// One InvManagement period on one thread, and the period draws of the
// random policy, shared by every InvManagement kernel (im_episode.cu K7-K9,
// im_policy.cu K10-K12 and K27), so that they cannot drift apart; and the
// observation column of the tile kernels (im_policy.cu K10-K12, im_lstm.cu
// K22-K24). It replaces
// pallas_episode_kernels._im_step_math (:686), _im_sample_actions (:841),
// _im_sample_demand (:853) and _invert_discrete_i32 (:824).
//
// The params travel as one POD struct by value (__grid_constant__), packed
// at run time by the wrapper (ops/episode_kernels.py _im_plan, whose ctypes
// mirror _ImParams must match this layout field for field); the JAX kernels baked them
// in at trace time. All state is int32, as in the JAX package, so a kernel
// that replays the same actions and demand reproduces it bit for bit.
//
// Where the semantics are easy to get wrong:
// - Backlog or lost sales is the template parameter BACKLOG.
// - A lead time of 0 delivers the order of the same period; the last
//   stage's supplier holds 1 << 30 (unlimited raw material).
// - Stages 1..m1-1 are decremented by the orders they placed, not by what
//   they shipped (inventory_management.py:300), so on-hand can go negative.
// - Fulfilled orders: the JAX kernel shifts a newest-first ring of
//   lt_max x m1 rows every period and reads row L_i - 1. Here a ring of depth
//   lt_max per stage holds the order of period p in slot p % lt_max; period t
//   reads slot (t - L_i) % lt_max (zero before period L_i), then overwrites
//   slot t % lt_max. Indexed at run time, it lives in a thread's local
//   frame (ImEpisode) or, in K7 and K8, in shared memory
//   (ImSharedEpisode).
// - One body, two views of the state: im_step, im_reset and
//   im_draw_actions take the state type and M1 (im_stages). The frame
//   kernels (K10-K12, K22-K24, K27) call them as before, with their loops
//   to the run-time m1; K7 and K8 unroll them, an instance per m1, so
//   their per-stage arrays (inv, bkl, the orders, the actions) are
//   registers and their frames are empty. So K7 on K9's streams and K8
//   run one body: the same bits. K9 draws through im_draw_actions<M1> too,
//   an instance per m1, its actions in registers.
// - Profit is summed per stage in the JAX order, (price - cost) * S, then
//   - k * U, then - h * max(inv, 0), each product and sum rounded alone
//   (__fmul_rn, __fadd_rn): no FMA contraction, so the plain version's
//   elementwise torch arithmetic gives the same bits.
//
// Random policy (K7 _random, K8, K9): key (seed, 0), counter (lane,
// episode, period, block); per period the m1 action words, then one demand
// word. action = min((int)(u01(w) * f32(c_i + 1)), c_i), an inclusive
// uniform int on [0, c_i] (pallas_episode_kernels.py:847-850); demand =
// base + count_le(table, u01(w)) (:824-830). USER mode reads user_d[t] and
// still owns its word, so the layout does not depend on the dist mode.
#pragma once

#include "philox.cuh"

#define IM_MAX_M1 8
#define IM_MAX_LT 32
#define IM_LOOP -1  // im_stages' M1 for loops to the run-time m1 (the frame kernels)

struct ImParams {
  int m1, lt;          // stages that hold stock, lt_max
  int user;            // 1: demand = user_d[t]; 0: invert the CDF table
  int tab_len, base;   // the table's length and the demand's base
  int c[IM_MAX_M1], L[IM_MAX_M1], I0[IM_MAX_M1];
  float gain[IM_MAX_M1 + 1];    // f32(unit_price - unit_cost) per stage
  float k[IM_MAX_M1 + 1];       // unfulfilled-demand cost per stage
  float h[IM_MAX_M1];           // holding cost per stage that holds stock
  float act_span[IM_MAX_M1];    // f32(c_i + 1), the random policy's factor
};

// The state in a thread's frame (local memory): every stepping kernel but
// K7 and K8.
struct ImEpisode {
  int inv[IM_MAX_M1];
  int bkl[IM_MAX_M1 + 1];
  int rh[IM_MAX_LT * IM_MAX_M1];  // fulfilled order of period p: slot p % lt
  int slot;                       // t % lt
  __device__ int& ring(int k) { return rh[k]; }
};

// The per-stage arrays of an instance: m1 entries for an exact M1 > 0,
// else the struct maxima.
template <int M1>
__host__ __device__ constexpr int im_width() {
  return M1 > 0 ? M1 : IM_MAX_M1;
}

// K7's and K8's state: on-hand and backlog in registers (every stage loop of
// im_stages unrolled, so their indices are constants), the ring of
// fulfilled orders in the thread's column of a [word][thread] region of
// shared memory (the slot, t % lt, is the same for every thread of the
// launch, so a warp's accesses fall on 32 banks).
template <int M1>
struct ImSharedEpisode {
  int inv[im_width<M1>()];
  int bkl[im_width<M1>() + 1];
  int* rh;
  int stride;  // threads a block
  int slot;
  __device__ int& ring(int k) { return rh[k * stride]; }
};

// f(i) for each stage i < m1 + EXTRA. M1 = IM_LOOP: a loop to the run-time
// m1, as the frame kernels always ran it; else unrolled to im_width<M1>()
// + EXTRA stages under i < m1 + EXTRA: for M1 > 0 the caller's m1 is M1, so
// the predicate folds away and exactly M1 stages remain (K7's and K8's
// instances);
// M1 = 0 unrolls to the struct maxima under run-time predicates.
template <int M1, int EXTRA = 0, class F>
__device__ __forceinline__ void im_stages(int m1, F f) {
  if constexpr (M1 == IM_LOOP) {
    for (int i = 0; i < m1 + EXTRA; ++i) f(i);
  } else {
#pragma unroll
    for (int i = 0; i < im_width<M1>() + EXTRA; ++i)
      if (i < m1 + EXTRA) f(i);
  }
}

// i, clamped into an array of n: a constant index stays inside a register
// array in the unrolled loops, where a predicate guards the access.
__device__ __forceinline__ int im_in(int i, int n) { return i < n ? i : n - 1; }

template <int M1 = IM_LOOP, class S>
__device__ __forceinline__ void im_reset(const ImParams& p, S& s) {
  const int m1 = M1 > 0 ? M1 : p.m1;
  im_stages<M1>(m1, [&](int i) { s.inv[i] = p.I0[i]; });
  im_stages<M1, 1>(m1, [&](int i) { s.bkl[i] = 0; });
  for (int k = 0; k < p.lt * m1; ++k) s.ring(k) = 0;
  s.slot = 0;
}

// One period (pallas_episode_kernels._im_step_math) on the state s (an
// ImEpisode or K7/K8's ImSharedEpisode): the requested orders max(act, 0) go
// to r_req[0, m1); returns the undiscounted profit.
template <bool BACKLOG, int M1 = IM_LOOP, class S>
__device__ __forceinline__ float im_step(const ImParams& p, S& s, int t, const int* act,
                                         int d, int* r_req) {
  constexpr int W = im_width<M1>();
  const int m1 = M1 > 0 ? M1 : p.m1;
  int order_req[W], r_ful[W], inv[W];

  // 0) orders: request = action + the prior backlog of stages 1..m, capped
  // by the capacity and the supplier's on-hand
  im_stages<M1>(m1, [&](int i) {
    r_req[i] = max(act[i], 0);
    order_req[i] = r_req[i] + s.bkl[i + 1];
    const int sup = i + 1 < m1 ? s.inv[im_in(i + 1, W)] : (1 << 30);
    r_ful[i] = min(min(order_req[i], p.c[i]), sup);
  });

  // 1) arrivals of the orders fulfilled L_i periods ago
  im_stages<M1>(m1, [&](int i) {
    const int li = p.L[i];
    int due = 0;
    if (li == 0) {
      due = r_ful[i];
    } else if (t >= li) {
      int k = s.slot - li;
      if (k < 0) k += p.lt;
      due = s.ring(k * m1 + i);
    }
    inv[i] = s.inv[i] + due;
  });

  // 2-3) retail sales with the prior backlog
  const int to_fill = max(d, 0) + s.bkl[0];
  const int sales0 = min(inv[0], to_fill);
  inv[0] -= sales0;

  // 4) supplier stages decremented by the orders they placed
  im_stages<M1>(m1, [&](int i) {
    if (i > 0) inv[i] -= r_ful[i];
  });

  // 5) profit per stage in the JAX order; the new backlog
  float profit = 0.f;
  im_stages<M1, 1>(m1, [&](int i) {
    const int j = i > 0 ? i - 1 : 0;  // the link that supplies stage i
    const int S = i == 0 ? sales0 : r_ful[j];
    const int U = i == 0 ? to_fill - sales0 : order_req[j] - r_ful[j];
    profit = __fadd_rn(profit, __fmul_rn(p.gain[i], (float)S));
    profit = __fsub_rn(profit, __fmul_rn(p.k[i], (float)U));
    if (i < m1)
      profit = __fsub_rn(profit, __fmul_rn(p.h[im_in(i, W)], (float)max(inv[im_in(i, W)], 0)));
    s.bkl[i] = BACKLOG ? U : 0;
  });

  // history ring; then the new on-hand
  if (p.lt > 0) {
    im_stages<M1>(m1, [&](int i) { s.ring(s.slot * m1 + i) = r_ful[i]; });
    s.slot = s.slot + 1 == p.lt ? 0 : s.slot + 1;
  }
  im_stages<M1>(m1, [&](int i) { s.inv[i] = inv[i]; });
  return profit;
}

// The m1 inclusive-uniform actions of one period from the next m1 words.
template <int M1 = IM_LOOP>
__device__ __forceinline__ void im_draw_actions(const ImParams& p, WordStream& ws, int* act) {
  im_stages<M1>(M1 > 0 ? M1 : p.m1, [&](int i) {
    act[i] = min((int)__fmul_rn(u01(ws.next()), p.act_span[i]), p.c[i]);
  });
}

// Demand of period t from its word (USER mode ignores the word).
__device__ __forceinline__ int im_demand(const ImParams& p,
                                         const float* __restrict__ table,
                                         const int* __restrict__ user_d, int t,
                                         unsigned word) {
  if (p.user) return __ldg(user_d + t);
  return p.base + count_le(table, p.tab_len, u01(word));
}

// The lane's observation column in x0 (rows S floats apart), in the order
// of _im_obs_rows (pallas_episode_kernels.py :1108): on-hand, then the
// requested orders of periods max(t - lt, 0) .. t-1 oldest first, one row
// per (period, stage), zero rows at the end while t < lt. ``ah`` is the
// ring of requested orders (slot q % lt). The tile kernels' (K11/K12,
// K22-K24) column of shared memory.
__device__ __forceinline__ void lane_obs(const ImParams& p, const ImEpisode& s, int t,
                                         const int* ah, float* x0, int S) {
  const int m1 = p.m1, lt = p.lt;
  for (int i = 0; i < m1; ++i) x0[i * S] = (float)s.inv[i];
  const int q0 = max(t - lt, 0);
  for (int j = 0; j < lt; ++j) {
    const int q = q0 + j;
    for (int i = 0; i < m1; ++i)
      x0[(m1 + j * m1 + i) * S] = q < t ? (float)ah[(q % lt) * m1 + i] : 0.f;
  }
}
