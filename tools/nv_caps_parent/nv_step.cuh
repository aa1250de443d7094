// One Newsvendor period on one thread, the reset's economics and the
// per-episode Poisson(mu) inversion, shared by every Newsvendor kernel
// (nv_episode.cu K13-K17, nv_policy.cu K18-K20), so that they cannot drift
// apart. It replaces pallas_episode_kernels._nv_step_math (:77),
// _nv_econ_from_uniforms (:393), _nv_poisson_setup (:213) and
// _nv_poisson_invert (:273).
//
// The params travel as one POD struct by value (__grid_constant__), packed
// at run time by the wrapper (ops/episode_kernels.py _nv_plan, whose ctypes
// mirror _NvParams must match this layout field for field).
//
// Where the semantics are easy to get wrong:
// - lead_time 0: the order after the [0, max_order] clip and before the
//   max_inventory cap is on hand (newsvendor.py:136-142); otherwise on hand
//   is the oldest pipeline slot, and unsold stock expires.
// - The pipeline is a ring of depth L (the oldest at ``head``), in a
//   thread's local NvEpisode (K14-K17) or in the pair's column of shared
//   memory in K19/K20's tile (nv_step_ring takes either), or a shift
//   register of L registers, the oldest first, in K13 (nv_step_shift, an
//   instance per L); its sum runs oldest first, as JAX's sum(P[1:], P[0]),
//   and the rest of the step is one function (nv_reward) for all three.
// - Purchase cost is charged on the capped order.
// - NaN: jnp.clip/maximum/minimum propagate it (nanmath.cuh), so a NaN
//   action gives a NaN return.
// - Rounding: every product, sum and quotient is rounded alone
//   (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn): no FMA contraction, so
//   the plain version's elementwise torch arithmetic gives the same bits.
//   The inversion depends on exact roundings (the Veltkamp head
//   s - (s - logmu), the TwoSum error terms, kc * tail, and
//   ceil(5.75 sqrt(mu) + pad), where one ulp would move kc and every draw of
//   the lane); only logf and expf may differ from the CPU's by an ulp.
//
// The inversion (the notes at pallas_episode_kernels.py:164-195): mu is
// fixed for the episode, so the setup anchors a descending pmf recurrence at
// kc = floor(mu) + min(w(mu), Wb) and runs it K = 2 Wb + 1 steps once for the
// renormalisation total; a period's demand is max(kc + 1 - count, 0), where
// count is the number of steps whose Kahan-summed (pre-add) suffix sum S(k)
// lies below v = (1 - u) * total. Every lane runs all K steps, the ones
// after kf reaches 0 included, since the count identity depends on it. Two
// ways to count, the same count bit for bit:
// - the table (K14-K17, nv_table_setup/nv_table_invert): the setup's one
//   pass also writes S(0..K-1) into the thread's column of a [k][thread]
//   shared-memory table and records m, the first k with S(k+1) < S(k) (a
//   Kahan step that adds a negative y, only in the far tail), and the min
//   and max of S over [m, K). S is nondecreasing on [0, m), so a period's
//   count there is a lower-bound search (ceil(log2 m) probes, the chunk's
//   16 searches interleaved round by round so their shared-memory loads
//   overlap); over [m, K) it is 0 below the minimum, K - m above the
//   maximum, and a linear count in between (rare: the suffix sits within
//   ulps of total). ops/episode_kernels.py _nv_table_plan sizes the block
//   to the table (NvParams.threads) and picks, for a K whose table a block
//   of 32 cannot hold, the linear count below instead (NvParams.table 0);
//   K18-K20's tile (nv_policy.cu) builds the same table at its reset and
//   searches every period of the episode there at once;
// - linear (nv_poisson_invert; K28, whose shared memory holds the actor,
//   and K18-K20 where no table fits a block): each chunk of 16
//   periods reruns the K steps and compares every S(k) with each
//   threshold. lgamma(kc + 1) is a host-built table of f32
// hi/lo pairs split from float64 exactly as JAX splits them, indexed by kc
// (0 for kc < 2; kc beyond the table takes its last pair, as JAX's masked
// loop does).
#pragma once

#include "nanmath.cuh"
#include "philox.cuh"

#define NV_MAX_L 32
#define NV_CHUNK 16           // periods whose demand is inverted at once
#define NV_ECON_PERIOD 0xFFFFFFFFu  // the period index of the reset's words

struct NvParams {
  int L;                // lead_time
  int K;                // recurrence steps, 2 Wb + 1
  int threads;          // K14-K17's block size (_nv_table_plan)
  int table;            // 1: K14-K17 search a shared-memory table of 4 K
                        // bytes a thread; 0: they count linearly
  int kc_max;           // floor(mu_max) + Wb: the lgamma table's last index
  float wb;             // Wb, the widest half-window
  float max_inv, max_order;
  float p_max, h_max, k_max, mu_max;
  int k13_threads;      // K13's block size (nv_episode.cu; _nv_k13_plan)
};

struct NvEpisode {
  float price, cost, h, k, mu;
  float ring[NV_MAX_L];  // pipeline; ring[head] arrives next
  int head;
};

__device__ __forceinline__ void nv_reset(const NvParams& p, NvEpisode& s) {
  for (int j = 0; j < p.L; ++j) s.ring[j] = 0.f;
  s.head = 0;
}

// The economics of one episode, as the step reads them.
struct NvEcon {
  float price, cost, h, k, mu;
};

// The reset's five conditional uniforms (newsvendor.py:105-111).
__device__ __forceinline__ NvEcon nv_econ(const NvParams& p, const float* u) {
  NvEcon c;
  c.price = max_nan(1.f, __fmul_rn(u[0], p.p_max));
  c.cost = max_nan(1.f, __fmul_rn(u[1], c.price));
  c.h = __fmul_rn(u[2], min_nan(c.cost, p.h_max));
  c.k = __fmul_rn(u[3], p.k_max);
  c.mu = __fmul_rn(u[4], p.mu_max);
  return c;
}

__device__ __forceinline__ void nv_econ(const NvParams& p, const float* u, NvEpisode& s) {
  const NvEcon c = nv_econ(p, u);
  s.price = c.price;
  s.cost = c.cost;
  s.h = c.h;
  s.k = c.k;
  s.mu = c.mu;
}

// The pipeline's slots as nv_step_ring reads them: a thread's own ring
// (NvEpisode, local memory) or its column of a [slot][lane] region of
// shared memory (the tile kernel K19/K20, nv_policy.cu).
struct NvFrameRing {
  float* r;
  __device__ float& operator()(int k) const { return r[k]; }
};

struct NvSharedRing {
  float* r;
  int stride;
  __device__ float& operator()(int k) const { return r[k * stride]; }
};

// One period after the pipeline is read: the undiscounted reward of
// ``order_raw`` against demand d, with ``inv`` on hand and ``psum`` in the
// pipeline; the capped order that enters the pipeline into q. ``c`` is the
// economics.
__device__ __forceinline__ float nv_reward(const NvParams& p, const NvEcon& c, float inv,
                                           float psum, float order_raw, float d, float& q) {
  q = max_nan(0.f, min_nan(order_raw, __fsub_rn(p.max_inv, psum)));
  const float sales = min_nan(inv, d);
  const float excess = max_nan(0.f, __fsub_rn(inv, d));
  const float shortage = max_nan(0.f, __fsub_rn(d, inv));
  float reward = __fsub_rn(__fmul_rn(sales, c.price), __fmul_rn(q, c.cost));
  reward = __fsub_rn(reward, __fmul_rn(excess, c.h));
  return __fsub_rn(reward, __fmul_rn(shortage, c.k));
}

// One period: the undiscounted reward of ``order_raw`` against demand d; the
// capped order that enters the pipeline into q. ``ring`` and ``head`` are
// the pipeline (the oldest at ``head``), ``c`` the economics.
template <class Ring>
__device__ __forceinline__ float nv_step_ring(const NvParams& p, const Ring& ring, int& head,
                                              const NvEcon& c, float order_raw, float d,
                                              float& q) {
  const int L = p.L;
  float psum = 0.f, inv = order_raw;
  if (L > 0) {
    inv = ring(head);
    psum = inv;
    for (int j = 1; j < L; ++j) {
      int k = head + j;
      if (k >= L) k -= L;
      psum = __fadd_rn(psum, ring(k));
    }
  }
  const float reward = nv_reward(p, c, inv, psum, order_raw, d, q);
  if (L > 0) {
    ring(head) = q;
    head = head + 1 == L ? 0 : head + 1;
  }
  return reward;
}

// nv_step_ring on a pipeline of a depth L known at compile time, held as a
// shift register: ring[0] arrives next, ring[L - 1] is the newest. With the
// period loop unrolled every index is a constant, so the pipeline stays in
// registers (K13); the float operations are nv_step_ring's, in its order.
template <int L>
__device__ __forceinline__ float nv_step_shift(const NvParams& p, float (&ring)[L > 0 ? L : 1],
                                               const NvEcon& c, float order_raw, float d,
                                               float& q) {
  float psum = 0.f, inv = order_raw;
  if constexpr (L > 0) {
    inv = ring[0];
    psum = inv;
#pragma unroll
    for (int j = 1; j < L; ++j) psum = __fadd_rn(psum, ring[j]);
  }
  const float reward = nv_reward(p, c, inv, psum, order_raw, d, q);
  if constexpr (L > 0) {
#pragma unroll
    for (int j = 0; j + 1 < L; ++j) ring[j] = ring[j + 1];
    ring[L - 1] = q;
  }
  return reward;
}

__device__ __forceinline__ float nv_step(const NvParams& p, NvEpisode& s,
                                         float order_raw, float d, float& q) {
  const NvEcon c{s.price, s.cost, s.h, s.k, s.mu};
  return nv_step_ring(p, NvFrameRing{s.ring}, s.head, c, order_raw, d, q);
}

__device__ __forceinline__ float nv_step(const NvParams& p, NvEpisode& s,
                                         float order_raw, float d) {
  float q;
  return nv_step(p, s, order_raw, d, q);
}

// The per-episode anchor of the inversion (_nv_poisson_setup).
struct NvPoisson {
  float mu, kc, p_c, total;
};

// One step of the descending recurrence: T += p (Kahan), p *= kf / mu.
__device__ __forceinline__ void nv_recur(float& T, float& comp, float& p, float& kf,
                                         float mu) {
  const float y = __fsub_rn(p, comp);
  const float t_new = __fadd_rn(T, y);
  comp = __fsub_rn(__fsub_rn(t_new, T), y);
  T = t_new;
  p = __fmul_rn(p, __fdiv_rn(kf, mu));
  kf = __fsub_rn(kf, 1.f);
}

// The anchor: mu, kc and pmf(kc); total is left for the K steps.
__device__ __forceinline__ NvPoisson nv_poisson_anchor(const NvParams& p,
                                                       const float* __restrict__ lgam,
                                                       float mu) {
  NvPoisson q;
  q.mu = max_nan(mu, 1e-6f);
  const float pad = __fadd_rn(2.f, __fmul_rn(4.f, min_nan(q.mu, 1.f)));
  const float w = ceilf(__fadd_rn(__fmul_rn(5.75f, sqrtf(q.mu)), pad));
  q.kc = __fadd_rn(floorf(q.mu), min_nan(w, p.wb));
  float lg_hi = 0.f, lg_lo = 0.f;
  if (q.kc >= 2.f) {
    const int i = min((int)q.kc, p.kc_max);
    lg_hi = __ldg(lgam + 2 * i);
    lg_lo = __ldg(lgam + 2 * i + 1);
  }
  const float logmu = logf(q.mu);
  const float s = __fmul_rn(logmu, 4097.f);  // Veltkamp split: 12-bit head
  const float head = __fsub_rn(s, __fsub_rn(s, logmu));
  const float tail = __fsub_rn(logmu, head);
  const float a1 = __fmul_rn(q.kc, head);  // exact: 9 + 12 bits < 24
  const float A = __fsub_rn(a1, lg_hi);    // TwoSum-compensated cancels
  const float t1 = __fsub_rn(A, a1);
  const float e1 = __fsub_rn(__fsub_rn(a1, __fsub_rn(A, t1)), __fadd_rn(lg_hi, t1));
  const float Bv = __fsub_rn(A, q.mu);
  const float t2 = __fsub_rn(Bv, A);
  const float e2 = __fsub_rn(__fsub_rn(A, __fsub_rn(Bv, t2)), __fadd_rn(q.mu, t2));
  const float g =
      __fadd_rn(Bv, __fsub_rn(__fadd_rn(__fadd_rn(e1, e2), __fmul_rn(q.kc, tail)), lg_lo));
  q.p_c = expf(g);
  q.total = 0.f;
  return q;
}

// The renormalisation total: the K steps from the anchor.
__device__ __forceinline__ float nv_poisson_total(const NvParams& p, const NvPoisson& q) {
  float T = 0.f, comp = 0.f, pk = q.p_c, kf = q.kc;
  for (int k = 0; k < p.K; ++k) nv_recur(T, comp, pk, kf, q.mu);
  return T;
}

__device__ __forceinline__ NvPoisson nv_poisson_setup(const NvParams& p,
                                                      const float* __restrict__ lgam,
                                                      float mu) {
  NvPoisson q = nv_poisson_anchor(p, lgam, mu);
  q.total = nv_poisson_total(p, q);
  return q;
}

// The thread's column of the table: S(k) at s[k * stride].
struct NvTable {
  float* s;
  int stride;
  int m;          // the first k with S(k+1) < S(k); K if there is none
  float lo, hi;   // min and max of S over [m, K)
};

// nv_poisson_setup with the table: the same K steps, each pre-add sum
// stored; sets q.total.
__device__ __forceinline__ NvTable nv_table_setup(const NvParams& p, NvPoisson& q,
                                                  float* col, int stride) {
  NvTable t{col, stride, p.K, __int_as_float(0x7f800000), -__int_as_float(0x7f800000)};
  float T = 0.f, comp = 0.f, pk = q.p_c, kf = q.kc;
  for (int k = 0; k < p.K; ++k) {
    const float s = T;
    col[k * stride] = s;
    nv_recur(T, comp, pk, kf, q.mu);
    if (t.m == p.K && T < s) t.m = k;
    if (t.m <= k) {
      t.lo = fminf(t.lo, s);
      t.hi = fmaxf(t.hi, s);
    }
  }
  q.total = T;
  return t;
}

// nv_poisson_invert's demands from the table. The lower bound on [0, m) is
// the branchless one: its rounds depend on m alone, so the chunk's searches
// run them together. A NaN threshold (a NaN mu makes total NaN) counts 0,
// as the linear compare does.
__device__ __forceinline__ void nv_table_invert(const NvParams& p, const NvPoisson& q,
                                                const NvTable& t, const float* v,
                                                float* d) {
  int base[NV_CHUNK];
#pragma unroll
  for (int i = 0; i < NV_CHUNK; ++i) base[i] = 0;
  for (int n = t.m; n > 1;) {
    const int half = n >> 1;
#pragma unroll
    for (int i = 0; i < NV_CHUNK; ++i)
      base[i] = t.s[(base[i] + half) * t.stride] < v[i] ? base[i] + half : base[i];
    n -= half;
  }
  const float top = __fadd_rn(q.kc, 1.f);
#pragma unroll
  for (int i = 0; i < NV_CHUNK; ++i) {
    int cnt = t.m > 0 ? base[i] + (t.s[base[i] * t.stride] < v[i]) : 0;
    if (v[i] > t.hi) {
      cnt += p.K - t.m;
    } else if (v[i] > t.lo) {
      for (int k = t.m; k < p.K; ++k) cnt += t.s[k * t.stride] < v[i];
    }
    d[i] = max_nan(__fsub_rn(top, (float)cnt), 0.f);
  }
}

// Demand d[i] = #{k : F(k) <= u_i} for the NV_CHUNK uniforms whose
// thresholds v[i] = (1 - u_i) * total are given (_nv_poisson_invert), by
// the linear count.
__device__ __forceinline__ void nv_poisson_invert(const NvParams& p, const NvPoisson& q,
                                                  const float* v, float* d) {
  int cnt[NV_CHUNK];
#pragma unroll
  for (int i = 0; i < NV_CHUNK; ++i) cnt[i] = 0;
  float T = 0.f, comp = 0.f, pk = q.p_c, kf = q.kc;
  for (int k = 0; k < p.K; ++k) {
#pragma unroll
    for (int i = 0; i < NV_CHUNK; ++i) cnt[i] += T < v[i];
    nv_recur(T, comp, pk, kf, q.mu);
  }
  const float top = __fadd_rn(q.kc, 1.f);
#pragma unroll
  for (int i = 0; i < NV_CHUNK; ++i) d[i] = max_nan(__fsub_rn(top, (float)cnt[i]), 0.f);
}
