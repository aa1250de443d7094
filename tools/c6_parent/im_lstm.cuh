// The lane side of the InvManagement LSTM kernels K22-K24, shared by the
// fixed actor class's kernels (im_lstm.cu, struct Lstm) and the general
// class's (im_lstm_any.cu, struct LstmG), so that the two draw, act and step
// alike: the period's draws (K10's stream, key (seed, 1)), the draws ahead
// by the second half of the block's threads, the action from the means, the
// lane's state on the fixed route (a frame) and on the chain route (a
// column of the workspace), and the step. im_lstm.cu's header holds the
// design, the stream and the rounding.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "im_step.cuh"
#include "launch.cuh"
#include "lstm.cuh"
#include "philox.cuh"

namespace {

// The lane's demand of period t and, when stochastic, its m1 standard
// normals into z ([act][lane] column n).
template <bool STOCH, class P>
__device__ __forceinline__ int lane_draws(const P& p, const float* __restrict__ table,
                                          const int* __restrict__ user_d, unsigned seed,
                                          unsigned lane, int t, float* z, int S) {
  WordStream ws(seed, 1u, lane, 0u, (unsigned)t);
  const int d = im_demand(p, table, user_d, t, ws.next());
  if (STOCH) {
    if constexpr (im_chain<P>()) {  // the u1 words wait in the rows as bits
      unsigned* u1 = reinterpret_cast<unsigned*>(z);
      for (int i = 0; i < p.m1; ++i) u1[i * S] = ws.next();
      for (int i = 0; i < p.m1; ++i) z[i * S] = normal01(u1[i * S], ws.next());
    } else {
      unsigned w1[IM_MAX_M1];
      for (int i = 0; i < p.m1; ++i) w1[i] = ws.next();
      for (int i = 0; i < p.m1; ++i) z[i * S] = normal01(w1[i], ws.next());
    }
  }
  return d;
}

// Threads LANES..2 LANES-1 draw period t for the block's lanes 0..LANES-1
// (lane0 is the block's first): the demand (an int in the last row) and,
// when stochastic, the m1 normals (the rows before it) of buffer t & 1 of
// the draw rows. The draws depend on the seed, the lane and t alone, so
// these threads make them for period t + 1 while the lane threads step
// period t, and the lanes read them after the next period's first barrier.
template <bool STOCH, int LANES, class P, class LS>
__device__ __forceinline__ void draw_ahead(const P& p, const LS& L,
                                           const float* __restrict__ table,
                                           const int* __restrict__ user_d, unsigned seed,
                                           long long lane0, int t, float* smem) {
  const int n = threadIdx.x - LANES, S = L.stride;
  float* buf = smem + L.s_z + (t & 1) * (L.act + 1) * S + n;
  buf[L.act * S] = __int_as_float(lane_draws<STOCH>(p, table, user_d, seed,
                                                     (unsigned)(lane0 + n), t, buf, S));
}

// Action i's half range: the actor's on the fixed route (struct Lstm's, or
// LstmG's in the buffer w), the records' on the chain route.
__device__ __forceinline__ float lstm_half(const Lstm& L, const float*, const ImParams&, int i) {
  return L.half_hi[i];
}
__device__ __forceinline__ float lstm_half(const LstmG& L, const float* __restrict__ w,
                                           const ImParams&, int i) {
  return __ldg(w + L.half_hi + i);
}
template <class LS>
__device__ __forceinline__ float lstm_half(const LS&, const float*, const ImView& p, int i) {
  return p.half_c[i];
}

// A raw sample into the frame's array or, as its bits, the chain's column.
__device__ __forceinline__ void put_raw(float* raw, int i, float x) { raw[i] = x; }
__device__ __forceinline__ void put_raw(const ImColumn& raw, int i, float x) {
  raw[i] = __float_as_int(x);
}
__device__ __forceinline__ float get_raw(const float* raw, int i) { return raw[i]; }
__device__ __forceinline__ float get_raw(const ImColumn& raw, int i) {
  return __int_as_float(raw[i]);
}

// The lane's raw samples and int actions from the means in m (its column).
template <bool STOCH, class LS, class P, class R, class A>
__device__ __forceinline__ void lane_act(const LS& L, const P& p, const float* __restrict__ w,
                                         const float* m, const float* z, int m1, R raw,
                                         A act) {
  const int S = L.stride;
  for (int i = 0; i < m1; ++i) {
    float x = m[i * S];
    if (STOCH) x = __fadd_rn(x, __fmul_rn(__ldg(w + L.std + i), z[i * S]));
    put_raw(raw, i, x);
    act[i] = (int)__fmul_rn(__fadd_rn(tanhf(x), 1.f), lstm_half(L, w, p, i));
  }
}

// One period's step, with the requested orders pushed into the ring ``ah``.
template <bool BACKLOG>
__device__ __forceinline__ float lane_step(const ImParams& p, ImEpisode& s, int t,
                                           const int* act, int d, int* ah) {
  int r_req[IM_MAX_M1];
  const int slot = s.slot;
  const float profit = im_step<BACKLOG>(p, s, t, act, d, r_req);
  if (p.lt > 0)
    for (int i = 0; i < p.m1; ++i) ah[slot * p.m1 + i] = r_req[i];
  return profit;
}

// A lane's state on the fixed route: the frame, as the parent kept it.
struct LstmFrameLane {
  ImEpisode s;
  int ah[IM_MAX_LT * IM_MAX_M1];  // requested order of period q: slot q % lt
  int act[IM_MAX_M1];
  float raw[IM_MAX_M1];
};

template <class P>
using LstmLaneOf = typename std::conditional<im_chain<P>(), ImLane, LstmFrameLane>::type;

// Point a chain lane at its column of the workspace (lane b of the launch);
// a frame lane needs nothing.
__device__ __forceinline__ void lstm_lane_init(LstmFrameLane&, const ImParams&, const ImParams&,
                                               long long) {}
__device__ __forceinline__ void lstm_lane_init(ImLane& l, const ImView& p, const ImParamsG& g,
                                               long long b) {
  l = im_lane({g.ws + b, g.ws_stride}, p.m1, p.lt, true);
}

// The raw samples: the frame's array or the chain lane's extra words.
__device__ __forceinline__ float* lane_raw(LstmFrameLane& l) { return l.raw; }
__device__ __forceinline__ ImColumn lane_raw(ImLane& l) { return l.extra; }

// The period's step on either lane.
template <bool BACKLOG>
__device__ __forceinline__ float lstm_step(const ImParams& p, LstmFrameLane& l, int t, int d) {
  return lane_step<BACKLOG>(p, l.s, t, l.act, d, l.ah);
}
template <bool BACKLOG>
__device__ __forceinline__ float lstm_step(const ImView& p, ImLane& l, int t, int d) {
  return im_step_any<BACKLOG>(p, l.s, t, l.act, d, l.ah + l.s.slot * p.m1);
}

// Blocks an SM the register allocation aims at: as many as its 65,536
// registers hold at 128 a thread (two of 256 threads).
__host__ __device__ constexpr int lstm_min_blocks(int threads) { return 512 / threads; }

}  // namespace
