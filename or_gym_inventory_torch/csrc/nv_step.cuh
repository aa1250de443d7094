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
// - The pipeline is a ring of depth L (the oldest at ``head``), in local
//   memory; its sum runs oldest first, as JAX's sum(P[1:], P[0]).
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
// renormalisation total; each chunk of periods then runs the same K steps
// again, counting for each uniform the steps whose Kahan-summed suffix sum
// lies below v = (1 - u) * total; demand = max(kc + 1 - count, 0). Every
// lane runs all K steps, the ones after kf reaches 0 included, since the
// count identity depends on it. lgamma(kc + 1) is a host-built table of f32
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
  int kc_max;           // floor(mu_max) + Wb: the lgamma table's last index
  float wb;             // Wb, the widest half-window
  float max_inv, max_order;
  float p_max, h_max, k_max, mu_max;
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

// The reset's five conditional uniforms (newsvendor.py:105-111).
__device__ __forceinline__ void nv_econ(const NvParams& p, const float* u, NvEpisode& s) {
  s.price = max_nan(1.f, __fmul_rn(u[0], p.p_max));
  s.cost = max_nan(1.f, __fmul_rn(u[1], s.price));
  s.h = __fmul_rn(u[2], min_nan(s.cost, p.h_max));
  s.k = __fmul_rn(u[3], p.k_max);
  s.mu = __fmul_rn(u[4], p.mu_max);
}

// One period: the undiscounted reward of ``order_raw`` against demand d; the
// capped order that enters the pipeline into q.
__device__ __forceinline__ float nv_step(const NvParams& p, NvEpisode& s,
                                         float order_raw, float d, float& q) {
  const int L = p.L;
  float psum = 0.f, inv = order_raw;
  if (L > 0) {
    inv = s.ring[s.head];
    psum = inv;
    for (int j = 1; j < L; ++j) {
      int k = s.head + j;
      if (k >= L) k -= L;
      psum = __fadd_rn(psum, s.ring[k]);
    }
  }
  q = max_nan(0.f, min_nan(order_raw, __fsub_rn(p.max_inv, psum)));
  const float sales = min_nan(inv, d);
  const float excess = max_nan(0.f, __fsub_rn(inv, d));
  const float shortage = max_nan(0.f, __fsub_rn(d, inv));
  float reward = __fsub_rn(__fmul_rn(sales, s.price), __fmul_rn(q, s.cost));
  reward = __fsub_rn(reward, __fmul_rn(excess, s.h));
  reward = __fsub_rn(reward, __fmul_rn(shortage, s.k));
  if (L > 0) {
    s.ring[s.head] = q;
    s.head = s.head + 1 == L ? 0 : s.head + 1;
  }
  return reward;
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

__device__ __forceinline__ NvPoisson nv_poisson_setup(const NvParams& p,
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
  float T = 0.f, comp = 0.f, pk = q.p_c, kf = q.kc;
  for (int k = 0; k < p.K; ++k) nv_recur(T, comp, pk, kf, q.mu);
  q.total = T;
  return q;
}

// Demand d[i] = #{k : F(k) <= u_i} for the NV_CHUNK uniforms whose
// thresholds v[i] = (1 - u_i) * total are given (_nv_poisson_invert).
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
