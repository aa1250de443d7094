// One NetInvMgmt period on one thread, shared by every episode kernel
// (net_episode.cu K1-K3, net_policy.cu K4-K6), so that they cannot drift
// apart. It replaces pallas_net_step._step_math (:34).
//
// Where the semantics are easy to get wrong:
// - Rounding: jnp.round rounds half to even, so rintf, never roundf (which
//   rounds half away from zero).
// - Contention runs over the reorder links in sorted-edge order; the
//   factory cap is min(avail, min(C, v*avail)); consumed += fulfilled / v is
//   a true division (__fdiv_rn): custom graphs may have v < 1.
// - A link with L = 0 delivers the order of the same period.
// - Order history: the JAX kernels shift a newest-first ring of lt_max x n_ro
//   rows (132 floats on the default graph) every period and read row L-1 of
//   each link. Here each link i keeps a ring of depth L_i (sum 61 on the
//   default graph): slot t % L_i holds the order of period t - L_i; it is
//   read, then overwritten with this period's order. Zero-initialised, so
//   no validity mask is needed for t < L_i. At the start of period t the
//   link's chronological window r[t-L_i .. t-1] is therefore slots
//   (t + j) % L_i for j = 0 .. L_i-1 (order_window below). Indexed at run
//   time, the ring lives in local memory (cached in L1, spilling to L2), as
//   do the per-node arrays indexed by supplier and purchaser.
// - NaN: jnp.maximum/minimum propagate a NaN operand, fmaxf/fminf drop it.
//   max_nan/min_nan keep the JAX semantics, so a policy whose weights
//   diverged gives NaN returns here as it does in the JAX package.
// - FMA contraction is left on, so the profit may differ from the plain
//   version in the last bits; the state (integer-valued floats) is exact.
//
// The NetInvMgmt draws are here too (link_demand, draw_period), built on
// philox.cuh. Random-policy kernels, key (seed, 0): the n_ro action words,
// then one demand word per retail link; action = float(word >> 8) *
// act_scale, act_scale = f32(act_hi / 2^24) (pallas_net_step.py:328-333).
// Policy kernels, key (seed, 1): one demand word per retail link, then, when
// stochastic, the n_ro u1 and the n_ro u2 words of the Box-Muller normals
// (the JAX kernels draw the demand before the policy,
// pallas_net_step.py:528/:654, and u1 before u2,
// pallas_episode_kernels.py:69-70). A const (user/zero) link still owns its
// word, so the layout does not depend on the demand specs.
#pragma once

#include "net_topo.cuh"
#include "philox.cuh"

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}

struct Episode {
  float X[NET_MAX_MAIN];
  float Y[NET_MAX_RO];
  float U[NET_MAX_RT];
  float ring[NET_MAX_RING];
  int slot[NET_MAX_RO];  // t % L_i
};

__device__ __forceinline__ void episode_reset(const NetTopo& tp, Episode& s) {
  for (int n = 0; n < tp.n_main; ++n) s.X[n] = tp.I0[n];
  int ring = 0;
  for (int i = 0; i < tp.n_ro; ++i) {
    s.Y[i] = 0.f;
    s.slot[i] = 0;
    ring += tp.ro_L[i];
  }
  for (int j = 0; j < tp.n_rt; ++j) s.U[j] = 0.f;
  for (int k = 0; k < ring; ++k) s.ring[k] = 0.f;
}

// r[t - L_i + j] of link i at the start of period t, 0 <= j < L_i (zero
// before period 0).
__device__ __forceinline__ float order_window(const NetTopo& tp,
                                              const Episode& s, int i, int j) {
  const int L = tp.ro_L[i];
  int k = s.slot[i] + j;
  if (k >= L) k -= L;
  return s.ring[tp.ro_ring[i] + k];
}

// One period (pallas_net_step._step_math): writes the fulfilled orders to
// r[0, n_ro) and returns the undiscounted profit.
__device__ __forceinline__ float step_period(const NetTopo& tp, Episode& s,
                                             const float* act,
                                             const float* dem, float* r) {
  float consumed[NET_MAX_MAIN], arrivals[NET_MAX_MAIN];
  for (int n = 0; n < tp.n_main; ++n) consumed[n] = arrivals[n] = 0.f;

  // 0) order fulfillment with sequential supplier contention
  for (int i = 0; i < tp.n_ro; ++i) {
    const float req = max_nan(0.f, rintf(act[i]));
    const int sup = tp.ro_sup[i];
    float f = req;
    if (sup >= 0) {
      float avail = max_nan(0.f, s.X[sup] - consumed[sup]);
      if (tp.is_factory[sup])
        avail = min_nan(avail, min_nan(tp.C[sup], tp.v[sup] * avail));
      f = min_nan(req, avail);
      consumed[sup] = consumed[sup] + __fdiv_rn(f, tp.v[sup]);
    }
    r[i] = f;
  }

  // 1) deliveries + pipeline
  for (int i = 0; i < tp.n_ro; ++i) {
    const int L = tp.ro_L[i];
    float a = r[i];
    if (L > 0) {
      const int k = tp.ro_ring[i] + s.slot[i];
      a = s.ring[k];
      s.ring[k] = r[i];
      s.slot[i] = s.slot[i] + 1 == L ? 0 : s.slot[i] + 1;
    }
    s.Y[i] = s.Y[i] - a + r[i];
    arrivals[tp.ro_pur[i]] += a;
  }
  for (int n = 0; n < tp.n_main; ++n)
    s.X[n] = s.X[n] + arrivals[n] - consumed[n];

  // 2-4) sequential retail fulfillment
  float sales[NET_MAX_RT];
  for (int j = 0; j < tp.n_rt; ++j) {
    const int ret = tp.rt_ret[j];
    const float to_fill = max_nan(0.f, rintf(dem[j])) + s.U[j];
    const float sl = min_nan(to_fill, max_nan(0.f, s.X[ret]));
    s.X[ret] = s.X[ret] - sl;
    sales[j] = sl;
    s.U[j] = tp.backlog ? to_fill - sl : 0.f;
  }

  // 5) per-node profit
  float SR[NET_MAX_MAIN], PC[NET_MAX_MAIN], HCp[NET_MAX_MAIN],
      sold[NET_MAX_MAIN], UP[NET_MAX_MAIN];
  for (int n = 0; n < tp.n_main; ++n) SR[n] = PC[n] = HCp[n] = sold[n] = UP[n] = 0.f;
  for (int i = 0; i < tp.n_ro; ++i) {
    const int sup = tp.ro_sup[i], pur = tp.ro_pur[i];
    const float rev = tp.ro_price[i] * r[i];
    if (sup >= 0) {
      SR[sup] += rev;
      sold[sup] += r[i];
    }
    PC[pur] += rev;
    HCp[pur] += tp.ro_g[i] * max_nan(0.f, s.Y[i]);
  }
  for (int j = 0; j < tp.n_rt; ++j) {
    const int ret = tp.rt_ret[j];
    SR[ret] += tp.rt_price[j] * sales[j];
    sold[ret] += sales[j];
    UP[ret] += tp.rt_b[j] * s.U[j];
  }
  float total = 0.f;
  for (int n = 0; n < tp.n_main; ++n) {
    const float HC = tp.h[n] * max_nan(0.f, s.X[n]) + HCp[n];
    const float OC = tp.is_factory[n] ? __fdiv_rn(tp.o[n] * sold[n], tp.v[n]) : 0.f;
    total += SR[n] - PC[n] - OC - HC - UP[n];
  }
  return total;
}

// Demand of retail link j in period t from its word.
__device__ __forceinline__ float link_demand(const NetTopo& tp,
                                             const float* __restrict__ tables,
                                             int j, unsigned t, unsigned word) {
  const float* tab = tables + tp.rt_off[j];
  if (tp.rt_const[j]) return __ldg(tab + min((int)t, tp.rt_len[j] - 1));
  return tp.rt_base[j] + (float)count_le(tab, tp.rt_len[j], u01(word));
}

// Actions act[0, n_ro) and demand dem[0, n_rt) of one (lane, episode,
// period) of the random-policy kernels.
__device__ __forceinline__ void draw_period(const NetTopo& tp,
                                            const float* __restrict__ tables,
                                            unsigned seed, unsigned lane,
                                            unsigned e, unsigned t,
                                            float act_scale, float* act,
                                            float* dem) {
  WordStream ws(seed, 0u, lane, e, t);
  for (int i = 0; i < tp.n_ro; ++i) act[i] = (float)(ws.next() >> 8) * act_scale;
  for (int j = 0; j < tp.n_rt; ++j) dem[j] = link_demand(tp, tables, j, t, ws.next());
}
