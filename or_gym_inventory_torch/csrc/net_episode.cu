// NetInvMgmt whole-episode kernels for Hopper (sm_90a), bound with ctypes
// by ops/_build.py and wrapped by ops/net_step.py, whose plain PyTorch
// versions compute the same functions.
//
// K1 k_episode_returns  replaces pallas_net_step.episode_returns (:820,
//    body _episode_kernel_body :144, step _step_math :34). One thread per
//    env reads its (T, n_ro) actions and (T, n_rt) demands, coalesced along
//    B, and keeps the state in registers and local memory for the whole
//    episode. Bound by bytes: (T*(n_ro+n_rt)+1)*4 per env, read once.
// K2 k_episode_returns_fused  replaces episode_returns_fully_fused (:379).
//    Actions and demand are drawn in the kernel (philox.cuh draw_period),
//    so only the returns leave it. Bound by operations: per env-step three
//    Philox4x32-10 blocks, the contention chain, deliveries, retail, profit
//    and one binary search per table link. One thread per (episode, lane):
//    the TPU interleaved E episodes per lane to hide the serial contention
//    chain (:312-318); here more resident threads do that job, so E only
//    widens the grid.
// K3 k_sample_streams  replaces sample_streams_debug (:427). It writes the
//    streams K2 draws for episodes [e0, e1), through the same draw_period.
//    The counter-based generator needs no replay of the other episodes.
//    Bound by bytes: the streams it writes.
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
//   no validity mask is needed for t < L_i. Indexed at run time, it lives in
//   local memory (cached in L1, spilling to L2), as do the per-node arrays
//   indexed by supplier and purchaser.
// - Discount: alpha**t is a Python double rounded to f32 in the JAX kernel
//   (:165); the wrapper passes that table, the kernel calls no powf.
// - The batch tail is masked, so any B >= 1 works (no TPU tile assert).
// - FMA contraction is left on, so the profit may differ from the plain
//   version in the last bits; the state (integer-valued floats) is exact.
// - fmaxf/fminf drop a NaN operand where jnp.maximum/minimum propagate it;
//   the inputs here are finite.

#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

struct Episode {
  float X[NET_MAX_MAIN];
  float Y[NET_MAX_RO];
  float U[NET_MAX_RT];
  float ring[NET_MAX_RING];
  int slot[NET_MAX_RO];
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

// One period (pallas_net_step._step_math); returns the undiscounted profit.
__device__ __forceinline__ float step_period(const NetTopo& tp, Episode& s,
                                             const float* act,
                                             const float* dem) {
  float consumed[NET_MAX_MAIN], arrivals[NET_MAX_MAIN];
  for (int n = 0; n < tp.n_main; ++n) consumed[n] = arrivals[n] = 0.f;

  // 0) order fulfillment with sequential supplier contention
  float r[NET_MAX_RO];
  for (int i = 0; i < tp.n_ro; ++i) {
    const float req = fmaxf(0.f, rintf(act[i]));
    const int sup = tp.ro_sup[i];
    float f = req;
    if (sup >= 0) {
      float avail = fmaxf(0.f, s.X[sup] - consumed[sup]);
      if (tp.is_factory[sup])
        avail = fminf(avail, fminf(tp.C[sup], tp.v[sup] * avail));
      f = fminf(req, avail);
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
    const float to_fill = fmaxf(0.f, rintf(dem[j])) + s.U[j];
    const float sl = fminf(to_fill, fmaxf(0.f, s.X[ret]));
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
    HCp[pur] += tp.ro_g[i] * fmaxf(0.f, s.Y[i]);
  }
  for (int j = 0; j < tp.n_rt; ++j) {
    const int ret = tp.rt_ret[j];
    SR[ret] += tp.rt_price[j] * sales[j];
    sold[ret] += sales[j];
    UP[ret] += tp.rt_b[j] * s.U[j];
  }
  float total = 0.f;
  for (int n = 0; n < tp.n_main; ++n) {
    const float HC = tp.h[n] * fmaxf(0.f, s.X[n]) + HCp[n];
    const float OC = tp.is_factory[n] ? __fdiv_rn(tp.o[n] * sold[n], tp.v[n]) : 0.f;
    total += SR[n] - PC[n] - OC - HC - UP[n];
  }
  return total;
}

__global__ void k_episode_returns(const __grid_constant__ NetTopo tp,
                                  const float* __restrict__ acts,
                                  const float* __restrict__ dems,
                                  const float* __restrict__ disc,
                                  float* __restrict__ out, long long B, int T) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  Episode s;
  episode_reset(tp, s);
  float act[NET_MAX_RO], dem[NET_MAX_RT];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < tp.n_ro; ++i)
      act[i] = __ldg(acts + ((long long)t * tp.n_ro + i) * B + b);
    for (int j = 0; j < tp.n_rt; ++j)
      dem[j] = __ldg(dems + ((long long)t * tp.n_rt + j) * B + b);
    total += __ldg(disc + t) * step_period(tp, s, act, dem);
  }
  out[b] = total;
}

__global__ void k_episode_returns_fused(const __grid_constant__ NetTopo tp,
                                        const float* __restrict__ disc,
                                        const float* __restrict__ tables,
                                        float* __restrict__ out, unsigned seed,
                                        float act_scale, long long B, int E,
                                        int T) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  Episode s;
  episode_reset(tp, s);
  float act[NET_MAX_RO], dem[NET_MAX_RT];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    draw_period(tp, tables, seed, lane, e, (unsigned)t, act_scale, act, dem);
    total += __ldg(disc + t) * step_period(tp, s, act, dem);
  }
  out[idx] = total;  // (E, B), episode-major
}

__global__ void k_sample_streams(const __grid_constant__ NetTopo tp,
                                 const float* __restrict__ tables,
                                 float* __restrict__ acts,
                                 float* __restrict__ dems, unsigned seed,
                                 float act_scale, long long B, int T, int e0,
                                 int W) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * W) return;
  const int w = (int)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)w * B);
  float act[NET_MAX_RO], dem[NET_MAX_RT];
  for (int t = 0; t < T; ++t) {
    draw_period(tp, tables, seed, lane, (unsigned)(e0 + w), (unsigned)t,
                act_scale, act, dem);
    const long long row = (long long)t * W + w;  // (T, W, rows, B)
    for (int i = 0; i < tp.n_ro; ++i) acts[(row * tp.n_ro + i) * B + lane] = act[i];
    for (int j = 0; j < tp.n_rt; ++j) dems[(row * tp.n_rt + j) * B + lane] = dem[j];
  }
}

constexpr int kThreads = 128;

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int net_episode_returns(const NetTopo* topo, const float* acts,
                        const float* dems, const float* disc, float* out,
                        long long B, int T, cudaStream_t stream) {
  k_episode_returns<<<blocks_for(B), kThreads, 0, stream>>>(*topo, acts, dems,
                                                            disc, out, B, T);
  return (int)cudaGetLastError();
}

int net_episode_returns_fused(const NetTopo* topo, const float* disc,
                              const float* tables, float* out, unsigned seed,
                              float act_scale, long long B, int E, int T,
                              cudaStream_t stream) {
  k_episode_returns_fused<<<blocks_for(B * E), kThreads, 0, stream>>>(
      *topo, disc, tables, out, seed, act_scale, B, E, T);
  return (int)cudaGetLastError();
}

int net_sample_streams(const NetTopo* topo, const float* tables, float* acts,
                       float* dems, unsigned seed, float act_scale, long long B,
                       int T, int e0, int e1, cudaStream_t stream) {
  k_sample_streams<<<blocks_for(B * (e1 - e0)), kThreads, 0, stream>>>(
      *topo, tables, acts, dems, seed, act_scale, B, T, e0, e1 - e0);
  return (int)cudaGetLastError();
}

const char* net_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
