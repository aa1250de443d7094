// The first designs of K1 (episode_returns) and K25 (batched_step), kept for
// tools/net_k1_k25_sweep.py to time in turns with the package's kernels: a
// copy of both kernels as csrc/net_episode.cu held them before their state
// moved into shared memory. One thread a lane keeps the lane's state in
// net_step.cuh's Episode, a 1,792-byte frame in local memory: K1 loads a
// period's n_ro + n_rt words into frame arrays before each step, K25 loads
// the lane's rows into the frame (the arriving order of each link in slot 0
// of its ring), steps one period and writes the rows out. Built by the sweep
// with -I or_gym_inventory_torch/csrc; its C entry points take the arguments
// the package's took then (K1: topo, acts, dems, disc, out, B, T, stream;
// K25: topo, X, Y, U, RH, acts, dems, X', Y', U', RH', reward, disc, t, lt,
// B, stream), the topology packed by ops/net_step.py ``_pack_topology``
// with its cumulative ring offsets. Both step through net_step.cuh's
// step_view as it was then (step_view_first below: the same arithmetic, but
// each of a link's loads issued after the store before it). ``net_empty``
// launches a kernel that does nothing, the launch floor of this ctypes path.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "net_step.cuh"

namespace {

// net_step.cuh's step_view as the first designs ran it
template <class S, class Act, class Dem, class Sink>
__device__ __forceinline__ float step_view_first(const NetTopo& tp, const S& s, const Act& act,
                                                 const Dem& dem, const Sink& r) {
  for (int n = 0; n < tp.n_main; ++n) s.consumed(n) = s.arrivals(n) = s.sold(n) = 0.f;
  float total = 0.f;

  // 0-1) per reorder link: fulfillment with sequential supplier contention,
  // the delivery and the pipeline, the link's profit terms
  for (int i = 0; i < tp.n_ro; ++i) {
    const float req = max_nan(0.f, rintf(act(i)));
    const int sup = tp.ro_sup[i];
    float f = req;
    if (sup >= 0) {
      float avail = max_nan(0.f, s.X(sup) - s.consumed(sup));
      if (tp.is_factory[sup])
        avail = min_nan(avail, min_nan(tp.C[sup], tp.v[sup] * avail));
      f = min_nan(req, avail);
      s.consumed(sup) = s.consumed(sup) + __fdiv_rn(f, tp.v[sup]);
      s.sold(sup) += f;
    } else {
      total -= tp.ro_price[i] * f;
    }
    r(i, f);
    const int L = tp.ro_L[i];
    float a = f;
    if (L > 0) {
      int& slot = s.slot(i);
      float& cell = s.ring(tp.ro_ring[i] + slot);
      a = cell;
      cell = f;
      slot = slot + 1 == L ? 0 : slot + 1;
    }
    const float y = s.Y(i) - a + f;
    s.Y(i) = y;
    s.arrivals(tp.ro_pur[i]) += a;
    total -= tp.ro_g[i] * max_nan(0.f, y);
  }
  for (int n = 0; n < tp.n_main; ++n)
    s.X(n) = s.X(n) + s.arrivals(n) - s.consumed(n);

  // 2-4) sequential retail fulfillment, with its revenue and backlog penalty
  for (int j = 0; j < tp.n_rt; ++j) {
    const int ret = tp.rt_ret[j];
    const float to_fill = max_nan(0.f, rintf(dem(j))) + s.U(j);
    const float sl = min_nan(to_fill, max_nan(0.f, s.X(ret)));
    s.X(ret) = s.X(ret) - sl;
    s.sold(ret) += sl;
    const float u = tp.backlog ? to_fill - sl : 0.f;
    s.U(j) = u;
    total += tp.rt_price[j] * sl - tp.rt_b[j] * u;
  }

  // 5) per-node holding and operating costs
  for (int n = 0; n < tp.n_main; ++n) {
    const float HC = tp.h[n] * max_nan(0.f, s.X(n));
    const float OC = tp.is_factory[n] ? __fdiv_rn(tp.o[n] * s.sold(n), tp.v[n]) : 0.f;
    total -= HC + OC;
  }
  return total;
}

__device__ __forceinline__ float step_period_first(const NetTopo& tp, Episode& s,
                                                   const float* act, const float* dem,
                                                   float* r) {
  return step_view_first(tp, FrameView{s}, FromArray{act}, FromArray{dem}, ToArray{r});
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
  float act[NET_MAX_RO], dem[NET_MAX_RT], r[NET_MAX_RO];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < tp.n_ro; ++i)
      act[i] = __ldg(acts + ((long long)t * tp.n_ro + i) * B + b);
    for (int j = 0; j < tp.n_rt; ++j)
      dem[j] = __ldg(dems + ((long long)t * tp.n_rt + j) * B + b);
    total += __ldg(disc + t) * step_period_first(tp, s, act, dem, r);
  }
  out[b] = total;
}

__global__ void k_batched_step(const __grid_constant__ NetTopo tp,
                               const float* __restrict__ X, const float* __restrict__ Y,
                               const float* __restrict__ U, const float* __restrict__ RH,
                               const float* __restrict__ acts,
                               const float* __restrict__ dems, float* __restrict__ Xo,
                               float* __restrict__ Yo, float* __restrict__ Uo,
                               float* __restrict__ RHo, float* __restrict__ rew,
                               float disc, int t, int lt, long long B) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n_ro = tp.n_ro;
  Episode s;
  for (int n = 0; n < tp.n_main; ++n) s.X[n] = X[n * B + b];
  for (int j = 0; j < tp.n_rt; ++j) s.U[j] = U[j * B + b];
  float act[NET_MAX_RO], dem[NET_MAX_RT], r[NET_MAX_RO];
  for (int i = 0; i < n_ro; ++i) {
    s.Y[i] = Y[i * B + b];
    s.slot[i] = 0;
    const int L = tp.ro_L[i];
    if (L > 0)
      s.ring[tp.ro_ring[i]] = RH[((long long)(L - 1) * n_ro + i) * B + b] * (t >= L ? 1.f : 0.f);
    act[i] = acts[i * B + b];
  }
  for (int j = 0; j < tp.n_rt; ++j) dem[j] = dems[j * B + b];
  const float profit = step_period_first(tp, s, act, dem, r);
  for (int n = 0; n < tp.n_main; ++n) Xo[n * B + b] = s.X[n];
  for (int j = 0; j < tp.n_rt; ++j) Uo[j * B + b] = s.U[j];
  for (int i = 0; i < n_ro; ++i) {
    Yo[i * B + b] = s.Y[i];
    RHo[i * B + b] = r[i];
  }
  for (long long k = n_ro; k < (long long)lt * n_ro; ++k) RHo[k * B + b] = RH[(k - n_ro) * B + b];
  rew[b] = disc * profit;
}

__global__ void k_empty() {}

}  // namespace

extern "C" {

int net_episode_returns(const NetTopo* topo, const float* acts, const float* dems,
                        const float* disc, float* out, long long B, int T,
                        cudaStream_t stream) {
  k_episode_returns<<<blocks_for(B), kThreads, 0, stream>>>(*topo, acts, dems, disc, out, B,
                                                            T);
  return (int)cudaGetLastError();
}

int net_batched_step(const NetTopo* topo, const float* X, const float* Y, const float* U,
                     const float* RH, const float* acts, const float* dems, float* Xo,
                     float* Yo, float* Uo, float* RHo, float* rew, float disc, int t, int lt,
                     long long B, cudaStream_t stream) {
  k_batched_step<<<blocks_for(B), kThreads, 0, stream>>>(*topo, X, Y, U, RH, acts, dems, Xo,
                                                         Yo, Uo, RHo, rew, disc, t, lt, B);
  return (int)cudaGetLastError();
}

int net_empty(cudaStream_t stream) {
  k_empty<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
