// The first designs of K3 (sample_streams_debug, NetInvMgmt) and K7
// (episode_returns_im and episode_returns_im_random, InvManagement), kept for
// tools/k3_k7_sweep.py to time in turns with the package's kernels: copies
// of both kernels as csrc/net_episode.cu and csrc/im_episode.cu held them
// before this redesign.
//
// - K3: one thread a (lane, episode) walks the lane's T periods, each
//   period three Philox blocks, the retail links' CDF searches and n_ro +
//   n_rt stores (draw_period), B x W threads of launch.cuh's kThreads.
// - K7: one thread a lane keeps the episode in im_step.cuh's ImEpisode, a
//   1,232-byte frame in local memory, the stage loops to the run-time m1,
//   and loads each period's m1 action words and its demand word (__ldg) on
//   the step's chain; RANDOM draws the actions as K8 does.
//
// Built by the sweep with -I or_gym_inventory_torch/csrc; the C entry
// points take the arguments the package's took then (K3: topo, tables,
// acts, dems, seed, act_scale, B, T, e0, e1, stream; K7: params, acts, dems,
// disc, out, seed, random, backlog, B, T, stream). ``k3_k7_empty`` launches
// a kernel that does nothing, the launch floor of this ctypes path.

#include <cuda_runtime.h>

#include "im_step.cuh"
#include "launch.cuh"
#include "net_step.cuh"
#include "philox.cuh"

namespace {

__global__ void k_sample_streams_first(const __grid_constant__ NetTopo tp,
                                       const float* __restrict__ tables,
                                       float* __restrict__ acts,
                                       float* __restrict__ dems, unsigned seed,
                                       float act_scale, long long B, int T, int e0,
                                       int W) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * W) return;
  const int w = (int)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)w * B);
  for (int t = 0; t < T; ++t) {
    const long long row = (long long)t * W + w;  // (T, W, rows, B)
    draw_period(tp, tables, seed, lane, (unsigned)(e0 + w), (unsigned)t, act_scale,
                ToRows{acts + row * tp.n_ro * B + lane, B, true},
                ToRows{dems + row * tp.n_rt * B + lane, B, true});
  }
}

template <bool BACKLOG, bool RANDOM>
__global__ void k_im_returns_first(const __grid_constant__ ImParams p,
                                   const int* __restrict__ acts,
                                   const int* __restrict__ dems,
                                   const float* __restrict__ disc,
                                   float* __restrict__ out, unsigned seed, long long B,
                                   int T) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  ImEpisode s;
  im_reset(p, s);
  int act[IM_MAX_M1], r_req[IM_MAX_M1];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    if (RANDOM) {
      WordStream ws(seed, 0u, (unsigned)b, 0u, (unsigned)t);
      im_draw_actions(p, ws, act);
    } else {
      for (int i = 0; i < p.m1; ++i)
        act[i] = __ldg(acts + ((long long)t * p.m1 + i) * B + b);
    }
    const int d = __ldg(dems + (long long)t * B + b);
    const float profit = im_step<BACKLOG>(p, s, t, act, d, r_req);
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
  }
  out[b] = total;
}

__global__ void k_empty() {}

}  // namespace

extern "C" {

int net_sample_streams_first(const NetTopo* topo, const float* tables, float* acts,
                             float* dems, unsigned seed, float act_scale, long long B,
                             int T, int e0, int e1, cudaStream_t stream) {
  k_sample_streams_first<<<blocks_for(B * (e1 - e0)), kThreads, 0, stream>>>(
      *topo, tables, acts, dems, seed, act_scale, B, T, e0, e1 - e0);
  return (int)cudaGetLastError();
}

int im_episode_returns_first(const ImParams* p, const int* acts, const int* dems,
                             const float* disc, float* out, unsigned seed, int random,
                             int backlog, long long B, int T, cudaStream_t stream) {
  auto kernel = backlog ? (random ? k_im_returns_first<true, true>
                                  : k_im_returns_first<true, false>)
                        : (random ? k_im_returns_first<false, true>
                                  : k_im_returns_first<false, false>);
  kernel<<<blocks_for(B), kThreads, 0, stream>>>(*p, acts, dems, disc, out, seed, B, T);
  return (int)cudaGetLastError();
}

int k3_k7_empty(cudaStream_t stream) {
  k_empty<<<1, 1, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
