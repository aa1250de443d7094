// InvManagement whole-episode kernels for Hopper (sm_90a), bound with ctypes
// by ops/_build.py and wrapped by ops/episode_kernels.py, whose plain PyTorch
// versions compute the same functions.
//
// K7 k_im_returns  replaces pallas_episode_kernels._im_call (:779) behind
//    episode_returns_im (:802) and episode_returns_im_random (:815); body
//    _im_kernel :750, step _im_step_math :686. One thread per env reads its
//    (T, m1) int32 actions (or, RANDOM, draws them: K8's action words at
//    episode 0) and its (T,) int32 demand, coalesced along B. Bound by
//    bytes: (T * (m1 + 1) + 1) * 4 per env, read once.
// K8 k_im_returns_fused  replaces episode_returns_im_fused (:919, body
//    _im_fused_kernel :868). Actions and demand are drawn in the kernel
//    (im_step.cuh), so only the returns leave it. Bound by operations: per
//    env-step one Philox4x32-10 block (m1 + 1 = 4 words), the step and a
//    binary search of the demand table. One thread per (episode, lane): the
//    TPU interleaved E episodes per lane to hide the serial period chain;
//    here more resident threads do that job, so E only widens the grid.
// K9 k_im_sample_streams  replaces sample_streams_debug_im (:1873, body
//    _im_streams_debug_kernel :901): the streams K8 draws, through the same
//    draws. Bound by bytes: the streams it writes.
//
// The period step and the draws are in im_step.cuh (their notes list the
// semantics that are easy to get wrong). The batch tail is masked, so any
// B >= 1 works. Discount: alpha**t is a Python double rounded to f32 in the
// JAX kernels (:775, :896); the wrapper passes that table.

#include <cuda_runtime.h>

#include "im_step.cuh"
#include "launch.cuh"
#include "philox.cuh"

namespace {

template <bool BACKLOG, bool RANDOM>
__global__ void k_im_returns(const __grid_constant__ ImParams p,
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

template <bool BACKLOG>
__global__ void k_im_returns_fused(const __grid_constant__ ImParams p,
                                   const float* __restrict__ table,
                                   const int* __restrict__ user_d,
                                   const float* __restrict__ disc,
                                   float* __restrict__ out, unsigned seed,
                                   long long B, int E, int T) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  ImEpisode s;
  im_reset(p, s);
  int act[IM_MAX_M1], r_req[IM_MAX_M1];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    WordStream ws(seed, 0u, lane, e, (unsigned)t);
    im_draw_actions(p, ws, act);
    const int d = im_demand(p, table, user_d, t, ws.next());
    const float profit = im_step<BACKLOG>(p, s, t, act, d, r_req);
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
  }
  out[idx] = total;  // (E, B), episode-major
}

__global__ void k_im_sample_streams(const __grid_constant__ ImParams p,
                                    const float* __restrict__ table,
                                    const int* __restrict__ user_d,
                                    int* __restrict__ acts, int* __restrict__ dems,
                                    unsigned seed, long long B, int E, int T) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  int act[IM_MAX_M1];
  for (int t = 0; t < T; ++t) {
    WordStream ws(seed, 0u, lane, e, (unsigned)t);
    im_draw_actions(p, ws, act);
    const long long row = (long long)t * E + e;  // (T, E, m1, B) and (T, E, B)
    for (int i = 0; i < p.m1; ++i) acts[(row * p.m1 + i) * B + lane] = act[i];
    dems[row * B + lane] = im_demand(p, table, user_d, t, ws.next());
  }
}

}  // namespace

extern "C" {

// random != 0: K7 _random, the actions drawn in the kernel (acts unused).
int im_episode_returns(const ImParams* p, const int* acts, const int* dems,
                       const float* disc, float* out, unsigned seed, int random,
                       int backlog, long long B, int T, cudaStream_t stream) {
  auto kernel = backlog ? (random ? k_im_returns<true, true> : k_im_returns<true, false>)
                        : (random ? k_im_returns<false, true> : k_im_returns<false, false>);
  kernel<<<blocks_for(B), kThreads, 0, stream>>>(*p, acts, dems, disc, out, seed, B, T);
  return (int)cudaGetLastError();
}

int im_episode_returns_fused(const ImParams* p, const float* table,
                             const int* user_d, const float* disc, float* out,
                             unsigned seed, int backlog, long long B, int E,
                             int T, cudaStream_t stream) {
  auto kernel = backlog ? k_im_returns_fused<true> : k_im_returns_fused<false>;
  kernel<<<blocks_for(B * E), kThreads, 0, stream>>>(*p, table, user_d, disc, out,
                                                     seed, B, E, T);
  return (int)cudaGetLastError();
}

int im_sample_streams(const ImParams* p, const float* table, const int* user_d,
                      int* acts, int* dems, unsigned seed, long long B, int E,
                      int T, cudaStream_t stream) {
  k_im_sample_streams<<<blocks_for(B * E), kThreads, 0, stream>>>(
      *p, table, user_d, acts, dems, seed, B, E, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
