// The earlier designs of K13 (episode_returns_nv and
// episode_returns_nv_random, Newsvendor), kept for tools/k13_sweep.py to
// time in turns with the package's kernel:
//
// - the first design, a copy of the kernel as csrc/nv_episode.cu held it
//   before the redesign: one thread a lane keeps the episode in
//   nv_step.cuh's NvEpisode, its pipeline ring of NV_MAX_L floats indexed at
//   run time (a frame in local memory), and loads each period's action and
//   demand words (__ldg) only when the serial period loop reaches them;
//   RANDOM draws the period's order from K16's action word of episode 0 at
//   the step. ``nv_episode_returns_first`` launches it at launch.cuh's
//   kThreads, ignoring the params' K13 block;
// - the shared-memory form: one thread a lane, the ring in the lane's
//   column of dynamic shared memory (NvSharedRing, L words), then two
//   staging buffers of ``chunk`` periods (the order word, then the demand
//   word) filled by cp.async, the next chunk copied while this one is
//   stepped one period at a time; RANDOM draws the next chunk's orders into
//   their slots while its copies are in flight. ``nv_episode_returns_smem``
//   launches it at ``threads`` a block.
//
// Built by the sweep with -I or_gym_inventory_torch/csrc; the C entry points
// take the arguments the package's takes (params, econ, acts, dems, disc,
// out, seed, random, B, T, stream), the shared-memory form also its chunk
// and block before the stream. ``k13_empty`` launches a kernel that does
// nothing, the launch floor of this ctypes path.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "launch.cuh"
#include "nv_step.cuh"
#include "philox.cuh"

namespace {

template <bool RANDOM>
__global__ void k_nv_returns_first(const __grid_constant__ NvParams p,
                                   const float* __restrict__ econ,
                                   const float* __restrict__ acts,
                                   const float* __restrict__ dems,
                                   const float* __restrict__ disc,
                                   float* __restrict__ out, unsigned seed, long long B,
                                   int T) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  NvEpisode s;
  nv_reset(p, s);
  s.price = __ldg(econ + b);
  s.cost = __ldg(econ + B + b);
  s.h = __ldg(econ + 2 * B + b);
  s.k = __ldg(econ + 3 * B + b);
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    float order;
    if (RANDOM) {
      WordStream ws(seed, 0u, (unsigned)b, 0u, (unsigned)t);
      order = __fmul_rn(u01(ws.next()), p.max_order);
    } else {
      order = min_nan(max_nan(__ldg(acts + (long long)t * B + b), 0.f), p.max_order);
    }
    const float reward = nv_step(p, s, order, __ldg(dems + (long long)t * B + b));
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), reward));
  }
  out[b] = total;
}

template <bool RANDOM>
__global__ void k_nv_returns_smem(const __grid_constant__ NvParams p,
                                  const float* __restrict__ econ,
                                  const float* __restrict__ acts,
                                  const float* __restrict__ dems,
                                  const float* __restrict__ disc,
                                  float* __restrict__ out, unsigned seed, long long B, int T,
                                  int C) {
  extern __shared__ float nv_words[];
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = blockDim.x;
  float* const stage = nv_words + p.L * n + threadIdx.x;
  auto stage_chunk = [&](int t0, int buf) {
    float* const dst = stage + buf * C * 2 * n;
    const int t1 = min(t0 + C, T);
    for (int t = t0; t < t1; ++t) {
      float* const q = dst + (t - t0) * 2 * n;
      if (!RANDOM) cp_async4(q, acts + (long long)t * B + b);
      cp_async4(q + n, dems + (long long)t * B + b);
    }
    cp_async_commit();
    if (RANDOM) {
      for (int t = t0; t < t1; ++t) {
        WordStream ws(seed, 0u, (unsigned)b, 0u, (unsigned)t);
        dst[(t - t0) * 2 * n] = __fmul_rn(u01(ws.next()), p.max_order);
      }
    }
  };
  const NvSharedRing ring{nv_words + threadIdx.x, n};
  for (int j = 0; j < p.L; ++j) ring(j) = 0.f;
  int head = 0;
  const NvEcon c{__ldg(econ + b), __ldg(econ + B + b), __ldg(econ + 2 * B + b),
                 __ldg(econ + 3 * B + b), 0.f};
  stage_chunk(0, 0);
  float total = 0.f;
  const float* q = stage;
  for (int t = 0, k = C, buf = 1; t < T; ++t, ++k, q += 2 * n) {
    if (k == C) {
      k = 0;
      buf ^= 1;
      if (t + C < T) stage_chunk(t + C, buf ^ 1);
      else cp_async_commit();
      cp_async_wait<1>();
      q = stage + buf * C * 2 * n;
    }
    const float order = RANDOM ? q[0] : min_nan(max_nan(q[0], 0.f), p.max_order);
    float q_cap;
    const float reward = nv_step_ring(p, ring, head, c, order, q[n], q_cap);
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), reward));
  }
  out[b] = total;
}

__global__ void k_empty() {}

}  // namespace

extern "C" {

int nv_episode_returns_first(const NvParams* p, const float* econ, const float* acts,
                             const float* dems, const float* disc, float* out,
                             unsigned seed, int random, long long B, int T,
                             cudaStream_t stream) {
  auto kernel = random ? k_nv_returns_first<true> : k_nv_returns_first<false>;
  kernel<<<blocks_for(B), kThreads, 0, stream>>>(*p, econ, acts, dems, disc, out, seed,
                                                 B, T);
  return (int)cudaGetLastError();
}

int nv_episode_returns_smem(const NvParams* p, const float* econ, const float* acts,
                            const float* dems, const float* disc, float* out,
                            unsigned seed, int random, long long B, int T, int chunk,
                            int threads, cudaStream_t stream) {
  auto kernel = random ? k_nv_returns_smem<true> : k_nv_returns_smem<false>;
  const size_t smem = (size_t)(p->L + 4 * chunk) * threads * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  kernel<<<blocks, threads, smem, stream>>>(*p, econ, acts, dems, disc, out, seed, B, T,
                                            chunk);
  return (int)cudaGetLastError();
}

int k13_empty(cudaStream_t stream) {
  k_empty<<<1, 1, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
