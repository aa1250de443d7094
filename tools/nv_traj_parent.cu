// The first design of K18 (rollout_traj_nv's PPO head), kept for
// tools/ppo_traj_sweep.py to time in turns with the package's kernel: a
// copy of the kernel as csrc/nv_policy.cu held it before K18 moved onto
// K19's tensor-core tile (one thread a lane, the episode in a local frame,
// the demand counted linearly a chunk of NV_CHUNK periods at a time, the
// 64x64 tanh actor on the FP32 cores, csrc/mlp.cuh). Built by the sweep
// with -I or_gym_inventory_torch/csrc; its C entry point takes the
// arguments the package's ``nv_rollout_traj`` took then (params, mlp,
// actor, n_actor, lgamma, econ, orders, raw, reward, demand, seed, B, T,
// stream), packed by ops/episode_kernels.py ``_pack_actor``.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "mlp.cuh"
#include "nv_step.cuh"
#include "philox.cuh"

namespace {

// The reset of one (lane, episode): the economics from the first five words
// of period NV_ECON_PERIOD, an empty pipeline.
__device__ __forceinline__ void policy_reset(const NvParams& p, unsigned seed,
                                             unsigned lane, unsigned e, NvEpisode& s) {
  nv_reset(p, s);
  WordStream ws(seed, 1u, lane, e, NV_ECON_PERIOD);
  float u[5];
  for (int r = 0; r < 5; ++r) u[r] = u01(ws.next());
  nv_econ(p, u, s);
}

// The thresholds v = (1 - u) * total of periods t0 .. t0 + NV_CHUNK - 1
// (u from word 0 of each); 0 past the horizon, where no step reads them.
__device__ __forceinline__ void chunk_thresholds(const NvPoisson& q, unsigned seed,
                                                 unsigned lane, unsigned e, int t0, int T,
                                                 float* v) {
#pragma unroll
  for (int i = 0; i < NV_CHUNK; ++i) {
    v[i] = 0.f;
    if (t0 + i < T) {
      WordStream ws(seed, 1u, lane, e, (unsigned)(t0 + i));
      v[i] = __fmul_rn(__fsub_rn(1.f, u01(ws.next())), q.total);
    }
  }
}

// The demand of periods t0 .. t0 + NV_CHUNK - 1, inverted with one
// recurrence.
__device__ __forceinline__ void chunk_demand(const NvParams& p, const NvPoisson& q,
                                             unsigned seed, unsigned lane, unsigned e,
                                             int t0, int T, float* d) {
  float v[NV_CHUNK];
  chunk_thresholds(q, seed, lane, e, t0, T, v);
  nv_poisson_invert(p, q, v, d);
}

// The policy's raw sample and order of one (lane, episode, period): the
// observation of the live state into h0, the actor, the head. Returns the
// order, before the max_inventory cap.
template <bool STOCH>
__device__ __forceinline__ float policy_period(const NvParams& p, const Mlp& m,
                                               const float* w, float stdv, unsigned seed,
                                               unsigned lane, unsigned e, int t,
                                               const NvEpisode& s, float* h0, float* h1,
                                               float& raw) {
  col(h0, 0) = s.price;
  col(h0, 1) = s.cost;
  col(h0, 2) = s.h;
  col(h0, 3) = s.k;
  col(h0, 4) = s.mu;
  for (int j = 0; j < p.L; ++j) {
    int k = s.head + j;
    if (k >= p.L) k -= p.L;
    col(h0, 5 + j) = s.ring[k];
  }
  float x = col(mlp_forward(m, w, h0, h1), 0);
  if (STOCH) {
    WordStream ws(seed, 1u, lane, e, (unsigned)t);
    ws.next();  // word 0: the period's demand
    const unsigned u1 = ws.next();
    x = __fadd_rn(x, __fmul_rn(stdv, normal01(u1, ws.next())));
  }
  raw = x;
  return __fmul_rn(__fadd_rn(tanhf(x), 1.f), m.half_hi[0]);
}

__global__ void k_nv_rollout_traj(const __grid_constant__ NvParams p,
                                  const __grid_constant__ Mlp m,
                                  const float* __restrict__ params, int n_params,
                                  const float* __restrict__ lgam,
                                  float* __restrict__ econo, float* __restrict__ ordo,
                                  float* __restrict__ rawo, float* __restrict__ rewo,
                                  float* __restrict__ demo, unsigned seed, long long B,
                                  int T) {
  float *h0, *h1;
  const float* sw = load_params(m, params, n_params, h0, h1);
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const unsigned lane = (unsigned)b;
  const float stdv = sw[n_params - 1];
  NvEpisode s;
  policy_reset(p, seed, lane, 0u, s);
  econo[b] = s.price;
  econo[B + b] = s.cost;
  econo[2 * B + b] = s.h;
  econo[3 * B + b] = s.k;
  econo[4 * B + b] = s.mu;
  const NvPoisson q = nv_poisson_setup(p, lgam, s.mu);
  for (int t0 = 0; t0 < T; t0 += NV_CHUNK) {
    float d[NV_CHUNK];
    chunk_demand(p, q, seed, lane, 0u, t0, T, d);
    const int n = min(NV_CHUNK, T - t0);
    for (int i = 0; i < n; ++i) {
      const int t = t0 + i;
      float raw, qty;
      const float order = policy_period<true>(p, m, sw, stdv, seed, lane, 0u, t, s, h0, h1,
                                              raw);
      const float reward = nv_step(p, s, order, d[i], qty);
      const long long k = (long long)t * B + b;  // (T, B) and (T, 1, B)
      ordo[k] = qty;
      rawo[k] = raw;
      rewo[k] = reward;
      demo[k] = d[i];
    }
  }
}

}  // namespace

extern "C" {

int nv_rollout_traj(const NvParams* p, const Mlp* mlp, const float* params, int n_params,
                    const float* lgam, float* econ, float* orders, float* raw, float* rew,
                    float* dem, unsigned seed, long long B, int T, cudaStream_t stream) {
  const size_t smem = smem_bytes(*mlp, n_params);
  cudaError_t err = allow_smem(k_nv_rollout_traj, smem);
  if (err != cudaSuccess) return (int)err;
  k_nv_rollout_traj<<<blocks_for(B), kThreads, smem, stream>>>(
      *p, *mlp, params, n_params, lgam, econ, orders, raw, rew, dem, seed, B, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
