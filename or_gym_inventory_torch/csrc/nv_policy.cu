// Newsvendor kernels under a folded MLP actor, and the dump of the policy
// kernels' normals, for Hopper (sm_90a), bound with ctypes by ops/_build.py
// and wrapped by ops/episode_kernels.py, whose plain PyTorch versions compute
// the same functions.
//
// K18 k_nv_rollout_traj  replaces pallas_episode_kernels.rollout_traj_nv
//    (:1796; body _nv_traj_kernel :1752, policy head traj_policy "ppo" :1036,
//    trunk mlp_forward :1124). One stochastic-policy episode per lane, the
//    reset, the per-lane Poisson(mu) demand and the actor all in the kernel,
//    the training streams written to device memory: econ (5, B), the capped
//    orders, the pre-squash raws, the undiscounted rewards and the demand,
//    (T[, 1], B) each, coalesced along B. PPO with rollout="kernel" feeds on
//    it.
// K19/K20 k_nv_policy_returns  replace _nv_policy_call (:603) behind
//    episode_returns_nv_policy (:648) and its stream-dumping twin
//    sample_policy_streams_debug_nv (:665; body _nv_policy_kernel :544): the
//    same policy, deterministic or stochastic, E episodes per lane, returns
//    (E, B) gamma^t-discounted; with DUMP it also writes the econ (E, 5, B),
//    the orders before the max_inventory cap (T, E, B) and the demand
//    (T, E, B) it used.
// K28 k_nv_rollout_traj_wide  replaces rollout_traj_nv (:1796) under the
//    off-policy heads traj_policy "det", "sac" and "uniform" (:1062-1080) on
//    a relu (or tanh) trunk, the collection of OffPolicyConfig(collect=
//    "kernel"): K18's streams, the raw stream holding the normalised [-1, 1]
//    orders. The actor is wide_mlp.cuh's (a block per 32 lanes); threads
//    0..31 own the lanes' resets, demand chunks and pipelines. Bound by
//    operations: the (256, 256) actor's ~1.4e5 per env-step.
// K21 k_sample_normals  replaces sample_normals_debug (:1849): the
//    Box-Muller normals of the policy kernels' generator, (rows, B), for the
//    goodness-of-fit pin.
//
// Design (a simple kernel first): one thread per lane (K18) or per
// (episode, lane) (K19/K20), as K10/K11. The step, the reset's formulas and
// the inversion are nv_step.cuh's, unchanged; the actor is mlp.cuh's
// (weights and activations in shared memory: 5,905 floats of weights for the
// default 10-64-64-1 actor and 64 KB of activations at 128 threads). The
// observation is assembled from the live state in the order of
// _nv_policy_kernel (:586) and _nv_traj_kernel (:1783): econ, then the
// pipeline oldest first, ring[(head + j) % L]. Demand does not depend on the
// orders, so each chunk of NV_CHUNK = 16 periods first draws its 16 demand
// words and inverts them with one recurrence, then runs its 16 policy
// periods; the chunk's demands wait in a small local array. Bound by
// operations: the MLP's ~9,900 per env-step dwarf the step and the draws.
// K21 writes one float per two words: bound by bytes.
//
// Random stream (philox.cuh): key (seed, 1), counter (lane, episode, period,
// block). The reset's five uniforms are the first five words of period
// NV_ECON_PERIOD; period t's word 0 is its demand's uniform and, when
// stochastic, words 1 and 2 the u1 and u2 of its normal (act_dim 1), so the
// policy period recomputes the period's block for them. K18 is episode 0, so
// episode 0 of the stochastic K19 draws exactly K18's words and takes K18's
// orders for the same seed; the deterministic K19 draws one word a period.
// K28 draws K18's reset and demand words; its head's words are words 1 and 2
// of the period (word 1 alone for "uniform").
// K21's element (row, lane) is normal01(word 0, word 1) of counter
// (lane, 0, row, 0).
//
// Rounding: raw = H + std * z with two roundings (__fmul_rn/__fadd_rn), and
// order = (tanh(raw) + 1) * f32(0.5 max_order), each operation rounded
// alone, as the plain version computes them; no integer cast. The MLP sums
// in another order than a matmul and tanhf may differ from the CPU's by an
// ulp; the pipeline feeds the orders back, so kernel and plain version are
// held by the share of lanes that agree. A NaN std gives NaN raws, orders
// and returns; the draws and the econ stay as they are (nanmath.cuh).

#include <cuda_runtime.h>

#include "launch.cuh"
#include "mlp.cuh"
#include "nv_step.cuh"
#include "philox.cuh"
#include "wide_mlp.cuh"

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

// The demand of periods t0 .. t0 + NV_CHUNK - 1 (word 0 of each), inverted
// with one recurrence; past the horizon no step reads it.
__device__ __forceinline__ void chunk_demand(const NvParams& p, const NvPoisson& q,
                                             unsigned seed, unsigned lane, unsigned e,
                                             int t0, int T, float* d) {
  float v[NV_CHUNK];
#pragma unroll
  for (int i = 0; i < NV_CHUNK; ++i) {
    v[i] = 0.f;
    if (t0 + i < T) {
      WordStream ws(seed, 1u, lane, e, (unsigned)(t0 + i));
      v[i] = __fmul_rn(__fsub_rn(1.f, u01(ws.next())), q.total);
    }
  }
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

template <bool STOCH, bool DUMP>
__global__ void k_nv_policy_returns(const __grid_constant__ NvParams p,
                                    const __grid_constant__ Mlp m,
                                    const float* __restrict__ params, int n_params,
                                    const float* __restrict__ lgam,
                                    const float* __restrict__ disc,
                                    float* __restrict__ out, float* __restrict__ econo,
                                    float* __restrict__ acto, float* __restrict__ demo,
                                    unsigned seed, long long B, int E, int T) {
  float *h0, *h1;
  const float* sw = load_params(m, params, n_params, h0, h1);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  const float stdv = STOCH ? sw[n_params - 1] : 0.f;
  NvEpisode s;
  policy_reset(p, seed, lane, e, s);
  if (DUMP) {
    float* row = econo + (long long)e * 5 * B + lane;  // (E, 5, B)
    row[0] = s.price;
    row[B] = s.cost;
    row[2 * B] = s.h;
    row[3 * B] = s.k;
    row[4 * B] = s.mu;
  }
  const NvPoisson q = nv_poisson_setup(p, lgam, s.mu);
  float total = 0.f;
  for (int t0 = 0; t0 < T; t0 += NV_CHUNK) {
    float d[NV_CHUNK];
    chunk_demand(p, q, seed, lane, e, t0, T, d);
    const int n = min(NV_CHUNK, T - t0);
    for (int i = 0; i < n; ++i) {
      const int t = t0 + i;
      float raw;
      const float order = policy_period<STOCH>(p, m, sw, stdv, seed, lane, e, t, s, h0, h1,
                                               raw);
      if (DUMP) {
        const long long k = ((long long)t * E + e) * B + lane;  // (T, E, B)
        acto[k] = order;
        demo[k] = d[i];
      }
      total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), nv_step(p, s, order, d[i])));
    }
  }
  out[idx] = total;  // (E, B), episode-major
}

__global__ void k_sample_normals(float* __restrict__ out, unsigned seed, long long B,
                                 long long n) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const unsigned row = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)row * B);
  WordStream ws(seed, 1u, lane, 0u, row);
  const unsigned w0 = ws.next();
  out[idx] = normal01(w0, ws.next());  // (rows, B)
}

template <bool RELU>
__global__ void __launch_bounds__(kWideThreads)
    k_nv_rollout_traj_wide(const __grid_constant__ NvParams p,
                           const __grid_constant__ WideMlp m, const float* __restrict__ w,
                           const float* __restrict__ lgam, float* __restrict__ econo,
                           float* __restrict__ ordo, float* __restrict__ rawo,
                           float* __restrict__ rewo, float* __restrict__ demo, unsigned seed,
                           long long B, int T) {
  extern __shared__ float4 smem4[];
  float* x0 = reinterpret_cast<float*>(smem4);
  float* x1 = x0 + m.rows * kWideLanes;
  const int n = threadIdx.x;
  const long long b = (long long)blockIdx.x * kWideLanes + n;
  const bool lane = n < kWideLanes, live = lane && b < B;
  const bool actor = m.head != kHeadUniform;
  const unsigned ln = (unsigned)b;
  NvEpisode s;
  NvPoisson q;
  if (lane) {
    policy_reset(p, seed, ln, 0u, s);
    if (live) {
      econo[b] = s.price;
      econo[B + b] = s.cost;
      econo[2 * B + b] = s.h;
      econo[3 * B + b] = s.k;
      econo[4 * B + b] = s.mu;
    }
    q = nv_poisson_setup(p, lgam, s.mu);
  }
  for (int t0 = 0; t0 < T; t0 += NV_CHUNK) {
    float d[NV_CHUNK];
    if (lane) chunk_demand(p, q, seed, ln, 0u, t0, T, d);
    const int cn = min(NV_CHUNK, T - t0);
    for (int i = 0; i < cn; ++i) {
      const int t = t0 + i;
      float z[WIDE_MAX_ACT];
      if (lane) {
        WordStream ws(seed, 1u, ln, 0u, (unsigned)t);
        ws.next();  // word 0: the period's demand
        wide_noise(m, ws, z);
        if (actor) {
          x0[n] = s.price;
          x0[kWideLanes + n] = s.cost;
          x0[2 * kWideLanes + n] = s.h;
          x0[3 * kWideLanes + n] = s.k;
          x0[4 * kWideLanes + n] = s.mu;
          for (int j = 0; j < p.L; ++j) {
            int k = s.head + j;
            if (k >= p.L) k -= p.L;
            x0[(5 + j) * kWideLanes + n] = s.ring[k];
          }
        }
      }
      const float* H = actor ? wide_forward<RELU>(m, w, x0, x1) : x0;
      if (lane) {
        float st, qty;
        const float a = wide_head(m, w, H, n, 0, z[0], st);
        const float order = __fmul_rn(__fadd_rn(a, 1.f), m.half_hi[0]);
        const float reward = nv_step(p, s, order, d[i], qty);
        if (live) {
          const long long k = (long long)t * B + b;  // (T, B) and (T, 1, B)
          ordo[k] = qty;
          rawo[k] = st;
          rewo[k] = reward;
          demo[k] = d[i];
        }
      }
    }
  }
}

template <bool STOCH, bool DUMP>
int launch_policy_returns(const NvParams& p, const Mlp& m, const float* params,
                          int n_params, const float* lgam, const float* disc, float* out,
                          float* econ, float* acts, float* dems, unsigned seed,
                          long long B, int E, int T, cudaStream_t stream) {
  auto kernel = k_nv_policy_returns<STOCH, DUMP>;
  const size_t smem = smem_bytes(m, n_params);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_for(B * E), kThreads, smem, stream>>>(p, m, params, n_params, lgam, disc,
                                                        out, econ, acts, dems, seed, B, E, T);
  return (int)cudaGetLastError();
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

// acts == nullptr: returns only (K19); otherwise also econ, acts and dems (K20).
int nv_policy_returns(const NvParams* p, const Mlp* mlp, const float* params, int n_params,
                      const float* lgam, const float* disc, float* out, float* econ,
                      float* acts, float* dems, unsigned seed, int stochastic, long long B,
                      int E, int T, cudaStream_t stream) {
  const bool dump = acts != nullptr;
  if (stochastic)
    return dump ? launch_policy_returns<true, true>(*p, *mlp, params, n_params, lgam, disc,
                                                    out, econ, acts, dems, seed, B, E, T,
                                                    stream)
                : launch_policy_returns<true, false>(*p, *mlp, params, n_params, lgam, disc,
                                                     out, econ, acts, dems, seed, B, E, T,
                                                     stream);
  return dump ? launch_policy_returns<false, true>(*p, *mlp, params, n_params, lgam, disc,
                                                   out, econ, acts, dems, seed, B, E, T,
                                                   stream)
              : launch_policy_returns<false, false>(*p, *mlp, params, n_params, lgam, disc,
                                                    out, econ, acts, dems, seed, B, E, T,
                                                    stream);
}

int nv_rollout_traj_wide(const NvParams* p, const WideMlp* wm, const float* w,
                         const float* lgam, float* econ, float* orders, float* raw, float* rew,
                         float* dem, unsigned seed, int relu, long long B, int T,
                         cudaStream_t stream) {
  auto kernel = relu ? k_nv_rollout_traj_wide<true> : k_nv_rollout_traj_wide<false>;
  const size_t smem = wide_smem_bytes(*wm);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<wide_blocks(B), kWideThreads, smem, stream>>>(*p, *wm, w, lgam, econ, orders, raw,
                                                         rew, dem, seed, B, T);
  return (int)cudaGetLastError();
}

int sample_normals(float* out, unsigned seed, long long B, int rows, cudaStream_t stream) {
  const long long n = B * rows;
  k_sample_normals<<<blocks_for(n), kThreads, 0, stream>>>(out, seed, B, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
