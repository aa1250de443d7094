// NetInvMgmt episode kernels under a folded MLP actor, for Hopper (sm_90a),
// bound with ctypes by ops/_build.py and wrapped by ops/net_step.py, whose
// plain PyTorch versions compute the same functions.
//
// K4 k_rollout_traj  replaces pallas_net_step.rollout_traj_net (:683, body
//    _net_traj_kernel :629, policy head pallas_episode_kernels.traj_policy
//    "ppo" :1036). One stochastic-policy episode per lane, the training
//    streams written to device memory: start-of-period X and U (T+1
//    snapshots), fulfilled orders r, pre-squash raws, alpha^t rewards and
//    demand, each (T[+1], rows, B) and coalesced along B.
// K5/K6 k_policy_returns  replace _net_policy_call (:554) behind
//    episode_returns_net_policy (:611) and its stream-dumping twin
//    sample_policy_streams_debug_net (:756): the same policy, deterministic
//    or stochastic, E episodes per lane, returns (E, B); with DUMP it also
//    writes the squashed actions and the demand it used.
// K29 k_rollout_traj_wide  replaces rollout_traj_net (:683) under the
//    off-policy heads traj_policy "det", "sac" and "uniform" (:1062-1080) on
//    a relu (or tanh) trunk, the collection of OffPolicyConfig(collect=
//    "kernel"): K4's streams, the raw stream holding the normalised [-1, 1]
//    actions. The actor is wide_mlp.cuh's (a block per 32 lanes); threads
//    0..31 own the lanes' envs (net_step.cuh). Bound by operations: the
//    (256, 256) actor's ~1.7e5 per env-step.
//
// Design (a simple kernel first): one thread per (lane, episode), as K2 has.
// The actor runs as mlp.cuh has it: weights and activations in shared
// memory, ~9,600 floats (38.5 KB) of weights for the default 68-64-64-11
// actor and 68 KB of activations at 128 threads, so two blocks fit an SM.
// The observation is assembled from the live state in the order of
// pallas_net_step._net_obs_rows (:482): U, X, then each reorder link's window
// r[t-L..t-1] oldest first, read from net_step.cuh's per-link ring
// (order_window). Bound by operations: the MLP's ~18,600 per env-step dwarf
// the step and the draws. wgmma/mma tiles across lanes, TMA and the step's
// state out of local memory are later work.
//
// Random stream (net_step.cuh, philox.cuh): key (seed, 1), counter (lane,
// episode, period, block); per period the n_rt demand words, then the n_ro
// u1 and the n_ro u2 words when stochastic (K29: the head's words, the n_ro
// u1 words alone for "uniform"), so K29's demand is K4's for the same seed.
//
// Rounding: act = (tanh(raw) + 1) * f32(0.5 * act_hi) as the JAX kernels
// write it; raw = H + std * z with two roundings (__fmul_rn/__fadd_rn), as
// the plain version computes it. The MLP sums in another order than a
// matmul, so a lane whose action lands on a rint tie may take the other
// integer and diverge from the plain version (the fraction-closeness rule
// of ROADMAP.md Queue C): they are
// held by the share of lanes that agree.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "mlp.cuh"
#include "net_step.cuh"
#include "philox.cuh"
#include "wide_mlp.cuh"

namespace {

// The observation of the period-t state (pallas_net_step._net_obs_rows),
// into the activation column h.
__device__ __forceinline__ void assemble_obs(const NetTopo& tp,
                                             const Episode& s, float* h) {
  int k = 0;
  for (int j = 0; j < tp.n_rt; ++j) col(h, k++) = s.U[j];
  for (int n = 0; n < tp.n_main; ++n) col(h, k++) = s.X[n];
  for (int i = 0; i < tp.n_ro; ++i)
    for (int j = 0; j < tp.ro_L[i]; ++j) col(h, k++) = order_window(tp, s, i, j);
}

// Demand, then the policy's raw and squashed actions, of one (lane,
// episode, period).
template <bool STOCH>
__device__ __forceinline__ void policy_period(
    const NetTopo& tp, const Mlp& m, const float* w, const float* stdv,
    const float* __restrict__ tables, unsigned seed, unsigned lane, unsigned e,
    unsigned t, const Episode& s, float* h0, float* h1, float* raw, float* act,
    float* dem) {
  WordStream ws(seed, 1u, lane, e, t);
  for (int j = 0; j < tp.n_rt; ++j) dem[j] = link_demand(tp, tables, j, t, ws.next());
  assemble_obs(tp, s, h0);
  float* H = mlp_forward(m, w, h0, h1);
  unsigned w1[NET_MAX_RO];
  if (STOCH)
    for (int i = 0; i < tp.n_ro; ++i) w1[i] = ws.next();
  for (int i = 0; i < tp.n_ro; ++i) {
    float x = col(H, i);
    if (STOCH) x = __fadd_rn(x, __fmul_rn(stdv[i], normal01(w1[i], ws.next())));
    raw[i] = x;
    act[i] = (tanhf(x) + 1.f) * m.half_hi[i];
  }
}

__global__ void k_rollout_traj(const __grid_constant__ NetTopo tp,
                               const __grid_constant__ Mlp m,
                               const float* __restrict__ params, int n_params,
                               const float* __restrict__ tables,
                               const float* __restrict__ disc,
                               float* __restrict__ xo, float* __restrict__ uo,
                               float* __restrict__ ro, float* __restrict__ rawo,
                               float* __restrict__ rewo,
                               float* __restrict__ demo, unsigned seed,
                               long long B, int T) {
  float *h0, *h1;
  const float* sw = load_params(m, params, n_params, h0, h1);
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* stdv = sw + n_params - tp.n_ro;
  Episode s;
  episode_reset(tp, s);
  float raw[NET_MAX_RO], act[NET_MAX_RO], dem[NET_MAX_RT], r[NET_MAX_RO];
  for (int t = 0; t <= T; ++t) {
    for (int n = 0; n < tp.n_main; ++n) xo[((long long)t * tp.n_main + n) * B + b] = s.X[n];
    for (int j = 0; j < tp.n_rt; ++j) uo[((long long)t * tp.n_rt + j) * B + b] = s.U[j];
    if (t == T) break;  // the final snapshots are the bootstrap obs
    policy_period<true>(tp, m, sw, stdv, tables, seed, (unsigned)b, 0u,
                        (unsigned)t, s, h0, h1, raw, act, dem);
    const float profit = step_period(tp, s, act, dem, r);
    for (int i = 0; i < tp.n_ro; ++i) {
      const long long k = ((long long)t * tp.n_ro + i) * B + b;
      ro[k] = r[i];
      rawo[k] = raw[i];
    }
    rewo[(long long)t * B + b] = __ldg(disc + t) * profit;
    for (int j = 0; j < tp.n_rt; ++j) demo[((long long)t * tp.n_rt + j) * B + b] = dem[j];
  }
}

template <bool STOCH, bool DUMP>
__global__ void k_policy_returns(const __grid_constant__ NetTopo tp,
                                 const __grid_constant__ Mlp m,
                                 const float* __restrict__ params, int n_params,
                                 const float* __restrict__ tables,
                                 const float* __restrict__ disc,
                                 float* __restrict__ out, float* __restrict__ acts,
                                 float* __restrict__ dems, unsigned seed,
                                 long long B, int E, int T) {
  float *h0, *h1;
  const float* sw = load_params(m, params, n_params, h0, h1);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  const float* stdv = sw + n_params - tp.n_ro;
  Episode s;
  episode_reset(tp, s);
  float raw[NET_MAX_RO], act[NET_MAX_RO], dem[NET_MAX_RT], r[NET_MAX_RO];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    policy_period<STOCH>(tp, m, sw, stdv, tables, seed, lane, e, (unsigned)t, s,
                         h0, h1, raw, act, dem);
    if (DUMP) {
      const long long row = (long long)t * E + e;  // (T, E, rows, B)
      for (int i = 0; i < tp.n_ro; ++i) acts[(row * tp.n_ro + i) * B + lane] = act[i];
      for (int j = 0; j < tp.n_rt; ++j) dems[(row * tp.n_rt + j) * B + lane] = dem[j];
    }
    total += __ldg(disc + t) * step_period(tp, s, act, dem, r);
  }
  out[idx] = total;  // (E, B), episode-major
}

// The observation of the period-t state into column n of x
// ([row][kWideLanes]), in assemble_obs's order.
__device__ __forceinline__ void wide_obs(const NetTopo& tp, const Episode& s, float* x,
                                         int n) {
  int k = 0;
  for (int j = 0; j < tp.n_rt; ++j) x[(k++) * kWideLanes + n] = s.U[j];
  for (int i = 0; i < tp.n_main; ++i) x[(k++) * kWideLanes + n] = s.X[i];
  for (int i = 0; i < tp.n_ro; ++i)
    for (int j = 0; j < tp.ro_L[i]; ++j) x[(k++) * kWideLanes + n] = order_window(tp, s, i, j);
}

template <bool RELU>
__global__ void __launch_bounds__(kWideThreads)
    k_rollout_traj_wide(const __grid_constant__ NetTopo tp, const __grid_constant__ WideMlp m,
                        const float* __restrict__ w, const float* __restrict__ tables,
                        const float* __restrict__ disc, float* __restrict__ xo,
                        float* __restrict__ uo, float* __restrict__ ro,
                        float* __restrict__ rawo, float* __restrict__ rewo,
                        float* __restrict__ demo, unsigned seed, long long B, int T) {
  extern __shared__ float4 smem4[];
  float* x0 = reinterpret_cast<float*>(smem4);
  float* x1 = x0 + m.rows * kWideLanes;
  const int n = threadIdx.x;
  const long long b = (long long)blockIdx.x * kWideLanes + n;
  const bool lane = n < kWideLanes, live = lane && b < B;
  const bool actor = m.head != kHeadUniform;
  Episode s;
  float dem[NET_MAX_RT], act[NET_MAX_RO], r[NET_MAX_RO], st[NET_MAX_RO], z[WIDE_MAX_ACT];
  if (lane) episode_reset(tp, s);
  for (int t = 0; t <= T; ++t) {
    if (live) {
      for (int i = 0; i < tp.n_main; ++i) xo[((long long)t * tp.n_main + i) * B + b] = s.X[i];
      for (int j = 0; j < tp.n_rt; ++j) uo[((long long)t * tp.n_rt + j) * B + b] = s.U[j];
    }
    if (t == T) break;  // the final snapshots are the bootstrap obs
    if (lane) {
      WordStream ws(seed, 1u, (unsigned)b, 0u, (unsigned)t);
      for (int j = 0; j < tp.n_rt; ++j) dem[j] = link_demand(tp, tables, j, t, ws.next());
      wide_noise(m, ws, z);
      if (actor) wide_obs(tp, s, x0, n);
    }
    const float* H = actor ? wide_forward<RELU>(m, w, x0, x1) : x0;
    if (lane) {
      for (int i = 0; i < tp.n_ro; ++i)
        act[i] = (wide_head(m, w, H, n, i, z[i], st[i]) + 1.f) * m.half_hi[i];
      const float profit = step_period(tp, s, act, dem, r);
      if (live) {
        for (int i = 0; i < tp.n_ro; ++i) {
          const long long k = ((long long)t * tp.n_ro + i) * B + b;
          ro[k] = r[i];
          rawo[k] = st[i];
        }
        rewo[(long long)t * B + b] = __ldg(disc + t) * profit;
        for (int j = 0; j < tp.n_rt; ++j)
          demo[((long long)t * tp.n_rt + j) * B + b] = dem[j];
      }
    }
  }
}

template <bool STOCH, bool DUMP>
int launch_policy_returns(const NetTopo& tp, const Mlp& m, const float* params,
                          int n_params, const float* tables, const float* disc,
                          float* out, float* acts, float* dems, unsigned seed,
                          long long B, int E, int T, cudaStream_t stream) {
  const size_t smem = smem_bytes(m, n_params);
  auto kernel = k_policy_returns<STOCH, DUMP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_for(B * E), kThreads, smem, stream>>>(
      tp, m, params, n_params, tables, disc, out, acts, dems, seed, B, E, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int net_rollout_traj(const NetTopo* topo, const Mlp* mlp, const float* params,
                     int n_params, const float* tables, const float* disc,
                     float* xo, float* uo, float* ro, float* raw, float* rew,
                     float* dem, unsigned seed, long long B, int T,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes(*mlp, n_params);
  cudaError_t err = allow_smem(k_rollout_traj, smem);
  if (err != cudaSuccess) return (int)err;
  k_rollout_traj<<<blocks_for(B), kThreads, smem, stream>>>(
      *topo, *mlp, params, n_params, tables, disc, xo, uo, ro, raw, rew, dem,
      seed, B, T);
  return (int)cudaGetLastError();
}

// acts == dems == nullptr: returns only (K5); otherwise also the streams (K6).
int net_policy_returns(const NetTopo* topo, const Mlp* mlp,
                       const float* params, int n_params, const float* tables,
                       const float* disc, float* out, float* acts, float* dems,
                       unsigned seed, long long B, int E, int T, int stochastic,
                       cudaStream_t stream) {
  const bool dump = acts != nullptr;
  if (stochastic)
    return dump ? launch_policy_returns<true, true>(*topo, *mlp, params, n_params, tables,
                                                    disc, out, acts, dems, seed, B, E, T, stream)
                : launch_policy_returns<true, false>(*topo, *mlp, params, n_params, tables,
                                                     disc, out, acts, dems, seed, B, E, T, stream);
  return dump ? launch_policy_returns<false, true>(*topo, *mlp, params, n_params, tables,
                                                   disc, out, acts, dems, seed, B, E, T, stream)
              : launch_policy_returns<false, false>(*topo, *mlp, params, n_params, tables,
                                                    disc, out, acts, dems, seed, B, E, T, stream);
}

int net_rollout_traj_wide(const NetTopo* topo, const WideMlp* wm, const float* w,
                          const float* tables, const float* disc, float* xo, float* uo,
                          float* ro, float* raw, float* rew, float* dem, unsigned seed,
                          int relu, long long B, int T, cudaStream_t stream) {
  auto kernel = relu ? k_rollout_traj_wide<true> : k_rollout_traj_wide<false>;
  const size_t smem = wide_smem_bytes(*wm);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<wide_blocks(B), kWideThreads, smem, stream>>>(*topo, *wm, w, tables, disc, xo, uo,
                                                         ro, raw, rew, dem, seed, B, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
