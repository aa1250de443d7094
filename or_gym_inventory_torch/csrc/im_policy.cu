// InvManagement kernels under a folded MLP actor, for Hopper (sm_90a), bound
// with ctypes by ops/_build.py and wrapped by ops/episode_kernels.py, whose
// plain PyTorch versions compute the same functions.
//
// K10 k_im_rollout_traj  replaces pallas_episode_kernels.rollout_traj_im
//    (:1683; body _im_traj_kernel :1641, obs _im_obs_rows :1108, policy head
//    traj_policy "ppo" :1036, trunk mlp_forward :1124). One stochastic-policy
//    episode per lane, the training streams written to device memory:
//    start-of-period on-hand inv (T+1 snapshots), int actions, pre-squash
//    raws, alpha^t rewards and demand, each (T[+1], rows, B) and coalesced
//    along B. PPO with rollout="kernel" feeds on it.
// K11/K12 k_im_policy_returns  replace _im_policy_call (:1218) behind
//    episode_returns_im_policy (:1264) and its stream-dumping twin
//    sample_policy_streams_debug_im (:1287; body _im_policy_kernel :1170,
//    actions _policy_actions :1149): the same policy, deterministic or
//    stochastic, E episodes per lane, returns (E, B); with DUMP it also
//    writes the int actions (T, E, m1, B) and the demand (T, E, B) it used.
//
// Design (a simple kernel first): one thread per lane (K10) or per
// (episode, lane) (K11/K12); the step is im_step.cuh's, the actor mlp.cuh's
// (weights and activations in shared memory: 7,379 floats of weights for the
// default 33-64-64-3 actor and 64 KB of activations at 128 threads). The
// observation is assembled from the live state in the order of _im_obs_rows:
// on-hand, then the requested orders of periods max(t - lt, 0) .. t-1 oldest
// first, one row per (period, stage), zero rows at the end while t < lt. The
// requested orders live in a ring of depth lt per stage (slot p % lt), in
// local memory. Bound by operations: the MLP's ~12,800 per env-step dwarf
// the step and the draws.
//
// Random stream (philox.cuh): key (seed, 1), counter (lane, episode, period,
// block); per period one demand word, then, when stochastic, the m1 u1 and
// the m1 u2 words of the Box-Muller normals (pallas_episode_kernels.py
// :1657-1658, :69-70). K10 is episode 0, so episode 0 of the stochastic K11
// draws exactly K10's words for the same seed and takes K10's actions.
//
// Rounding: raw = H + std * z with two roundings (__fmul_rn/__fadd_rn), as
// the plain version computes it; the action truncates,
// (int)((tanh(raw) + 1) * f32(0.5 c_i)) (:1165-1167, :1666-1671), with each
// operation rounded alone. A float-to-int cast on the card (cvt.rzi)
// saturates and takes NaN to 0, as JAX's cast does on the CPU. The MLP sums
// in another order than a matmul and tanhf may differ from the CPU's by an
// ulp, so a lane whose action lands on a truncation boundary may take the
// other integer, and its int state then diverges: kernel and plain version
// are held by the share of lanes that agree.

#include <cuda_runtime.h>

#include "im_step.cuh"
#include "launch.cuh"
#include "mlp.cuh"
#include "philox.cuh"

namespace {

// Demand, then the policy's raw samples and int actions, of one (lane,
// episode, period): the observation of the live state into h0, the actor,
// the head. ``ah`` is the ring of requested orders. Returns the demand.
template <bool STOCH>
__device__ __forceinline__ int policy_period(
    const ImParams& p, const Mlp& m, const float* w, const float* stdv,
    const float* __restrict__ table, const int* __restrict__ user_d,
    unsigned seed, unsigned lane, unsigned e, int t, const ImEpisode& s,
    const int* ah, float* h0, float* h1, float* raw, int* act) {
  const int m1 = p.m1, lt = p.lt;
  WordStream ws(seed, 1u, lane, e, (unsigned)t);
  const int d = im_demand(p, table, user_d, t, ws.next());
  for (int i = 0; i < m1; ++i) col(h0, i) = (float)s.inv[i];
  const int q0 = max(t - lt, 0);
  for (int j = 0; j < lt; ++j) {
    const int q = q0 + j;
    for (int i = 0; i < m1; ++i)
      col(h0, m1 + j * m1 + i) = q < t ? (float)ah[(q % lt) * m1 + i] : 0.f;
  }
  float* H = mlp_forward(m, w, h0, h1);
  unsigned w1[IM_MAX_M1];
  if (STOCH)
    for (int i = 0; i < m1; ++i) w1[i] = ws.next();
  for (int i = 0; i < m1; ++i) {
    float x = col(H, i);
    if (STOCH) x = __fadd_rn(x, __fmul_rn(stdv[i], normal01(w1[i], ws.next())));
    raw[i] = x;
    act[i] = (int)__fmul_rn(__fadd_rn(tanhf(x), 1.f), m.half_hi[i]);
  }
  return d;
}

// One period's step, with the requested orders pushed into the ring ``ah``.
template <bool BACKLOG>
__device__ __forceinline__ float step_and_record(const ImParams& p, ImEpisode& s,
                                                 int t, const int* act, int d,
                                                 int* ah) {
  int r_req[IM_MAX_M1];
  const int slot = s.slot;
  const float profit = im_step<BACKLOG>(p, s, t, act, d, r_req);
  if (p.lt > 0)
    for (int i = 0; i < p.m1; ++i) ah[slot * p.m1 + i] = r_req[i];
  return profit;
}

template <bool BACKLOG>
__global__ void k_im_rollout_traj(const __grid_constant__ ImParams p,
                                  const __grid_constant__ Mlp m,
                                  const float* __restrict__ params, int n_params,
                                  const float* __restrict__ table,
                                  const int* __restrict__ user_d,
                                  const float* __restrict__ disc,
                                  int* __restrict__ invo, int* __restrict__ acto,
                                  float* __restrict__ rawo, float* __restrict__ rewo,
                                  int* __restrict__ demo, unsigned seed,
                                  long long B, int T) {
  float *h0, *h1;
  const float* sw = load_params(m, params, n_params, h0, h1);
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int m1 = p.m1;
  const float* stdv = sw + n_params - m1;
  ImEpisode s;
  im_reset(p, s);
  int ah[IM_MAX_LT * IM_MAX_M1];  // requested order of period q: slot q % lt
  int act[IM_MAX_M1];
  float raw[IM_MAX_M1];
  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < m1; ++i) invo[((long long)t * m1 + i) * B + b] = s.inv[i];
    const int d = policy_period<true>(p, m, sw, stdv, table, user_d, seed, (unsigned)b,
                                      0u, t, s, ah, h0, h1, raw, act);
    demo[(long long)t * B + b] = d;
    for (int i = 0; i < m1; ++i) {
      const long long k = ((long long)t * m1 + i) * B + b;
      rawo[k] = raw[i];
      acto[k] = act[i];
    }
    const float profit = step_and_record<BACKLOG>(p, s, t, act, d, ah);
    rewo[(long long)t * B + b] = __fmul_rn(__ldg(disc + t), profit);
  }
  for (int i = 0; i < m1; ++i) invo[((long long)T * m1 + i) * B + b] = s.inv[i];
}

template <bool STOCH, bool DUMP, bool BACKLOG>
__global__ void k_im_policy_returns(const __grid_constant__ ImParams p,
                                    const __grid_constant__ Mlp m,
                                    const float* __restrict__ params, int n_params,
                                    const float* __restrict__ table,
                                    const int* __restrict__ user_d,
                                    const float* __restrict__ disc,
                                    float* __restrict__ out, int* __restrict__ acto,
                                    int* __restrict__ demo, unsigned seed,
                                    long long B, int E, int T) {
  float *h0, *h1;
  const float* sw = load_params(m, params, n_params, h0, h1);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  const int m1 = p.m1;
  const float* stdv = sw + n_params - m1;
  ImEpisode s;
  im_reset(p, s);
  int ah[IM_MAX_LT * IM_MAX_M1];
  int act[IM_MAX_M1];
  float raw[IM_MAX_M1];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    const int d = policy_period<STOCH>(p, m, sw, stdv, table, user_d, seed, lane, e, t,
                                       s, ah, h0, h1, raw, act);
    if (DUMP) {
      const long long row = (long long)t * E + e;  // (T, E, m1, B) and (T, E, B)
      for (int i = 0; i < m1; ++i) acto[(row * m1 + i) * B + lane] = act[i];
      demo[row * B + lane] = d;
    }
    const float profit = step_and_record<BACKLOG>(p, s, t, act, d, ah);
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
  }
  out[idx] = total;  // (E, B), episode-major
}

template <bool STOCH, bool DUMP, bool BACKLOG>
int launch_policy_kernel(const ImParams& p, const Mlp& m, const float* params,
                          int n_params, const float* table, const int* user_d,
                          const float* disc, float* out, int* acts, int* dems,
                          unsigned seed, long long B, int E, int T,
                          cudaStream_t stream) {
  auto kernel = k_im_policy_returns<STOCH, DUMP, BACKLOG>;
  const size_t smem = smem_bytes(m, n_params);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_for(B * E), kThreads, smem, stream>>>(
      p, m, params, n_params, table, user_d, disc, out, acts, dems, seed, B, E, T);
  return (int)cudaGetLastError();
}

template <bool STOCH, bool DUMP>
int launch_policy_returns(const ImParams& p, const Mlp& m, const float* params,
                          int n_params, const float* table, const int* user_d,
                          const float* disc, float* out, int* acts, int* dems,
                          unsigned seed, int backlog, long long B, int E, int T,
                          cudaStream_t stream) {
  return backlog ? launch_policy_kernel<STOCH, DUMP, true>(
                       p, m, params, n_params, table, user_d, disc, out, acts, dems,
                       seed, B, E, T, stream)
                 : launch_policy_kernel<STOCH, DUMP, false>(
                       p, m, params, n_params, table, user_d, disc, out, acts, dems,
                       seed, B, E, T, stream);
}

}  // namespace

extern "C" {

int im_rollout_traj(const ImParams* p, const Mlp* mlp, const float* params,
                    int n_params, const float* table, const int* user_d,
                    const float* disc, int* inv, int* acts, float* raw,
                    float* rew, int* dem, unsigned seed, int backlog, long long B,
                    int T, cudaStream_t stream) {
  auto kernel = backlog ? k_im_rollout_traj<true> : k_im_rollout_traj<false>;
  const size_t smem = smem_bytes(*mlp, n_params);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_for(B), kThreads, smem, stream>>>(*p, *mlp, params, n_params, table,
                                                    user_d, disc, inv, acts, raw, rew,
                                                    dem, seed, B, T);
  return (int)cudaGetLastError();
}

// acts == dems == nullptr: returns only (K11); otherwise also the streams (K12).
int im_policy_returns(const ImParams* p, const Mlp* mlp, const float* params,
                      int n_params, const float* table, const int* user_d,
                      const float* disc, float* out, int* acts, int* dems,
                      unsigned seed, int stochastic, int backlog, long long B, int E,
                      int T, cudaStream_t stream) {
  const bool dump = acts != nullptr;
  if (stochastic)
    return dump ? launch_policy_returns<true, true>(*p, *mlp, params, n_params, table,
                                                    user_d, disc, out, acts, dems, seed,
                                                    backlog, B, E, T, stream)
                : launch_policy_returns<true, false>(*p, *mlp, params, n_params, table,
                                                     user_d, disc, out, acts, dems, seed,
                                                     backlog, B, E, T, stream);
  return dump ? launch_policy_returns<false, true>(*p, *mlp, params, n_params, table,
                                                   user_d, disc, out, acts, dems, seed,
                                                   backlog, B, E, T, stream)
              : launch_policy_returns<false, false>(*p, *mlp, params, n_params, table,
                                                    user_d, disc, out, acts, dems, seed,
                                                    backlog, B, E, T, stream);
}

}  // extern "C"
