// The first design of K4 (rollout_traj_net's PPO head), kept for
// tools/net_traj_sweep.py to time in turns with the package's kernel: a
// copy of the kernel as csrc/net_policy.cu held it before K4 moved onto the
// tensor-core tile (one thread a lane, the state in a local Episode, the
// 64x64 tanh actor on the FP32 cores, csrc/mlp.cuh). Built by the sweep
// with -I or_gym_inventory_torch/csrc; its C entry point takes the
// arguments the package's ``net_rollout_traj`` took then (topo, mlp,
// params, n_params, tables, disc, x, u, r, raw, reward, demand, seed, B, T,
// stream), packed by ops/episode_kernels.py ``_pack_actor``.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "mlp.cuh"
#include "net_step.cuh"
#include "philox.cuh"

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

}  // extern "C"
