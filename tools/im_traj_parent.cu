// The first design of K10 (rollout_traj_im's PPO head), kept for
// tools/ppo_traj_sweep.py to time in turns with the package's kernel: a
// copy of the kernel as csrc/im_policy.cu held it before K10 moved onto
// K11's tensor-core tile (one thread a lane, the state and the ring of
// requested orders in a local frame, the 64x64 tanh actor on the FP32
// cores, csrc/mlp.cuh). Built by the sweep with -I
// or_gym_inventory_torch/csrc; its C entry point takes the arguments the
// package's ``im_rollout_traj`` took then (params, mlp, actor, n_actor,
// table, user_d, disc, inv, acts, raw, reward, demand, seed, backlog, B, T,
// stream), packed by ops/episode_kernels.py ``_pack_actor``.

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

}  // extern "C"
