// NetInvMgmt whole-episode kernels for Hopper (sm_90a), bound with ctypes
// by ops/_build.py and wrapped by ops/net_step.py, whose plain PyTorch
// versions compute the same functions.
//
// K1 k_episode_returns  replaces pallas_net_step.episode_returns (:820,
//    body _episode_kernel_body :144, step _step_math :34). One thread per
//    env reads its (T, n_ro) actions and (T, n_rt) demands, coalesced along
//    B, and keeps the state in registers and local memory for the whole
//    episode. Bound by bytes: (T*(n_ro+n_rt)+1)*4 per env, read once.
// K2 k_episode_returns_fused  replaces episode_returns_fully_fused (:379).
//    Actions and demand are drawn in the kernel, so only the returns leave
//    it. Bound by operations: per env-step three Philox4x32-10 blocks, the
//    contention chain, deliveries, retail, profit and one binary search per
//    table link. One thread per (episode, lane): the TPU interleaved E
//    episodes per lane to hide the serial contention chain (:312-318); here
//    more resident threads do that job, so E only widens the grid. The
//    first version kept the state in a 2,240-byte local-memory frame whose
//    traffic went out to HBM (2,217 ms at 4,194,304 x 16 x 30, 0.8% of the
//    bound). Now the state is in shared memory (net_step.cuh SharedView,
//    432 bytes a thread on the default graph, 4 blocks of 128 an SM) and
//    step_view makes one pass over the links, drawing each action word as
//    it reaches the link: no stack, no local loads or stores, 163-166 ms,
//    10.5-10.7% of the 17.52 ms bound (H100 80GB HBM3, 700 W). Blocks of
//    256 were ~1% faster (tools/k2_block_sweep.py), less than the spread
//    between runs, so K2 keeps launch.cuh's kThreads.
// K3 k_sample_streams  replaces sample_streams_debug (:427). It writes the
//    streams K2 draws for episodes [e0, e1), through the same draw_period.
//    The counter-based generator needs no replay of the other episodes.
//    Bound by bytes: the streams it writes.
// K25 k_batched_step  replaces batched_step (:774, body _kernel_body :112):
//    one period of a lockstep batch on the transposed (rows, B) state X, Y,
//    U and the newest-first order history RH (lt x n_ro rows), with the
//    actions and demand given; writes X', Y', U', RH' and the reward
//    alpha^t * profit. One thread per lane: it loads the lane's rows into
//    step_period's Episode, with the one order of each link that arrives
//    this period (RH row L_i - 1, times the arrival mask t >= L_i) in slot 0
//    of the link's ring, steps, and writes RH' as the new orders followed by
//    RH's first lt - 1 rows. Bound by bytes: every row read and written once.
// K26 k_episode_returns_random  replaces episode_returns_random_policy
//    (:857, body _episode_kernel_body_inkernel_actions :169): whole-episode
//    returns with the uniform [0, act_hi) actions drawn in the kernel and
//    the demand (T, n_rt, B) streamed in. K2's body (random_episode) with
//    the demand read instead of drawn: its actions are K2's action words of
//    episode 0 (key (seed, 0), the period's first n_ro words), so K26 on
//    K3's demand gives K2's returns bit for bit. Bound by operations: the
//    Philox blocks and the step. 0.19-0.23 ms at 65,536 x 30, 7-8% of the
//    bound (first version, on the local frame, 0.95 ms).
//
// The period step (step_view, on an Episode or on shared memory) is in
// net_step.cuh, shared with the policy kernels; its notes list the
// semantics that are easy to get wrong. The batch tail is masked, so any
// B >= 1 works (no TPU tile assert). Discount: alpha**t is a Python double
// rounded to f32 in the JAX kernel (:165); the wrapper passes that table,
// the kernel calls no powf.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "net_step.cuh"
#include "philox.cuh"

namespace {

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
    total += __ldg(disc + t) * step_period(tp, s, act, dem, r);
  }
  out[b] = total;
}

// The random policy's discounted return on the shared state s: per period
// the n_ro action words of key (seed, 0) drawn as the link pass reaches each
// link, then the demand source demand(ws, t).
template <class DemandOf>
__device__ __forceinline__ float random_episode(const NetTopo& tp, const SharedView& s,
                                                unsigned seed, unsigned lane, unsigned e,
                                                float act_scale,
                                                const float* __restrict__ disc, int T,
                                                DemandOf demand) {
  reset_view(tp, s);
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    WordStream ws(seed, 0u, lane, e, (unsigned)t);
    total += __ldg(disc + t) *
             step_view(tp, s, DrawnActions{ws, act_scale}, demand(ws, t), NoSink{});
  }
  return total;
}

__global__ void k_episode_returns_fused(const __grid_constant__ NetTopo tp,
                                        const __grid_constant__ NetSmem lay,
                                        const float* __restrict__ disc,
                                        const float* __restrict__ tables,
                                        float* __restrict__ out, unsigned seed,
                                        float act_scale, long long B, int E,
                                        int T) {
  extern __shared__ float net_state[];
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  const SharedView s(net_state, lay);
  out[idx] = random_episode(tp, s, seed, lane, e, act_scale, disc, T,  // (E, B)
                            [&](WordStream& ws, int t) {
                              return DrawnDemand{tp, tables, (unsigned)t, ws};
                            });
}

__global__ void k_sample_streams(const __grid_constant__ NetTopo tp,
                                 const float* __restrict__ tables,
                                 float* __restrict__ acts,
                                 float* __restrict__ dems, unsigned seed,
                                 float act_scale, long long B, int T, int e0,
                                 int W) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * W) return;
  const int w = (int)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)w * B);
  float act[NET_MAX_RO], dem[NET_MAX_RT];
  for (int t = 0; t < T; ++t) {
    draw_period(tp, tables, seed, lane, (unsigned)(e0 + w), (unsigned)t,
                act_scale, act, dem);
    const long long row = (long long)t * W + w;  // (T, W, rows, B)
    for (int i = 0; i < tp.n_ro; ++i) acts[(row * tp.n_ro + i) * B + lane] = act[i];
    for (int j = 0; j < tp.n_rt; ++j) dems[(row * tp.n_rt + j) * B + lane] = dem[j];
  }
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
  const float profit = step_period(tp, s, act, dem, r);
  for (int n = 0; n < tp.n_main; ++n) Xo[n * B + b] = s.X[n];
  for (int j = 0; j < tp.n_rt; ++j) Uo[j * B + b] = s.U[j];
  for (int i = 0; i < n_ro; ++i) {
    Yo[i * B + b] = s.Y[i];
    RHo[i * B + b] = r[i];
  }
  for (long long k = n_ro; k < (long long)lt * n_ro; ++k) RHo[k * B + b] = RH[(k - n_ro) * B + b];
  rew[b] = disc * profit;
}

__global__ void k_episode_returns_random(const __grid_constant__ NetTopo tp,
                                         const __grid_constant__ NetSmem lay,
                                         const float* __restrict__ dems,
                                         const float* __restrict__ disc,
                                         float* __restrict__ out, unsigned seed,
                                         float act_scale, long long B, int T) {
  extern __shared__ float net_state[];
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const SharedView s(net_state, lay);
  out[b] = random_episode(tp, s, seed, (unsigned)b, 0u, act_scale, disc, T,
                          [&](WordStream&, int t) {
                            return FromStream{dems + (long long)t * tp.n_rt * B + b, B};
                          });
}

// Dynamic shared memory of a block of the shared-state kernels: above 48 KB
// it needs the opt-in, and the SM's whole carveout goes to shared memory
// so that the most blocks fit.
template <typename K>
cudaError_t allow_state(K kernel, size_t bytes) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

int net_episode_returns(const NetTopo* topo, const float* acts,
                        const float* dems, const float* disc, float* out,
                        long long B, int T, cudaStream_t stream) {
  k_episode_returns<<<blocks_for(B), kThreads, 0, stream>>>(*topo, acts, dems,
                                                            disc, out, B, T);
  return (int)cudaGetLastError();
}

int net_episode_returns_fused(const NetTopo* topo, const NetSmem* lay, const float* disc,
                              const float* tables, float* out, unsigned seed,
                              float act_scale, long long B, int E, int T,
                              cudaStream_t stream) {
  const size_t smem = (size_t)lay->words * kThreads * sizeof(float);
  cudaError_t err = allow_state(k_episode_returns_fused, smem);
  if (err != cudaSuccess) return (int)err;
  k_episode_returns_fused<<<blocks_for(B * E), kThreads, smem, stream>>>(
      *topo, *lay, disc, tables, out, seed, act_scale, B, E, T);
  return (int)cudaGetLastError();
}

int net_sample_streams(const NetTopo* topo, const float* tables, float* acts,
                       float* dems, unsigned seed, float act_scale, long long B,
                       int T, int e0, int e1, cudaStream_t stream) {
  k_sample_streams<<<blocks_for(B * (e1 - e0)), kThreads, 0, stream>>>(
      *topo, tables, acts, dems, seed, act_scale, B, T, e0, e1 - e0);
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

int net_episode_returns_random(const NetTopo* topo, const NetSmem* lay, const float* dems,
                               const float* disc, float* out, unsigned seed,
                               float act_scale, long long B, int T,
                               cudaStream_t stream) {
  const size_t smem = (size_t)lay->words * kThreads * sizeof(float);
  cudaError_t err = allow_state(k_episode_returns_random, smem);
  if (err != cudaSuccess) return (int)err;
  k_episode_returns_random<<<blocks_for(B), kThreads, smem, stream>>>(
      *topo, *lay, dems, disc, out, seed, act_scale, B, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
