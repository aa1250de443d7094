// NetInvMgmt whole-episode kernels for Hopper (sm_90a), bound with ctypes
// by ops/_build.py and wrapped by ops/net_step.py, whose plain PyTorch
// versions compute the same functions. K1, K2, K25 and K26 keep a lane's
// state in dynamic shared memory (net_step.cuh SharedView, [word][thread]);
// K3 keeps none. No kernel here has a stack frame.
//
// K1 k_episode_returns  replaces pallas_net_step.episode_returns (:820,
//    body _episode_kernel_body :144, step _step_math :34): the returns of
//    given (T, n_ro, B) actions and (T, n_rt, B) demand. One thread a lane
//    runs K2's episode body (shared_episode, step_view on the shared state),
//    so on K3's streams it gives K2's returns bit for bit. Its periods' n_ro
//    + n_rt words are staged into shared memory ahead of the step by 4-byte
//    cp.async copies, coalesced across the warp (one row of a block's lanes
//    is contiguous in B) and needing no alignment, so any B works: two
//    buffers of `chunk` periods, the next chunk copied while this one is
//    stepped (commit_group / wait_group 1), so no global load sits on a
//    period's chain. ops/net_step.py _k1_plan lays the staging beside the
//    state (NetStage): 4 periods a buffer, 128 threads a block where that
//    fits. Bound by bytes, (T*(n_ro+n_rt)+1)*4 per lane read once, but at
//    the main path's shapes a lane's chain of T dependent steps sets the
//    time: on an H100 80GB HBM3 at 700 W, 0.118-0.127 ms alone at 1,024 and
//    4,096 lanes x 30 whatever the block size, 0.248-0.257 at 65,536
//    (11.0-11.4% of its bound); the first design, the state in the
//    1,792-byte Episode frame in local memory (tools/net_episode_parent.cu),
//    0.148-0.155 and 1.037-1.060 in turns (tools/net_k1_k25_sweep.py,
//    PERF.md).
// K2 k_episode_returns_fused  replaces episode_returns_fully_fused (:379).
//    Actions and demand are drawn in the kernel, so only the returns leave
//    it. Bound by operations: per env-step three Philox4x32-10 blocks, the
//    contention chain, deliveries, retail, profit and one binary search per
//    table link. One thread per (episode, lane): the TPU interleaved E
//    episodes per lane to hide the serial contention chain (:312-318); here
//    more resident threads do that job, so E only widens the grid. The state
//    is in shared memory (432 bytes a thread on the default graph, 4 blocks
//    of 128 an SM) and step_view makes one pass over the links, drawing each
//    action word as it reaches the link: 163-166 ms at 4,194,304 x 16 x 30,
//    10.5-10.7% of the 17.52 ms bound (H100 80GB HBM3, 700 W; the first
//    version's local frame went out to HBM, 2,217 ms). Blocks of 256 were ~1%
//    faster (tools/k2_block_sweep.py), less than the spread between runs, so
//    K2 keeps launch.cuh's kThreads.
// K3 k_sample_streams  replaces sample_streams_debug (:427). It writes the
//    streams K2 draws for episodes [e0, e1) (draw_period: K2's draws, each
//    value stored as it is drawn). The counter-based generator needs no
//    replay of the other episodes, nor of the other periods: a period's
//    words are counter (lane, episode, period, block), so a thread draws
//    kK3Periods (4) periods of one (lane, episode), each alone, and writes
//    their n_ro + n_rt words: B x W x T / 4 threads on a 2-D grid, lanes
//    along x, so a warp's threads are consecutive lanes of one output row
//    (coalesced stores).
//    The first design walked a lane's T periods on one thread, B x W
//    threads (tools/k3_k7_parent.cu). Bound by bytes: the streams it
//    writes.
// K25 k_batched_step  replaces batched_step (:774, body _kernel_body :112):
//    one period of a lockstep batch on the transposed (rows, B) state X, Y,
//    U and the newest-first order history RH (lt x n_ro rows), with the
//    actions and demand given; writes X', Y', U', RH' and the reward
//    alpha^t * profit. One thread a lane copies (cp.async) the lane's X, Y,
//    U, actions, demand and, for each link with L > 0, the one order that
//    arrives this period (RH row L_i - 1, times the mask t >= L_i) into
//    shared memory: one ring word a link, which the packed topology's
//    ro_ring names (ops/net_step.py _k25_plan), not the episode's sum L_i
//    ring. While those copies fly, the grid copies RH's first (lt - 1) n_ro
//    rows to RH' rows n_ro.. (one contiguous block, float4 where both ends
//    are 16-byte aligned): most of the kernel's bytes. Then step_view runs
//    and hands the fulfilled orders straight to RH' rows 0..n_ro-1 (ToRows).
//    Bound by bytes: every row read and written once, 0.0245 ms at 65,536
//    lanes; 0.046-0.054 ms alone there on an H100 80GB HBM3 at 700 W (the
//    copy alone 0.042-0.049), against the first design's 0.075-0.083 on the
//    local frame (tools/net_k1_k25_sweep.py, PERF.md).
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
// The period step (step_view) is in net_step.cuh, shared with the policy
// kernels; its notes list the semantics that are easy to get wrong. The
// batch tail is masked, so any B >= 1 works (no TPU tile assert). Discount:
// alpha**t is a Python double rounded to f32 in the JAX kernel (:165); the
// wrapper passes that table (K25: that value), the kernel calls no powf.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "launch.cuh"
#include "net_step.cuh"
#include "philox.cuh"

// The staging words beside a thread's state (K1 and K25), laid out by
// ops/net_step.py _k1_plan / _k25_plan (mirrored there by _NetStage): a
// thread's words in all, the first staging word, the periods a buffer, and
// the threads a block. A staged period is its n_ro action words, then its
// n_rt demand words, [word][thread] like the state. K1 keeps two buffers of
// `chunk` periods; K25 stages its one period (chunk 1) once.
struct NetStage {
  int words, stage, chunk, threads;
};

namespace {

// K3's periods a thread: a thread draws kK3Periods periods of one (lane,
// episode), each from its own counter, and writes their n_ro + n_rt words.
// Four ran 3-4% faster than one at 65,536 lanes x 30 on an H100 (the row's
// index work spread over four periods, four Philox chains in flight) and
// alike at 1,024 x 8 episodes; two alike at both (tools/k3_k7_sweep.py
// times 1 and 2 by a text change of this line).
constexpr int kK3Periods = 4;
__host__ __device__ constexpr int k3_groups(int T) { return (T + kK3Periods - 1) / kK3Periods; }

// One episode's discounted return on the shared state s: the reset, then
// per period t the profit period(t) of one step_view, discounted by disc[t].
// K1, K2 and K26 run it, so the three sum alike.
template <class Period>
__device__ __forceinline__ float shared_episode(const NetTopo& tp, const SharedView& s,
                                                const float* __restrict__ disc, int T,
                                                Period period) {
  reset_view(tp, s);
  float total = 0.f;
  for (int t = 0; t < T; ++t) total += __ldg(disc + t) * period(t);
  return total;
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
  return shared_episode(tp, s, disc, T, [&](int t) {
    WordStream ws(seed, 0u, lane, e, (unsigned)t);
    return step_view(tp, s, DrawnActions{ws, act_scale}, demand(ws, t), NoSink{});
  });
}

__global__ void k_episode_returns(const __grid_constant__ NetTopo tp,
                                  const __grid_constant__ NetSmem lay,
                                  const __grid_constant__ NetStage st,
                                  const float* __restrict__ acts,
                                  const float* __restrict__ dems,
                                  const float* __restrict__ disc,
                                  float* __restrict__ out, long long B, int T) {
  extern __shared__ float net_state[];
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = blockDim.x, n_ro = tp.n_ro, n_rt = tp.n_rt, C = st.chunk;
  const int period_words = (n_ro + n_rt) * n;  // a staged period's stride
  float* const stage = net_state + st.stage * n + threadIdx.x;
  // copy periods [t0, min(t0 + C, T)) into buffer (t0 / C) % 2, one group
  auto issue = [&](int t0) {
    float* dst = stage + ((t0 / C) & 1) * C * period_words;
    for (int t = t0; t < min(t0 + C, T); ++t, dst += period_words) {
      const float* a = acts + (long long)t * n_ro * B + b;
      const float* d = dems + (long long)t * n_rt * B + b;
      for (int i = 0; i < n_ro; ++i) cp_async4(dst + i * n, a + i * B);
      for (int j = 0; j < n_rt; ++j) cp_async4(dst + (n_ro + j) * n, d + j * B);
    }
    cp_async_commit();
  };
  const SharedView s(net_state, lay);
  issue(0);
  out[b] = shared_episode(tp, s, disc, T, [&](int t) {
    const int c = t % C;
    if (c == 0) {
      if (t + C < T) issue(t + C);  // into the buffer the last chunk used
      else cp_async_commit();       // an empty group keeps the count
      cp_async_wait<1>();           // this chunk's group has landed
    }
    const float* p = stage + (((t / C) & 1) * C + c) * period_words;
    return step_view(tp, s, FromColumn{p, n}, FromColumn{p + n_ro * n, n}, NoSink{});
  });
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

// K3 on a 2-D grid: x over the lanes, y over the rows q = (group of
// kK3Periods periods) * W + episode (a block strides over the rows past the
// grid's 65,535), so a warp's threads are consecutive lanes of one output
// row and no thread divides a 64-bit index.
__global__ void k_sample_streams(const __grid_constant__ NetTopo tp,
                                 const float* __restrict__ tables,
                                 float* __restrict__ acts,
                                 float* __restrict__ dems, unsigned seed,
                                 float act_scale, long long B, int T, int e0,
                                 int W) {
  const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int rows = k3_groups(T) * W;
  for (int q = blockIdx.y; q < rows; q += gridDim.y) {
    const int w = q % W, t0 = q / W * kK3Periods;
    for (int t = t0; t < min(t0 + kK3Periods, T); ++t) {
      const long long row = (long long)t * W + w;  // (T, W, rows, B)
      draw_period(tp, tables, seed, (unsigned)lane, (unsigned)(e0 + w), (unsigned)t,
                  act_scale, ToRows{acts + row * tp.n_ro * B + lane, B, true},
                  ToRows{dems + row * tp.n_rt * B + lane, B, true});
    }
  }
}

// tp.ro_ring[i] is link i's one ring word among the links with L > 0
__global__ void k_batched_step(const __grid_constant__ NetTopo tp,
                               const __grid_constant__ NetSmem lay,
                               const __grid_constant__ NetStage st,
                               const float* __restrict__ X, const float* __restrict__ Y,
                               const float* __restrict__ U, const float* __restrict__ RH,
                               const float* __restrict__ acts,
                               const float* __restrict__ dems, float* __restrict__ Xo,
                               float* __restrict__ Yo, float* __restrict__ Uo,
                               float* __restrict__ RHo, float* __restrict__ rew,
                               float disc, int t, int lt, long long B) {
  extern __shared__ float net_state[];
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int n = blockDim.x, n_ro = tp.n_ro;
  const SharedView s(net_state, lay);
  float* const in = net_state + st.stage * n + threadIdx.x;  // actions, then demand
  if (b < B) {  // the lane's inputs, in flight during the copy below
    for (int k = 0; k < tp.n_main; ++k) cp_async4(&s.X(k), X + k * B + b);
    for (int j = 0; j < tp.n_rt; ++j) {
      cp_async4(&s.U(j), U + j * B + b);
      cp_async4(in + (n_ro + j) * n, dems + j * B + b);
    }
    for (int i = 0; i < n_ro; ++i) {
      cp_async4(&s.Y(i), Y + i * B + b);
      cp_async4(in + i * n, acts + i * B + b);
      const int L = tp.ro_L[i];
      if (L > 0) cp_async4(&s.ring(tp.ro_ring[i]), RH + ((long long)(L - 1) * n_ro + i) * B + b);
    }
    cp_async_commit();
  }
  // RH' rows [n_ro, lt n_ro) = RH rows [0, (lt - 1) n_ro): one block of
  // (lt - 1) n_ro B floats, spread over the grid's threads
  const long long len = (long long)(lt - 1) * n_ro * B;
  const float* src = RH;
  float* dst = RHo + (long long)n_ro * B;
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long G = (long long)gridDim.x * blockDim.x;
  long long k0 = 0;
  if (((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) & 15) == 0) {
    const long long len4 = len / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (long long k = g; k < len4; k += G) d4[k] = __ldg(s4 + k);
    k0 = len4 * 4;
  }
  for (long long k = k0 + g; k < len; k += G) dst[k] = __ldg(src + k);
  if (b >= B) return;
  cp_async_wait<0>();
  for (int i = 0; i < n_ro; ++i) {
    s.slot(i) = 0;
    const int L = tp.ro_L[i];
    if (L > t) s.ring(tp.ro_ring[i]) *= 0.f;  // the mask t >= L_i, NaN kept as the JAX kernel does
  }
  const float profit = step_view(tp, s, FromColumn{in, n}, FromColumn{in + n_ro * n, n},
                                 ToRows{RHo + b, B, true});
  for (int k = 0; k < tp.n_main; ++k) Xo[k * B + b] = s.X(k);
  for (int j = 0; j < tp.n_rt; ++j) Uo[j * B + b] = s.U(j);
  for (int i = 0; i < n_ro; ++i) Yo[i * B + b] = s.Y(i);
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

// A staged kernel's (K1, K25) block: st.words a thread, st.threads a block.
size_t staged_smem(const NetStage& st) { return (size_t)st.words * st.threads * sizeof(float); }
unsigned staged_blocks(const NetStage& st, long long B) {
  return (unsigned)((B + st.threads - 1) / st.threads);
}

}  // namespace

extern "C" {

int net_episode_returns(const NetTopo* topo, const NetSmem* lay, const NetStage* st,
                        const float* acts, const float* dems, const float* disc, float* out,
                        long long B, int T, cudaStream_t stream) {
  const size_t smem = staged_smem(*st);
  cudaError_t err = allow_state(k_episode_returns, smem);
  if (err != cudaSuccess) return (int)err;
  k_episode_returns<<<staged_blocks(*st, B), st->threads, smem, stream>>>(
      *topo, *lay, *st, acts, dems, disc, out, B, T);
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
  if (T < 1) return (int)cudaSuccess;  // nothing to write
  const int rows = k3_groups(T) * (e1 - e0);
  const dim3 grid(blocks_for(B), rows < 65535 ? rows : 65535);
  k_sample_streams<<<grid, kThreads, 0, stream>>>(*topo, tables, acts, dems, seed, act_scale,
                                                  B, T, e0, e1 - e0);
  return (int)cudaGetLastError();
}

int net_batched_step(const NetTopo* topo, const NetSmem* lay, const NetStage* st,
                     const float* X, const float* Y, const float* U, const float* RH,
                     const float* acts, const float* dems, float* Xo, float* Yo, float* Uo,
                     float* RHo, float* rew, float disc, int t, int lt, long long B,
                     cudaStream_t stream) {
  const size_t smem = staged_smem(*st);
  cudaError_t err = allow_state(k_batched_step, smem);
  if (err != cudaSuccess) return (int)err;
  k_batched_step<<<staged_blocks(*st, B), st->threads, smem, stream>>>(
      *topo, *lay, *st, X, Y, U, RH, acts, dems, Xo, Yo, Uo, RHo, rew, disc, t, lt, B);
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
