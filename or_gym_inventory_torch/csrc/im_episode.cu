// InvManagement whole-episode kernels for Hopper (sm_90a), bound with ctypes
// by ops/_build.py and wrapped by ops/episode_kernels.py, whose plain PyTorch
// versions compute the same functions.
//
// K7 k_im_returns  replaces pallas_episode_kernels._im_call (:779) behind
//    episode_returns_im (:802) and episode_returns_im_random (:815); body
//    _im_kernel :750, step _im_step_math :686. One thread a lane reads its
//    (T, m1) int32 actions (or, RANDOM, draws them: K8's action words at
//    episode 0) and its (T,) int32 demand, coalesced along B. Bound by
//    bytes: (T * (m1 + 1) + 1) * 4 per env, read once, but a lane's chain
//    of T dependent steps sets its time. It runs K8's episode body (the
//    state of ImSharedEpisode<M1>, an instance per m1 and mode), so on K9's
//    streams it gives K8's returns bit for bit, and stages a period's m1 + 1
//    words into shared memory ahead of the step by 4-byte cp.async copies
//    (cp_async.cuh), two buffers of `chunk` periods, the next chunk copied
//    while this one is stepped (commit_group / wait_group 1), as K1 does:
//    no global load sits on a period's chain. ops/episode_kernels.py
//    _im_k7_plan lays the ring and the staging out (ImStage). The first
//    design stepped on the 1,232-byte ImEpisode frame in local memory with
//    each period's m1 + 1 loads on the chain (tools/k3_k7_parent.cu).
// K8 k_im_returns_fused  replaces episode_returns_im_fused (:919, body
//    _im_fused_kernel :868). Actions and demand are drawn in the kernel
//    (im_step.cuh), so only the returns leave it. Bound by operations: per
//    env-step one Philox4x32-10 block (m1 + 1 = 4 words), the step and a
//    binary search of the demand table. One thread per (episode, lane): the
//    TPU interleaved E episodes per lane to hide the serial period chain;
//    here more resident threads do that job, so E only widens the grid.
//    The first version kept the whole state in the thread's ImEpisode, a
//    1,232-byte local frame; at 4,194,304 x 16 threads its loads went to
//    L2 (54.6 ms on an H100, PERF.md). Now the ring of fulfilled orders
//    lives in the thread's column of shared memory ([word][thread], lt m1
//    words, sized by ops/episode_kernels.py _im_fused_plan) and every stage
//    loop of im_step.cuh is unrolled, so on-hand, backlog, the actions and
//    the step's per-stage arrays are registers: no frame at all. There is
//    an instance for each m1 from 1 to IM_MAX_M1, its loops unrolled to
//    exactly m1 stages (32 registers at m1 = 3); one instance unrolled to
//    IM_MAX_M1 under i < m1 predicates took 71-79 registers and ran 1.8x
//    slower at m1 = 3 (tools/im_fused_sweep.py times both).
// K9 k_im_sample_streams<M1>  replaces sample_streams_debug_im (:1873, body
//    _im_streams_debug_kernel :901): the streams K8 draws, through the same
//    draws (im_draw_actions<M1>, im_demand). No period depends on another:
//    a period's words are counter (lane, episode, period, block), so a
//    thread draws kK9Periods (4) periods of one (lane, episode), each from
//    its own counter, on K3's 2-D grid (net_episode.cu): lanes along x, so
//    a warp's stores are consecutive lanes of one output row, and rows q =
//    (group of periods) x E + episode along y, no 64-bit division. An
//    instance per m1 (launch_k9_m1, as K7's and K8's), so the actions are
//    registers and there is no frame. The first design walked a lane's T
//    periods on one thread, the actions in a frame sized to IM_MAX_M1
//    (tools/k9_k21_parent.cu). Bound by bytes: the streams it writes.
//
// The period step and the draws are in im_step.cuh (their notes list the
// semantics that are easy to get wrong). The batch tail is masked, so any
// B >= 1 works. Discount: alpha**t is a Python double rounded to f32 in the
// JAX kernels (:775, :896); the wrapper passes that table.

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "im_step.cuh"
#include "launch.cuh"
#include "philox.cuh"

// K8's launch, sized by ops/episode_kernels.py _im_fused_plan (mirrored
// there by _ImSmem): threads a block and the ring's words a thread (lt m1).
struct ImSmem {
  int threads, words;
};

// K7's launch, laid out by ops/episode_kernels.py _im_k7_plan (mirrored
// there by _ImStage): threads a block, words a thread (the ring's lt m1,
// then two staging buffers of `chunk` periods of m1 + 1 words), the first
// staging word (lt m1).
struct ImStage {
  int threads, words, stage, chunk;
};

namespace {

// K9's periods a thread: a thread draws kK9Periods periods of one (lane,
// episode), each from its own counter, and writes their m1 + 1 words. One
// ran 5-15% slower at 65,536 lanes x 30 on an H100 (12-21% in USER mode),
// two within 5%, eight within 5% but 4-10% slower at m1 = 8 (64 registers)
// (tools/k9_k21_sweep.py times 1, 2 and 8 by a text change of this line).
constexpr int kK9Periods = 4;
__host__ __device__ constexpr int k9_groups(int T) { return (T + kK9Periods - 1) / kK9Periods; }

// K7: one thread a lane on K8's state (ImSharedEpisode<M1>: on-hand,
// backlog, the actions and the orders in registers, the ring in the
// thread's column of shared memory, words [0, st.stage)), its streamed
// words staged ahead of the step by cp.async into two buffers of st.chunk
// periods from word st.stage on, [word][thread] like the ring: a period is
// its M1 action words, then its demand word. RANDOM stages the demand alone
// and draws the actions as K8 does. A thread touches only its own column,
// so there is no barrier and a thread past the batch returns at once.
template <bool BACKLOG, bool RANDOM, int M1>
__global__ void k_im_returns(const __grid_constant__ ImParams p,
                             const __grid_constant__ ImStage st,
                             const int* __restrict__ acts,
                             const int* __restrict__ dems,
                             const float* __restrict__ disc,
                             float* __restrict__ out, unsigned seed, long long B,
                             int T) {
  extern __shared__ int im_words[];
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = blockDim.x, C = st.chunk;
  constexpr int kPeriod = M1 + 1;  // a staged period's words
  int* const stage = im_words + st.stage * n + threadIdx.x;
  // copy periods [t0, min(t0 + C, T)) into buffer (t0 / C) % 2, one group
  auto copy_chunk = [&](int t0) {
    int* dst = stage + ((t0 / C) & 1) * C * kPeriod * n;
    for (int t = t0; t < min(t0 + C, T); ++t, dst += kPeriod * n) {
      if (!RANDOM) {
#pragma unroll
        for (int i = 0; i < M1; ++i) cp_async4(dst + i * n, acts + ((long long)t * M1 + i) * B + b);
      }
      cp_async4(dst + M1 * n, dems + (long long)t * B + b);
    }
    cp_async_commit();
  };
  ImSharedEpisode<M1> s;
  s.rh = im_words + threadIdx.x;
  s.stride = n;
  im_reset<M1>(p, s);
  int act[M1], r_req[M1];
  float total = 0.f;
  copy_chunk(0);
  for (int t = 0; t < T; ++t) {
    const int c = t % C;
    if (c == 0) {
      if (t + C < T) copy_chunk(t + C);  // into the buffer the last chunk used
      else cp_async_commit();       // an empty group keeps the count
      cp_async_wait<1>();           // this chunk's group has landed
    }
    const int* q = stage + (((t / C) & 1) * C + c) * kPeriod * n;
    if (RANDOM) {
      WordStream ws(seed, 0u, (unsigned)b, 0u, (unsigned)t);
      im_draw_actions<M1>(p, ws, act);
    } else {
#pragma unroll
      for (int i = 0; i < M1; ++i) act[i] = q[i * n];
    }
    const float profit = im_step<BACKLOG, M1>(p, s, t, act, q[M1 * n], r_req);
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
  }
  out[b] = total;
}

// K8: one thread per (episode, lane), the state of ImSharedEpisode<M1>:
// on-hand and backlog in registers, the ring of fulfilled orders in the
// thread's lay.words words of dynamic shared memory ([word][thread]). A
// thread touches only its own column, so there is no barrier and a thread
// past the batch returns at once.
template <bool BACKLOG, int M1>
__global__ void k_im_returns_fused(const __grid_constant__ ImParams p,
                                   const float* __restrict__ table,
                                   const int* __restrict__ user_d,
                                   const float* __restrict__ disc,
                                   float* __restrict__ out, unsigned seed,
                                   long long B, int E, int T) {
  extern __shared__ int ring_words[];
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  ImSharedEpisode<M1> s;
  s.rh = ring_words + threadIdx.x;
  s.stride = (int)blockDim.x;
  im_reset<M1>(p, s);
  int act[im_width<M1>()], r_req[im_width<M1>()];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    WordStream ws(seed, 0u, lane, e, (unsigned)t);
    im_draw_actions<M1>(p, ws, act);
    const int d = im_demand(p, table, user_d, t, ws.next());
    const float profit = im_step<BACKLOG, M1>(p, s, t, act, d, r_req);
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
  }
  out[idx] = total;  // (E, B), episode-major
}

// K9 on a 2-D grid: x over the lanes, y over the rows q = (group of
// kK9Periods periods) * E + episode (a block strides over the rows past the
// grid's 65,535). Each period: its M1 action words, then the demand word,
// stored to (T, E, M1, B) and (T, E, B).
template <int M1>
__global__ void k_im_sample_streams(const __grid_constant__ ImParams p,
                                    const float* __restrict__ table,
                                    const int* __restrict__ user_d,
                                    int* __restrict__ acts, int* __restrict__ dems,
                                    unsigned seed, long long B, int E, int T) {
  const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int rows = k9_groups(T) * E;
  for (int q = blockIdx.y; q < rows; q += gridDim.y) {
    const int e = q % E, t0 = q / E * kK9Periods;
#pragma unroll
    for (int k = 0; k < kK9Periods; ++k) {
      const int t = t0 + k;
      if (t >= T) break;
      WordStream ws(seed, 0u, (unsigned)lane, (unsigned)e, (unsigned)t);
      int act[M1];
      im_draw_actions<M1>(p, ws, act);
      const long long row = (long long)t * E + e;
      int* const a = acts + row * M1 * B + lane;
#pragma unroll
      for (int i = 0; i < M1; ++i) a[i * B] = act[i];
      dems[row * B + lane] = im_demand(p, table, user_d, t, ws.next());
    }
  }
}

template <bool BACKLOG, int M1>
int launch_fused(const ImParams& p, const ImSmem& lay, const float* table, const int* user_d,
                 const float* disc, float* out, unsigned seed, long long B, int E, int T,
                 cudaStream_t stream) {
  auto kernel = k_im_returns_fused<BACKLOG, M1>;
  const size_t smem = (size_t)lay.words * lay.threads * sizeof(int);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B * E + lay.threads - 1) / lay.threads);
  kernel<<<blocks, lay.threads, smem, stream>>>(p, table, user_d, disc, out, seed, B, E, T);
  return (int)cudaGetLastError();
}

// K8's instance for the params' m1, M1 .. IM_MAX_M1.
template <bool BACKLOG, int M1 = 1>
int launch_fused_m1(const ImParams& p, const ImSmem& lay, const float* table, const int* user_d,
                    const float* disc, float* out, unsigned seed, long long B, int E, int T,
                    cudaStream_t stream) {
  if (p.m1 == M1)
    return launch_fused<BACKLOG, M1>(p, lay, table, user_d, disc, out, seed, B, E, T, stream);
  if constexpr (M1 < IM_MAX_M1)
    return launch_fused_m1<BACKLOG, M1 + 1>(p, lay, table, user_d, disc, out, seed, B, E, T,
                                            stream);
  return (int)cudaErrorInvalidValue;
}

template <bool BACKLOG, bool RANDOM, int M1>
int launch_k7(const ImParams& p, const ImStage& st, const int* acts, const int* dems,
              const float* disc, float* out, unsigned seed, long long B, int T,
              cudaStream_t stream) {
  auto kernel = k_im_returns<BACKLOG, RANDOM, M1>;
  const size_t smem = (size_t)st.words * st.threads * sizeof(int);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + st.threads - 1) / st.threads);
  kernel<<<blocks, st.threads, smem, stream>>>(p, st, acts, dems, disc, out, seed, B, T);
  return (int)cudaGetLastError();
}

// K7's instance for the params' m1, M1 .. IM_MAX_M1.
template <bool BACKLOG, bool RANDOM, int M1 = 1>
int launch_k7_m1(const ImParams& p, const ImStage& st, const int* acts, const int* dems,
                 const float* disc, float* out, unsigned seed, long long B, int T,
                 cudaStream_t stream) {
  if (p.m1 == M1)
    return launch_k7<BACKLOG, RANDOM, M1>(p, st, acts, dems, disc, out, seed, B, T, stream);
  if constexpr (M1 < IM_MAX_M1)
    return launch_k7_m1<BACKLOG, RANDOM, M1 + 1>(p, st, acts, dems, disc, out, seed, B, T,
                                                 stream);
  return (int)cudaErrorInvalidValue;
}

// K9's instance for the params' m1, M1 .. IM_MAX_M1.
template <int M1 = 1>
int launch_k9_m1(const ImParams& p, const float* table, const int* user_d, int* acts,
                 int* dems, unsigned seed, long long B, int E, int T, cudaStream_t stream) {
  if (p.m1 == M1) {
    const int rows = k9_groups(T) * E;
    const dim3 grid(blocks_for(B), rows < 65535 ? rows : 65535);
    k_im_sample_streams<M1><<<grid, kThreads, 0, stream>>>(p, table, user_d, acts, dems, seed,
                                                            B, E, T);
    return (int)cudaGetLastError();
  }
  if constexpr (M1 < IM_MAX_M1)
    return launch_k9_m1<M1 + 1>(p, table, user_d, acts, dems, seed, B, E, T, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K7 on st->threads a block with st->words a thread, the instance unrolled
// to the params' m1; random != 0: K7 _random, the actions drawn in the
// kernel (acts unused).
int im_episode_returns(const ImParams* p, const ImStage* st, const int* acts, const int* dems,
                       const float* disc, float* out, unsigned seed, int random,
                       int backlog, long long B, int T, cudaStream_t stream) {
  auto launch = backlog ? (random ? launch_k7_m1<true, true> : launch_k7_m1<true, false>)
                        : (random ? launch_k7_m1<false, true> : launch_k7_m1<false, false>);
  return launch(*p, *st, acts, dems, disc, out, seed, B, T, stream);
}

// K8 on lay->threads a block with lay->words of ring a thread, the
// instance unrolled to the params' m1.
int im_episode_returns_fused(const ImParams* p, const ImSmem* lay, const float* table,
                             const int* user_d, const float* disc, float* out,
                             unsigned seed, int backlog, long long B, int E,
                             int T, cudaStream_t stream) {
  return backlog ? launch_fused_m1<true>(*p, *lay, table, user_d, disc, out, seed, B, E, T,
                                         stream)
                 : launch_fused_m1<false>(*p, *lay, table, user_d, disc, out, seed, B, E, T,
                                          stream);
}

// K9, the instance unrolled to the params' m1.
int im_sample_streams(const ImParams* p, const float* table, const int* user_d,
                      int* acts, int* dems, unsigned seed, long long B, int E,
                      int T, cudaStream_t stream) {
  if (T < 1) return (int)cudaSuccess;  // nothing to write
  return launch_k9_m1(*p, table, user_d, acts, dems, seed, B, E, T, stream);
}

}  // extern "C"
