// Newsvendor whole-episode kernels for Hopper (sm_90a), bound with ctypes by
// ops/_build.py and wrapped by ops/episode_kernels.py, whose plain PyTorch
// versions compute the same functions.
//
// K13 k_nv_returns<RANDOM, L>  replaces pallas_episode_kernels._nv_call
//    (:123) behind episode_returns_nv (:146) and episode_returns_nv_random
//    (:157); body _nv_kernel :99. One thread a lane reads its econ (5, B)
//    and its (T,) f32 actions, clipped to [0, max_order] (or, RANDOM, draws
//    them: K16's action words of episode 0), and its (T,) demand, coalesced
//    along B. Bound by bytes: (5 + 2 T + 1) * 4 per env, read or written
//    once; but a lane's T periods are a chain (each order's cap reads the
//    pipeline), and what sets the time is the instructions a period issues
//    and the latency of that chain, not the loads. So the pipeline is a
//    shift register of L registers (nv_step_shift, an instance per L from 0
//    to NV_MAX_L and per mode), and the periods of a chunk of kK13Chunk are
//    unrolled, so that the parts of a period off the chain (the reward, the
//    discount, the next period's words) overlap the chain's. The order and
//    demand words are staged into shared memory ahead of the step by
//    4-byte cp.async copies (cp_async.cuh), two buffers of kK13Chunk
//    periods a thread ([word][thread]), the next chunk copied while this one
//    is stepped, as K1 and K7 do; RANDOM stages the demand alone and draws
//    the chunk's orders while the copies are in flight.
//    ops/episode_kernels.py _nv_k13_plan sizes the block (NvParams.
//    k13_threads) and its shared memory. The float operations are
//    nv_step_ring's, in its order, so the returns equal the first design's
//    bit for bit. The first design stepped on NvEpisode's ring of NV_MAX_L
//    floats in a local frame, each period's loads on the chain; a second
//    kept the ring in a column of shared memory and staged the streams as
//    here, one period at a time (both in tools/k13_parent.cu, which
//    tools/k13_sweep.py times in turns with this one).
// K14/K15 k_nv_episodes<ECON_IN>  replace _nv_fused_call (:341) behind
//    episode_returns_nv_fused (:368) and sample_streams_debug_nv (:529):
//    econ streamed in, actions and Poisson(mu) demand drawn in the kernel
//    (E = 1), the returns or, with DUMP, the streams written out.
// K16/K17 k_nv_episodes<!ECON_IN>  replace _nv_reset_fused_call (:469)
//    behind episode_returns_nv_reset_fused (:495) and
//    sample_streams_debug_nv_reset (:513): the reset's economics drawn in
//    the kernel too, E episodes per lane; returns (E, B) or the streams econ
//    (E, 5, B), actions and demand (T, E, B). The production Newsvendor path
//    (vector.fast_episodes.random_episode_returns) runs K16 alone.
//
// Design: one thread per (episode, lane), as K8. The TPU interleaved E
// episodes per lane to hide the serial period chain; here more resident
// threads do that job, so E only widens the grid. Bound by operations. The
// inversion's recurrence depends on mu alone, so it runs once per episode
// (nv_step.cuh nv_table_setup) and leaves its K suffix sums in the thread's
// column of a [k][thread] dynamic shared-memory table (4 K bytes a thread,
// 708 at mu_max 200); a period's count is then a lower-bound search of
// ceil(log2 K) probes (nv_table_invert), where the first version reran the
// K-step recurrence for every chunk of 16 periods and compared every sum
// with each threshold (~2 K operations an env-step). Per env-step that
// leaves the period's Philox block, ~8 probes, the step and 1/T of the
// setup. The table bounds the resident threads (5 blocks of 64, 320 an
// SM, at K = 177), so the wrapper sizes the block to it (_nv_table_plan;
// the pipeline ring stays in local memory: under the table in shared
// memory, which leaves fewer threads an SM, K16 ran slower);
// the demand of NV_CHUNK = 16 periods is still drawn and inverted at once,
// so 16 independent Philox blocks and searches overlap their latencies.
// For a K whose table a block of 32 cannot hold, the plan launches the
// TABLE = false instance, which counts linearly as the first version did.
// The count does not depend on the chunk or the method, so neither do the
// draws.
//
// Random stream (philox.cuh): key (seed, 0), counter (lane, episode, period,
// block). The reset's five uniforms are the first five words of period
// NV_ECON_PERIOD, which no period uses; period t's first word is its
// action (u * max_order), its second its demand's uniform. The layout does
// not depend on the chunk, E or the batch, so on K17's streams K16 = K14(econ)
// = K13 _random(econ, demand) = K13(econ, actions, demand).

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "launch.cuh"
#include "nv_step.cuh"
#include "philox.cuh"

namespace {

// K13's periods a staging buffer and an unrolled chunk of the period loop;
// 8 keeps 16 words a thread in flight while a chunk is stepped, about 4 MB
// over the card at 65,536 lanes (tools/k13_sweep.py times 4 and 16 by a
// text change of this line; ops/episode_kernels.py NV_K13_CHUNK mirrors it).
constexpr int kK13Chunk = 8;

// K13: one thread a lane, its pipeline in registers (nv_step_shift), its
// column of dynamic shared memory ([word][thread]) two staging buffers of
// kK13Chunk periods: a period's order word, then its demand word (RANDOM:
// the demand word alone). A thread touches only its own column, so there
// is no barrier and a thread past the batch returns at once.
template <bool RANDOM, int L>
__global__ void k_nv_returns(const __grid_constant__ NvParams p,
                             const float* __restrict__ econ,
                             const float* __restrict__ acts,
                             const float* __restrict__ dems,
                             const float* __restrict__ disc,
                             float* __restrict__ out, unsigned seed, long long B,
                             int T) {
  extern __shared__ float nv_words[];
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int kWords = RANDOM ? 1 : 2;  // staged words a period
  const int n = blockDim.x;
  float* const stage = nv_words + threadIdx.x;
  // copy periods [t0, t0 + kK13Chunk) (those below T) into buffer ``buf``
  auto copy_chunk = [&](int t0, int buf) {
    float* const dst = stage + buf * kK13Chunk * kWords * n;
#pragma unroll
    for (int i = 0; i < kK13Chunk; ++i) {
      if (t0 + i >= T) break;
      const long long k = (long long)(t0 + i) * B + b;
      if (!RANDOM) cp_async4(dst + 2 * i * n, acts + k);
      cp_async4(dst + (kWords * i + kWords - 1) * n, dems + k);
    }
    cp_async_commit();
  };
  float ring[L > 0 ? L : 1];
#pragma unroll
  for (int j = 0; j < L; ++j) ring[j] = 0.f;
  const NvEcon c{__ldg(econ + b), __ldg(econ + B + b), __ldg(econ + 2 * B + b),
                 __ldg(econ + 3 * B + b), 0.f};
  float total = 0.f;
  copy_chunk(0, 0);
  for (int t0 = 0, buf = 0; t0 < T; t0 += kK13Chunk, buf ^= 1) {
    if (t0 + kK13Chunk < T) copy_chunk(t0 + kK13Chunk, buf ^ 1);
    else cp_async_commit();  // an empty group keeps the count
    float order[kK13Chunk];
    if (RANDOM) {  // this chunk's orders, drawn while the copies are in flight
#pragma unroll
      for (int i = 0; i < kK13Chunk; ++i) {
        WordStream ws(seed, 0u, (unsigned)b, 0u, (unsigned)(t0 + i));
        order[i] = __fmul_rn(u01(ws.next()), p.max_order);
      }
    }
    cp_async_wait<1>();  // this chunk's group has landed
    const float* const q = stage + buf * kK13Chunk * kWords * n;
#pragma unroll
    for (int i = 0; i < kK13Chunk; ++i) {
      if (t0 + i >= T) break;
      if (!RANDOM) order[i] = min_nan(max_nan(q[2 * i * n], 0.f), p.max_order);
      float q_cap;
      const float reward = nv_step_shift<L>(p, ring, c, order[i],
                                            q[(kWords * i + kWords - 1) * n], q_cap);
      total = __fadd_rn(total, __fmul_rn(__ldg(disc + t0 + i), reward));
    }
  }
  out[b] = total;
}

template <bool ECON_IN, bool DUMP, bool TABLE>
__global__ void k_nv_episodes(const __grid_constant__ NvParams p,
                              const float* __restrict__ lgam,
                              const float* __restrict__ econ_in,
                              const float* __restrict__ disc,
                              float* __restrict__ out, float* __restrict__ econ_out,
                              float* __restrict__ acts, float* __restrict__ dems,
                              unsigned seed, long long B, int E, int T) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  NvEpisode s;
  nv_reset(p, s);
  if (ECON_IN) {
    s.price = __ldg(econ_in + lane);
    s.cost = __ldg(econ_in + B + lane);
    s.h = __ldg(econ_in + 2 * B + lane);
    s.k = __ldg(econ_in + 3 * B + lane);
    s.mu = __ldg(econ_in + 4 * B + lane);
  } else {
    WordStream ws(seed, 0u, lane, e, NV_ECON_PERIOD);
    float u[5];
    for (int r = 0; r < 5; ++r) u[r] = u01(ws.next());
    nv_econ(p, u, s);
    if (DUMP) {
      float* row = econ_out + (long long)e * 5 * B + lane;  // (E, 5, B)
      row[0] = s.price;
      row[B] = s.cost;
      row[2 * B] = s.h;
      row[3 * B] = s.k;
      row[4 * B] = s.mu;
    }
  }
  extern __shared__ float nv_table[];
  NvPoisson q = nv_poisson_anchor(p, lgam, s.mu);
  NvTable tab;
  if (TABLE)
    tab = nv_table_setup(p, q, nv_table + threadIdx.x, blockDim.x);
  else
    q.total = nv_poisson_total(p, q);
  float total = 0.f;
  for (int t0 = 0; t0 < T; t0 += NV_CHUNK) {
    float order[NV_CHUNK], v[NV_CHUNK], d[NV_CHUNK];
#pragma unroll
    for (int i = 0; i < NV_CHUNK; ++i) {
      order[i] = 0.f;
      v[i] = 0.f;  // past the horizon: no step reads it
      if (t0 + i < T) {
        WordStream ws(seed, 0u, lane, e, (unsigned)(t0 + i));
        order[i] = __fmul_rn(u01(ws.next()), p.max_order);
        v[i] = __fmul_rn(__fsub_rn(1.f, u01(ws.next())), q.total);
      }
    }
    if (TABLE)
      nv_table_invert(p, q, tab, v, d);
    else
      nv_poisson_invert(p, q, v, d);
#pragma unroll
    for (int i = 0; i < NV_CHUNK; ++i) {
      const int t = t0 + i;
      if (t >= T) continue;
      if (DUMP) {
        const long long k = ((long long)t * E + e) * B + lane;  // (T, E, B)
        acts[k] = order[i];
        dems[k] = d[i];
      } else {
        total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), nv_step(p, s, order[i], d[i])));
      }
    }
  }
  if (!DUMP) out[idx] = total;  // (E, B), episode-major
}

// K13's instance for the params' lead time, L .. NV_MAX_L.
template <bool RANDOM, int L = 0>
int launch_k13(const NvParams& p, const float* econ, const float* acts, const float* dems,
               const float* disc, float* out, unsigned seed, long long B, int T,
               cudaStream_t stream) {
  if (p.L == L) {
    if (p.k13_threads < 1) return (int)cudaErrorInvalidValue;
    auto kernel = k_nv_returns<RANDOM, L>;
    const size_t smem = (size_t)2 * kK13Chunk * (RANDOM ? 1 : 2) * p.k13_threads * sizeof(float);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((B + p.k13_threads - 1) / p.k13_threads);
    kernel<<<blocks, p.k13_threads, smem, stream>>>(p, econ, acts, dems, disc, out, seed, B, T);
    return (int)cudaGetLastError();
  }
  if constexpr (L < NV_MAX_L)
    return launch_k13<RANDOM, L + 1>(p, econ, acts, dems, disc, out, seed, B, T, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool ECON_IN, bool DUMP, bool TABLE>
int launch_plan(const NvParams& p, const float* lgam, const float* econ_in,
                const float* disc, float* out, float* econ_out, float* acts, float* dems,
                unsigned seed, long long B, int E, int T, cudaStream_t stream) {
  auto kernel = k_nv_episodes<ECON_IN, DUMP, TABLE>;
  const size_t smem = TABLE ? (size_t)p.K * p.threads * sizeof(float) : 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B * E + p.threads - 1) / p.threads);
  kernel<<<blocks, p.threads, smem, stream>>>(p, lgam, econ_in, disc, out, econ_out, acts,
                                              dems, seed, B, E, T);
  return (int)cudaGetLastError();
}

template <bool ECON_IN, bool DUMP>
int launch_episodes(const NvParams& p, const float* lgam, const float* econ_in,
                    const float* disc, float* out, float* econ_out, float* acts,
                    float* dems, unsigned seed, long long B, int E, int T,
                    cudaStream_t stream) {
  return p.table ? launch_plan<ECON_IN, DUMP, true>(p, lgam, econ_in, disc, out, econ_out,
                                                    acts, dems, seed, B, E, T, stream)
                 : launch_plan<ECON_IN, DUMP, false>(p, lgam, econ_in, disc, out, econ_out,
                                                     acts, dems, seed, B, E, T, stream);
}

}  // namespace

extern "C" {

// K13 on p->k13_threads a block, the instance for the params' lead time;
// random != 0: K13 _random, the actions drawn in the kernel (acts unused).
int nv_episode_returns(const NvParams* p, const float* econ, const float* acts,
                       const float* dems, const float* disc, float* out,
                       unsigned seed, int random, long long B, int T,
                       cudaStream_t stream) {
  return random ? launch_k13<true>(*p, econ, acts, dems, disc, out, seed, B, T, stream)
                : launch_k13<false>(*p, econ, acts, dems, disc, out, seed, B, T, stream);
}

// econ_in != nullptr: K14/K15, the econ (5, B) streamed in (E must be 1);
// otherwise K16/K17, drawn. acts == nullptr: returns into out (K14, K16);
// otherwise the streams, with econ_out for K17 (K15, K17).
int nv_episodes(const NvParams* p, const float* lgam, const float* econ_in,
                const float* disc, float* out, float* econ_out, float* acts,
                float* dems, unsigned seed, long long B, int E, int T,
                cudaStream_t stream) {
  const bool dump = acts != nullptr;
  if (econ_in)
    return dump ? launch_episodes<true, true>(*p, lgam, econ_in, disc, out, econ_out,
                                              acts, dems, seed, B, E, T, stream)
                : launch_episodes<true, false>(*p, lgam, econ_in, disc, out, econ_out,
                                               acts, dems, seed, B, E, T, stream);
  return dump ? launch_episodes<false, true>(*p, lgam, econ_in, disc, out, econ_out,
                                             acts, dems, seed, B, E, T, stream)
              : launch_episodes<false, false>(*p, lgam, econ_in, disc, out, econ_out,
                                              acts, dems, seed, B, E, T, stream);
}

}  // extern "C"
