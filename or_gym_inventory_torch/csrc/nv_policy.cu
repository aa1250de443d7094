// Newsvendor kernels under a folded MLP actor, and the dump of the policy
// kernels' normals, for Hopper (sm_90a), bound with ctypes by ops/_build.py
// and wrapped by ops/episode_kernels.py, whose plain PyTorch versions compute
// the same functions.
//
// K18 k_nv_policy_returns<1, 0, 1, LAYOUT>  replaces
//    pallas_episode_kernels.rollout_traj_nv (:1796; body _nv_traj_kernel
//    :1752, policy head traj_policy "ppo" :1036, trunk mlp_forward :1124).
//    One stochastic-policy episode per lane, the reset, the per-lane
//    Poisson(mu) demand and the actor all in the kernel, the training
//    streams written to device memory: econ (5, B), the capped orders, the
//    pre-squash raws, the undiscounted rewards and the demand, (T[, 1], B)
//    each, coalesced along B. PPO with rollout="kernel" feeds on it.
// K19/K20 k_nv_policy_returns<STOCH, DUMP, 0, LAYOUT>  replace
//    _nv_policy_call (:603) behind episode_returns_nv_policy (:648) and its
//    stream-dumping twin sample_policy_streams_debug_nv (:665; body
//    _nv_policy_kernel :544): the same policy, deterministic or stochastic,
//    E episodes per lane, returns (E, B) gamma^t-discounted; with DUMP it
//    also writes the econ (E, 5, B), the orders before the max_inventory cap
//    (T, E, B) and the demand (T, E, B) it used.
// K28 k_nv_rollout_traj_wide  replaces rollout_traj_nv (:1796) under the
//    off-policy heads traj_policy "det", "sac" and "uniform" (:1062-1080) on
//    a relu (or tanh) trunk, the collection of OffPolicyConfig(collect=
//    "kernel"): K18's streams, the raw stream holding the normalised [-1, 1]
//    orders. k_nv_rollout_traj_cluster runs the actor over a thread-block
//    cluster (cluster_mlp.cuh), each tile's demand counted up front by
//    every thread; k_nv_rollout_traj_wide, the first design, is the wide
//    route for an actor whose slice fits no CTA (a block per 32 lanes,
//    wide_mlp.cuh; threads 0..31 own the lanes' resets, demand chunks and
//    pipelines). Bound by operations: the (256, 256) actor's ~1.4e5 per
//    env-step.
// K21 k_sample_normals  replaces sample_normals_debug (:1849): the
//    Box-Muller normals of the policy kernels' generator, (rows, B), for the
//    goodness-of-fit pin. A thread walks kK21Rows (8) rows of one lane on a
//    2-D grid (lanes along x, row groups along y), so no thread divides a
//    64-bit index; each element is one Philox block, and the thread computes
//    the next row's block while it forms this row's normal. The first design
//    gave a thread one element of a 1-D grid, its (row, lane) from a 64-bit
//    division (tools/k9_k21_parent.cu). Bound by operations: a Philox
//    block, the normal's logf, cosf and sqrtf.
//
// K18-K20's design: a block per tile of (episode, lane) pairs, one thread
// each (mlp_tile.cuh), as K4-K6 and K10-K12; K18 is the one-episode,
// stochastic instance with its streams written (TRAJ), so it cannot drift
// from K19. The first versions ran one thread per pair with the actor on
// the FP32 cores (mlp.cuh), each chunk of 16 periods rerunning the K = 177
// recurrence steps of the linear count: K19 37.97 ms at 65,536 x 16 x 50,
// K18 2.6996 ms at 65,536 x 50 on an H100 (PERF.md). Now:
// - the reset draws the econ, builds the episode's table of suffix sums
//   (nv_step.cuh nv_table_setup, K14-K17's) in the pair's column and
//   searches every period's demand up front (nv_table_invert, the same
//   counts bit for bit as the linear count), keeping each as 16 bits, two a
//   word, in rows that last the episode; a block barrier, and the table's
//   rows become the activations and the pipeline (NV_DEM_UPFRONT). The
//   table needs K rows a lane only while the reset runs; the demand ceil(T
//   / 2);
// - per period each thread writes its obs column (through keep_nan); its
//   warp runs the actor for its 32 pairs on the tensor cores in 3xTF32;
//   the thread adds its normal when stochastic, squashes the order and
//   steps its pair with nv_step_ring on the pipeline in its column of
//   shared memory ([slot][lane]); econ, head and the Poisson anchor live in
//   registers. No local frame in the deterministic instances;
// - K18 writes the econ at the reset, and per period the raw before the
//   squash, the capped order that enters the pipeline, the undiscounted
//   reward and the demand.
// Bound by operations: the products, 2 sum(in out) FLOPs an env-step, as
// three TF32 products each; the reset's table and searches come next.
// Where no table fits a block, the demand is the linear count per chunk
// (NV_DEM_LINEAR); tools/nv_tile_sweep.py times it, and two layouts of its
// own, beside the up-front one. The batch tail is masked: a warp past it
// returns after the reset's barrier, a pair past it computes but writes
// nothing. The observation is assembled from the live state in the order of
// _nv_policy_kernel (:586) and _nv_traj_kernel (:1783): econ, then the
// pipeline oldest first, ring[(head + j) % L]. K21 writes one float per two
// words: bound by bytes.
//
// Random stream (philox.cuh): key (seed, 1), counter (lane, episode, period,
// block). The reset's five uniforms are the first five words of period
// NV_ECON_PERIOD; period t's word 0 is its demand's uniform and, when
// stochastic, words 1 and 2 the u1 and u2 of its normal (act_dim 1), so the
// policy period recomputes the period's block for them. K18 is episode 0, so
// episode 0 of the stochastic K19 draws exactly K18's words and, on the same
// tile, gives K18's streams bit for bit; the deterministic K19 draws one
// word a period.
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

#include "cluster_mlp.cuh"
#include "launch.cuh"
#include "mlp_tile.cuh"
#include "nv_step.cuh"
#include "philox.cuh"
#include "wide_mlp.cuh"

// Where the tile kernel K18-K20 takes its demand from (NvTile.layout):
#define NV_DEM_LINEAR 0   // per chunk of NV_CHUNK periods, the linear count
                          // (nv_poisson_invert) into NV_CHUNK rows: where
                          // no table fits a block (_nv_tile_plan)
#define NV_DEM_UPFRONT 1  // the whole episode's demand searched at the
                          // reset into ceil(T / 2) rows, the table on the
                          // rows the activations and the ring take after it

// The tile kernel's regions beside the MlpTile's activation buffer, float
// offsets, each [row][lane] at a stride of the tile's lanes (a multiple of
// 32, so that the lanes' data-dependent table probes and their rows of
// demand and pipeline fall on 32 banks), as ops/episode_kernels.py
// _nv_tile_plan lays them out (mirrored there by _NvTile).
struct NvTile {
  int layout;   // NV_DEM_*
  int s_dem;    // the demand rows
  int s_ring;   // the pipeline, L rows
  int s_table;  // the table, K rows; -1 for NV_DEM_LINEAR
};

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

// The tile's demand of one (lane, episode): the thresholds of the period
// words and, per layout, the linear count or the table's search.
struct TileDemand {
  const NvParams& p;
  const NvTile& nt;
  NvPoisson q;
  NvTable tb;
  float* rows;  // the pair's column of the demand rows, nt.s_dem
  int N;        // the rows' stride: the tile's lanes

  // LAYOUT's setup of the anchor: the renormalisation total, or the table
  // in the pair's column of nt.s_table and the total.
  template <int LAYOUT>
  __device__ __forceinline__ void setup(float* smem, int n) {
    if (LAYOUT == NV_DEM_LINEAR)
      q.total = nv_poisson_total(p, q);
    else
      tb = nv_table_setup(p, q, smem + nt.s_table + n, N);
  }

  // NV_DEM_LINEAR: periods t0 .. t0 + NV_CHUNK - 1 into the rows.
  __device__ __forceinline__ void chunk(unsigned seed, unsigned lane, unsigned e, int t0,
                                        int T) const {
    float v[NV_CHUNK], d[NV_CHUNK];
    chunk_thresholds(q, seed, lane, e, t0, T, v);
    nv_poisson_invert(p, q, v, d);
#pragma unroll
    for (int i = 0; i < NV_CHUNK; ++i) rows[i * N] = d[i];
  }

  // NV_DEM_UPFRONT: every period's demand searched in the table into the
  // rows, two a word (16 bits each: a demand is an integer in [0, kc + 1],
  // kc + 1 < 2^16 where a table fits, _nv_tile_plan); a NaN mu (then kc is
  // NaN, and so is every demand) is read back from kc.
  __device__ __forceinline__ void upfront(unsigned seed, unsigned lane, unsigned e, int T) {
    unsigned* words = reinterpret_cast<unsigned*>(rows);
    for (int t0 = 0; t0 < T; t0 += NV_CHUNK) {
      float v[NV_CHUNK], d[NV_CHUNK];
      chunk_thresholds(q, seed, lane, e, t0, T, v);
      nv_table_invert(p, q, tb, v, d);
#pragma unroll
      for (int i = 0; i < NV_CHUNK; i += 2)
        if (t0 + i < T)
          words[((t0 + i) >> 1) * N] = (unsigned)d[i] | ((unsigned)d[i + 1] << 16);
    }
  }

  // The demand of period t, i its index in the chunk.
  template <int LAYOUT>
  __device__ __forceinline__ float at(int t, int i) const {
    if (LAYOUT == NV_DEM_LINEAR) return rows[i * N];
    if (isnan(q.kc)) return __int_as_float(0x7fffffff);
    const unsigned w = reinterpret_cast<const unsigned*>(rows)[(t >> 1) * N];
    return (float)((w >> ((t & 1) << 4)) & 0xFFFFu);
  }
};

// The pair's observation column x (rows S apart): econ, then the pipeline
// oldest first, through keep_nan
// (a NaN order reaches the ring); then zero rows up to pad8(obs_dim).
__device__ __forceinline__ void tile_obs(const NvParams& p, const NvEcon& c,
                                         const NvSharedRing& ring, int head, int obs_pad,
                                         float* x, int S) {
  x[0] = keep_nan(c.price);
  x[S] = keep_nan(c.cost);
  x[2 * S] = keep_nan(c.h);
  x[3 * S] = keep_nan(c.k);
  x[4 * S] = keep_nan(c.mu);
  for (int j = 0; j < p.L; ++j) {
    int k = head + j;
    if (k >= p.L) k -= p.L;
    x[(5 + j) * S] = keep_nan(ring(k));
  }
  for (int k = 5 + p.L; k < obs_pad; ++k) x[k * S] = 0.f;
}

// The reset of one (lane, episode) in the tile: the economics from the
// first five words of period NV_ECON_PERIOD (written when DUMP), the
// Poisson anchor.
template <bool DUMP>
__device__ __forceinline__ NvEcon tile_reset(const NvParams& p, const float* __restrict__ lgam,
                                             unsigned seed, unsigned lane, unsigned e,
                                             bool live, float* econo, long long B,
                                             NvPoisson& q) {
  WordStream ws(seed, 1u, lane, e, NV_ECON_PERIOD);
  float u[5];
#pragma unroll
  for (int r = 0; r < 5; ++r) u[r] = u01(ws.next());
  const NvEcon c = nv_econ(p, u);
  if (DUMP && live) {
    float* row = econo + (long long)e * 5 * B + lane;  // (E, 5, B)
    row[0] = c.price;
    row[B] = c.cost;
    row[2 * B] = c.h;
    row[3 * B] = c.k;
    row[4 * B] = c.mu;
  }
  q = nv_poisson_anchor(p, lgam, c.mu);
  return c;
}

// The streams K18 writes (TRAJ) beside the econ and demand (DUMP's econo
// and demo), each (T, B): the capped orders, the pre-squash raws, the
// undiscounted rewards.
struct NvTrajStreams {
  float *orders, *raw, *rew;
};

// K18-K20 on the tensor-core tile (mlp_tile.cuh): a block of m.lanes
// (lane, episode) pairs, one thread each, the pair's column of the
// activation buffer its observation and H. LAYOUT is where the demand
// comes from (NvTile). The episode's pipeline lives in the pair's column
// of nt.s_ring; its head, econ and Poisson anchor in registers.
template <bool STOCH, bool DUMP, bool TRAJ, int LAYOUT>
__global__ void k_nv_policy_returns(const __grid_constant__ NvParams p,
                                    const __grid_constant__ MlpTile m,
                                    const __grid_constant__ NvTile nt,
                                    const float* __restrict__ w,
                                    const float* __restrict__ lgam,
                                    const float* __restrict__ disc,
                                    float* __restrict__ out, float* __restrict__ econo,
                                    float* __restrict__ acto, float* __restrict__ demo,
                                    const __grid_constant__ NvTrajStreams tr, unsigned seed,
                                    long long B, int E, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = threadIdx.x, S = m.stride, N = m.lanes;
  const long long pair0 = (long long)blockIdx.x * N, idx = pair0 + n;
  const bool past = pair0 + (n & ~31) >= B * E;  // the warp's pairs all lie past the batch
  constexpr bool upfront = LAYOUT == NV_DEM_UPFRONT;
  if (!upfront && past) return;
  const bool live = idx < B * E;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  TileDemand dem{p, nt, {}, {}, smem + nt.s_dem + n, N};
  const NvEcon c = tile_reset<DUMP || TRAJ>(p, lgam, seed, lane, e, live, econo, B, dem.q);
  dem.setup<LAYOUT>(smem, n);
  if (upfront) {
    // the whole episode's demand now; then the table is dead, and its rows
    // become the activations and the ring (a block barrier between)
    dem.upfront(seed, lane, e, T);
    __syncthreads();
    if (past) return;
  }
  const NvSharedRing ring{smem + nt.s_ring + n, N};
  for (int j = 0; j < p.L; ++j) ring(j) = 0.f;
  int head = 0;
  const float stdv = STOCH ? __ldg(w + m.std) : 0.f;
  const int obs_pad = (m.dims[0] + 7) & ~7;
  float* x = smem + m.s_x0 + n;
  float total = 0.f;
  for (int t0 = 0; t0 < T; t0 += NV_CHUNK) {
    if (!upfront) dem.chunk(seed, lane, e, t0, T);
    const int cn = min(NV_CHUNK, T - t0);
    for (int i = 0; i < cn; ++i) {
      const int t = t0 + i;
      tile_obs(p, c, ring, head, obs_pad, x, S);
      __syncwarp();
      float v = mlp_tile_forward(m, w, smem)[n];
      if (STOCH) {
        WordStream ws(seed, 1u, lane, e, (unsigned)t);
        ws.next();  // word 0: the period's demand
        const unsigned u1 = ws.next();
        v = __fadd_rn(v, __fmul_rn(stdv, normal01(u1, ws.next())));
      }
      const long long k = ((long long)t * E + e) * B + lane;  // (T, E, B)
      if (TRAJ && live) tr.raw[k] = v;
      const float order = __fmul_rn(__fadd_rn(tanhf(v), 1.f), m.half_hi[0]);
      const float d = dem.at<LAYOUT>(t, i);
      if (DUMP && live) acto[k] = order;
      if ((DUMP || TRAJ) && live) demo[k] = d;
      float qty;
      const float reward = nv_step_ring(p, ring, head, c, order, d, qty);
      if (TRAJ) {
        if (live) {
          tr.orders[k] = qty;
          tr.rew[k] = reward;
        }
      } else {
        total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), reward));
      }
    }
  }
  if (!TRAJ && live) out[idx] = total;  // (E, B), episode-major
}

// K21's rows a thread: a thread walks kK21Rows rows of one lane, each from
// its own counter. Eight ran 3-5% faster than four at 64 x 1,048,576 on an
// H100 and alike at 64 x 65,536; one and two 13-29% slower at 1,048,576
// (tools/k9_k21_sweep.py times 1, 2 and 4 by a text change of this line).
constexpr int kK21Rows = 8;
__host__ __device__ constexpr int k21_groups(int rows) { return (rows + kK21Rows - 1) / kK21Rows; }

// K21 on a 2-D grid: x over the lanes, y over the groups of kK21Rows rows
// (a block strides over the groups past the grid's 65,535), so a warp's
// stores are consecutive lanes of one row and no thread divides a 64-bit
// index. Element (row, lane) is normal01 of words 0 and 1 of counter (lane,
// 0, row, 0) under key (seed, 1), as the first design had it. The row loop
// stays rolled, one copy of normal01 in it, and each pass forms this row's
// normal while it computes the next row's Philox block, so two independent
// chains are in flight. With the loop unrolled (a copy of normal01 a row)
// ptxas put cosf's Payne-Hanek reduction (never run: the argument stays
// below 2 pi) in a 32-byte frame with LDL/STL; with one copy it keeps it in
// registers, and the rolled loop ran 1-6% faster at 64 x 1,048,576.
__global__ void k_sample_normals(float* __restrict__ out, unsigned seed, long long B,
                                 int rows) {
  const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int groups = k21_groups(rows);
  for (int g = blockIdx.y; g < groups; g += gridDim.y) {
    const int r0 = g * kK21Rows, r1 = min(r0 + kK21Rows, rows);
    WordStream ws(seed, 1u, (unsigned)lane, 0u, (unsigned)r0);
    unsigned w0 = ws.next(), w1 = ws.next();
#pragma unroll 1
    for (int row = r0; row < r1; ++row) {
      unsigned n0 = 0u, n1 = 0u;
      if (row + 1 < r1) {
        WordStream nx(seed, 1u, (unsigned)lane, 0u, (unsigned)(row + 1));
        n0 = nx.next();
        n1 = nx.next();
      }
      out[row * B + lane] = normal01(w0, w1);  // (rows, B)
      w0 = n0;
      w1 = n1;
    }
  }
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

// K28 over a thread-block cluster (cluster_mlp.cuh). CTA r of a cluster
// steps lanes r lanes_cta .. of each tile, one thread each (the econ and
// the pipeline's head in registers, the pipeline in the lane's row of
// shared memory); the rest runs on every thread. At each tile's reset the
// lane threads draw the econ and set up the Poisson anchor; then every
// thread counts the lanes' demand, a (lane, chunk of NV_CHUNK periods) at
// a time with chunk_demand (K18's words, the linear count), and draws the
// head noise of each (lane, period), into shared memory. Per period, the
// obs of the CTA's lanes into every CTA's xo, the cluster's actor, then
// the lane threads' head and step.
template <bool RELU>
__global__ void __launch_bounds__(kClusterThreads, 1)
    k_nv_rollout_traj_cluster(const __grid_constant__ NvParams p,
                              const __grid_constant__ ClusterMlp m, const float* __restrict__ w,
                              const float* __restrict__ lgam, float* __restrict__ econo,
                              float* __restrict__ ordo, float* __restrict__ rawo,
                              float* __restrict__ rewo, float* __restrict__ demo, unsigned seed,
                              long long B, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), n = threadIdx.x, Lc = m.lanes_cta, A = m.act;
  const bool actor = m.head != kHeadUniform, lane = n < Lc;
  if (actor) cluster_load_weights(m, w, rank, smem);
  const long long tiles = (B + m.lanes - 1) / m.lanes;
  const int chunks = (T + NV_CHUNK - 1) / NV_CHUNK, L = p.L, n_obs = 5 + L;
  float* dem = smem + m.s_dem;      // [lane][T]
  float* zs = smem + m.s_z;         // [lane][T][act]
  float* qs = smem + m.s_q;         // [lane][4]: the anchors
  float* state = smem + m.s_state;  // [lane][econ 5, pipeline L, its head]
  float* mine = state + n * m.state_words;  // a lane thread's
  const NvSharedRing ring{mine + 5, 1};
  NvEcon c;
  int head = 0;
  for (long long tile = blockIdx.x / m.cluster; tile < tiles; tile += gridDim.x / m.cluster) {
    const long long lane0 = tile * m.lanes + rank * Lc, b = lane0 + n;
    const bool live = lane && b < B;
    if (lane) {
      WordStream ws(seed, 1u, (unsigned)b, 0u, NV_ECON_PERIOD);
      float u[5];
      for (int r = 0; r < 5; ++r) u[r] = u01(ws.next());
      c = nv_econ(p, u);
      if (live) {
        econo[b] = c.price;
        econo[B + b] = c.cost;
        econo[2 * B + b] = c.h;
        econo[3 * B + b] = c.k;
        econo[4 * B + b] = c.mu;
      }
      const float e[5] = {c.price, c.cost, c.h, c.k, c.mu};
      for (int r = 0; r < 5; ++r) mine[r] = e[r];
      for (int j = 0; j < L; ++j) ring(j) = 0.f;
      head = 0;
      mine[5 + L] = __int_as_float(head);
      const NvPoisson q = nv_poisson_setup(p, lgam, c.mu);
      qs[4 * n] = q.mu;
      qs[4 * n + 1] = q.kc;
      qs[4 * n + 2] = q.p_c;
      qs[4 * n + 3] = q.total;
    }
    __syncthreads();  // the anchors are in
    for (int i = n; i < Lc * chunks; i += kClusterThreads) {
      const int l = i % Lc, t0 = (i / Lc) * NV_CHUNK;
      const NvPoisson q{qs[4 * l], qs[4 * l + 1], qs[4 * l + 2], qs[4 * l + 3]};
      float d[NV_CHUNK];
      chunk_demand(p, q, seed, (unsigned)(lane0 + l), 0u, t0, T, d);
#pragma unroll
      for (int j = 0; j < NV_CHUNK; ++j)
        if (t0 + j < T) dem[l * T + t0 + j] = d[j];
    }
    for (int i = n; i < Lc * T; i += kClusterThreads) {  // the head noise, a (lane, period) each
      const int l = i / T, t = i - l * T;
      WordStream ws(seed, 1u, (unsigned)(lane0 + l), 0u, (unsigned)t);
      ws.next();  // word 0: the period's demand
      offpolicy_noise(m.head, A, ws, zs + (long long)i * A);
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      if (actor) {  // the obs of period t: econ, the pipeline oldest first, zero rows to kin[0]
        for (int i = n; i < m.kin[0] * Lc; i += kClusterThreads) {
          const int k = i / Lc, l = i - k * Lc;
          const float* st = state + l * m.state_words;
          float v = 0.f;
          if (k < 5) {
            v = st[k];
          } else if (k < n_obs) {
            int j = __float_as_int(st[5 + L]) + k - 5;
            if (j >= L) j -= L;
            v = st[5 + j];
          }
          cluster_put(cl, m, smem + m.s_xo, k * m.stride + rank * Lc + l, v);
        }
      }
      const float* H = actor ? cluster_forward<RELU>(cl, m, smem, rank) : nullptr;
      if (lane) {
        float st, qty;
        const float a = cluster_head(m, smem, H, n, 0, zs[((long long)n * T + t) * A], st);
        const float order = __fmul_rn(__fadd_rn(a, 1.f), m.half_hi[0]);
        const float dt = dem[n * T + t];
        const float reward = nv_step_ring(p, ring, head, c, order, dt, qty);
        mine[5 + L] = __int_as_float(head);
        if (live) {
          const long long k = (long long)t * B + b;  // (T, B) and (T, 1, B)
          ordo[k] = qty;
          rawo[k] = st;
          rewo[k] = reward;
          demo[k] = dt;
        }
      }
      if (actor) __syncthreads();  // the lanes' state, for the next obs
    }
    __syncthreads();  // the last period's draws are read
  }
  if (actor) cl.sync();  // no CTA leaves while a peer may still write its memory
}

using NvClusterKernel = decltype(&k_nv_rollout_traj_cluster<true>);

NvClusterKernel nv_cluster_kernel(int relu) {
  return relu ? k_nv_rollout_traj_cluster<true> : k_nv_rollout_traj_cluster<false>;
}

template <bool STOCH, bool DUMP, bool TRAJ, int LAYOUT>
int launch_layout(const NvParams& p, const MlpTile& m, const NvTile& nt, const float* w,
                  const float* lgam, const float* disc, float* out, float* econ, float* acts,
                  float* dems, const NvTrajStreams& tr, unsigned seed, long long B, int E, int T,
                  cudaStream_t stream) {
  return launch_mlp_tile(k_nv_policy_returns<STOCH, DUMP, TRAJ, LAYOUT>, m, B * E, stream, p, m,
                         nt, w, lgam, disc, out, econ, acts, dems, tr, seed, B, E, T);
}

// The entry points' layouts: NV_DEM_UPFRONT, or the linear count where no
// table fits a block (_nv_tile_plan).
template <bool STOCH, bool DUMP, bool TRAJ>
int launch_policy_returns(const NvParams& p, const MlpTile& m, const NvTile& nt,
                          const float* w, const float* lgam, const float* disc, float* out,
                          float* econ, float* acts, float* dems, const NvTrajStreams& tr,
                          unsigned seed, long long B, int E, int T, cudaStream_t stream) {
  if (nt.layout == NV_DEM_UPFRONT)
    return launch_layout<STOCH, DUMP, TRAJ, NV_DEM_UPFRONT>(p, m, nt, w, lgam, disc, out, econ,
                                                            acts, dems, tr, seed, B, E, T,
                                                            stream);
  if (nt.layout == NV_DEM_LINEAR)
    return launch_layout<STOCH, DUMP, TRAJ, NV_DEM_LINEAR>(p, m, nt, w, lgam, disc, out, econ,
                                                           acts, dems, tr, seed, B, E, T, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K18: one stochastic episode a lane on K19's tile, its streams written.
int nv_rollout_traj(const NvParams* p, const MlpTile* m, const NvTile* nt, const float* w,
                    const float* lgam, float* econ, float* orders, float* raw, float* rew,
                    float* dem, unsigned seed, long long B, int T, cudaStream_t stream) {
  return launch_policy_returns<true, false, true>(*p, *m, *nt, w, lgam, nullptr, nullptr, econ,
                                                  nullptr, dem, NvTrajStreams{orders, raw, rew},
                                                  seed, B, 1, T, stream);
}

// acts == nullptr: returns only (K19); otherwise also econ, acts and dems (K20).
int nv_policy_returns(const NvParams* p, const MlpTile* m, const NvTile* nt, const float* w,
                      const float* lgam, const float* disc, float* out, float* econ,
                      float* acts, float* dems, unsigned seed, int stochastic, long long B,
                      int E, int T, cudaStream_t stream) {
  const bool dump = acts != nullptr;
  const NvTrajStreams none{};
  if (stochastic)
    return dump ? launch_policy_returns<true, true, false>(*p, *m, *nt, w, lgam, disc, out, econ,
                                                           acts, dems, none, seed, B, E, T,
                                                           stream)
                : launch_policy_returns<true, false, false>(*p, *m, *nt, w, lgam, disc, out,
                                                            econ, acts, dems, none, seed, B, E,
                                                            T, stream);
  return dump ? launch_policy_returns<false, true, false>(*p, *m, *nt, w, lgam, disc, out, econ,
                                                          acts, dems, none, seed, B, E, T,
                                                          stream)
              : launch_policy_returns<false, false, false>(*p, *m, *nt, w, lgam, disc, out, econ,
                                                           acts, dems, none, seed, B, E, T,
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

// K28 on the cluster (cluster_mlp.cuh): m->clusters clusters of
// m->cluster CTAs.
int nv_rollout_traj_cluster(const NvParams* p, const ClusterMlp* m, const float* w,
                            const float* lgam, float* econ, float* orders, float* raw,
                            float* rew, float* dem, unsigned seed, int relu, long long B, int T,
                            cudaStream_t stream) {
  return launch_cluster(nv_cluster_kernel(relu), *m, stream, *p, *m, w, lgam, econ,
                        orders, raw, rew, dem, seed, B, T);
}

// The clusters of K28's instance that the card holds at once, into *out.
int nv_rollout_traj_cluster_occupancy(const ClusterMlp* m, int relu, int* out) {
  return max_active_clusters(nv_cluster_kernel(relu), *m, out);
}

int sample_normals(float* out, unsigned seed, long long B, int rows, cudaStream_t stream) {
  if (rows < 1) return (int)cudaSuccess;  // nothing to write
  const int groups = k21_groups(rows);
  const dim3 grid(blocks_for(B), groups < 65535 ? groups : 65535);
  k_sample_normals<<<grid, kThreads, 0, stream>>>(out, seed, B, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
