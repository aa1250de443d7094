// InvManagement kernels under a folded MLP actor, for Hopper (sm_90a), bound
// with ctypes by ops/_build.py and wrapped by ops/episode_kernels.py, whose
// plain PyTorch versions compute the same functions.
//
// K10 k_im_policy_returns<1, 0, 1, BACKLOG>  replaces
//    pallas_episode_kernels.rollout_traj_im (:1683; body _im_traj_kernel
//    :1641, obs _im_obs_rows :1108, policy head traj_policy "ppo" :1036,
//    trunk mlp_forward :1124). One stochastic-policy episode per lane, the
//    training streams written to device memory: start-of-period on-hand inv
//    (T+1 snapshots), int actions, pre-squash raws, alpha^t rewards and
//    demand, each (T[+1], rows, B) and coalesced along B. PPO with
//    rollout="kernel" feeds on it.
// K11/K12 k_im_policy_returns<STOCH, DUMP, 0, BACKLOG>  replace
//    _im_policy_call (:1218) behind episode_returns_im_policy (:1264) and
//    its stream-dumping twin sample_policy_streams_debug_im (:1287; body
//    _im_policy_kernel :1170, actions _policy_actions :1149): the same
//    policy, deterministic or stochastic, E episodes per lane, returns
//    (E, B); with DUMP it also writes the int actions (T, E, m1, B) and the
//    demand (T, E, B) it used.
// K27 k_im_rollout_traj_wide  replaces rollout_traj_im (:1683) under the
//    off-policy heads traj_policy "det", "sac" and "uniform" (:1062-1080) on
//    a relu (or tanh) trunk, the collection of OffPolicyConfig(collect=
//    "kernel"): K10's streams, the raw stream holding the normalised [-1, 1]
//    actions. k_im_rollout_traj_cluster runs the SB3 default (256, 256)
//    actor over a thread-block cluster, each CTA holding a slice of it in
//    shared memory (cluster_mlp.cuh); k_im_rollout_traj_wide, the first
//    design, is the wide route for an actor whose slice fits no CTA (a
//    block per 32 lanes, the actor streamed from L2, wide_mlp.cuh; threads
//    0..31 own the lanes' envs, as in K24). Bound by operations: the
//    (256, 256) actor's ~1.5e5 per env-step.
//
// K10-K12's design: a block per tile of (episode, lane) pairs, one thread
// each (mlp_tile.cuh); K10 is the one-episode, stochastic instance with its
// streams written (TRAJ), so it cannot drift from K11. The first versions
// ran one thread per pair with the actor on the FP32 cores (mlp.cuh): K11
// 45.50 ms at 65,536 x 16 x 30, K10 2.5333 ms at 65,536 x 30 on an H100
// (PERF.md), the MLP at ~9 TFLOP/s. Now, per period, each thread writes its
// obs column; its warp runs the actor for its 32 pairs on the tensor cores
// in 3xTF32; then the thread draws its pair's demand (a register) and, when
// stochastic, its normals (the transient rows of its column), takes its
// actions and steps. The InvManagement step stays on a per-thread frame
// (ImEpisode and the ring of requested orders, local memory). K10 writes the
// on-hand at each period's start and after the last, the raws before the
// squash, the actions, the demand and the alpha^t reward. Bound by
// operations: the products, 2 sum(in out) FLOPs an env-step, as three TF32
// products each. The batch tail is masked: a warp past it returns, a pair
// past it computes (its warp's products need every thread) but writes
// nothing.
//
// K10-K12 and K27's wide route are built for both actor classes
// (mlp_tile.cuh MlpTile and MlpTileG, wide_mlp.cuh WideMlp and WideMlpG,
// the general class through the C entry points named *_any): an actor past
// the fixed arrays, or whose activations fit no block, takes the general
// class, its activations in shared memory or in a device workspace.
//
// Each kernel is also built for the params' two routes (im_step.cuh): the
// fixed ImParams, whose lanes step on the ImEpisode frame as above, and the
// chain route's ImParamsG (past IM_MAX_M1 stages or IM_MAX_LT periods of
// lead time; the C entry points named *_chain, on the general actor class
// MlpTileG or WideMlpG, and on the cluster), whose lanes step on their
// column (im_lane: the state, the ring of requested orders, the actions
// and, on the wide route, the head noise) in shared memory: the tile's
// state region ([word][lane]), the cluster's ([lane][word]), and on the
// wide route a region after the activations ([word][lane]); the block
// stages the params' records after it. On the wide route the chain's layer
// sums run in FP64 (wide_mlp.cuh wide_layer): with obs of hundreds of inputs
// an FP32 sum's error, through the sac head's exp, reached the teacher-forced
// tolerance (1e-4) at IM-chain12-lt40's 492 inputs. The fixed route's
// instances are the parent's code.
//
// Random stream (philox.cuh): key (seed, 1), counter (lane, episode, period,
// block); per period one demand word, then, when stochastic, the m1 u1 and
// the m1 u2 words of the Box-Muller normals (pallas_episode_kernels.py
// :1657-1658, :69-70). K10 is episode 0, so episode 0 of the stochastic K11
// draws exactly K10's words for the same seed and, on the same tile, takes
// K10's actions bit for bit. K27 draws the demand word, then the head's m1
// u1 and m1 u2 words (the m1 u1 words alone for "uniform"), so its demand is
// K10's for the same seed.
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

#include "cluster_mlp.cuh"
#include "im_step.cuh"
#include "launch.cuh"
#include "mlp_tile.cuh"
#include "philox.cuh"
#include "wide_mlp.cuh"

namespace {

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

// A lane's state on the fixed route: the frame, as the parent kept it.
struct ImFrameLane {
  ImEpisode s;
  int ah[IM_MAX_LT * IM_MAX_M1];  // requested order of period q: slot q % lt
  int act[IM_MAX_M1];
};

// The lane state of route P (ImFrameLane, or the chain's column ImLane),
// and its period step with the requested orders pushed into its ring.
template <class P>
using ImLaneOf = typename std::conditional<im_chain<P>(), ImLane, ImFrameLane>::type;

template <bool BACKLOG>
__device__ __forceinline__ float lane_step(const ImParams& p, ImFrameLane& l, int t, int d) {
  return step_and_record<BACKLOG>(p, l.s, t, l.act, d, l.ah);
}
template <bool BACKLOG>
__device__ __forceinline__ float lane_step(const ImView& p, ImLane& l, int t, int d) {
  return im_step_any<BACKLOG>(p, l.s, t, l.act, d, l.ah + l.s.slot * p.m1);
}

// Point a chain lane at its column (a frame lane needs nothing).
__device__ __forceinline__ void lane_init(ImFrameLane&, const ImParams&, ImColumn) {}
__device__ __forceinline__ void lane_init(ImLane& l, const ImView& p, ImColumn col) {
  l = im_lane(col, p.m1, p.lt, true);
}

// The streams K10 writes (TRAJ) beside the actions and demand (DUMP's acto
// and demo), each (T[+1], m1, B): the on-hand at each period's start and
// after the last, the pre-squash raws, the alpha^t rewards.
struct ImTrajStreams {
  int* inv;
  float *raw, *rew;
};

// Tile is the actor's class (mlp_tile.cuh): MlpTile launches a block a
// tile, MlpTileG a grid of m.grid blocks walking tiles blockIdx.x + k grid,
// its activations from tile_acts. PP is the params' route: ImParams, or
// ImParamsG with the lanes' columns in the state region and the records
// after it.
template <bool STOCH, bool DUMP, bool TRAJ, bool BACKLOG, class Tile, class PP>
__global__ void k_im_policy_returns(const __grid_constant__ PP pp,
                                    const __grid_constant__ Tile m,
                                    const float* __restrict__ w,
                                    const float* __restrict__ table,
                                    const int* __restrict__ user_d,
                                    const float* __restrict__ disc,
                                    float* __restrict__ out, int* __restrict__ acto,
                                    int* __restrict__ demo,
                                    const __grid_constant__ ImTrajStreams tr, unsigned seed,
                                    long long B, int E, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* act0 = tile_acts(m, smem);
  int* const cols = reinterpret_cast<int*>(smem + m.s_state);  // the chain's [word][lane]
  const auto& p = im_params(pp, cols + im_state_words(pp) * m.lanes);
  const int n = threadIdx.x, S = m.stride;
  const int m1 = p.m1, obs_pad = (tile_obs_dim(m, w) + 7) & ~7;
  for (long long tile = blockIdx.x; tile * m.lanes < B * E; tile += tile_grid(m)) {
    const long long pair0 = tile * m.lanes, idx = pair0 + n;
    if (pair0 + (n & ~31) >= B * E) break;  // the warp's pairs all lie past the batch
    const bool live = idx < B * E;
    const unsigned e = (unsigned)(idx / B);
    const unsigned lane = (unsigned)(idx - (long long)e * B);
    float* x = act0 + m.s_x0 + n;
    float* z = act0 + m.s_z + n;
    ImLaneOf<PP> l;
    lane_init(l, p, {cols + n, m.lanes});
    im_reset(p, l.s);
    float total = 0.f;
    for (int t = 0; t < T; ++t) {
      if (TRAJ && live)  // the start-of-period on-hand
        for (int i = 0; i < m1; ++i) tr.inv[((long long)t * m1 + i) * B + lane] = l.s.inv[i];
      lane_obs(p, l.s, t, l.ah, x, S);  // the obs rows, then zero rows up to pad8
      for (int k = m1 * (p.lt + 1); k < obs_pad; ++k) x[k * S] = 0.f;
      __syncwarp();
      const float* H = mlp_tile_forward(m, w, act0) + n;
      WordStream ws(seed, 1u, lane, e, (unsigned)t);  // the obs does not depend on the draws
      const int d = im_demand(p, table, user_d, t, ws.next());
      if (STOCH) {  // the normals into the transient rows
        unsigned* u1 = reinterpret_cast<unsigned*>(z);
        for (int i = 0; i < m1; ++i) u1[i * S] = ws.next();
        for (int i = 0; i < m1; ++i) z[i * S] = normal01(u1[i * S], ws.next());
      }
      const long long row = (long long)t * E + e;  // (T, E, m1, B) and (T, E, B)
      for (int i = 0; i < m1; ++i) {
        float v = H[i * S];
        if (STOCH) v = __fadd_rn(v, __fmul_rn(__ldg(w + m.std + i), z[i * S]));
        if (TRAJ && live) tr.raw[(row * m1 + i) * B + lane] = v;
        l.act[i] = (int)__fmul_rn(__fadd_rn(tanhf(v), 1.f), tile_half_hi(m, w, i));
        if ((DUMP || TRAJ) && live) acto[(row * m1 + i) * B + lane] = l.act[i];
      }
      if ((DUMP || TRAJ) && live) demo[row * B + lane] = d;
      const float profit = lane_step<BACKLOG>(p, l, t, d);
      const float reward = __fmul_rn(__ldg(disc + t), profit);
      if (TRAJ) {
        if (live) tr.rew[row * B + lane] = reward;
      } else {
        total = __fadd_rn(total, reward);
      }
    }
    if (TRAJ && live)  // the final on-hand, the bootstrap obs
      for (int i = 0; i < m1; ++i) tr.inv[((long long)T * m1 + i) * B + lane] = l.s.inv[i];
    if (!TRAJ && live) out[idx] = total;  // (E, B), episode-major
    if (!tile_walks(m)) break;  // MlpTile: one tile a block
  }
}

template <bool STOCH, bool DUMP, bool TRAJ, bool BACKLOG, class Tile, class PP>
int launch_policy_kernel(const PP& p, const Tile& m, const float* w, const float* table,
                         const int* user_d, const float* disc, float* out, int* acts, int* dems,
                         const ImTrajStreams& tr, unsigned seed, long long B, int E, int T,
                         cudaStream_t stream) {
  return launch_mlp_tile(k_im_policy_returns<STOCH, DUMP, TRAJ, BACKLOG, Tile, PP>, m, B * E,
                         stream,
                         p, m, w, table, user_d, disc, out, acts, dems, tr, seed, B, E, T);
}

template <bool STOCH, bool DUMP, class Tile, class PP>
int launch_policy_returns(const PP& p, const Tile& m, const float* w, const float* table,
                          const int* user_d, const float* disc, float* out, int* acts, int* dems,
                          unsigned seed, int backlog, long long B, int E, int T,
                          cudaStream_t stream) {
  const ImTrajStreams none{};
  return backlog ? launch_policy_kernel<STOCH, DUMP, false, true>(
                       p, m, w, table, user_d, disc, out, acts, dems, none, seed, B, E, T, stream)
                 : launch_policy_kernel<STOCH, DUMP, false, false>(
                       p, m, w, table, user_d, disc, out, acts, dems, none, seed, B, E, T, stream);
}

// The lane's observation into column n of x ([row][kWideLanes]), in the
// order of lane_obs's.
template <class P, class St, class A>
__device__ __forceinline__ void wide_obs(const P& p, const St& s, int t, const A& ah, float* x,
                                         int n) {
  const int m1 = p.m1, lt = p.lt;
  for (int i = 0; i < m1; ++i) x[i * kWideLanes + n] = (float)s.inv[i];
  const int q0 = max(t - lt, 0);
  for (int j = 0; j < lt; ++j) {
    const int q = q0 + j;
    for (int i = 0; i < m1; ++i)
      x[(m1 + j * m1 + i) * kWideLanes + n] = q < t ? (float)ah[(q % lt) * m1 + i] : 0.f;
  }
}

static_assert(IM_MAX_M1 <= WIDE_MAX_ACT, "K27's head noise is a thread's array of actions");

// Where a lane's head noise lies: the fixed route's thread array, or the
// chain lane's extra words (a row a noise, kWideLanes floats apart).
__device__ __forceinline__ float* lane_noise(ImFrameLane&, float* z) { return z; }
__device__ __forceinline__ float* lane_noise(ImLane& l, float*) {
  return reinterpret_cast<float*>(l.extra.p);
}

// Wide is the actor's class (wide_mlp.cuh): WideMlp launches a block per
// 32 lanes, WideMlpG a grid of m.grid blocks walking blocks of lanes
// blockIdx.x + k grid, its activations in shared memory or the workspace.
template <bool RELU, bool BACKLOG, class Wide, class PP>
__global__ void __launch_bounds__(kWideThreads)
    k_im_rollout_traj_wide(const __grid_constant__ PP pp,
                           const __grid_constant__ Wide m, const float* __restrict__ w,
                           const float* __restrict__ table, const int* __restrict__ user_d,
                           const float* __restrict__ disc, int* __restrict__ invo,
                           int* __restrict__ acto, float* __restrict__ rawo,
                           float* __restrict__ rewo, int* __restrict__ demo, unsigned seed,
                           long long B, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* x0 = wide_x0(m, smem);
  float* x1 = wide_x1(m, x0);
  // the chain's lane columns ([word][kWideLanes]) after the activations, then the records
  int* const cols = reinterpret_cast<int*>(smem + wide_smem_acts(m));
  const auto& p = im_params(pp, cols + im_state_words(pp) * kWideLanes);
  constexpr int zs = im_chain<PP>() ? kWideLanes : 1;  // floats between two noises
  // the chain route's sums in FP64 (its obs run to hundreds of inputs)
  using WideAcc = typename std::conditional<im_chain<PP>(), double, float>::type;
  const int n = threadIdx.x;
  const bool lane = n < kWideLanes;
  const bool actor = m.head != kHeadUniform;
  const int m1 = p.m1;
  for (long long blk = blockIdx.x; blk * kWideLanes < B; blk += wide_grid(m)) {
    const long long b = blk * kWideLanes + n;
    const bool live = lane && b < B;
    ImLaneOf<PP> l;
    lane_init(l, p, {cols + n, kWideLanes});
    int d = 0;
    float zf[im_chain<PP>() ? 1 : WIDE_MAX_ACT];
    float* const z = lane_noise(l, zf);
    if (lane) im_reset(p, l.s);
    for (int t = 0; t < T; ++t) {
      if (lane) {
        if (live)
          for (int i = 0; i < m1; ++i) invo[((long long)t * m1 + i) * B + b] = l.s.inv[i];
        WordStream ws(seed, 1u, (unsigned)b, 0u, (unsigned)t);
        d = im_demand(p, table, user_d, t, ws.next());
        if constexpr (im_chain<PP>())
          offpolicy_noise_rows(m.head, m.act, ws, z, zs);
        else
          wide_noise(m, ws, z);
        if (actor) wide_obs(p, l.s, t, l.ah, x0, n);
      }
      const float* H = actor ? wide_forward<RELU, Wide, WideAcc>(m, w, x0, x1) : x0;
      if (lane) {
        for (int i = 0; i < m1; ++i) {
          float st;
          const float a = wide_head(m, w, H, n, i, z[i * zs], st);
          l.act[i] = (int)__fmul_rn(__fadd_rn(a, 1.f), wide_half_hi(m, w, i));
          if (live) {
            const long long k = ((long long)t * m1 + i) * B + b;
            rawo[k] = st;
            acto[k] = l.act[i];
          }
        }
        const float profit = lane_step<BACKLOG>(p, l, t, d);
        if (live) {
          rewo[(long long)t * B + b] = __fmul_rn(__ldg(disc + t), profit);
          demo[(long long)t * B + b] = d;
        }
      }
    }
    if (live)
      for (int i = 0; i < m1; ++i) invo[((long long)T * m1 + i) * B + b] = l.s.inv[i];
  }
}

// The cluster's lane step: the fixed route pushes the requested orders into
// the ring in shared memory at ``ah`` and copies on-hand beside it
// (cluster_publish), where the obs reads them; the chain's column is that
// memory already.
template <bool BACKLOG>
__device__ __forceinline__ float cluster_step(const ImParams& p, ImFrameLane& l, int t, int d,
                                              int* ah) {
  return step_and_record<BACKLOG>(p, l.s, t, l.act, d, ah);
}
template <bool BACKLOG>
__device__ __forceinline__ float cluster_step(const ImView& p, ImLane& l, int t, int d, int*) {
  return lane_step<BACKLOG>(p, l, t, d);
}
__device__ __forceinline__ void cluster_publish(const ImParams& p, ImFrameLane& l, int* mine) {
  for (int i = 0; i < p.m1; ++i) mine[i] = l.s.inv[i];
}
__device__ __forceinline__ void cluster_publish(const ImView&, ImLane&, int*) {}

// K27 over a thread-block cluster (cluster_mlp.cuh). CTA r of a cluster
// steps lanes r lanes_cta .. of each tile, one thread each (the ImEpisode
// frame in local memory, as K10); the rest runs on every thread: at each
// tile's reset, every (lane, period)'s demand and head noise from the
// period's words (the demand word, then the head's) into shared memory;
// per period, the obs of the CTA's lanes, read from their on-hand and
// ring of requested orders in shared memory, into every CTA's xo, then
// the cluster's actor; then the lane threads' head and step.
template <bool RELU, bool BACKLOG, class PP>
__global__ void __launch_bounds__(kClusterThreads, 1)
    k_im_rollout_traj_cluster(const __grid_constant__ PP pp,
                              const __grid_constant__ ClusterMlp m, const float* __restrict__ w,
                              const float* __restrict__ table, const int* __restrict__ user_d,
                              const float* __restrict__ disc, int* __restrict__ invo,
                              int* __restrict__ acto, float* __restrict__ rawo,
                              float* __restrict__ rewo, int* __restrict__ demo, unsigned seed,
                              long long B, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), n = threadIdx.x, Lc = m.lanes_cta, A = m.act;
  const bool actor = m.head != kHeadUniform, lane = n < Lc;
  if (actor) cluster_load_weights(m, w, rank, smem);
  int* state = reinterpret_cast<int*>(smem + m.s_state);  // [lane][on-hand m1, ring lt m1, ...]
  // the chain's records after the state region (its words padded to 4)
  const auto& p = im_params(pp, state + ((Lc * m.state_words + 3) & ~3));
  const int m1 = p.m1, lt = p.lt, n_obs = m1 * (lt + 1);
  const long long tiles = (B + m.lanes - 1) / m.lanes;
  int* dem = reinterpret_cast<int*>(smem + m.s_dem);       // [lane][T]
  float* zs = smem + m.s_z;                                // [lane][T][act]
  int* mine = state + n * m.state_words;                   // a lane thread's
  ImLaneOf<PP> ln;  // the chain's column is ``mine``, a word apart
  lane_init(ln, p, {mine, 1});
  for (long long tile = blockIdx.x / m.cluster; tile < tiles; tile += gridDim.x / m.cluster) {
    const long long lane0 = tile * m.lanes + rank * Lc, b = lane0 + n;
    const bool live = lane && b < B;
    if (lane) {
      im_reset(p, ln.s);
      cluster_publish(p, ln, mine);
    }
    for (int i = n; i < Lc * T; i += kClusterThreads) {  // the draws, a (lane, period) each
      const int l = i / T, t = i - l * T;
      WordStream ws(seed, 1u, (unsigned)(lane0 + l), 0u, (unsigned)t);
      dem[i] = im_demand(p, table, user_d, t, ws.next());
      offpolicy_noise(m.head, A, ws, zs + (long long)i * A);
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      if (actor) {  // the obs of period t, in lane_obs's order, zero rows to kin[0]
        const int q0 = max(t - lt, 0);
        for (int i = n; i < m.kin[0] * Lc; i += kClusterThreads) {
          const int k = i / Lc, l = i - k * Lc;
          const int* st = state + l * m.state_words;
          int v = 0;
          if (k < m1) {
            v = st[k];
          } else if (k < n_obs) {
            const int j = (k - m1) / m1, q = q0 + j;
            if (q < t) v = st[m1 + (q % lt) * m1 + (k - m1 - j * m1)];
          }
          cluster_put(cl, m, smem + m.s_xo, k * m.stride + rank * Lc + l, (float)v);
        }
      }
      const float* H = actor ? cluster_forward<RELU>(cl, m, smem, rank) : nullptr;
      if (lane) {
        if (live)
          for (int i = 0; i < m1; ++i) invo[((long long)t * m1 + i) * B + b] = ln.s.inv[i];
        const int d = dem[n * T + t];
        const float* z = zs + ((long long)n * T + t) * A;
        for (int i = 0; i < m1; ++i) {
          float st;
          const float a = cluster_head(m, smem, H, n, i, z[i], st);
          ln.act[i] = (int)__fmul_rn(__fadd_rn(a, 1.f), m.half_hi[i]);
          if (live) {
            const long long k = ((long long)t * m1 + i) * B + b;
            rawo[k] = st;
            acto[k] = ln.act[i];
          }
        }
        const float profit = cluster_step<BACKLOG>(p, ln, t, d, mine + m1);
        cluster_publish(p, ln, mine);
        if (live) {
          rewo[(long long)t * B + b] = __fmul_rn(__ldg(disc + t), profit);
          demo[(long long)t * B + b] = d;
        }
      }
      if (actor) __syncthreads();  // the lanes' state, for the next obs
    }
    if (live)
      for (int i = 0; i < m1; ++i) invo[((long long)T * m1 + i) * B + b] = ln.s.inv[i];
    __syncthreads();  // the last period's draws are read
  }
  if (actor) cl.sync();  // no CTA leaves while a peer may still write its memory
}

template <class PP>
using ImClusterKernel = decltype(&k_im_rollout_traj_cluster<true, true, PP>);

template <class PP = ImParams>
ImClusterKernel<PP> im_cluster_kernel(int relu, int backlog) {
  if (relu)
    return backlog ? k_im_rollout_traj_cluster<true, true, PP>
                   : k_im_rollout_traj_cluster<true, false, PP>;
  return backlog ? k_im_rollout_traj_cluster<false, true, PP>
                 : k_im_rollout_traj_cluster<false, false, PP>;
}

// K10 for either actor class and either route.
template <class Tile, class PP>
int rollout_traj(const PP* p, const Tile* m, const float* w, const float* table,
                 const int* user_d, const float* disc, int* inv, int* acts, float* raw,
                 float* rew, int* dem, unsigned seed, int backlog, long long B, int T,
                 cudaStream_t stream) {
  const ImTrajStreams tr{inv, raw, rew};
  return backlog ? launch_policy_kernel<true, false, true, true>(
                       *p, *m, w, table, user_d, disc, nullptr, acts, dem, tr, seed, B, 1, T,
                       stream)
                 : launch_policy_kernel<true, false, true, false>(
                       *p, *m, w, table, user_d, disc, nullptr, acts, dem, tr, seed, B, 1, T,
                       stream);
}

// K11/K12 for either actor class and either route.
template <class Tile, class PP>
int policy_returns(const PP* p, const Tile* m, const float* w, const float* table,
                   const int* user_d, const float* disc, float* out, int* acts, int* dems,
                   unsigned seed, int stochastic, int backlog, long long B, int E, int T,
                   cudaStream_t stream) {
  const bool dump = acts != nullptr;
  if (stochastic)
    return dump ? launch_policy_returns<true, true>(*p, *m, w, table, user_d, disc, out, acts,
                                                    dems, seed, backlog, B, E, T, stream)
                : launch_policy_returns<true, false>(*p, *m, w, table, user_d, disc, out, acts,
                                                     dems, seed, backlog, B, E, T, stream);
  return dump ? launch_policy_returns<false, true>(*p, *m, w, table, user_d, disc, out, acts,
                                                   dems, seed, backlog, B, E, T, stream)
              : launch_policy_returns<false, false>(*p, *m, w, table, user_d, disc, out, acts,
                                                    dems, seed, backlog, B, E, T, stream);
}

// K27's wide route for either actor class and either route (the chain's
// lane columns and records after the activations).
template <class Wide, class PP>
int rollout_traj_wide(const PP* p, const Wide* wm, const float* w, const float* table,
                      const int* user_d, const float* disc, int* inv, int* acts, float* raw,
                      float* rew, int* dem, unsigned seed, int relu, int backlog, long long B,
                      int T, cudaStream_t stream) {
  auto kernel = relu ? (backlog ? k_im_rollout_traj_wide<true, true, Wide, PP>
                                : k_im_rollout_traj_wide<true, false, Wide, PP>)
                     : (backlog ? k_im_rollout_traj_wide<false, true, Wide, PP>
                                : k_im_rollout_traj_wide<false, false, Wide, PP>);
  const size_t smem = wide_smem_bytes(*wm) + im_chain_bytes(*p, kWideLanes);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<wide_blocks(*wm, B), kWideThreads, smem, stream>>>(*p, *wm, w, table, user_d, disc,
                                                              inv, acts, raw, rew, dem, seed, B,
                                                              T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K10: one stochastic episode a lane on K11's tile, its streams written.
int im_rollout_traj(const ImParams* p, const MlpTile* m, const float* w, const float* table,
                    const int* user_d, const float* disc, int* inv, int* acts, float* raw,
                    float* rew, int* dem, unsigned seed, int backlog, long long B, int T,
                    cudaStream_t stream) {
  return rollout_traj(p, m, w, table, user_d, disc, inv, acts, raw, rew, dem, seed, backlog, B,
                      T, stream);
}

// K10 on the general actor class (MlpTileG).
int im_rollout_traj_any(const ImParams* p, const MlpTileG* m, const float* w,
                        const float* table, const int* user_d, const float* disc, int* inv,
                        int* acts, float* raw, float* rew, int* dem, unsigned seed, int backlog,
                        long long B, int T, cudaStream_t stream) {
  return rollout_traj(p, m, w, table, user_d, disc, inv, acts, raw, rew, dem, seed, backlog, B,
                      T, stream);
}

// acts == dems == nullptr: returns only (K11); otherwise also the streams (K12).
int im_policy_returns(const ImParams* p, const MlpTile* m, const float* w, const float* table,
                      const int* user_d, const float* disc, float* out, int* acts, int* dems,
                      unsigned seed, int stochastic, int backlog, long long B, int E, int T,
                      cudaStream_t stream) {
  return policy_returns(p, m, w, table, user_d, disc, out, acts, dems, seed, stochastic, backlog,
                        B, E, T, stream);
}

// K11/K12 on the general actor class (MlpTileG).
int im_policy_returns_any(const ImParams* p, const MlpTileG* m, const float* w,
                          const float* table, const int* user_d, const float* disc, float* out,
                          int* acts, int* dems, unsigned seed, int stochastic, int backlog,
                          long long B, int E, int T, cudaStream_t stream) {
  return policy_returns(p, m, w, table, user_d, disc, out, acts, dems, seed, stochastic, backlog,
                        B, E, T, stream);
}

int im_rollout_traj_wide(const ImParams* p, const WideMlp* wm, const float* w,
                         const float* table, const int* user_d, const float* disc, int* inv,
                         int* acts, float* raw, float* rew, int* dem, unsigned seed, int relu,
                         int backlog, long long B, int T, cudaStream_t stream) {
  return rollout_traj_wide(p, wm, w, table, user_d, disc, inv, acts, raw, rew, dem, seed, relu,
                           backlog, B, T, stream);
}

// K27's wide route on the general actor class (WideMlpG).
int im_rollout_traj_wide_any(const ImParams* p, const WideMlpG* wm, const float* w,
                             const float* table, const int* user_d, const float* disc,
                             int* inv, int* acts, float* raw, float* rew, int* dem,
                             unsigned seed, int relu, int backlog, long long B, int T,
                             cudaStream_t stream) {
  return rollout_traj_wide(p, wm, w, table, user_d, disc, inv, acts, raw, rew, dem, seed, relu,
                           backlog, B, T, stream);
}

// K27 on the cluster (cluster_mlp.cuh): m->clusters clusters of
// m->cluster CTAs.
int im_rollout_traj_cluster(const ImParams* p, const ClusterMlp* m, const float* w,
                            const float* table, const int* user_d, const float* disc, int* inv,
                            int* acts, float* raw, float* rew, int* dem, unsigned seed, int relu,
                            int backlog, long long B, int T, cudaStream_t stream) {
  return launch_cluster(im_cluster_kernel(relu, backlog), *m, stream, *p, *m, w, table,
                        user_d, disc, inv, acts, raw, rew, dem, seed, B, T);
}

// The clusters of K27's instance that the card holds at once, into *out.
int im_rollout_traj_cluster_occupancy(const ClusterMlp* m, int relu, int backlog, int* out) {
  return max_active_clusters(im_cluster_kernel(relu, backlog), *m, out);
}

// K10 on the chain route (past the struct maxima; the general actor class).
int im_rollout_traj_chain(const ImParamsG* p, const MlpTileG* m, const float* w,
                          const float* table, const int* user_d, const float* disc, int* inv,
                          int* acts, float* raw, float* rew, int* dem, unsigned seed,
                          int backlog, long long B, int T, cudaStream_t stream) {
  return rollout_traj(p, m, w, table, user_d, disc, inv, acts, raw, rew, dem, seed, backlog, B,
                      T, stream);
}

// K11/K12 on the chain route (the general actor class).
int im_policy_returns_chain(const ImParamsG* p, const MlpTileG* m, const float* w,
                            const float* table, const int* user_d, const float* disc,
                            float* out, int* acts, int* dems, unsigned seed, int stochastic,
                            int backlog, long long B, int E, int T, cudaStream_t stream) {
  return policy_returns(p, m, w, table, user_d, disc, out, acts, dems, seed, stochastic, backlog,
                        B, E, T, stream);
}

// K27's wide route on the chain route (the general actor class).
int im_rollout_traj_wide_chain(const ImParamsG* p, const WideMlpG* wm, const float* w,
                               const float* table, const int* user_d, const float* disc,
                               int* inv, int* acts, float* raw, float* rew, int* dem,
                               unsigned seed, int relu, int backlog, long long B, int T,
                               cudaStream_t stream) {
  return rollout_traj_wide(p, wm, w, table, user_d, disc, inv, acts, raw, rew, dem, seed, relu,
                           backlog, B, T, stream);
}

// K27 on the cluster, on the chain route.
int im_rollout_traj_cluster_chain(const ImParamsG* p, const ClusterMlp* m, const float* w,
                                  const float* table, const int* user_d, const float* disc,
                                  int* inv, int* acts, float* raw, float* rew, int* dem,
                                  unsigned seed, int relu, int backlog, long long B, int T,
                                  cudaStream_t stream) {
  return launch_cluster(im_cluster_kernel<ImParamsG>(relu, backlog), *m, stream, *p, *m, w,
                        table, user_d, disc, inv, acts, raw, rew, dem, seed, B, T);
}

// The clusters of K27's chain instance that the card holds at once, into *out.
int im_rollout_traj_cluster_occupancy_chain(const ClusterMlp* m, int relu, int backlog,
                                            int* out) {
  return max_active_clusters(im_cluster_kernel<ImParamsG>(relu, backlog), *m, out);
}

}  // extern "C"
