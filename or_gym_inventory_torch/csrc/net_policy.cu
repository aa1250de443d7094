// NetInvMgmt episode kernels under a folded MLP actor, for Hopper (sm_90a),
// bound with ctypes by ops/_build.py and wrapped by ops/net_step.py, whose
// plain PyTorch versions compute the same functions.
//
// K4 k_policy_returns<1, 0, 1>  replaces pallas_net_step.rollout_traj_net
//    (:683, body _net_traj_kernel :629, policy head
//    pallas_episode_kernels.traj_policy "ppo" :1036). One stochastic-policy
//    episode per lane, the training streams written to device memory:
//    start-of-period X and U (T+1 snapshots), fulfilled orders r,
//    pre-squash raws, alpha^t rewards and demand, each (T[+1], rows, B) and
//    coalesced along B.
// K5/K6 k_policy_returns<STOCH, DUMP, 0>  replace _net_policy_call (:554)
//    behind episode_returns_net_policy (:611) and its stream-dumping twin
//    sample_policy_streams_debug_net (:756): the same policy, deterministic
//    or stochastic, E episodes per lane, returns (E, B); with DUMP it also
//    writes the squashed actions and the demand it used.
// K29 k_rollout_traj_cluster  replaces rollout_traj_net (:683) under the
//    off-policy heads traj_policy "det", "sac" and "uniform" (:1062-1080) on
//    a relu (or tanh) trunk, the collection of OffPolicyConfig(collect=
//    "kernel"): K4's streams, the raw stream holding the normalised [-1, 1]
//    actions. The actor runs over a thread-block cluster (cluster_mlp.cuh),
//    the lanes' state in shared memory; k_rollout_traj_wide, the first
//    design (a block per 32 lanes, wide_mlp.cuh, the state in a thread's
//    local Episode), is the wide route for an actor whose slice fits no CTA.
//    Bound by operations: the (256, 256) actor's ~1.7e5 per env-step.
//
// K4-K6's design: a block per tile of (lane, episode) pairs, one thread
// each (mlp_tile.cuh); K4 is the one-episode, stochastic instance with its
// streams written (TRAJ), so it cannot drift from K5. The first versions
// ran one thread per pair with the actor on the FP32 cores (mlp.cuh) and
// the state in a local Episode: K5 47.70 ms at 65,536 x 16 x 30, K4 4.5683
// ms at 65,536 x 30 on an H100 (PERF.md), the MLP at ~12 TFLOP/s and the
// step from a 2,240-byte frame, the one that cost K2 13x. Now, per period,
// each thread writes its obs column (through keep_nan: the state may hold
// a NaN, which the TF32 split must see as the quiet NaN); its warp runs the
// actor for its 32 pairs on the tensor cores in 3xTF32; then the thread
// draws its pair's words (the demand and, when stochastic, the normals: the
// obs does not depend on them) into the transient rows of its column,
// squashes its actions in place and steps its state: the episode's state in
// shared memory [word][lane] (TileView, laid out by ops/net_step.py
// _shared_layout), the step's scratch in the transient rows. No local
// frame. K4 writes X and U at each period's start and after the last, the
// raws before the squash, r through the step's sink, the reward and the
// demand. Bound by operations: the products, 2 sum(in out) FLOPs an
// env-step, as three TF32 products each. The batch tail is masked: a warp
// past it returns, a pair past it computes (its warp's products need every
// thread) but writes nothing.
//
// K29's design (cluster_mlp.cuh, as K27/K28): a persistent grid of
// clusters, each walking tiles of lanes; each CTA keeps its slice of the
// actor in shared memory for the launch and steps lanes_cta lanes, one
// thread each, their state (_shared_layout with the step's scratch) in its
// shared memory [word][lane] (SharedView over the CTA's lanes). At each
// tile's reset every thread draws (lane, period)s' words into shared
// memory, the n_rt demands through link_demand and the head's noise; per
// period all threads write the CTA's lanes' obs (view_obs's order) into
// every CTA's xo, the cluster runs the actor, and the lane threads take
// the head (as the step's action source, which stores a_norm) and the
// step, writing r through the step's sink.
//
// Random stream (net_step.cuh, philox.cuh): key (seed, 1), counter (lane,
// episode, period, block); per period the n_rt demand words, then the n_ro
// u1 and the n_ro u2 words when stochastic (K29: the head's words, the n_ro
// u1 words alone for "uniform"), so K29's demand is K4's for the same seed,
// and K4's words are those of K5's stochastic episode 0.
//
// Rounding: act = (tanh(raw) + 1) * f32(0.5 * act_hi) as the JAX kernels
// write it; raw = H + std * z with two roundings (__fmul_rn/__fadd_rn), as
// the plain version computes it. The MLP sums in another order than a
// matmul, so a lane whose action lands on a rint tie may take the other
// integer and diverge from the plain version (the fraction-closeness rule
// of ROADMAP.md Queue C): they are held by the share of lanes that agree.

#include <cuda_runtime.h>

#include "cluster_mlp.cuh"
#include "launch.cuh"
#include "mlp_tile.cuh"
#include "net_step.cuh"
#include "philox.cuh"
#include "wide_mlp.cuh"

namespace {

// SharedView over the state that lasts the episode (X, Y, slot, U, the
// rings: ops/net_step.py _shared_layout without the scratch), with the
// step's per-node scratch (consumed, arrivals, sold) in the thread's column
// of the tile's transient rows, rows S floats apart.
struct TileView : SharedView {
  float* scratch_;
  int S, nm;
  __device__ TileView(float* state, const NetSmem& L, float* scratch, int stride, int n_main)
      : SharedView(state, L), scratch_(scratch), S(stride), nm(n_main) {}
  __device__ float& consumed(int k) const { return scratch_[k * S]; }
  __device__ float& arrivals(int k) const { return scratch_[(nm + k) * S]; }
  __device__ float& sold(int k) const { return scratch_[(2 * nm + k) * S]; }
};

// The words of one (lane, episode, period) of K5/K6 into the thread's
// columns: the demand of each retail link into dem and, when stochastic,
// the n_ro normals of the u1 then the u2 words into z.
template <bool STOCH>
__device__ __forceinline__ void pair_draws(const NetTopo& tp, const float* __restrict__ tables,
                                           unsigned seed, unsigned lane, unsigned e,
                                           unsigned t, float* dem, float* z, int S) {
  WordStream ws(seed, 1u, lane, e, t);
  for (int j = 0; j < tp.n_rt; ++j) dem[j * S] = link_demand(tp, tables, j, t, ws.next());
  if (STOCH) {
    unsigned* u1 = reinterpret_cast<unsigned*>(z);
    for (int i = 0; i < tp.n_ro; ++i) u1[i * S] = ws.next();
    for (int i = 0; i < tp.n_ro; ++i) z[i * S] = normal01(u1[i * S], ws.next());
  }
}

// The observation of the state view s (pallas_net_step._net_obs_rows's
// order, :482) into the column x, each value through keep_nan, then zero
// rows up to pad8.
template <class V>
__device__ __forceinline__ void view_obs(const NetTopo& tp, const V& s, int obs_pad, float* x,
                                         int S) {
  int k = 0;
  for (int j = 0; j < tp.n_rt; ++j) x[(k++) * S] = keep_nan(s.U(j));
  for (int n = 0; n < tp.n_main; ++n) x[(k++) * S] = keep_nan(s.X(n));
  for (int i = 0; i < tp.n_ro; ++i) {  // the window, oldest first: slots slot .. slot - 1
    const int L = tp.ro_L[i], ring = tp.ro_ring[i];
    int q = L > 0 ? s.slot(i) : 0;
    for (int j = 0; j < L; ++j) {
      x[(k++) * S] = keep_nan(s.ring(ring + q));
      q = q + 1 == L ? 0 : q + 1;
    }
  }
  for (; k < obs_pad; ++k) x[k * S] = 0.f;
}

// The streams K4 writes (TRAJ), each (T[+1], rows, B): X and U at each
// period's start and after the last, the fulfilled orders r, the
// pre-squash raws, the alpha^t rewards (the demand goes to K6's dems).
struct TrajStreams {
  float *x, *u, *r, *raw, *rew;
};

template <bool STOCH, bool DUMP, bool TRAJ>
__global__ void k_policy_returns(const __grid_constant__ NetTopo tp,
                                 const __grid_constant__ NetSmem lay,
                                 const __grid_constant__ MlpTile m,
                                 const float* __restrict__ w, const float* __restrict__ tables,
                                 const float* __restrict__ disc, float* __restrict__ out,
                                 float* __restrict__ acts, float* __restrict__ dems,
                                 const __grid_constant__ TrajStreams tr, unsigned seed,
                                 long long B, int E, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = threadIdx.x, S = m.stride;
  const long long pair0 = (long long)blockIdx.x * m.lanes, idx = pair0 + n;
  if (pair0 + (n & ~31) >= B * E) return;  // the warp's pairs all lie past the batch
  const bool live = idx < B * E;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  float* x = smem + m.s_x0 + n;
  float* dem = smem + m.s_dem + n;
  float* z = smem + m.s_z + n;
  const TileView s(smem + m.s_state, lay, smem + m.s_scratch + n, S, tp.n_main);
  reset_view(tp, s);
  const int obs_pad = (m.dims[0] + 7) & ~7;
  float total = 0.f;
  for (int t = 0; t <= T; ++t) {
    if (TRAJ && live) {  // the start-of-period snapshots; the last is the bootstrap obs
      for (int k = 0; k < tp.n_main; ++k) tr.x[((long long)t * tp.n_main + k) * B + lane] = s.X(k);
      for (int j = 0; j < tp.n_rt; ++j) tr.u[((long long)t * tp.n_rt + j) * B + lane] = s.U(j);
    }
    if (t == T) break;
    view_obs(tp, s, obs_pad, x, S);
    __syncwarp();
    float* a = mlp_tile_forward(m, w, smem) + n;  // H, squashed in place into the actions
    pair_draws<STOCH>(tp, tables, seed, lane, e, (unsigned)t, dem, z, S);  // rows now dead
    const long long row = (long long)t * E + e;   // (T, E, rows, B)
    for (int i = 0; i < tp.n_ro; ++i) {
      float v = a[i * S];
      if (STOCH) v = __fadd_rn(v, __fmul_rn(__ldg(w + m.std + i), z[i * S]));
      if (TRAJ && live) tr.raw[((long long)t * tp.n_ro + i) * B + lane] = v;
      v = (tanhf(v) + 1.f) * m.half_hi[i];
      a[i * S] = v;
      if (DUMP && live) acts[(row * tp.n_ro + i) * B + lane] = v;
    }
    if ((DUMP || TRAJ) && live)
      for (int j = 0; j < tp.n_rt; ++j) dems[(row * tp.n_rt + j) * B + lane] = dem[j * S];
    if (TRAJ) {
      const float profit = step_view(tp, s, FromColumn{a, S}, FromColumn{dem, S},
                                     ToRows{tr.r + (long long)t * tp.n_ro * B + lane, B, live});
      if (live) tr.rew[(long long)t * B + lane] = __ldg(disc + t) * profit;
    } else {
      total += __ldg(disc + t) * step_view(tp, s, FromColumn{a, S}, FromColumn{dem, S}, NoSink{});
    }
  }
  if (!TRAJ && live) out[idx] = total;  // (E, B), episode-major
}

// The observation of the period-t state into column n of x
// ([row][kWideLanes]), in view_obs's order.
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

// Row k of the obs of one lane (view_obs's order: U, X, then each reorder
// link's window, oldest first), read from the lane's column ``col`` of a
// [word][lane] region ``S`` floats a word laid out by ``L``; 0 for the rows
// past the obs. The window rows of link i are rows ro_ring[i] ..
// ro_ring[i] + L_i - 1 of the windows, as its ring's words are.
__device__ __forceinline__ float lane_obs(const NetTopo& tp, const NetSmem& L, const float* col,
                                          int S, int k) {
  if (k < tp.n_rt) return col[(L.u + k) * S];
  k -= tp.n_rt;
  if (k < tp.n_main) return col[(L.x + k) * S];
  k -= tp.n_main;
  int i = 0;
  while (i < tp.n_ro && k >= tp.ro_ring[i] + tp.ro_L[i]) ++i;
  if (i == tp.n_ro) return 0.f;
  const int Li = tp.ro_L[i];
  int q = reinterpret_cast<const int*>(col)[(L.slot + i) * S] + k - tp.ro_ring[i];
  if (q >= Li) q -= Li;
  return col[(L.ring + tp.ro_ring[i] + q) * S];
}

// K29's action source: the head of action i for the CTA's lane n (its
// a_norm stored into the raw stream), mapped onto the action's range.
struct ClusterActions {
  const ClusterMlp& m;
  const float* smem;
  const float* H;
  const float* z;  // the (lane, period)'s head noise
  int n;
  ToRows raw;
  __device__ float operator()(int i) const {
    float st;
    const float a = cluster_head(m, smem, H, n, i, z[i], st);
    raw(i, st);
    return (a + 1.f) * m.half_hi[i];
  }
};

// K29 over a thread-block cluster (cluster_mlp.cuh). CTA r of a cluster
// steps lanes r lanes_cta .. of each tile, one thread each, their state
// (X, Y, U, the rings and the step's scratch) in shared memory [word][lane]
// (SharedView over the CTA's lanes); the rest runs on every thread: at each
// tile's reset, every (lane, period)'s demand from the period's first n_rt
// words into shared memory ("uniform": also its head's u1 words); per
// period, the obs of the CTA's lanes into every CTA's xo and their head
// noise from the period's words after the demand's (a (lane, action) a
// thread: word_at, the same words a WordStream gives), then the cluster's
// actor; then the lane threads' snapshots, head and step. The noise of one
// period, not the episode's, is what lets four CTAs hold 64 lanes of the
// (68, 256, 256, 11) actor (ops/episode_kernels.py _cluster_plan).
template <bool RELU>
__global__ void __launch_bounds__(kClusterThreads, 1)
    k_rollout_traj_cluster(const __grid_constant__ NetTopo tp, const __grid_constant__ NetSmem lay,
                           const __grid_constant__ ClusterMlp m, const float* __restrict__ w,
                           const float* __restrict__ tables, const float* __restrict__ disc,
                           float* __restrict__ xo, float* __restrict__ uo,
                           float* __restrict__ ro, float* __restrict__ rawo,
                           float* __restrict__ rewo, float* __restrict__ demo, unsigned seed,
                           long long B, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), n = threadIdx.x, Lc = m.lanes_cta, A = m.act;
  const int n_rt = tp.n_rt, n_ro = tp.n_ro;
  const bool actor = m.head != kHeadUniform, lane = n < Lc;
  if (actor) cluster_load_weights(m, w, rank, smem);
  const long long tiles = (B + m.lanes - 1) / m.lanes;
  float* dem = smem + m.s_dem;      // [lane][T][n_rt]
  float* zs = smem + m.s_z;         // [lane][act], "uniform" [lane][T][act]
  float* state = smem + m.s_state;  // [word][lane], lanes_cta floats a word
  const SharedView s(state, lay, Lc, lane ? n : 0);
  for (long long tile = blockIdx.x / m.cluster; tile < tiles; tile += gridDim.x / m.cluster) {
    const long long lane0 = tile * m.lanes + rank * Lc, b = lane0 + n;
    const bool live = lane && b < B;
    if (lane) reset_view(tp, s);
    for (int i = n; i < Lc * T; i += kClusterThreads) {  // the draws, a (lane, period) each
      const int l = i / T, t = i - l * T;
      WordStream ws(seed, 1u, (unsigned)(lane0 + l), 0u, (unsigned)t);
      for (int j = 0; j < n_rt; ++j) dem[i * n_rt + j] = link_demand(tp, tables, j, t, ws.next());
      if (!actor) offpolicy_noise(m.head, A, ws, zs + (long long)i * A);
    }
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      if (actor) {  // the obs of period t, zero rows to kin[0], and its noise
        for (int i = n; i < m.kin[0] * Lc; i += kClusterThreads) {
          const int k = i / Lc, l = i - k * Lc;
          cluster_put(cl, m, smem + m.s_xo, k * m.stride + rank * Lc + l,
                      lane_obs(tp, lay, state + l, Lc, k));
        }
        for (int i = n; i < Lc * A; i += kClusterThreads) {  // offpolicy_noise's normals
          const int l = i / A, a = i - l * A;
          const unsigned b0 = (unsigned)(lane0 + l);
          zs[i] = normal01(word_at(seed, 1u, b0, 0u, (unsigned)t, n_rt + a),
                           word_at(seed, 1u, b0, 0u, (unsigned)t, n_rt + A + a));
        }
      }
      const float* H = actor ? cluster_forward<RELU>(cl, m, smem, rank) : nullptr;
      if (lane) {
        if (live) {
          for (int k = 0; k < tp.n_main; ++k) xo[((long long)t * tp.n_main + k) * B + b] = s.X(k);
          for (int j = 0; j < n_rt; ++j) uo[((long long)t * n_rt + j) * B + b] = s.U(j);
        }
        const float* d = dem + (n * T + t) * n_rt;
        const long long row = (long long)t * n_ro * B + b;
        const float profit = step_view(
            tp, s, ClusterActions{m, smem, H, zs + (actor ? n : (long long)n * T + t) * A, n,
                                  ToRows{rawo + row, B, live}},
            FromArray{d}, ToRows{ro + row, B, live});
        if (live) {
          rewo[(long long)t * B + b] = __ldg(disc + t) * profit;
          for (int j = 0; j < n_rt; ++j) demo[((long long)t * n_rt + j) * B + b] = d[j];
        }
      }
      if (actor) __syncthreads();  // the lanes' state, for the next obs
    }
    if (live) {  // the final snapshots are the bootstrap obs
      for (int k = 0; k < tp.n_main; ++k) xo[((long long)T * tp.n_main + k) * B + b] = s.X(k);
      for (int j = 0; j < n_rt; ++j) uo[((long long)T * n_rt + j) * B + b] = s.U(j);
    }
    __syncthreads();  // the last period's draws are read
  }
  if (actor) cl.sync();  // no CTA leaves while a peer may still write its memory
}

using NetClusterKernel = decltype(&k_rollout_traj_cluster<true>);

NetClusterKernel net_cluster_kernel(int relu) {
  return relu ? k_rollout_traj_cluster<true> : k_rollout_traj_cluster<false>;
}

template <bool STOCH, bool DUMP, bool TRAJ>
int launch_policy_returns(const NetTopo& tp, const NetSmem& lay, const MlpTile& m,
                          const float* w, const float* tables, const float* disc, float* out,
                          float* acts, float* dems, const TrajStreams& tr, unsigned seed,
                          long long B, int E, int T, cudaStream_t stream) {
  return launch_mlp_tile(k_policy_returns<STOCH, DUMP, TRAJ>, m, B * E, stream, tp, lay, m, w,
                         tables, disc, out, acts, dems, tr, seed, B, E, T);
}

}  // namespace

extern "C" {

// K4: one stochastic episode a lane on the tile, its streams written.
int net_rollout_traj(const NetTopo* topo, const NetSmem* lay, const MlpTile* m, const float* w,
                     const float* tables, const float* disc, float* xo, float* uo, float* ro,
                     float* raw, float* rew, float* dem, unsigned seed, long long B, int T,
                     cudaStream_t stream) {
  return launch_policy_returns<true, false, true>(*topo, *lay, *m, w, tables, disc, nullptr,
                                                  nullptr, dem, TrajStreams{xo, uo, ro, raw, rew},
                                                  seed, B, 1, T, stream);
}

// acts == dems == nullptr: returns only (K5); otherwise also the streams (K6).
int net_policy_returns(const NetTopo* topo, const NetSmem* lay, const MlpTile* m,
                       const float* w, const float* tables, const float* disc, float* out,
                       float* acts, float* dems, unsigned seed, long long B, int E, int T,
                       int stochastic, cudaStream_t stream) {
  const bool dump = acts != nullptr;
  const TrajStreams none{};
  if (stochastic)
    return dump ? launch_policy_returns<true, true, false>(*topo, *lay, *m, w, tables, disc, out,
                                                           acts, dems, none, seed, B, E, T,
                                                           stream)
                : launch_policy_returns<true, false, false>(*topo, *lay, *m, w, tables, disc,
                                                            out, acts, dems, none, seed, B, E,
                                                            T, stream);
  return dump ? launch_policy_returns<false, true, false>(*topo, *lay, *m, w, tables, disc, out,
                                                          acts, dems, none, seed, B, E, T,
                                                          stream)
              : launch_policy_returns<false, false, false>(*topo, *lay, *m, w, tables, disc, out,
                                                           acts, dems, none, seed, B, E, T,
                                                           stream);
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

// K29 on the cluster (cluster_mlp.cuh): m->clusters clusters of
// m->cluster CTAs.
int net_rollout_traj_cluster(const NetTopo* topo, const NetSmem* lay, const ClusterMlp* m,
                             const float* w, const float* tables, const float* disc, float* xo,
                             float* uo, float* ro, float* raw, float* rew, float* dem,
                             unsigned seed, int relu, long long B, int T, cudaStream_t stream) {
  return launch_cluster(net_cluster_kernel(relu), *m, stream, *topo, *lay, *m, w, tables, disc,
                        xo, uo, ro, raw, rew, dem, seed, B, T);
}

// The clusters of K29's instance that the card holds at once, into *out.
int net_rollout_traj_cluster_occupancy(const ClusterMlp* m, int relu, int* out) {
  return max_active_clusters(net_cluster_kernel(relu), *m, out);
}

}  // extern "C"
