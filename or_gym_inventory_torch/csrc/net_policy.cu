// NetInvMgmt episode kernels under a folded MLP actor, for Hopper (sm_90a),
// bound with ctypes by ops/_build.py and wrapped by ops/net_step.py, whose
// plain PyTorch versions compute the same functions.
//
// K4 k_rollout_traj  replaces pallas_net_step.rollout_traj_net (:683, body
//    _net_traj_kernel :629, policy head pallas_episode_kernels.traj_policy
//    "ppo" :1036). One stochastic-policy episode per lane, the training
//    streams written to device memory: start-of-period X and U (T+1
//    snapshots), fulfilled orders r, pre-squash raws, alpha^t rewards and
//    demand, each (T[+1], rows, B) and coalesced along B.
// K5/K6 k_policy_returns  replace _net_policy_call (:554) behind
//    episode_returns_net_policy (:611) and its stream-dumping twin
//    sample_policy_streams_debug_net (:756): the same policy, deterministic
//    or stochastic, E episodes per lane, returns (E, B); with DUMP it also
//    writes the squashed actions and the demand it used.
// K29 k_rollout_traj_wide  replaces rollout_traj_net (:683) under the
//    off-policy heads traj_policy "det", "sac" and "uniform" (:1062-1080) on
//    a relu (or tanh) trunk, the collection of OffPolicyConfig(collect=
//    "kernel"): K4's streams, the raw stream holding the normalised [-1, 1]
//    actions. The actor is wide_mlp.cuh's (a block per 32 lanes); threads
//    0..31 own the lanes' envs (net_step.cuh). Bound by operations: the
//    (256, 256) actor's ~1.7e5 per env-step.
//
// K4's design (a simple kernel first): one thread per lane, its state in a
// local Episode (net_step.cuh FrameView), the actor as mlp.cuh has it:
// weights and activations in shared memory, one forward pass per thread on
// the FP32 cores. The observation is assembled from the live state in the
// order of pallas_net_step._net_obs_rows (:482): U, X, then each reorder
// link's window r[t-L..t-1] oldest first, read from net_step.cuh's per-link
// ring (order_window). Bound by operations: the MLP's ~18,600 per env-step
// dwarf the step and the draws.
//
// K5/K6's design: a block per tile of (lane, episode) pairs, one thread
// each (mlp_tile.cuh). The first version ran K4's design with E episodes
// per lane: 47.70 ms at 65,536 x 16 x 30 on an H100 (PERF.md), its MLP on
// the FP32 cores at ~12 TFLOP/s and its step from a 2,240-byte local
// Episode, the frame that cost K2 13x. Now, per period, each thread writes
// its obs column (through keep_nan: the state may hold a NaN, which the
// TF32 split must see as the quiet NaN); its warp runs the actor for its 32
// pairs on the tensor cores in 3xTF32; then the thread draws its pair's
// words (the demand and, when stochastic, the normals: the obs does not
// depend on them) into the transient rows of its column, squashes its
// actions in place and steps its state: the episode's state in shared
// memory [word][lane] (TileView, laid out by ops/net_step.py
// _shared_layout), the step's scratch in the transient rows. No local
// frame. Bound by
// operations: the products, 2 sum(in out) FLOPs an env-step, as three
// TF32 products each. The batch tail is masked: a warp past it returns, a
// pair past it computes (its warp's products need every thread) but
// writes nothing.
//
// Random stream (net_step.cuh, philox.cuh): key (seed, 1), counter (lane,
// episode, period, block); per period the n_rt demand words, then the n_ro
// u1 and the n_ro u2 words when stochastic (K29: the head's words, the n_ro
// u1 words alone for "uniform"), so K29's demand is K4's for the same seed.
//
// Rounding: act = (tanh(raw) + 1) * f32(0.5 * act_hi) as the JAX kernels
// write it; raw = H + std * z with two roundings (__fmul_rn/__fadd_rn), as
// the plain version computes it. The MLP sums in another order than a
// matmul, so a lane whose action lands on a rint tie may take the other
// integer and diverge from the plain version (the fraction-closeness rule
// of ROADMAP.md Queue C): they are
// held by the share of lanes that agree.

#include <cuda_runtime.h>

#include "launch.cuh"
#include "mlp.cuh"
#include "mlp_tile.cuh"
#include "net_step.cuh"
#include "philox.cuh"
#include "wide_mlp.cuh"

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

// A column of a [row][lane] buffer in shared memory, read as a step source.
struct FromColumn {
  const float* p;
  int S;
  __device__ float operator()(int k) const { return p[k * S]; }
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

// The observation of the state view s (assemble_obs's order) into the
// column x, each value through keep_nan, then zero rows up to pad8.
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

template <bool STOCH, bool DUMP>
__global__ void k_policy_returns(const __grid_constant__ NetTopo tp,
                                 const __grid_constant__ NetSmem lay,
                                 const __grid_constant__ MlpTile m,
                                 const float* __restrict__ w, const float* __restrict__ tables,
                                 const float* __restrict__ disc, float* __restrict__ out,
                                 float* __restrict__ acts, float* __restrict__ dems,
                                 unsigned seed, long long B, int E, int T) {
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
  for (int t = 0; t < T; ++t) {
    view_obs(tp, s, obs_pad, x, S);
    __syncwarp();
    float* a = mlp_tile_forward(m, w, smem) + n;  // H, squashed in place into the actions
    pair_draws<STOCH>(tp, tables, seed, lane, e, (unsigned)t, dem, z, S);  // rows now dead
    const long long row = (long long)t * E + e;   // (T, E, rows, B)
    for (int i = 0; i < tp.n_ro; ++i) {
      float v = a[i * S];
      if (STOCH) v = __fadd_rn(v, __fmul_rn(__ldg(w + m.std + i), z[i * S]));
      v = (tanhf(v) + 1.f) * m.half_hi[i];
      a[i * S] = v;
      if (DUMP && live) acts[(row * tp.n_ro + i) * B + lane] = v;
    }
    if (DUMP && live)
      for (int j = 0; j < tp.n_rt; ++j) dems[(row * tp.n_rt + j) * B + lane] = dem[j * S];
    total += __ldg(disc + t) * step_view(tp, s, FromColumn{a, S}, FromColumn{dem, S}, nullptr);
  }
  if (live) out[idx] = total;  // (E, B), episode-major
}

// The observation of the period-t state into column n of x
// ([row][kWideLanes]), in assemble_obs's order.
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

template <bool STOCH, bool DUMP>
int launch_policy_returns(const NetTopo& tp, const NetSmem& lay, const MlpTile& m,
                          const float* w, const float* tables, const float* disc, float* out,
                          float* acts, float* dems, unsigned seed, long long B, int E, int T,
                          cudaStream_t stream) {
  return launch_mlp_tile(k_policy_returns<STOCH, DUMP>, m, B * E, stream, tp, lay, m, w,
                         tables, disc, out, acts, dems, seed, B, E, T);
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

// acts == dems == nullptr: returns only (K5); otherwise also the streams (K6).
int net_policy_returns(const NetTopo* topo, const NetSmem* lay, const MlpTile* m,
                       const float* w, const float* tables, const float* disc, float* out,
                       float* acts, float* dems, unsigned seed, long long B, int E, int T,
                       int stochastic, cudaStream_t stream) {
  const bool dump = acts != nullptr;
  if (stochastic)
    return dump ? launch_policy_returns<true, true>(*topo, *lay, *m, w, tables, disc, out, acts,
                                                    dems, seed, B, E, T, stream)
                : launch_policy_returns<true, false>(*topo, *lay, *m, w, tables, disc, out,
                                                     acts, dems, seed, B, E, T, stream);
  return dump ? launch_policy_returns<false, true>(*topo, *lay, *m, w, tables, disc, out, acts,
                                                   dems, seed, B, E, T, stream)
              : launch_policy_returns<false, false>(*topo, *lay, *m, w, tables, disc, out, acts,
                                                    dems, seed, B, E, T, stream);
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

}  // extern "C"
