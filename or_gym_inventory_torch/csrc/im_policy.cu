// InvManagement kernels under a folded MLP actor, for Hopper (sm_90a), bound
// with ctypes by ops/_build.py and wrapped by ops/episode_kernels.py, whose
// plain PyTorch versions compute the same functions.
//
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
//
// K10-K12's design: a block per tile of (episode, lane) pairs, one thread
// each (mlp_tile.cuh); K10 is the one-episode, stochastic instance with its
// streams written (TRAJ), so it cannot drift from K11. The first versions
// ran one thread per pair with the actor on the FP32 cores (mlp.cuh): K11
// 45.50 ms at 65,536 x 16 x 30, K10 2.5333 ms at 65,536 x 30 on an H100
// (PERF.md), the MLP at ~9 TFLOP/s. Now, per period, each thread writes its
// obs column; its warp runs the actor for its 32 pairs on the tensor cores
// in 6xTF32; then the thread draws its pair's demand (a register) and, when
// stochastic, its normals (the transient rows of its column), takes its
// actions and steps. The InvManagement step stays on a per-thread frame
// (ImEpisode and the ring of requested orders, local memory). K10 writes the
// on-hand at each period's start and after the last, the raws before the
// squash, the actions, the demand and the alpha^t reward. Bound by
// operations: the products, 2 sum(in out) FLOPs an env-step, as six TF32
// products each. The batch tail is masked: a warp past it returns, a pair
// past it computes (its warp's products need every thread) but writes
// nothing.
//
// K10-K12 are built for both actor classes (mlp_tile.cuh MlpTile and
// MlpTileG, the general class through the C entry points named *_any): an
// actor past the fixed arrays, or whose activations fit no block, takes the
// general class, its activations in shared memory or in a device workspace.
//
// Each kernel is also built for the params' two routes (im_step.cuh): the
// fixed ImParams, whose lanes step on the ImEpisode frame as above, and the
// chain route's ImParamsG (past IM_MAX_M1 stages or IM_MAX_LT periods of
// lead time; the C entry points named *_chain, on the general actor class
// MlpTileG), whose lanes step on their column (im_lane.cuh: the state, the
// ring of requested orders, the actions) in the tile's state region
// ([word][lane]) of shared memory; the block stages the params' records
// after it. The fixed route's instances are the parent's code.
//
// Random stream (philox.cuh): key (seed, 1), counter (lane, episode, period,
// block); per period one demand word, then, when stochastic, the m1 u1 and
// the m1 u2 words of the Box-Muller normals (pallas_episode_kernels.py
// :1657-1658, :69-70). K10 is episode 0, so episode 0 of the stochastic K11
// draws exactly K10's words for the same seed and, on the same tile, takes
// K10's actions bit for bit.
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
//
// K27, the off-policy heads on the same InvManagement step, is
// im_offpolicy.cu's: a source of its own, so that the two build at once
// (ops/_build.py runs one nvcc a source); the lane state both step on is
// im_lane.cuh's.

#include <cuda_runtime.h>

#include "im_lane.cuh"
#include "im_step.cuh"
#include "launch.cuh"
#include "mlp_tile.cuh"
#include "philox.cuh"

namespace {

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

}  // extern "C"
