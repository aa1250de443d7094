// InvManagement kernels under the off-policy heads, for Hopper (sm_90a),
// bound with ctypes by ops/_build.py and wrapped by ops/episode_kernels.py
// (rollout_traj_im_offpolicy), whose plain PyTorch version computes the
// same function. K10-K12, the PPO head's tile kernels on the same step,
// are im_policy.cu's; the two sources build at once.
//
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
// K27's wide route is built for both actor classes (wide_mlp.cuh WideMlp
// and WideMlpG, the general class through the C entry point
// im_rollout_traj_wide_any), and each kernel for the params' two routes
// (im_step.cuh): the fixed ImParams, whose lanes step on the ImEpisode
// frame, and the chain route's ImParamsG (the C entry points named
// *_chain), whose lanes step on their column (im_lane.cuh: the state, the
// ring of requested orders, the actions and, on the wide route, the head
// noise) in shared memory: the cluster's ([lane][word]), and on the wide
// route a region after the activations ([word][lane]); the block stages
// the params' records after it. On the wide route the chain's layer sums
// run in FP64 (wide_mlp.cuh wide_layer): with obs of hundreds of inputs an
// FP32 sum's error, through the sac head's exp, reached the teacher-forced
// tolerance (1e-4) at IM-chain12-lt40's 492 inputs.
//
// Random stream (philox.cuh): key (seed, 1), counter (lane, 0, period,
// block), K10's: per period the demand word, then the head's m1 u1 and m1
// u2 words (the m1 u1 words alone for "uniform"), so its demand is K10's
// for the same seed. The action truncates, (int)((a + 1) * f32(0.5 c_i)),
// each operation rounded alone, and is held against the plain version by
// the share of lanes, as K10's.

#include <cuda_runtime.h>

#include "cluster_mlp.cuh"
#include "im_lane.cuh"
#include "im_step.cuh"
#include "launch.cuh"
#include "philox.cuh"
#include "wide_mlp.cuh"

namespace {

// The lane's observation into column n of x ([row][kWideLanes]), in the
// order of im_policy.cu's lane_obs.
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
