// InvManagement kernels under the folded LSTM actor, for Hopper (sm_90a),
// bound with ctypes by ops/_build.py and wrapped by ops/episode_kernels.py,
// whose plain PyTorch versions compute the same functions.
//
// K22/K23 k_im_lstm_returns  replaces pallas_episode_kernels._im_lstm_call
//    (:1419) behind episode_returns_im_lstm (:1459) and its stream-dumping
//    twin sample_lstm_streams_debug_im (:1470; body _im_lstm_kernel :1361):
//    the deterministic LSTM policy, one episode per lane, returns (B,); with
//    DUMP it also writes the int actions (T, m1, B) and the demand (T, B) it
//    used.
// K24 k_im_lstm_traj  replaces rollout_traj_im_lstm (:1551; body
//    _im_lstm_traj_kernel :1483): one stochastic-policy episode per lane,
//    the training streams written to device memory: start-of-period on-hand
//    inv (T+1 snapshots), int actions, pre-squash raws, alpha^t rewards and
//    demand. Recurrent PPO with rollout="kernel" feeds on it.
//
// Design: a block runs a tile of LANES lanes (lstm.cuh; 64 at the
// benchmark widths, the wrapper's _pack_lstm_actor picks the tile). Threads
// 0..LANES-1, a warp per 32 lanes, each own one lane's env (im_step.cuh's
// state and step, the ring of requested orders, in local memory as in K10:
// ~2 KB a lane, where the block's activations already take ~104 KB of
// shared memory and two blocks share an SM) and write its observation
// column; then the whole block runs the actor (lstm.cuh: the encoder and
// the gate product on the tensor cores in 3xTF32, C in registers and H in
// shared memory, the head); then the lane threads take the actions and
// step, while threads LANES..2 LANES-1 draw the next period's words
// (draw_ahead, into two buffers of shared memory). The carry never leaves
// the block. Bound by
// operations: the gate product's ~2e5 FLOPs per env-step at the benchmark
// widths, run as three TF32 products. The tiles the entry points can launch
// are LSTM_TILES below; one is picked per actor by the wrapper and passed
// in struct Lstm.
//
// Random stream (philox.cuh): K10's, key (seed, 1), counter (lane, 0,
// period, block); per period one demand word, then, when stochastic, the m1
// u1 and the m1 u2 words of the Box-Muller normals. So K24 draws the demand
// K23 draws for the same seed, as the JAX kernels drew demand first and
// then one (m1, lanes) noise draw (pallas_episode_kernels.py:1514-1533).
//
// Rounding: raw = mean + std * z with two roundings (__fmul_rn/__fadd_rn);
// the action truncates, (int)((tanh(raw) + 1) * f32(0.5 c_i)), each
// operation rounded alone; a NaN raw casts to 0 (cvt.rzi), as JAX's cast
// does on the CPU. The actor's sums run in another order than the plain
// version's matmuls, so a lane whose action lands on a truncation boundary
// may take the other integer and its int state then diverges: kernel and
// plain version are held by the share of lanes that agree.

#include <cuda_runtime.h>

#include "im_step.cuh"
#include "launch.cuh"
#include "lstm.cuh"
#include "philox.cuh"

namespace {

// The lane's demand of period t and, when stochastic, its m1 standard
// normals into z ([act][lane] column n).
template <bool STOCH>
__device__ __forceinline__ int lane_draws(const ImParams& p, const float* __restrict__ table,
                                          const int* __restrict__ user_d, unsigned seed,
                                          unsigned lane, int t, float* z, int S) {
  WordStream ws(seed, 1u, lane, 0u, (unsigned)t);
  const int d = im_demand(p, table, user_d, t, ws.next());
  if (STOCH) {
    unsigned w1[IM_MAX_M1];
    for (int i = 0; i < p.m1; ++i) w1[i] = ws.next();
    for (int i = 0; i < p.m1; ++i) z[i * S] = normal01(w1[i], ws.next());
  }
  return d;
}

// The lane's observation column in x0 (rows S floats apart), in the order
// of _im_obs_rows:
// on-hand, then the requested orders of periods max(t - lt, 0) .. t-1
// oldest first, one row per (period, stage), zero rows at the end while
// t < lt. ``ah`` is the ring of requested orders (slot q % lt).
__device__ __forceinline__ void lane_obs(const ImParams& p, const ImEpisode& s, int t,
                                         const int* ah, float* x0, int S) {
  const int m1 = p.m1, lt = p.lt;
  for (int i = 0; i < m1; ++i) x0[i * S] = (float)s.inv[i];
  const int q0 = max(t - lt, 0);
  for (int j = 0; j < lt; ++j) {
    const int q = q0 + j;
    for (int i = 0; i < m1; ++i)
      x0[(m1 + j * m1 + i) * S] = q < t ? (float)ah[(q % lt) * m1 + i] : 0.f;
  }
}

// Threads LANES..2 LANES-1 draw period t for the block's lanes 0..LANES-1
// (lane0 is the block's first): the demand (an int in the last row) and,
// when stochastic, the m1 normals (the rows before it) of buffer t & 1 of
// the draw rows. The draws depend on the seed, the lane and t alone, so
// these threads make them for period t + 1 while the lane threads step
// period t, and the lanes read them after the next period's first barrier.
template <bool STOCH, int LANES>
__device__ __forceinline__ void draw_ahead(const ImParams& p, const Lstm& L,
                                           const float* __restrict__ table,
                                           const int* __restrict__ user_d, unsigned seed,
                                           long long lane0, int t, float* smem) {
  const int n = threadIdx.x - LANES, S = L.stride;
  float* buf = smem + L.s_z + (t & 1) * (L.act + 1) * S + n;
  buf[L.act * S] = __int_as_float(lane_draws<STOCH>(p, table, user_d, seed,
                                                     (unsigned)(lane0 + n), t, buf, S));
}

// The lane's raw samples and int actions from the means in m (its column).
template <bool STOCH>
__device__ __forceinline__ void lane_act(const Lstm& L, const float* __restrict__ w,
                                         const float* m, const float* z, int m1,
                                         float* raw, int* act) {
  const int S = L.stride;
  for (int i = 0; i < m1; ++i) {
    float x = m[i * S];
    if (STOCH) x = __fadd_rn(x, __fmul_rn(__ldg(w + L.std + i), z[i * S]));
    raw[i] = x;
    act[i] = (int)__fmul_rn(__fadd_rn(tanhf(x), 1.f), L.half_hi[i]);
  }
}

// One period's step, with the requested orders pushed into the ring ``ah``.
template <bool BACKLOG>
__device__ __forceinline__ float lane_step(const ImParams& p, ImEpisode& s, int t,
                                           const int* act, int d, int* ah) {
  int r_req[IM_MAX_M1];
  const int slot = s.slot;
  const float profit = im_step<BACKLOG>(p, s, t, act, d, r_req);
  if (p.lt > 0)
    for (int i = 0; i < p.m1; ++i) ah[slot * p.m1 + i] = r_req[i];
  return profit;
}

// The tiles compiled: (lanes a block, warps along the units). The wrapper's
// _LSTM_TILES lists the entry points' preference among them.
#define LSTM_TILES(X) X(64, 4) X(32, 8)

// Blocks an SM the register allocation aims at: as many as its 65,536
// registers hold at 128 a thread (two of 256 threads).
__host__ __device__ constexpr int lstm_min_blocks(int threads) { return 512 / threads; }

template <int LANES, int WM, bool DUMP, bool BACKLOG>
__global__ void __launch_bounds__(LANES * WM, lstm_min_blocks(LANES * WM))
    k_im_lstm_returns(const __grid_constant__ ImParams p, const __grid_constant__ Lstm L,
                      const float* __restrict__ w, const float* __restrict__ table,
                      const int* __restrict__ user_d, const float* __restrict__ disc,
                      float* __restrict__ out, int* __restrict__ acto,
                      int* __restrict__ demo, unsigned seed, long long B, int T) {
  static_assert(WM >= 2, "threads LANES..2 LANES-1 draw ahead");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = threadIdx.x, S = L.stride;
  const long long lane0 = (long long)blockIdx.x * LANES, b = lane0 + n;
  const bool lane = n < LANES, live = lane && b < B, drawer = !lane && n < 2 * LANES;
  const int m1 = p.m1;
  float c[lstm_groups_per_warp(WM)][4][2];
  float *hold, *hnew;
  lstm_reset<WM>(L, smem, hold, hnew, c);
  ImEpisode s;
  int ah[IM_MAX_LT * IM_MAX_M1];  // requested order of period q: slot q % lt
  int act[IM_MAX_M1];
  float raw[IM_MAX_M1], total = 0.f;
  if (lane) im_reset(p, s);
  __syncthreads();  // the reset's zeros are in before the obs rows and draws
  if (drawer) draw_ahead<false, LANES>(p, L, table, user_d, seed, lane0, 0, smem);
  for (int t = 0; t < T; ++t) {
    if (lane) lane_obs(p, s, t, ah, smem + L.s_x0 + n, S);
    lstm_forward<LANES, WM>(L, w, smem, hold, hnew, c);
    if (lane) {
      const float* buf = smem + L.s_z + (t & 1) * (L.act + 1) * S + n;
      const int d = __float_as_int(buf[L.act * S]);
      lane_act<false>(L, w, smem + L.s_m + n, buf, m1, raw, act);
      if (DUMP && live) {
        for (int i = 0; i < m1; ++i) acto[((long long)t * m1 + i) * B + b] = act[i];
        demo[(long long)t * B + b] = d;
      }
      const float profit = lane_step<BACKLOG>(p, s, t, act, d, ah);
      total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
    } else if (drawer && t + 1 < T) {
      draw_ahead<false, LANES>(p, L, table, user_d, seed, lane0, t + 1, smem);
    }
  }
  if (live) out[b] = total;
}

template <int LANES, int WM, bool BACKLOG>
__global__ void __launch_bounds__(LANES * WM, lstm_min_blocks(LANES * WM))
    k_im_lstm_traj(const __grid_constant__ ImParams p, const __grid_constant__ Lstm L,
                   const float* __restrict__ w, const float* __restrict__ table,
                   const int* __restrict__ user_d, const float* __restrict__ disc,
                   int* __restrict__ invo, int* __restrict__ acto, float* __restrict__ rawo,
                   float* __restrict__ rewo, int* __restrict__ demo, unsigned seed,
                   long long B, int T) {
  static_assert(WM >= 2, "threads LANES..2 LANES-1 draw ahead");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = threadIdx.x, S = L.stride;
  const long long lane0 = (long long)blockIdx.x * LANES, b = lane0 + n;
  const bool lane = n < LANES, live = lane && b < B, drawer = !lane && n < 2 * LANES;
  const int m1 = p.m1;
  float c[lstm_groups_per_warp(WM)][4][2];
  float *hold, *hnew;
  lstm_reset<WM>(L, smem, hold, hnew, c);
  ImEpisode s;
  int ah[IM_MAX_LT * IM_MAX_M1];
  int act[IM_MAX_M1];
  float raw[IM_MAX_M1];
  if (lane) im_reset(p, s);
  __syncthreads();  // the reset's zeros are in before the obs rows and draws
  if (drawer) draw_ahead<true, LANES>(p, L, table, user_d, seed, lane0, 0, smem);
  for (int t = 0; t < T; ++t) {
    if (lane) {
      if (live)
        for (int i = 0; i < m1; ++i) invo[((long long)t * m1 + i) * B + b] = s.inv[i];
      lane_obs(p, s, t, ah, smem + L.s_x0 + n, S);
    }
    lstm_forward<LANES, WM>(L, w, smem, hold, hnew, c);
    if (lane) {
      const float* buf = smem + L.s_z + (t & 1) * (L.act + 1) * S + n;
      const int d = __float_as_int(buf[L.act * S]);
      lane_act<true>(L, w, smem + L.s_m + n, buf, m1, raw, act);
      const float profit = lane_step<BACKLOG>(p, s, t, act, d, ah);
      if (live) {
        for (int i = 0; i < m1; ++i) {
          const long long k = ((long long)t * m1 + i) * B + b;
          rawo[k] = raw[i];
          acto[k] = act[i];
        }
        rewo[(long long)t * B + b] = __fmul_rn(__ldg(disc + t), profit);
        demo[(long long)t * B + b] = d;
      }
    } else if (drawer && t + 1 < T) {
      draw_ahead<true, LANES>(p, L, table, user_d, seed, lane0, t + 1, smem);
    }
  }
  if (live)
    for (int i = 0; i < m1; ++i) invo[((long long)T * m1 + i) * B + b] = s.inv[i];
}

// Launch one kernel instance on the tile L names: the grid of
// ceil(B / lanes) blocks of L.threads threads and L.s_total floats of
// dynamic shared memory.
template <typename Kernel, typename... Args>
int launch_tile(Kernel kernel, const Lstm& L, long long B, cudaStream_t stream,
                Args... args) {
  const size_t smem = (size_t)L.s_total * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + L.lanes - 1) / L.lanes);
  kernel<<<blocks, L.threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <bool DUMP, bool BACKLOG>
int launch_returns(const ImParams& p, const Lstm& L, const float* w, const float* table,
                   const int* user_d, const float* disc, float* out, int* acts, int* dems,
                   unsigned seed, long long B, int T, cudaStream_t stream) {
#define LSTM_RETURNS_TILE(N, W)                                                         \
  if (L.lanes == N && L.warps_m == W && L.threads == N * W)                             \
    return launch_tile(k_im_lstm_returns<N, W, DUMP, BACKLOG>, L, B, stream, p, L, w,   \
                       table, user_d, disc, out, acts, dems, seed, B, T);
  LSTM_TILES(LSTM_RETURNS_TILE)
#undef LSTM_RETURNS_TILE
  return (int)cudaErrorInvalidConfiguration;
}

template <bool BACKLOG>
int launch_traj(const ImParams& p, const Lstm& L, const float* w, const float* table,
                const int* user_d, const float* disc, int* inv, int* acts, float* raw,
                float* rew, int* dem, unsigned seed, long long B, int T,
                cudaStream_t stream) {
#define LSTM_TRAJ_TILE(N, W)                                                            \
  if (L.lanes == N && L.warps_m == W && L.threads == N * W)                             \
    return launch_tile(k_im_lstm_traj<N, W, BACKLOG>, L, B, stream, p, L, w, table,     \
                       user_d, disc, inv, acts, raw, rew, dem, seed, B, T);
  LSTM_TILES(LSTM_TRAJ_TILE)
#undef LSTM_TRAJ_TILE
  return (int)cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" {

// acts == dems == nullptr: returns only (K22); otherwise also the streams (K23).
int im_lstm_returns(const ImParams* p, const Lstm* L, const float* w, const float* table,
                    const int* user_d, const float* disc, float* out, int* acts, int* dems,
                    unsigned seed, int backlog, long long B, int T, cudaStream_t stream) {
  if (acts != nullptr)
    return backlog ? launch_returns<true, true>(*p, *L, w, table, user_d, disc, out, acts,
                                                dems, seed, B, T, stream)
                   : launch_returns<true, false>(*p, *L, w, table, user_d, disc, out, acts,
                                                 dems, seed, B, T, stream);
  return backlog ? launch_returns<false, true>(*p, *L, w, table, user_d, disc, out, acts,
                                               dems, seed, B, T, stream)
                 : launch_returns<false, false>(*p, *L, w, table, user_d, disc, out, acts,
                                                dems, seed, B, T, stream);
}

int im_lstm_rollout_traj(const ImParams* p, const Lstm* L, const float* w,
                         const float* table, const int* user_d, const float* disc, int* inv,
                         int* acts, float* raw, float* rew, int* dem, unsigned seed,
                         int backlog, long long B, int T, cudaStream_t stream) {
  return backlog ? launch_traj<true>(*p, *L, w, table, user_d, disc, inv, acts, raw, rew, dem,
                                     seed, B, T, stream)
                 : launch_traj<false>(*p, *L, w, table, user_d, disc, inv, acts, raw, rew,
                                      dem, seed, B, T, stream);
}

}  // extern "C"
