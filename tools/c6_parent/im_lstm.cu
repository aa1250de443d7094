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
// The chain route (im_step.cuh ImParamsG: past IM_MAX_M1 stages or
// IM_MAX_LT periods of lead time; the C entry points named *_chain): the
// same kernels with the block's staged records (after the activations) and
// each lane's column (im_lane: the state, the ring of requested orders, the
// actions and the raw samples) in a device workspace ([word][lane], the
// lanes of the launch apart, so a warp's accesses are coalesced): beside
// the obs rows of a long chain a block has no room for it. The actions'
// half ranges come from the records (half_c) rather than struct Lstm, and
// the u1 words wait in the draw rows, as the tile kernels keep them.
//
// An actor past struct Lstm's arrays, or whose layout fits no block, takes
// the general class (lstm.cuh LstmG), whose kernels are im_lstm_any.cu's;
// the lane side of both (the draws, the action, the lane's state and the
// step) is im_lstm.cuh's.
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
#include "im_lstm.cuh"

namespace {

// The tiles compiled: (lanes a block, warps along the units). The wrapper's
// _LSTM_TILES lists the entry points' preference among them.
#define LSTM_TILES(X) X(64, 4) X(32, 8)

template <int LANES, int WM, bool DUMP, bool BACKLOG, class PP>
__global__ void __launch_bounds__(LANES * WM, lstm_min_blocks(LANES * WM))
    k_im_lstm_returns(const __grid_constant__ PP pp, const __grid_constant__ Lstm L,
                      const float* __restrict__ w, const float* __restrict__ table,
                      const int* __restrict__ user_d, const float* __restrict__ disc,
                      float* __restrict__ out, int* __restrict__ acto,
                      int* __restrict__ demo, unsigned seed, long long B, int T) {
  static_assert(WM >= 2, "threads LANES..2 LANES-1 draw ahead");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const auto& p = im_params(pp, reinterpret_cast<int*>(smem + L.s_total));  // the chain's records
  const int n = threadIdx.x, S = L.stride;
  const long long lane0 = (long long)blockIdx.x * LANES, b = lane0 + n;
  const bool lane = n < LANES, live = lane && b < B, drawer = !lane && n < 2 * LANES;
  const int m1 = p.m1;
  float c[lstm_groups_per_warp(WM)][4][2];
  float *hold, *hnew;
  lstm_reset<WM>(L, smem, hold, hnew, c);
  LstmLaneOf<PP> l;
  lstm_lane_init(l, p, pp, b);
  float total = 0.f;
  if (lane) im_reset(p, l.s);
  __syncthreads();  // the reset's zeros are in before the obs rows and draws
  if (drawer) draw_ahead<false, LANES>(p, L, table, user_d, seed, lane0, 0, smem);
  for (int t = 0; t < T; ++t) {
    if (lane) lane_obs(p, l.s, t, l.ah, smem + L.s_x0 + n, S);
    lstm_forward<LANES, WM>(L, w, smem, hold, hnew, c);
    if (lane) {
      const float* buf = smem + L.s_z + (t & 1) * (L.act + 1) * S + n;
      const int d = __float_as_int(buf[L.act * S]);
      lane_act<false>(L, p, w, smem + L.s_m + n, buf, m1, lane_raw(l), l.act);
      if (DUMP && live) {
        for (int i = 0; i < m1; ++i) acto[((long long)t * m1 + i) * B + b] = l.act[i];
        demo[(long long)t * B + b] = d;
      }
      const float profit = lstm_step<BACKLOG>(p, l, t, d);
      total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
    } else if (drawer && t + 1 < T) {
      draw_ahead<false, LANES>(p, L, table, user_d, seed, lane0, t + 1, smem);
    }
  }
  if (live) out[b] = total;
}

template <int LANES, int WM, bool BACKLOG, class PP>
__global__ void __launch_bounds__(LANES * WM, lstm_min_blocks(LANES * WM))
    k_im_lstm_traj(const __grid_constant__ PP pp, const __grid_constant__ Lstm L,
                   const float* __restrict__ w, const float* __restrict__ table,
                   const int* __restrict__ user_d, const float* __restrict__ disc,
                   int* __restrict__ invo, int* __restrict__ acto, float* __restrict__ rawo,
                   float* __restrict__ rewo, int* __restrict__ demo, unsigned seed,
                   long long B, int T) {
  static_assert(WM >= 2, "threads LANES..2 LANES-1 draw ahead");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const auto& p = im_params(pp, reinterpret_cast<int*>(smem + L.s_total));  // the chain's records
  const int n = threadIdx.x, S = L.stride;
  const long long lane0 = (long long)blockIdx.x * LANES, b = lane0 + n;
  const bool lane = n < LANES, live = lane && b < B, drawer = !lane && n < 2 * LANES;
  const int m1 = p.m1;
  float c[lstm_groups_per_warp(WM)][4][2];
  float *hold, *hnew;
  lstm_reset<WM>(L, smem, hold, hnew, c);
  LstmLaneOf<PP> l;
  lstm_lane_init(l, p, pp, b);
  if (lane) im_reset(p, l.s);
  __syncthreads();  // the reset's zeros are in before the obs rows and draws
  if (drawer) draw_ahead<true, LANES>(p, L, table, user_d, seed, lane0, 0, smem);
  for (int t = 0; t < T; ++t) {
    if (lane) {
      if (live)
        for (int i = 0; i < m1; ++i) invo[((long long)t * m1 + i) * B + b] = l.s.inv[i];
      lane_obs(p, l.s, t, l.ah, smem + L.s_x0 + n, S);
    }
    lstm_forward<LANES, WM>(L, w, smem, hold, hnew, c);
    if (lane) {
      const float* buf = smem + L.s_z + (t & 1) * (L.act + 1) * S + n;
      const int d = __float_as_int(buf[L.act * S]);
      lane_act<true>(L, p, w, smem + L.s_m + n, buf, m1, lane_raw(l), l.act);
      const float profit = lstm_step<BACKLOG>(p, l, t, d);
      if (live) {
        for (int i = 0; i < m1; ++i) {
          const long long k = ((long long)t * m1 + i) * B + b;
          rawo[k] = get_raw(lane_raw(l), i);
          acto[k] = l.act[i];
        }
        rewo[(long long)t * B + b] = __fmul_rn(__ldg(disc + t), profit);
        demo[(long long)t * B + b] = d;
      }
    } else if (drawer && t + 1 < T) {
      draw_ahead<true, LANES>(p, L, table, user_d, seed, lane0, t + 1, smem);
    }
  }
  if (live)
    for (int i = 0; i < m1; ++i) invo[((long long)T * m1 + i) * B + b] = l.s.inv[i];
}

// Launch one kernel instance on the tile L names: the grid of
// ceil(B / lanes) blocks of L.threads threads and L.s_total floats of
// dynamic shared memory, and ``extra`` bytes after them (the chain's
// records).
template <typename Kernel, typename... Args>
int launch_tile(Kernel kernel, const Lstm& L, long long B, cudaStream_t stream, size_t extra,
                Args... args) {
  const size_t smem = (size_t)L.s_total * sizeof(float) + extra;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + L.lanes - 1) / L.lanes);
  kernel<<<blocks, L.threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <bool DUMP, bool BACKLOG, class PP>
int launch_returns(const PP& p, const Lstm& L, const float* w, const float* table,
                   const int* user_d, const float* disc, float* out, int* acts, int* dems,
                   unsigned seed, long long B, int T, cudaStream_t stream) {
#define LSTM_RETURNS_TILE(N, W)                                                         \
  if (L.lanes == N && L.warps_m == W && L.threads == N * W)                             \
    return launch_tile(k_im_lstm_returns<N, W, DUMP, BACKLOG, PP>, L, B, stream,        \
                       im_chain_bytes(p, 0), p, L, w, table, user_d, disc, out, acts, dems,   \
                       seed, B, T);
  LSTM_TILES(LSTM_RETURNS_TILE)
#undef LSTM_RETURNS_TILE
  return (int)cudaErrorInvalidConfiguration;
}

template <bool BACKLOG, class PP>
int launch_traj(const PP& p, const Lstm& L, const float* w, const float* table,
                const int* user_d, const float* disc, int* inv, int* acts, float* raw,
                float* rew, int* dem, unsigned seed, long long B, int T,
                cudaStream_t stream) {
#define LSTM_TRAJ_TILE(N, W)                                                            \
  if (L.lanes == N && L.warps_m == W && L.threads == N * W)                             \
    return launch_tile(k_im_lstm_traj<N, W, BACKLOG, PP>, L, B, stream,                 \
                       im_chain_bytes(p, 0), p, L, w, table, user_d, disc, inv, acts, raw,    \
                       rew, dem, seed, B, T);
  LSTM_TILES(LSTM_TRAJ_TILE)
#undef LSTM_TRAJ_TILE
  return (int)cudaErrorInvalidConfiguration;
}

// K22/K23 on either route.
template <class PP>
int lstm_returns(const PP* p, const Lstm* L, const float* w, const float* table,
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

// K24 on either route.
template <class PP>
int lstm_rollout_traj(const PP* p, const Lstm* L, const float* w, const float* table,
                      const int* user_d, const float* disc, int* inv, int* acts, float* raw,
                      float* rew, int* dem, unsigned seed, int backlog, long long B, int T,
                      cudaStream_t stream) {
  return backlog ? launch_traj<true>(*p, *L, w, table, user_d, disc, inv, acts, raw, rew, dem,
                                     seed, B, T, stream)
                 : launch_traj<false>(*p, *L, w, table, user_d, disc, inv, acts, raw, rew,
                                      dem, seed, B, T, stream);
}

}  // namespace

extern "C" {

// acts == dems == nullptr: returns only (K22); otherwise also the streams (K23).
int im_lstm_returns(const ImParams* p, const Lstm* L, const float* w, const float* table,
                    const int* user_d, const float* disc, float* out, int* acts, int* dems,
                    unsigned seed, int backlog, long long B, int T, cudaStream_t stream) {
  return lstm_returns(p, L, w, table, user_d, disc, out, acts, dems, seed, backlog, B, T,
                      stream);
}

int im_lstm_rollout_traj(const ImParams* p, const Lstm* L, const float* w,
                         const float* table, const int* user_d, const float* disc, int* inv,
                         int* acts, float* raw, float* rew, int* dem, unsigned seed,
                         int backlog, long long B, int T, cudaStream_t stream) {
  return lstm_rollout_traj(p, L, w, table, user_d, disc, inv, acts, raw, rew, dem, seed,
                           backlog, B, T, stream);
}

// K22/K23 on the chain route (the lanes' state in p->ws).
int im_lstm_returns_chain(const ImParamsG* p, const Lstm* L, const float* w, const float* table,
                          const int* user_d, const float* disc, float* out, int* acts,
                          int* dems, unsigned seed, int backlog, long long B, int T,
                          cudaStream_t stream) {
  return lstm_returns(p, L, w, table, user_d, disc, out, acts, dems, seed, backlog, B, T,
                      stream);
}

// K24 on the chain route (the lanes' state in p->ws).
int im_lstm_rollout_traj_chain(const ImParamsG* p, const Lstm* L, const float* w,
                               const float* table, const int* user_d, const float* disc,
                               int* inv, int* acts, float* raw, float* rew, int* dem,
                               unsigned seed, int backlog, long long B, int T,
                               cudaStream_t stream) {
  return lstm_rollout_traj(p, L, w, table, user_d, disc, inv, acts, raw, rew, dem, seed,
                           backlog, B, T, stream);
}

}  // extern "C"
