// The InvManagement LSTM kernels K22-K24 on the general actor class (lstm.cuh
// LstmG: any encoder depth and width, any hidden width of at least 1, any
// action count), for Hopper (sm_90a), bound with ctypes by ops/_build.py
// and wrapped by ops/episode_kernels.py (the same wrappers as im_lstm.cu's
// fixed class, which pick the class by the actor). They replace the same
// JAX sites as im_lstm.cu's kernels, at the actors that class refuses:
// pallas_episode_kernels._im_lstm_call (:1419, pallas_call :1448) and
// rollout_traj_im_lstm (:1551, pallas_call :1592), whose weights went whole
// into VMEM at any width.
//
// k_im_lstm_returns_g (K22, K23 with DUMP) and k_im_lstm_traj_g (K24) run
// im_lstm.cu's body, the lane side from im_lstm.cuh, on the actor through
// lstm.cuh's general functions: the encoder's layer table from the packed
// buffer, a warp's unit groups in a loop with C in a region beside H, the
// head over any hidden width. Every region lies at an offset from the
// activation base: the block's shared memory where the regions fit it (64
// lanes, else 32), else the block's slice of a device workspace, a
// persistent grid of LstmG.grid blocks walking tiles blockIdx.x, + grid, ...
// The chain route's records stay in shared memory either way (after the
// regions, or alone). Between two tiles a barrier: the last period's reads
// of the means and the draws finish before the next tile's reset. The
// stream, the roundings and the order of every sum are im_lstm.cu's, so an
// actor that both classes take gives the same bits.
//
// The C entry points: *_any on the fixed route (ImParams), *_chain_any on
// the chain route (ImParamsG), with the arguments of im_lstm.cu's.

#include "im_lstm.cuh"

namespace {

// The tiles compiled: (lanes a block, warps along the units). The wrapper's
// _LSTM_TILES lists the preference among them; the workspace takes the
// first.
#define LSTM_ANY_TILES(X) X(64, 4) X(32, 8)

// K22/K23 on the general class (LstmG): k_im_lstm_returns's body on the
// regions from the activation base, a block walking tiles blockIdx.x, +
// L.grid, ... (one trip where the regions are in shared memory: the grid is
// then a block a tile).
template <int LANES, int WM, bool DUMP, bool BACKLOG, class PP>
__global__ void __launch_bounds__(LANES * WM, lstm_min_blocks(LANES * WM))
    k_im_lstm_returns_g(const __grid_constant__ PP pp, const __grid_constant__ LstmG L,
                        const float* __restrict__ w, const float* __restrict__ table,
                        const int* __restrict__ user_d, const float* __restrict__ disc,
                        float* __restrict__ out, int* __restrict__ acto,
                        int* __restrict__ demo, unsigned seed, long long B, int T) {
  static_assert(WM >= 2, "threads LANES..2 LANES-1 draw ahead");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const auto& p = im_params(pp, reinterpret_cast<int*>(smem + L.smem_floats));  // the records
  float* acts = lstm_acts(L, smem);
  const int n = threadIdx.x, S = L.stride;
  const bool lane = n < LANES, drawer = !lane && n < 2 * LANES;
  const int m1 = p.m1;
  const long long tiles = (B + LANES - 1) / LANES;
  for (long long tile = blockIdx.x; tile < tiles; tile += L.grid) {
    const long long lane0 = tile * LANES, b = lane0 + n;
    const bool live = lane && b < B;
    float *hold, *hnew;
    lstm_reset_g(L, acts, hold, hnew);
    LstmLaneOf<PP> l;
    lstm_lane_init(l, p, pp, b);
    float total = 0.f;
    if (lane) im_reset(p, l.s);
    __syncthreads();  // the reset's zeros are in before the obs rows and draws
    if (drawer) draw_ahead<false, LANES>(p, L, table, user_d, seed, lane0, 0, acts);
    for (int t = 0; t < T; ++t) {
      if (lane) lane_obs(p, l.s, t, l.ah, acts + L.s_x0 + n, S);
      lstm_forward_g<LANES, WM>(L, w, acts, hold, hnew);
      if (lane) {
        const float* buf = acts + L.s_z + (t & 1) * (L.act + 1) * S + n;
        const int d = __float_as_int(buf[L.act * S]);
        lane_act<false>(L, p, w, acts + L.s_m + n, buf, m1, lane_raw(l), l.act);
        if (DUMP && live) {
          for (int i = 0; i < m1; ++i) acto[((long long)t * m1 + i) * B + b] = l.act[i];
          demo[(long long)t * B + b] = d;
        }
        const float profit = lstm_step<BACKLOG>(p, l, t, d);
        total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
      } else if (drawer && t + 1 < T) {
        draw_ahead<false, LANES>(p, L, table, user_d, seed, lane0, t + 1, acts);
      }
    }
    if (live) out[b] = total;
    __syncthreads();  // the last period's reads are done before the next tile's reset
  }
}

// K24 on the general class, as k_im_lstm_returns_g.
template <int LANES, int WM, bool BACKLOG, class PP>
__global__ void __launch_bounds__(LANES * WM, lstm_min_blocks(LANES * WM))
    k_im_lstm_traj_g(const __grid_constant__ PP pp, const __grid_constant__ LstmG L,
                     const float* __restrict__ w, const float* __restrict__ table,
                     const int* __restrict__ user_d, const float* __restrict__ disc,
                     int* __restrict__ invo, int* __restrict__ acto, float* __restrict__ rawo,
                     float* __restrict__ rewo, int* __restrict__ demo, unsigned seed,
                     long long B, int T) {
  static_assert(WM >= 2, "threads LANES..2 LANES-1 draw ahead");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const auto& p = im_params(pp, reinterpret_cast<int*>(smem + L.smem_floats));  // the records
  float* acts = lstm_acts(L, smem);
  const int n = threadIdx.x, S = L.stride;
  const bool lane = n < LANES, drawer = !lane && n < 2 * LANES;
  const int m1 = p.m1;
  const long long tiles = (B + LANES - 1) / LANES;
  for (long long tile = blockIdx.x; tile < tiles; tile += L.grid) {
    const long long lane0 = tile * LANES, b = lane0 + n;
    const bool live = lane && b < B;
    float *hold, *hnew;
    lstm_reset_g(L, acts, hold, hnew);
    LstmLaneOf<PP> l;
    lstm_lane_init(l, p, pp, b);
    if (lane) im_reset(p, l.s);
    __syncthreads();  // the reset's zeros are in before the obs rows and draws
    if (drawer) draw_ahead<true, LANES>(p, L, table, user_d, seed, lane0, 0, acts);
    for (int t = 0; t < T; ++t) {
      if (lane) {
        if (live)
          for (int i = 0; i < m1; ++i) invo[((long long)t * m1 + i) * B + b] = l.s.inv[i];
        lane_obs(p, l.s, t, l.ah, acts + L.s_x0 + n, S);
      }
      lstm_forward_g<LANES, WM>(L, w, acts, hold, hnew);
      if (lane) {
        const float* buf = acts + L.s_z + (t & 1) * (L.act + 1) * S + n;
        const int d = __float_as_int(buf[L.act * S]);
        lane_act<true>(L, p, w, acts + L.s_m + n, buf, m1, lane_raw(l), l.act);
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
        draw_ahead<true, LANES>(p, L, table, user_d, seed, lane0, t + 1, acts);
      }
    }
    if (live)
      for (int i = 0; i < m1; ++i) invo[((long long)T * m1 + i) * B + b] = l.s.inv[i];
    __syncthreads();  // the last period's reads are done before the next tile's reset
  }
}

// Launch one general-class instance: L.grid blocks of L.threads threads,
// L.smem_floats floats of dynamic shared memory and ``extra`` bytes after
// them (the chain's records).
template <typename Kernel, typename... Args>
int launch_tile(Kernel kernel, const LstmG& L, long long, cudaStream_t stream, size_t extra,
                Args... args) {
  const size_t smem = (size_t)L.smem_floats * sizeof(float) + extra;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (L.grid < 1) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)L.grid, L.threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <bool DUMP, bool BACKLOG, class PP>
int launch_returns(const PP& p, const LstmG& L, const float* w, const float* table,
                   const int* user_d, const float* disc, float* out, int* acts, int* dems,
                   unsigned seed, long long B, int T, cudaStream_t stream) {
#define LSTM_RETURNS_TILE_G(N, W)                                                       \
  if (L.lanes == N && L.warps_m == W && L.threads == N * W)                             \
    return launch_tile(k_im_lstm_returns_g<N, W, DUMP, BACKLOG, PP>, L, B, stream,      \
                       im_chain_bytes(p, 0), p, L, w, table, user_d, disc, out, acts, dems,   \
                       seed, B, T);
  LSTM_ANY_TILES(LSTM_RETURNS_TILE_G)
#undef LSTM_RETURNS_TILE_G
  return (int)cudaErrorInvalidConfiguration;
}

template <bool BACKLOG, class PP>
int launch_traj(const PP& p, const LstmG& L, const float* w, const float* table,
                const int* user_d, const float* disc, int* inv, int* acts, float* raw,
                float* rew, int* dem, unsigned seed, long long B, int T,
                cudaStream_t stream) {
#define LSTM_TRAJ_TILE_G(N, W)                                                          \
  if (L.lanes == N && L.warps_m == W && L.threads == N * W)                             \
    return launch_tile(k_im_lstm_traj_g<N, W, BACKLOG, PP>, L, B, stream,               \
                       im_chain_bytes(p, 0), p, L, w, table, user_d, disc, inv, acts, raw,    \
                       rew, dem, seed, B, T);
  LSTM_ANY_TILES(LSTM_TRAJ_TILE_G)
#undef LSTM_TRAJ_TILE_G
  return (int)cudaErrorInvalidConfiguration;
}

// K22/K23 on either route.
template <class PP>
int lstm_returns(const PP* p, const LstmG* L, const float* w, const float* table,
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
int lstm_rollout_traj(const PP* p, const LstmG* L, const float* w, const float* table,
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

// K22/K23 on the general class (the activations in shared memory or in
// L->ws).
int im_lstm_returns_any(const ImParams* p, const LstmG* L, const float* w, const float* table,
                        const int* user_d, const float* disc, float* out, int* acts, int* dems,
                        unsigned seed, int backlog, long long B, int T, cudaStream_t stream) {
  return lstm_returns(p, L, w, table, user_d, disc, out, acts, dems, seed, backlog, B, T,
                      stream);
}

// K24 on the general class.
int im_lstm_rollout_traj_any(const ImParams* p, const LstmG* L, const float* w,
                             const float* table, const int* user_d, const float* disc, int* inv,
                             int* acts, float* raw, float* rew, int* dem, unsigned seed,
                             int backlog, long long B, int T, cudaStream_t stream) {
  return lstm_rollout_traj(p, L, w, table, user_d, disc, inv, acts, raw, rew, dem, seed,
                           backlog, B, T, stream);
}

// K22/K23 on the chain route and the general class.
int im_lstm_returns_chain_any(const ImParamsG* p, const LstmG* L, const float* w,
                              const float* table, const int* user_d, const float* disc,
                              float* out, int* acts, int* dems, unsigned seed, int backlog,
                              long long B, int T, cudaStream_t stream) {
  return lstm_returns(p, L, w, table, user_d, disc, out, acts, dems, seed, backlog, B, T,
                      stream);
}

// K24 on the chain route and the general class.
int im_lstm_rollout_traj_chain_any(const ImParamsG* p, const LstmG* L, const float* w,
                                   const float* table, const int* user_d, const float* disc,
                                   int* inv, int* acts, float* raw, float* rew, int* dem,
                                   unsigned seed, int backlog, long long B, int T,
                                   cudaStream_t stream) {
  return lstm_rollout_traj(p, L, w, table, user_d, disc, inv, acts, raw, rew, dem, seed,
                           backlog, B, T, stream);
}

}  // extern "C"
