// The folded LSTM actor as the recurrent policy kernels run it, one block
// over a tile of LANES lanes, shared by the InvManagement LSTM kernels
// (K22-K24: im_lstm.cu on the fixed class, im_lstm_any.cu on the general). It replaces the in-kernel encoder, cell and mean
// head of pallas_episode_kernels._im_lstm_kernel (:1391-1403) and
// _im_lstm_traj_kernel (:1519-1532), which ran them as MXU matmuls over a
// (rows, lanes) tile with the (hidden, lanes) carry in VMEM.
//
// What bounds it: the gate product G = W [E; H] + b, 2 (enc + h) 4h FLOPs an
// env-step (196,608 at encoder 64 and hidden 128, 97% of the actor). It
// runs on the tensor cores: mma.sync m16n8k8 in TF32, as three products
// (3xTF32) so that the sums keep FP32's accuracy (mma_tf32.cuh, which
// holds the split, the products and the quiet-NaN rule, shared with
// mlp_tile.cuh).
//
// - The tile: a block runs LANES lanes (64 at the benchmark widths) with
//   WM x WN warps, WN = LANES / 32 along the lanes (a warp owns 4 n-tiles of
//   8 lanes) and WM along the units. The units go in groups of 8 ("unit
//   groups"); a group's four gates are two 16-row M-tiles, [i; f] and
//   [g; o], so that each thread's accumulators hold all four gates of one
//   unit for two lanes, and the cell runs on them in place. A warp walks
//   its unit groups (ug = wm, wm + WM, ...) one at a time: 2 x 4 tiles of
//   accumulators live, and the cell state C of all its groups stays in
//   registers for the whole episode, in the accumulator layout.
// - The weights: the wrapper packs W as the A fragments themselves (fp32,
//   (M-tile, k-step, lane) -> float4 {a0, a1, a2, a3}), so a warp loads a
//   fragment with one coalesced 16-byte load per thread through the
//   read-only path and splits it in registers. The WN warps of one wm load
//   the same fragments close together in time, so that each 16 bytes fetched
//   from L2 can serve LANES lanes through L1 (2x the first version's 32).
//   Whether they do is not measured (no counters on the card). A tile of
//   128 lanes (one block an SM) was slower, and reading every fragment
//   from shared memory, copies free, saved 8.5% of the actor's time
//   (tools/lstm_tile_sweep.py); staging buffers beside this layout would
//   leave one block an SM, so they were not built.
// - Shared memory holds every activation as [row][lane], rows of
//   stride = LANES + 8 floats, so that a B-fragment load (rows tig, tig + 4;
//   lanes gid) and the cell's float2 store of H hit 32 banks: the encoder's
//   output E (rows padded to 8 with zeros), the hidden state H twice (old
//   and new: every unit reads all of the old H), the obs and the encoder's
//   ping-pong buffers, the mean head's outputs, and two buffers of the
//   draws (each the normals and the demand, im_lstm.cu draw_ahead). ~104 KB
//   at the benchmark widths and 64 lanes: two blocks an SM.
// - Not kept: wgmma (m64n64k8, a warpgroup per 64 gate rows, E and H split
//   in its K-major shared-memory layout) ran slower than this tile: at 64
//   lanes each warpgroup has only two accumulator chains of 72 dependent
//   products a period, too few to hide their latency, and the split
//   buffers left one block an SM.
// - The encoder runs the same way, a layer's outputs in M-tiles of 16 (2% of
//   the FLOPs; as FP32 dot products it took a fifth of the kernel's time).
//   The mean head (act x h) stays FP32 dot products, one (output, lane) per
//   thread in turn.
//
// Rounding: the sums run in another order than the plain version's matmuls
// and with the tensor cores' FP32 accumulation, and expf/tanhf may differ
// from the CPU's by an ulp, so the actor's outputs agree with the plain
// version to ~1e-6 relative; the cell update and the head's sample round
// each operation alone, as torch does. A lane's sums do not depend on the
// tile, so every tile gives the same bits. The wrapper
// (ops/episode_kernels.py _pack_lstm_actor, whose ctypes mirror _Lstm must
// match struct Lstm field for field) packs the buffer, picks the tile,
// computes the shared-memory layout and raises for an actor beyond the
// maxima (LSTM_MAX_ACT binds only the fixed route's half_hi: the chain
// route, past IM_MAX_M1 stages, takes the half ranges from its records).
//
// Two classes of actor, as mlp_tile.cuh has two. An actor within Lstm's
// arrays (LSTM_MAX_ENC encoder layers, a hidden width that is a multiple of
// 4 and at most 8 LSTM_MAX_GROUPS, LSTM_MAX_ACT actions on the fixed route)
// whose layout fits a block takes Lstm, the struct of fixed arrays in the
// kernel parameters, with C in registers. Any other takes LstmG (any
// encoder depth and width, any hidden width of at least 1, padded to the
// unit groups of 8 with zero weights, any action count): the encoder's layer
// table and half_hi lie in the packed buffer, read with __ldg; C is a region
// of its own beside H ([unit][lane], each thread reading and writing only
// its own accumulator positions), and a warp walks its unit groups in a
// loop. Where the regions fit no block even at 32 lanes they move to the
// block's slice of a device workspace (LstmG.ws, rows ``lanes`` floats
// apart) on a persistent grid, LstmG.grid blocks each walking tiles
// blockIdx.x, + grid, ..., the chain route's records staying in shared
// memory. The products, the cell's roundings and the head are the fixed
// class's, so an actor that both classes take gives the same bits.
#pragma once

#include <cuda_runtime.h>

#include "mma_tf32.cuh"

#define LSTM_MAX_ENC 4
#define LSTM_MAX_ACT 8
#define LSTM_MAX_GROUPS 16  // unit groups of 8: hidden <= 128

// The actor's shape, its offsets in the packed float buffer, the tile and
// the block's shared-memory layout (float offsets), as the wrapper packs
// them.
struct Lstm {
  int n_enc;
  int dims[LSTM_MAX_ENC + 1];  // dims[0] = obs_dim, dims[l + 1] = encoder width l
  int hidden, act;
  int w_enc[LSTM_MAX_ENC], b_enc[LSTM_MAX_ENC];  // A fragments, b (out padded to 16)
  int w_gate, b_gate;          // the A fragments; the biases (h_pad, 4)
  int w_mean, b_mean, std;     // (act, h), (act), (act) or -1
  int lanes, warps_m, threads; // the tile: lanes a block, warps along the units
  int e_pad, h_pad, k_steps;   // gate inputs and units padded; (e_pad + h_pad) / 8
  int stride;                  // floats a row of every activation buffer
  int s_e, s_h0, s_h1, s_x0, s_x1, s_m, s_z, s_total;
  float half_hi[LSTM_MAX_ACT];  // per action, f32(0.5 * (high - low)); the chain
                                // route (im_lstm.cu) reads the records' instead
};

// The general class, as the wrapper packs it (_pack_lstm_actor, mirrored by
// _LstmG): the regions' float offsets from the activation base (shared
// memory, or the block's slice of ws).
struct LstmG {
  float* ws;                   // the workspace, or nullptr: the activations in shared memory
  int n_enc;
  int table;                   // encoder layer l's int4 {in, out, w, b} at w + table + 4 l
  int half_hi;                 // per action, f32(0.5 * (high - low)) at w + half_hi
  int hidden, act;
  int w_gate, b_gate;          // the A fragments; the biases (h_pad, 4)
  int w_mean, b_mean, std;     // (act, h), (act), (act) or -1
  int lanes, warps_m, threads; // the tile: lanes a block, warps along the units
  int e_pad, h_pad, k_steps;   // gate inputs and units padded; (e_pad + h_pad) / 8
  int stride;                  // floats a row of every activation region
  int s_e, s_h0, s_h1, s_c, s_x0, s_x1, s_m, s_z, s_total;
  int smem_floats;             // floats of the regions in shared memory (0 on the workspace)
  int ws_floats;               // floats of a block's slice of ws
  int grid;                    // blocks of the launch (each walks tiles blockIdx.x + k grid)
};

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// The encoder: x0 (the obs rows, written by the lane threads) through the
// tanh layers into E, each layer a product on the tensor cores like the
// gates' (mma_tf32.cuh mma_layer_tiles): the warp's M-tiles of 16 outputs
// (mt = wm, wm + WM, ...) over its 32 lanes, K = the layer's inputs padded
// to 8 (zero rows), outputs padded to 16 (zero weights and bias, so tanh
// writes 0). Ends with a barrier.
template <int WM>
__device__ __forceinline__ void lstm_encoder(const Lstm& L, const float* __restrict__ w,
                                             float* smem) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const float* in = smem + L.s_x0;
  for (int l = 0; l < L.n_enc; ++l) {
    const int ks_n = (L.dims[l] + 7) / 8, mt_n = (L.dims[l + 1] + 15) / 16;
    float* out = smem + (l == L.n_enc - 1 ? L.s_e : (l & 1) ? L.s_x0 : L.s_x1);
    const float4* frag = reinterpret_cast<const float4*>(w + L.w_enc[l]);
    for (int mt = wm; mt < mt_n; mt += WM)
      mma_layer_tiles<1, true>(frag, w + L.b_enc[l], mt, ks_n, in, out, L.stride, 32 * wn);
    __syncthreads();
    in = out;
  }
}

__host__ __device__ constexpr int lstm_groups_per_warp(int wm) {
  return (LSTM_MAX_GROUPS + wm - 1) / wm;
}

// The gates and the cell of this warp's unit groups for its 32 lanes: reads
// E and the old H, updates its C (registers, c[group][n-tile][lane pair])
// and writes its part of the new H. No barrier inside; the caller
// synchronises after it.
template <int LANES, int WM>
__device__ __forceinline__ void lstm_cell(const Lstm& L, const float* __restrict__ w,
                                          const float* smem, const float* hold, float* hnew,
                                          float (&c)[lstm_groups_per_warp(WM)][4][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tig = lane & 3;
  const int S = L.stride, col = 32 * wn + gid, ke = L.e_pad / 8, kh = L.h_pad / 8;
  const float* e = smem + L.s_e;
  const float4* frag = reinterpret_cast<const float4*>(w + L.w_gate) + lane;
  const float4* bias = reinterpret_cast<const float4*>(w + L.b_gate);
#pragma unroll
  for (int j = 0; j < lstm_groups_per_warp(WM); ++j) {
    const int ug = wm + j * WM;
    if (ug >= kh) break;
    const float4 b = __ldg(bias + 8 * ug + gid);  // i, f, g, o of unit 8 ug + gid
    float acc[2][4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[0][nt][0] = acc[0][nt][1] = b.x;
      acc[0][nt][2] = acc[0][nt][3] = b.y;
      acc[1][nt][0] = acc[1][nt][1] = b.z;
      acc[1][nt][2] = acc[1][nt][3] = b.w;
    }
    mma_rows<2>(frag + (size_t)(2 * ug) * L.k_steps * 32, L.k_steps * 32, L.k_steps, ke, e,
                hold, S, col, tig, acc);
    float* hrow = hnew + (8 * ug + gid) * S + 32 * wn + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float hv[2];
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const float ig = sigmoidf(acc[0][nt][l]), fg = sigmoidf(acc[0][nt][2 + l]);
        const float gg = tanhf(acc[1][nt][l]), og = sigmoidf(acc[1][nt][2 + l]);
        c[j][nt][l] = __fadd_rn(__fmul_rn(fg, c[j][nt][l]), __fmul_rn(ig, gg));
        hv[l] = keep_nan(__fmul_rn(og, tanhf(c[j][nt][l])));
      }
      *reinterpret_cast<float2*>(hrow + 8 * nt) = make_float2(hv[0], hv[1]);
    }
  }
}

// The mean head on the new H into m ([act][lane]). No barrier inside.
template <int LANES, class LS>
__device__ __forceinline__ void lstm_head(const LS& L, const float* __restrict__ w,
                                          const float* hnew, float* m) {
  const int h = L.hidden, S = L.stride;
  for (int idx = threadIdx.x; idx < L.act * LANES; idx += blockDim.x) {
    const int i = idx / LANES, n = idx - i * LANES;
    const float* Wi = w + L.w_mean + i * h;
    float acc = 0.f;
    for (int j = 0; j < h; ++j) acc = fmaf(__ldg(Wi + j), hnew[j * S + n], acc);
    m[i * S + n] = acc + __ldg(w + L.b_mean + i);
  }
}

// One period of the actor for the block's lanes, the obs already in x0:
// encoder, cell and head, with the barriers between them; swaps the H
// buffers. On return m holds the means.
template <int LANES, int WM>
__device__ __forceinline__ void lstm_forward(const Lstm& L, const float* __restrict__ w,
                                             float* smem, float*& hold, float*& hnew,
                                             float (&c)[lstm_groups_per_warp(WM)][4][2]) {
  __syncthreads();  // the obs rows are in
  lstm_encoder<WM>(L, w, smem);
  lstm_cell<LANES, WM>(L, w, smem, hold, hnew, c);
  __syncthreads();
  lstm_head<LANES>(L, w, hnew, smem + L.s_m);
  __syncthreads();
  float* tmp = hold;
  hold = hnew;
  hnew = tmp;
}

// Zero C and every activation buffer (the first H, and the rows that pad E
// and H to 8, which stay zero); returns through hold/hnew the two H
// buffers.
template <int WM>
__device__ __forceinline__ void lstm_reset(const Lstm& L, float* smem, float*& hold,
                                           float*& hnew,
                                           float (&c)[lstm_groups_per_warp(WM)][4][2]) {
#pragma unroll
  for (int j = 0; j < lstm_groups_per_warp(WM); ++j)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) c[j][nt][0] = c[j][nt][1] = 0.f;
  hold = smem + L.s_h0;
  hnew = smem + L.s_h1;
  for (int k = threadIdx.x; k < L.s_total; k += blockDim.x) smem[k] = 0.f;
}

// ---------------------------------------------------------------- LstmG

// The activation base: shared memory, or the block's slice of the workspace.
__device__ __forceinline__ float* lstm_acts(const LstmG& L, float* smem) {
  return L.ws ? L.ws + (long long)blockIdx.x * L.ws_floats : smem;
}

// lstm_encoder for the general class: the layer table from the buffer.
template <int WM>
__device__ __forceinline__ void lstm_encoder_g(const LstmG& L, const float* __restrict__ w,
                                               float* acts) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const float* in = acts + L.s_x0;
  for (int l = 0; l < L.n_enc; ++l) {
    const int4 ly = __ldg(reinterpret_cast<const int4*>(w + L.table) + l);
    const int ks_n = (ly.x + 7) / 8, mt_n = (ly.y + 15) / 16;
    float* out = acts + (l == L.n_enc - 1 ? L.s_e : (l & 1) ? L.s_x0 : L.s_x1);
    const float4* frag = reinterpret_cast<const float4*>(w + ly.z);
    for (int mt = wm; mt < mt_n; mt += WM)
      mma_layer_tiles<1, true>(frag, w + ly.w, mt, ks_n, in, out, L.stride, 32 * wn);
    __syncthreads();
    in = out;
  }
}

// lstm_cell for the general class: the warp's unit groups in a loop, C read
// from and written back to its region at the positions H takes (a thread's
// own: unit 8 ug + gid, lanes 32 wn + 2 tig + 8 nt + {0, 1}).
template <int WM>
__device__ __forceinline__ void lstm_cell_g(const LstmG& L, const float* __restrict__ w,
                                            float* acts, const float* hold, float* hnew) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tig = lane & 3;
  const int S = L.stride, col = 32 * wn + gid, ke = L.e_pad / 8, kh = L.h_pad / 8;
  const float* e = acts + L.s_e;
  const float4* frag = reinterpret_cast<const float4*>(w + L.w_gate) + lane;
  const float4* bias = reinterpret_cast<const float4*>(w + L.b_gate);
  for (int ug = wm; ug < kh; ug += WM) {
    const float4 b = __ldg(bias + 8 * ug + gid);  // i, f, g, o of unit 8 ug + gid
    float acc[2][4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[0][nt][0] = acc[0][nt][1] = b.x;
      acc[0][nt][2] = acc[0][nt][3] = b.y;
      acc[1][nt][0] = acc[1][nt][1] = b.z;
      acc[1][nt][2] = acc[1][nt][3] = b.w;
    }
    mma_rows<2>(frag + (size_t)(2 * ug) * L.k_steps * 32, L.k_steps * 32, L.k_steps, ke, e,
                hold, S, col, tig, acc);
    const int at = (8 * ug + gid) * S + 32 * wn + 2 * tig;
    float* hrow = hnew + at;
    float* crow = acts + L.s_c + at;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 cv = *reinterpret_cast<const float2*>(crow + 8 * nt);
      float c[2] = {cv.x, cv.y}, hv[2];
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const float ig = sigmoidf(acc[0][nt][l]), fg = sigmoidf(acc[0][nt][2 + l]);
        const float gg = tanhf(acc[1][nt][l]), og = sigmoidf(acc[1][nt][2 + l]);
        c[l] = __fadd_rn(__fmul_rn(fg, c[l]), __fmul_rn(ig, gg));
        hv[l] = keep_nan(__fmul_rn(og, tanhf(c[l])));
      }
      *reinterpret_cast<float2*>(crow + 8 * nt) = make_float2(c[0], c[1]);
      *reinterpret_cast<float2*>(hrow + 8 * nt) = make_float2(hv[0], hv[1]);
    }
  }
}

// lstm_forward for the general class, on the regions from ``acts``.
template <int LANES, int WM>
__device__ __forceinline__ void lstm_forward_g(const LstmG& L, const float* __restrict__ w,
                                               float* acts, float*& hold, float*& hnew) {
  __syncthreads();  // the obs rows are in
  lstm_encoder_g<WM>(L, w, acts);
  lstm_cell_g<WM>(L, w, acts, hold, hnew);
  __syncthreads();
  lstm_head<LANES>(L, w, hnew, acts + L.s_m);
  __syncthreads();
  float* tmp = hold;
  hold = hnew;
  hnew = tmp;
}

// lstm_reset for the general class: every region zero, C among them.
__device__ __forceinline__ void lstm_reset_g(const LstmG& L, float* acts, float*& hold,
                                             float*& hnew) {
  hold = acts + L.s_h0;
  hnew = acts + L.s_h1;
  for (int k = threadIdx.x; k < L.s_total; k += blockDim.x) acts[k] = 0.f;
}

}  // namespace
