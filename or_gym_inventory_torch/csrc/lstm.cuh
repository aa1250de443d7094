// The folded LSTM actor as the recurrent policy kernels run it, one block
// over a tile of kLstmLanes lanes, shared by the InvManagement LSTM kernels
// (im_lstm.cu K22-K24). It replaces the in-kernel encoder, cell and mean
// head of pallas_episode_kernels._im_lstm_kernel (:1391-1403) and
// _im_lstm_traj_kernel (:1519-1532), which ran them as MXU matmuls over a
// (rows, lanes) tile with the (hidden, lanes) carry in VMEM.
//
// What bounds it: operations. Per env-step the gates are 2 (enc + h) 4h
// FLOPs (196,608 at encoder 64 and hidden 128), the encoder 2 obs enc and
// the head 2 h act more; the env step and the draws are ~1% of that. The
// folded actor at that width is ~400 KB, more than the shared memory of a
// block (227 KB), so the whole-actor-in-shared-memory design of mlp.cuh does
// not carry over. Instead each block runs 32 lanes as a small matrix
// product per period, the lanes as columns:
//
// - Shared memory holds the activations as [row][lane] (kLstmLanes
//   columns): the observation and the encoder's ping-pong buffers, the
//   encoder's output E, the hidden state H twice (old and new, since every
//   unit reads all of the old H), the mean head's outputs and the normals.
//   ~45 KB at the benchmark widths, so several blocks share an SM.
// - The gate phase is register-tiled: a thread owns 4 units x 4 lanes, so
//   its 64 accumulators (4 gates each) and the cell state C of those 16
//   (unit, lane) pairs stay in registers for the whole episode. Per input
//   row k it reads the 4 lanes' activations (one 16-byte shared load) and
//   the 4 units' gate weights (four 16-byte loads: the wrapper packs the
//   weights as (enc + h, h, 4), so one load brings one unit's four gates)
//   for 64 FMAs. The weights stream from L2 through the read-only path.
// - The encoder and the mean head are short dot products, one (output,
//   lane) per thread in turn.
//
// Rounding: the sums run in another order than the plain version's matmuls
// and with FMA, and expf/tanhf may differ from the CPU's by an ulp, so the
// actor's outputs agree with the plain version to ~1e-6 relative; the cell
// update and the head's sample round each operation alone, as torch does.
// The wrapper (ops/episode_kernels.py _pack_lstm_actor, whose ctypes mirror
// _Lstm must match struct Lstm field for field) packs the buffer, computes
// the shared-memory layout and raises for an actor beyond the maxima.
#pragma once

#include <cuda_runtime.h>

#define LSTM_MAX_ENC 4
#define LSTM_MAX_ACT 8

constexpr int kLstmLanes = 32;  // lanes a block runs: the activations' columns

// The actor's shape, its offsets in the packed float buffer, and the
// block's shared-memory layout (float offsets), as the wrapper packs them.
struct Lstm {
  int n_enc;
  int dims[LSTM_MAX_ENC + 1];  // dims[0] = obs_dim, dims[l + 1] = encoder width l
  int hidden, act;
  int w_enc[LSTM_MAX_ENC], b_enc[LSTM_MAX_ENC];  // W (out, in), b (out)
  int w_gate, b_gate;          // (enc + h, h, 4) and (h, 4)
  int w_mean, b_mean, std;     // (act, h), (act), (act) or -1
  int threads;                 // block size: max(h/4 * kLstmLanes/4, kLstmLanes)
  int s_h0, s_h1, s_e, s_x0, s_x1, s_m, s_z, s_total;
  float half_hi[LSTM_MAX_ACT];  // per action, f32(0.5 * (high - low))
};

namespace {

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// The encoder: x0 (the obs rows, written by the lane threads) through the
// tanh layers into E. Ends with a barrier.
__device__ __forceinline__ void lstm_encoder(const Lstm& L, const float* __restrict__ w,
                                             float* smem) {
  const float* in = smem + L.s_x0;
  for (int l = 0; l < L.n_enc; ++l) {
    const int ni = L.dims[l], no = L.dims[l + 1];
    float* out = smem + (l == L.n_enc - 1 ? L.s_e : (l & 1) ? L.s_x0 : L.s_x1);
    const float* W = w + L.w_enc[l];
    const float* b = w + L.b_enc[l];
    for (int idx = threadIdx.x; idx < no * kLstmLanes; idx += blockDim.x) {
      const int o = idx / kLstmLanes, n = idx - o * kLstmLanes;
      const float* Wo = W + o * ni;
      float acc = 0.f;
      for (int k = 0; k < ni; ++k) acc = fmaf(__ldg(Wo + k), in[k * kLstmLanes + n], acc);
      out[idx] = tanhf(acc + __ldg(b + o));
    }
    __syncthreads();
    in = out;
  }
}

// acc[u][g][l] += W[k][unit u][gate g] * x[k][lane l] over nx input rows.
__device__ __forceinline__ void gate_rows(const float4* __restrict__ wk, int h,
                                          const float* x, int nx, int lg,
                                          float (&acc)[4][4][4]) {
#pragma unroll 2
  for (int k = 0; k < nx; ++k) {
    const float4 xv = *reinterpret_cast<const float4*>(x + k * kLstmLanes + 4 * lg);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 wv = __ldg(wk + k * h + u);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        acc[u][0][l] = fmaf(wv.x, xs[l], acc[u][0][l]);
        acc[u][1][l] = fmaf(wv.y, xs[l], acc[u][1][l]);
        acc[u][2][l] = fmaf(wv.z, xs[l], acc[u][2][l]);
        acc[u][3][l] = fmaf(wv.w, xs[l], acc[u][3][l]);
      }
    }
  }
}

// The gates and the cell for this thread's 4 units x 4 lanes: reads E and
// the old H, updates its C (registers) and writes its part of the new H.
// No barrier inside; the caller synchronises after it.
__device__ __forceinline__ void lstm_cell(const Lstm& L, const float* __restrict__ w,
                                          const float* smem, const float* hold,
                                          float* hnew, float (&c)[4][4]) {
  const int h = L.hidden;
  const int ug = threadIdx.x / (kLstmLanes / 4), lg = threadIdx.x % (kLstmLanes / 4);
  if (ug >= h / 4) return;
  const float4* bg = reinterpret_cast<const float4*>(w + L.b_gate) + 4 * ug;
  float acc[4][4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 bv = __ldg(bg + u);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      acc[u][0][l] = bv.x;
      acc[u][1][l] = bv.y;
      acc[u][2][l] = bv.z;
      acc[u][3][l] = bv.w;
    }
  }
  const int ne = L.n_enc ? L.dims[L.n_enc] : L.dims[0];
  const float4* wk = reinterpret_cast<const float4*>(w + L.w_gate) + 4 * ug;
  gate_rows(wk, h, smem + L.s_e, ne, lg, acc);
  gate_rows(wk + ne * h, h, hold, h, lg, acc);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float hv[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float ig = sigmoidf(acc[u][0][l]), fg = sigmoidf(acc[u][1][l]);
      const float gg = tanhf(acc[u][2][l]), og = sigmoidf(acc[u][3][l]);
      c[u][l] = __fadd_rn(__fmul_rn(fg, c[u][l]), __fmul_rn(ig, gg));
      hv[l] = __fmul_rn(og, tanhf(c[u][l]));
    }
    *reinterpret_cast<float4*>(hnew + (4 * ug + u) * kLstmLanes + 4 * lg) =
        make_float4(hv[0], hv[1], hv[2], hv[3]);
  }
}

// The mean head on the new H into m ([act][lane]). No barrier inside.
__device__ __forceinline__ void lstm_head(const Lstm& L, const float* __restrict__ w,
                                          const float* hnew, float* m) {
  const int h = L.hidden;
  for (int idx = threadIdx.x; idx < L.act * kLstmLanes; idx += blockDim.x) {
    const int i = idx / kLstmLanes, n = idx - i * kLstmLanes;
    const float* Wi = w + L.w_mean + i * h;
    float acc = 0.f;
    for (int j = 0; j < h; ++j) acc = fmaf(__ldg(Wi + j), hnew[j * kLstmLanes + n], acc);
    m[idx] = acc + __ldg(w + L.b_mean + i);
  }
}

// One period of the actor for the block's lanes, the obs already in x0:
// encoder, cell and head, with the barriers between them; swaps the H
// buffers. On return m holds the means.
__device__ __forceinline__ void lstm_forward(const Lstm& L, const float* __restrict__ w,
                                             float* smem, float*& hold, float*& hnew,
                                             float (&c)[4][4]) {
  __syncthreads();  // the obs rows are in
  lstm_encoder(L, w, smem);
  lstm_cell(L, w, smem, hold, hnew, c);
  __syncthreads();
  lstm_head(L, w, hnew, smem + L.s_m);
  __syncthreads();
  float* tmp = hold;
  hold = hnew;
  hnew = tmp;
}

// Zero C and the first H; returns through hold/hnew the two H buffers.
__device__ __forceinline__ void lstm_reset(const Lstm& L, float* smem, float*& hold,
                                           float*& hnew, float (&c)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int l = 0; l < 4; ++l) c[u][l] = 0.f;
  hold = smem + L.s_h0;
  hnew = smem + L.s_h1;
  for (int k = threadIdx.x; k < L.hidden * kLstmLanes; k += blockDim.x) hold[k] = 0.f;
}

}  // namespace
