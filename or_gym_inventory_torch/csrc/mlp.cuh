// The folded MLP actor as the policy kernels run it, one forward pass per
// thread, shared by the NetInvMgmt policy kernels (net_policy.cu K4-K6) and
// the InvManagement trajectory kernel (im_policy.cu K10). It replaces the
// in-kernel pallas_episode_kernels.mlp_forward (:1124).
//
// The folded actor (obs normalisation already in layer 1) is copied once per
// block into shared memory, each layer as W^T (in, out16) row-major, then b
// (out16), the outputs zero-padded to a multiple of 16; then the clipped std
// when stochastic. Each thread runs its own forward pass as a plain FMA loop
// over 16 outputs at a time, the 16 sums in registers; the 16 weights of
// one input are read as four 16-byte broadcasts (every thread of the block
// reads the same address). The activations live in shared memory too, one
// column per thread ([row][thread], conflict-free), two buffers of
// max(obs_dim, out16) rows. The wrapper (ops/episode_kernels.py
// _pack_actor, whose ctypes mirror must match struct Mlp field for field)
// packs the buffer and raises for an actor beyond the maxima or the shared
// memory of a block.
#pragma once

#include <cuda_runtime.h>

#include "launch.cuh"

#define MLP_MAX_LAYERS 8
#define MLP_MAX_ACT 32

// The actor's shape as the wrapper packs it.
struct Mlp {
  int n_layers;
  int dims[MLP_MAX_LAYERS + 1];  // dims[0] = obs_dim, dims[n_layers] = act_dim
  int act_rows;                  // rows of each activation buffer
  float half_hi[MLP_MAX_ACT];    // per action, f32(0.5 * (high - low))
};

namespace {

constexpr int kChunk = 16;  // outputs summed at once, in registers
// launch.cuh's kThreads threads per block: one activation column each

__device__ __forceinline__ int pad16(int n) { return (n + kChunk - 1) & ~(kChunk - 1); }

// Element i of this thread's activation column.
__device__ __forceinline__ float& col(float* a, int i) { return a[i * kThreads]; }

// The pre-squash mean (pallas_episode_kernels.mlp_forward): tanh after every
// layer but the last. h0 holds the observation; returns the activation
// column that holds the act_dim outputs.
__device__ __forceinline__ float* mlp_forward(const Mlp& m, const float* w,
                                              float* h0, float* h1) {
  float* in = h0;
  float* out = h1;
  for (int l = 0; l < m.n_layers; ++l) {
    const int ni = m.dims[l], nop = pad16(m.dims[l + 1]);
    const float* W = w;  // (ni, nop)
    const float* b = w + ni * nop;
    w = b + nop;
    const bool last = l == m.n_layers - 1;
    for (int o0 = 0; o0 < nop; o0 += kChunk) {
      float acc[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) acc[k] = 0.f;
      for (int i = 0; i < ni; ++i) {
        const float x = col(in, i);
        const float4* row = reinterpret_cast<const float4*>(W + i * nop + o0);
#pragma unroll
        for (int q = 0; q < kChunk / 4; ++q) {
          const float4 v = row[q];
          acc[4 * q] = fmaf(v.x, x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, x, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, x, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, x, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float z = acc[k] + b[o0 + k];
        col(out, o0 + k) = last ? z : tanhf(z);
      }
    }
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

// Shared memory: the packed actor (n_params floats, 16-byte aligned), then
// the two activation buffers of act_rows x kThreads. Returns this thread's
// two activation columns through h0 and h1.
__device__ __forceinline__ float* load_params(const Mlp& m, const float* params,
                                              int n_params, float*& h0, float*& h1) {
  extern __shared__ float4 smem[];
  float* sw = reinterpret_cast<float*>(smem);
  for (int k = threadIdx.x; k < n_params; k += blockDim.x) sw[k] = __ldg(params + k);
  __syncthreads();
  h0 = sw + ((n_params + 3) & ~3) + threadIdx.x;
  h1 = h0 + m.act_rows * kThreads;
  return sw;
}

size_t smem_bytes(const Mlp& m, int n_params) {
  return (size_t)(((n_params + 3) & ~3) + 2 * m.act_rows * kThreads) * sizeof(float);
}

}  // namespace
