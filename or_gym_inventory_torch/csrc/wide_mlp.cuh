// The folded actor of the off-policy learners (SAC, TD3, DDPG) as the
// trajectory kernels' first design runs it, one block over a tile of
// kWideLanes lanes: K27 (im_policy.cu), K28 (nv_policy.cu) and K29
// (net_policy.cu) on their wide route, for an actor whose slice fits no
// CTA of cluster_mlp.cuh (and K29 for a batch of many rounds), where they
// run otherwise; the heads' math
// (offpolicy_head) and noise (offpolicy_noise) are shared with
// cluster_mlp.cuh. It replaces the in-kernel pallas_episode_kernels
// .mlp_forward (:1124) with a relu (or tanh) trunk and the heads of
// traj_policy (:1036-1081): "det", "sac", "uniform", and "ppo" on a relu
// trunk (the PPO head on a tanh trunk stays K4/K10/K18's, mlp_tile.cuh).
//
// What bounds it: operations. The off-policy actor has SB3's default width,
// (256, 256): 76,038 floats (304 KB) for InvManagement's 33 inputs and the
// SAC head's 6 outputs, ~2 x 74,000 FLOPs an env-step. It does not fit the
// shared memory of a block (227 KB) beside mlp.cuh's activation buffers, so
// each block runs kWideLanes = 32 lanes as a small matrix product per
// period, as lstm.cuh does:
//
// - Shared memory holds the activations as [row][lane], two ping-pong
//   buffers of ``rows`` x 32 floats (64 KB at width 256), so three blocks
//   share an SM.
// - Each layer is an (out x in) . (in x 32) product. A thread owns 8
//   outputs x 4 lanes (kWideThreads = 256 threads: 32 output groups x 8
//   lane groups, 256 outputs a pass), its 32 sums in registers. Per input
//   row k it reads the 4 lanes' activations (one 16-byte shared load, a
//   broadcast across the warp's output groups) and the 8 outputs' weights
//   (two 16-byte loads of W^T's row k) for 32 FMAs. The weights are read
//   from global memory through the read-only path: the actor (<= 0.3 MB)
//   stays in L2 and the block's warps share each 128-byte line in L1.
// - The env state of each lane stays with one of threads 0..31, stepped by
//   the family's step header, as in K24; the whole block runs the actor
//   between the lane phases, with a barrier before and after each layer.
//
// FP32 FMAs only, no tensor cores. The layers are packed by the wrapper
// (ops/episode_kernels.py _pack_wide_actor, whose ctypes mirror _WideMlp
// must match struct WideMlp field for field): each layer W^T (in, out8)
// row-major, then b (out8), the outputs zero-padded to a multiple of 8
// (16-byte aligned rows); then the std (act_dim) when the head takes one.
//
// Heads, per lane and action i, on the trunk's outputs H (traj_policy's
// math, each operation rounded alone as the plain version computes it):
//   ppo      raw = H_i + std_i z_i, stored; a_norm = tanh(raw)
//   det      a = clip(tanh(H_i) + std_i z_i, -1, 1), stored and consumed
//   sac      a = tanh(H_i + exp(clip(H_{act+i}, -10, 2)) z_i)
//   uniform  a = 2 u_i - 1 (exact for a 24-bit u); the actor does not run
// where z_i is the Box-Muller normal of the period's u1/u2 words and u_i
// the 24-bit uniform of its u1 word. clip and relu propagate a NaN, as
// jnp.clip and jnp.maximum do (nanmath.cuh).
#pragma once

#include <cuda_runtime.h>

#include "nanmath.cuh"
#include "philox.cuh"

#define WIDE_MAX_LAYERS 8
#define WIDE_MAX_ACT 32

constexpr int kWideLanes = 32;                 // lanes a block runs: the activations' columns
constexpr int kWideThreads = 256;              // output groups x lane groups
constexpr int kWideGroups = kWideLanes / 4;    // lane groups of 4 lanes

enum WideHead { kHeadPpo = 0, kHeadDet = 1, kHeadSac = 2, kHeadUniform = 3 };

// The actor's shape as the wrapper packs it.
struct WideMlp {
  int n_layers;
  int dims[WIDE_MAX_LAYERS + 1];  // dims[0] = obs_dim, dims[n_layers] = outputs
  int rows;                       // rows of each activation buffer
  int act;                        // the env's act_dim
  int head;                       // WideHead
  int std;                        // offset of the std in the buffer, or -1
  float half_hi[WIDE_MAX_ACT];    // per action, f32(0.5 * (high - low))
};

namespace {

__device__ __forceinline__ int pad8(int n) { return (n + 7) & ~7; }

// One layer: out[o][lane] = act(sum_k W^T[k][o] in[k][lane] + b[o]) for the
// block's 32 lanes, o < no8. No barrier inside.
template <bool RELU>
__device__ __forceinline__ void wide_layer(const float* __restrict__ W,
                                           const float* __restrict__ bias, int ni, int no8,
                                           const float* in, float* out, bool hidden) {
  const int lg = threadIdx.x % kWideGroups;
  const int step = (kWideThreads / kWideGroups) * 8;  // outputs a pass
  for (int o0 = (threadIdx.x / kWideGroups) * 8; o0 < no8; o0 += step) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[j][l] = 0.f;
    const float* wr = W + o0;
#pragma unroll 4
    for (int k = 0; k < ni; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(in + k * kWideLanes + 4 * lg);
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wr + (long long)k * no8));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wr + (long long)k * no8 + 4));
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[j][l] = fmaf(ws[j], xs[l], acc[j][l]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bj = __ldg(bias + o0 + j);
      float v[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float z = acc[j][l] + bj;
        v[l] = !hidden ? z : RELU ? max_nan(z, 0.f) : tanhf(z);
      }
      *reinterpret_cast<float4*>(out + (o0 + j) * kWideLanes + 4 * lg) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The trunk and the output layer for the block's lanes, the obs rows already
// in x0 (written by the lane threads): returns the buffer that holds the
// outputs, [row][lane]. Every thread of the block must call it; it starts
// and ends with a barrier.
template <bool RELU>
__device__ __forceinline__ const float* wide_forward(const WideMlp& m,
                                                     const float* __restrict__ w, float* x0,
                                                     float* x1) {
  __syncthreads();  // the obs rows are in
  float* in = x0;
  float* out = x1;
  for (int l = 0; l < m.n_layers; ++l) {
    const int ni = m.dims[l], no8 = pad8(m.dims[l + 1]);
    const float* W = w;
    const float* b = w + (long long)ni * no8;
    w = b + no8;
    wide_layer<RELU>(W, b, ni, no8, in, out, l < m.n_layers - 1);
    __syncthreads();
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

// The head's noise of one (lane, period) from the words after the demand's:
// the act u1 words then the act u2 words as Box-Muller normals, or, for
// "uniform", the act u1 words as 24-bit uniforms.
__device__ __forceinline__ void offpolicy_noise(int head, int act, WordStream& ws, float* z) {
  if (head == kHeadUniform) {
    for (int i = 0; i < act; ++i) z[i] = u01(ws.next());
    return;
  }
  unsigned w1[WIDE_MAX_ACT];
  for (int i = 0; i < act; ++i) w1[i] = ws.next();
  for (int i = 0; i < act; ++i) z[i] = normal01(w1[i], ws.next());
}

__device__ __forceinline__ void wide_noise(const WideMlp& m, WordStream& ws, float* z) {
  offpolicy_noise(m.head, m.act, ws, z);
}

// Action i's head from its output h = H_i, for "sac" also ls = H_{act+i},
// for "ppo" and "det" the std s = std_i, and its noise z: returns a_norm in
// [-1, 1] (the env takes low + (a_norm + 1) half_hi) and the value the
// kernel stores in its raw stream.
__device__ __forceinline__ float offpolicy_head(int head, float h, float ls, float s, float z,
                                                float& store) {
  float a;
  switch (head) {
    case kHeadPpo: {
      const float raw = __fadd_rn(h, __fmul_rn(s, z));
      store = raw;
      return tanhf(raw);
    }
    case kHeadDet:
      a = __fadd_rn(tanhf(h), __fmul_rn(s, z));
      a = min_nan(max_nan(a, -1.f), 1.f);
      break;
    case kHeadSac: {
      const float sd = expf(min_nan(max_nan(ls, -10.f), 2.f));
      a = tanhf(__fadd_rn(h, __fmul_rn(sd, z)));
      break;
    }
    default:
      a = __fsub_rn(__fmul_rn(2.f, z), 1.f);
  }
  store = a;
  return a;
}

// Action i's head (offpolicy_head) for lane column n of the outputs H
// ([row][lane]).
__device__ __forceinline__ float wide_head(const WideMlp& m, const float* __restrict__ w,
                                           const float* H, int n, int i, float z,
                                           float& store) {
  const bool with_std = m.head == kHeadPpo || m.head == kHeadDet;
  const bool actor = m.head != kHeadUniform;
  return offpolicy_head(m.head, actor ? H[i * kWideLanes + n] : 0.f,
                        m.head == kHeadSac ? H[(m.act + i) * kWideLanes + n] : 0.f,
                        with_std ? __ldg(w + m.std + i) : 0.f, z, store);
}

size_t wide_smem_bytes(const WideMlp& m) {
  return (size_t)2 * m.rows * kWideLanes * sizeof(float);
}

unsigned wide_blocks(long long B) { return (unsigned)((B + kWideLanes - 1) / kWideLanes); }

}  // namespace
