"""Time K5 and K11 (the PyTorch port's learned-policy returns kernels) on
one CUDA card: their first design beside the tensor-core tile, split into
the actor and the env, at several tiles and weight sources.

K5 (``k_policy_returns`` in or_gym_inventory_torch/csrc/net_policy.cu) and
K11 (``k_im_policy_returns`` in csrc/im_policy.cu) run a block per tile of
(lane, episode) pairs, the actor on the tensor cores (csrc/mlp_tile.cuh).
This script builds, into the ignored ``build/`` directory, two extra
libraries, one including net_policy.cu and one im_policy.cu, which add:

- ``first``: the first design, one thread per pair with the actor of
  csrc/mlp.cuh on the FP32 cores (weights and activations in shared memory)
  and, for K5, the state in a local-memory Episode; ``first_actor`` its
  actor alone (no draws, no step), ``first_env`` its env alone (the draws,
  the observation and the step, on a fixed action);
- ``tile_actor`` and ``tile_env``: the tile's actor alone and env alone;
- ``tile_presplit``: the tile with every A fragment split into its TF32
  halves on the host (``presplit_fragments``, the bits the kernel's split
  makes), twice the fragment bytes and no integer split in the kernel;
- ``tile_occ_less``: the entry points' kernel with its shared memory padded
  so that an SM holds one block less;
- ``tile_smem_w`` (K5): the whole tile with every A fragment staged in
  shared memory once a block and read from there, beside the layout;
- ``tile_fp32_head``: the whole tile with the output layer as FP32 dot
  products, one lane thread its actions from its column.

The tile itself is timed through the entry points' C function at 32, 64
and 128 lanes (the kernels take any multiple of 32). It runs at the
learned-policy evaluation's shape (the defaults of each family, 65,536
lanes x 16 episodes x 30 periods, deterministic, chip_smoke.py's seeded
actor), in turns: the first design and the tile, then the tile and the
first design (the parent's kernel and this one, in one call), the tiles
forward, reversed and forward, then each variant three times. Every tile
run must equal the entry point's returns bit for bit (a lane's sums do not
depend on the tile), and so must ``tile_presplit``, ``tile_smem_w`` and
``tile_occ_less``; the first design and the FP32 head must agree with it
on >= 99% of lanes; the actor-alone and env-alone outputs are not results.
It prints each time, ptxas's registers and stack per kernel, and a JSON
line of the best times.

    python3 tools/mlp_tile_sweep.py

Without a CUDA card it exits 1.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LANES, EPISODES, SEED = 65_536, 16, 2024
TILES = (64, 32, 128)
FIRST = ("first", "first_actor", "first_env")
TILE_VARIANTS = {"net": ("tile_actor", "tile_env", "tile_presplit", "tile_occ_less", "tile_smem_w",
                         "tile_fp32_head"),
                 "im": ("tile_actor", "tile_env", "tile_presplit", "tile_occ_less",
                        "tile_fp32_head")}

# The variants both families share: the staged-weights loader and the
# forward pass with the FP32 output layer.
COMMON = r"""
namespace {

struct LdsFragments {
  __device__ __forceinline__ float4 operator()(const float4* p) const {
    float4 v;
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
    return v;
  }
};

// The tile with its A fragments split into TF32 halves by the host
// (presplit_fragments: per (M-tile, k-step) 32 float4 of big halves, then 32
// of small ones; the bits the kernel's split makes): mma_tf32.cuh's
// mma_kstep without the A split, and the layer and forward loops of
// mma_layer_tiles and mlp_tile_layers around it.
template <int NS>
__device__ __forceinline__ void kstep_presplit(const unsigned (&ab)[NS][4],
                                               const unsigned (&as)[NS][4], const float* x,
                                               int S, int col, int tig, float (&acc)[NS][4][4]) {
  const float* x0 = x + tig * S + col;
  const float* x1 = x0 + 4 * S;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    unsigned bb[2], bs[2];
    split_tf32(x0[8 * nt], bb[0], bs[0]);
    split_tf32(x1[8 * nt], bb[1], bs[1]);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mma_tf32(acc[s][nt], as[s], bb);
      mma_tf32(acc[s][nt], ab[s], bs);
      mma_tf32(acc[s][nt], ab[s], bb);
    }
  }
}

template <int NS, bool TANH>
__device__ __forceinline__ void layer_presplit(const float4* __restrict__ frag,
                                               const float* __restrict__ b, int mt0, int ks_n,
                                               const float* in, float* out, int S, int col0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float acc[NS][4][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float b0 = __ldg(b + 16 * (mt0 + s) + gid), b1 = __ldg(b + 16 * (mt0 + s) + gid + 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[s][nt][0] = acc[s][nt][1] = b0;
      acc[s][nt][2] = acc[s][nt][3] = b1;
    }
  }
  const float4* a = frag + lane + 64 * mt0 * ks_n;
  float4 nb[NS], ns[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    nb[s] = __ldg(a + s * 64 * ks_n);
    ns[s] = __ldg(a + s * 64 * ks_n + 32);
  }
#pragma unroll 2
  for (int ks = 0; ks < ks_n; ++ks) {
    unsigned ab[NS][4], as[NS][4];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      ab[s][0] = __float_as_uint(nb[s].x), ab[s][1] = __float_as_uint(nb[s].y);
      ab[s][2] = __float_as_uint(nb[s].z), ab[s][3] = __float_as_uint(nb[s].w);
      as[s][0] = __float_as_uint(ns[s].x), as[s][1] = __float_as_uint(ns[s].y);
      as[s][2] = __float_as_uint(ns[s].z), as[s][3] = __float_as_uint(ns[s].w);
      if (ks + 1 < ks_n) {
        nb[s] = __ldg(a + s * 64 * ks_n + 64 * (ks + 1));
        ns[s] = __ldg(a + s * 64 * ks_n + 64 * (ks + 1) + 32);
      }
    }
    kstep_presplit<NS>(ab, as, in + 8 * ks * S, S, col0 + gid, tig, acc);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    float* row = out + (16 * (mt0 + s) + gid) * S + col0 + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = TANH ? keep_nan(tanhf(acc[s][nt][r])) : acc[s][nt][r];
      *reinterpret_cast<float2*>(row + 8 * nt) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(row + 8 * S + 8 * nt) = make_float2(v[2], v[3]);
    }
  }
}

template <bool TANH>
__device__ __forceinline__ void group_presplit(int r, const float4* frag, const float* b,
                                               int mt0, int ks_n, const float* in, float* out,
                                               int S, int col0) {
  if (r >= 4)
    layer_presplit<4, TANH>(frag, b, mt0, ks_n, in, out, S, col0);
  else if (r == 3)
    layer_presplit<3, TANH>(frag, b, mt0, ks_n, in, out, S, col0);
  else if (r == 2)
    layer_presplit<2, TANH>(frag, b, mt0, ks_n, in, out, S, col0);
  else
    layer_presplit<1, TANH>(frag, b, mt0, ks_n, in, out, S, col0);
}

__device__ float* forward_presplit(const MlpTile& m, const float* __restrict__ w, float* smem) {
  const int S = m.stride, col0 = threadIdx.x & ~31;
  float* in = smem + m.s_x0;
  float* out = smem + m.s_x1;
  for (int l = 0; l < m.n_layers; ++l) {
    const int ks_n = (m.dims[l] + 7) >> 3, mt_n = (m.dims[l + 1] + 15) >> 4;
    const float4* frag = reinterpret_cast<const float4*>(w + m.w[l]);
    for (int mt = 0; mt < mt_n; mt += MLP_TILE_GROUP) {
      const int r = min(MLP_TILE_GROUP, mt_n - mt);
      if (l + 1 < m.n_layers)
        group_presplit<true>(r, frag, w + m.b[l], mt, ks_n, in, out, S, col0);
      else
        group_presplit<false>(r, frag, w + m.b[l], mt, ks_n, in, out, S, col0);
    }
    __syncwarp();
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

// mlp_tile_forward with the output layer as FP32 dot products: each lane
// thread computes its act outputs from its column of the last hidden layer
// (w_head: the layer's W as (act, in) row-major) into act rows after the
// layout (the launch adds them), which it returns.
__device__ float* forward_fp32_head(const MlpTile& m, const float* __restrict__ w,
                                    const float* __restrict__ w_head, float* smem) {
  const int S = m.stride, col0 = threadIdx.x & ~31, last = m.n_layers - 1;
  float* in = smem + m.s_x0;
  float* out = smem + m.s_x1;
  for (int l = 0; l < last; ++l) {
    const int ks_n = (m.dims[l] + 7) >> 3, mt_n = (m.dims[l + 1] + 15) >> 4;
    const float4* frag = reinterpret_cast<const float4*>(w + m.w[l]);
    for (int mt = 0; mt < mt_n; mt += MLP_TILE_GROUP)
      mlp_tile_group<true>(min(MLP_TILE_GROUP, mt_n - mt), frag, w + m.b[l], mt, ks_n, in, out,
                           S, col0, LdgFragments());
    __syncwarp();
    float* tmp = in;
    in = out;
    out = tmp;
  }
  const int ni = m.dims[last];
  const float* h = in + threadIdx.x;
  float* z = smem + ((m.s_total + 3) & ~3);
  for (int i = 0; i < m.dims[last + 1]; ++i) {
    float acc = __ldg(w + m.b[last] + i);
    for (int j = 0; j < ni; ++j) acc = fmaf(__ldg(w_head + i * ni + j), h[j * S], acc);
    z[i * S + threadIdx.x] = acc;
  }
  return z;
}

}  // namespace
"""

NET_LAUNCHER = r"""
#include "net_policy.cu"
""" + COMMON + r"""
namespace {

// The first design of K5, deterministic: PART 0 whole, 1 the actor alone,
// 2 the env alone on the action (tanh(0) + 1) * half_hi.
template <int PART>
__global__ void k_first(const __grid_constant__ NetTopo tp, const __grid_constant__ Mlp m,
                        const float* __restrict__ params, int n_params,
                        const float* __restrict__ tables, const float* __restrict__ disc,
                        float* __restrict__ out, unsigned seed, long long B, int E, int T) {
  float *h0, *h1;
  const float* sw = load_params(m, params, n_params, h0, h1);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  for (int k = 0; k < m.act_rows; ++k) col(h0, k) = 0.f;
  Episode s;
  episode_reset(tp, s);
  float raw[NET_MAX_RO], act[NET_MAX_RO], dem[NET_MAX_RT], r[NET_MAX_RO];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    if (PART == 1) {
      total += col(mlp_forward(m, sw, h0, h1), 0);
      continue;
    }
    if (PART == 0) {
      policy_period<false>(tp, m, sw, nullptr, tables, seed, lane, e, (unsigned)t, s, h0, h1,
                           raw, act, dem);
    } else {
      WordStream ws(seed, 1u, lane, e, (unsigned)t);
      for (int j = 0; j < tp.n_rt; ++j) dem[j] = link_demand(tp, tables, j, t, ws.next());
      assemble_obs(tp, s, h0);
      for (int i = 0; i < tp.n_ro; ++i) act[i] = m.half_hi[i];
    }
    total += __ldg(disc + t) * step_period(tp, s, act, dem, r);
  }
  out[idx] = total;
}

// The tile, deterministic: PART 1 the actor alone, 2 the env alone on the
// action half_hi, 3 whole with the fragments staged in shared memory, 4
// whole with the FP32 output layer, 5 whole with the fragments split by
// the host (w presplit, as m's offsets say).
template <int PART>
__global__ void k_tile(const __grid_constant__ NetTopo tp, const __grid_constant__ NetSmem lay,
                       const __grid_constant__ MlpTile m, const float* __restrict__ w, int n_w,
                       const float* __restrict__ w_head, const float* __restrict__ tables,
                       const float* __restrict__ disc, float* __restrict__ out, unsigned seed,
                       long long B, int E, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sw = smem + ((m.s_total + 3) & ~3);
  if (PART == 3) {
    for (int k = threadIdx.x; k < n_w; k += blockDim.x) sw[k] = __ldg(w + k);
    __syncthreads();
  }
  const int n = threadIdx.x, S = m.stride;
  const long long pair0 = (long long)blockIdx.x * m.lanes, idx = pair0 + n;
  if (pair0 + (n & ~31) >= B * E) return;
  const bool live = idx < B * E;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  float* x = smem + m.s_x0 + n;
  float* dem = smem + m.s_dem + n;
  float* z = smem + m.s_z + n;
  for (int k = 0; k < m.s_state - m.s_x0; k += S) x[k] = 0.f;
  const TileView s(smem + m.s_state, lay, smem + m.s_scratch + n, S, tp.n_main);
  reset_view(tp, s);
  const int obs_pad = (m.dims[0] + 7) & ~7;
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    if (PART != 1) view_obs(tp, s, obs_pad, x, S);
    __syncwarp();
    float* a;
    if (PART == 1)
      a = mlp_tile_forward(m, w, smem) + n;
    else if (PART == 2)
      a = x;
    else if (PART == 3)
      a = mlp_tile_layers(m, w, sw, smem, LdsFragments()) + n;
    else if (PART == 5)
      a = forward_presplit(m, w, smem) + n;
    else
      a = forward_fp32_head(m, w, w_head, smem) + n;
    if (PART == 1) {
      total += a[0];
      continue;
    }
    pair_draws<false>(tp, tables, seed, lane, e, (unsigned)t, dem, z, S);
    for (int i = 0; i < tp.n_ro; ++i)
      a[i * S] = PART == 2 ? m.half_hi[i] : (tanhf(a[i * S]) + 1.f) * m.half_hi[i];
    total += __ldg(disc + t) * step_view(tp, s, FromColumn{a, S}, FromColumn{dem, S}, nullptr);
  }
  if (live) out[idx] = total;
}

}  // namespace

extern "C" {

int sweep_first(int part, const NetTopo* tp, const Mlp* m, const float* params, int n_params,
                const void* env, const float* tables, const float* disc, float* out,
                unsigned seed, long long B, int E, int T, cudaStream_t stream) {
  auto kernel = part == 0 ? k_first<0> : part == 1 ? k_first<1> : k_first<2>;
  const size_t smem = smem_bytes(*m, n_params);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_for(B * E), kThreads, smem, stream>>>(*tp, *m, params, n_params, tables, disc,
                                                         out, seed, B, E, T);
  return (int)cudaGetLastError();
}

int sweep_tile(int part, const NetTopo* tp, const NetSmem* lay, const MlpTile* m, const float* w,
               int n_w, const float* w_head, const void* env, const float* tables,
               const float* disc, float* out, unsigned seed, long long B, int E, int T,
               cudaStream_t stream) {
  auto kernel = part == 1   ? k_tile<1>
                : part == 2 ? k_tile<2>
                : part == 3 ? k_tile<3>
                : part == 4 ? k_tile<4>
                            : k_tile<5>;
  MlpTile sized = *m;  // the launch's shared memory: the layout, then the staged weights
  if (part == 3) sized.s_total = ((m->s_total + 3) & ~3) + n_w;  // or the FP32 head's rows
  if (part == 4) sized.s_total = ((m->s_total + 3) & ~3) + m->dims[m->n_layers] * m->stride;
  return launch_mlp_tile(kernel, sized, B * E, stream, *tp, *lay, *m, w, n_w, w_head, tables,
                         disc, out, seed, B, E, T);
}

}  // extern "C"
"""

IM_LAUNCHER = r"""
#include "im_policy.cu"
""" + COMMON + r"""
namespace {

// The first design of K11, deterministic, backlog: PART 0 whole, 1 the
// actor alone, 2 the env alone on the action (int)half_hi.
template <int PART>
__global__ void k_first(const __grid_constant__ ImParams p, const __grid_constant__ Mlp m,
                        const float* __restrict__ params, int n_params,
                        const float* __restrict__ table, const int* __restrict__ user_d,
                        const float* __restrict__ disc, float* __restrict__ out, unsigned seed,
                        long long B, int E, int T) {
  float *h0, *h1;
  const float* sw = load_params(m, params, n_params, h0, h1);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  for (int k = 0; k < m.act_rows; ++k) col(h0, k) = 0.f;
  ImEpisode s;
  im_reset(p, s);
  int ah[IM_MAX_LT * IM_MAX_M1];
  int act[IM_MAX_M1];
  float raw[IM_MAX_M1], total = 0.f;
  for (int t = 0; t < T; ++t) {
    if (PART == 1) {
      total += col(mlp_forward(m, sw, h0, h1), 0);
      continue;
    }
    int d;
    if (PART == 0) {
      d = policy_period<false>(p, m, sw, nullptr, table, user_d, seed, lane, e, t, s, ah, h0, h1,
                               raw, act);
    } else {
      WordStream ws(seed, 1u, lane, e, (unsigned)t);
      d = im_demand(p, table, user_d, t, ws.next());
      lane_obs(p, s, t, ah, h0, kThreads);
      for (int i = 0; i < p.m1; ++i) act[i] = (int)m.half_hi[i];
    }
    const float profit = step_and_record<true>(p, s, t, act, d, ah);
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
  }
  out[idx] = total;
}

// The tile, deterministic, backlog: PART 1 the actor alone, 2 the env
// alone on the action (int)half_hi, 4 whole with the FP32 output layer, 5
// whole with the fragments split by the host (w presplit).
template <int PART>
__global__ void k_tile(const __grid_constant__ ImParams p, const __grid_constant__ MlpTile m,
                       const float* __restrict__ w, const float* __restrict__ w_head,
                       const float* __restrict__ table, const int* __restrict__ user_d,
                       const float* __restrict__ disc, float* __restrict__ out, unsigned seed,
                       long long B, int E, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = threadIdx.x, S = m.stride;
  const long long pair0 = (long long)blockIdx.x * m.lanes, idx = pair0 + n;
  if (pair0 + (n & ~31) >= B * E) return;
  const bool live = idx < B * E;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  const int m1 = p.m1, obs_pad = (m.dims[0] + 7) & ~7;
  float* x = smem + m.s_x0 + n;
  for (int k = 0; k < m.s_state - m.s_x0; k += S) x[k] = 0.f;
  ImEpisode s;
  im_reset(p, s);
  int ah[IM_MAX_LT * IM_MAX_M1];
  int act[IM_MAX_M1];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    if (PART != 1) {
      lane_obs(p, s, t, ah, x, S);
      for (int k = m1 * (p.lt + 1); k < obs_pad; ++k) x[k * S] = 0.f;
    }
    __syncwarp();
    const float* H;
    if (PART == 1)
      H = mlp_tile_forward(m, w, smem) + n;
    else if (PART == 2)
      H = x;
    else if (PART == 5)
      H = forward_presplit(m, w, smem) + n;
    else
      H = forward_fp32_head(m, w, w_head, smem) + n;
    if (PART == 1) {
      total += H[0];
      continue;
    }
    WordStream ws(seed, 1u, lane, e, (unsigned)t);
    const int d = im_demand(p, table, user_d, t, ws.next());
    for (int i = 0; i < m1; ++i)
      act[i] = PART == 2 ? (int)m.half_hi[i]
                         : (int)__fmul_rn(__fadd_rn(tanhf(H[i * S]), 1.f), m.half_hi[i]);
    const float profit = step_and_record<true>(p, s, t, act, d, ah);
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
  }
  if (live) out[idx] = total;
}

}  // namespace

extern "C" {

int sweep_first(int part, const ImParams* p, const Mlp* m, const float* params, int n_params,
                const int* user_d, const float* table, const float* disc, float* out,
                unsigned seed, long long B, int E, int T, cudaStream_t stream) {
  auto kernel = part == 0 ? k_first<0> : part == 1 ? k_first<1> : k_first<2>;
  const size_t smem = smem_bytes(*m, n_params);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_for(B * E), kThreads, smem, stream>>>(*p, *m, params, n_params, table, user_d,
                                                         disc, out, seed, B, E, T);
  return (int)cudaGetLastError();
}

int sweep_tile(int part, const ImParams* p, const void* lay, const MlpTile* m, const float* w,
               int n_w, const float* w_head, const int* user_d, const float* table,
               const float* disc, float* out, unsigned seed, long long B, int E, int T,
               cudaStream_t stream) {
  if (part == 3) return (int)cudaErrorInvalidValue;
  auto kernel = part == 1 ? k_tile<1> : part == 2 ? k_tile<2> : part == 4 ? k_tile<4> : k_tile<5>;
  MlpTile sized = *m;  // the launch's shared memory: the layout, then the FP32 head's rows
  if (part == 4) sized.s_total = ((m->s_total + 3) & ~3) + m->dims[m->n_layers] * m->stride;
  return launch_mlp_tile(kernel, sized, B * E, stream, *p, *m, w, w_head, table, user_d, disc,
                         out, seed, B, E, T);
}

}  // extern "C"
"""

PARTS = {"first": 0, "first_actor": 1, "first_env": 2, "tile_actor": 1, "tile_env": 2,
         "tile_smem_w": 3, "tile_fp32_head": 4, "tile_presplit": 5}


def presplit_fragments(frag):
    """``_mma_fragments``' output split as csrc/mma_tf32.cuh split_tf32
    splits each element on the card: per (M-tile, k-step) the 32 lanes'
    float4 of big halves, then their float4 of small halves, as float32
    bits; a non-finite element's small half the card's (0x80000fff)."""
    import torch
    x = frag.contiguous()
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def as_f32(u):
        return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)

    big = as_f32((bits + 0x1000) & 0xFFFFE000)
    diff = (x - big).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    small = as_f32(torch.where(torch.isfinite(x), (diff + 0x1000) & 0xFFFFFFFF,
                               torch.full_like(diff, 0x80000FFF)))
    return torch.stack([big.reshape(-1, 32, 4), small.reshape(-1, 32, 4)], 1).reshape(-1)


def build_launchers():
    """Compile both launchers at once next to the port's libraries; returns
    ({family: the library bound}, {family: ptxas's report})."""
    from or_gym_inventory_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for fam, text in (("net", NET_LAUNCHER), ("im", IM_LAUNCHER)):
        src = _build.BUILD_DIR / f"mlp_tile_sweep_{fam}.cu"
        src.write_text(text)
        so = _build.BUILD_DIR / f"libmlp_tile_sweep_{fam}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(src)]
        jobs[fam] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
    libs, logs = {}, {}
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    for fam, (so, proc) in jobs.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {fam} launcher:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.sweep_first.argtypes = [I, P, P, P, I, P, P, P, P, U, LL, I, I, P]
        lib.sweep_tile.argtypes = [I, P, P, P, P, I, P, P, P, P, P, U, LL, I, I, P]
        lib.sweep_first.restype = lib.sweep_tile.restype = I
        lib.cuda_error_message.argtypes, lib.cuda_error_message.restype = [I], ctypes.c_char_p
        libs[fam], logs[fam] = lib, out
    return libs, logs


def timed(launch):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def family_setup(fam, dev):
    """(params, actor, the entry point's call, the arguments of the two
    launchers) of one family at its defaults."""
    import torch

    import chip_smoke
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    if fam == "net":
        params = net.default_params(num_periods=30)
        T = params.topology
        obs_dim, act_dim, half = T.obs_dim, T.n_reorder, [ns._half_hi(T)] * T.n_reorder
        actor, _ = chip_smoke.seeded_actor(obs_dim, act_dim, dev)
        st, flat = ns._pack_net_tile_actor(T, actor, None, dev)
        tp, disc, tab = ns._launch_plan(params, 30, ek._plan_key(dev), True)
        lay = ns._shared_layout(T, False)[1]
        env = [ctypes.addressof(tp)]
        tile_env = [ctypes.addressof(tp), ctypes.addressof(lay)]
        tables = [None, tab.data_ptr(), disc.data_ptr()]
        entry = (lambda: ns.episode_returns_net_policy(params, actor, SEED, LANES, EPISODES,
                                                       device=dev))
        periods = 30
    else:
        params = im.default_params()
        obs_dim, act_dim, half = params.pipeline_length, params.m1, ek._half_c(params)
        actor, _ = chip_smoke.seeded_actor(obs_dim, act_dim, dev)
        st, flat = ek._pack_tile_actor(actor, None, obs_dim, act_dim, half, dev)
        plan = ek._im_plan(params, ek._plan_key(dev))
        env = [ctypes.addressof(plan["struct"])]
        tile_env = [ctypes.addressof(plan["struct"]), None]
        tables = [plan["user_d"].data_ptr(), plan["table"].data_ptr(), plan["disc"].data_ptr()]
        entry = (lambda: ek.episode_returns_im_policy(params, actor, SEED, LANES, EPISODES,
                                                      device=dev))
        periods = params.periods
    mlp, flat_first = ek._pack_actor(actor, None, obs_dim, act_dim, half, dev)
    w_head = actor[0][-1].T.contiguous().to(dev)
    st_pre = type(st).from_buffer_copy(st)   # the fragments split, at their offsets
    parts, at = [], 0
    for layer, (W, b) in enumerate(zip(*actor)):
        frag, bias = ek._encoder_fragments(W.T, b)
        frag = presplit_fragments(ek._quiet_nans(frag))
        st_pre.w[layer], st_pre.b[layer] = at, at + frag.numel()
        parts += [frag, bias]
        at += frag.numel() + bias.numel()
    return dict(params=params, actor=actor, st=st, flat=flat, mlp=mlp, flat_first=flat_first,
                st_pre=st_pre, flat_pre=torch.cat(parts),
                w_head=w_head, env=env, tile_env=tile_env, tables=tables, entry=entry,
                periods=periods, dims=[obs_dim] + [int(W.shape[1]) for W in actor[0]],
                act_dim=act_dim)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mlp_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    libs, logs = build_launchers()
    occupancy = {}   # blocks of 64 an SM by the returns kernel's registers
    for fam, log in logs.items():
        print(f"ptxas ({fam} launcher): " + chip_smoke.ptxas_entries(log), flush=True)
        kernel = "k_policy_returns<0,0>" if fam == "net" else "k_im_policy_returns<0,0,1>"
        regs = int(re.search(re.escape(kernel) + r" (\d+) registers",
                             chip_smoke.ptxas_entries(log)).group(1))
        occupancy[fam] = ek.REGS_PER_SM // (-(-regs // 8) * 8 * 64)
    stream = ek._stream(dev)
    result = {"card": smi.strip(), "shape": [LANES, EPISODES, 30]}

    def check(rc, lib, what):
        if rc:
            raise RuntimeError(f"{what}: {lib.cuda_error_message(rc).decode()}")

    for fam in ("net", "im"):
        lib, f = libs[fam], family_setup(fam, dev)
        T = f["periods"]
        ref = f["entry"]().reshape(-1)
        out = torch.empty(LANES * EPISODES, dtype=torch.float32, device=dev)
        entry_lib = _build.library("net_policy" if fam == "net" else "im_policy")
        params = f["params"]

        def tile(lanes, fewer_blocks=False):
            st1 = type(f["st"]).from_buffer_copy(f["st"])
            if fam == "net":
                T1 = params.topology
                layout = (T1.n_retail, 3 * T1.n_main, ns._shared_layout(T1, False)[0].words)
            else:
                layout = (0, 0, 0)
            ek._set_mlp_tile(st1, ek._mlp_tile_plan(f["dims"], *layout, lanes))
            if fewer_blocks:   # pad the shared memory so that an SM holds one block less
                per = 4 * st1.s_total + ek.SMEM_PER_BLOCK_RESERVED
                blocks = min(ek.SMEM_PER_SM // per, occupancy[fam]) - 1
                st1.s_total = (ek.SMEM_PER_SM // blocks - ek.SMEM_PER_BLOCK_RESERVED) // 4
            if fam == "net":
                rc = entry_lib.net_policy_returns(*f["tile_env"], ctypes.addressof(st1),
                                                  f["flat"].data_ptr(), *f["tables"][1:],
                                                  out.data_ptr(), None, None, SEED, LANES,
                                                  EPISODES, T, 0, stream)
            else:
                rc = entry_lib.im_policy_returns(f["env"][0], ctypes.addressof(st1),
                                                 f["flat"].data_ptr(), f["tables"][1],
                                                 f["tables"][0], f["tables"][2], out.data_ptr(),
                                                 None, None, SEED, 0, int(params.backlog),
                                                 LANES, EPISODES, T, stream)
            check(rc, entry_lib, f"{fam} tile {lanes}")

        def variant(kind):
            if kind == "tile_occ_less":
                return tile(64, fewer_blocks=True)
            if kind == "tile_presplit":
                rc = lib.sweep_tile(PARTS[kind], *f["tile_env"], ctypes.addressof(f["st_pre"]),
                                    f["flat_pre"].data_ptr(), f["flat_pre"].numel(),
                                    f["w_head"].data_ptr(), *f["tables"], out.data_ptr(), SEED,
                                    LANES, EPISODES, T, stream)
            elif kind.startswith("first"):
                rc = lib.sweep_first(PARTS[kind], f["env"][0], ctypes.addressof(f["mlp"]),
                                     f["flat_first"].data_ptr(), f["flat_first"].numel(),
                                     *f["tables"], out.data_ptr(), SEED, LANES, EPISODES, T,
                                     stream)
            else:
                rc = lib.sweep_tile(PARTS[kind], *f["tile_env"], ctypes.addressof(f["st"]),
                                    f["flat"].data_ptr(), f["flat"].numel(),
                                    f["w_head"].data_ptr(), *f["tables"], out.data_ptr(), SEED,
                                    LANES, EPISODES, T, stream)
            check(rc, lib, f"{fam} {kind}")

        variants = FIRST + TILE_VARIANTS[fam]
        for kind in variants:       # one untimed launch each, and the checks
            variant(kind)
            torch.cuda.synchronize()
            if kind in ("first", "tile_fp32_head", "tile_smem_w", "tile_presplit", "tile_occ_less"):
                need = chip_smoke.LANE_SHARE if kind in ("first", "tile_fp32_head") else 1.0
                share, _ = chip_smoke.lane_share(f"{fam} {kind} vs the entry point",
                                                 out.reshape(EPISODES, LANES),
                                                 ref.reshape(EPISODES, LANES), need=need)
                print(f"{fam} {kind}: {share:.4%} of lanes agree with the entry point",
                      flush=True)
        for lanes in TILES:
            tile(lanes)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"{fam} tile {lanes} differs from the entry point")
        turns = {"first": [], "tile": []}
        for kind in ("first", "tile", "tile", "first"):
            turns[kind].append(timed(lambda: variant("first") if kind == "first" else tile(64)))
            print(f"{fam} turn {kind}: {turns[kind][-1]:.4f} ms", flush=True)
        runs = {lanes: [] for lanes in TILES}
        for lanes in TILES + TILES[::-1] + TILES:
            runs[lanes].append(timed(lambda: tile(lanes)))
            print(f"{fam} tile {lanes}: {runs[lanes][-1]:.4f} ms", flush=True)
        var_ms = {k: [] for k in variants}
        for _ in range(3):
            for kind in variants:
                var_ms[kind].append(timed(lambda: variant(kind)))
                print(f"{fam} variant {kind}: {var_ms[kind][-1]:.4f} ms", flush=True)
        entry_ms = min(timed(f["entry"]) for _ in range(3))
        result[fam] = {"turns_ms": turns, "tiles_ms": {str(k): v for k, v in runs.items()},
                       "tiles_best_ms": {str(k): min(v) for k, v in runs.items()},
                       "variants_ms": var_ms,
                       "variants_best_ms": {k: min(v) for k, v in var_ms.items()},
                       "entry_point_ms": entry_ms, "entry_tile": f["st"].lanes,
                       "blocks_per_sm_by_registers": occupancy[fam],
                       "dims": f["dims"], "smem_bytes_64": f["st"].s_total * 4}
        del out, ref
    print(json.dumps({"mlp_tile_sweep": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
