// The folded MLP actor over a tile of lanes on the tensor cores, shared by
// the learned-policy returns kernels K5/K6 (net_policy.cu
// k_policy_returns), K11/K12 (im_policy.cu k_im_policy_returns) and
// K19/K20 (nv_policy.cu k_nv_policy_returns), and by the PPO trajectory
// kernels K4, K10 and K18, their one-episode stochastic instances with the
// streams written (TRAJ). It replaces the in-kernel
// pallas_episode_kernels.mlp_forward (:1124) of _net_policy_call,
// _im_policy_call, _nv_policy_call, _net_traj_kernel, _im_traj_kernel and
// _nv_traj_kernel, which ran the layers as MXU matmuls over a (rows,
// lanes) tile.
//
// What bounds it: the products, 2 sum(in out) FLOPs an env-step (18,304 at
// K5's default 68-64-64-11 actor, 12,800 at K11's 33-64-64-3), nearly all
// of the kernels' arithmetic. The first version (mlp.cuh: one forward
// pass per thread on the FP32 cores, every 4 FMAs waiting on a 16-byte
// shared-memory broadcast) ran them at 9-12 TFLOP/s. Here they run on the
// tensor cores, mma.sync m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh: the split,
// the products and the quiet-NaN rule, shared with lstm.cuh).
//
// - The tile: a block runs ``lanes`` (lane, episode) pairs, one thread each,
//   so every thread steps its own pair's env. A warp runs the whole actor
//   for its 32 pairs: per hidden layer the output M-tiles of 16 in groups
//   of MLP_TILE_GROUP (4 x 4 accumulator tiles live), the rest and the
//   output layer one M-tile at a time, over its 4 n-tiles of 8 lanes, K =
//   the layer's inputs padded to 8. The warps never wait on
//   each other: the kernels have no block barrier, only __syncwarp between
//   a column's writes by its lane thread and the products that read it,
//   so one warp's step overlaps another's products.
// - The weights: the wrapper packs each layer as A fragments
//   (ops/episode_kernels.py _pack_tile_actor, NaN as the quiet NaN), read
//   through L1 and L2 one k-step ahead and split in registers (mma_tf32.cuh
//   mma_rows); each 16 bytes a thread feeds 32 lanes. Split by the wrapper
//   (twice the bytes, no integer work) they ran slower, and staged in
//   shared memory slower still: a block an SM (tools/mlp_tile_sweep.py).
// - Shared memory, [row][lane] at stride lanes + 8 (B-fragment loads and
//   float2 stores hit 32 banks): the activation buffer, in place when
//   every layer's outputs are one product (a group, or a single M-tile),
//   which reads all of its inputs before it writes (72 rows for K5's
//   default actor, 64 for K11's), else two ping-pong buffers; then, for K5, the NetInvMgmt step
//   state that lasts the episode ([word][lane], net_step.cuh SharedView).
//   The output layer writes the pre-squash means H with no tanh into rows
//   0 .. act - 1 of its buffer; the rows from pad16(act) on are dead until
//   the next period's obs, so the lane threads keep the period's transient
//   values there: the demand (K5; K11 keeps its one demand in a register),
//   the normals, and K5's per-node step scratch. K5's shared memory a lane
//   is what sets its blocks an SM (one block less ran 24% slower,
//   tools/mlp_tile_sweep.py), so nothing transient has rows of its own.
//
// Rounding: the sums run in another order than the plain version's matmuls
// and with the tensor cores' FP32 accumulation, and tanhf may differ from
// the CPU's by an ulp, so H agrees with the plain version to ~1e-6
// relative; a lane's sums do not depend on the tile's size. The wrapper
// (_pack_tile_actor and _mlp_tile_plan, whose ctypes mirror _MlpTile must
// match struct MlpTile field for field) packs the buffer, picks the tile,
// computes the layout and raises for an actor beyond the maxima.
#pragma once

#include <cuda_runtime.h>

#include "launch.cuh"
#include "mlp.cuh"
#include "mma_tf32.cuh"

#define MLP_TILE_GROUP 4  // M-tiles of 16 outputs a warp holds at once

// The actor's shape, its offsets in the packed float buffer, the tile and
// the block's shared-memory layout (float offsets), as the wrapper packs
// them.
struct MlpTile {
  int n_layers;
  int dims[MLP_MAX_LAYERS + 1];  // dims[0] = obs_dim, dims[n_layers] = act_dim
  int w[MLP_MAX_LAYERS];         // layer l's A fragments (pad16(out) x pad8(in))
  int b[MLP_MAX_LAYERS];         // its bias, padded to 16
  int std;                       // the std (act), or -1
  int lanes, stride;             // pairs (threads) a block; floats a row
  int s_x0, s_x1;                // the activation buffers; s_x1 = s_x0 in place
  int s_dem, s_z, s_scratch;     // transient rows in H's buffer, from row pad16(act)
  int s_state, s_total;          // the episode's state ([word][lane]); floats in all
  float half_hi[MLP_MAX_ACT];    // per action, f32(0.5 * (high - low))
};

namespace {

// M-tiles mt0 .. mt0 + r - 1 of one layer: a group of MLP_TILE_GROUP in one
// product, fewer one M-tile at a time. Three instances of mma_layer_tiles
// in all (a group, a single M-tile, the output layer's single M-tiles), so
// the warps of a block, each at its own point of the period, share less
// code.
template <bool TANH, class Load>
__device__ __forceinline__ void mlp_tile_group(int r, const float4* __restrict__ frag,
                                               const float* __restrict__ b, int mt0, int ks_n,
                                               const float* in, float* out, int S, int col0,
                                               Load load) {
  if (TANH && r == MLP_TILE_GROUP) {
    mma_layer_tiles<MLP_TILE_GROUP, true>(frag, b, mt0, ks_n, in, out, S, col0, load);
    return;
  }
  for (int s = 0; s < r; ++s)
    mma_layer_tiles<1, TANH>(frag, b, mt0 + s, ks_n, in, out, S, col0, load);
}

// The actor for the calling warp's 32 lanes, the obs rows already in the
// x0 buffer (the caller's __syncwarp after writing them): tanh after every
// layer but the last. Layer l reads buffer l & 1 and writes the other (the
// same buffer in place). The fragments at frags + m.w[l] (``load`` reads
// them), the biases at w + m.b[l]. Returns the buffer that holds H (rows
// 0 .. act - 1); ends with __syncwarp, so a lane thread may read its column.
template <class Load>
__device__ __forceinline__ float* mlp_tile_layers(const MlpTile& m, const float* __restrict__ w,
                                                  const float* frags, float* smem, Load load) {
  const int S = m.stride, col0 = threadIdx.x & ~31;
  float* in = smem + m.s_x0;
  float* out = smem + m.s_x1;
  for (int l = 0; l < m.n_layers; ++l) {
    const int ks_n = (m.dims[l] + 7) >> 3, mt_n = (m.dims[l + 1] + 15) >> 4;
    const float4* frag = reinterpret_cast<const float4*>(frags + m.w[l]);
    const float* b = w + m.b[l];
    const bool hidden = l + 1 < m.n_layers;
    for (int mt = 0; mt < mt_n; mt += MLP_TILE_GROUP) {
      const int r = min(MLP_TILE_GROUP, mt_n - mt);
      if (hidden)
        mlp_tile_group<true>(r, frag, b, mt, ks_n, in, out, S, col0, load);
      else
        mlp_tile_group<false>(r, frag, b, mt, ks_n, in, out, S, col0, load);
    }
    __syncwarp();
    float* tmp = in;
    in = out;
    out = tmp;
  }
  return in;
}

// mlp_tile_layers with the fragments read from device memory.
__device__ __forceinline__ float* mlp_tile_forward(const MlpTile& m, const float* __restrict__ w,
                                                   float* smem) {
  return mlp_tile_layers(m, w, w, smem, LdgFragments());
}

// Launch one kernel instance on the tile m names: ceil(n / lanes) blocks
// of m.lanes threads and m.s_total floats of dynamic shared memory.
template <typename Kernel, typename... Args>
int launch_mlp_tile(Kernel kernel, const MlpTile& m, long long n, cudaStream_t stream,
                    Args... args) {
  const size_t smem = (size_t)m.s_total * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + m.lanes - 1) / m.lanes);
  kernel<<<blocks, m.lanes, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
