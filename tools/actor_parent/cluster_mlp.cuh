// The folded off-policy actor of K27 (im_policy.cu), K28 (nv_policy.cu) and
// K29 (net_policy.cu) over a thread-block cluster, at the learners' shape:
// 1,024 lanes x the horizon, SB3's default (256, 256) relu actor. It
// replaces, as wide_mlp.cuh did, the in-kernel
// pallas_episode_kernels.mlp_forward (:1124) under the heads of traj_policy
// (:1036-1081); the heads' math is wide_mlp.cuh's offpolicy_head,
// unchanged. They stay on wide_mlp.cuh where a CTA's slice of the actor
// does not fit, and K29 for a batch of more rounds than its rule allows
// (the wrapper's plan picks that route from the sizes, before the launch).
// The regions below are offsets the plan lays out (ops/episode_kernels.py
// _cluster_plan, on the family's ClusterLayout): K29's puts red and h inside
// x0, which is dead from the last hidden layer's barrier to the next
// period's obs barrier, and its rows unpadded.
//
// What bounds it: operations, the actor's ~1.5e5 FMAs an env-step. The
// first design (wide_mlp.cuh) ran a block per 32 lanes: 32 blocks on 132
// SMs at 1,024 lanes, each streaming the whole 304 KB actor from L2 every
// period at two warps a scheduler. Here:
//
// - A cluster of C CTAs (cudaLaunchAttributeClusterDimension; C = 4 at
//   the defaults) runs a tile of N lanes (64). CTA r keeps, in its own
//   shared memory for the whole launch, rows [r R, (r + 1) R) of every
//   hidden layer (R = the layer's width padded to 16 C, over C: 64 at
//   width 256 and C = 4), as W^T [k][R + 8] (the 8 keep the A fragment
//   loads of the sweep's 3xTF32 form on 32 banks), and the output layer
//   whole. The wrapper packs each rank's block contiguously
//   (ops/episode_kernels.py _pack_cluster_actor); the block is copied in
//   once per launch with cp.async, never re-read.
// - Each CTA holds the tile's obs and the hidden layers' outputs but the
//   last whole, [row][lane] at a stride of N + 8. A hidden layer computes
//   the CTA's R rows for all N lanes and writes them into every CTA's next
//   buffer through distributed shared memory (cluster.map_shared_rank);
//   the last hidden layer writes each lane's rows only into the buffer of
//   the CTA that owns the lane (xl, [row][N / C]), so a CTA holds one whole
//   buffer for the default two hidden layers. One cluster barrier ends
//   each layer: a layer reads one buffer and writes another, so the
//   barrier after layer l - 1 also ends every read of the buffer layer l
//   writes.
// - CTA r owns lanes r N / C .. (r + 1) N / C - 1 (lanes_cta of them, one
//   thread each), which it steps with the family's step header. At each
//   tile's reset all its threads draw every (lane, period)'s words into
//   shared memory; per period all of them write the lanes' obs columns,
//   read from the lanes' state in shared memory, into every CTA's xo (then
//   a cluster barrier), run the output layer for the CTA's lanes (the k
//   split into 32 groups summed in a fixed order, so a lane's sums do not
//   depend on the tile), and the lane threads take the head and the step.
// - The kernel is persistent: the grid holds as many clusters as
//   cudaOccupancyMaxActiveClusters reports for the launch (the wrapper
//   asks the card), each walking tiles c, c + clusters, ... Every CTA of a
//   cluster walks the same tiles, so they meet at every barrier; lanes
//   past the batch compute and write nothing. A CTA ends with a cluster
//   barrier, so none exits while a peer may still write its memory.
// - Products: FP32 FMAs, a thread 4 rows x 2 lanes, a warp 8 rows x 32
//   lanes, 16 warps a CTA (4 a scheduler, one warp item each at the
//   defaults): a period is a serial chain of barriers and layers, and the
//   warps in flight are what hides its shared-memory latency (256 threads,
//   two items a warp in turn, ran 11-13% slower: tools/wide_cluster_sweep.py
//   threads256). The sweep also times a 3xTF32 form on mma.sync
//   (its own copy): 2-8% faster at the defaults, a_norm within 1e-4 of
//   this one on 97-99% of lanes, so the FP32 cores stay (PERF.md).
// - "uniform" runs no actor and meets no barrier: its plan is a cluster
//   of one CTA over 64 lanes.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch.cuh"
#include "nanmath.cuh"
#include "wide_mlp.cuh"

#define CLUSTER_MAX_SIZE 8  // the portable cluster size

constexpr int kClusterThreads = 512;  // threads a CTA: 16 warps
constexpr int kClusterWarps = kClusterThreads / 32;

// The plan of one launch as ops/episode_kernels.py _cluster_plan lays it
// out (mirrored there by _ClusterMlp): the actor's slices in a CTA's block
// of weights (float offsets), the tile, and the shared-memory regions.
struct ClusterMlp {
  int n_layers;
  int dims[WIDE_MAX_LAYERS + 1];  // the actor's widths, obs_dim .. outputs
  int kin[WIDE_MAX_LAYERS];       // input rows of each layer: pad8(obs), then C R
  int rows[WIDE_MAX_LAYERS];      // hidden: R rows a CTA; output: pad8(outputs)
  int ws[WIDE_MAX_LAYERS];        // the row stride of each W slice: R + 8; output rows
  int w[WIDE_MAX_LAYERS];         // each W slice, [k][ws]
  int b[WIDE_MAX_LAYERS];         // each bias slice
  int std;                        // the std (act floats), or -1
  int block;                      // floats of a CTA's block, a multiple of 4
  int act;                        // the env's act_dim
  int head;                       // WideHead
  int cluster;                    // C, CTAs a cluster
  int lanes;                      // N, lanes a tile
  int lanes_cta;                  // N / C, lanes a CTA steps
  int stride;                     // S = N + 8, the activations' row stride
  int s_xo;                       // the tile's obs, [row][S], kin[0] rows
  int s_x0, s_x1;                 // the hidden layers' but the last, [row][S]
  int s_xl;                       // the last hidden layer's, the CTA's lanes: [row][lanes_cta]
  int s_red;                      // the output layer's partial sums, [32][8][lanes_cta]
  int s_h;                        // the outputs of the CTA's lanes, [row][lanes_cta]
  int s_dem;                      // the lanes' demand, [lane][T]
  int s_z;                        // the lanes' head noise, [lane][T][act]
  int s_q;                        // K28: the lanes' Poisson anchors, [lane][4]
  int s_state;                    // the lanes' state the obs reads, [lane][state_words]
  int state_words;                // words of state a lane
  int floats;                     // floats of shared memory a CTA
  int clusters;                   // clusters the grid launches
  float half_hi[WIDE_MAX_ACT];    // per action, f32(0.5 * (high - low))
};

namespace {

namespace cg = cooperative_groups;

// CTA rank's block of weights into shared memory [0, block), once a
// launch; every thread must call it.
__device__ __forceinline__ void cluster_load_weights(const ClusterMlp& m,
                                                     const float* __restrict__ w, int rank,
                                                     float* smem) {
  const float4* src = reinterpret_cast<const float4*>(w + (long long)rank * m.block);
  for (int i = threadIdx.x; i < m.block / 4; i += kClusterThreads) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem + 4 * i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// A hidden layer's output z through the trunk's activation.
template <bool RELU>
__device__ __forceinline__ float hidden_act(float z) {
  return RELU ? max_nan(z, 0.f) : tanhf(z);
}

// Row ``row`` of columns c, c + 1 (v0, v1) into ``out`` ([row][S]) of
// every CTA of the cluster, or, when ``last`` (the last hidden layer, which
// only the owner's output layer reads), into the owner's ``out`` (xl,
// [row][lanes_cta]) alone.
__device__ __forceinline__ void cluster_store(cg::cluster_group& cl, const ClusterMlp& m,
                                              float* out, int row, int c, float v0, float v1,
                                              bool last) {
  const float2 v = make_float2(v0, v1);
  if (last) {  // the owner's xl: [row][lanes_cta]
    const int q = c / m.lanes_cta;
    float* dst = cl.map_shared_rank(out, q);
    *reinterpret_cast<float2*>(dst + row * m.lanes_cta + c - q * m.lanes_cta) = v;
    return;
  }
  const int off = row * m.stride + c;
  for (int q = 0; q < m.cluster; ++q) {
    float* dst = cl.map_shared_rank(out, q);
    *reinterpret_cast<float2*>(dst + off) = v;
  }
}

// Hidden layer l on the FP32 cores: the CTA's R rows for the tile's N
// lanes. A warp item is 8 rows x 32 lanes, a thread 4 rows x 2 lanes: per
// k one float4 of weights (a broadcast) and one float2 of activations for
// 8 FMAs, one item a warp at the defaults (R = 64 rows over N = 64 lanes:
// 16 items). A sum runs over k in order, so it depends neither on the tile
// nor on the warps a CTA.
template <bool RELU>
__device__ __forceinline__ void cluster_layer_fp32(cg::cluster_group& cl, const ClusterMlp& m,
                                                   int l, const float* W, const float* bias,
                                                   const float* in, float* out, int rank,
                                                   bool last) {
  const int R = m.rows[l], RS = m.ws[l], K = m.kin[l], S = m.stride;
  const int t = threadIdx.x & 31, blocks = m.lanes >> 5, items = (R >> 3) * blocks;
  for (int wi = threadIdx.x >> 5; wi < items; wi += kClusterWarps) {
    const int r0 = (wi / blocks) * 8 + (t >> 4) * 4;
    const int c = (wi % blocks) * 32 + (t & 15) * 2;
    float acc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = 0.f;
    const float* wp = W + r0;
    const float* xp = in + c;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(wp + k * RS);
      const float2 xv = *reinterpret_cast<const float2*>(xp + k * S);
      const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] = fmaf(ww[j], xv.x, acc[j][0]);
        acc[j][1] = fmaf(ww[j], xv.y, acc[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = bias[r0 + j];
      cluster_store(cl, m, out, rank * R + r0 + j, c, hidden_act<RELU>(acc[j][0] + bj),
                    hidden_act<RELU>(acc[j][1] + bj), last);
    }
  }
}

// The output layer for the CTA's lanes_cta lanes, columns c0 .. of the
// last hidden layer's rows in x (``xs`` floats apart): (lane, group g < 32) pairs
// sum k = g, g + 32, .. for 8 outputs at a time into red
// ([g][8][lanes_cta]); then (output, lane) pairs sum the 32 groups in
// order and add the bias, so the sums are the same at any tile. Returns H
// ([row][lanes_cta]); every thread must call it, and it ends with a
// barrier.
__device__ __forceinline__ const float* cluster_output(const ClusterMlp& m, float* smem,
                                                       const float* x, int c0, int xs) {
  const int l = m.n_layers - 1, K = m.kin[l], A8 = m.rows[l], Lc = m.lanes_cta;
  const float* W = smem + m.w[l];
  const float* bias = smem + m.b[l];
  float* red = smem + m.s_red;
  float* H = smem + m.s_h;
  for (int o0 = 0; o0 < A8; o0 += 8) {
    for (int pr = threadIdx.x; pr < 32 * Lc; pr += kClusterThreads) {
      const int li = pr % Lc, g = pr / Lc;
      const float* xc = x + c0 + li;
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      for (int k = g; k < K; k += 32) {
        const float xv = xc[k * xs];
        const float4 w0 = *reinterpret_cast<const float4*>(W + k * A8 + o0);
        const float4 w1 = *reinterpret_cast<const float4*>(W + k * A8 + o0 + 4);
        const float ww[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(ww[j], xv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(g * 8 + j) * Lc + li] = acc[j];
    }
    __syncthreads();
    for (int pr = threadIdx.x; pr < 8 * Lc; pr += kClusterThreads) {
      const int j = pr / Lc, li = pr % Lc;
      float v = 0.f;
      for (int g = 0; g < 32; ++g) v += red[(g * 8 + j) * Lc + li];
      H[(o0 + j) * Lc + li] = v + bias[o0 + j];
    }
    __syncthreads();
  }
  return H;
}

// v into word ``off`` of the region at ``local`` (this CTA's address) in
// every CTA of the cluster.
__device__ __forceinline__ void cluster_put(cg::cluster_group& cl, const ClusterMlp& m,
                                            float* local, int off, float v) {
  for (int q = 0; q < m.cluster; ++q) cl.map_shared_rank(local, q)[off] = v;
}

// The tile's forward pass, the obs of every lane of the tile already
// written into every CTA's xo (cluster_put): one cluster barrier, the
// hidden layers (a barrier each: xo -> x0 -> x1 -> x0 ..., the last into
// the owners' xl), then the output layer for the CTA's lanes. Returns H
// ([row][lanes_cta]); every thread of every CTA of the cluster must call
// it.
template <bool RELU>
__device__ __forceinline__ const float* cluster_forward(cg::cluster_group& cl,
                                                        const ClusterMlp& m, float* smem,
                                                        int rank) {
  cl.sync();  // the obs are in
  float* bufs[2] = {smem + m.s_x0, smem + m.s_x1};
  const float* in = smem + m.s_xo;
  const int hidden = m.n_layers - 1;
  for (int l = 0; l < hidden; ++l) {
    const bool last = l == hidden - 1;
    float* out = last ? smem + m.s_xl : bufs[l & 1];
    cluster_layer_fp32<RELU>(cl, m, l, smem + m.w[l], smem + m.b[l], in, out, rank, last);
    cl.sync();
    in = out;
  }
  return hidden ? cluster_output(m, smem, in, 0, m.lanes_cta)
                : cluster_output(m, smem, in, rank * m.lanes_cta, m.stride);
}

// Action i's head (offpolicy_head) for the CTA's lane n, from H
// ([row][lanes_cta]) and the std in the CTA's block.
__device__ __forceinline__ float cluster_head(const ClusterMlp& m, const float* smem,
                                              const float* H, int n, int i, float z,
                                              float& store) {
  const int Lc = m.lanes_cta;
  const bool actor = m.head != kHeadUniform;
  return offpolicy_head(m.head, actor ? H[i * Lc + n] : 0.f,
                        m.head == kHeadSac ? H[(m.act + i) * Lc + n] : 0.f,
                        m.std >= 0 ? smem[m.std + i] : 0.f, z, store);
}

// Launch ``kernel`` on m.clusters clusters of m.cluster CTAs; returns the
// error code (a refused launch included).
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...), const ClusterMlp& m, cudaStream_t stream,
                   Args... args) {
  if (m.cluster < 1 || m.cluster > CLUSTER_MAX_SIZE || m.clusters < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)m.floats * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)m.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(m.clusters * m.cluster));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clusters of m.cluster CTAs that can be resident at once for
// ``kernel`` with m's shared memory, into *out; returns the error code.
template <typename K>
int max_active_clusters(K kernel, const ClusterMlp& m, int* out) {
  const size_t smem = (size_t)m.floats * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)m.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)m.cluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)kernel, &cfg);
}

}  // namespace
