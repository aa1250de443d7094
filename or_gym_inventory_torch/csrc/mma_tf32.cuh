// FP32-accurate products on the tensor cores (mma.sync m16n8k8 TF32 in
// 3xTF32), shared by the tile kernels: the LSTM actor (lstm.cuh, K22-K24)
// and the MLP actor over a tile of lanes (mlp_tile.cuh, K5/K6 and K11/K12).
//
// 3xTF32: one TF32 product keeps ~3 decimal digits, and a lane whose action
// sits near a rounding or truncation boundary would take the other integer.
// So each operand x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big) (split_tf32), and D += A_small B_big + A_big B_small +
// A_big B_big, accumulated in FP32; the dropped A_small B_small is ~2^-22
// relative, so the sums keep FP32's accuracy.
//
// The quiet-NaN rule: split_tf32 rounds by integer arithmetic, which carries
// the canonical NaN 0x7fffffff (what CUDA's arithmetic produces) into the
// sign bit, a zero, while the quiet NaN 0x7fc00000 stays a NaN. So every
// operand the split sees must be finite, infinite or 0x7fc00000: the
// wrappers write every NaN weight as 0x7fc00000 (ops/episode_kernels.py
// _QUIET_NAN_BITS), and the kernels write every activation they compute,
// and every float observation, through keep_nan, once per value produced
// (a select in split_tf32 would run for every use).
//
// Layouts (the PTX ISA's m16n8k8 .tf32 fragments; gid = lane / 4, tig =
// lane % 4):
// - A (16 x 8, row-major): the wrapper packs the weights as the fragments
//   themselves, (M-tile, k-step, lane) -> float4 {a0, a1, a2, a3} =
//   A[gid][tig], A[gid + 8][tig], A[gid][tig + 4], A[gid + 8][tig + 4]
//   (ops/episode_kernels.py _mma_fragments), so a warp loads a fragment
//   with one coalesced 16-byte load per thread through the read-only path;
// - B (8 x 8): the activations in shared memory as [row][lane], rows S
//   floats apart, S = lanes + 8 so that the loads of rows tig and tig + 4,
//   lanes gid, hit 32 banks; a warp's 4 n-tiles cover its 32 lanes;
// - C (16 x 8): c0, c1 at row gid, lanes 2 tig and 2 tig + 1; c2, c3 at
//   row gid + 8; written back as float2, conflict-free at that stride.
#pragma once

#include <cuda_runtime.h>

namespace {

// x = big + small, both rounded to TF32 as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero): adding half a TF32 ulp to the bits, then
// dropping the 13 low bits. big's are cleared, so that small = x - big is
// exact; small's are left to the tensor core, which reads only the top 19
// bits of a TF32 operand. Integer and FP32 operations at full rate, where
// cvt.rna issues on the slower conversion path. A NaN must be the quiet NaN
// (then small is a NaN that reads as a zero, and big makes the products
// NaN, as in FP32); see the quiet-NaN rule above.
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// v, a NaN written as the quiet NaN split_tf32 keeps.
__device__ __forceinline__ float keep_nan(float v) {
  return isnan(v) ? __uint_as_float(0x7fc00000u) : v;
}

// d += a b: one m16n8k8 TF32 product, FP32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of NS M-tiles (their A fragments f, float4 {a0, a1, a2, a3}
// per lane) over the warp's 4 n-tiles: the B fragments from rows tig and
// tig + 4 of x (this k-step's 8 rows), lanes col + 8 nt; three TF32
// products into each accumulator tile.
template <int NS>
__device__ __forceinline__ void mma_kstep(const float4 (&f)[NS], const float* x, int S,
                                          int col, int tig, float (&acc)[NS][4][4]) {
  unsigned ab[NS][4], as[NS][4];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float fa[4] = {f[s].x, f[s].y, f[s].z, f[s].w};
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(fa[r], ab[s][r], as[s][r]);
  }
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

// The A fragments' default source: device memory through the read-only
// path (L1, then L2).
struct LdgFragments {
  __device__ __forceinline__ float4 operator()(const float4* p) const { return __ldg(p); }
};

// acc += the product of NS M-tiles (A fragments at a + s * tile_stride +
// 32 ks for k-step ks) and the k_steps * 8 input rows, the first ke of
// them at x_lo and the rest at x_hi. Each k-step's fragments are loaded one
// k-step ahead, so the L2 latency overlaps the products. ``load`` reads a
// fragment (LdgFragments; a timing variant may read them elsewhere).
template <int NS, class Load = LdgFragments>
__device__ __forceinline__ void mma_rows(const float4* __restrict__ a, int tile_stride,
                                         int k_steps, int ke, const float* x_lo,
                                         const float* x_hi, int S, int col, int tig,
                                         float (&acc)[NS][4][4], Load load = Load()) {
  float4 next[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) next[s] = load(a + s * tile_stride);
#pragma unroll 2
  for (int ks = 0; ks < k_steps; ++ks) {
    float4 cur[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      cur[s] = next[s];
      if (ks + 1 < k_steps) next[s] = load(a + s * tile_stride + 32 * (ks + 1));
    }
    const float* x = ks < ke ? x_lo + 8 * ks * S : x_hi + 8 * (ks - ke) * S;
    mma_kstep<NS>(cur, x, S, col, tig, acc);
  }
}

// M-tiles mt0 .. mt0 + NS - 1 (16 outputs each) of one dense layer for a
// warp's 32 lanes, columns col0 .. col0 + 31 of the [row][lane] buffers:
// the bias in the accumulators, the product over the layer's ks_n k-steps
// of input rows ``in``, then the outputs into ``out``, through
// keep_nan(tanhf(.)) when TANH, else as they are. The fragments of M-tile
// mt at frag + 32 mt ks_n, as _mma_fragments packs a layer. Outputs padded
// to 16 have zero weights and bias; inputs padded to 8 are zero rows. No
// barrier inside: the caller orders the buffers' writes and reads.
template <int NS, bool TANH, class Load = LdgFragments>
__device__ __forceinline__ void mma_layer_tiles(const float4* __restrict__ frag,
                                                const float* __restrict__ b, int mt0,
                                                int ks_n, const float* in, float* out, int S,
                                                int col0, Load load = Load()) {
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
  mma_rows<NS>(frag + lane + 32 * mt0 * ks_n, 32 * ks_n, ks_n, ks_n, in, in, S, col0 + gid, tig,
               acc, load);
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

}  // namespace
