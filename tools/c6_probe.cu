// One dense layer on the tensor cores, as the tile kernels run it, for
// tools/c6_sweep.py: out = W x + b over columns of x, a warp per 32 columns,
// W packed as the A fragments of ops/episode_kernels.py _mma_fragments.
//
// Scheme 0 is the package's own csrc/mma_tf32.cuh mma_layer_tiles, one
// M-tile at a time. The others are candidate k-steps written out here on the
// first design's two-piece split (split_tf32 below) or the package's
// three-piece one (split3_tf32) and the same product (mma_tf32), so that
// one build compares them on the same inputs:
//   1  three products into the running accumulator (the first design: As Bb,
//      Ab Bs, Ab Bb);
//   2  the three products into a fresh accumulator a k-step, added to the
//      running sum in IEEE FP32;
//   3  as 2, the big product first;
//   4  four products (As Bs first) into the running accumulator;
//   5  four products into a fresh accumulator a k-step;
//   6  the three products into a fresh accumulator every two k-steps;
//   7  the small products into a second running accumulator, Ab Bb into the
//      first, summed at the end;
//   8  Ab Bb alone (one TF32 product, for scale);
//   9  A split exactly in three (Ab + Am + Ar, the rest of 24 bits), B in
//      two: Ar Bb, Am Bs, Ab Bs, Am Bb, Ab Bb into a fresh accumulator.
// (Both in three, six products fresh, is the package's own: scheme 0.)
// c6_probe_layer also takes raw operands (split 0): each value's top 19 bits
// only, one mma.sync a k-step, so that a caller can hold the accumulator's
// rounding against exact sums (c6_sweep.py's accumulator probe).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I or_gym_inventory_torch/csrc tools/c6_probe.cu
#include <cuda_runtime.h>

#include "launch.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kStride = 40;  // floats a row: 32 columns + 8 (mma_tf32.cuh's bank rule)

// The first design's split (csrc/mma_tf32.cuh before the three-piece
// split): big = rna_tf32(x), small = x - big with half a TF32 ulp added to
// its bits, which the tensor core truncates to 19, so rounded to nearest.
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void split4(const float4 f, unsigned (&big)[4], unsigned (&small)[4]) {
  split_tf32(f.x, big[0], small[0]);
  split_tf32(f.y, big[1], small[1]);
  split_tf32(f.z, big[2], small[2]);
  split_tf32(f.w, big[3], small[3]);
}

template <int SCHEME>
__device__ __forceinline__ void kstep(const float4 f, const float* x, int gid, int tig,
                                      int ks, int ks_n, float (&acc)[4][4], float (&part)[4][4],
                                      float (&acc2)[4][4]) {
  unsigned ab[4], as[4], a3b[4], a3m[4], a3r[4];
  split4(f, ab, as);
  const float fa[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) split3_tf32(fa[r], a3b[r], a3m[r], a3r[r]);
  const float* x0 = x + tig * kStride + gid;
  const float* x1 = x0 + 4 * kStride;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    unsigned bb[2], bs[2];
    split_tf32(x0[8 * nt], bb[0], bs[0]);
    split_tf32(x1[8 * nt], bb[1], bs[1]);
    if (SCHEME == 9) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(t, a3r, bb);
      mma_tf32(t, a3m, bs);
      mma_tf32(t, a3b, bs);
      mma_tf32(t, a3m, bb);
      mma_tf32(t, a3b, bb);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] = __fadd_rn(acc[nt][r], t[r]);
    } else if (SCHEME == 1) {
      mma_tf32(acc[nt], as, bb);
      mma_tf32(acc[nt], ab, bs);
      mma_tf32(acc[nt], ab, bb);
    } else if (SCHEME == 2 || SCHEME == 3 || SCHEME == 5) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      if (SCHEME == 5) mma_tf32(t, as, bs);
      if (SCHEME == 3) mma_tf32(t, ab, bb);
      mma_tf32(t, as, bb);
      mma_tf32(t, ab, bs);
      if (SCHEME != 3) mma_tf32(t, ab, bb);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] = __fadd_rn(acc[nt][r], t[r]);
    } else if (SCHEME == 4) {
      mma_tf32(acc[nt], as, bs);
      mma_tf32(acc[nt], as, bb);
      mma_tf32(acc[nt], ab, bs);
      mma_tf32(acc[nt], ab, bb);
    } else if (SCHEME == 6) {
      mma_tf32(part[nt], as, bb);
      mma_tf32(part[nt], ab, bs);
      mma_tf32(part[nt], ab, bb);
      if ((ks & 1) || ks + 1 == ks_n) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[nt][r] = __fadd_rn(acc[nt][r], part[nt][r]);
          part[nt][r] = 0.f;
        }
      }
    } else if (SCHEME == 7) {
      mma_tf32(acc2[nt], as, bb);
      mma_tf32(acc2[nt], ab, bs);
      mma_tf32(acc[nt], ab, bb);
    } else {
      mma_tf32(acc[nt], ab, bb);
    }
  }
}

// Raw operands: the bits as they are (the tensor core reads the top 19).
__device__ __forceinline__ void kstep_raw(const float4 f, const float* x, int gid, int tig,
                                          float (&acc)[4][4]) {
  const unsigned a[4] = {__float_as_uint(f.x), __float_as_uint(f.y), __float_as_uint(f.z),
                         __float_as_uint(f.w)};
  const float* x0 = x + tig * kStride + gid;
  const float* x1 = x0 + 4 * kStride;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const unsigned b[2] = {__float_as_uint(x0[8 * nt]), __float_as_uint(x1[8 * nt])};
    mma_tf32(acc[nt], a, b);
  }
}

template <int SCHEME>
__device__ void layer_tile(const float4* __restrict__ frag, const float* __restrict__ b, int mt,
                           int ks_n, const float* in, float* out) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float b0 = __ldg(b + 16 * mt + gid), b1 = __ldg(b + 16 * mt + gid + 8);
  float acc[4][4], part[4][4], acc2[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    acc[nt][0] = acc[nt][1] = b0;
    acc[nt][2] = acc[nt][3] = b1;
#pragma unroll
    for (int r = 0; r < 4; ++r) part[nt][r] = acc2[nt][r] = 0.f;
  }
  const float4* a = frag + lane + 32 * mt * ks_n;
  for (int ks = 0; ks < ks_n; ++ks) {
    const float4 f = __ldg(a + 32 * ks);
    if (SCHEME < 0)
      kstep_raw(f, in + 8 * ks * kStride, gid, tig, acc);
    else
      kstep<SCHEME>(f, in + 8 * ks * kStride, gid, tig, ks, ks_n, acc, part, acc2);
  }
  float* row = out + (16 * mt + gid) * kStride + 2 * tig;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = SCHEME == 7 ? __fadd_rn(acc[nt][r], acc2[nt][r]) : acc[nt][r];
    *reinterpret_cast<float2*>(row + 8 * nt) = make_float2(v[0], v[1]);
    *reinterpret_cast<float2*>(row + 8 * kStride + 8 * nt) = make_float2(v[2], v[3]);
  }
}

// A block (one warp) per 32 columns: x (ks_n * 8 rows, n columns) into
// shared memory, each M-tile of the layer, the rows back to out (m_tiles *
// 16 rows, n columns).
template <int SCHEME>
__global__ void __launch_bounds__(32) k_probe(const float4* __restrict__ frag,
                                              const float* __restrict__ b,
                                              const float* __restrict__ x, float* __restrict__ y,
                                              int m_tiles, int ks_n, long long n) {
  extern __shared__ float smem[];
  float* in = smem;
  float* out = smem + 8 * ks_n * kStride;
  const int lane = threadIdx.x;
  const long long col = 32LL * blockIdx.x + lane;
  for (int k = 0; k < 8 * ks_n; ++k) in[k * kStride + lane] = keep_nan(x[k * n + col]);
  __syncwarp();
  for (int mt = 0; mt < m_tiles; ++mt) {
    if (SCHEME == 0)
      mma_layer_tiles<1, false>(frag, b, mt, ks_n, in, out, kStride, 0);
    else
      layer_tile<SCHEME>(frag, b, mt, ks_n, in, out);
  }
  __syncwarp();
  for (int m = 0; m < 16 * m_tiles; ++m) y[m * n + col] = out[m * kStride + lane];
}

template <int SCHEME>
int launch(const float* frag, const float* b, const float* x, float* y, int m_tiles, int ks_n,
           long long n, cudaStream_t stream) {
  const size_t smem = (size_t)(8 * ks_n + 16 * m_tiles) * kStride * sizeof(float);
  cudaError_t err = allow_smem(k_probe<SCHEME>, smem);
  if (err != cudaSuccess) return (int)err;
  k_probe<SCHEME><<<(unsigned)(n / 32), 32, smem, stream>>>(
      reinterpret_cast<const float4*>(frag), b, x, y, m_tiles, ks_n, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (m_tiles * 16, n) = the layer over x (ks_n * 8, n), n a multiple of 32,
// under ``scheme`` (0-9 above; -1 the raw operands, one product a k-step).
int c6_probe_layer(const float* frag, const float* b, const float* x, float* y, int m_tiles,
                   int ks_n, long long n, int scheme, cudaStream_t stream) {
  if (n % 32 || n <= 0) return (int)cudaErrorInvalidValue;
  switch (scheme) {
    case -1: return launch<-1>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 0: return launch<0>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 1: return launch<1>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 2: return launch<2>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 3: return launch<3>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 4: return launch<4>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 5: return launch<5>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 6: return launch<6>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 7: return launch<7>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 8: return launch<8>(frag, b, x, y, m_tiles, ks_n, n, stream);
    case 9: return launch<9>(frag, b, x, y, m_tiles, ks_n, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
