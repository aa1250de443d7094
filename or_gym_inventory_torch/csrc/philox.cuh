// Philox4x32-10 and the family-free draws of the episode kernels: the word
// stream, the 24-bit uniform, the inversion count and the Box-Muller normal.
// Each family's kernels build their period draws from these (NetInvMgmt in
// net_step.cuh, InvManagement in im_step.cuh), so a kernel and its
// stream-dumping twin cannot drift apart.
//
// Replaces the TPU's hardware generator (pltpu.prng_seed /
// prng_random_bits in the JAX package's kernels), which exists neither on a
// GPU nor in interpret mode. The bits differ from the TPU's; the plain twin
// in ops/rng.py gives the same words bit for bit for the same counter and
// key.
//
// Stream layout: counter = (lane, episode, period, block); per (lane,
// episode, period), word w is component w % 4 of block w / 4. Which words a
// period takes is the family's (net_step.cuh, im_step.cuh).
//
// Conversions, kept exactly as the JAX kernels have them:
//   u24    = word >> 8
//   u      = float(u24) * 2^-24 (pallas_net_step.py:257-262)
//   demand = base + #{F in table : u >= F} (:265-288); a binary search over
//            the nondecreasing table gives the same count as the linear
//            compare, in log2(len) steps instead of len.
//   normal = sqrt(-2 ln(1 - u1)) * cos(f32(2 pi) * u2)
//            (pallas_episode_kernels.py:56-72). Built without fast math, so
//            logf/cosf are the accurate library versions; they may still
//            differ from the CPU's by an ulp.
#pragma once

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const unsigned M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const unsigned W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const unsigned hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const unsigned hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The words of one (lane, episode, period) in order, one block at a time.
struct WordStream {
  uint4 ctr;
  uint2 key;
  int w = 0;
  uint4 blk;

  __device__ WordStream(unsigned seed, unsigned key1, unsigned lane, unsigned e,
                        unsigned t)
      : ctr(make_uint4(lane, e, t, 0u)), key(make_uint2(seed, key1)) {}

  __device__ __forceinline__ unsigned next() {
    const int c = w & 3;
    if (c == 0) {
      ctr.w = (unsigned)(w >> 2);
      blk = philox4x32_10(ctr, key);
    }
    ++w;
    return c == 0 ? blk.x : c == 1 ? blk.y : c == 2 ? blk.z : blk.w;
  }
};

// Word k of one (lane, episode, period) alone: WordStream's k-th next().
__device__ __forceinline__ unsigned word_at(unsigned seed, unsigned key1, unsigned lane,
                                            unsigned e, unsigned t, int k) {
  const uint4 b = philox4x32_10(make_uint4(lane, e, t, (unsigned)(k >> 2)), make_uint2(seed, key1));
  const int c = k & 3;
  return c == 0 ? b.x : c == 1 ? b.y : c == 2 ? b.z : b.w;
}

__device__ __forceinline__ float u01(unsigned word) {
  return (float)(word >> 8) * 5.9604644775390625e-8f;  // exact: u24 < 2^24
}

// #{i < len : tab[i] <= u}
__device__ __forceinline__ int count_le(const float* __restrict__ tab, int len,
                                        float u) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(tab + mid) <= u)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float normal01(unsigned w1, unsigned w2) {
  const float r = sqrtf(-2.f * logf(1.f - u01(w1)));
  return r * cosf(6.2831855f * u01(w2));
}
