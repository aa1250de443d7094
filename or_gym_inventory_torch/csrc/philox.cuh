// Philox4x32-10 and the per-period draw shared by the fused episode kernel
// (K2) and its stream-dumping twin (K3), so the two cannot drift apart.
//
// Replaces the TPU's hardware generator (pltpu.prng_seed /
// prng_random_bits in ops/pallas_net_step.py), which exists neither on a GPU
// nor in interpret mode. The bits differ from the TPU's; the plain twin in
// ops/rng.py gives the same words bit for bit for the same counter and key.
//
// Stream layout: key = (seed, 0); counter = (lane, episode, period, block).
// Per (lane, episode, period), word w is component w % 4 of block w / 4: the
// n_ro action words come first, then one demand word per retail link. A
// const (user/zero) link still owns its word, so the layout does not depend
// on the demand specs.
//
// Conversions, kept exactly as the JAX kernels have them:
//   u24    = word >> 8
//   action = float(u24) * act_scale, act_scale = f32(act_hi / 2^24)
//            (pallas_net_step.py:328-333)
//   u      = float(u24) * 2^-24 (:257-262)
//   demand = base + #{F in table : u >= F} (:265-288); a binary search over
//            the nondecreasing table gives the same count as the linear
//            compare, in log2(len) steps instead of len.
#pragma once

#include "net_topo.cuh"

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

// Actions act[0, n_ro) and demand dem[0, n_rt) of one (lane, episode,
// period).
__device__ __forceinline__ void draw_period(const NetTopo& tp,
                                            const float* __restrict__ tables,
                                            unsigned seed, unsigned lane,
                                            unsigned e, unsigned t,
                                            float act_scale, float* act,
                                            float* dem) {
  const int n_words = tp.n_ro + tp.n_rt;
  uint4 blk = make_uint4(0u, 0u, 0u, 0u);
  for (int w = 0; w < n_words; ++w) {
    const int c = w & 3;
    if (c == 0)
      blk = philox4x32_10(make_uint4(lane, e, t, (unsigned)(w >> 2)),
                          make_uint2(seed, 0u));
    const unsigned word = c == 0 ? blk.x : c == 1 ? blk.y : c == 2 ? blk.z : blk.w;
    const float u24 = (float)(word >> 8);  // exact: u24 < 2^24
    if (w < tp.n_ro) {
      act[w] = u24 * act_scale;
    } else {
      const int j = w - tp.n_ro;
      const float* tab = tables + tp.rt_off[j];
      if (tp.rt_const[j])
        dem[j] = tab[min((int)t, tp.rt_len[j] - 1)];
      else
        dem[j] = tp.rt_base[j] +
                 (float)count_le(tab, tp.rt_len[j], u24 * 5.9604644775390625e-8f);
    }
  }
}
