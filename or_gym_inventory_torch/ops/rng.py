"""Philox4x32-10 in plain PyTorch, the twin of ``csrc/philox.cuh``.

The JAX package's kernels drew from the TPU's hardware generator
(``pltpu.prng_seed`` / ``prng_random_bits``), which exists neither on a GPU
nor in interpret mode. The port's kernels use the counter-based Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011)
instead. This module computes the same words on int64 tensors holding
unsigned 32-bit values, so the plain versions of the kernels draw exactly
the kernels' bits: ``csrc/philox.cuh`` must give bit-identical words for the
same counter and key.

Stream layout: counter = (lane, episode, period, block). Per (lane, episode,
period) the words are numbered w = 0, 1, ...; word w is component w % 4 of
the block w // 4.

- Random-policy kernels (K2, K3), key = (seed, 0): the n_ro action words,
  then the n_rt demand words.
- Policy kernels (K4-K6), key = (seed, ``POLICY_KEY``) = (seed, 1), so that
  their stream differs from K2's for the same seed: the n_rt demand words,
  then, when the policy is stochastic, the n_ro u1 words and the n_ro u2
  words of the Box-Muller normals. This is the order in which the JAX
  kernels consume their draws: demand before the policy
  (pallas_net_step.py:528, :654), u1 before u2
  (pallas_episode_kernels.py:69-70).
- The in-kernel random actions of K26 are K2's: under (seed, 0), the first
  n_ro words of episode 0's period block, so K26 on K3's demand gives K2's
  returns.
- The off-policy heads of the trajectory kernels (K27-K29), key (seed, 1):
  per period the family's demand word(s) first, exactly as K4/K10/K18 draw
  them, so the demand of seed s is theirs bit for bit; then, for ``det``
  and ``sac``, the act_dim u1 and the act_dim u2 words of the Box-Muller
  normals, and for ``uniform`` the act_dim u1 words alone, as 24-bit
  uniforms (a_norm = 2 u - 1).
- The seeded evaluators (``vector.vecenv.evaluate_episodes_seeded``), key
  (seeds[i], ``SEEDED_KEY``) = (seeds[i], 2) a lane, counter (0, 0, period,
  block): lane i's words depend on ``seeds[i]`` alone, not on its index or
  batch (``seeded_words``). Per period the family's env draws: one demand
  word (InvManagement), one word a retail link, const links too
  (NetInvMgmt), one demand word (Newsvendor, whose reset's five words are
  those of period ``SEEDED_RESET_PERIOD`` = 0xFFFFFFFF, the kernels' layout).
  A demand law past the inversion table's cap (InvManagement's, or retail
  link j's) takes words 0 and 1 of the counter (0, 1 + j, period, 0) instead,
  a 53-bit uniform (``distributions.seeded_law_draws``).
- The ranks of a data-parallel run (``parallel.mesh``), key (seed,
  ``RANK_KEY``) = (seed, 3), counter (rank, 0, 0, 0): word 0 masked to 31
  bits is the rank's seed (``rank_seed``), where the JAX package folded the
  axis index into a replicated key.

A word becomes a uniform as ``(word >> 8) * 2**-24`` (24 bits, exact in
f32), and two uniforms a normal as ``sqrt(-2 ln(1 - u1)) * cos(2 pi u2)``
(``normal01``). The words are bit for bit the kernels'; the normals may
differ from the card's by an ulp, since ``logf``/``cosf`` there and the CPU's
``log``/``cos`` are different implementations.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
POLICY_KEY = 1                       # key[1] of the policy kernels' stream
SEEDED_KEY = 2                       # key[1] of the seeded evaluators' streams
SEEDED_RESET_PERIOD = MASK32         # the period of Newsvendor's reset words
RANK_KEY = 3                         # key[1] of the ranks' seeds
TWO_PI_F32 = 6.2831854820251465      # f32(2 pi), as the JAX kernels round it
_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # Weyl key increments


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product a * b, for a constant
    a < 2**32 and int64 ``b`` in [0, 2**32). b is split into 16-bit halves
    so that no product leaves int64's range."""
    p_lo = a * (b & 0xFFFF)          # < 2**48
    p_hi = a * (b >> 16)             # < 2**48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Ten Philox4x32 rounds of the counter (c0, c1, c2, c3) under the key
    (k0, k1). Counters are int64 tensors (broadcastable) or ints holding
    values in [0, 2**32); so is each key half, a tensor of them broadcast
    against the counters (a key a lane). Returns the four output words as
    int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in (c0, c1, c2, c3))
    k0, k1 = (k.to(torch.int64) & MASK32 if isinstance(k, torch.Tensor) else k & MASK32
              for k in (k0, k1))
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def period_words(seed: int, lanes: torch.Tensor, episode, period: int,
                 n_words: int, key1: int = 0):
    """The ``n_words`` words of every lane in ``lanes`` (int64 tensor) for
    one period of ``episode`` (an int, or an int64 tensor shaped like
    ``lanes``) under the key (seed, key1): a list of ``n_words`` int64
    tensors shaped like ``lanes``."""
    words = []
    for blk in range((n_words + 3) // 4):
        words.extend(philox4x32_10(lanes, episode, period, blk, seed, key1))
    return words[:n_words]


def seeded_words(seeds: torch.Tensor, period: int, n_words: int, stream: int = 0):
    """The ``n_words`` words of ``period`` for each lane of ``seeds`` (B,)
    under the key (seeds[i], ``SEEDED_KEY``) and the counter (0, ``stream``,
    period, block): a list of ``n_words`` int64 tensors shaped like
    ``seeds``. The lane index is in neither, so lane i's words depend on
    ``seeds[i]`` alone. Stream 0 holds the env draws; stream 1 + j a wide
    law's draws for retail link j (``distributions.seeded_law_draws``)."""
    seeds = torch.as_tensor(seeds).to(torch.int64) & MASK32
    zero = torch.zeros_like(seeds)
    words = []
    for blk in range((n_words + 3) // 4):
        words.extend(w.expand(seeds.shape)
                     for w in philox4x32_10(zero, stream, period, blk, seeds, SEEDED_KEY))
    return words[:n_words]


def rank_seed(seed: int, rank: int) -> int:
    """The 31-bit seed of ``rank`` in a data-parallel run whose replicated
    seed is ``seed``: word 0 of the counter (rank, 0, 0, 0) under the key
    (seed, ``RANK_KEY``), masked to 31 bits."""
    return int(philox4x32_10(rank, 0, 0, 0, seed, RANK_KEY)[0]) & 0x7FFFFFFF


def uniform01(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The 24-bit uniform in [0, 1) of each word, as ``dtype`` (exact in
    float32 and float64 alike)."""
    return (words >> 8).to(dtype) * (2.0 ** -24)


def normal01(w1: torch.Tensor, w2: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Box-Muller standard normals from two words each
    (pallas_episode_kernels._normal01): 1 - u1 lies in (0, 1], so the log
    never sees 0 and the radius is at most sqrt(48 ln 2) ~ 5.77. In
    float64 (the plain oracle's twin) the same function of the same
    uniforms, f32(2 pi) included."""
    r = torch.sqrt(-2.0 * torch.log(1.0 - uniform01(w1, dtype)))
    return r * torch.cos(TWO_PI_F32 * uniform01(w2, dtype))
