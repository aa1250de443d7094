"""Philox4x32-10 in plain PyTorch, the twin of ``csrc/philox.cuh``.

The JAX package's kernels drew from the TPU's hardware generator
(``pltpu.prng_seed`` / ``prng_random_bits``), which exists neither on a GPU
nor in interpret mode. The port's kernels use the counter-based Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011)
instead. This module computes the same words on int64 tensors holding
unsigned 32-bit values, so the plain versions of the kernels draw exactly
the kernels' bits: ``csrc/philox.cuh`` must give bit-identical words for the
same counter and key.

Stream layout of the episode kernels: key = (seed, 0); counter =
(lane, episode, period, block). Per (lane, episode, period) the words are
numbered w = 0, 1, ...: the n_ro action words, then the n_rt demand words;
word w is component w % 4 of the block w // 4.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
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


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox4x32 rounds of the counter (c0, c1, c2, c3) under the key
    (k0, k1). Counters are int64 tensors (broadcastable) or ints holding
    values in [0, 2**32); returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in (c0, c1, c2, c3))
    k0, k1 = k0 & MASK32, k1 & MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & MASK32, (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def period_words(seed: int, lanes: torch.Tensor, episode: int, period: int,
                 n_words: int):
    """The ``n_words`` words of every lane in ``lanes`` (int64 tensor) for
    one (episode, period): a list of ``n_words`` int64 tensors shaped like
    ``lanes``."""
    words = []
    for blk in range((n_words + 3) // 4):
        words.extend(philox4x32_10(lanes, episode, period, blk, seed, 0))
    return words[:n_words]
