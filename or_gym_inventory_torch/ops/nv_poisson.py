"""Newsvendor's Poisson(mu) demand by inversion, as the episode kernels
draw it (port of ``pallas_episode_kernels._nv_window``,
``_nv_poisson_setup`` and ``_nv_poisson_invert``).

A lane's demand is ``#{k : F(k) <= u}`` for a 24-bit uniform u, counted
over a window of K = 2 Wb + 1 terms of the pmf below a cutoff kc. The plain
versions of K13-K17 and the seeded evaluators (``envs.newsvendor.
seeded_draws``) draw through ``demand``; ``csrc/nv_step.cuh`` holds the same
operations. The module imports no env, so the env and the kernels' module
both import it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

TAIL_Z = 5.75            # one-sided normal tail ~4.5e-9 at Z=5.75
TAIL_PAD = 6             # absolute slack on top of Z*sqrt(mu) (small-mu skew)


def window(params):
    """(Wb, K, lgamma_consts): worst-case half-width, the recurrence's steps
    and float64 lgamma(k+1) for every reachable cutoff kc
    (pallas_episode_kernels._nv_window)."""
    mu_max = max(float(params.mu_max), 1.0)
    Wb = int(math.ceil(TAIL_Z * math.sqrt(mu_max))) + TAIL_PAD
    kc_max = int(math.floor(mu_max)) + Wb
    return Wb, 2 * Wb + 1, tuple(float(math.lgamma(k + 1)) for k in range(kc_max + 1))


@functools.lru_cache(maxsize=32)
def lgamma_pairs(params) -> np.ndarray:
    """(kc_max + 1, 2) f32: lgamma(k+1) split into hi = f32(x) and
    lo = f32(x - hi) from float64, as JAX splits its constants (:237-242);
    rows 0 and 1 are 0, since lgamma(1) = lgamma(2) = 0."""
    _, _, lgam = window(params)
    out = np.zeros((len(lgam), 2), np.float32)
    for kk in range(2, len(lgam)):
        hi = np.float32(lgam[kk])
        out[kk] = hi, np.float32(lgam[kk] - float(hi))
    return out


def recur(T, comp, p, kf, mu_safe):
    """One step of the descending recurrence: T += p (Kahan-compensated),
    pmf(k-1) = pmf(k) * (k / mu), an exact division."""
    y = p - comp
    t_new = T + y
    comp = (t_new - T) - y
    return t_new, comp, p * (kf / mu_safe), kf - 1.0


def setup(params, mu):
    """Per-episode inversion anchor (mu_safe, kc, pmf(kc), t_total) of (N,)
    f32 ``mu`` (pallas_episode_kernels._nv_poisson_setup), operation for
    operation: the cutoff kc, the hi/lo lgamma pair, the Veltkamp split of
    log(mu), the TwoSum-compensated exponent and the renormalisation total
    of K = 2 Wb + 1 recurrence steps."""
    Wb, K, _ = window(params)
    mu = torch.as_tensor(mu).to(torch.float32)
    one = torch.ones_like(mu)
    mu_safe = torch.maximum(mu, torch.full_like(mu, float(np.float32(1e-6))))
    pad = 2.0 + 4.0 * torch.minimum(mu_safe, one)
    w = torch.ceil(TAIL_Z * torch.sqrt(mu_safe) + pad)
    kc = torch.floor(mu_safe) + torch.minimum(w, torch.full_like(w, float(Wb)))
    pairs = torch.as_tensor(lgamma_pairs(params), device=mu.device)
    row = pairs[torch.nan_to_num(kc).clamp(0, pairs.shape[0] - 1).long()]
    lg_hi = torch.where(kc >= 2.0, row[..., 0], torch.zeros_like(mu))
    lg_lo = torch.where(kc >= 2.0, row[..., 1], torch.zeros_like(mu))
    logmu = torch.log(mu_safe)
    s = logmu * 4097.0                      # Veltkamp split: 12-bit head
    head = s - (s - logmu)
    tail = logmu - head
    a1 = kc * head                          # exact: 9 + 12 bits < 24
    A = a1 - lg_hi                          # TwoSum-compensated cancels
    t1 = A - a1
    e1 = (a1 - (A - t1)) - (lg_hi + t1)
    B = A - mu_safe
    t2 = B - A
    e2 = (A - (B - t2)) - (mu_safe + t2)
    g = B + (e1 + e2 + kc * tail - lg_lo)
    p_c = torch.exp(g)
    p, T, comp, kf = p_c, torch.zeros_like(p_c), torch.zeros_like(p_c), kc
    for _ in range(K):
        T, comp, p, kf = recur(T, comp, p, kf, mu_safe)
    return mu_safe, kc, p_c, T


def invert(mu_safe, kc, p_c, t_total, K, us):
    """demand_i = #{k : F(k) <= u_i} for each (N,) uniform in the list ``us``
    (pallas_episode_kernels._nv_poisson_invert): one shared descending
    suffix-sum recurrence of K steps, per-u compare-accumulate, thresholds
    v = (1 - u) * t_total. Returns a list of (N,) f32 demands."""
    vs = (1.0 - torch.stack(list(us))) * t_total   # 1 - u exact for 24-bit uniforms
    cnt = torch.zeros_like(vs)
    p, T, comp, kf = p_c, torch.zeros_like(p_c), torch.zeros_like(p_c), kc
    for _ in range(K):
        cnt += (T < vs).to(torch.float32)
        T, comp, p, kf = recur(T, comp, p, kf, mu_safe)
    d = torch.maximum(kc + 1.0 - cnt, torch.zeros_like(cnt))
    return list(d)


def demand(params, mu, us):
    """The (N,) f32 Poisson(``mu``) demand of each (N,) uniform in the list
    ``us``, as a list: ``invert`` at ``setup``'s anchor for ``mu``."""
    _, K, _ = window(params)
    return invert(*setup(params, mu), K, us)
