"""Demand samplers, host float64 CDF tables for inversion sampling, and the
Poisson quantile.

Port of ``or_gym_inventory_tpu/ops/distributions.py``:

- the named samplers (``sample_poisson``, ``sample_binomial``,
  ``sample_randint``, ``sample_geometric``, ``sample_negbinomial``,
  ``sample_normal_rounded``), each drawing a batch of int32 from a
  ``torch.Generator``, and ``make_demand_sampler`` over the five demand
  modes; ``sample_from_law`` draws a named spec's law through them;
- the NumPy part (``_accumulate_cdf``, ``discrete_cdf_table``,
  ``cdf_table_for_spec``), copied so that the port's samplers and CUDA
  kernels invert exactly the thresholds the JAX package's kernels bake in
  (tests/test_torch_topology.py holds every named spec equal to the
  original);
- ``poisson_cdf`` and ``poisson_ppf``, the device form of
  ``scipy.stats.poisson.ppf`` the heuristic agents use. JAX bisects on the
  f32 gammaincc and refines with a series up to mu 16,000; the port bisects
  on the float64 gammaincc, which is exact against scipy without a
  refinement, past mu 2,000 (where JAX's f32 misses by up to 3) too.

``demand = base + #{F in thresholds : F <= u}`` for a 24-bit uniform u is an
exact draw of the spec's law up to the uniform's resolution. The torch sampler
that inverts these tables is ``envs.net_inv_management.sample_demand``; the
kernels invert the same tables with ``count_le`` of ``csrc/philox.cuh``.
"""

from __future__ import annotations

from typing import Dict

import torch

# Demand mode selectors (match reference `dist` integers, inventory_management.py:163)
POISSON, BINOMIAL, RANDINT, GEOMETRIC, USER = 1, 2, 3, 4, 5


def _shape_device(generator: torch.Generator, shape, device):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return shape, torch.device(device) if device is not None else generator.device


def sample_poisson(generator: torch.Generator, lam, shape=(), device=None) -> torch.Tensor:
    """Poisson(lam) draws of ``shape``, int32 (JAX sample_poisson)."""
    shape, dev = _shape_device(generator, shape, device)
    rate = torch.broadcast_to(torch.as_tensor(lam, dtype=torch.float32, device=dev), shape)
    return torch.poisson(rate.contiguous(), generator=generator).to(torch.int32)


def sample_binomial(generator: torch.Generator, n, p, shape=(), device=None) -> torch.Tensor:
    """Binomial(n, p) draws of ``shape``, int32."""
    shape, dev = _shape_device(generator, shape, device)
    f32 = dict(dtype=torch.float32, device=dev)
    return torch.binomial(torch.full(shape, float(n), **f32), torch.full(shape, float(p), **f32),
                          generator=generator).to(torch.int32)


def sample_randint(generator: torch.Generator, low, high_inclusive, shape=(),
                   device=None) -> torch.Tensor:
    """Uniform integers on [low, high] inclusive (the reference adds +1 to
    high for np_random.integers, inventory_management.py:177), int32."""
    shape, dev = _shape_device(generator, shape, device)
    return torch.randint(int(low), int(high_inclusive) + 1, shape, generator=generator,
                         device=dev).to(torch.int32)


def sample_geometric(generator: torch.Generator, p, shape=(), device=None) -> torch.Tensor:
    """Geometric on {1, 2, ...} (the number of trials, numpy's
    Generator.geometric, inventory_management.py:180), int32."""
    shape, dev = _shape_device(generator, shape, device)
    return torch.empty(shape, dtype=torch.float32, device=dev).geometric_(
        float(p), generator=generator).to(torch.int32)


def sample_negbinomial(generator: torch.Generator, n, p, shape=(), device=None) -> torch.Tensor:
    """Negative binomial as numpy's ``negative_binomial(n, p)`` (failures
    before the n-th success), by the Gamma(n, (1-p)/p) - Poisson mixture:
    the gamma draws first, then the Poisson draws, both from ``generator``.
    int32."""
    shape, dev = _shape_device(generator, shape, device)
    n, p = float(n), float(p)
    lam = torch._standard_gamma(torch.full(shape, n, dtype=torch.float32, device=dev),
                                generator=generator) * ((1.0 - p) / p)
    return torch.poisson(lam, generator=generator).to(torch.int32)


def sample_normal_rounded(generator: torch.Generator, loc, scale, shape=(),
                          device=None) -> torch.Tensor:
    """Normal(loc, scale) rounded half-even and clamped at 0, as the
    reference wraps every sampled demand in ``max(0, int(round(.)))``
    (network_management.py:263, 540). int32."""
    shape, dev = _shape_device(generator, shape, device)
    x = torch.normal(float(loc), float(scale), shape, generator=generator,
                     dtype=torch.float32, device=dev)
    return torch.clamp_min(torch.round(x), 0.0).to(torch.int32)


def make_demand_sampler(dist: int, dist_param: Dict, user_D=None):
    """``sample(generator, t, batch, device) -> (batch,) int32`` demand for
    one of the five modes (JAX make_demand_sampler). ``t`` (the period) is
    read only by USER, which gives ``user_D[t]`` and 0 past its end
    (inventory_management.py:181-182)."""
    if dist == POISSON:
        lam = float(dist_param["mu"])
        return lambda generator, t, batch, device=None: sample_poisson(generator, lam, batch,
                                                                       device)
    if dist == BINOMIAL:
        n, p = int(dist_param["n"]), float(dist_param["p"])
        return lambda generator, t, batch, device=None: sample_binomial(generator, n, p, batch,
                                                                        device)
    if dist == RANDINT:
        low, high = int(dist_param["low"]), int(dist_param["high"])
        return lambda generator, t, batch, device=None: sample_randint(generator, low, high,
                                                                       batch, device)
    if dist == GEOMETRIC:
        p = float(dist_param["p"])
        return lambda generator, t, batch, device=None: sample_geometric(generator, p, batch,
                                                                         device)
    if dist == USER:
        values = [int(v) for v in user_D]

        def user(generator, t, batch, device=None):
            dev = device if device is not None else generator.device
            t = int(t)
            v = values[t] if 0 <= t < len(values) else 0
            return torch.full((batch,), v, dtype=torch.int32, device=dev)
        return user
    raise ValueError(f"Invalid distribution choice: {dist}")

_TABLE_CAP = 4096  # largest inversion table a link may have


def _accumulate_cdf(pmf_iter, base, granularity):
    """Shared threshold accumulator for every table constructor: stop at the
    first F with tail mass below the uniform's resolution (same convention
    as ops/net_step._poisson_cdf_table); REFUSE loudly if the
    support does not fit the cap — silently truncating a wide
    distribution would make the kernel sample the wrong law."""
    import numpy as np
    F = 0.0
    table = []
    for p in pmf_iter:
        F += p
        table.append(F)
        if 1.0 - F <= granularity:
            break
        if len(table) >= _TABLE_CAP:
            raise NotImplementedError(
                f"demand distribution support exceeds the {_TABLE_CAP}-entry "
                f"inversion-table cap (mass covered: {F:.6f}); pre-sample "
                "this distribution instead")
    return base, tuple(float(np.float32(v)) for v in table)


def discrete_cdf_table(dist: int, dist_param: Dict,
                       granularity: float = 2.0 ** -24):
    """Host-side CDF thresholds for inversion sampling.

    Returns ``(base, thresholds)`` such that ``demand = base + #{F in
    thresholds : F <= u}`` for u ~ Uniform[0,1) is an EXACT draw from the
    distribution, up to the uniform's resolution (``granularity`` — the
    kernels invert a 24-bit uniform). Thresholds are computed in float64 and
    returned as Python floats pre-rounded to f32 (the dtype the kernel
    compares in). A distribution whose support exceeds the cap raises
    NotImplementedError rather than silently truncating.

    Supports POISSON / BINOMIAL / RANDINT / GEOMETRIC. USER mode is
    deterministic per period (no sampling) and raises ValueError here.
    """
    import numpy as np

    def _truncate(pmf_iter, base):
        return _accumulate_cdf(pmf_iter, base, granularity)

    if dist == POISSON:
        lam = float(dist_param["mu"])
        if lam <= 0.0:
            return 0, ()

        def pmf():
            p = float(np.exp(-lam))
            k = 0
            while True:
                yield p
                k += 1
                p *= lam / k

        return _truncate(pmf(), 0)
    if dist == BINOMIAL:
        n, p = int(dist_param["n"]), float(dist_param["p"])
        if p <= 0.0:
            return 0, ()
        if p >= 1.0:
            return n, ()

        def pmf():
            q = float(np.exp(n * np.log1p(-p)))  # (1-p)^n, log-safe
            r = p / (1.0 - p)
            for k in range(n + 1):
                yield q
                q *= r * (n - k) / (k + 1.0)

        return _truncate(pmf(), 0)
    if dist == RANDINT:
        low, high = int(dist_param["low"]), int(dist_param["high"])
        span = high - low + 1
        if span - 1 > _TABLE_CAP:
            raise NotImplementedError(
                f"randint span {span} exceeds the {_TABLE_CAP}-entry "
                "inversion-table cap; pre-sample this distribution instead")
        return low, tuple(float(np.float32((k + 1) / span))
                          for k in range(span - 1))
    if dist == GEOMETRIC:
        p = float(dist_param["p"])

        def pmf():
            q = p  # P(X=1); support {1, 2, ...} per numpy Generator.geometric
            while True:
                yield q
                q *= (1.0 - p)

        return _truncate(pmf(), 1)
    raise ValueError(f"No inversion table for dist={dist} "
                     "(USER mode is deterministic per period)")


def cdf_table_for_spec(spec, granularity: float = 2.0 ** -24):
    """``(base, thresholds)`` for a named retail-link demand spec
    (envs/topology.Topology.rt_demand) — the inversion form of every
    STATIC-parameter distribution the network env supports
    (network_management.py:240-267 resolves per-edge demand callables; the
    topology compiler names them).

    Handles ``poisson``/``binomial``/``geometric`` (via
    ``discrete_cdf_table``), ``randint`` (numpy ``integers`` high-EXCLUSIVE
    semantics), ``negbinomial`` (failures before the n-th success, numpy
    ``negative_binomial``), and ``normal`` (demand is ``max(0, round(X))``
    for X ~ N(loc, scale) — itself a discrete distribution with static
    parameters: F(k) = Phi((k + 0.5 - loc)/scale)).
    Returns ``None`` for per-period-DETERMINISTIC specs (``user``/``zero``);
    raises NotImplementedError for ``hostfn`` (an arbitrary host callable).
    """
    import math

    tag = spec[0]
    if tag in ("user", "zero"):
        return None
    if tag == "poisson":
        return discrete_cdf_table(POISSON, {"mu": spec[1]}, granularity)
    if tag == "binomial":
        return discrete_cdf_table(BINOMIAL, {"n": spec[1], "p": spec[2]},
                                  granularity)
    if tag == "randint":
        low, high_ex = int(spec[1]), int(spec[2])
        return discrete_cdf_table(RANDINT, {"low": low, "high": high_ex - 1},
                                  granularity)
    if tag == "geometric":
        return discrete_cdf_table(GEOMETRIC, {"p": spec[1]}, granularity)
    if tag == "negbinomial":
        n, p = float(spec[1]), float(spec[2])
        if p >= 1.0:
            return 0, ()

        def pmf():
            # pmf(0) = p^n; pmf(k+1) = pmf(k) * (1-p) * (n+k) / (k+1), in
            # LOG space: p^n itself can underflow float64.
            log_q = n * math.log(p)
            log_1mp = math.log1p(-p)
            k = 0
            while True:
                yield math.exp(log_q)
                log_q += log_1mp + math.log((n + k) / (k + 1.0))
                k += 1

        return _accumulate_cdf(pmf(), 0, granularity)
    if tag == "normal":
        loc, scale = float(spec[1]), float(spec[2])
        if scale <= 0.0:
            return max(0, int(round(loc))), ()
        inv = 1.0 / (scale * math.sqrt(2.0))
        # start the table 9 sigma below loc (left-tail mass ~1e-19, far
        # under the 24-bit uniform's resolution)
        base = max(0, int(math.floor(loc - 9.0 * scale)))

        def pmf():
            prev = 0.0
            k = base
            while True:
                F = 0.5 * (1.0 + math.erf((k + 0.5 - loc) * inv))
                yield F - prev
                prev = F
                k += 1

        return _accumulate_cdf(pmf(), base, granularity)
    raise NotImplementedError(
        f"no compile-time inversion for demand spec {tag!r} (an arbitrary "
        "host callable); pre-sample demand or use a named spec")


def sample_from_law(spec, generator: torch.Generator, batch: int, dev):
    """(batch,) float32 draws of a static named spec from its law itself,
    with ``generator`` on ``dev``, through the named samplers above (as the
    JAX env draws them), for a spec whose support is too wide for an
    inversion table. Both envs' ``sample_demand`` take it there."""
    tag = spec[0]
    if tag == "poisson":
        d = sample_poisson(generator, float(spec[1]), batch, dev)
    elif tag == "binomial":
        d = sample_binomial(generator, spec[1], spec[2], batch, dev)
    elif tag == "negbinomial":
        d = sample_negbinomial(generator, spec[1], spec[2], batch, dev)
    elif tag == "randint":   # the spec's high is exclusive (numpy ``integers``)
        d = sample_randint(generator, spec[1], int(spec[2]) - 1, batch, dev)
    elif tag == "geometric":
        d = sample_geometric(generator, spec[1], batch, dev)
    elif tag == "normal":
        d = sample_normal_rounded(generator, spec[1], spec[2], batch, dev)
    else:
        raise NotImplementedError(f"no sampler for demand spec {tag!r}")
    return d.to(torch.float32)


# ------------------------------------------------------------------ quantile

def poisson_cdf(k: torch.Tensor, mu) -> torch.Tensor:
    """P(X <= k) for X ~ Poisson(mu), k floored, 0 for k < 0, in ``k``'s
    dtype: gammaincc(floor(k) + 1, mu)."""
    k = torch.as_tensor(k)
    mu = torch.as_tensor(mu, dtype=k.dtype, device=k.device)
    kf = torch.floor(torch.clamp_min(k, -1.0))
    return torch.where(kf < 0, torch.zeros_like(kf),
                       torch.special.gammaincc(torch.clamp_min(kf, 0.0) + 1.0, mu))


def poisson_ppf(q, mu, max_k: int = 1 << 22) -> torch.Tensor:
    """The smallest integer k with CDF(k; mu) >= q (scipy.stats.poisson.ppf's
    semantics), f32. q and mu are cast to f32 first, as JAX does, then
    broadcast; ``max_k.bit_length()`` bisection steps on the float64
    gammaincc, a fixed count (no data-dependent loop, so no host sync).
    q <= 0 gives 0 and q >= 1 gives ``max_k``, JAX's edge rules."""
    q = torch.as_tensor(q, dtype=torch.float32)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=q.device)
    q, mu = torch.broadcast_tensors(q, mu)
    q64, mu64 = q.double(), mu.double()
    lo = torch.zeros_like(mu64)
    hi = torch.full_like(mu64, float(max_k))
    for _ in range(max_k.bit_length()):
        mid = torch.floor((lo + hi) * 0.5)
        ok = poisson_cdf(mid, mu64) >= q64     # mid is an upper bound
        lo = torch.where(ok, lo, mid + 1.0)
        hi = torch.where(ok, mid, hi)
    out = torch.where(q <= 0.0, 0.0, hi.to(torch.float32))
    return torch.where(q >= 1.0, float(max_k), out)
