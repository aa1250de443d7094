"""Host float64 CDF tables for inversion sampling.

Copied from ``or_gym_inventory_tpu/ops/distributions.py`` (the NumPy part:
``_accumulate_cdf``, ``discrete_cdf_table``, ``cdf_table_for_spec``), so that
the port's samplers and CUDA kernels invert exactly the thresholds the JAX
package's kernels bake in. tests/test_torch_topology.py holds every named spec
equal to the original.

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
    with ``generator`` on ``dev``: the JAX env's samplers
    (ops/distributions.py sample_*), for a spec whose support is too wide for
    an inversion table. Both envs' ``sample_demand`` take it there."""
    f32 = dict(dtype=torch.float32, device=dev)
    tag = spec[0]
    if tag == "poisson":
        return torch.poisson(torch.full((batch,), float(spec[1]), **f32),
                             generator=generator)
    if tag == "binomial":
        return torch.binomial(torch.full((batch,), float(spec[1]), **f32),
                              torch.full((batch,), float(spec[2]), **f32),
                              generator=generator)
    if tag == "negbinomial":
        # failures before the n-th success: Poisson(Gamma(n) * (1 - p) / p)
        n, p = float(spec[1]), float(spec[2])
        lam = torch._standard_gamma(torch.full((batch,), n, **f32),
                                    generator=generator) * ((1.0 - p) / p)
        return torch.poisson(lam, generator=generator)
    if tag == "randint":
        return torch.randint(int(spec[1]), int(spec[2]), (batch,),
                             generator=generator, device=dev).to(torch.float32)
    if tag == "geometric":
        return torch.empty((batch,), **f32).geometric_(float(spec[1]),
                                                      generator=generator)
    if tag == "normal":
        x = torch.normal(float(spec[1]), float(spec[2]), (batch,),
                         generator=generator, **f32)
        return torch.clamp_min(torch.round(x), 0.0)
    raise NotImplementedError(f"no sampler for demand spec {tag!r}")
