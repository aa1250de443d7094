"""NumPy-parity RNG: reproduce the reference's randomness draw-for-draw.

A verbatim copy of ``or_gym_inventory_tpu/core/parity.py`` (NumPy only), kept
so that the PyTorch port can replay the seed-42 goldens without importing the
JAX package.

The reference samples from ``self.np_random`` — the PCG64 Generator that
``gymnasium.Env.reset(seed=...)`` installs (pinned by the reference's own
test.py:1-11: ``gymnasium.utils.seeding.np_random(seed)``). JAX's threefry
cannot reproduce those bit streams, so exact trajectory parity is achieved at
the *demand-stream level*: this module replays the reference's draws in its
exact order on host, and the resulting streams are injected into the jitted
dynamics (the reference itself has this injection hook: ``user_D``/``dist=5``
at inventory_management.py:181-182 and per-edge ``user_D`` at
network_management.py:249-255).

Draw-order contracts replicated here:
- Newsvendor reset: 5 sequential uniforms with conditional scaling
  (newsvendor.py:105-111), then one Poisson(mu) per step (:146).
- InvManagement: one demand draw per step from the dist selector
  (inventory_management.py:169-184).
- NetInvMgmt: per step, one draw per retail link in retail-link declaration
  order (network_management.py:536-540 iterates ``self.retail_links``).

The JAX counter-based RNG remains the performance path; this is the
correctness oracle.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def reference_rng(seed: int) -> np.random.Generator:
    """The exact Generator gymnasium's Env.reset(seed) creates."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))


# ---------------------------------------------------------------- newsvendor

def newsvendor_reset_draws(rng: np.random.Generator,
                           p_max: float, h_max: float, k_max: float,
                           mu_max: float) -> Tuple[float, float, float, float, float]:
    """The 5 sequential conditional uniforms of newsvendor.py:105-111."""
    price = max(1.0, rng.random() * p_max)
    cost = max(1.0, rng.random() * price)
    h = rng.random() * min(cost, h_max)
    k = rng.random() * k_max
    mu = rng.random() * mu_max
    return price, cost, h, k, mu


def newsvendor_demand_stream(rng: np.random.Generator, mu: float, n_steps: int) -> np.ndarray:
    """One Poisson(mu) per step, drawn sequentially (newsvendor.py:146)."""
    return np.array([rng.poisson(mu) for _ in range(n_steps)], dtype=np.int64)


# ----------------------------------------------------------- inv management

def inv_management_demand_stream(rng: np.random.Generator, dist: int,
                                 dist_param: Dict, n_steps: int,
                                 user_D: Sequence[int] = ()) -> np.ndarray:
    """One demand draw per step per inventory_management.py:169-184."""
    out = np.zeros(n_steps, dtype=np.int64)
    for t in range(n_steps):
        if dist == 1:
            d = rng.poisson(lam=dist_param["mu"])
        elif dist == 2:
            d = rng.binomial(n=dist_param["n"], p=dist_param["p"])
        elif dist == 3:
            d = rng.integers(low=dist_param["low"], high=dist_param["high"] + 1)
        elif dist == 4:
            d = rng.geometric(p=dist_param["p"])
        elif dist == 5:
            d = user_D[t] if t < len(user_D) else 0
        else:
            raise ValueError(f"Invalid dist {dist}")
        out[t] = max(0, int(d))
    return out


# ------------------------------------------------------------- net inv mgmt

def net_inv_demand_stream(rng: np.random.Generator,
                          retail_dist_params: Sequence[Dict],
                          n_steps: int) -> np.ndarray:
    """Per-step, per-retail-link draws in link order (network_management.py:536-540).

    ``retail_dist_params`` is one dict per retail link in declaration order.
    Each dict is either ``{'user_D': array}`` (used verbatim, the reference's
    user_D-without-sample_path mode, network_management.py:250-255), a named
    spec ``{'dist': name, **numpy-kwargs}`` (``Topology.retail_dist_params``
    emits these for poisson/binomial/negbinomial/randint/geometric/normal),
    bare poisson params ``{'lam': float}`` (the default ``demand_dist_func``,
    network_management.py:123-127), or ``{'dist': 'hostfn', 'func': f, ...}``
    (the callable is invoked with the remaining kwargs). Returns shape
    (n_steps, n_links) int64.
    """
    n_links = len(retail_dist_params)
    out = np.zeros((n_steps, n_links), dtype=np.int64)
    for t in range(n_steps):
        for j, spec in enumerate(retail_dist_params):
            name = spec.get("dist")
            if "user_D" in spec:
                arr = spec["user_D"]
                d = arr[min(t, len(arr) - 1)]
            elif name == "poisson" or (name is None and "lam" in spec):
                d = rng.poisson(lam=spec["lam"])
            elif name == "binomial":
                d = rng.binomial(n=int(spec["n"]), p=spec["p"])
            elif name == "negbinomial":
                d = rng.negative_binomial(n=spec["n"], p=spec["p"])
            elif name == "randint":
                d = rng.integers(low=int(spec["low"]), high=int(spec["high"]))
            elif name == "geometric":
                d = rng.geometric(p=spec["p"])
            elif name == "normal":
                d = rng.normal(loc=spec["loc"], scale=spec["scale"])
            elif name == "hostfn":
                kwargs = {k: v for k, v in spec.items()
                          if k not in ("dist", "func")}
                d = spec["func"](**kwargs)
            else:
                raise ValueError(f"Unsupported retail demand spec: {spec}")
            out[t, j] = max(0, int(round(float(d))))
    return out
