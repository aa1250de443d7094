"""Carrying NetInvMgmt parameters and state across from the JAX package.

Both functions take plain Python and NumPy values, so the JAX package is
never imported here: a caller passes ``dataclasses.asdict(jax_params.topology)``
and the JAX state's arrays through ``numpy.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs.net_inv_management import NetInvParams, NetInvState
from or_gym_inventory_torch.envs.topology import Topology


def _tuples(x):
    """Lists (and NumPy arrays) back to the tuples a Topology holds."""
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_tuples(v) for v in x)
    return x


def net_params_from_numpy(topology_fields: dict, num_periods: int,
                          backlog: bool, alpha: float) -> NetInvParams:
    """The port's NetInvParams from a JAX topology's fields
    (``dataclasses.asdict``) and the three scalars of its params."""
    topology = Topology(**{k: _tuples(v) for k, v in topology_fields.items()})
    return NetInvParams(topology=topology, num_periods=int(num_periods),
                        backlog=bool(backlog), alpha=float(alpha)).validate()


def net_state_from_numpy(X, Y, U, r_hist, period, device=None) -> NetInvState:
    """The port's batched NetInvState from a JAX NetInvState stacked over B:
    X (B, n_main), Y (B, n_reorder), U (B, n_retail),
    r_hist (B, lt_max, n_reorder), period (B,)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return NetInvState(X=f32(X), Y=f32(Y), U=f32(U), r_hist=f32(r_hist),
                       period=torch.tensor(np.asarray(period, np.int32), device=dev))
