"""Carrying NetInvMgmt and InvManagement parameters and state, PPO,
recurrent PPO and off-policy weights, and statistics across from the JAX
package.

Every function takes plain Python and NumPy values, so the JAX package is
never imported here: a caller passes ``dataclasses.asdict(jax_params.topology)``
or ``dataclasses.asdict(jax_params)``, the JAX state's arrays through
``numpy.asarray``, and a flax parameter tree through
``jax.tree_util.tree_map(numpy.asarray, ...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from or_gym_inventory_torch.agents.ppo import RunningMeanStd
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs.inv_management import (InvManagementParams,
                                                        InvManagementState)
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


def im_params_from_numpy(fields: dict) -> InvManagementParams:
    """The port's InvManagementParams from a JAX InvManagementParams' fields
    (``dataclasses.asdict``)."""
    return InvManagementParams(**{k: _tuples(v) for k, v in fields.items()}).validate()


def im_state_from_numpy(inv, backlog_v, action_hist, r_hist, period,
                        device=None) -> InvManagementState:
    """The port's batched InvManagementState from a JAX InvManagementState
    stacked over B: inv (B, m1), backlog_v (B, m), action_hist and r_hist
    (B, lt_max, m1), period (B,), all int32."""
    dev = resolve_device(device)

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=dev)

    return InvManagementState(inv=i32(inv), backlog_v=i32(backlog_v),
                              action_hist=i32(action_hist), r_hist=i32(r_hist),
                              period=i32(period))


def ppo_params_from_numpy(flax_tree, device=None) -> dict:
    """The state dict of the port's ``MLPActorCritic`` from the flax
    ``MLPActorCritic`` parameters as NumPy arrays:
    ``{"params": {"Dense_i": {"kernel": (in, out), "bias": (out,)}, ...,
    "log_std": (act_dim,)}}``. flax numbers the layers pi trunk, mean head,
    vf trunk, value head; the mean head is the first layer with act_dim
    outputs that is followed by a layer reading the observation (the vf
    trunk's first, or the value head). Kernels are transposed to torch's
    (out, in)."""
    dev = resolve_device(device)
    p = flax_tree["params"]
    n = sum(1 for k in p if k.startswith("Dense_"))
    dense = [p[f"Dense_{i}"] for i in range(n)]
    act_dim = int(np.asarray(p["log_std"]).shape[0])
    obs_dim = int(np.asarray(dense[0]["kernel"]).shape[0])
    n_pi = next(i for i in range(n - 1)
                if np.asarray(dense[i]["kernel"]).shape[1] == act_dim
                and np.asarray(dense[i + 1]["kernel"]).shape[0] == obs_dim)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    names = ([f"pi.{i}" for i in range(n_pi)] + ["mean"]
             + [f"vf.{j}" for j in range(n - n_pi - 2)] + ["value"])
    state = {"log_std": t(p["log_std"])}
    for name, d in zip(names, dense):
        state[f"{name}.weight"] = t(np.asarray(d["kernel"]).T)
        state[f"{name}.bias"] = t(d["bias"])
    return state


def lstm_params_from_numpy(flax_tree, device=None) -> dict:
    """The state dict of the port's ``LSTMActorCritic`` from the flax
    ``LSTMActorCritic`` parameters as NumPy arrays: ``Dense_0`` ..
    ``Dense_{n-1}`` the encoder, ``OptimizedLSTMCell_0`` the cell (input
    kernels ``ii``/``if``/``ig``/``io`` without a bias, recurrent kernels and
    biases ``hi``/``hf``/``hg``/``ho``), ``Dense_n`` the mean head,
    ``Dense_{n+1}`` the value head and ``log_std``. Dense kernels are
    transposed to torch's (out, in); the cell keeps flax's (in, 4h) layout
    with the gates side by side in the order i, f, g, o."""
    dev = resolve_device(device)
    p = flax_tree["params"]
    n_enc = sum(1 for k in p if k.startswith("Dense_")) - 2

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    cell = p["OptimizedLSTMCell_0"]
    state = {"log_std": t(p["log_std"]),
             "cell.wi": t(np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]) for g in "ifgo"],
                                         axis=1)),
             "cell.wh": t(np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]) for g in "ifgo"],
                                         axis=1)),
             "cell.bh": t(np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in "ifgo"]))}
    names = [f"enc.{i}" for i in range(n_enc)] + ["mean", "value"]
    for i, name in enumerate(names):
        d = p[f"Dense_{i}"]
        state[f"{name}.weight"] = t(np.asarray(d["kernel"]).T)
        state[f"{name}.bias"] = t(d["bias"])
    return state


def offpolicy_params_from_numpy(actor_tree, q_tree, stochastic: bool, device=None):
    """The state dicts of the port's off-policy ``_Actor`` and ``TwinQ``
    (``agents/off_policy.py``) from the flax trees as NumPy arrays. The
    actor's ``Dense_*`` layers are the relu trunk, then the mean head and,
    when ``stochastic`` (SAC), the log_std head; the critics'
    ``QNetwork_0`` (and ``QNetwork_1``, absent for DDPG) each hold the trunk
    and then the output layer. Kernels are transposed to torch's (out, in).
    Returns (actor state dict, critics state dict)."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def dense_list(p):
        return [p[f"Dense_{i}"] for i in range(sum(1 for k in p if k.startswith("Dense_")))]

    actor = dense_list(actor_tree["params"])
    n_heads = 2 if stochastic else 1
    names = [f"trunk.{i}" for i in range(len(actor) - n_heads)] + ["mean", "log_std"][:n_heads]
    a_state = {}
    for name, d in zip(names, actor):
        a_state[f"{name}.weight"] = t(np.asarray(d["kernel"]).T)
        a_state[f"{name}.bias"] = t(d["bias"])
    q_state = {}
    qp = q_tree["params"]
    for j in range(sum(1 for k in qp if k.startswith("QNetwork_"))):
        layers = dense_list(qp[f"QNetwork_{j}"])
        for i, d in enumerate(layers):
            name = f"qs.{j}." + (f"trunk.{i}" if i < len(layers) - 1 else "out")
            q_state[f"{name}.weight"] = t(np.asarray(d["kernel"]).T)
            q_state[f"{name}.bias"] = t(d["bias"])
    return a_state, q_state


def rms_from_numpy(mean, var, count, device=None):
    """The port's ``RunningMeanStd`` from a JAX one's three arrays."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return RunningMeanStd(mean=t(mean), var=t(var), count=t(count))
