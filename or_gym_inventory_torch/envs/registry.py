"""Environment registry: name-keyed env creation (port of
``or_gym_inventory_tpu/envs/registry.py``).

The reference registers env creators with Ray's tune registry
(``register_env(name, creator)``, benchmark_NetInvMgmtLostSalesEnv_sb3_rllib
.py:120-133) so that algorithms are configured by env-name string. Two
layers, as in the JAX package:

- ``make_functional(name, env_config=None)`` -> (Environment, params), the
  device path; the eight functional ids of the reference ship registered on
  the port's env modules;
- ``make(name, **config)`` -> a host (Gymnasium) env from a creator given to
  ``register_env``; the port's ``envs.adapters`` classes ship registered
  under the ten reference ids, as the JAX package's do. An id nobody
  registered raises KeyError.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple

from or_gym_inventory_torch.envs import adapters as ad
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import net_inv_management as net
from or_gym_inventory_torch.envs import newsvendor as nv
from or_gym_inventory_torch.envs import topology as topo
from or_gym_inventory_torch.envs.base import Environment

_HOST_REGISTRY: Dict[str, Callable] = {}
_FUNC_REGISTRY: Dict[str, Tuple[Environment, Callable]] = {}

# the reference's host env ids (JAX registry.py:71-82) and their envs.adapters classes
_HOST_CLASSES = {
    "Newsvendor-v0": ad.NewsvendorEnv,
    "CustomizableNewsvendor-v0": ad.CustomizableNewsvendorEnv,
    "InvManagement-v0": ad.InvManagementMasterEnv,
    "InvManagementBacklog-v0": ad.InvManagementBacklogEnv,
    "InvManagementLostSales-v0": ad.InvManagementLostSalesEnv,
    "NetInvMgmt-v0": ad.NetInvMgmtMasterEnv,
    "NetInvMgmtBacklog-v0": ad.NetInvMgmtBacklogEnv,
    "NetInvMgmtLostSales-v0": ad.NetInvMgmtLostSalesEnv,
    "NetInvMgmtCustomBacklog-v0": ad.NetInvMgmtCustomBacklogEnv,
    "NetInvMgmtCustomLostSales-v0": ad.NetInvMgmtCustomLostSalesEnv,
}
REFERENCE_HOST_IDS = tuple(_HOST_CLASSES)


def register_env(name: str, creator: Callable) -> None:
    """Register a host env creator under ``name`` (the Ray registry's analogue)."""
    _HOST_REGISTRY[name] = creator


def register_functional(name: str, env: Environment, params_factory: Callable) -> None:
    """Register an env family and its params factory under ``name``."""
    _FUNC_REGISTRY[name] = (env, params_factory)


def make(name: str, **config):
    """Instantiate a registered host (Gymnasium) env."""
    if name not in _HOST_REGISTRY:
        raise KeyError(f"Unknown env {name!r}; known: {sorted(_HOST_REGISTRY)}")
    return _HOST_REGISTRY[name](**config)


def make_functional(name: str, env_config: Optional[dict] = None):
    """(Environment, params) of a registered functional env."""
    if name not in _FUNC_REGISTRY:
        raise KeyError(f"Unknown env {name!r}; known: {sorted(_FUNC_REGISTRY)}")
    env, factory = _FUNC_REGISTRY[name]
    return env, factory(env_config=env_config)


def registered_envs():
    return sorted(set(_HOST_REGISTRY) | set(_FUNC_REGISTRY))


def _net_custom_params(env_config=None, backlog=True):
    cfg = dict(env_config or {})
    periods = int(cfg.get("num_periods", 30))
    return net.default_params(env_config=cfg, topology=topo.custom_topology(periods),
                              backlog=backlog)


def _register_builtins():
    for name, cls in _HOST_CLASSES.items():
        register_env(name, cls)
    register_functional("Newsvendor-v0", nv.ENV, nv.default_params)
    register_functional("InvManagementBacklog-v0", im.ENV,
                        partial(im.default_params, backlog=True))
    register_functional("InvManagementLostSales-v0", im.ENV,
                        partial(im.default_params, backlog=False))
    register_functional("NetInvMgmtBacklog-v0", net.ENV,
                        partial(net.default_params, backlog=True))
    # The reference's NetInvMgmt LostSales subclasses de facto run
    # backlog=True: the master __init__ overwrites env_config['backlog'] with
    # its kwarg and the subclasses set backlog only via env_config (QUIRKS.md
    # #1; network_management.py:83-85, :747-761). The functional ids match the
    # adapters, or agents built by name train on dynamics the eval env never
    # runs.
    register_functional("NetInvMgmtLostSales-v0", net.ENV,
                        partial(net.default_params, backlog=True))
    register_functional("NetInvMgmtCustomBacklog-v0", net.ENV,
                        partial(_net_custom_params, backlog=True))
    register_functional("NetInvMgmtCustomLostSales-v0", net.ENV,
                        partial(_net_custom_params, backlog=True))


_register_builtins()
