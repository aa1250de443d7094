"""Whole-episode returns under the uniform-random policy and under a
learned MLP policy.

Port of ``or_gym_inventory_tpu/vector/fast_episodes.random_episode_returns``
and ``policy_episode_returns`` (:42-217): every family's branch of
``random_episode_returns``, and the NetInvMgmt and InvManagement branches of
``policy_episode_returns``. On CUDA the episodes run in the fused kernels
(``ops.net_step.episode_returns_fully_fused``, K2, and
``episode_returns_net_policy``, K5; ``ops.episode_kernels.
episode_returns_im_fused``, K8, ``episode_returns_im_policy``, K11, and
``episode_returns_nv_reset_fused``, K16), on the CPU in their plain
versions. A demand the kernels cannot draw (a ``hostfn`` link, a law beyond
the inversion table's cap) raises NotImplementedError before anything is
launched; a failure to build or launch a kernel propagates. The JAX package
fell back to its XLA rollout there; the port has no such fallback.
"""

from __future__ import annotations

import torch

from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import net_inv_management as net
from or_gym_inventory_torch.envs import newsvendor as nv
from or_gym_inventory_torch.ops import episode_kernels, net_step


def kernel_seed(generator: torch.Generator) -> int:
    """The 31-bit kernel seed ``random_episode_returns`` draws from
    ``generator``; a copy of the generator replays it."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=generator.device).item())


def _check_family(params):
    if not isinstance(params, (net.NetInvParams, im.InvManagementParams,
                               nv.NewsvendorParams)):
        raise TypeError(f"Unknown params type {type(params).__name__}")


def random_episode_returns(params, generator: torch.Generator, batch: int,
                           episodes_per_lane: int = 1, device=None):
    """Per-episode returns under the uniform-random policy, a
    (episodes_per_lane * batch,) float32 tensor, episode-major. The kernel
    seed is drawn from ``generator``, which must live on ``device``.
    InvManagement steps' rewards are already alpha^t-discounted (reference
    semantics), so are its returns; Newsvendor's are gamma^t-discounted in
    the kernel."""
    dev = resolve_device(device)
    E = int(episodes_per_lane)
    if E < 1:
        raise ValueError(f"episodes_per_lane must be >= 1, got {E}")
    _check_family(params)
    if isinstance(params, nv.NewsvendorParams):
        # reset-fused: econ, orders and per-lane Poisson(mu) demand all drawn
        # in the kernel
        return episode_kernels.episode_returns_nv_reset_fused(
            params, kernel_seed(generator), batch, episodes_per_lane=E,
            device=dev).reshape(-1)
    if isinstance(params, im.InvManagementParams):
        episode_kernels._im_demand_spec(params)   # a law beyond the cap raises here
        return episode_kernels.episode_returns_im_fused(
            params, kernel_seed(generator), batch, episodes_per_lane=E,
            device=dev).reshape(-1)
    T = params.topology
    net_step._topology_link_specs(T, params.num_periods)  # hostfn raises here
    hi = float(T.order_cap_heuristic * 2)
    return net_step.episode_returns_fully_fused(
        params, kernel_seed(generator), hi, batch, episodes_per_lane=E,
        device=dev).reshape(-1)


def policy_episode_returns(params, actor, generator: torch.Generator, batch: int,
                           episodes_per_lane: int = 1, deterministic: bool = True,
                           log_std=None, device=None):
    """Per-episode returns under a learned MLP policy, a
    (episodes_per_lane * batch,) float32 tensor, episode-major.

    ``actor`` is ``(Ws, bs)`` from ``ops.episode_kernels.fold_actor_params``
    (pi trunk and mean head, obs normalisation folded in). The policy runs
    inside the episode kernel: K5 on NetInvMgmt, K11 on InvManagement (int
    actions, alpha^t-discounted rewards). ``deterministic=False`` evaluates the
    stochastic policy, tanh-squashed Gaussian samples around the mean, and
    needs the trained ``log_std`` (the model's ``log_std`` parameter). The
    kernel seed is drawn from ``generator`` (``kernel_seed``), which must
    live on ``device``."""
    dev = resolve_device(device)
    E = int(episodes_per_lane)
    if E < 1:
        raise ValueError(f"episodes_per_lane must be >= 1, got {E}")
    if not deterministic and log_std is None:
        raise ValueError("deterministic=False requires log_std (the trained "
                         "per-action-dim log-std parameter)")
    _check_family(params)
    kern_log_std = None if deterministic else log_std
    if isinstance(params, nv.NewsvendorParams):
        raise NotImplementedError(
            "policy_episode_returns on Newsvendor runs the learned-policy "
            "kernel episode_returns_nv_policy, still to port (ROADMAP.md "
            "Queue B15)")
    if isinstance(params, im.InvManagementParams):
        episode_kernels._im_demand_spec(params)   # a law beyond the cap raises here
        return episode_kernels.episode_returns_im_policy(
            params, actor, kernel_seed(generator), batch, episodes_per_lane=E,
            log_std=kern_log_std, device=dev).reshape(-1)
    net_step._topology_link_specs(params.topology, params.num_periods)  # hostfn raises here
    return net_step.episode_returns_net_policy(
        params, actor, kernel_seed(generator), batch, episodes_per_lane=E,
        log_std=kern_log_std, device=dev).reshape(-1)
