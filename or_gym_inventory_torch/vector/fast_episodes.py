"""Whole-episode returns under the uniform-random policy, under a learned
MLP policy and under a learned LSTM policy.

Port of ``or_gym_inventory_tpu/vector/fast_episodes.random_episode_returns``,
``policy_episode_returns`` and ``lstm_policy_episode_returns`` (:42-295),
every family's branch of each. On CUDA the episodes run in the fused kernels
(``ops.net_step.episode_returns_fully_fused``, K2, and
``episode_returns_net_policy``, K5; ``ops.episode_kernels.
episode_returns_im_fused``, K8, ``episode_returns_im_policy``, K11,
``episode_returns_nv_reset_fused``, K16, ``episode_returns_nv_policy``,
K19, and ``episode_returns_im_lstm``, K22; the LSTM policy on Newsvendor
and NetInvMgmt runs through ``vecenv``, as in the JAX package), on the CPU
in their plain versions. A demand the kernels cannot draw
(a ``hostfn`` link, a law beyond the inversion table's cap) raises
NotImplementedError before anything is launched; a failure to build or launch a kernel propagates. The JAX package
fell back to its XLA rollout there; the port has no such fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from or_gym_inventory_torch.agents import networks
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import net_inv_management as net
from or_gym_inventory_torch.envs import newsvendor as nv
from or_gym_inventory_torch.ops import episode_kernels, net_step
from or_gym_inventory_torch.vector import vecenv


def kernel_seed(generator: torch.Generator) -> int:
    """The 31-bit kernel seed ``random_episode_returns`` draws from
    ``generator``; a copy of the generator replays it."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=generator.device).item())


def _check_family(params):
    if not isinstance(params, (net.NetInvParams, im.InvManagementParams,
                               nv.NewsvendorParams)):
        raise TypeError(f"Unknown params type {type(params).__name__}")


def _check_kernel_demand(params):
    """Raise before any draw or launch for a family the kernels do not run
    or a demand they cannot draw (a law beyond the inversion table's cap, a
    ``hostfn`` link)."""
    _check_family(params)
    if isinstance(params, im.InvManagementParams):
        episode_kernels._im_demand_spec(params)
    elif isinstance(params, net.NetInvParams):
        net_step._topology_link_specs(params.topology, params.num_periods)


def _episodes(episodes_per_lane) -> int:
    E = int(episodes_per_lane)
    if E < 1:
        raise ValueError(f"episodes_per_lane must be >= 1, got {E}")
    return E


def random_episode_returns(params, generator: torch.Generator, batch: int,
                           episodes_per_lane: int = 1, device=None):
    """Per-episode returns under the uniform-random policy, a
    (episodes_per_lane * batch,) float32 tensor, episode-major. The kernel
    seed is drawn from ``generator``, which must live on ``device``.
    InvManagement steps' rewards are already alpha^t-discounted (reference
    semantics), so are its returns; Newsvendor's are gamma^t-discounted in
    the kernel."""
    dev = resolve_device(device)
    _episodes(episodes_per_lane)
    _check_kernel_demand(params)
    return random_returns_on_seed(params, kernel_seed(generator), batch, episodes_per_lane,
                                  dev)


def random_returns_on_seed(params, seed: int, batch: int, episodes_per_lane: int = 1,
                           device=None):
    """``random_episode_returns`` on a given 31-bit kernel ``seed``: the
    family's fused kernel (K2, K8 or K16) at ``batch`` lanes."""
    dev = resolve_device(device)
    E = _episodes(episodes_per_lane)
    _check_family(params)
    if isinstance(params, nv.NewsvendorParams):
        # reset-fused: econ, orders and per-lane Poisson(mu) demand all drawn
        # in the kernel
        return episode_kernels.episode_returns_nv_reset_fused(
            params, seed, batch, episodes_per_lane=E, device=dev).reshape(-1)
    if isinstance(params, im.InvManagementParams):
        episode_kernels._im_demand_spec(params)   # a law beyond the cap raises here
        return episode_kernels.episode_returns_im_fused(
            params, seed, batch, episodes_per_lane=E, device=dev).reshape(-1)
    T = params.topology
    net_step._topology_link_specs(T, params.num_periods)  # hostfn raises here
    hi = float(T.order_cap_heuristic * 2)
    return net_step.episode_returns_fully_fused(
        params, seed, hi, batch, episodes_per_lane=E, device=dev).reshape(-1)


def policy_episode_returns(params, actor, generator: torch.Generator, batch: int,
                           episodes_per_lane: int = 1, deterministic: bool = True,
                           log_std=None, device=None):
    """Per-episode returns under a learned MLP policy, a
    (episodes_per_lane * batch,) float32 tensor, episode-major.

    ``actor`` is ``(Ws, bs)`` from ``ops.episode_kernels.fold_actor_params``
    (pi trunk and mean head, obs normalisation folded in). The policy runs
    inside the episode kernel: K5 on NetInvMgmt, K11 on InvManagement (int
    actions, alpha^t-discounted rewards), K19 on Newsvendor (the reset and
    the per-lane Poisson(mu) demand in the kernel too, gamma^t-discounted
    returns). ``deterministic=False`` evaluates the stochastic policy,
    tanh-squashed Gaussian samples around the mean, and needs the trained
    ``log_std`` (the model's ``log_std`` parameter). The
    kernel seed is drawn from ``generator`` (``kernel_seed``), which must
    live on ``device``."""
    dev = resolve_device(device)
    _episodes(episodes_per_lane)
    if not deterministic and log_std is None:
        raise ValueError("deterministic=False requires log_std (the trained "
                         "per-action-dim log-std parameter)")
    _check_kernel_demand(params)
    return policy_returns_on_seed(params, actor, kernel_seed(generator), batch,
                                  episodes_per_lane, deterministic, log_std, dev)


def policy_returns_on_seed(params, actor, seed: int, batch: int, episodes_per_lane: int = 1,
                           deterministic: bool = True, log_std=None, device=None):
    """``policy_episode_returns`` on a given 31-bit kernel ``seed``: the
    family's policy kernel (K5, K11 or K19) at ``batch`` lanes."""
    dev = resolve_device(device)
    E = _episodes(episodes_per_lane)
    if not deterministic and log_std is None:
        raise ValueError("deterministic=False requires log_std (the trained "
                         "per-action-dim log-std parameter)")
    _check_family(params)
    kern_log_std = None if deterministic else log_std
    if isinstance(params, nv.NewsvendorParams):
        return episode_kernels.episode_returns_nv_policy(
            params, actor, seed, batch, episodes_per_lane=E,
            log_std=kern_log_std, device=dev).reshape(-1)
    if isinstance(params, im.InvManagementParams):
        episode_kernels._im_demand_spec(params)   # a law beyond the cap raises here
        return episode_kernels.episode_returns_im_policy(
            params, actor, seed, batch, episodes_per_lane=E,
            log_std=kern_log_std, device=dev).reshape(-1)
    net_step._topology_link_specs(params.topology, params.num_periods)  # hostfn raises here
    return net_step.episode_returns_net_policy(
        params, actor, seed, batch, episodes_per_lane=E,
        log_std=kern_log_std, device=dev).reshape(-1)


def lstm_policy_episode_returns(params, actor, generator: torch.Generator, batch: int,
                                device=None):
    """Per-episode returns under a deterministic learned LSTM policy, a
    (batch,) float32 tensor (JAX fast_episodes.py:220-295).

    ``actor`` is the dict of ``ops.episode_kernels.fold_lstm_actor`` (encoder,
    gate blocks and mean head, obs normalisation folded in). On
    InvManagement the policy runs inside the episode kernel with its carry
    (K22, ``episode_returns_im_lstm``; a law beyond the inversion table's cap
    raises NotImplementedError before any launch); its kernel seed is drawn
    from ``generator`` (``kernel_seed``). On Newsvendor and NetInvMgmt the
    same folded math runs through ``vecenv`` on ``device`` with the carry
    threaded, the JAX package's only path for them; Newsvendor's
    undiscounted step rewards are weighted by gamma^t when gamma != 1.
    ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    _check_family(params)
    if isinstance(params, im.InvManagementParams):
        episode_kernels._im_demand_spec(params)   # a law beyond the cap raises here
        return episode_kernels.episode_returns_im_lstm(params, actor, kernel_seed(generator),
                                                       batch, device=dev)
    env = nv.ENV if isinstance(params, nv.NewsvendorParams) else net.ENV
    space = env.action_space(params)
    low = torch.as_tensor(space.low, dtype=torch.float32, device=dev)
    high = torch.as_tensor(np.where(np.isinf(space.high), 1e4, space.high),
                           dtype=torch.float32, device=dev)
    int_actions = np.issubdtype(space.dtype, np.integer)
    actor = episode_kernels._lstm_on(actor, dev)
    hidden = actor["wh"].shape[1]
    horizon = env.horizon(params)
    state, ts = vecenv.batch_reset(env, params, generator, batch, device=dev)
    H = torch.zeros((hidden, batch), dtype=torch.float32, device=dev)
    C = torch.zeros_like(H)
    rewards = []
    for _ in range(horizon):
        mean, H, C = episode_kernels.lstm_forward(actor, list(ts.obs.T), H, C)
        a = networks.squash_action(mean.T, low, high)
        state, ts = vecenv.batch_step(env, params, state,
                                      a.to(torch.int32) if int_actions else a, generator)
        rewards.append(ts.reward)
    rew = torch.stack(rewards)
    if isinstance(params, nv.NewsvendorParams) and params.gamma != 1.0:
        w = torch.tensor([float(np.float32(params.gamma) ** np.float32(t))
                          for t in range(horizon)], dtype=torch.float32, device=dev)
        return torch.sum(w[:, None] * rew, dim=0)
    return torch.sum(rew, dim=0)
