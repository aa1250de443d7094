"""Whole-episode returns under the uniform-random policy.

Port of ``or_gym_inventory_tpu/vector/fast_episodes.random_episode_returns``,
NetInvMgmt branch. On CUDA the episodes run in the fused kernel K2
(``ops.net_step.episode_returns_fully_fused``), on the CPU in its plain
version. A ``hostfn`` demand link, which neither the kernel nor the env's
``sample_demand`` can sample, raises NotImplementedError before anything is
launched; a failure to build or launch a kernel propagates.
"""

from __future__ import annotations

import torch

from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import net_inv_management as net
from or_gym_inventory_torch.ops import net_step


def kernel_seed(generator: torch.Generator) -> int:
    """The 31-bit kernel seed ``random_episode_returns`` draws from
    ``generator``; a copy of the generator replays it."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=generator.device).item())


def random_episode_returns(params, generator: torch.Generator, batch: int,
                           episodes_per_lane: int = 1, device=None):
    """Per-episode returns under the uniform-random policy, a
    (episodes_per_lane * batch,) float32 tensor, episode-major. The kernel
    seed is drawn from ``generator``, which must live on ``device``."""
    dev = resolve_device(device)
    E = int(episodes_per_lane)
    if E < 1:
        raise ValueError(f"episodes_per_lane must be >= 1, got {E}")
    if not isinstance(params, net.NetInvParams):
        raise NotImplementedError(
            f"{type(params).__name__}: the PyTorch port runs NetInvMgmt only; "
            "Newsvendor and InvManagement are still to port (ROADMAP.md "
            "Queue A7)")
    T = params.topology
    net_step._topology_link_specs(T, params.num_periods)  # hostfn raises here
    hi = float(T.order_cap_heuristic * 2)
    return net_step.episode_returns_fully_fused(
        params, kernel_seed(generator), hi, batch, episodes_per_lane=E,
        device=dev).reshape(-1)
