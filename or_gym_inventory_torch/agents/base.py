"""The agent protocol and a device-policy bridge (port of
``or_gym_inventory_tpu/agents/base.py``).

Host agents speak the reference's ``BaseAgent`` protocol:
``get_action(obs, env)``, ``train(env_config, total_timesteps,
save_path_prefix)``, ``load`` and ``get_training_time``
(benchmark_InvManagementBacklogEnv.py:114-132), so a benchmark runs any mix
of heuristics and learned policies. Device policies are functions
``policy_fn(policy_state, obs, generator, t) -> action`` on batched tensors,
as ``vector.vecenv``'s rollouts call them; ``PolicyAgent`` bridges one into
the host protocol for single-env evaluation.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from or_gym_inventory_torch.core.device import resolve_device


def write_ckpt_meta(ckpt_path: str, trained_timesteps: int) -> None:
    """Record the training budget next to a checkpoint. The skip-retrain
    shortcut fires only when the stored model was trained for at least the
    requested budget (the reference's SB3AgentWrapper checks
    _total_timesteps, benchmark_InvManagementBacklogEnv.py:243-250), so a
    small-budget checkpoint never stands in for a full-budget run."""
    with open(ckpt_path + ".meta.json", "w") as f:
        json.dump({"trained_timesteps": int(trained_timesteps)}, f)


def ckpt_trained_timesteps(ckpt_path: str) -> int:
    """The budget recorded at save time; 0 (always retrain) when absent."""
    try:
        with open(ckpt_path + ".meta.json") as f:
            return int(json.load(f).get("trained_timesteps", 0))
    except (OSError, ValueError):
        return 0


def checkpoint_budget(ckpt_path: str, mesh=None) -> Optional[int]:
    """The budget recorded beside the checkpoint at ``ckpt_path``, None
    when there is no checkpoint. Under a ``mesh`` every rank gets rank 0's
    reading, so the skip-retrain decision is the same on every rank (one
    rank training while another skips would block in a collective)."""
    found = ckpt_trained_timesteps(ckpt_path) if os.path.exists(ckpt_path) else None
    return found if mesh is None else mesh.broadcast_object(found)


def training_device(device=None, mesh=None) -> torch.device:
    """An agent's training device: ``device``, else the mesh's, else the
    card (``core.device.resolve_device``)."""
    return resolve_device(device if device is not None or mesh is None else mesh.device)


def writes_files(mesh=None) -> bool:
    """Whether this process writes the agent's checkpoint and logs: rank 0
    of a mesh, or the process itself without one."""
    return mesh is None or mesh.rank == 0


class BaseAgent:
    """The host agent protocol (benchmark_InvManagementBacklogEnv.py:114-132)."""

    def __init__(self, name: str = "BaseAgent"):
        self.name = name
        self.training_time = 0.0

    def get_action(self, observation: np.ndarray, env) -> np.ndarray:
        raise NotImplementedError

    def train(self, env_config: dict, total_timesteps: int, save_path_prefix: str = ""):
        print(f"Agent {self.name} does not require training.")

    def load(self, path: str):
        print(f"Agent {self.name} does not support loading.")

    def get_training_time(self) -> float:
        return self.training_time

    def device_policy(self, env, params) -> Optional[Callable]:
        """A ``policy_fn(policy_state, obs, generator, t)`` for batched
        evaluation on tensors, or None if only the host path exists."""
        return None


class RandomAgent(BaseAgent):
    """Uniform samples from the action space (benchmark_InvManagementBacklogEnv.py:134-140)."""

    def __init__(self):
        super().__init__(name="Random")

    def get_action(self, observation, env):
        return env.action_space.sample().astype(env.action_space.dtype)

    def device_policy(self, env, params):
        space = env.action_space(params)

        def policy(_state, obs, generator, _t):
            return space.sample(generator, (obs.shape[0],), device=obs.device)
        return policy


class PolicyAgent(BaseAgent):
    """Host adapter around a device policy function (deterministic
    evaluation): one observation in, as a batch of one on the CPU."""

    def __init__(self, name: str, policy_fn: Callable, policy_state: Any = None):
        super().__init__(name=name)
        self.policy_fn = policy_fn
        self.policy_state = policy_state
        self._generator = torch.Generator().manual_seed(0)

    def get_action(self, observation, env):
        obs = torch.as_tensor(np.asarray(observation))[None]
        t = int(getattr(env, "period", getattr(env, "step_count", 0)))
        action = self.policy_fn(self.policy_state, obs, self._generator, t)
        return np.asarray(action[0].cpu()).astype(env.action_space.dtype)

    def device_policy(self, env, params):
        return self.policy_fn
