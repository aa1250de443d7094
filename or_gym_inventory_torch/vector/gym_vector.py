"""A Gymnasium vector env over the batched device env (port of
``or_gym_inventory_tpu/vector/gym_vector.py``).

The reference's only vec-env was SB3 ``DummyVecEnv`` with n_envs=1
(benchmark_InvManagementBacklogEnv.py:269). ``BatchedGymVectorEnv`` is a
``gymnasium.vector.VectorEnv`` over ``vecenv.batch_reset`` /
``batch_step``: batched ``observation_space`` / ``action_space`` through
``gymnasium.vector.utils.batch_space``, NumPy in and out, the state on the
device between steps, so host RL libraries step thousands of envs on the
card through the standard vector API. Its draws come from one
``torch.Generator`` on the device, seeded from ``seed`` (and again by
``reset(seed=...)``), where the JAX package splits a key every step.

All three gymnasium autoreset modes:
- SAME_STEP (default): the step that ends an episode returns the fresh
  reset obs; the terminal obs rides in ``info["final_obs"]``, with the
  ``_final_obs`` / ``_final_info`` masks of the envs that ended.
- NEXT_STEP: the terminal step returns the terminal obs; the FOLLOWING
  step resets those envs (their action is ignored) and returns reward 0,
  done False, gymnasium >= 1.0's default.
- DISABLED: no automatic reset; the caller must ``reset()``.

A step returns NumPy, so the host learns which envs are done every step;
a reset batch is drawn only on a step where some env needs one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from or_gym_inventory_torch.core.device import resolve_device, to_numpy
from or_gym_inventory_torch.core.gym_compat import AutoresetMode, VectorEnv, batch_space
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.vector import vecenv


class BatchedGymVectorEnv(VectorEnv):
    """``num_envs`` lockstep instances of ``env`` on ``device`` (None means
    the GPU)."""

    def __init__(self, env: Environment, params, num_envs: int, seed: int = 0,
                 autoreset_mode: Union[AutoresetMode, str] = AutoresetMode.SAME_STEP,
                 device=None):
        self.env = env
        self.params = params
        self.num_envs = num_envs
        self.device = resolve_device(device)
        mode = AutoresetMode(autoreset_mode)
        self.metadata = {**self.metadata, "autoreset_mode": mode}
        self._mode = mode
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state = None
        self._pending = np.zeros(num_envs, bool)   # NEXT_STEP: envs awaiting their reset
        self.single_observation_space = env.observation_space(params).to_gymnasium()
        self.single_action_space = env.action_space(params).to_gymnasium()
        self.observation_space = batch_space(self.single_observation_space, num_envs)
        self.action_space = batch_space(self.single_action_space, num_envs)

    def _reset_batch(self):
        return vecenv.batch_reset(self.env, self.params, self._generator, self.num_envs,
                                  device=self.device)

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state, ts = self._reset_batch()
        self._pending = np.zeros(self.num_envs, bool)
        return to_numpy(ts.obs), {}

    def step(self, actions):
        action = torch.as_tensor(np.asarray(actions), device=self.device)
        self._state, ts = vecenv.batch_step(self.env, self.params, self._state, action,
                                            self._generator)
        obs, reward = to_numpy(ts.obs), to_numpy(ts.reward)
        terminated, truncated = to_numpy(ts.terminated), to_numpy(ts.truncated)
        done = terminated | truncated
        if self._mode is AutoresetMode.SAME_STEP:
            info = {
                "final_obs": obs,            # gymnasium >= 1.0 name
                "final_info": {},
                "final_observation": obs,    # pre-1.0 name
                # gymnasium's SAME_STEP masks: which envs ended this step
                # (all or none under lockstep horizons, but mask-aware
                # consumers should not have to know that)
                "_final_obs": done,
                "_final_info": done,
                "_final_observation": done,
            }
            if done.any():
                self._state, next_obs = vecenv.auto_reset(self.env, self.params, self._state,
                                                          ts, self._generator, self.num_envs)
                obs = to_numpy(next_obs)
            return obs, reward, terminated, truncated, info
        if self._mode is AutoresetMode.NEXT_STEP:
            if self._pending.any():
                # the envs flagged last step reset instead of stepping: their
                # action is discarded, reward 0, done False
                reset_state, reset_ts = self._reset_batch()
                mask = torch.as_tensor(self._pending, device=self.device)

                def sel(new, old):
                    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)

                self._state = type(self._state)(**{
                    f.name: sel(getattr(reset_state, f.name), getattr(self._state, f.name))
                    for f in dataclasses.fields(self._state)})
                obs = np.where(self._pending[:, None], to_numpy(reset_ts.obs), obs)
                reward = np.where(self._pending, np.zeros_like(reward), reward)
                terminated = terminated & ~self._pending
                truncated = truncated & ~self._pending
            self._pending = terminated | truncated
            return obs, reward, terminated, truncated, {}
        return obs, reward, terminated, truncated, {}
