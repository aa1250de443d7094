"""Batched env execution: reset, step, auto-reset and rollouts.

Port of ``or_gym_inventory_tpu/vector/vecenv.py``. The env functions are
batched natively over a leading env dimension, so ``vmap`` disappears, and
``lax.scan`` over periods becomes a Python loop. Every reference family
truncates at a fixed horizon, so a batch stays in lockstep and auto-reset is
an elementwise ``where``.

The seeded evaluators (``evaluate_episodes_seeded`` and its stateful twin)
drive lane i by ``seeds[i]`` alone, as the reference seeds episode i. The
JAX package folds each seed into a key a lane; here every env draw of lane i
comes from its own Philox stream, key (seeds[i], ``rng.SEEDED_KEY``)
(``ops.rng.seeded_words``), drawn by the family's ``seeded_draws`` and fed
through its ``step_with_demand``, so lane i's episode does not depend on
the batch it runs in. A demand law past the inversion table's cap is drawn
from the lane's own stream too, through its quantile on a 53-bit uniform
(``ops.distributions.seeded_law_draws``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.core.struct import TimeStep
from or_gym_inventory_torch.envs.base import Environment


class Trajectory(NamedTuple):
    """Stacked per-step outputs, time-major: (T, num_envs, ...)."""
    obs: torch.Tensor        # observation the action was computed from
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    next_obs: torch.Tensor   # post-step obs (pre-auto-reset; bootstrap target)
    info: dict


def batch_reset(env: Environment, params, generator: torch.Generator,
                num_envs: int, device=None):
    return env.reset(params, generator, num_envs, device=device)


def batch_step(env: Environment, params, state, action, generator: torch.Generator):
    return env.step(params, state, action, generator)


def auto_reset(env: Environment, params, state, ts: TimeStep,
               generator: torch.Generator, num_envs: int):
    """Replace done env states with fresh resets; returns (state, next_obs).

    ``ts`` is left untouched (its obs/reward are the final step's values)."""
    reset_state, reset_ts = batch_reset(env, params, generator, num_envs,
                                        device=ts.obs.device)
    done = ts.done

    def select(new, old):
        d = done.reshape(done.shape + (1,) * (new.ndim - done.ndim))
        return torch.where(d, new, old)

    state = type(state)(**{f.name: select(getattr(reset_state, f.name),
                                          getattr(state, f.name))
                           for f in dataclasses.fields(state)})
    return state, select(reset_ts.obs, ts.obs)


def _stack(trajs):
    first = trajs[0]
    return Trajectory(
        obs=torch.stack([t.obs for t in trajs]),
        action=torch.stack([t.action for t in trajs]),
        reward=torch.stack([t.reward for t in trajs]),
        done=torch.stack([t.done for t in trajs]),
        next_obs=torch.stack([t.next_obs for t in trajs]),
        info={k: torch.stack([t.info[k] for t in trajs]) for k in first.info})


def rollout(env: Environment, params, policy_fn: Callable, policy_state,
            generator: torch.Generator, num_envs: int, num_steps: int,
            init_carry: Optional[Any] = None, device=None):
    """Run ``num_steps`` across ``num_envs`` instances.

    ``policy_fn(policy_state, obs_batch, generator, t) -> action_batch``;
    ``t`` is the step index. Returns ``((state, obs), Trajectory)``; pass the
    carry back in to continue a rollout without re-resetting. ``generator``
    must live on ``device``.
    """
    dev = resolve_device(device)
    if init_carry is None:
        state, ts0 = batch_reset(env, params, generator, num_envs, device=dev)
        obs = ts0.obs
    else:
        state, obs = init_carry
    trajs = []
    for t in range(num_steps):
        action = policy_fn(policy_state, obs, generator, t)
        state, ts = batch_step(env, params, state, action, generator)
        state, next_obs = auto_reset(env, params, state, ts, generator, num_envs)
        trajs.append(Trajectory(obs=obs, action=action, reward=ts.reward,
                                done=ts.done, next_obs=ts.obs, info=ts.info))
        obs = next_obs
    return (state, obs), _stack(trajs)


def evaluate_episodes(env: Environment, params, policy_fn: Callable,
                      policy_state, generator: torch.Generator, num_envs: int,
                      device=None):
    """One full fixed-horizon episode per env; returns per-env totals and the
    stacked trajectory (the reference's ``evaluate_agent`` inner loop,
    benchmark_newsvendor.py:227-245)."""
    dev = resolve_device(device)
    state, ts = batch_reset(env, params, generator, num_envs, device=dev)
    obs = ts.obs
    trajs = []
    for t in range(env.horizon(params)):
        action = policy_fn(policy_state, obs, generator, t)
        state, ts = batch_step(env, params, state, action, generator)
        trajs.append(Trajectory(obs=obs, action=action, reward=ts.reward,
                                done=ts.done, next_obs=ts.obs, info=ts.info))
        obs = ts.obs
    traj = _stack(trajs)
    return traj.reward.sum(dim=0), traj


def _seeded_episode(env: Environment, params, seeds, act, device):
    """The episode loop of the seeded evaluators: ``act(obs, generator, t)
    -> action`` each period, the env stepped on lane-seeded demand."""
    dev = resolve_device(device)
    seeds = torch.as_tensor(seeds, device=dev).to(torch.int64)
    if env.seeded_draws is None:
        raise NotImplementedError(f"no seeded draws for the env family {env.name!r}")
    reset, demands = env.seeded_draws(params, seeds)
    generator = torch.Generator(device=dev).manual_seed(int(seeds[0]) & 0xFFFFFFFF)
    state, ts = reset()
    obs, trajs, totals = ts.obs, [], torch.zeros_like(ts.reward)
    for t, demand in enumerate(demands):
        action = act(obs, generator, t)
        state, ts = env.step_with_demand(params, state, action, demand)
        trajs.append(Trajectory(obs=obs, action=action, reward=ts.reward,
                                done=ts.done, next_obs=ts.obs, info=ts.info))
        # summed period by period, so that a lane's total does not depend on
        # the batch (a reduction over periods orders its sums by batch size)
        totals, obs = totals + ts.reward, ts.obs
    return totals, _stack(trajs)


def evaluate_episodes_seeded(env: Environment, params, policy_fn: Callable, policy_state,
                             seeds, device=None):
    """One fixed-horizon episode per lane, lane i driven only by
    ``seeds[i]`` (the reference seeds episode i with ``seed_offset + i``,
    benchmark_newsvendor.py:227-228): its reset and every period's env
    draws come from its own Philox words (the env's ``seeded_draws``), so its row
    does not depend on the batch's size, order or other lanes.
    ``policy_fn(policy_state, obs, generator, t) -> action``; the one
    ``generator`` (on the device, seeded from ``seeds[0]``, as the JAX
    package derives every period's action key from ``seeds[0]`` alone) is
    for stochastic policies, and a deterministic one never reads it.
    Returns (totals, Trajectory) as ``evaluate_episodes`` does."""
    return _seeded_episode(env, params, seeds,
                           lambda obs, g, t: policy_fn(policy_state, obs, g, t), device)


def evaluate_episodes_seeded_stateful(env: Environment, params, carry0_fn: Callable,
                                      policy_fn: Callable, seeds, device=None):
    """``evaluate_episodes_seeded`` for stateful (recurrent) policies:
    ``carry0_fn(num_envs)`` builds the initial carry and ``policy_fn(carry,
    obs, generator, t) -> (carry, action)`` threads it through the episode.
    Seeding and return layout are ``evaluate_episodes_seeded``'s."""
    seeds = torch.as_tensor(seeds)
    carry = [carry0_fn(seeds.shape[0])]

    def act(obs, g, t):
        carry[0], action = policy_fn(carry[0], obs, g, t)
        return action
    return _seeded_episode(env, params, seeds, act, device)
