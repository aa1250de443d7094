"""Heuristic policies, the reference's full roster, in two forms (port of
``or_gym_inventory_tpu/agents/heuristics.py``).

Host agents (the ``BaseAgent`` protocol, NumPy/SciPy) mirror the benchmark
scripts' classes formula for formula, reading the attributes of the
``envs.adapters`` envs they step (``lead_time``, ``action_log``,
``period``, ``dist_param``, the action space):

- OrderUpToHeuristicAgent        benchmark_newsvendor.py:97-111
- ClassicNewsvendorAgent         benchmark_newsvendor.py:113-161
- sSPolicyAgent                  benchmark_newsvendor_sb3_rllib.py:343-351
- BaseStockAgent                 benchmark_InvManagementBacklogEnv.py:142-198
- ConstantOrderAgent             benchmark_NetInvMgmtBacklogEnv.py:119-134

Device policies (``device_policy(env, params)``) return ``policy(state,
obs, generator, t)`` on batched tensors, as ``vector.vecenv``'s rollouts
and seeded evaluators call them; ``scipy.stats.poisson.ppf`` becomes
``ops.distributions.poisson_ppf``. A pipeline position is summed period by
period, left to right, so that a lane's order does not depend on how a
device orders a reduction.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import poisson

from or_gym_inventory_torch.agents.base import BaseAgent
from or_gym_inventory_torch.ops.distributions import poisson_ppf


def _position(obs: torch.Tensor, start: int) -> torch.Tensor:
    """The sum of ``obs[:, start:]`` per row, added left to right."""
    pos = torch.zeros_like(obs[:, 0])
    for j in range(start, obs.shape[1]):
        pos = pos + obs[:, j]
    return pos


# ============================================================ newsvendor

class OrderUpToHeuristicAgent(BaseAgent):
    """Order up to mu*(L+1)*SF minus the pipeline position."""

    def __init__(self, safety_factor: float = 1.0):
        super().__init__(name=f"OrderUpTo_SF={safety_factor:.1f}")
        self.safety_factor = safety_factor

    def get_action(self, observation, env):
        mu = observation[4]
        pipeline = observation[5:]
        target = mu * (env.lead_time + 1) * self.safety_factor
        order = max(0, target - pipeline.sum())
        order = np.clip(order, env.action_space.low[0], env.action_space.high[0])
        return np.array([order], dtype=env.action_space.dtype)

    def device_policy(self, env, params):
        sf, L = self.safety_factor, params.lead_time
        space = env.action_space(params)

        def policy(_state, obs, _generator, _t):
            order = torch.clamp_min(obs[:, 4] * (L + 1) * sf - _position(obs, 5), 0.0)
            return space.clip(order[:, None])
        return policy


class ClassicNewsvendorAgent(BaseAgent):
    """Critical-ratio Poisson quantile order-up-to, with the reference's
    fallback on degenerate costs."""

    def __init__(self, cr_method: str = "k_vs_h", safety_factor: float = 1.0):
        super().__init__(name=f"ClassicNV_SF={safety_factor:.1f}_{cr_method}")
        self.cr_method = cr_method
        self.safety_factor = safety_factor

    def _critical_ratio(self, price, cost, h, k):
        if self.cr_method == "profit_margin":
            underage, overage = price - cost + k, h
            if underage + overage <= 1e-6 or underage <= 0 or overage <= 0:
                return None
            return underage / (underage + overage)
        if h + k <= 1e-6 or k < 0 or h < 0:
            return None
        return k / (h + k)

    def get_action(self, observation, env):
        price, cost, h, k, mu = observation[:5]
        pipeline = observation[5:]
        cr = self._critical_ratio(price, cost, h, k)
        if cr is None:
            target = mu * (env.lead_time + 1)
        else:
            eff_mu = mu * (env.lead_time + 1) * self.safety_factor
            target = poisson.ppf(cr, mu=max(1e-6, eff_mu))
        order = max(0, target - pipeline.sum())
        order = np.clip(order, env.action_space.low[0], env.action_space.high[0])
        return np.array([order], dtype=env.action_space.dtype)

    def device_policy(self, env, params):
        sf, L = self.safety_factor, params.lead_time
        profit_margin = self.cr_method == "profit_margin"
        space = env.action_space(params)

        def policy(_state, obs, _generator, _t):
            price, cost, h, k, mu = (obs[:, i] for i in range(5))
            if profit_margin:
                under, over = price - cost + k, h
                bad = (under + over <= 1e-6) | (under <= 0) | (over <= 0)
                cr = torch.where(bad, 0.5, under / torch.clamp_min(under + over, 1e-6))
            else:
                bad = (h + k <= 1e-6) | (k < 0) | (h < 0)
                cr = torch.where(bad, 0.5, k / torch.clamp_min(h + k, 1e-6))
            eff_mu = mu * (L + 1) * sf
            target_q = poisson_ppf(cr, torch.clamp_min(eff_mu, 1e-6))
            target = torch.where(bad, mu * (L + 1), target_q)
            order = torch.clamp_min(target - _position(obs, 5), 0.0)
            return space.clip(order[:, None])
        return policy


class sSPolicyAgent(BaseAgent):
    """(s, S): order S - position iff position < s. As the reference, ``s``
    uses the k/(h+k) quantile (the ``s_quantile`` argument is vestigial
    there and kept only for name parity, benchmark_newsvendor_sb3_rllib.py:
    343-351)."""

    def __init__(self, s_quantile: float = 0.5, S_buffer_factor: float = 1.2):
        super().__init__(name=f"sS_Policy(s={s_quantile:.2f},S={S_buffer_factor:.1f}s)")
        self.s_quantile = s_quantile
        self.S_buffer_factor = S_buffer_factor

    def get_action(self, observation, env):
        price, cost, h, k, mu = observation[:5]
        pipeline = observation[5:]
        lead_time = env.lead_time
        s_lvl = 0.0
        if h + k > 1e-6:
            cr = np.clip(k / (h + k), 0.001, 0.999)
            s_lvl = max(0.0, poisson.ppf(cr, mu=max(1e-6, mu * (lead_time + 1))))
        S_lvl = s_lvl * self.S_buffer_factor
        pos = pipeline.sum()
        order = max(0, S_lvl - pos) if pos < s_lvl else 0
        order = np.clip(order, env.action_space.low[0], env.action_space.high[0])
        return np.array([order], dtype=env.action_space.dtype)

    def device_policy(self, env, params):
        L, buf = params.lead_time, self.S_buffer_factor
        space = env.action_space(params)

        def policy(_state, obs, _generator, _t):
            h, k, mu = obs[:, 2], obs[:, 3], obs[:, 4]
            ok = h + k > 1e-6
            cr = torch.clamp(k / torch.clamp_min(h + k, 1e-6), 0.001, 0.999)
            ppf = poisson_ppf(cr, torch.clamp_min(mu * (L + 1), 1e-6))
            s_lvl = torch.where(ok, torch.clamp_min(ppf, 0.0), 0.0)
            pos = _position(obs, 5)
            order = torch.where(pos < s_lvl, torch.clamp_min(s_lvl * buf - pos, 0.0), 0.0)
            return space.clip(order[:, None])
        return policy


# ======================================================= inv management

class BaseStockAgent(BaseAgent):
    """Per-stage base-stock: position (on-hand + the pipeline from the
    action log) against the target (L_i+1)*mu*SF. The reference's
    simplification: the final customer's mu for every stage
    (benchmark_InvManagementBacklogEnv.py:142-198)."""

    def __init__(self, safety_factor: float = 1.0):
        super().__init__(name=f"BaseStock_SF={safety_factor:.1f}")
        self.safety_factor = safety_factor

    def get_action(self, observation, env):
        needed = ["num_stages", "lead_time", "dist_param", "lt_max", "I",
                  "action_log", "period"]
        if not all(hasattr(env, a) for a in needed):
            print(f"Warning: Env missing attributes needed for {self.name}. "
                  "Returning random action.")
            return env.action_space.sample().astype(env.action_space.dtype)
        m1 = env.num_stages - 1
        lead_times = env.lead_time
        mu = env.dist_param.get("mu", 10)
        position = observation[:m1].astype(np.float64).copy()
        t = env.period
        for i in range(m1):
            li = int(lead_times[i])
            if li == 0:
                continue
            lo = max(0, t - li)
            if t > 0 and lo < t:
                position[i] += env.action_log[lo:t, i].sum()
        targets = (lead_times + 1) * mu * self.safety_factor
        orders = np.maximum(0, targets - position)
        orders = np.clip(orders, env.action_space.low, env.action_space.high)
        return orders.astype(env.action_space.dtype)

    def device_policy(self, env, params):
        sf = self.safety_factor
        m1, lt = params.m1, params.lt_max
        L = np.asarray(params.L)
        mu = params.dist_param_dict.get("mu", 10)
        space = env.action_space(params)
        targets_np = np.asarray((L + 1) * mu * sf, np.float32)
        L_t = torch.as_tensor(L)

        def policy(_state, obs, _generator, t):
            dev = obs.device
            on_hand = obs[:, :m1].to(torch.float32)
            hist = obs[:, m1:].reshape(obs.shape[0], lt, m1).to(torch.float32)
            # chronological rows 0..min(t, lt)-1 hold the last orders; the last
            # L_i of them are in flight (the window the host agent takes from
            # env.action_log)
            n_valid = torch.clamp(torch.as_tensor(t, device=dev), max=lt)
            rows = torch.arange(lt, device=dev)
            mask = (rows[None, :] >= (n_valid - L_t.to(dev)[:, None])) & (rows[None, :] < n_valid)
            pipe = (hist * mask.T.to(torch.float32)[None]).sum(dim=1)   # (B, m1)
            targets = torch.as_tensor(targets_np, device=dev)
            orders = torch.clamp_min(targets[None] - (on_hand + pipe), 0.0)
            return space.clip(orders).to(torch.int32)
        return policy


# ========================================================== network env

class ConstantOrderAgent(BaseAgent):
    """A constant fraction of the action space's high on every link
    (benchmark_NetInvMgmtBacklogEnv.py:119-134, with its inf -> 1000
    clamp)."""

    def __init__(self, order_fraction: float = 0.1):
        super().__init__(name=f"ConstantOrder_{order_fraction * 100:.0f}%")
        self.order_fraction = order_fraction
        self._action = None

    def get_action(self, observation, env):
        if self._action is None:
            high = env.action_space.high.copy()
            high[high == np.inf] = 1000
            self._action = (high * self.order_fraction).astype(env.action_space.dtype)
        return self._action

    def device_policy(self, env, params):
        space = env.action_space(params)
        high = np.where(np.isinf(space.high), 1000, space.high)
        action_np = np.asarray(high * self.order_fraction, np.float32)

        def policy(_state, obs, _generator, _t):
            action = torch.as_tensor(action_np, device=obs.device)
            return action.expand((obs.shape[0],) + action.shape)
        return policy
