"""Multi-period newsvendor with lead times, batched in PyTorch.

Port of ``or_gym_inventory_tpu/envs/newsvendor.py``. Every state tensor
carries a leading env dimension (B, ...) where the JAX package vmapped a
single-env function; all state is float32, as there. The event order of
``step_with_demand`` follows newsvendor.py:125-204 operation for operation,
with the reference quirks the JAX package keeps:

- lead_time == 0 uses the order *after* the [0, max_order] clip but *before*
  the max_inventory cap as on-hand inventory (newsvendor.py:136-142);
- purchase cost is charged on the (post-cap) order at order time,
  undiscounted (newsvendor.py:162-163);
- unsold inventory expires: on-hand each period is only the arriving
  pipeline slot (newsvendor.py:19-21, 174-183);
- reset draws 5 sequential conditional uniforms enforcing p >= c >= h
  (newsvendor.py:105-111).

``step`` draws Poisson(mu) demand with ``torch.poisson`` from a
``torch.Generator``, where JAX draws from ``jax.random.poisson``: the same
law from another stream. Rewards are undiscounted; a caller applies
``gamma``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from or_gym_inventory_torch.core.config import apply_env_config
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.core.spaces import Box
from or_gym_inventory_torch.core.struct import TimeStep
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.ops import nv_poisson, rng


@dataclasses.dataclass(frozen=True)
class NewsvendorParams:
    """Static config (reference __init__ kwargs, newsvendor.py:52-73);
    frozen, so the params are hashable and key the kernels' cached launch
    arguments."""

    lead_time: int = 5
    max_inventory: float = 4000.0
    max_order_quantity: float = 2000.0
    step_limit: int = 40
    p_max: float = 100.0
    h_max: float = 5.0
    k_max: float = 10.0
    mu_max: float = 200.0
    gamma: float = 1.0

    @property
    def obs_dim(self) -> int:
        return self.lead_time + 5

    @property
    def horizon(self) -> int:
        return self.step_limit


def default_params(env_config=None, **kwargs) -> NewsvendorParams:
    params = apply_env_config(NewsvendorParams(**kwargs), env_config)
    return dataclasses.replace(params, lead_time=max(0, params.lead_time))


@dataclasses.dataclass
class NewsvendorState:
    econ: torch.Tensor        # (B, 5) f32: price, cost, h, k, mu (per-episode draws)
    pipeline: torch.Tensor    # (B, lead_time) f32: pipeline[:, 0] arrives next
    step_count: torch.Tensor  # (B,) i32


def observation_space(params: NewsvendorParams) -> Box:
    high = np.array(
        [params.p_max, params.p_max, params.h_max, params.k_max, params.mu_max]
        + [params.max_order_quantity] * params.lead_time, dtype=np.float32)
    return Box(low=np.zeros(params.obs_dim, np.float32), high=high, dtype=np.float32)


def action_space(params: NewsvendorParams) -> Box:
    return Box(low=np.zeros(1, np.float32),
               high=np.full(1, params.max_order_quantity, np.float32),
               dtype=np.float32)


def _obs(state: NewsvendorState) -> torch.Tensor:
    return torch.cat([state.econ, state.pipeline], dim=1)


def assemble_obs_from_streams(params: NewsvendorParams, econ, orders):
    """The observation stream of whole episodes from rollout streams: the
    gather form of ``_obs`` over an episode.

    ``econ`` (5, B) f32 per-episode economics; ``orders`` (T, B) f32 CAPPED
    order quantities (the values entering the pipeline). Returns
    (T+1, B, obs_dim) f32 whose row t is ``_obs`` of the period-t state:
    econ first, then pipeline[j] = order of period t - lead_time + j (zero
    before the episode)."""
    orders = torch.as_tensor(orders, dtype=torch.float32)
    T, B = orders.shape
    L = params.lead_time
    econ_b = torch.as_tensor(econ, dtype=torch.float32)[None].expand(T + 1, 5, B)
    if L == 0:
        return econ_b.transpose(1, 2).contiguous()
    padded = torch.cat([orders, orders.new_zeros((1, B))])   # row T = zeros
    idx = np.full((T + 1, L), T, np.int64)
    for t in range(T + 1):
        for j in range(L):
            if 0 <= t - L + j < T:
                idx[t, j] = t - L + j
    hist = padded[torch.as_tensor(idx, device=padded.device)]   # (T+1, L, B)
    return torch.cat([econ_b, hist], dim=1).transpose(1, 2).contiguous()


def _info(state: NewsvendorState):
    e = state.econ
    return {"price": e[:, 0], "cost": e[:, 1], "holding_cost_rate": e[:, 2],
            "penalty_cost_rate": e[:, 3], "demand_mean": e[:, 4],
            "step_count": state.step_count}


def as_f32(x: float) -> float:
    """``x`` rounded to float32, as JAX folds a Python scalar into f32 math."""
    return float(np.float32(x))


def clip_order(params: NewsvendorParams, a: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(a, 0, max_order)``: NaN propagates, as there."""
    return torch.minimum(torch.maximum(a, torch.zeros_like(a)),
                         torch.full_like(a, as_f32(params.max_order_quantity)))


def econ_from_uniforms(params: NewsvendorParams, u):
    """The reset's formulas on 5 uniforms ``u`` (a sequence of equal-shaped
    f32 tensors): price, cost, h, k, mu (newsvendor.py:105-111)."""
    one = torch.ones_like(u[0])
    price = torch.maximum(one, u[0] * as_f32(params.p_max))
    cost = torch.maximum(one, u[1] * price)
    h = u[2] * torch.minimum(cost, torch.full_like(cost, as_f32(params.h_max)))
    k = u[3] * as_f32(params.k_max)
    mu = u[4] * as_f32(params.mu_max)
    return price, cost, h, k, mu


def draw_econ(params: NewsvendorParams, generator: torch.Generator, batch: int,
              device=None) -> torch.Tensor:
    """(batch, 5) economics from 5 uniforms per env drawn from ``generator``,
    which must live on ``device`` (the formulas of newsvendor.py:105-111)."""
    dev = resolve_device(device)
    u = torch.rand((5, batch), generator=generator, device=dev)
    return torch.stack(econ_from_uniforms(params, u), dim=1)


def reset_with_econ(params: NewsvendorParams, econ: torch.Tensor):
    """Deterministic reset with pinned economics ``econ`` (B, 5): the
    capability of the reference's CustomizableNewsvendorEnv fixed_params
    reset (benchmark_newsvendor_sb3_rllib.py:276-291)."""
    econ = torch.as_tensor(econ, dtype=torch.float32)
    B, dev = econ.shape[0], econ.device
    state = NewsvendorState(
        econ=econ,
        pipeline=torch.zeros((B, params.lead_time), dtype=torch.float32, device=dev),
        step_count=torch.zeros((B,), dtype=torch.int32, device=dev))
    false = torch.zeros((B,), dtype=torch.bool, device=dev)
    ts = TimeStep(obs=_obs(state), reward=torch.zeros((B,), dtype=torch.float32, device=dev),
                  terminated=false, truncated=false.clone(), info=_info(state))
    return state, ts


def reset(params: NewsvendorParams, generator: torch.Generator = None, batch: int = 1,
          device=None):
    return reset_with_econ(params, draw_econ(params, generator, batch, device))


def step_with_demand(params: NewsvendorParams, state: NewsvendorState,
                     action: torch.Tensor, demand: torch.Tensor):
    """One period for every env with injected ``demand`` (B,) and orders
    ``action`` (B,) or (B, 1); event order per newsvendor.py:125-204. Each
    product and sum is rounded alone, and the pipeline is summed oldest
    first, as the Newsvendor kernels do it."""
    B = state.econ.shape[0]
    price, cost, h, k = (state.econ[:, i] for i in range(4))
    zero = torch.zeros_like(price)
    a = torch.as_tensor(action, dtype=torch.float32, device=price.device).reshape(B, -1)[:, 0]
    order_raw = clip_order(params, a)
    L = params.lead_time
    if L > 0:
        inv_on_hand = state.pipeline[:, 0]
        pipeline_sum = state.pipeline[:, 0]
        for j in range(1, L):
            pipeline_sum = pipeline_sum + state.pipeline[:, j]
    else:
        # reference quirk: the pre-cap order is instantly on hand (:136-142)
        inv_on_hand, pipeline_sum = order_raw, zero
    order_qty = torch.maximum(zero, torch.minimum(
        order_raw, as_f32(params.max_inventory) - pipeline_sum))

    d = torch.as_tensor(demand, dtype=torch.float32, device=price.device).reshape(B)
    sales = torch.minimum(inv_on_hand, d)
    revenue = sales * price
    excess = torch.maximum(zero, inv_on_hand - d)
    short = torch.maximum(zero, d - inv_on_hand)
    purchase_cost = order_qty * cost
    holding_cost = excess * h
    lost_sales_penalty = short * k
    reward = revenue - purchase_cost - holding_cost - lost_sales_penalty

    pipeline = (torch.cat([state.pipeline[:, 1:], order_qty[:, None]], dim=1) if L > 0
                else state.pipeline)
    new_state = NewsvendorState(econ=state.econ, pipeline=pipeline,
                                step_count=state.step_count + 1)
    truncated = new_state.step_count >= params.step_limit
    info = _info(new_state)
    info.update(demand=d, revenue=revenue, purchase_cost=purchase_cost,
                holding_cost=holding_cost, lost_sales_penalty=lost_sales_penalty)
    ts = TimeStep(obs=_obs(new_state), reward=reward,
                  terminated=torch.zeros_like(truncated), truncated=truncated, info=info)
    return new_state, ts


def seeded_draws(params: NewsvendorParams, seeds: torch.Tensor):
    """(reset, demands) of lane-seeded episodes
    (``vector.vecenv.evaluate_episodes_seeded``): ``reset()`` resets on lane
    i's economics, drawn from the five words of period
    ``rng.SEEDED_RESET_PERIOD`` under (seeds[i], ``rng.SEEDED_KEY``), and
    ``demands[t]`` is period t's Poisson(mu) demand from word 0 of its
    block, inverted as the episode kernels invert it (``ops.nv_poisson``),
    all drawn here, before any step."""
    words = rng.seeded_words(seeds, rng.SEEDED_RESET_PERIOD, 5)
    econ = torch.stack(econ_from_uniforms(params, [rng.uniform01(w) for w in words]), dim=1)
    us = [rng.uniform01(rng.seeded_words(seeds, t, 1)[0]) for t in range(params.horizon)]
    return (lambda: reset_with_econ(params, econ)), nv_poisson.demand(params, econ[:, 4], us)


def step(params: NewsvendorParams, state: NewsvendorState, action: torch.Tensor,
         generator: torch.Generator):
    demand = torch.poisson(state.econ[:, 4], generator=generator)
    return step_with_demand(params, state, action, demand)


ENV = Environment(
    name="newsvendor",
    default_params=default_params,
    reset=reset,
    step=step,
    step_with_demand=step_with_demand,
    observation_space=observation_space,
    action_space=action_space,
    seeded_draws=seeded_draws,
)
