"""Serial multi-echelon inventory management, batched in PyTorch.

Port of ``or_gym_inventory_tpu/envs/inv_management.py``. Every state tensor
carries a leading env dimension (B, ...) where the JAX package vmapped a
single-env function; all state is int32, as there. The event order of
``step_with_demand`` follows inventory_management.py:224-352 operation for
operation, with the reference quirks the JAX package keeps:

- the observation encodes *requested* (not fulfilled) orders (:268,
  :380-383) and excludes the backlog (:385-388);
- supplier stages 1..m-2 are decremented by ``R_fulfill[1:]``, the orders
  those stages *placed* (:300), so on-hand inventory can go negative even in
  lost-sales mode; the holding cost clamps at 0 (:318);
- float actions truncate toward zero through the int cast (:250); a NaN
  casts to 0, as JAX's saturating cast gives it (``trunc_i32``);
- the reward itself is discounted by alpha**t (:322), in f32 ``pow``.

``step`` draws demand as the port's NetInvMgmt ``sample_demand`` does: a
24-bit uniform from a ``torch.Generator`` inverts the host CDF table of
``ops.distributions.discrete_cdf_table``; USER mode reads ``user_D[t]``. A
law whose table would exceed the 4,096-entry cap is drawn from the law
itself (``ops.distributions.sample_from_law``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from or_gym_inventory_torch.core.config import apply_env_config
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.core.spaces import Box
from or_gym_inventory_torch.core.struct import TimeStep
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.ops import distributions as dist
from or_gym_inventory_torch.ops import rng

_SEQ_KEYS = ("I0", "r", "k", "h", "c", "L", "user_D")


@dataclasses.dataclass(frozen=True)
class InvManagementParams:
    """Static config mirroring the reference's __init__ kwargs
    (inventory_management.py:48-100). Sequence fields are tuples, so the
    params are hashable and key the kernels' cached launch arguments."""

    periods: int = 30
    I0: Tuple[int, ...] = (100, 150, 200)
    p: float = 20.0
    r: Tuple[float, ...] = (15.0, 10.0, 7.0, 5.0)
    k: Tuple[float, ...] = (0.10, 0.075, 0.05, 0.025)
    h: Tuple[float, ...] = (0.15, 0.10, 0.05)
    c: Tuple[int, ...] = (100, 200, 230)
    L: Tuple[int, ...] = (1, 5, 10)
    backlog: bool = True
    dist: int = 1
    dist_param: Tuple[Tuple[str, float], ...] = (("mu", 20),)
    alpha: float = 0.97
    user_D: Tuple[int, ...] = ()

    # ---- derived static properties (inventory_management.py:86-100) ----
    @property
    def num_stages(self) -> int:
        return len(self.I0) + 1

    @property
    def m1(self) -> int:  # stages that hold inventory and place orders
        return self.num_stages - 1

    @property
    def lt_max(self) -> int:
        return 0 if self.num_stages <= 1 else int(max(self.L))

    @property
    def pipeline_length(self) -> int:
        return self.m1 * (self.lt_max + 1)

    @property
    def horizon(self) -> int:
        return self.periods

    @property
    def dist_param_dict(self) -> Dict:
        return dict(self.dist_param)

    @property
    def unit_price(self) -> np.ndarray:  # price received by stage i (m,)
        return np.append(self.p, self.r[:-1]).astype(np.float32)

    @property
    def unit_cost(self) -> np.ndarray:  # procurement cost of stage i (m,)
        return np.array(self.r, np.float32)

    @property
    def holding_cost_vec(self) -> np.ndarray:  # (m,), 0 at the last stage
        return np.append(self.h, 0.0).astype(np.float32)

    @property
    def obs_bound(self) -> int:  # reference heuristic bound (:121)
        return int(np.sum(self.c) * self.periods * 2)

    def validate(self):
        """Mirrors the reference's _validate_inputs
        (inventory_management.py:144-167), message for message."""
        m = self.num_stages
        assert all(i >= 0 for i in self.I0), "Initial inventory cannot be negative"
        assert self.periods > 0, "Number of periods must be positive"
        assert all(v >= 0 for v in self.unit_price), "Sales prices cannot be negative"
        assert all(v >= 0 for v in self.r), "Procurement costs cannot be negative"
        assert all(v >= 0 for v in self.k), "Unfulfilled demand costs cannot be negative"
        assert all(v >= 0 for v in self.holding_cost_vec), "Holding costs cannot be negative"
        assert all(v > 0 for v in self.c), "Supply capacities must be positive"
        assert all(v >= 0 for v in self.L), "Lead times cannot be negative"
        assert isinstance(self.backlog, bool), "Backlog parameter must be boolean"
        assert m >= 2, "Minimum number of stages is 2"
        assert len(self.r) == m and len(self.k) == m
        assert len(self.h) == m - 1, f"Length of h ({len(self.h)}) != num stages - 1 ({m-1})"
        assert len(self.c) == m - 1 and len(self.L) == m - 1
        assert self.dist in (1, 2, 3, 4, 5), "dist must be one of 1..5"
        if self.dist == 5:
            assert len(self.user_D) == self.periods, \
                "User specified demand length != num periods"
        self._validate_dist_param()
        assert 0 < self.alpha <= 1, "alpha must be in the range (0, 1]"
        return self

    def _validate_dist_param(self):
        """Per-dist required keys and value ranges, so that a wrong dict
        raises when the params are built."""
        dp = self.dist_param_dict
        required = {1: ("mu",), 2: ("n", "p"), 3: ("low", "high"),
                    4: ("p",), 5: ()}[self.dist]
        missing = [k for k in required if k not in dp]
        assert not missing, (
            f"dist={self.dist} requires dist_param keys {list(required)}; "
            f"missing {missing} (got {sorted(dp)})")
        if self.dist != 5:
            extra = sorted(set(dp) - set(required))
            assert not extra, (
                f"dist={self.dist} takes dist_param keys {list(required)}; "
                f"unexpected {extra}")
        if self.dist == 1:
            assert dp["mu"] >= 0, f"Poisson mu must be >= 0, got {dp['mu']}"
        elif self.dist == 2:
            assert dp["n"] >= 0 and float(dp["n"]).is_integer(), \
                f"Binomial n must be a non-negative integer, got {dp['n']}"
            assert 0 <= dp["p"] <= 1, f"Binomial p must be in [0, 1], got {dp['p']}"
        elif self.dist == 3:
            assert dp["low"] <= dp["high"], (
                f"Uniform-integer requires low <= high, got "
                f"low={dp['low']}, high={dp['high']}")
        elif self.dist == 4:
            assert 0 < dp["p"] <= 1, f"Geometric p must be in (0, 1], got {dp['p']}"


def _as_fields(config: dict) -> dict:
    """Sequences to tuples and a ``dist_param`` dict to sorted pairs, so that
    the params stay hashable."""
    config = dict(config)
    for key in _SEQ_KEYS:
        if key in config:
            config[key] = tuple(config[key])
    if isinstance(config.get("dist_param"), dict):
        config["dist_param"] = tuple(sorted(config["dist_param"].items()))
    return config


def default_params(env_config=None, backlog: Optional[bool] = None,
                   **kwargs) -> InvManagementParams:
    """Params with reference-style dict overrides. ``backlog=True/False`` is
    the reference's InvManagementBacklogEnv / InvManagementLostSalesEnv
    (inventory_management.py:429-451)."""
    params = InvManagementParams(**_as_fields(kwargs))
    params = apply_env_config(params, _as_fields(env_config) if env_config else None)
    if backlog is not None:
        params = dataclasses.replace(params, backlog=backlog)
    return params.validate()


@dataclasses.dataclass
class InvManagementState:
    inv: torch.Tensor          # (B, m1) i32 on-hand at the start of period t
    backlog_v: torch.Tensor    # (B, m) i32 backlog at the start of period t
    action_hist: torch.Tensor  # (B, lt_max, m1) i32 requested orders, newest-first
    r_hist: torch.Tensor       # (B, lt_max, m1) i32 fulfilled orders, newest-first
    period: torch.Tensor       # (B,) i32


def observation_space(params: InvManagementParams) -> Box:
    n, bound = params.pipeline_length, params.obs_bound
    low = (-bound if params.backlog else 0) * np.ones(n, np.int32)
    return Box(low=low, high=bound * np.ones(n, np.int32), dtype=np.int32)


def action_space(params: InvManagementParams) -> Box:
    return Box(low=np.zeros(params.m1, np.int32),
               high=np.array(params.c, np.int32), dtype=np.int32)


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """Float to int32 toward zero as JAX casts on the CPU and CUDA's
    ``cvt.rzi`` does on the card: saturating at the int32 range, NaN to 0
    (torch's own cast leaves both undefined). Integer input passes."""
    if not torch.is_floating_point(x):
        return x.to(torch.int32)
    x = torch.nan_to_num(x.double(), nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return x.to(torch.int32)


def _obs(params: InvManagementParams, state: InvManagementState) -> torch.Tensor:
    """The reference layout (inventory_management.py:354-391): on-hand I[t]
    first, then the last min(t, lt_max) requested orders chronologically,
    zero-padded at the END when t < lt_max. Returns (B, pipeline_length)."""
    lt = params.lt_max
    if lt == 0:
        return state.inv
    B = state.inv.shape[0]
    chron = state.action_hist.flip(1)   # row j = order of period t - lt + j
    # when t < lt the first lt - t rows are zeros from the reset; the
    # reference packs the valid orders at the FRONT, so rotate them up
    shift = torch.clamp_min(lt - state.period.long(), 0)
    idx = (torch.arange(lt, device=shift.device)[None] + shift[:, None]) % lt
    chron = torch.gather(chron, 1, idx[:, :, None].expand(B, lt, params.m1))
    return torch.cat([state.inv, chron.reshape(B, -1)], dim=1)


def assemble_obs_from_streams(params: InvManagementParams, inv, actions):
    """The observation stream of whole episodes from the trajectory kernel's
    streams (``ops.episode_kernels.rollout_traj_im``): the gather form of
    ``_obs``, which the PPO update feeds on.

    ``inv`` (T+1, m1, B) i32 start-of-period on-hand (the final snapshot
    last); ``actions`` (T, m1, B) i32 the orders of each period, clamped to
    the REQUESTED ``max(a, 0)`` as the obs history encodes them (:268).
    Returns (T+1, B, pipeline_length) i32 whose row t is ``_obs`` of the
    period-t state."""
    T1, m1, B = inv.shape
    T = T1 - 1
    lt = params.lt_max
    if lt == 0:
        return inv.transpose(1, 2)
    req = torch.clamp_min(actions.to(torch.int32), 0)
    padded = torch.cat([req, req.new_zeros((1, m1, B))])   # row T = zeros
    # slot j of obs row t reads the order of period t - w + j for the
    # w = min(t, lt) valid slots, else the zero row: a static gather table
    idx = np.full((T1, lt), T, np.int64)
    for t in range(T1):
        w = min(t, lt)
        idx[t, :w] = np.arange(t - w, t)
    hist = padded[torch.as_tensor(idx, device=inv.device)]  # (T+1, lt, m1, B)
    obs = torch.cat([inv.to(torch.int32), hist.reshape(T1, lt * m1, B)], dim=1)
    return obs.transpose(1, 2)


def _info(state):
    return {"period": state.period, "current_inventory_on_hand": state.inv,
            "current_backlog": state.backlog_v}


def reset(params: InvManagementParams, generator: torch.Generator = None,
          batch: int = 1, device=None):
    """``batch`` fresh episodes: zero histories, I[0] = I0
    (inventory_management.py:186-222). Demand is drawn in ``step``, so the
    reset draws nothing; ``generator`` keeps the interface of ``step``."""
    dev = resolve_device(device)
    m1, lt = params.m1, params.lt_max
    i32 = dict(dtype=torch.int32, device=dev)
    state = InvManagementState(
        inv=torch.tensor(params.I0, **i32).expand(batch, m1).clone(),
        backlog_v=torch.zeros((batch, params.num_stages), **i32),
        action_hist=torch.zeros((batch, lt, m1), **i32),
        r_hist=torch.zeros((batch, lt, m1), **i32),
        period=torch.zeros((batch,), **i32))
    false = torch.zeros((batch,), dtype=torch.bool, device=dev)
    ts = TimeStep(obs=_obs(params, state),
                  reward=torch.zeros((batch,), dtype=torch.float32, device=dev),
                  terminated=false, truncated=false.clone(), info=_info(state))
    return state, ts


@functools.lru_cache(maxsize=16)
def _consts(params: InvManagementParams, device: str):
    """The step's constant vectors on ``device``, built once per params."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return dict(c=torch.tensor(params.c, dtype=torch.int32, device=device),
                price=f32(params.unit_price), cost=f32(params.unit_cost),
                hold=f32(params.holding_cost_vec), k=f32(params.k),
                alpha=torch.tensor(params.alpha, dtype=torch.float32, device=device))


def step_with_demand(params: InvManagementParams, state: InvManagementState,
                     action: torch.Tensor, demand: torch.Tensor):
    """One period for every env with injected ``demand`` (B,) and orders
    ``action`` (B, m1); event order per inventory_management.py:224-352."""
    m1 = params.m1
    t = state.period
    B = state.inv.shape[0]
    K = _consts(params, str(state.inv.device))

    # --- 0) place replenishment orders (:245-268): truncate, clamp at 0
    r_requested = torch.clamp_min(trunc_i32(torch.as_tensor(action).reshape(B, m1)), 0)
    order_request = r_requested + state.backlog_v[:, 1:]   # B[t, 1:] zero at t=0
    # stage i's order is capped by I[t, i+1]; the last stage draws from
    # unlimited raw material (:260-265)
    supplier_inv = torch.cat([state.inv[:, 1:],
                              torch.full((B, 1), 2 ** 31 - 1, dtype=torch.int32,
                                         device=t.device)], dim=1)
    r_fulfill = torch.minimum(torch.minimum(order_request, K["c"]), supplier_inv)

    # --- 1) receive shipments ordered L_i periods ago (:272-277)
    arrivals = []
    for i, li in enumerate(params.L):
        if li == 0:
            arrivals.append(r_fulfill[:, i])   # same-period arrival
        else:
            arrivals.append(torch.where(t >= li, state.r_hist[:, li - 1, i],
                                        torch.zeros_like(t)))
    inv_cur = state.inv + torch.stack(arrivals, dim=1)

    # --- 2-3) customer demand, filled with the prior backlog (:280-289)
    d = torch.clamp_min(trunc_i32(torch.as_tensor(demand).reshape(B)), 0)
    demand_to_fill = d + state.backlog_v[:, 0]
    sales0 = torch.minimum(inv_cur[:, 0], demand_to_fill)

    # --- 4) sales and unfulfilled per stage (:292-304); stages 1.. are
    # decremented by the orders they placed (:300)
    inv_cur = torch.cat([(inv_cur[:, 0] - sales0)[:, None],
                         inv_cur[:, 1:] - r_fulfill[:, 1:]], dim=1)
    S = torch.cat([sales0[:, None], r_fulfill], dim=1)             # (B, m)
    U = torch.cat([(demand_to_fill - sales0)[:, None],
                   order_request - r_fulfill], dim=1)               # (B, m)
    new_backlog = U if params.backlog else torch.zeros_like(U)

    # --- 5) profit (:315-323)
    Sf = S.to(torch.float32)
    revenue = K["price"] * Sf
    procurement = K["cost"] * Sf
    holding = K["hold"] * torch.clamp_min(
        torch.cat([inv_cur, torch.zeros_like(inv_cur[:, :1])], dim=1), 0).to(torch.float32)
    penalty = K["k"] * U.to(torch.float32)
    period_profit = torch.sum(revenue - procurement - holding - penalty, dim=1)
    reward = torch.pow(K["alpha"], t.to(torch.float32)) * period_profit

    # --- history buffers roll (newest-first)
    if params.lt_max > 0:
        action_hist = torch.cat([r_requested[:, None], state.action_hist[:, :-1]], dim=1)
        r_hist = torch.cat([r_fulfill[:, None], state.r_hist[:, :-1]], dim=1)
    else:
        action_hist, r_hist = state.action_hist, state.r_hist

    new_state = InvManagementState(inv=inv_cur, backlog_v=new_backlog,
                                   action_hist=action_hist, r_hist=r_hist,
                                   period=t + 1)
    truncated = new_state.period >= params.periods
    info = _info(new_state)
    info.update(
        period_profit=period_profit,
        revenue=revenue.sum(1), procurement_cost=procurement.sum(1),
        holding_cost=holding.sum(1), penalty_cost=penalty.sum(1),
        demand_realized=d, sales=S, unfulfilled=U, ending_inventory=inv_cur,
        backlog_start_of_next=new_backlog, fulfilled_orders=r_fulfill,
        requested_orders=r_requested)
    ts = TimeStep(obs=_obs(params, new_state), reward=reward,
                  terminated=torch.zeros_like(truncated), truncated=truncated,
                  info=info)
    return new_state, ts


def demand_law(params: InvManagementParams):
    """The demand mode as a named spec of ``ops.distributions`` (None for
    USER): the law ``sample_from_law`` draws when the table is too wide."""
    dp = params.dist_param_dict
    return {dist.POISSON: lambda: ("poisson", dp["mu"]),
            dist.BINOMIAL: lambda: ("binomial", dp["n"], dp["p"]),
            dist.RANDINT: lambda: ("randint", dp["low"], dp["high"] + 1),
            dist.GEOMETRIC: lambda: ("geometric", dp["p"]),
            dist.USER: lambda: None}[params.dist]()


@functools.lru_cache(maxsize=16)
def _demand_plan(params: InvManagementParams, device: str):
    """("user", per-period values + a trailing 0), ("table", base,
    thresholds) or ("law",) for a table beyond the cap, on ``device``."""
    if params.dist == dist.USER:
        return ("user", torch.tensor(list(params.user_D) + [0], dtype=torch.int32,
                                     device=device))
    try:
        base, table = dist.discrete_cdf_table(params.dist, params.dist_param_dict)
    except NotImplementedError:
        return ("law",)
    return ("table", int(base), torch.tensor(table or (float("inf"),),
                                             dtype=torch.float32, device=device))


def sample_demand(params: InvManagementParams, generator: torch.Generator,
                  period, batch: int, device=None) -> torch.Tensor:
    """(batch,) int32 demand of ``period`` (an int or a (batch,) tensor):
    ``base + #{F in table : F <= u}`` for a 24-bit uniform u from
    ``generator``, which must live on ``device``; USER mode reads
    ``user_D[t]`` (0 past its end) and draws nothing."""
    dev = resolve_device(device)
    kind, *rest = _demand_plan(params, str(dev))
    if kind == "user":
        return _demand_of(kind, rest, None, period, batch, dev)
    if kind == "law":
        d = dist.sample_from_law(demand_law(params), generator, batch, dev)
        return d.to(torch.int32)
    u24 = torch.randint(0, 1 << 24, (batch,), generator=generator, device=dev)
    return _demand_of(kind, rest, u24.to(torch.float32) * (2.0 ** -24), period, batch, dev)


def _demand_of(kind, rest, u, period, batch: int, dev) -> torch.Tensor:
    """The demand of a "user" or "table" plan: ``user_D[t]`` (0 past its
    end), or ``base + #{F in table : F <= u}``."""
    if kind == "user":
        vals, = rest
        period = torch.as_tensor(period, device=dev).expand(batch).long()
        return vals[torch.clamp(period, max=vals.shape[0] - 1)]
    base, table = rest
    return (torch.searchsorted(table, u, right=True) + base).to(torch.int32)


def demand_from_uniform(params: InvManagementParams, u: torch.Tensor, period,
                        law=None) -> torch.Tensor:
    """(batch,) int32 demand of ``period`` from the (batch,) f32 uniforms
    ``u``: what ``sample_demand`` gives for the same 24-bit uniform (USER
    mode reads ``user_D[t]`` and ignores ``u``). A law past the table cap
    cannot be drawn from one uniform: ``law(spec)`` draws it (the seeded
    evaluators' per-lane draws), and without ``law`` it raises
    NotImplementedError."""
    kind, *rest = _demand_plan(params, str(u.device))
    if kind == "law":
        if law is None:
            raise NotImplementedError(
                f"demand law {demand_law(params)} has no inversion table within the cap: it "
                "cannot be drawn from one uniform a period")
        return law(demand_law(params)).to(torch.int32)
    return _demand_of(kind, rest, u, period, u.shape[0], u.device)


def seeded_draws(params: InvManagementParams, seeds: torch.Tensor):
    """(reset, demands) of lane-seeded episodes
    (``vector.vecenv.evaluate_episodes_seeded``): ``reset()`` gives the
    batch's (state, TimeStep) and ``demands[t]`` period t's demand from
    word 0 of lane i's block under (seeds[i], ``rng.SEEDED_KEY``), all drawn
    here, before any step. A law past the table cap is drawn from lane i's
    stream 1 of the same key (``distributions.seeded_law_draws``)."""
    n, dev = seeds.shape[0], seeds.device
    demands = [demand_from_uniform(
        params, rng.uniform01(rng.seeded_words(seeds, t, 1)[0]), t,
        lambda spec, t=t: dist.seeded_law_draws(spec, seeds, 1, t))
        for t in range(params.horizon)]
    return (lambda: reset(params, None, n, device=dev)), demands


def step(params: InvManagementParams, state: InvManagementState,
         action: torch.Tensor, generator: torch.Generator):
    demand = sample_demand(params, generator, state.period, state.inv.shape[0],
                           device=state.inv.device)
    return step_with_demand(params, state, action, demand)


ENV = Environment(
    name="inv_management",
    default_params=default_params,
    reset=reset,
    step=step,
    step_with_demand=step_with_demand,
    observation_space=observation_space,
    action_space=action_space,
    seeded_draws=seeded_draws,
)
