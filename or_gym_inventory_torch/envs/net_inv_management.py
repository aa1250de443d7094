"""Graph-structured network inventory management, batched in PyTorch.

Port of ``or_gym_inventory_tpu/envs/net_inv_management.py``. Every state
tensor carries a leading env dimension (B, ...) where the JAX package
vmapped a single-env function. The per-link loops run over the static
topology in Python, in the same order as the JAX step:

- reorder links fulfill in sorted-edge order with *sequential* supplier
  contention via a running consumed tally (network_management.py:446-485);
  factory caps are min(C, v * remaining-inventory) applied per order;
- retail links fill in declaration order, sequentially decrementing the
  retailer's inventory (:536-554);
- lost-sales mode zeroes U[t+1] (:563) and the retail penalty reads U[t+1]
  (:608), so no stockout penalty is charged in lost-sales mode (a reference
  quirk kept for parity);
- actions and demands are rounded half to even (``torch.round``, like
  ``jnp.round``) and clamped non-negative (:449, :540).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.core.spaces import Box
from or_gym_inventory_torch.core.struct import TimeStep
from or_gym_inventory_torch.envs import topology as topo_mod
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.envs.topology import Topology
from or_gym_inventory_torch.ops import distributions as dist
from or_gym_inventory_torch.ops import net_step, rng


@dataclasses.dataclass(frozen=True)
class NetInvParams:
    topology: Topology
    num_periods: int = 30
    backlog: bool = True
    alpha: float = 1.0

    @property
    def horizon(self) -> int:
        return self.num_periods

    @property
    def obs_dim(self) -> int:
        return self.topology.obs_dim

    def validate(self):
        assert isinstance(self.backlog, bool), "backlog must be boolean"
        assert 0 < self.alpha <= 1, "alpha must be in (0, 1]"
        assert self.num_periods > 0, "num_periods must be positive"
        return self


def default_params(env_config=None, graph=None, topology: Optional[Topology] = None,
                   num_periods: int = 30, backlog: bool = True, alpha: float = 1.0,
                   user_D=None, sample_path=None) -> NetInvParams:
    """Build params; mirrors NetInvMgmtMasterEnv.__init__
    (network_management.py:55-106) incl. the env_config override path and the
    'graph' special case (network_management.py:17-24)."""
    cfg = dict(env_config or {})
    num_periods = int(cfg.pop("num_periods", num_periods))
    backlog = bool(cfg.pop("backlog", backlog))
    alpha = float(cfg.pop("alpha", alpha))
    graph = cfg.pop("graph", graph)
    user_D = cfg.pop("user_D", user_D)
    sample_path = cfg.pop("sample_path", sample_path)
    if cfg:
        raise KeyError(f"Unknown env_config keys for NetInvParams: {sorted(cfg)}")
    if topology is None:
        if graph is not None:
            topology = topo_mod.from_networkx(graph, num_periods,
                                              user_D=user_D, sample_path=sample_path)
        else:
            topology = topo_mod.default_topology(num_periods,
                                                 user_D=user_D, sample_path=sample_path)
    return NetInvParams(topology=topology, num_periods=num_periods,
                        backlog=backlog, alpha=alpha).validate()


@dataclasses.dataclass
class NetInvState:
    X: torch.Tensor       # (B, n_main) f32 on-hand at start of period t
    Y: torch.Tensor       # (B, n_reorder) f32 pipeline at start of period t
    U: torch.Tensor       # (B, n_retail) f32 unfulfilled demand at start of t
    r_hist: torch.Tensor  # (B, lt_max, n_reorder) f32 fulfilled orders, newest-first
    period: torch.Tensor  # (B,) int32


def observation_space(params: NetInvParams) -> Box:
    """network_management.py:283-298 (+ lost-sales low clamp :762-770)."""
    T = params.topology
    hi = T.order_cap_heuristic * params.num_periods * 2
    lo = 0.0 if not params.backlog else -hi
    low = np.full(T.obs_dim, lo, np.float32)
    low[:T.n_retail] = 0.0
    return Box(low=low, high=np.full(T.obs_dim, hi, np.float32), dtype=np.float32)


def action_space(params: NetInvParams) -> Box:
    T = params.topology
    hi = T.order_cap_heuristic * 2
    return Box(low=np.zeros(T.n_reorder, np.float32),
               high=np.full(T.n_reorder, hi, np.float32), dtype=np.float32)


def _obs(params: NetInvParams, state: NetInvState) -> torch.Tensor:
    """[U[t] per retail link, X[t] per main node, per-reorder-link order
    windows R[t-L..t-1] (zeros at the front when t < L)] —
    network_management.py:334-413. Returns (B, obs_dim)."""
    T = params.topology
    parts = [state.U, state.X]
    for i, L in enumerate(T.ro_L):
        if L == 0:
            continue
        # newest-first buffer -> chronological window of length L
        parts.append(state.r_hist[:, :L, i].flip(1))
    return torch.cat(parts, dim=1)


def assemble_obs_from_streams(params: NetInvParams, x, u, r) -> torch.Tensor:
    """The observation stream of whole episodes from a trajectory's streams:
    the gather form of ``_obs``, which the PPO update feeds on
    (``ops.net_step.rollout_traj_net``).

    ``x`` (T+1, n_main, B) and ``u`` (T+1, n_rt, B) are start-of-period node
    inventories and retail backlogs, ``r`` (T, n_ro, B) fulfilled orders.
    Returns (T+1, B, obs_dim) float32 whose row t is ``_obs`` of the period-t
    state: U, then X, then for each reorder link i the chronological window
    ``r[t-L_i .. t-1, i]`` (zeros before the episode; links with L_i = 0 have
    no rows)."""
    T = params.topology
    T1, _, B = x.shape
    Tn = T1 - 1
    f32 = dict(dtype=torch.float32)
    parts = [u.to(**f32), x.to(**f32)]
    # one zero row at index Tn stands for every period before the episode
    padded = torch.cat([r.to(**f32), r.new_zeros((1, T.n_reorder, B), **f32)])
    for i, L in enumerate(T.ro_L):
        if L == 0:
            continue
        idx = torch.arange(T1)[:, None] - L + torch.arange(L)[None, :]
        idx = torch.where((idx >= 0) & (idx < Tn), idx, Tn).to(x.device)
        parts.append(padded[idx, i])                      # (T+1, L, B)
    return torch.cat(parts, dim=1).transpose(1, 2)


def _info(state):
    return {"period": state.period, "inventory": state.X,
            "pipeline": state.Y, "backlog_start": state.U}


def reset(params: NetInvParams, generator: torch.Generator = None,
          batch: int = 1, device=None):
    """``batch`` fresh episodes. The reset is deterministic, so
    ``generator`` is unused; it keeps the interface of ``step``."""
    dev = resolve_device(device)
    T = params.topology
    f32 = dict(dtype=torch.float32, device=dev)
    state = NetInvState(
        X=torch.tensor(T.I0, **f32).expand(batch, T.n_main).clone(),
        Y=torch.zeros((batch, T.n_reorder), **f32),
        U=torch.zeros((batch, T.n_retail), **f32),
        r_hist=torch.zeros((batch, max(T.lt_max, 1), T.n_reorder), **f32),
        period=torch.zeros((batch,), dtype=torch.int32, device=dev))
    false = torch.zeros((batch,), dtype=torch.bool, device=dev)
    ts = TimeStep(obs=_obs(params, state), reward=torch.zeros((batch,), **f32),
                  terminated=false, truncated=false.clone(), info=_info(state))
    return state, ts


def _segment_sum(cols, idx, n: int, zero: torch.Tensor) -> torch.Tensor:
    """Sum the (B,) columns ``cols`` into ``n`` node buckets in link order;
    index -1 (raw-material) is dropped. Returns (B, n)."""
    out = [None] * n
    for c, k in zip(cols, idx):
        if k >= 0:
            out[k] = c if out[k] is None else out[k] + c
    return torch.stack([zero if o is None else o for o in out], dim=1)


def step_with_demand(params: NetInvParams, state: NetInvState,
                     action: torch.Tensor, demand: torch.Tensor):
    """One period for every env, with injected per-retail-link demand
    ``demand`` (B, n_retail) and orders ``action`` (B, n_reorder). Event
    order per network_management.py:436-635."""
    T = params.topology
    t = state.period
    B = state.X.shape[0]
    n_main = T.n_main
    action = action.to(torch.float32).reshape(B, T.n_reorder)
    demand = demand.to(torch.float32).reshape(B, T.n_retail)
    zero = torch.zeros_like(state.X[:, 0])

    # --- 0) order fulfillment with sequential supplier contention (:442-490)
    requests = torch.clamp_min(torch.round(action), 0.0)
    consumed = [zero] * n_main
    r_cols = []
    for i in range(T.n_reorder):
        sup = T.ro_sup_main[i]
        if sup < 0:  # raw-material supplier: unlimited (:453-455)
            fulfilled = requests[:, i]
        else:
            remaining = state.X[:, sup] - consumed[sup]
            avail = torch.clamp_min(remaining, 0.0)
            if T.is_factory[sup]:
                # per-order capacity/yield cap (:464-478)
                avail = torch.minimum(avail, torch.clamp_max(T.v[sup] * avail, T.C[sup]))
            fulfilled = torch.minimum(requests[:, i], avail)
            consumed[sup] = consumed[sup] + fulfilled / T.v[sup]
        r_cols.append(fulfilled)
    r_cur = torch.stack(r_cols, dim=1)

    # --- 1) deliveries + pipeline (:494-528) ---
    arr_cols = []
    for i, L in enumerate(T.ro_L):
        if L == 0:
            arr_cols.append(r_cols[i])  # placed and arrives this period
        else:
            arr_cols.append(torch.where(t >= L, state.r_hist[:, L - 1, i], zero))
    arriving = torch.stack(arr_cols, dim=1)
    Y_new = state.Y - arriving + r_cur
    arrivals_node = _segment_sum(arr_cols, T.ro_pur_main, n_main, zero)
    X_mid = state.X + arrivals_node - torch.stack(consumed, dim=1)

    # --- 2-4) market demand, sequential retail fulfillment (:532-566) ---
    d = torch.clamp_min(torch.round(demand), 0.0)
    X_cols = list(X_mid.unbind(1))
    sales, U_cols = [], []
    for j in range(T.n_retail):
        ret = T.rt_retailer_main[j]
        to_fill = d[:, j] + state.U[:, j]
        inv_r = torch.clamp_min(X_cols[ret], 0.0)
        s = torch.minimum(to_fill, inv_r)
        X_cols[ret] = X_cols[ret] - s
        sales.append(s)
        unf = to_fill - s
        U_cols.append(unf if params.backlog else torch.zeros_like(unf))
    X_new = torch.stack(X_cols, dim=1)
    U_new = torch.stack(U_cols, dim=1)

    # --- 5) per-node profit (:576-619) ---
    ro_rev = [p * r for p, r in zip(T.ro_price, r_cols)]
    SR = (_segment_sum(ro_rev, T.ro_sup_main, n_main, zero)
          + _segment_sum([p * s for p, s in zip(T.rt_price, sales)],
                         T.rt_retailer_main, n_main, zero))
    PC = _segment_sum(ro_rev, T.ro_pur_main, n_main, zero)
    Y_pos = torch.clamp_min(Y_new, 0.0)
    HC = (torch.stack([h * torch.clamp_min(X_cols[n], 0.0)
                       for n, h in enumerate(T.h)], dim=1)
          + _segment_sum([g * Y_pos[:, i] for i, g in enumerate(T.ro_g)],
                         T.ro_pur_main, n_main, zero))
    sold_total = (_segment_sum(r_cols, T.ro_sup_main, n_main, zero)
                  + _segment_sum(sales, T.rt_retailer_main, n_main, zero))
    OC = torch.stack([T.o[n] * sold_total[:, n] / T.v[n] if T.is_factory[n]
                      else zero for n in range(n_main)], dim=1)
    UP = _segment_sum([b * U_cols[j] for j, b in enumerate(T.rt_b)],
                      T.rt_retailer_main, n_main, zero)
    node_profit = SR - PC - OC - HC - UP
    profit = torch.sum(node_profit, dim=1)
    reward = (params.alpha ** t.to(torch.float32)) * profit

    r_hist = torch.cat([r_cur[:, None], state.r_hist[:, :-1]], dim=1)
    new_state = NetInvState(X=X_new, Y=Y_new, U=U_new, r_hist=r_hist,
                            period=t + 1)
    truncated = new_state.period >= params.num_periods

    info = _info(new_state)
    info.update(demand=d, retail_sales=torch.stack(sales, dim=1),
                fulfilled_orders=r_cur, arrivals=arrivals_node,
                node_profit=node_profit, profit_period_undiscounted=profit,
                profit_period_discounted=reward)
    ts = TimeStep(obs=_obs(params, new_state), reward=reward,
                  terminated=torch.zeros_like(truncated), truncated=truncated,
                  info=info)
    return new_state, ts


def _refuse_hostfn(T: Topology):
    for j, spec in enumerate(T.rt_demand):
        if spec[0] == "hostfn":
            raise NotImplementedError(
                f"Retail link {T.retail_links[j]}: spec {spec[0]!r} (an arbitrary "
                "host callable) cannot compile to device — pass "
                "demand_dist=<name> (see envs.topology) or use the Gymnasium "
                "adapter, which calls the callable verbatim.")


@functools.lru_cache(maxsize=16)
def _demand_plan(T: Topology, device: str):
    """The episode kernels' per-link demand plan as device tensors, cached
    per topology and device so that a rollout copies the tables to the
    device once, not once per step. ``user`` arrays keep their full length,
    so a period past the horizon takes the array's last value. A link whose
    inversion table would exceed the cap is planned as ("law",): it is drawn
    from its law (``ops.distributions.sample_from_law``). ``hostfn`` links
    are refused before this is called."""
    steps = max([1] + [len(s[1]) for s in T.rt_demand if s[0] == "user"])
    plan = []
    for spec in T.rt_demand:
        try:
            link = net_step._link_spec(spec, steps)
        except NotImplementedError:   # support beyond the table cap
            plan.append(("law",))
            continue
        plan.extend(net_step._device_link_plan((link,), device))
    return tuple(plan)


def sample_demand(params: NetInvParams, generator: torch.Generator,
                  period, batch: int, device=None) -> torch.Tensor:
    """(batch, n_retail) demand for every named spec the topology compiler
    emits. Each link inverts its host CDF table (``ops.distributions``)
    against a 24-bit uniform from ``generator`` — the sampler the kernels
    use, exact for every static spec. A spec whose table would exceed the
    4,096-entry cap (e.g. Poisson(50,000)) is drawn from its law itself
    with ``generator``, as the JAX env draws every spec (the kernels refuse
    it). ``user``/``zero`` links take their per-period value; a ``hostfn``
    spec raises. ``period`` is an int or a (batch,) tensor; ``generator``
    must live on ``device``."""
    dev = resolve_device(device)
    T = params.topology
    _refuse_hostfn(T)
    period = torch.as_tensor(period, device=dev).expand(batch).long()
    cols = []
    for spec, plan in zip(T.rt_demand, _demand_plan(T, str(dev))):
        if plan[0] == "law":
            cols.append(dist.sample_from_law(spec, generator, batch, dev))
            continue
        # every other link draws its uniform, const links too, so the stream
        # layout does not depend on the specs
        u24 = torch.randint(0, 1 << 24, (batch,), generator=generator, device=dev)
        cols.append(_link_demand(plan, u24.to(torch.float32) * (2.0 ** -24), period))
    return torch.stack(cols, dim=1)


def _link_demand(plan, u, period) -> torch.Tensor:
    """One link's f32 demand: ``base + #{F in table : F <= u}`` for a
    "table" link, its value of ``period`` for a "user" or const link."""
    kind, *rest = plan
    if kind == "table":
        base, table = rest
        d = torch.searchsorted(table, u, right=True).to(torch.float32)
        return d + base if base else d
    vals, = rest
    return vals[torch.clamp(period, max=vals.shape[0] - 1)]


def demand_from_uniforms(params: NetInvParams, u: torch.Tensor, period) -> torch.Tensor:
    """(batch, n_retail) demand of ``period`` from (batch, n_retail) f32
    uniforms ``u``, one a retail link (const and user links ignore theirs):
    what ``sample_demand`` gives for the same 24-bit uniforms. A link whose
    law has no table within the cap cannot be drawn from one uniform:
    NotImplementedError, as for a ``hostfn`` spec."""
    T = params.topology
    _refuse_hostfn(T)
    plans = _demand_plan(T, str(u.device))
    wide = [spec for spec, plan in zip(T.rt_demand, plans) if plan[0] == "law"]
    if wide:
        raise NotImplementedError(
            f"retail demand {wide} has no inversion table within the cap: it cannot be "
            "drawn from one uniform a period")
    period = torch.as_tensor(period, device=u.device).expand(u.shape[0]).long()
    return torch.stack([_link_demand(plan, u[:, j], period) for j, plan in enumerate(plans)],
                       dim=1)


def seeded_draws(params: NetInvParams, seeds: torch.Tensor):
    """(reset, demands) of lane-seeded episodes
    (``vector.vecenv.evaluate_episodes_seeded``): ``reset()`` gives the
    batch's (state, TimeStep) and ``demands[t]`` period t's (B, n_retail)
    demand, word j of lane i's block under (seeds[i], ``rng.SEEDED_KEY``)
    for retail link j (const links too), all drawn here, before any step.
    A link whose law is past the table cap raises NotImplementedError."""
    n, dev, k = seeds.shape[0], seeds.device, params.topology.n_retail
    demands = [demand_from_uniforms(
        params, torch.stack([rng.uniform01(w) for w in rng.seeded_words(seeds, t, k)], dim=1),
        t) for t in range(params.horizon)]
    return (lambda: reset(params, None, n, device=dev)), demands


def step(params: NetInvParams, state: NetInvState, action: torch.Tensor,
         generator: torch.Generator):
    demand = sample_demand(params, generator, state.period, state.X.shape[0],
                           device=state.X.device)
    return step_with_demand(params, state, action, demand)


ENV = Environment(
    name="net_inv_management",
    default_params=default_params,
    reset=reset,
    step=step,
    step_with_demand=step_with_demand,
    observation_space=observation_space,
    action_space=action_space,
    seeded_draws=seeded_draws,
)
