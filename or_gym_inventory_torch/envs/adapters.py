"""Gymnasium drop-in adapters: the reference's mutable-env API on NumPy host
dynamics (port of ``or_gym_inventory_tpu/envs/adapters.py``).

A reference user can switch imports and keep their code:

    from or_gym_inventory_torch.envs.adapters import (
        NewsvendorEnv, CustomizableNewsvendorEnv,
        InvManagementMasterEnv, InvManagementBacklogEnv, InvManagementLostSalesEnv,
        NetInvMgmtMasterEnv, NetInvMgmtBacklogEnv, NetInvMgmtLostSalesEnv,
        NetInvMgmtCustomMasterEnv, NetInvMgmtCustomBacklogEnv,
        NetInvMgmtCustomLostSalesEnv, assign_env_config)

The classes are the JAX package's, line for line, built on the port's own
modules: the draw order of ``core.parity``, the params, spaces and topology
compiler of ``envs/``. No tensor and no device: a single env steps on the
host in NumPy (a per-step device round trip would cost more than the step).

Fidelity contract (held bit for bit against the JAX package's adapters by
tests/test_torch_adapters.py):
- Seeding and randomness reproduce the reference draw for draw (PCG64 via
  ``Env.reset(seed)``; draw-order contracts in core/parity.py), so a seed
  and an action sequence give the reference's trajectory.
- The attributes the reference's heuristics and evaluators reach into are
  exposed: ``lead_time/action_log/period/dist_param/I``
  (benchmark_InvManagementBacklogEnv.py:154-184) and the network env's lazy
  ``X/Y/R/S/D/U/P`` pandas frames + ``retail_links/main_nodes``
  (benchmark_NetInvMgmtBacklogEnv.py:268-277).
- The reference quirks QUIRKS.md lists for the host envs are kept, among
  them the NetInvMgmt master-__init__ backlog override
  (network_management.py:83-85) that makes the LostSales subclasses run
  with backlog=True.

The base classes and ``Box`` come from ``core.gym_compat``: gymnasium's
where it is installed, else stand-ins with the same seeding.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from or_gym_inventory_torch.core import gym_compat as gym
from or_gym_inventory_torch.core import parity
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import net_inv_management as net
from or_gym_inventory_torch.envs import newsvendor as nv
from or_gym_inventory_torch.envs import topology as topo_mod


def assign_env_config(self, config: Dict[str, Any]):
    """Reference-compatible reflection override (inventory_management.py:15-17,
    network_management.py:17-24 incl. the DiGraph deep-copy special case)."""
    for key, value in config.items():
        if key == "graph" and hasattr(value, "copy") and hasattr(value, "edges"):
            self.graph = value.copy()
        else:
            setattr(self, key, value)


# ===================================================================== E1/E9

class NewsvendorEnv(gym.Env):
    """Drop-in for reference newsvendor.py:13-230."""

    metadata = {"render_modes": [], "render_fps": 4}

    def __init__(self, lead_time: int = 5, max_inventory: int = 4000,
                 max_order_quantity: int = 2000, step_limit: int = 40,
                 p_max: float = 100.0, h_max: float = 5.0, k_max: float = 10.0,
                 mu_max: float = 200.0, gamma: float = 1.0):
        super().__init__()
        self.params = nv.default_params(
            lead_time=lead_time, max_inventory=float(max_inventory),
            max_order_quantity=float(max_order_quantity), step_limit=step_limit,
            p_max=p_max, h_max=h_max, k_max=k_max, mu_max=mu_max, gamma=gamma)
        p = self.params
        self.lead_time = p.lead_time
        self.max_inventory = p.max_inventory
        self.max_order_quantity = p.max_order_quantity
        self.step_limit = p.step_limit
        self.p_max, self.h_max, self.k_max, self.mu_max = p.p_max, p.h_max, p.k_max, p.mu_max
        self.gamma = p.gamma
        self.obs_dim = p.obs_dim
        self.observation_space = nv.observation_space(p).to_gymnasium()
        self.action_space = nv.action_space(p).to_gymnasium()
        self.state: Optional[np.ndarray] = None
        self.step_count = 0
        self.price = self.cost = self.h = self.k = self.mu = 0.0

    # -- reference reset draw order: parity.newsvendor_reset_draws --
    def _randomize_econ(self):
        self.price, self.cost, self.h, self.k, self.mu = \
            parity.newsvendor_reset_draws(
                self.np_random, self.p_max, self.h_max, self.k_max, self.mu_max)

    def _init_state(self):
        self.state = np.zeros(self.obs_dim, dtype=np.float32)
        self.state[:5] = [self.price, self.cost, self.h, self.k, self.mu]
        self.step_count = 0
        return self._get_obs(), self._get_info()

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None):
        super().reset(seed=seed)
        self._randomize_econ()
        return self._init_state()

    def step(self, action):
        # Expression-for-expression mirror of newsvendor.py:125-204 — scalar
        # numpy dtypes are preserved (float32 state reads stay float32 under
        # NEP 50) so rewards match the reference bit-for-bit.
        self.step_count += 1
        a = np.asarray(action)
        order_qty_raw = a.item() if a.size == 1 else action
        order_qty = np.clip(order_qty_raw, 0, self.max_order_quantity)
        current_pipeline_inventory = self.state[5:].sum()
        if self.lead_time > 0:
            inv_on_hand = self.state[5]
        else:
            inv_on_hand = order_qty
        order_qty = max(0, min(order_qty,
                               self.max_inventory - current_pipeline_inventory))

        demand = self.np_random.poisson(self.mu)
        sales = min(inv_on_hand, demand)
        revenue = sales * self.price
        excess = max(0, inv_on_hand - demand)
        short = max(0, demand - inv_on_hand)
        purchase_cost = order_qty * self.cost
        holding_cost = excess * self.h
        lost_sales_penalty = short * self.k
        reward = revenue - purchase_cost - holding_cost - lost_sales_penalty

        if self.lead_time > 0:
            self.state[5:-1] = self.state[6:]
            self.state[-1] = order_qty
        truncated = self.step_count >= self.step_limit

        info = self._get_info()
        info.update(demand=demand, revenue=revenue, purchase_cost=purchase_cost,
                    holding_cost=holding_cost, lost_sales_penalty=lost_sales_penalty)
        return self._get_obs(), float(reward), False, truncated, info

    def _get_obs(self):
        return self.state.copy()

    def _get_info(self):
        return {"price": self.price, "cost": self.cost,
                "holding_cost_rate": self.h, "penalty_cost_rate": self.k,
                "demand_mean": self.mu, "lead_time": self.lead_time,
                "step_count": self.step_count}

    def render(self):
        pass

    def close(self):
        pass


class CustomizableNewsvendorEnv(NewsvendorEnv):
    """Reference benchmark_newsvendor_sb3_rllib.py:276-291: reset(options=
    {'fixed_params': {...}}) pins any of price/cost/h/k/mu."""

    def reset(self, seed: Optional[int] = None, options: Optional[Dict] = None):
        gym.Env.reset(self, seed=seed)
        fixed = options.get("fixed_params") if options else None
        self._randomize_econ()
        if fixed:
            self.price = fixed.get("price", self.price)
            self.cost = fixed.get("cost", self.cost)
            self.h = fixed.get("h", self.h)
            self.k = fixed.get("k", self.k)
            self.mu = fixed.get("mu", self.mu)
        obs, info = self._init_state()
        if fixed:
            info["fixed_params_used"] = fixed
        return obs, info


# ====================================================================== E3-E5

class InvManagementMasterEnv(gym.Env):
    """Drop-in for reference inventory_management.py:19-425."""

    metadata = {"render_modes": [], "render_fps": 4}
    _force_backlog: Optional[bool] = None

    def __init__(self, periods: int = 30, I0=(100, 150, 200), p: float = 20,
                 r=(15, 10, 7, 5), k=(0.10, 0.075, 0.05, 0.025),
                 h=(0.15, 0.10, 0.05), c=(100, 200, 230), L=(1, 5, 10),
                 backlog: bool = True, dist: int = 1,
                 dist_param: Optional[Dict] = None, alpha: float = 0.97,
                 seed_int: int = 0, user_D=None,
                 env_config: Optional[Dict] = None):
        super().__init__()
        # replicate reference config flow: kwargs then env_config overrides
        # (inventory_management.py:66-84), then subclass backlog forcing
        cfg = dict(periods=periods, I0=I0, p=p, r=r, k=k, h=h, c=c, L=L,
                   backlog=backlog, dist=dist,
                   dist_param=dict(dist_param or {"mu": 20}), alpha=alpha,
                   user_D=tuple(user_D) if user_D else ())
        for key, value in (env_config or {}).items():
            if key not in cfg:
                raise KeyError(f"Unknown env_config key {key!r}")
            cfg[key] = value
        if self._force_backlog is not None:
            cfg["backlog"] = self._force_backlog
        self.seed_int = seed_int
        self.params = im.default_params(**cfg)
        P = self.params

        # reference-compatible attributes
        self.periods = self.num_periods = P.periods
        self.I0 = list(P.I0)
        self.init_inv = np.array(P.I0, np.int32)
        self.p = P.p
        self.r, self.k, self.h, self.c, self.L = (list(P.r), list(P.k),
                                                  list(P.h), list(P.c), list(P.L))
        self.backlog = P.backlog
        self.dist = P.dist
        self.dist_param = P.dist_param_dict
        self.alpha = self.discount = P.alpha
        self.user_D = np.array(P.user_D, np.int64)
        self.unit_price = P.unit_price
        self.unit_cost = P.unit_cost
        self.demand_cost = np.array(P.k, np.float32)
        self.holding_cost = P.holding_cost_vec
        self.supply_capacity = np.array(P.c, np.int64)
        self.lead_time = np.array(P.L, np.int64)
        self.num_stages = P.num_stages
        self.lt_max = P.lt_max
        self.pipeline_length = P.pipeline_length

        self.action_space = gym.Box(
            low=np.zeros(P.m1, np.int64),
            high=self.supply_capacity.astype(np.int64),
            shape=(P.m1,), dtype=np.int64)
        bound = P.obs_bound
        low = (-bound if P.backlog else 0) * np.ones(P.pipeline_length, np.int64)
        self.observation_space = gym.Box(
            low=low, high=bound * np.ones(P.pipeline_length, np.int64),
            shape=(P.pipeline_length,), dtype=np.int64)

        self.period = 0
        self.I = self.T = self.R = self.D = self.S = self.B = None
        self.LS = self.P = self.action_log = None

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        super().reset(seed=seed)
        periods, m = self.num_periods, self.num_stages
        self.I = np.zeros((periods + 1, m - 1), dtype=np.int64)
        self.T = np.zeros((periods + 1, m - 1), dtype=np.int64)
        self.R = np.zeros((periods, m - 1), dtype=np.int64)
        self.D = np.zeros(periods, dtype=np.int64)
        self.S = np.zeros((periods, m), dtype=np.int64)
        self.B = np.zeros((periods + 1, m), dtype=np.int64)
        self.LS = np.zeros((periods, m), dtype=np.int64)
        self.P = np.zeros(periods, dtype=np.float32)
        self.action_log = np.zeros((periods, m - 1), dtype=np.int64)
        # step scratch buffers (avoid per-step np.append allocations)
        self._supplier_inv_buf = np.empty(m - 1, dtype=np.float64)
        self._supplier_inv_buf[-1] = np.inf
        self._inv_ext_buf = np.zeros(m, dtype=np.int64)
        self.period = 0
        self.I[0, :] = self.init_inv
        return self._get_obs(), self._get_info()

    def _sample_demand(self) -> int:
        rng, dp = self.np_random, self.dist_param
        if self.dist == 1:
            return int(rng.poisson(lam=dp["mu"]))
        if self.dist == 2:
            return int(rng.binomial(n=dp["n"], p=dp["p"]))
        if self.dist == 3:
            return int(rng.integers(low=dp["low"], high=dp["high"] + 1))
        if self.dist == 4:
            return int(rng.geometric(p=dp["p"]))
        if self.dist == 5:
            return int(self.user_D[self.period]) if self.period < len(self.user_D) else 0
        raise ValueError(f"Invalid distribution choice: {self.dist}")

    def step(self, action):
        t, m = self.period, self.num_stages
        m1 = m - 1
        L, c = self.lead_time, self.supply_capacity

        r_requested = np.maximum(np.asarray(action), 0).astype(np.int64)
        order_request = r_requested.copy()
        if t >= 1:
            order_request += self.B[t, 1:]
        # supplier on-hand caps; last stage draws from unbounded raw material
        supplier_inv = self._supplier_inv_buf
        supplier_inv[:-1] = self.I[t, 1:]
        r_fulfill = np.minimum(np.minimum(order_request, c),
                               supplier_inv).astype(np.int64)
        self.R[t, :] = r_fulfill
        self.action_log[t, :] = r_requested

        inv = self.I[t, :].copy()
        for i in range(m1):
            if t - L[i] >= 0:
                inv[i] += self.R[t - L[i], i]

        demand = max(0, self._sample_demand())
        self.D[t] = demand
        to_fill = demand + (self.B[t, 0] if t >= 1 else 0)
        sales0 = min(inv[0], to_fill)
        inv[0] -= sales0

        S = np.zeros(m, dtype=np.int64)
        S[0], S[1:] = sales0, r_fulfill
        self.S[t, :] = S
        inv[1:] -= r_fulfill[1:]  # reference semantics (inventory_management.py:300)
        U = np.zeros(m, dtype=np.int64)
        U[0] = to_fill - sales0
        U[1:] = order_request - r_fulfill
        if self.backlog:
            self.B[t + 1, :] = U
            self.LS[t, :] = 0
        else:
            self.LS[t, :] = U
            self.B[t + 1, :] = 0

        inv_ext = self._inv_ext_buf
        inv_ext[:-1] = inv
        np.maximum(inv_ext, 0, out=inv_ext)
        revenue = float(self.unit_price @ S)
        procurement = float(self.unit_cost @ S)
        holding = float(self.holding_cost @ inv_ext)
        penalty = float(self.demand_cost @ U)
        period_profit = revenue - procurement - holding - penalty
        reward = (self.alpha ** t) * period_profit
        self.P[t] = reward
        self.I[t + 1, :] = inv

        self.period += 1
        info = self._get_info()
        info.update(period_profit=period_profit, revenue=revenue,
                    procurement_cost=procurement, holding_cost=holding,
                    penalty_cost=penalty, demand_realized=demand,
                    sales=S, unfulfilled=U, ending_inventory=inv,
                    backlog_start_of_next=self.B[t + 1, :])
        truncated = self.period >= self.num_periods
        return self._get_obs(), float(reward), False, truncated, info

    def _get_obs(self):
        t, m1, lt = self.period, self.num_stages - 1, self.lt_max
        state = np.zeros(self.pipeline_length, dtype=np.int64)
        state[:m1] = self.I[t, :m1]
        if t > 0 and lt > 0:
            n_past = min(t, lt)
            past = self.action_log[t - n_past:t, :]
            state[m1:m1 + past.size] = past.flatten()
        return state

    def _get_info(self):
        return {"period": self.period,
                "current_inventory_on_hand": self.I[self.period].copy(),
                "current_backlog": self.B[self.period].copy()}

    def sample_action(self):
        return self.action_space.sample()

    def render(self):
        print(f"Period: {self.period}")
        print(f"  Inventory (On-Hand): {self.I[self.period]}")
        print(f"  Backlog (Start of Period): {self.B[self.period]}")
        if self.period > 0:
            print(f"  Demand (Previous): {self.D[self.period - 1]}")
            print(f"  Sales (Previous): {self.S[self.period - 1]}")
            print(f"  Profit (Previous): {self.P[self.period - 1]:.2f}")

    def close(self):
        pass


class InvManagementBacklogEnv(InvManagementMasterEnv):
    _force_backlog = True


class InvManagementLostSalesEnv(InvManagementMasterEnv):
    _force_backlog = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        bound = self.params.obs_bound
        n = self.params.pipeline_length
        self.observation_space = gym.Box(
            low=np.zeros(n, np.int64), high=bound * np.ones(n, np.int64),
            shape=(n,), dtype=np.int64)


# ====================================================================== E6-E8

class NetInvMgmtMasterEnv(gym.Env):
    """Drop-in for reference network_management.py:26-743.

    State frames X/Y/R/S/D/U/P are real pandas DataFrames with the
    reference's MultiIndex layout, so evaluators that read them directly
    (benchmark_NetInvMgmtBacklogEnv.py:268-277) work unchanged. Internally
    the step math runs on the compiled topology tensors (envs/topology.py)
    in NumPy — no per-edge Python/pandas loops.
    """

    metadata = {"render_modes": ["human"], "render_fps": 4}
    _env_config_extra: Dict[str, Any] = {}

    def __init__(self, graph=None, num_periods: int = 30, backlog: bool = True,
                 alpha: float = 1.00, seed_int: int = 0,
                 user_D: Optional[Dict] = None, sample_path: Optional[Dict] = None,
                 env_config: Optional[Dict] = None):
        super().__init__()
        # Reference bug preserved: the master __init__ force-overwrites
        # env_config['backlog'] with the init ARG value
        # (network_management.py:83-85) — so subclasses that set backlog via
        # env_config (both reference subclasses do) are silently ignored and
        # everything runs with the kwarg/default. Pass ``backlog=`` directly
        # to actually change modes.
        _env_config = dict(env_config or {})
        _env_config.update(self._env_config_extra)
        _env_config["backlog"] = backlog
        num_periods = int(_env_config.pop("num_periods", num_periods))
        backlog = bool(_env_config.pop("backlog"))
        alpha = float(_env_config.pop("alpha", alpha))
        graph = _env_config.pop("graph", graph)
        user_D = _env_config.pop("user_D", user_D)
        sample_path = _env_config.pop("sample_path", sample_path)
        if _env_config:
            raise KeyError(f"Unknown env_config keys: {sorted(_env_config)}")

        self.seed_int = seed_int
        self.num_periods = num_periods
        self.backlog = backlog
        self.alpha = alpha
        self.user_D = dict(user_D or {})
        self.sample_path = dict(sample_path or {})
        self.graph = graph.copy() if graph is not None else None

        if self.graph is not None:
            self.topology = topo_mod.from_networkx(
                self.graph, num_periods, user_D=self.user_D,
                sample_path=self.sample_path)
        else:
            self.topology = self._default_topology(num_periods)
        T = self.topology
        self.params = net.NetInvParams(topology=T, num_periods=num_periods,
                                       backlog=backlog, alpha=alpha).validate()

        # reference-compatible derived attributes
        self.main_nodes = list(T.main_nodes)
        self.rawmat, self.market = list(T.rawmat), list(T.market)
        self.factory, self.distrib, self.retail = (list(T.factory),
                                                   list(T.distrib), list(T.retail))
        self.num_nodes = len(set(T.main_nodes) | set(T.rawmat) | set(T.market))
        self.reorder_links = list(T.reorder_links)
        self.retail_links = list(T.retail_links)
        self.network_links = sorted(self.reorder_links + self.retail_links)
        self.lead_times = dict(zip(T.reorder_links, T.ro_L))
        self.lt_max = T.lt_max
        self.pipeline_obs_length = T.pipeline_obs_length
        self.obs_dim = T.obs_dim
        self.init_inv_max = T.init_inv_max
        self.capacity_max = T.capacity_max
        self.order_cap_heuristic = T.order_cap_heuristic

        self.observation_space = net.observation_space(self.params).to_gymnasium()
        self.action_space = net.action_space(self.params).to_gymnasium()

        self.period = 0
        self._frames = {}

    def _default_topology(self, num_periods):
        return topo_mod.default_topology(num_periods, user_D=self.user_D,
                                         sample_path=self.sample_path)

    def reset(self, *, seed: Optional[int] = None, options: Optional[Dict] = None):
        super().reset(seed=seed)
        T, J = self.num_periods, len(self.main_nodes)
        RM, PS = len(self.retail_links), len(self.reorder_links)
        SL = len(self.network_links)
        # internal numpy state (hot path); pandas frames are lazy views below
        self._X = np.zeros((T + 1, J))
        self._Y = np.zeros((T + 1, PS))
        self._R = np.zeros((T, PS))
        self._S = np.zeros((T, SL))
        self._D = np.zeros((T, RM))
        self._U = np.zeros((T + 1, RM))
        self._P = np.zeros((T, J))
        self._frames = {}
        # column position of each edge in the sorted network_links S frame
        self._s_col = {e: i for i, e in enumerate(self.network_links)}
        self.period = 0
        self._X[0, :] = list(self.topology.I0)
        return self._get_obs(), self._get_info()

    # -- pandas frame views (reference layout), rebuilt lazily per step ----
    def _frame(self, name, data, columns, multi):
        import pandas as pd
        cached = self._frames.get(name)
        if cached is None:
            cols = (pd.MultiIndex.from_tuples(columns) if multi
                    else list(columns))
            cached = pd.DataFrame(data.copy(), columns=cols)
            self._frames[name] = cached
        return cached

    @property
    def X(self):
        return self._frame("X", self._X, self.main_nodes, False)

    @property
    def Y(self):
        return self._frame("Y", self._Y, self.reorder_links, True)

    @property
    def R(self):
        return self._frame("R", self._R, self.reorder_links, True)

    @property
    def S(self):
        return self._frame("S", self._S, self.network_links, True)

    @property
    def D(self):
        return self._frame("D", self._D, self.retail_links, True)

    @property
    def U(self):
        return self._frame("U", self._U, self.retail_links, True)

    @property
    def P(self):
        return self._frame("P", self._P, self.main_nodes, False)

    def _sample_demands(self) -> np.ndarray:
        """Per retail link, in declaration order (network_management.py:536-540).

        Named specs draw from ``self.np_random`` with the same Generator
        method + kwargs the reference's default ``demand_dist_func`` lambdas
        use, so seeded trajectories match the reference bit-for-bit;
        ``hostfn`` specs call the user's callable verbatim
        (network_management.py:258-263). Every draw is wrapped in
        ``max(0, int(round(.)))`` exactly as the reference step does (:540)."""
        T = self.topology
        rng = self.np_random
        out = np.zeros(T.n_retail)
        for j, spec in enumerate(T.rt_demand):
            tag = spec[0]
            if tag == "user":
                arr = spec[1]
                d = arr[min(self.period, len(arr) - 1)]
            elif tag == "poisson":
                d = rng.poisson(lam=spec[1])
            elif tag == "binomial":
                d = rng.binomial(n=int(spec[1]), p=spec[2])
            elif tag == "negbinomial":
                d = rng.negative_binomial(n=spec[1], p=spec[2])
            elif tag == "randint":
                d = rng.integers(low=int(spec[1]), high=int(spec[2]))
            elif tag == "geometric":
                d = rng.geometric(p=spec[1])
            elif tag == "normal":
                d = rng.normal(loc=spec[1], scale=spec[2])
            elif tag == "hostfn":
                d = spec[1](**dict(spec[2]))
            else:
                d = 0.0
            out[j] = max(0, int(round(float(d))))
        return out

    def step(self, action):
        T = self.topology
        t = self.period
        n_main = T.n_main
        X_t = self._X[t]

        # 0) sequential order fulfillment with supplier contention
        requests = np.maximum(0, np.round(np.asarray(action, np.float64).reshape(-1)))
        consumed = np.zeros(n_main)
        r_cur = np.zeros(T.n_reorder)
        for i in range(T.n_reorder):
            sup = T.ro_sup_main[i]
            if sup < 0:
                r_cur[i] = requests[i]
            else:
                avail = max(0.0, X_t[sup] - consumed[sup])
                if T.is_factory[sup]:
                    avail = min(avail, min(T.C[sup], T.v[sup] * avail))
                r_cur[i] = min(requests[i], avail)
                consumed[sup] += r_cur[i] / T.v[sup]
        self._R[t] = r_cur
        for i, e in enumerate(T.reorder_links):
            self._S[t, self._s_col[e]] = r_cur[i]

        # 1) deliveries + pipeline
        arriving = np.zeros(T.n_reorder)
        for i, L in enumerate(T.ro_L):
            if L == 0:
                arriving[i] = r_cur[i]
            elif t - L >= 0:
                arriving[i] = self._R[t - L, i]
        self._Y[t + 1] = self._Y[t] - arriving + r_cur
        arrivals_node = np.zeros(n_main)
        np.add.at(arrivals_node, np.asarray(T.ro_pur_main), arriving)
        X_mid = X_t + arrivals_node - consumed

        # 2-4) market demand, sequential retail fulfillment
        d = self._sample_demands()
        sales_rt = np.zeros(T.n_retail)
        U_new = np.zeros(T.n_retail)
        U_t = self._U[t]
        for j in range(T.n_retail):
            ret = T.rt_retailer_main[j]
            self._D[t, j] = d[j]
            to_fill = d[j] + U_t[j]
            s = min(to_fill, max(0.0, X_mid[ret]))
            X_mid[ret] -= s
            sales_rt[j] = s
            self._S[t, self._s_col[T.retail_links[j]]] = s
            U_new[j] = (to_fill - s) if self.backlog else 0.0
        self._U[t + 1] = U_new
        self._X[t + 1] = X_mid

        # 5) per-node profit
        ro_sup = np.asarray(T.ro_sup_main)
        ro_pur = np.asarray(T.ro_pur_main)
        rt_ret = np.asarray(T.rt_retailer_main)

        def seg(values, idx):
            out = np.zeros(n_main)
            mask = idx >= 0
            np.add.at(out, idx[mask], values[mask])
            return out

        SR = seg(np.asarray(T.ro_price) * r_cur, ro_sup) + seg(
            np.asarray(T.rt_price) * sales_rt, rt_ret)
        PC = seg(np.asarray(T.ro_price) * r_cur, ro_pur)
        HC = (np.asarray(T.h) * np.maximum(0, X_mid)
              + seg(np.asarray(T.ro_g) * np.maximum(0, self._Y[t + 1]), ro_pur))
        sold = seg(r_cur, ro_sup) + seg(sales_rt, rt_ret)
        OC = np.where(np.asarray(T.is_factory),
                      np.asarray(T.o) * sold / np.asarray(T.v), 0.0)
        UP = seg(np.asarray(T.rt_b) * U_new, rt_ret)
        node_profit = SR - PC - OC - HC - UP
        self._P[t] = node_profit
        total = float(node_profit.sum())
        reward = (self.alpha ** t) * total

        self._frames = {}  # invalidate lazy pandas views
        self.period += 1
        truncated = self.period >= self.num_periods
        info = self._get_info()
        info["profit_period_undiscounted"] = total
        info["profit_period_discounted"] = reward
        return self._get_obs(), float(reward), False, truncated, info

    def _get_obs(self):
        t = self.period
        parts = [self._U[t].astype(np.float32), self._X[t].astype(np.float32)]
        for i, edge in enumerate(self.topology.reorder_links):
            L = self.topology.ro_L[i]
            if L == 0:
                continue
            window = np.zeros(L, dtype=np.float32)
            lo = max(0, t - L)
            past = self._R[lo:t, i] if t > 0 else np.array([])
            if len(past):
                window[-len(past):] = past
            parts.append(window)
        return np.concatenate(parts).astype(np.float32)

    def _get_info(self):
        t = self.period
        info = {"period": t,
                "inventory": dict(zip(self.main_nodes, self._X[t])),
                "pipeline": dict(zip(self.reorder_links, self._Y[t])),
                "backlog_start": dict(zip(self.retail_links, self._U[t]))}
        if t > 0:
            tp = t - 1
            info.update(
                demand_prev=dict(zip(self.retail_links, self._D[tp])),
                sales_prev=dict(zip(self.network_links, self._S[tp])),
                profit_node_prev=dict(zip(self.main_nodes, self._P[tp])),
                profit_total_prev=self._P[tp].sum())
        return info

    def sample_action(self):
        return self.action_space.sample()

    def render(self, mode="human"):
        t = min(self.period, self.num_periods)
        print(f"--- START of Period: {t} ---")
        print("Inventory (X):"); print(self.X.loc[t])
        print("\nPipeline (Y):"); print(self.Y.loc[t])
        print("\nBacklog (U):"); print(self.U.loc[t])
        if t > 0:
            tp = t - 1
            print(f"\n--- Results from Previous Period ({tp}) ---")
            print(f"  Demand (D): {self.D.loc[tp].to_dict()}")
            print(f"  Sales (S): {self.S.loc[tp].to_dict()}")
            print(f"  Profit (P): {self.P.loc[tp].sum():.2f}")

    def plot_network(self):
        """Layered network plot (reference network_management.py:672-738)."""
        try:
            import matplotlib.pyplot as plt
            import networkx as nx
        except ImportError:
            print("Matplotlib/networkx not installed. Cannot plot network.")
            return
        T = self.topology
        g = nx.DiGraph()
        layers, colors, labels = {}, [], {}
        for n in sorted(set(T.main_nodes) | set(T.rawmat) | set(T.market)):
            g.add_node(n)
            if n in T.rawmat:
                layers[n], c, tag = 0, "gray", "RawM"
            elif n in T.factory:
                layers[n], c, tag = 1, "skyblue", "Fact"
            elif n in T.retail:
                layers[n], c, tag = 3, "lightgreen", "Retail"
            elif n in T.distrib:
                layers[n], c, tag = 2, "khaki", "Dist"
            else:
                layers[n], c, tag = 4, "salmon", "Market"
            colors.append(c)
            labels[n] = f"{n}\n({tag})"
        edge_labels = {}
        for e, L in zip(T.reorder_links, T.ro_L):
            g.add_edge(*e)
            edge_labels[e] = f"L={L}"
        for e in T.retail_links:
            g.add_edge(*e)
        nx.set_node_attributes(g, layers, "layer")
        pos = nx.multipartite_layout(g, subset_key="layer")
        plt.figure(figsize=(12, 8))
        nx.draw_networkx_nodes(g, pos, node_color=colors, node_size=1500, alpha=0.8)
        nx.draw_networkx_edges(g, pos, arrowstyle="->", arrowsize=20,
                               edge_color="gray", node_size=1500)
        nx.draw_networkx_labels(g, pos, labels=labels, font_size=9)
        nx.draw_networkx_edge_labels(g, pos, edge_labels=edge_labels,
                                     font_size=8, label_pos=0.3)
        plt.title("Supply Network Structure")
        plt.box(False)
        return plt.gcf()

    def close(self):
        pass


class NetInvMgmtBacklogEnv(NetInvMgmtMasterEnv):
    _env_config_extra = {"backlog": True}


class NetInvMgmtLostSalesEnv(NetInvMgmtMasterEnv):
    # NOTE: like the reference subclass (network_management.py:755-761), this
    # sets backlog only via env_config, which the master __init__ overrides
    # back to the kwarg default True — so this class, exactly like the
    # reference it mirrors, runs with backlog=True unless backlog=False is
    # passed directly. The obs-space low clamp is applied as in the reference.
    _env_config_extra = {"backlog": False}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        lo = self.observation_space.low.copy()
        lo[: len(self.retail_links)] = 0.0
        self.observation_space = gym.Box(
            low=lo, high=self.observation_space.high,
            shape=(self.obs_dim,), dtype=self.observation_space.dtype)


class NetInvMgmtCustomMasterEnv(NetInvMgmtMasterEnv):
    """network_management_custom.py variant: only the default graph differs."""

    def _default_topology(self, num_periods):
        return topo_mod.custom_topology(num_periods, user_D=self.user_D,
                                        sample_path=self.sample_path)


class NetInvMgmtCustomBacklogEnv(NetInvMgmtCustomMasterEnv):
    _env_config_extra = {"backlog": True}


class NetInvMgmtCustomLostSalesEnv(NetInvMgmtCustomMasterEnv, NetInvMgmtLostSalesEnv):
    _env_config_extra = {"backlog": False}

    def _default_topology(self, num_periods):
        return topo_mod.custom_topology(num_periods, user_D=self.user_D,
                                        sample_path=self.sample_path)
