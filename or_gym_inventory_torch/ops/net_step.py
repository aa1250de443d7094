"""NetInvMgmt whole-episode kernels and their plain PyTorch versions.

Port of ``or_gym_inventory_tpu/ops/pallas_net_step.py``: the kernels of the
random-policy episode returns and the one-period step (``csrc/net_episode.cu``)
and those of the learned policy (``csrc/net_policy.cu``). Each public function is a
wrapper: on the CPU it runs the plain PyTorch version in this module, on
CUDA it launches its hand-written kernel and raises if the launch fails;
nothing falls back. Each wrapper counts its kernel launches in a plain
integer attribute, ``<wrapper>.launches``.

| wrapper                      | replaces (pallas_net_step.py)         |
| ``episode_returns``          | ``episode_returns`` :820 (K1)         |
| ``episode_returns_fully_fused`` | ``episode_returns_fully_fused`` :379 (K2) |
| ``sample_streams_debug``     | ``sample_streams_debug`` :427 (K3)    |
| ``rollout_traj_net``         | ``rollout_traj_net`` :683 (K4)        |
| ``episode_returns_net_policy`` | ``episode_returns_net_policy`` :611 (K5) |
| ``sample_policy_streams_debug_net`` | ``sample_policy_streams_debug_net`` :756 (K6) |
| ``batched_step``             | ``batched_step`` :774 (K25)           |
| ``episode_returns_random_policy`` | ``episode_returns_random_policy`` :857 (K26) |
| ``rollout_traj_net_offpolicy`` | ``rollout_traj_net`` :683, off-policy heads (K29) |

``rollout_transposed`` (:907) drives ``batched_step`` once per period.

Layout follows the JAX package: per-env state as (rows, B) with the batch
last, streams as (T, rows, B) or (T, E, rows, B). The random streams are
Philox4x32-10 words (``ops/rng.py``), not the TPU's bits; the plain versions
draw bit for bit what the kernels draw.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import TYPE_CHECKING

import numpy as np
import torch

from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.ops import distributions as dist
from or_gym_inventory_torch.ops import episode_kernels as ek
from or_gym_inventory_torch.ops import rng

if TYPE_CHECKING:  # the env imports this module for its demand sampler
    from or_gym_inventory_torch.envs.net_inv_management import NetInvParams

# The kernels keep each thread's state, and the topology's records, in
# dynamic shared memory. An H100 gives a block at most 227 KB of it and an SM
# 228 KB, of which it keeps 1 KB for each resident block; an SM holds at most
# 2,048 threads and 32 blocks.
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = (
    ek.SMEM_OPTIN_BYTES, ek.SMEM_PER_SM, ek.SMEM_PER_BLOCK_RESERVED)
# the block size of every kernel on a graph whose state fits it
# (csrc/launch.cuh kThreads)
THREADS = 128
# the block sizes of the shared-state kernels (K1, K2, K25, K26), largest
# first: each takes the first whose block holds the graph's state and
# records; 32 threads, a warp, is the least, and sets the one bound on a graph
STATE_THREADS = (THREADS, 64, 32)
# floats of a topology record (csrc/net_topo.cuh NetLink, NetNode, NetRetail)
RECORD_FLOATS = 8
# the small size class (csrc/net_topo.cuh NetTopoSmall, the first design's
# maxima): a graph of at most these reorder links, main nodes and retail
# links passes its records in the kernels' parameters, which the default
# graph's kernels read 2-6% faster than records in shared memory
SMALL_RO, SMALL_MAIN, SMALL_RT = 32, 16, 16


def init_transposed(params: NetInvParams, batch: int, device=None):
    """Reset state in the (rows, B) layout: X (n_main, B), Y (n_ro, B),
    U (n_rt, B) and the newest-first order history RH (lt*n_ro, B)."""
    dev = resolve_device(device)
    T = params.topology
    lt = max(T.lt_max, 1)
    f32 = dict(dtype=torch.float32, device=dev)
    X = torch.tensor(T.I0, **f32)[:, None].expand(T.n_main, batch)
    Y = torch.zeros((T.n_reorder, batch), **f32)
    U = torch.zeros((T.n_retail, batch), **f32)
    RH = torch.zeros((lt * T.n_reorder, batch), **f32)
    return X, Y, U, RH


def _step_math(T, backlog, X, Y, U, RH, act, dem, arrive_valid, dtype=torch.float32):
    """One period over lists of (B,) tensors (pallas_net_step._step_math).
    ``RH`` is a list of lt*n_ro rows, newest-first; ``arrive_valid[i]`` is
    1.0 iff t >= L_i. Returns (X', Y', U', r_cur, period_profit). With
    ``dtype=torch.float64`` (the float64 oracle, ops/episode_kernels.py)
    the same step of the inputs' float32 values in float64, and a sixth
    item: the float32 forward bound of each output (``_step_bounds``)."""
    ek._check_dtype(dtype)
    if dtype == torch.float64:
        X, Y, U, RH, act, dem = ([r.to(torch.float32).to(dtype) for r in rows]
                                 for rows in (X, Y, U, RH, act, dem))
    n_main, n_ro, n_rt = T.n_main, T.n_reorder, T.n_retail

    # --- 0) order fulfillment with sequential supplier contention ---
    consumed = [torch.zeros_like(X[0]) for _ in range(n_main)]
    r_cur = []
    for i in range(n_ro):
        req = torch.clamp_min(torch.round(act[i]), 0.0)
        sup = T.ro_sup_main[i]
        if sup < 0:
            fulfilled = req
        else:
            remaining = X[sup] - consumed[sup]
            avail = torch.clamp_min(remaining, 0.0)
            if T.is_factory[sup]:
                avail = torch.minimum(avail, torch.clamp_max(T.v[sup] * avail, T.C[sup]))
            fulfilled = torch.minimum(req, avail)
            consumed[sup] = consumed[sup] + fulfilled / T.v[sup]
        r_cur.append(fulfilled)

    # --- 1) deliveries + pipeline ---
    arriving = []
    for i, L in enumerate(T.ro_L):
        if L == 0:
            arriving.append(r_cur[i])
        else:
            arriving.append(RH[(L - 1) * n_ro + i] * arrive_valid[i])
    Y_new = [Y[i] - arriving[i] + r_cur[i] for i in range(n_ro)]
    arrivals_node = [torch.zeros_like(X[0]) for _ in range(n_main)]
    for i in range(n_ro):
        arrivals_node[T.ro_pur_main[i]] = arrivals_node[T.ro_pur_main[i]] + arriving[i]
    X_mid = [X[j] + arrivals_node[j] - consumed[j] for j in range(n_main)]

    # --- 2-4) sequential retail fulfillment ---
    sales_rt, U_new = [], []
    for j in range(n_rt):
        ret = T.rt_retailer_main[j]
        d = torch.clamp_min(torch.round(dem[j]), 0.0)
        to_fill = d + U[j]
        inv_r = torch.clamp_min(X_mid[ret], 0.0)
        s = torch.minimum(to_fill, inv_r)
        X_mid[ret] = X_mid[ret] - s
        sales_rt.append(s)
        unf = to_fill - s
        U_new.append(unf if backlog else torch.zeros_like(unf))

    # --- 5) per-node profit ---
    zero = torch.zeros_like(X[0])
    SR = [zero] * n_main
    PC = [zero] * n_main
    HCp = [zero] * n_main
    sold = [zero] * n_main
    for i in range(n_ro):
        sup, pur = T.ro_sup_main[i], T.ro_pur_main[i]
        rev = T.ro_price[i] * r_cur[i]
        if sup >= 0:
            SR[sup] = SR[sup] + rev
            sold[sup] = sold[sup] + r_cur[i]
        PC[pur] = PC[pur] + rev
        HCp[pur] = HCp[pur] + T.ro_g[i] * torch.clamp_min(Y_new[i], 0.0)
    UP = [zero] * n_main
    for j in range(n_rt):
        ret = T.rt_retailer_main[j]
        SR[ret] = SR[ret] + T.rt_price[j] * sales_rt[j]
        sold[ret] = sold[ret] + sales_rt[j]
        UP[ret] = UP[ret] + T.rt_b[j] * U_new[j]

    total = torch.zeros_like(X[0])
    terms = [] if dtype == torch.float64 else None
    for n in range(n_main):
        HC = T.h[n] * torch.clamp_min(X_mid[n], 0.0) + HCp[n]
        OC = (T.o[n] * sold[n] / T.v[n]) if T.is_factory[n] else zero
        total = total + (SR[n] - PC[n] - OC - HC - UP[n])
        if terms is not None:
            terms += [SR[n], PC[n], OC, HC, UP[n]]
    if terms is None:
        return X_mid, Y_new, U_new, r_cur, total
    flows = dict(X=X, Y=Y, U=U, arriving=arriving, arrivals_node=arrivals_node,
                 consumed=consumed, r_cur=r_cur, sales_rt=sales_rt, d=[
                     torch.clamp_min(torch.round(d), 0.0) for d in dem])
    return X_mid, Y_new, U_new, r_cur, total, _step_bounds(T, flows, terms)


def _step_terms(T) -> int:
    """The terms of a period's profit (``_step_math`` step 5): each reorder
    link's revenue at its supplier and cost at its purchaser and its
    pipeline holding cost, each retail link's sales and unmet-demand
    terms, and each node's holding and operating cost."""
    return 3 * T.n_reorder + 2 * T.n_retail + 2 * T.n_main


def _step_bounds(T, flows, terms):
    """The float32 forward bounds of ``_step_math``'s outputs (float64 rows
    of the flows each sums): a state row is its input plus or minus its
    flows, at most gamma_{2 (n_ro + n_rt) + 2} of their sum of |terms| (0
    wherever they are integers, as the default graphs' are, but bounded
    all the same); r_cur a min of the request and the supplier's stock,
    that stock's bound; the profit a sum of ``_step_terms`` products,
    gamma_{n + 2} of the sum of the node terms' magnitudes (every term of
    a node's revenue or cost is a price or cost times a quantity >= 0)."""
    g = ek.gamma_f32(2 * (T.n_reorder + T.n_retail) + 2)
    f = flows
    cons = [c.abs() for c in f["consumed"]]
    x_mag = [f["X"][n].abs() + f["arrivals_node"][n].abs() + cons[n] for n in range(T.n_main)]
    for j in range(T.n_retail):
        ret = T.rt_retailer_main[j]
        x_mag[ret] = x_mag[ret] + f["sales_rt"][j].abs()
    r_b = []
    for i in range(T.n_reorder):
        sup = T.ro_sup_main[i]
        r_b.append(torch.zeros_like(f["r_cur"][i]) if sup < 0 else
                   g * (f["X"][sup].abs() + cons[sup]))
    return dict(
        X=[g * m for m in x_mag],
        Y=[g * (f["Y"][i].abs() + f["arriving"][i].abs() + f["r_cur"][i].abs())
           for i in range(T.n_reorder)],
        U=[g * (f["d"][j] + f["U"][j].abs()) for j in range(T.n_retail)],
        r_cur=r_b,
        profit=ek.gamma_f32(_step_terms(T) + 2) * sum(t.abs() for t in terms))


def _poisson_cdf_table(lam: float, granularity: float = 2.0 ** -24):
    """Poisson CDF values F(0..K-1) for inversion sampling
    (pallas_net_step._poisson_cdf_table): float64 on host, truncated at the
    first K with P(X >= K) < ``granularity`` and rounded to f32."""
    if lam <= 0.0:
        return (float("inf"),)  # demand identically 0
    p = float(np.exp(-lam))
    F = p
    table = [F]
    k = 0
    while 1.0 - F > granularity and k < 4096:
        k += 1
        p *= lam / k
        F += p
        table.append(F)
    return tuple(float(np.float32(v)) for v in table)


def _topology_link_specs(T, num_steps):
    """Per-retail-link demand plan (pallas_net_step._topology_link_specs):
    ``("table", base, thresholds)`` for every static-parameter spec,
    ``("const", per_period_values)`` for ``user``/``zero`` links. A ``hostfn``
    link raises NotImplementedError, before anything is launched."""
    return tuple(_link_spec(spec, num_steps) for spec in T.rt_demand)


def _link_spec(spec, num_steps):
    """One link's entry of ``_topology_link_specs``. Raises
    NotImplementedError for a ``hostfn`` spec and for one whose inversion
    table would exceed the cap."""
    if spec[0] == "user":
        arr = tuple(float(v) for v in spec[1]) or (0.0,)
        return ("const", tuple(arr[min(t, len(arr) - 1)] for t in range(num_steps)))
    if spec[0] == "zero":
        return ("const", (0.0,) * num_steps)
    return ("table",) + dist.cdf_table_for_spec(spec)


def _act_scale(act_hi: float) -> float:
    """The f32 factor of ``action = float(u24) * scale`` (pallas_net_step.py:328)."""
    return float(np.float32(float(act_hi) / float(1 << 24)))


# ------------------------------------------------------------ plain versions

def _episode_returns_plain(params: NetInvParams, actions, demands):
    """Plain version of K1 (``episode_returns``): the episode loop of
    pallas_net_step._episode_kernel_body over (B,) rows."""
    T = params.topology
    n_ro, n_rt = T.n_reorder, T.n_retail
    lt = max(T.lt_max, 1)
    num_steps, _, B = actions.shape
    X, Y, U, RH = init_transposed(params, B, actions.device)
    X, Y, U, RH = list(X), list(Y), list(U), list(RH)
    total = torch.zeros(B, dtype=torch.float32, device=actions.device)
    for t, disc in enumerate(ek._discounts(params.alpha, num_steps)):
        valid = [1.0 if t >= L else 0.0 for L in T.ro_L]
        X, Y, U, r_cur, profit = _step_math(
            T, params.backlog, X, Y, U, RH, list(actions[t]), list(demands[t]), valid)
        RH = r_cur + RH[: (lt - 1) * n_ro]
        total = total + disc * profit
    return total


def _device_link_plan(link_specs, device):
    """``_topology_link_specs`` as f32 tensors on ``device``: per link
    ("table", base, thresholds) or ("const", per-period values). An empty
    table (a point mass at ``base``) becomes (inf,), which inverts to 0."""
    plan = []
    for spec in link_specs:
        if spec[0] == "const":
            plan.append(("const", torch.tensor(spec[1], dtype=torch.float32,
                                               device=device)))
        else:
            _tag, base, table = spec
            plan.append(("table", float(base),
                         torch.tensor(table or (float("inf"),),
                                      dtype=torch.float32, device=device)))
    return plan


def _draw_period_plain(plan, seed, lanes, e, t, n_ro, act_scale):
    """Actions (n_ro rows) and demand (one row per link) of every lane in
    ``lanes`` for episode ``e``, period ``t``: the words of ``rng`` turned
    into values exactly as csrc/net_step.cuh ``draw_period`` does."""
    words = rng.period_words(seed, lanes, e, t, n_ro + len(plan))
    act = [(w >> 8).to(torch.float32) * act_scale for w in words[:n_ro]]
    return act, _link_demand_plain(plan, words[n_ro:], t)


def _link_demand_plain(plan, words, t):
    """Demand of period ``t``, one row per link, from one word per link
    (csrc/net_step.cuh ``link_demand``)."""
    dem = []
    for spec, w in zip(plan, words):
        if spec[0] == "const":
            vals = spec[1]
            dem.append(vals[min(t, vals.shape[0] - 1)].expand(w.shape))
        else:
            _tag, base, table = spec
            d = torch.searchsorted(table, rng.uniform01(w), right=True).to(torch.float32)
            dem.append(d + base if base else d)
    return dem


def _sample_streams_plain(params, seed, act_hi, batch, num_steps, e0, e1, device):
    """Plain version of K3: (T, W, n_ro, B) actions and (T, W, n_rt, B)
    demand of episodes [e0, e1)."""
    T = params.topology
    n_ro, n_rt = T.n_reorder, T.n_retail
    plan = _device_link_plan(_topology_link_specs(T, num_steps), device)
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    W = e1 - e0
    acts = torch.empty((num_steps, W, n_ro, batch), dtype=torch.float32, device=device)
    dems = torch.empty((num_steps, W, n_rt, batch), dtype=torch.float32, device=device)
    scale = _act_scale(act_hi)
    for w in range(W):
        for t in range(num_steps):
            act, dem = _draw_period_plain(plan, seed, lanes, e0 + w, t, n_ro, scale)
            acts[t, w] = torch.stack(act)
            dems[t, w] = torch.stack(dem)
    return acts, dems


def _episode_returns_fully_fused_plain(params, seed, act_hi, batch, num_steps,
                                       episodes_per_lane, device):
    """Plain version of K2: returns (E, B), one episode at a time."""
    T = params.topology
    n_ro = T.n_reorder
    lt = max(T.lt_max, 1)
    plan = _device_link_plan(_topology_link_specs(T, num_steps), device)
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    scale = _act_scale(act_hi)
    discs = ek._discounts(params.alpha, num_steps)
    out = torch.empty((episodes_per_lane, batch), dtype=torch.float32, device=device)
    for e in range(episodes_per_lane):
        X, Y, U, RH = (list(a) for a in init_transposed(params, batch, device))
        total = torch.zeros(batch, dtype=torch.float32, device=device)
        for t in range(num_steps):
            act, dem = _draw_period_plain(plan, seed, lanes, e, t, n_ro, scale)
            valid = [1.0 if t >= L else 0.0 for L in T.ro_L]
            X, Y, U, r_cur, profit = _step_math(
                T, params.backlog, X, Y, U, RH, act, dem, valid)
            RH = r_cur + RH[: (lt - 1) * n_ro]
            total = total + discs[t] * profit
        out[e] = total
    return out


# ------------------------------------------------------------ kernel binding

class _NetLink(ctypes.Structure):
    """Mirror of ``struct NetLink`` in csrc/net_topo.cuh: a reorder link."""
    _fields_ = [("sup", ctypes.c_int), ("pur", ctypes.c_int), ("L", ctypes.c_int),
                ("ring", ctypes.c_int), ("price", ctypes.c_float), ("g", ctypes.c_float),
                ("pad0", ctypes.c_int), ("pad1", ctypes.c_int)]


class _NetNode(ctypes.Structure):
    """Mirror of ``struct NetNode`` in csrc/net_topo.cuh: a main node."""
    _fields_ = [("is_factory", ctypes.c_int), ("C", ctypes.c_float), ("v", ctypes.c_float),
                ("h", ctypes.c_float), ("o", ctypes.c_float), ("I0", ctypes.c_float),
                ("pad0", ctypes.c_int), ("pad1", ctypes.c_int)]


class _NetRetail(ctypes.Structure):
    """Mirror of ``struct NetRetail`` in csrc/net_topo.cuh: a retail link
    and its demand plan."""
    _fields_ = [("ret", ctypes.c_int), ("konst", ctypes.c_int), ("off", ctypes.c_int),
                ("len", ctypes.c_int), ("price", ctypes.c_float), ("b", ctypes.c_float),
                ("base", ctypes.c_float), ("pad0", ctypes.c_int)]


class _NetTopo(ctypes.Structure):
    """Mirror of ``struct NetTopo`` in csrc/net_topo.cuh: the counts and the
    device address of the records (4 ints, then an 8-byte pointer at offset
    16, so both sides lay it out without padding)."""
    _fields_ = [("n_main", ctypes.c_int), ("n_ro", ctypes.c_int), ("n_rt", ctypes.c_int),
                ("backlog", ctypes.c_int), ("rec", ctypes.c_void_p)]


# each field of the small class's arrays: (name, the record and its field,
# the array's length)
_SMALL_FIELDS = (
    [(f"ro_{f}", "links", f, SMALL_RO) for f in ("sup", "pur", "L", "ring", "price", "g")]
    + [(f, "nodes", f, SMALL_MAIN) for f in ("is_factory", "I0", "h", "C", "o", "v")]
    + [(f"rt_{name}", "retail", f, SMALL_RT)
       for name, f in (("ret", "ret"), ("price", "price"), ("b", "b"), ("const", "konst"),
                       ("off", "off"), ("len", "len"), ("base", "base"))])


class _NetTopoSmall(ctypes.Structure):
    """Mirror of ``NetTopoSmall`` (``NetTopoParams<32, 16, 16>``) in
    csrc/net_topo.cuh, the first design's struct: the counts, then each
    record field in an array of its own (all fields 4-byte, so both sides
    lay it out without padding)."""
    _fields_ = [("n_main", ctypes.c_int), ("n_ro", ctypes.c_int), ("n_rt", ctypes.c_int),
                ("backlog", ctypes.c_int)] + [
        (name, dict(_NetLink._fields_ + _NetNode._fields_ + _NetRetail._fields_)[field] * n)
        for name, _, field, n in _SMALL_FIELDS]


def _small_class(n_main: int, n_ro: int, n_rt: int) -> bool:
    """Whether a graph of these counts takes the small size class."""
    return n_main <= SMALL_MAIN and n_ro <= SMALL_RO and n_rt <= SMALL_RT


class _NetSmem(ctypes.Structure):
    """Mirror of ``struct NetSmem`` in csrc/net_step.cuh: a thread's words
    of shared state and each field's word offset."""
    _fields_ = [(name, ctypes.c_int) for name in
                ("words", "x", "consumed", "arrivals", "sold", "y", "slot", "u", "ring")]


@dataclasses.dataclass(frozen=True)
class SharedStatePlan:
    """The launch plan of K2 and K26, and (without the scratch) the state
    K5/K6 keep a lane. ``offsets`` maps each state field to its first word;
    word k of thread t lies at ``smem[k * threads + t]``; the topology's
    ``topo_floats`` follow the threads' words."""
    words: int            # 32-bit words of state a thread
    offsets: dict
    threads: int          # threads a block
    bytes: int            # dynamic shared memory a block
    blocks_per_sm: int    # resident blocks an SM holds on an H100
    topo_floats: int      # the topology's records, the block's last floats


def _topo_floats(n_main: int, n_ro: int, n_rt: int) -> int:
    """Floats of a graph's topology records in a block's shared memory:
    none for the small class, whose records are kernel parameters."""
    if _small_class(n_main, n_ro, n_rt):
        return 0
    return RECORD_FLOATS * (n_main + n_ro + n_rt)


def _block_plan(words: int, topo_floats: int, threads) -> tuple:
    """(threads, bytes, blocks an SM) of the first block size in ``threads``
    whose ``words`` a thread and the records fit a block's shared memory, or
    None."""
    for n in threads:
        nbytes = 4 * (words * n + topo_floats)
        if nbytes <= SMEM_PER_BLOCK:
            blocks = min(SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK_RESERVED), 2048 // n, 32)
            return n, nbytes, blocks
    return None


def _too_large(what: str, words: int, topo_floats: int) -> ValueError:
    """The refusal of a graph whose ``words`` a lane (``what``) and records
    fit no block of 32 threads."""
    held = (SMEM_PER_BLOCK - 4 * topo_floats) // (4 * 32)
    return ValueError(
        f"graph too large for the CUDA kernels: {what} needs {words} words a lane beside "
        f"the topology's {topo_floats}; the {SMEM_PER_BLOCK} bytes of shared memory of a "
        f"block of 32 threads hold {max(held, 0)} words a lane")


def _shared_state_plan(n_main: int, n_ro: int, n_rt: int, ring: int,
                       scratch: bool = True) -> SharedStatePlan:
    """The shared-memory layout of a graph with ``n_main`` main nodes,
    ``n_ro`` reorder links, ``n_rt`` retail links and lead times summing to
    ``ring``: X, consumed, arrivals and sold per main node, Y and the ring
    position per reorder link, U per retail link, then the order rings; the
    topology's records (``_topo_floats``) after the block's state. The block
    size is the first of ``STATE_THREADS`` that holds them (128 on a small
    graph of up to 453 words a lane); raises ValueError past a block of 32
    threads.
    Without ``scratch`` the step's per-node scratch
    (consumed, arrivals, sold) has no words (its offsets are the next
    field's): K5/K6 keep it in their tile's transient rows (net_policy.cu
    TileView), and the state here is what lasts the episode."""
    n_scratch = n_main if scratch else 0
    sizes = {"x": n_main, "consumed": n_scratch, "arrivals": n_scratch, "sold": n_scratch,
             "y": n_ro, "slot": n_ro, "u": n_rt, "ring": ring}
    offsets, words = {}, 0
    for name, size in sizes.items():
        offsets[name] = words
        words += size
    topo = _topo_floats(n_main, n_ro, n_rt)
    block = _block_plan(words, topo, STATE_THREADS)
    if block is None:
        raise _too_large("the state", words, topo)
    return SharedStatePlan(words, offsets, *block, topo)


class _NetStage(ctypes.Structure):
    """Mirror of ``struct NetStage`` in csrc/net_episode.cu: K1's and K25's
    words a thread (state and staging), the first staging word, the periods
    a staging buffer and the threads a block."""
    _fields_ = [(name, ctypes.c_int) for name in ("words", "stage", "chunk", "threads")]


@dataclasses.dataclass(frozen=True)
class StagedPlan:
    """The launch plan of K1 and K25: the lane's state (``state``, a
    ``SharedStatePlan``) and, from word ``stage`` on, the words its
    asynchronous copies land in; word k of thread t lies at
    ``smem[k * threads + t]``."""
    state: SharedStatePlan
    stage: int            # first staging word (the state's words)
    chunk: int            # periods a staging buffer
    words: int            # 32-bit words a thread, state and staging
    threads: int          # threads a block
    bytes: int            # dynamic shared memory a block
    blocks_per_sm: int    # resident blocks an SM holds on an H100

    def struct(self) -> "_NetStage":
        return _NetStage(words=self.words, stage=self.stage, chunk=self.chunk,
                         threads=self.threads)


def _staged_plan(state: SharedStatePlan, stage_words: int, chunk: int,
                 threads) -> StagedPlan:
    """``state`` followed by ``stage_words`` staging words a thread, then the
    records, at the first block size in ``threads`` that holds them, or
    None."""
    words = state.words + stage_words
    block = _block_plan(words, state.topo_floats, threads)
    return None if block is None else StagedPlan(state, state.words, chunk, words, *block)


# K1's block sizes, largest first: it takes the first whose block fits in
# shared memory (128 on a small graph of up to 453 words of state and
# staging). On an H100 the block size moved K1 by at most 3.4% at 1,024,
# 4,096 and 65,536 lanes x 30 (tools/net_k1_k25_sweep.py): a lane's chain
# of periods sets its time.
K1_THREADS = STATE_THREADS
# K1's periods a staging buffer (two buffers). Four ran 2% faster than one
# at 1,024 and 4,096 lanes and 7% at 65,536 (fewer waits, and at 65,536
# fewer resident warps contending for an SM's issue slots; same sweep).
K1_CHUNK = 4


def _k1_plan(n_main: int, n_ro: int, n_rt: int, ring: int, chunk: int = K1_CHUNK,
             threads: int = None) -> StagedPlan:
    """K1's shared memory for a graph of those counts (as
    ``_shared_state_plan`` takes them): K2's state (scratch included), then
    two staging buffers of ``chunk`` periods of n_ro + n_rt words, at
    ``threads`` a block, by default the first of ``K1_THREADS`` whose block
    fits, then the records. Raises ValueError where none fits, naming the
    words."""
    if chunk < 1:
        raise ValueError(f"K1 stages at least one period a buffer, got {chunk}")
    state = _shared_state_plan(n_main, n_ro, n_rt, ring)
    stage_words = 2 * chunk * (n_ro + n_rt)
    plan = _staged_plan(state, stage_words, chunk, K1_THREADS if threads is None else (threads,))
    if plan is None:
        raise ValueError(f"K1's staging of {chunk} periods a buffer fits no block of "
                         f"{threads or K1_THREADS} threads: " + str(_too_large(
                             "K1's state and staging", state.words + stage_words,
                             state.topo_floats)))
    return plan


def _k25_plan(n_main: int, n_ro: int, n_rt: int, arriving: int) -> StagedPlan:
    """K25's shared memory: the state of ``_shared_state_plan`` with one
    ring word for each of the ``arriving`` links with L > 0 (the order that
    arrives this period), then one staged period (its actions and demand),
    at the first of ``STATE_THREADS`` whose block holds them, then the
    records. Raises ValueError past a block of 32 threads."""
    state = _shared_state_plan(n_main, n_ro, n_rt, arriving)
    plan = _staged_plan(state, n_ro + n_rt, 1, STATE_THREADS)
    if plan is None:
        raise _too_large("K25's state and staging", state.words + n_ro + n_rt,
                         state.topo_floats)
    return plan


@functools.lru_cache(maxsize=32)
def _shared_layout(topology, scratch: bool = True):
    """(plan, its ``_NetSmem``) for ``topology``; ``scratch`` as
    ``_shared_state_plan`` takes it (False: K5/K6's state)."""
    plan = _shared_state_plan(topology.n_main, topology.n_reorder, topology.n_retail,
                              sum(topology.ro_L), scratch=scratch)
    return plan, _NetSmem(words=plan.words, **plan.offsets)


@dataclasses.dataclass(frozen=True)
class PackedTopology:
    """The topology's records as the kernels read them (csrc/net_topo.cuh):
    ``links`` (``_NetLink`` a reorder link), ``nodes`` (``_NetNode`` a main
    node) and ``retail`` (``_NetRetail`` a retail link), and the flat f32
    list ``tables`` of every retail link's inversion table or per-period
    constants, which a retail record's ``off``/``len`` index."""
    n_main: int
    n_ro: int
    n_rt: int
    backlog: int
    links: ctypes.Array
    nodes: ctypes.Array
    retail: ctypes.Array
    tables: list

    def records(self) -> np.ndarray:
        """The records as int32 words, in the kernels' order: the links, the
        main nodes, then the retail links."""
        raw = bytes(self.links) + bytes(self.nodes) + bytes(self.retail)
        return np.frombuffer(raw, dtype=np.int32).copy()


def _pack_topology(params: NetInvParams, link_specs=None, rings=None) -> PackedTopology:
    """The kernels' topology records and demand tables (``PackedTopology``).
    ``link_specs`` (``_topology_link_specs``) plans the demand; without it
    the retail records plan none (K1, K25 and K26 read no demand table).
    ``rings`` names each link's ring offset (K25: ``_arriving_words``); by
    default the cumulative lead times. No graph is too large to pack; the
    kernels' plans bound it by a block's shared memory."""
    T = params.topology
    n_main, n_ro, n_rt = T.n_main, T.n_reorder, T.n_retail
    rings = rings if rings is not None else tuple(np.cumsum((0,) + T.ro_L[:-1]).tolist())
    links = (_NetLink * n_ro)(*(
        _NetLink(sup=T.ro_sup_main[i], pur=T.ro_pur_main[i], L=T.ro_L[i], ring=int(rings[i]),
                 price=T.ro_price[i], g=T.ro_g[i]) for i in range(n_ro)))
    nodes = (_NetNode * n_main)(*(
        _NetNode(is_factory=int(T.is_factory[n]), C=T.C[n], v=T.v[n], h=T.h[n], o=T.o[n],
                 I0=T.I0[n]) for n in range(n_main)))
    retail = (_NetRetail * n_rt)()
    tables = []
    for j in range(n_rt):
        rt = retail[j]
        rt.ret, rt.price, rt.b = T.rt_retailer_main[j], T.rt_price[j], T.rt_b[j]
        if link_specs is None:
            continue
        spec = link_specs[j]
        values = spec[1] if spec[0] == "const" else spec[2]
        rt.konst = int(spec[0] == "const")
        rt.base = 0.0 if spec[0] == "const" else float(spec[1])
        rt.off, rt.len = len(tables), len(values)
        tables.extend(values)
    return PackedTopology(n_main, n_ro, n_rt, int(params.backlog), links, nodes, retail, tables)


def _topology_on(packed: PackedTopology, device: str) -> _NetTopo:
    """The header of ``packed``'s records copied to ``device``, the header
    keeping the copy alive; for a graph of the small class its ``small``
    is the records in a ``_NetTopoSmall`` (else None)."""
    rec = torch.from_numpy(packed.records()).to(device)
    counts = dict(n_main=packed.n_main, n_ro=packed.n_ro, n_rt=packed.n_rt,
                  backlog=packed.backlog)
    tp = _NetTopo(rec=rec.data_ptr(), **counts)
    tp.records = rec
    tp.small = None
    if _small_class(packed.n_main, packed.n_ro, packed.n_rt):
        tp.small = _NetTopoSmall(**counts)
        for name, records, field, _ in _SMALL_FIELDS:
            for k, rec in enumerate(getattr(packed, records)):
                getattr(tp.small, name)[k] = getattr(rec, field)
    return tp


def _topo_args(tp: _NetTopo) -> tuple:
    """The C entry points' first two arguments: the header and, for the
    small class, the small struct (else None)."""
    return ctypes.addressof(tp), None if tp.small is None else ctypes.addressof(tp.small)


def _f32_on(values, device):
    # one spare element keeps the buffer non-empty when every table is empty
    return torch.tensor(list(values) + [0.0], dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def _launch_plan(params: NetInvParams, num_steps: int, device: str,
                 with_demand: bool):
    """A launch's host-built arguments: the topology's header with its
    records on ``device`` (``_topology_on``), the f32 alpha^t table and,
    ``with_demand``, every link's inversion table, the tables copied to
    ``device``. Built once per (params, num_steps, device), so a launch packs
    and copies nothing. K1 takes no demand tables, so its topology may hold
    a ``hostfn`` link."""
    link_specs = (_topology_link_specs(params.topology, num_steps)
                  if with_demand else None)
    packed = _pack_topology(params, link_specs)
    return (_topology_on(packed, device),
            _f32_on(ek._discounts(params.alpha, num_steps), device),
            _f32_on(packed.tables, device))


@functools.lru_cache(maxsize=64)
def _k1_layout(n_main: int, n_ro: int, n_rt: int, ring: int):
    """(``_k1_plan``, its state's ``_NetSmem``, its ``_NetStage``) for a
    graph of those counts."""
    plan = _k1_plan(n_main, n_ro, n_rt, ring)
    return plan, _NetSmem(words=plan.state.words, **plan.state.offsets), plan.struct()


def _arriving_words(ro_L) -> tuple:
    """K25's ring word of each reorder link: its index among the links with
    L > 0, whose one arriving order it holds; -1 for a link with L = 0,
    which delivers the same period's order and has no word."""
    words, k = [], 0
    for L in ro_L:
        words.append(k if L > 0 else -1)
        k += L > 0
    return tuple(words)


@functools.lru_cache(maxsize=16)
def _k25_launch(params: NetInvParams, device: str):
    """K25's host-built arguments for ``params`` on ``device``: the topology's
    header with its records, each link's ``ring`` naming its arriving word
    (``_arriving_words``), the ``_k25_plan``'s ``_NetSmem`` and
    ``_NetStage``, lt and the row counts of the five outputs. It packs
    nothing of the demand, so a ``hostfn`` link is no obstacle."""
    T = params.topology
    words = _arriving_words(T.ro_L)
    plan = _k25_plan(T.n_main, T.n_reorder, T.n_retail, sum(k >= 0 for k in words))
    tp = _topology_on(_pack_topology(params, rings=words), device)
    lt = max(T.lt_max, 1)
    return (tp, _NetSmem(words=plan.state.words, **plan.state.offsets), plan.struct(), lt,
            (T.n_main, T.n_reorder, T.n_retail, lt * T.n_reorder, 1))


def _launch(fn_name, *args, lib_name="net_episode"):
    ek._launch(lib_name, fn_name, *args)


def _check_streams(params, actions, demands):
    T = params.topology
    if actions.dtype != torch.float32 or demands.dtype != torch.float32:
        raise TypeError("actions and demands must be float32")
    if actions.device != demands.device:
        raise ValueError(f"actions on {actions.device}, demands on {demands.device}")
    num_steps, n_ro, B = actions.shape
    if n_ro != T.n_reorder or demands.shape != (num_steps, T.n_retail, B):
        raise ValueError(f"expected actions (T, {T.n_reorder}, B) and demands "
                         f"(T, {T.n_retail}, B); got {tuple(actions.shape)} and "
                         f"{tuple(demands.shape)}")


# ------------------------------------------------------------------ wrappers

def episode_returns(params: NetInvParams, actions: torch.Tensor,
                    demands: torch.Tensor) -> torch.Tensor:
    """Discounted episode returns (B,) for pre-sampled streams ``actions``
    (T, n_reorder, B) and ``demands`` (T, n_retail, B), both float32 on one
    device. K1: on CUDA tensors one thread a lane runs K2's episode body on
    its state in shared memory, each period's words staged ahead of the step
    by asynchronous copies (csrc/net_episode.cu ``k_episode_returns``, laid
    out by ``_k1_plan``); on CPU tensors the plain version runs. On an H100
    (80GB HBM3, 700 W) the kernel alone takes 0.12 ms at 1,024 lanes x 30,
    where a lane's chain of periods sets its time, and 0.25 ms at 65,536
    (the first design, the state in a local-memory frame: 0.15 and 1.04;
    tools/net_k1_k25_sweep.py, PERF.md)."""
    _check_streams(params, actions, demands)
    if actions.device.type == "cpu":
        return _episode_returns_plain(params, actions, demands)
    if actions.device.type != "cuda":
        raise ValueError(f"unsupported device {actions.device}")
    if not (actions.is_contiguous() and demands.is_contiguous()):
        raise ValueError("actions and demands must be contiguous")
    num_steps, _, B = actions.shape
    dev = actions.device
    tp, disc, _ = _launch_plan(params, num_steps, ek._plan_key(dev), False)
    T = params.topology
    _, lay, st = _k1_layout(T.n_main, T.n_reorder, T.n_retail, sum(T.ro_L))
    out = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("net_episode_returns", *_topo_args(tp), ctypes.addressof(lay),
                ctypes.addressof(st), actions.data_ptr(), demands.data_ptr(), disc.data_ptr(),
                out.data_ptr(), B, num_steps, ek._stream(dev))
    episode_returns.launches += 1
    return out


episode_returns.launches = 0


def episode_returns_fully_fused(params: NetInvParams, seed: int, act_hi: float,
                                batch: int, num_steps: int = None,
                                episodes_per_lane: int = 1, device=None):
    """Random-policy episode returns with both streams drawn in the kernel:
    uniform actions on [0, act_hi) and per-link demand by inversion of the
    host CDF tables (``user``/``zero`` links take their per-period values;
    a ``hostfn`` link raises NotImplementedError). K2: one thread per
    (episode, lane), its state in shared memory (csrc/net_episode.cu
    ``k_episode_returns_fused``, laid out by ``_shared_state_plan``); on the
    CPU the plain version runs. Returns (batch,) for episodes_per_lane=1,
    else (episodes_per_lane, batch), episode-major."""
    dev = resolve_device(device)
    E = int(episodes_per_lane)
    if E < 1 or batch < 1:
        raise ValueError(f"need batch >= 1 and episodes_per_lane >= 1, got "
                         f"{batch}, {E}")
    num_steps = params.num_periods if num_steps is None else num_steps
    seed = int(seed) & rng.MASK32
    if dev.type == "cpu":
        out = _episode_returns_fully_fused_plain(params, seed, act_hi, batch,
                                                 num_steps, E, dev)
    else:
        tp, disc, tab = _launch_plan(params, num_steps, ek._plan_key(dev), True)
        plan, layout = _shared_layout(params.topology)
        out = torch.empty((E, batch), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            _launch("net_episode_returns_fused", *_topo_args(tp), ctypes.addressof(layout),
                    plan.threads, disc.data_ptr(), tab.data_ptr(), out.data_ptr(), seed,
                    _act_scale(act_hi), batch, E, num_steps, ek._stream(dev))
        episode_returns_fully_fused.launches += 1
    return out.reshape(batch) if E == 1 else out


episode_returns_fully_fused.launches = 0


def sample_streams_debug(params: NetInvParams, seed: int, act_hi: float,
                         batch: int, num_steps: int = None,
                         episodes_per_lane: int = 1, dump_range=None,
                         device=None):
    """The exact action and demand streams ``episode_returns_fully_fused``
    draws for ``seed``. K3: it shares K2's draw function
    (csrc/net_step.cuh ``draw_period``). Returns (actions (T, n_ro, batch),
    demands (T, n_rt, batch)) for episodes_per_lane=1, else with an E axis
    after T. ``dump_range=(e0, e1)`` writes only those episodes (the E axis
    then has length e1-e0); with a counter-based generator the other
    episodes need not be drawn at all."""
    dev = resolve_device(device)
    T = params.topology
    n_ro, n_rt = T.n_reorder, T.n_retail
    E = int(episodes_per_lane)
    e0, e1 = dump_range if dump_range is not None else (0, E)
    if not 0 <= e0 < e1 <= E or batch < 1:
        raise ValueError(f"need 0 <= e0 < e1 <= E and batch >= 1; got "
                         f"dump_range={(e0, e1)}, E={E}, batch={batch}")
    W = e1 - e0
    num_steps = params.num_periods if num_steps is None else num_steps
    seed = int(seed) & rng.MASK32
    if dev.type == "cpu":
        acts, dems = _sample_streams_plain(params, seed, act_hi, batch,
                                           num_steps, e0, e1, dev)
    else:
        tp, _, tab = _launch_plan(params, num_steps, ek._plan_key(dev), True)
        acts = torch.empty((num_steps, W, n_ro, batch), dtype=torch.float32, device=dev)
        dems = torch.empty((num_steps, W, n_rt, batch), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            _launch("net_sample_streams", *_topo_args(tp), tab.data_ptr(),
                    acts.data_ptr(), dems.data_ptr(), seed, _act_scale(act_hi),
                    batch, num_steps, e0, e1, ek._stream(dev))
        sample_streams_debug.launches += 1
    if E == 1:
        return acts.reshape(num_steps, n_ro, batch), dems.reshape(num_steps, n_rt, batch)
    return acts, dems


sample_streams_debug.launches = 0


def _batched_step_plain(params: NetInvParams, X, Y, U, RH, action, demand, t: int,
                        dtype=torch.float32):
    """Plain version of K25 (``batched_step``): pallas_net_step._kernel_body
    over (B,) rows, the arrival mask t >= L_i and the discount alpha^t (a
    Python double rounded to f32) computed from the host int ``t``. With
    ``dtype=torch.float64`` the float64 oracle of the inputs' float32
    values: (X', Y', U', RH', reward) and a dict of their float32 forward
    bounds under the same keys (RH's kept rows carry no error)."""
    T = params.topology
    lt = max(T.lt_max, 1)
    valid = [1.0 if t >= L else 0.0 for L in T.ro_L]
    out = _step_math(T, params.backlog, list(X), list(Y), list(U), list(RH), list(action),
                     list(demand), valid, dtype)
    Xn, Yn, Un, r_cur, profit = out[:5]
    kept = [r.to(torch.float32).to(dtype) for r in list(RH)[: (lt - 1) * T.n_reorder]]
    RHn = r_cur + kept
    disc = float(np.float32(params.alpha ** t))
    step = (torch.stack(Xn), torch.stack(Yn), torch.stack(Un), torch.stack(RHn), disc * profit)
    if dtype == torch.float32:
        return step
    b = out[5]
    bounds = dict(X=torch.stack(b["X"]), Y=torch.stack(b["Y"]), U=torch.stack(b["U"]),
                  RH=torch.stack(b["r_cur"] + [torch.zeros_like(r) for r in kept]),
                  reward=abs(disc) * (b["profit"] + ek.F32_U * profit.abs()))
    return step + (bounds,)


_K25_INPUTS = ("X", "Y", "U", "RH", "action", "demand")


def batched_step(params: NetInvParams, X: torch.Tensor, Y: torch.Tensor, U: torch.Tensor,
                 RH: torch.Tensor, action: torch.Tensor, demand: torch.Tensor, t: int):
    """One NetInvMgmt period over a transposed lockstep batch. Shapes
    (rows, B), float32, on one device: X (n_main, B), Y (n_reorder, B), U
    (n_retail, B), RH (lt_max * n_reorder, B) newest-first, action
    (n_reorder, B), demand (n_retail, B); ``t`` the period, a host int.
    Returns (X', Y', U', RH', reward (B,)), the reward alpha^t-discounted,
    each a contiguous view of one buffer. K25: one thread a lane steps its
    state in shared memory, copied in with one ring word per link with
    L > 0, while the grid copies RH's rows that RH' shifts down
    (csrc/net_episode.cu ``k_batched_step``, laid out by ``_k25_plan``); on
    CPU tensors the plain version runs. On an H100 (80GB HBM3, 700 W) the
    kernel alone takes 0.050 ms at 65,536 lanes against the first design's
    0.080 (tools/net_k1_k25_sweep.py, PERF.md)."""
    T = params.topology
    n_ro, n_rt = T.n_reorder, T.n_retail
    ins = (X, Y, U, RH, action, demand)
    B, dev = X.shape[-1], X.device
    rows = (T.n_main, n_ro, n_rt, max(T.lt_max, 1) * n_ro, n_ro, n_rt)
    for name, x, n in zip(_K25_INPUTS, ins, rows):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
        if x.shape != (n, B) or x.device != dev:
            raise ValueError(f"expected {name} ({n}, {B}) on {dev}; got "
                             f"{tuple(x.shape)} on {x.device}")
    t = int(t)
    if dev.type == "cpu":
        return _batched_step_plain(params, X, Y, U, RH, action, demand, t)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tp, lay, st, lt, out_rows = _k25_launch(params, ek._plan_key(dev))
    ins = [x.contiguous() for x in ins]
    outs = torch.empty((sum(out_rows), B), dtype=torch.float32, device=dev).split(out_rows)
    with torch.cuda.device(dev):
        # ctypes rounds the double alpha^t to f32 to nearest, as np.float32 does
        _launch("net_batched_step", *_topo_args(tp), ctypes.addressof(lay),
                ctypes.addressof(st), *(x.data_ptr() for x in ins),
                *(x.data_ptr() for x in outs), float(params.alpha ** t), t, lt, B,
                ek._stream(dev))
    batched_step.launches += 1
    return (*outs[:4], outs[4].reshape(B))


batched_step.launches = 0


def rollout_transposed(params: NetInvParams, generator: torch.Generator, batch: int,
                       num_steps: int, action_value: float = None, device=None):
    """Random-action rollout through ``batched_step`` (K25), one launch per
    period; returns the summed reward (a 0-d tensor). Actions are uniform on
    [0, 2 * order_cap_heuristic) from ``generator``, or the constant
    ``action_value``; demand is ``envs.net_inv_management.sample_demand``'s
    (a ``hostfn`` link raises). ``generator`` must live on ``device``."""
    from or_gym_inventory_torch.envs import net_inv_management as net
    dev = resolve_device(device)
    T = params.topology
    hi = float(T.order_cap_heuristic * 2)
    X, Y, U, RH = (x.contiguous() for x in init_transposed(params, batch, dev))
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for t in range(num_steps):
        if action_value is None:
            action = torch.rand((T.n_reorder, batch), generator=generator, device=dev) * hi
        else:
            action = torch.full((T.n_reorder, batch), float(action_value),
                                dtype=torch.float32, device=dev)
        demand = net.sample_demand(params, generator, t, batch, device=dev).T.contiguous()
        X, Y, U, RH, rew = batched_step(params, X, Y, U, RH, action, demand, t)
        total = total + rew.sum()
    return total


def _episode_returns_random_policy_plain(params: NetInvParams, demands, seed: int,
                                         act_hi: float):
    """Plain version of K26: ``_episode_returns_plain`` on the actions of
    K2's action words of episode 0 (key (seed, 0), the period's first n_ro
    words) and the given demand."""
    num_steps, _, B = demands.shape
    n_ro = params.topology.n_reorder
    lanes = torch.arange(B, dtype=torch.int64, device=demands.device)
    scale = _act_scale(act_hi)
    acts = torch.stack([
        torch.stack([(w >> 8).to(torch.float32) * scale
                     for w in rng.period_words(seed, lanes, 0, t, n_ro)])
        for t in range(num_steps)])
    return _episode_returns_plain(params, acts, demands)


def episode_returns_random_policy(params: NetInvParams, demands: torch.Tensor, seed,
                                  act_hi: float) -> torch.Tensor:
    """Discounted episode returns (B,) under the uniform-random policy, the
    actions on [0, act_hi) drawn in the kernel and the demand ``demands``
    (T, n_retail, B) float32 streamed in. The actions are
    ``episode_returns_fully_fused``'s action words of episode 0, so on
    ``sample_streams_debug``'s demand for the same seed it gives the fused
    kernel's returns. K26: K2's kernel body on one thread per lane, the
    demand read instead of drawn (csrc/net_episode.cu
    ``k_episode_returns_random``); on CPU tensors the plain version runs."""
    T = params.topology
    if demands.dtype != torch.float32:
        raise TypeError("demands must be float32")
    if demands.ndim != 3 or demands.shape[1] != T.n_retail:
        raise ValueError(f"expected demands (T, {T.n_retail}, B); got {tuple(demands.shape)}")
    seed = int(seed) & rng.MASK32
    if demands.device.type == "cpu":
        return _episode_returns_random_policy_plain(params, demands, seed, act_hi)
    if demands.device.type != "cuda":
        raise ValueError(f"unsupported device {demands.device}")
    if not demands.is_contiguous():
        raise ValueError("demands must be contiguous")
    num_steps, _, B = demands.shape
    dev = demands.device
    tp, disc, _ = _launch_plan(params, num_steps, ek._plan_key(dev), False)
    plan, layout = _shared_layout(params.topology)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("net_episode_returns_random", *_topo_args(tp), ctypes.addressof(layout),
                plan.threads, demands.data_ptr(), disc.data_ptr(), out.data_ptr(), seed,
                _act_scale(act_hi), B, num_steps, ek._stream(dev))
    episode_returns_random_policy.launches += 1
    return out


episode_returns_random_policy.launches = 0


# ============================================ policy kernels K4-K6 (net_policy.cu)

def _net_obs_rows(T, X, U, RH):
    """The observation as a list of (B,) rows (pallas_net_step._net_obs_rows):
    U per retail link, X per main node, then each reorder link's
    chronological order window R[t-L..t-1], read oldest first from the
    newest-first rows ``RH``; rows before period 0 are RH's zero rows."""
    rows = list(U) + list(X)
    n_ro = T.n_reorder
    for i, L in enumerate(T.ro_L):
        for j in range(L):
            rows.append(RH[(L - 1 - j) * n_ro + i])
    return rows


def _half_hi(T) -> float:
    """f32(0.5 * act_hi) with act_hi = 2 * order_cap_heuristic, the factor of
    ``act = (tanh(raw) + 1) * (0.5 * act_hi)`` (pallas_net_step.py:537)."""
    return float(np.float32(0.5 * float(T.order_cap_heuristic * 2)))


def _pack_net_tile_actor(T, actor, std, device, general: bool = False):
    """``episode_kernels._pack_tile_actor`` for the topology (K4-K6): the
    tile's transient rows hold a demand row per retail link and the step's
    per-node scratch, each lane keeps the state of ``_shared_layout(T,
    scratch=False)``, and the block the topology's records; MlpTileG where
    ``general``."""
    state = _shared_layout(T, False)[0]
    return ek._pack_tile_actor(actor, std, T.obs_dim, T.n_reorder,
                               [_half_hi(T)] * T.n_reorder, device, dem_rows=T.n_retail,
                               scratch_rows=3 * T.n_main, state_words=state.words,
                               topo_floats=state.topo_floats, general=general)


def _policy_period_plain(T, plan, layers, std, seed, lanes, episodes, t, X, U, RH,
                         policy="ppo", act_name="tanh"):
    """Demand, stored values and actions of one period of the policy
    kernels (csrc/net_policy.cu ``policy_period``, and K29's period), each a
    list of rows: the n_rt demand words first, then the head's words
    (``episode_kernels._head_words``: the n_ro u1 and n_ro u2 words, the
    n_ro u1 alone for "uniform", none for the deterministic PPO head);
    act = (a_norm + 1) * f32(0.5 act_hi)."""
    n_ro, n_rt = T.n_reorder, T.n_retail
    n_head = ek._head_words(policy, n_ro, std is not None)
    words = rng.period_words(seed, lanes, episodes, t, n_rt + n_head, key1=rng.POLICY_KEY)
    dem = _link_demand_plain(plan, words[:n_rt], t)
    obs_rows = _net_obs_rows(T, X, U, RH)
    if not n_head:
        raw = ek.mlp_forward(layers, "tanh", obs_rows)
        a_norm = torch.tanh(raw)
    else:
        raw, a_norm = ek.traj_policy(policy, act_name, n_ro, layers, std, obs_rows,
                                     ek._head_noise(policy, words[n_rt:]))
    act = (a_norm + 1.0) * _half_hi(T)
    return dem, raw, act


def _rollout_traj_plain(params, actor, std, seed, batch, device, policy="ppo",
                        act_name="tanh"):
    """Plain version of K4 (and, with another head or trunk, of K29): the
    streams of one stochastic-policy episode per lane, as
    ``rollout_traj_net`` returns them."""
    T = params.topology
    n_main, n_ro, n_rt = T.n_main, T.n_reorder, T.n_retail
    lt = max(T.lt_max, 1)
    num_steps = params.num_periods
    plan = _device_link_plan(_topology_link_specs(T, num_steps), device)
    layers = ek.kernel_layers(actor, device)
    std = None if std is None else std.to(device)
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    discs = ek._discounts(params.alpha, num_steps)
    f32 = dict(dtype=torch.float32, device=device)
    out = dict(x=torch.empty((num_steps + 1, n_main, batch), **f32),
               u=torch.empty((num_steps + 1, n_rt, batch), **f32),
               r=torch.empty((num_steps, n_ro, batch), **f32),
               raw=torch.empty((num_steps, n_ro, batch), **f32),
               reward=torch.empty((num_steps, batch), **f32),
               demand=torch.empty((num_steps, n_rt, batch), **f32))
    X, Y, U, RH = (list(a) for a in init_transposed(params, batch, device))
    for t in range(num_steps):
        out["x"][t], out["u"][t] = torch.stack(X), torch.stack(U)
        dem, raw, act = _policy_period_plain(T, plan, layers, std, seed, lanes, 0,
                                             t, X, U, RH, policy, act_name)
        valid = [1.0 if t >= L else 0.0 for L in T.ro_L]
        X, Y, U, r_cur, profit = _step_math(T, params.backlog, X, Y, U, RH,
                                            list(act), dem, valid)
        RH = r_cur + RH[: (lt - 1) * n_ro]
        out["r"][t], out["raw"][t] = torch.stack(r_cur), raw
        out["reward"][t] = discs[t] * profit
        out["demand"][t] = torch.stack(dem)
    out["x"][num_steps], out["u"][num_steps] = torch.stack(X), torch.stack(U)
    return out


def _policy_returns_plain(params, actor, std, seed, batch, episodes_per_lane,
                          device, dump=False):
    """Plain version of K5 (and, with ``dump``, K6): returns (E, B), and the
    actions (T, E, n_ro, B) and demand (T, E, n_rt, B) they came from. All
    E * B episodes run at once, episode-major, each with its own counter."""
    T = params.topology
    n_ro, n_rt = T.n_reorder, T.n_retail
    lt = max(T.lt_max, 1)
    num_steps, E = params.num_periods, episodes_per_lane
    plan = _device_link_plan(_topology_link_specs(T, num_steps), device)
    layers = ek.kernel_layers(actor, device)
    std = None if std is None else std.to(device)
    idx = torch.arange(E * batch, dtype=torch.int64, device=device)
    episodes, lanes = idx // batch, idx % batch
    discs = ek._discounts(params.alpha, num_steps)
    f32 = dict(dtype=torch.float32, device=device)
    acts = torch.empty((num_steps, E, n_ro, batch), **f32) if dump else None
    dems = torch.empty((num_steps, E, n_rt, batch), **f32) if dump else None
    X, Y, U, RH = (list(a) for a in init_transposed(params, E * batch, device))
    total = torch.zeros(E * batch, **f32)
    for t in range(num_steps):
        dem, _raw, act = _policy_period_plain(T, plan, layers, std, seed, lanes,
                                              episodes, t, X, U, RH)
        if dump:
            acts[t] = act.reshape(n_ro, E, batch).transpose(0, 1)
            dems[t] = torch.stack(dem).reshape(n_rt, E, batch).transpose(0, 1)
        valid = [1.0 if t >= L else 0.0 for L in T.ro_L]
        X, Y, U, r_cur, profit = _step_math(T, params.backlog, X, Y, U, RH,
                                            list(act), dem, valid)
        RH = r_cur + RH[: (lt - 1) * n_ro]
        total = total + discs[t] * profit
    return total.reshape(E, batch), acts, dems


def rollout_traj_net(params: NetInvParams, actor, log_std, seed, batch: int,
                     policy: str = "ppo", act_name: str = "tanh", device=None):
    """One full stochastic-policy episode per lane with the training streams
    written out. ``actor`` is ``(Ws, bs)`` from
    ``episode_kernels.fold_actor_params``; ``log_std`` the policy's log-std,
    clipped through ``clipped_std``. Returns a dict of float32 tensors:
    ``x (T+1, n_main, batch)`` and ``u (T+1, n_rt, batch)`` start-of-period
    node inventories and retail backlogs (the final snapshots last),
    ``r (T, n_ro, batch)`` fulfilled orders, ``raw (T, n_ro, batch)``
    pre-squash Gaussian samples, ``reward (T, batch)`` (alpha^t-discounted)
    and ``demand (T, n_rt, batch)``. K4: K5's tile with one stochastic
    episode a lane and the streams written, the actor on the tensor cores
    and the state in shared memory (csrc/net_policy.cu
    ``k_policy_returns<1, 0, 1>`` on csrc/mlp_tile.cuh); on the CPU the
    plain version runs. ``policy``/``act_name`` select the head and the trunk
    (``episode_kernels.traj_policy``): the default ("ppo", "tanh") is K4's;
    any other pair is ``rollout_traj_net_offpolicy``'s (K29), whose ``raw``
    holds the normalised [-1, 1] actions. A ``hostfn`` demand link raises
    NotImplementedError."""
    ek._check_head(policy, act_name)
    if (policy, act_name) != ("ppo", "tanh"):
        return rollout_traj_net_offpolicy(params, actor, log_std, seed, batch, policy,
                                          act_name, device)
    dev = resolve_device(device)
    if batch < 1:
        raise ValueError(f"need batch >= 1, got {batch}")
    T = params.topology
    n_main, n_ro, n_rt = T.n_main, T.n_reorder, T.n_retail
    num_steps = params.num_periods
    seed = int(seed) & rng.MASK32
    std = ek.clipped_std(torch.as_tensor(log_std).detach())
    if dev.type == "cpu":
        ek._actor_dims(actor, T.obs_dim, n_ro)
        return _rollout_traj_plain(params, actor, std, seed, batch, dev)
    st, flat = _pack_net_tile_actor(T, actor, std, dev)
    tp, disc, tab = _launch_plan(params, num_steps, ek._plan_key(dev), True)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(x=torch.empty((num_steps + 1, n_main, batch), **f32),
               u=torch.empty((num_steps + 1, n_rt, batch), **f32),
               r=torch.empty((num_steps, n_ro, batch), **f32),
               raw=torch.empty((num_steps, n_ro, batch), **f32),
               reward=torch.empty((num_steps, batch), **f32),
               demand=torch.empty((num_steps, n_rt, batch), **f32))
    with torch.cuda.device(dev):
        _launch("net_rollout_traj" + ek._tile_launch(st, batch, dev), *_topo_args(tp),
                ctypes.addressof(_shared_layout(T, False)[1]), ctypes.addressof(st),
                flat.data_ptr(), tab.data_ptr(), disc.data_ptr(),
                *(out[k].data_ptr() for k in ("x", "u", "r", "raw", "reward", "demand")),
                seed, batch, num_steps, ek._stream(dev), lib_name="net_policy")
    rollout_traj_net.launches += 1
    return out


rollout_traj_net.launches = 0


# K29's cluster walks a batch's tiles a round at a time (tiles over the
# clusters the card holds at once), one tile's chain a round, while the first
# design's blocks overlap on the card: on an H100 (30 clusters of 4 CTAs over
# 64 lanes) the cluster led it up to 8 rounds (15,360 lanes, 7.24 against
# 7.73 ms) and trailed from 16 (30,720 lanes, 14.47 against 11.70; 65,536
# lanes, 35 rounds, 31.44 against 23.18: tools/net_traj_sweep.py, PERF.md).
# So a batch of more rounds takes the wide route.
_NET_CLUSTER_MAX_ROUNDS = 8


def _net_route(batch: int, lanes: int, clusters_held: int) -> str:
    """K29's route for ``batch`` lanes on tiles of ``lanes`` when the card
    holds ``clusters_held`` clusters at once: "cluster" while the rounds
    (tiles over clusters, rounded up) are at most
    ``_NET_CLUSTER_MAX_ROUNDS``, else "wide"."""
    tiles = -(-batch // lanes)
    rounds = -(-tiles // max(clusters_held, 1))
    return "cluster" if rounds <= _NET_CLUSTER_MAX_ROUNDS else "wide"


def _net_cluster_layout(T) -> ek.ClusterLayout:
    """K29's cluster layout (``episode_kernels.ClusterLayout``): a demand
    a retail link, the topology's records after the regions, and the room
    that lets 4 CTAs hold 64 lanes of the (68, 256, 256, 11) actor: no
    padding (its FP32 products' loads are conflict-free without it), the
    output layer's sums in x0, a period's noise."""
    return ek.ClusterLayout(dem_rows=T.n_retail, pad=0, out_in_x0=True, noise_per_period=True,
                            topo_floats=_topo_floats(T.n_main, T.n_reorder, T.n_retail))


def _net_wide_extra(T) -> int:
    """Floats of K29's wide block beside its activations: each of its 32
    lanes' state (``_shared_layout`` with the scratch) and demand rows, then
    the records (csrc/net_policy.cu net_rollout_traj_wide); the general
    class adds its head noise's rows (``ek._pack_wide_actor``'s
    ``noise_rows``)."""
    state = _shared_layout(T)[0]
    return (state.words + T.n_retail) * ek._WIDE_LANES + state.topo_floats


def _net_wide_bytes(T, wide) -> None:
    """Check that a block of K29's wide route fits the shared memory of a
    block: the activation buffers of ``wide`` (WideMlp's two of ``rows``,
    WideMlpG's of rows0 and rows1, none in the workspace, and its noise
    rows), then ``_net_wide_extra``. Raises ValueError past it."""
    state = _shared_layout(T)[0]
    lanes = ek._WIDE_LANES
    if isinstance(wide, ek._WideMlpG):
        acts = (0 if wide.ws_floats else wide.rows0 + wide.rows1) + wide.act
    else:
        acts = 2 * wide.rows
    nbytes = 4 * (acts * lanes + _net_wide_extra(T))
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(
            f"graph too large for K29's wide route: its activations, {state.words} words of "
            f"state and {T.n_retail} demand rows a lane over {lanes} lanes and the "
            f"topology's {state.topo_floats} floats need {nbytes} bytes; the shared memory of "
            f"a block holds {SMEM_PER_BLOCK}")


def rollout_traj_net_offpolicy(params: NetInvParams, actor, log_std, seed, batch: int,
                               policy: str = "det", act_name: str = "relu", device=None):
    """``rollout_traj_net`` under the off-policy heads (see
    ``episode_kernels.rollout_traj_im_offpolicy``): one episode per lane of
    the folded actor (``episode_kernels.fold_offpolicy_actor``) with the
    head ``policy`` on an ``act_name`` trunk. Returns ``rollout_traj_net``'s
    dict, ``raw (T, n_ro, batch)`` holding the normalised [-1, 1] actions
    (the pre-squash samples for "ppo"). The stream is K4's: per period the
    n_rt demand words, then the head's, so its demand is K4's for the same
    seed. K29 on the card: a thread-block cluster a tile of lanes
    (csrc/net_policy.cu ``k_rollout_traj_cluster`` on csrc/cluster_mlp.cuh),
    the actor's slices in the CTAs' shared memory and the lanes' state
    beside them, for any actor a cluster tile holds
    (``episode_kernels._cluster_choice``); a wider one takes the wide
    route, a block per 32 lanes with the weights streamed from L2
    (``k_rollout_traj_wide`` on csrc/wide_mlp.cuh), chosen from the sizes
    before the launch, and so does a batch of more than
    ``_NET_CLUSTER_MAX_ROUNDS`` rounds of the card's clusters
    (``_net_route``); ``.route`` names the last launch's. Either launch that
    fails raises. On the CPU the plain version runs. A ``hostfn``
    demand link raises NotImplementedError."""
    ek._check_head(policy, act_name)
    dev = resolve_device(device)
    if batch < 1:
        raise ValueError(f"need batch >= 1, got {batch}")
    T = params.topology
    n_main, n_ro, n_rt = T.n_main, T.n_reorder, T.n_retail
    num_steps = params.num_periods
    seed = int(seed) & rng.MASK32
    std = ek._offpolicy_std(policy, log_std)
    if dev.type == "cpu":
        ek._head_dims(actor, T.obs_dim, n_ro, policy)
        return _rollout_traj_plain(params, actor, std, seed, batch, dev, policy, act_name)
    relu = int(act_name == "relu")
    half_hi = [_half_hi(T)] * n_ro
    layout, lay = _shared_layout(T)
    packed = ek._pack_cluster_actor(actor, std, T.obs_dim, n_ro, policy, half_hi, num_steps,
                                    layout.words, False, dev, _net_cluster_layout(T))
    tp, disc, tab = _launch_plan(params, num_steps, ek._plan_key(dev), True)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(x=torch.empty((num_steps + 1, n_main, batch), **f32),
               u=torch.empty((num_steps + 1, n_rt, batch), **f32),
               r=torch.empty((num_steps, n_ro, batch), **f32),
               raw=torch.empty((num_steps, n_ro, batch), **f32),
               reward=torch.empty((num_steps, batch), **f32),
               demand=torch.empty((num_steps, n_rt, batch), **f32))
    streams = tuple(out[k].data_ptr() for k in ("x", "u", "r", "raw", "reward", "demand"))
    with torch.cuda.device(dev):
        route = "wide"   # no cluster tile holds the actor, or the batch is too deep
        if packed is not None:
            st, flat = packed
            held = ek._cluster_max_active("net_policy", "net_rollout_traj_cluster_occupancy",
                                          st.cluster, st.floats, (relu, int(tp.small is not None)),
                                          ek._plan_key(dev))
            route = _net_route(batch, st.lanes, held)
        if route == "cluster":
            st.clusters = ek._cluster_grid(-(-batch // st.lanes), held)
            _launch("net_rollout_traj_cluster", *_topo_args(tp), ctypes.addressof(lay),
                    ctypes.addressof(st), flat.data_ptr(), tab.data_ptr(), disc.data_ptr(),
                    *streams, seed, relu, batch, num_steps, ek._stream(dev),
                    lib_name="net_policy")
        else:
            st, flat = ek._pack_wide_actor(actor, std, T.obs_dim, n_ro, policy, half_hi, dev,
                                           _net_wide_extra(T), noise_rows=True)
            _net_wide_bytes(T, st)
            _launch("net_rollout_traj_wide" + ek._wide_launch(st, batch, dev), *_topo_args(tp),
                    ctypes.addressof(lay),
                    ctypes.addressof(st), flat.data_ptr(), tab.data_ptr(), disc.data_ptr(),
                    *streams, seed, relu, batch, num_steps, ek._stream(dev),
                    lib_name="net_policy")
    rollout_traj_net_offpolicy.launches += 1
    rollout_traj_net_offpolicy.route = route
    return out


rollout_traj_net_offpolicy.launches = 0
rollout_traj_net_offpolicy.route = None   # the last launch's: "cluster" or "wide"


def _policy_call(wrapper, params, actor, seed, batch, episodes_per_lane, log_std,
                 dump, device):
    """K5 (``dump`` False) or K6 for ``wrapper``: (returns (E, B), actions,
    demands), the streams None without ``dump``."""
    dev = resolve_device(device)
    E = int(episodes_per_lane)
    if E < 1 or batch < 1:
        raise ValueError(f"need batch >= 1 and episodes_per_lane >= 1, got "
                         f"{batch}, {E}")
    T = params.topology
    num_steps = params.num_periods
    seed = int(seed) & rng.MASK32
    std = None if log_std is None else ek.clipped_std(log_std)
    if dev.type == "cpu":
        ek._actor_dims(actor, T.obs_dim, T.n_reorder)
        return _policy_returns_plain(params, actor, std, seed, batch, E, dev, dump)
    st, flat = _pack_net_tile_actor(T, actor, std, dev)
    tp, disc, tab = _launch_plan(params, num_steps, ek._plan_key(dev), True)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((E, batch), **f32)
    acts = dems = None
    if dump:
        acts = torch.empty((num_steps, E, T.n_reorder, batch), **f32)
        dems = torch.empty((num_steps, E, T.n_retail, batch), **f32)
    with torch.cuda.device(dev):
        _launch("net_policy_returns" + ek._tile_launch(st, E * batch, dev), *_topo_args(tp),
                ctypes.addressof(_shared_layout(T, False)[1]), ctypes.addressof(st),
                flat.data_ptr(), tab.data_ptr(), disc.data_ptr(),
                out.data_ptr(), acts.data_ptr() if dump else None,
                dems.data_ptr() if dump else None, seed, batch, E, num_steps,
                int(std is not None), ek._stream(dev), lib_name="net_policy")
    wrapper.launches += 1
    return out, acts, dems


def episode_returns_net_policy(params: NetInvParams, actor, seed, batch: int,
                               episodes_per_lane: int = 1, log_std=None,
                               device=None):
    """Episode returns under a folded MLP actor (``episode_kernels.
    fold_actor_params``), the policy run inside the kernel on the live state.
    Deterministic by default; with the trained ``log_std`` the actions are
    tanh-squashed Gaussian samples around the mean. Demand is drawn from the
    links' CDF tables (a ``hostfn`` link raises NotImplementedError). K5: a
    block per tile of (episode, lane) pairs, one thread each, the actor on
    the tensor cores and the state in shared memory (csrc/net_policy.cu
    ``k_policy_returns`` on csrc/mlp_tile.cuh); on the CPU the plain
    version runs. Returns (batch,) for episodes_per_lane=1, else
    (episodes_per_lane, batch)."""
    out, _, _ = _policy_call(episode_returns_net_policy, params, actor, seed,
                             batch, episodes_per_lane, log_std, False, device)
    return out.reshape(batch) if episodes_per_lane == 1 else out


episode_returns_net_policy.launches = 0


def sample_policy_streams_debug_net(params: NetInvParams, actor, seed, batch: int,
                                    episodes_per_lane: int = 1, log_std=None,
                                    device=None):
    """(returns, actions (T, E, n_ro, batch), demands (T, E, n_rt, batch)):
    ``episode_returns_net_policy`` with the squashed actions and the demand
    it used written out. K6: the same kernel with its dump switched on, so
    the streams are exactly the ones K5 consumes for the same seed. Returns
    are (batch,) for episodes_per_lane=1, else (E, batch)."""
    out, acts, dems = _policy_call(sample_policy_streams_debug_net, params, actor,
                                   seed, batch, episodes_per_lane, log_std, True,
                                   device)
    return (out.reshape(batch) if episodes_per_lane == 1 else out), acts, dems


sample_policy_streams_debug_net.launches = 0
