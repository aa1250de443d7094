"""InvManagement whole-episode kernels, the folded actor of the policy
kernels, and the plain versions of the in-kernel helpers.

Port of ``or_gym_inventory_tpu/ops/pallas_episode_kernels.py``: the
InvManagement kernels (``csrc/im_episode.cu``, ``csrc/im_policy.cu``) with
their plain PyTorch versions, and what every policy kernel shares:

- ``clipped_std``, ``fold_actor_params`` (the obs RunningMeanStd folded into
  layer 1), ``folded_actor_mean`` and ``apply_folded_actor``, on host;
- ``_pack_actor``, the actor as the CUDA kernels take it (``csrc/mlp.cuh``),
  shared by the NetInvMgmt policy kernels (``ops/net_step.py``) and K10;
- the plain versions of the in-kernel helpers ``mlp_forward``,
  ``traj_policy`` (mode ``"ppo"``), ``_im_step_math`` and ``_im_obs_rows``.
  Those of ``_uniform01`` and ``_normal01`` are ``ops.rng.uniform01`` and
  ``normal01``, which turn Philox words into the kernels' draws where the
  TPU drew from its own generator.

| wrapper                      | replaces (pallas_episode_kernels.py)   |
| ``episode_returns_im``       | ``episode_returns_im`` :802 (K7)       |
| ``episode_returns_im_random`` | ``episode_returns_im_random`` :815 (K7) |
| ``episode_returns_im_fused`` | ``episode_returns_im_fused`` :919 (K8) |
| ``sample_streams_debug_im``  | ``sample_streams_debug_im`` :1873 (K9) |
| ``rollout_traj_im``          | ``rollout_traj_im`` :1683 (K10)        |

Each wrapper runs the plain version for CPU tensors; on CUDA it launches its
kernel and raises if the launch fails; nothing falls back. It counts its
launches in ``<wrapper>.launches``. Layout follows the JAX package, the
batch last; InvManagement streams are int32. The random streams are
Philox4x32-10 words (``ops/rng.py``): the random policy's under key
(seed, 0), m1 action words then one demand word per period; K10's under
(seed, 1), one demand word, then m1 u1 and m1 u2 words.

An actor is ``(Ws, bs)``: Ws[l] (in, out), bs[l] (out,), float32, as the JAX
package has it. The plain versions compute with the layers as (out, in), as
the Pallas kernels did (``kernel_layers``); the CUDA kernels take them as
(in, out) with the outputs padded to 16 (``_pack_actor``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from or_gym_inventory_torch.agents import networks
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.ops import distributions as dist
from or_gym_inventory_torch.ops import rng

# maxima of the actor the policy kernels take (csrc/mlp.cuh); its weights,
# biases and std must fit the dynamic shared memory a Hopper block may opt
# in to (227 KB)
MAX_LAYERS, MAX_WIDTH, MAX_ACT = 8, 256, 32
SMEM_OPTIN_BYTES = 232_448
# and of the InvManagement params struct (csrc/im_step.cuh)
IM_MAX_M1, IM_MAX_LT = 8, 32


def _refuse_mode(what: str):
    raise NotImplementedError(
        f"{what}: the port's policy kernels run the PPO head with a tanh trunk; "
        "the off-policy heads (det, sac, uniform) and relu trunks come with "
        "the off-policy learners (ROADMAP.md A9)")


def clipped_std(log_std) -> torch.Tensor:
    """``exp(clip(log_std, -10, 2))`` shaped (act_dim, 1), the std the
    stochastic policy kernels take: networks.gaussian_sample's clip range,
    kept in this one place on the kernel side."""
    ls = torch.as_tensor(log_std, dtype=torch.float32)
    return torch.exp(torch.clamp(ls, -10.0, 2.0)).reshape(-1, 1)


def fold_actor_params(cfg, model, rms=None):
    """The deterministic actor of a PPO/A2C model as plain (Ws, bs) float32
    tensors, with the obs normalisation folded into the first layer:
    norm = (x - mu) / sqrt(var + 1e-8), so W1' = W1 * invstd[:, None] and
    b1' = b1 - (mu * invstd) @ W1. The layers are the pi trunk (tanh after
    each) and the mean head. ``model`` is an ``MLPActorCritic``."""
    if getattr(cfg, "activation", "tanh") != "tanh":
        _refuse_mode(f"activation={cfg.activation!r}")
    layers = list(model.pi) + [model.mean]
    Ws = [layer.weight.detach().to(torch.float32).T.clone() for layer in layers]
    bs = [layer.bias.detach().to(torch.float32).clone() for layer in layers]
    if rms is not None and getattr(cfg, "normalize_obs", True):
        invstd = 1.0 / torch.sqrt(rms.var.to(torch.float32) + 1e-8)
        mu = rms.mean.to(torch.float32)
        bs[0] = bs[0] - (mu * invstd) @ Ws[0]
        Ws[0] = Ws[0] * invstd[:, None]
    return tuple(Ws), tuple(bs)


def folded_actor_mean(actor, obs: torch.Tensor) -> torch.Tensor:
    """Pre-squash mean of a folded actor: tanh trunk, linear head.
    ``obs`` (B, obs_dim); returns (B, act_dim) float32."""
    Ws, bs = actor
    H = obs.to(torch.float32)
    for i, (W, b) in enumerate(zip(Ws, bs)):
        H = H @ W + b
        if i < len(Ws) - 1:
            H = torch.tanh(H)
    return H


def apply_folded_actor(actor, obs, low, high, int_actions: bool):
    """The folded actor's deterministic action: ``folded_actor_mean``, then
    networks.squash_action and, for integer actions, a cast toward zero.
    ``obs`` (B, obs_dim); returns (B, act_dim)."""
    a = networks.squash_action(folded_actor_mean(actor, obs), low, high)
    return a.to(torch.int32) if int_actions else a


def kernel_layers(actor, device):
    """The actor as the plain versions of the kernels use it:
    [(W (out, in), b (out, 1))] float32 on ``device``."""
    Ws, bs = actor
    return [(torch.as_tensor(W, dtype=torch.float32, device=device).T.contiguous(),
             torch.as_tensor(b, dtype=torch.float32, device=device).reshape(-1, 1))
            for W, b in zip(Ws, bs)]


def mlp_forward(layers, act_name: str, obs_rows) -> torch.Tensor:
    """Plain version of the in-kernel trunk and head: the obs rows, each (B,),
    stacked to (obs_dim, B), then W @ H + b per layer of ``kernel_layers``
    with ``act_name`` after every layer but the last. Returns (act_dim, B)."""
    if act_name != "tanh":
        _refuse_mode(f"act_name={act_name!r}")
    H = torch.stack([r.to(torch.float32) for r in obs_rows])
    for i, (W, b) in enumerate(layers):
        H = W @ H + b
        if i < len(layers) - 1:
            H = torch.tanh(H)
    return H


def traj_policy(mode: str, act_name: str, act_dim: int, layers, std, obs_rows,
                z: torch.Tensor):
    """Plain version of the trajectory kernels' policy head, mode ``"ppo"``:
    the pre-squash Gaussian ``raw = H + std * z`` on the trunk's mean, with
    ``z`` (act_dim, B) the period's standard normals. Returns (store, a_norm):
    the raw sample the kernel writes out, and tanh(raw) in [-1, 1]."""
    if mode != "ppo":
        _refuse_mode(f"policy={mode!r}")
    H = mlp_forward(layers, act_name, obs_rows)
    if H.shape[0] != act_dim:
        raise ValueError(f"the actor has {H.shape[0]} outputs, expected {act_dim}")
    raw = H + std * z
    return raw, torch.tanh(raw)


# ------------------------------------------------------- launch helpers

def _discounts(alpha: float, num_steps: int):
    """alpha**t per period as a Python double rounded to f32, as the JAX
    kernels fold it (pallas_net_step.py:165, pallas_episode_kernels.py:775)."""
    return [float(np.float32(alpha ** t)) for t in range(num_steps)]


def _launch(lib_name: str, fn_name: str, *args):
    """Call the C entry point ``fn_name`` of ``csrc/<lib_name>.cu``; raise
    with CUDA's message if it returns an error."""
    from or_gym_inventory_torch.ops import _build
    lib = _build.library(lib_name)
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}: {_build.error_string(lib_name, rc)}")


def _plan_key(device) -> str:
    """``device`` with its index, so that a plan cached for "cuda" stays on
    the card it was copied to."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return f"cuda:{index}"


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------- the packed actor

class _Mlp(ctypes.Structure):
    """Mirror of ``struct Mlp`` in csrc/mlp.cuh."""
    _fields_ = [("n_layers", ctypes.c_int), ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
                ("act_rows", ctypes.c_int), ("half_hi", ctypes.c_float * MAX_ACT)]


_POLICY_THREADS = 128   # kThreads of csrc/launch.cuh: activation columns


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _actor_dims(actor, obs_dim: int, act_dim: int):
    """The actor's widths [obs_dim, ..., act_dim]; raises ValueError for an
    actor that does not fit the env or the kernels' maxima."""
    Ws, bs = actor
    if len(Ws) != len(bs) or not Ws:
        raise ValueError("actor must be (Ws, bs) with one bias per layer")
    dims = [int(Ws[0].shape[0])] + [int(W.shape[1]) for W in Ws]
    for layer, (W, b) in enumerate(zip(Ws, bs)):
        if tuple(W.shape) != (dims[layer], dims[layer + 1]) or tuple(b.shape) != (dims[layer + 1],):
            raise ValueError(f"layer {layer}: W {tuple(W.shape)} and b {tuple(b.shape)} "
                             f"do not chain to widths {dims}")
    if dims[0] != obs_dim or dims[-1] != act_dim:
        raise ValueError(f"actor maps {dims[0]} -> {dims[-1]}; the env needs "
                         f"obs_dim {obs_dim} -> act_dim {act_dim}")
    if len(Ws) > MAX_LAYERS or max(dims) > MAX_WIDTH or act_dim > MAX_ACT:
        raise ValueError(f"actor widths {dims}: the kernels take at most "
                         f"{MAX_LAYERS} layers of width <= {MAX_WIDTH} and "
                         f"{MAX_ACT} actions")
    return dims


def _pack_actor(actor, std, obs_dim: int, act_dim: int, half_hi, device):
    """The kernels' actor arguments: the Mlp struct (``half_hi[i]`` the f32
    factor that maps tanh(raw_i) + 1 onto action i's range) and one flat
    float32 buffer on ``device``, each layer as W^T (in, out16) then b
    (out16), the outputs zero-padded to a multiple of 16, then the std when
    given. Raises ValueError if the buffer and the activation buffers exceed
    the shared memory of a block."""
    dims = _actor_dims(actor, obs_dim, act_dim)
    Ws, bs = actor
    parts = []
    for W, b in zip(Ws, bs):
        n_in, n_out = W.shape
        Wp = torch.zeros((n_in, _pad16(n_out)), dtype=torch.float32, device=device)
        bp = torch.zeros(_pad16(n_out), dtype=torch.float32, device=device)
        Wp[:, :n_out] = torch.as_tensor(W, dtype=torch.float32, device=device)
        bp[:n_out] = torch.as_tensor(b, dtype=torch.float32, device=device)
        parts += [Wp.reshape(-1), bp]
    if std is not None:
        parts.append(std.to(device).reshape(-1))
    flat = torch.cat(parts).contiguous()
    act_rows = max([dims[0]] + [_pad16(d) for d in dims[1:]])
    smem = (-(-flat.numel() // 4) * 4 + 2 * act_rows * _POLICY_THREADS) * 4
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"actor of {flat.numel()} floats with activation buffers of "
                         f"{act_rows} rows needs {smem} bytes; the shared memory of "
                         f"a block holds {SMEM_OPTIN_BYTES}")
    mlp = _Mlp(n_layers=len(dims) - 1, act_rows=act_rows)
    for k, d in enumerate(dims):
        mlp.dims[k] = d
    for i, h in enumerate(half_hi):
        mlp.half_hi[i] = h
    return mlp, flat


# ============================================ InvManagement kernels K7-K10

def _im_step_math(params: im.InvManagementParams, t: int, inv, bkl, RH, act, d):
    """One InvManagement period over lists of (B,) int32 tensors
    (pallas_episode_kernels._im_step_math), event order per
    inventory_management.py:224-352. ``RH`` is a newest-first list of
    lt_max * m1 fulfilled-order rows; ``t`` is a Python int. Returns (inv',
    backlog', RH', requested orders, undiscounted f32 profit)."""
    m1, c, L = params.m1, params.c, params.L

    # 0) orders: request = action + prior backlog of stages 1..m; caps
    r_req = [torch.clamp_min(a, 0) for a in act]
    order_req = [r_req[i] + bkl[i + 1] for i in range(m1)]
    r_ful = []
    for i in range(m1):
        capped = torch.clamp_max(order_req[i], c[i])
        # the last stage's supplier: unlimited raw material, 1 << 30
        r_ful.append(torch.minimum(capped, inv[i + 1]) if i + 1 < m1
                     else torch.clamp_max(capped, 1 << 30))

    # 1) arrivals ordered L_i periods ago
    inv_cur = list(inv)
    for i, li in enumerate(L):
        if li == 0:
            due = r_ful[i]
        elif t >= li:
            due = RH[(li - 1) * m1 + i]
        else:
            due = torch.zeros_like(r_ful[i])
        inv_cur[i] = inv_cur[i] + due

    # 2-3) retailer sales incl. prior backlog
    to_fill = torch.clamp_min(d, 0) + bkl[0]
    sales0 = torch.minimum(inv_cur[0], to_fill)
    inv_cur[0] = inv_cur[0] - sales0

    # 4) supplier stages decremented by the orders they placed (:300)
    for i in range(1, m1):
        inv_cur[i] = inv_cur[i] - r_ful[i]
    S = [sales0] + r_ful
    U = [to_fill - sales0] + [order_req[i] - r_ful[i] for i in range(m1)]
    new_bkl = U if params.backlog else [torch.zeros_like(u) for u in U]

    # 5) period profit, stage by stage in the JAX order
    up, uc, hv = params.unit_price, params.unit_cost, params.holding_cost_vec
    profit = torch.zeros(sales0.shape, dtype=torch.float32, device=sales0.device)
    for i in range(params.num_stages):
        profit = profit + float(np.float32(float(up[i]) - float(uc[i]))) * S[i].to(torch.float32)
        profit = profit - float(np.float32(params.k[i])) * U[i].to(torch.float32)
        if i < m1:
            profit = profit - float(hv[i]) * torch.clamp_min(inv_cur[i], 0).to(torch.float32)
    if params.lt_max > 0:
        RH = r_ful + RH[: (params.lt_max - 1) * m1]
    return inv_cur, new_bkl, RH, r_req, profit


def _im_obs_rows(params: im.InvManagementParams, t: int, inv, AH):
    """The reference observation as a list of (B,) rows
    (pallas_episode_kernels._im_obs_rows): on-hand, then the last
    min(t, lt_max) requested orders chronologically, front-packed with zero
    rows at the end when t < lt_max. ``AH`` is newest-first."""
    m1, lt = params.m1, params.lt_max
    rows = list(inv)
    shift = max(0, lt - t)
    for j in range(lt):
        src = (j + shift) % lt
        for i in range(m1):   # wrapped rows land on the zero slots
            rows.append(AH[(lt - 1 - src) * m1 + i])
    return rows


def _im_demand_spec(params: im.InvManagementParams):
    """(base, thresholds) of the demand's CDF table, or None for USER mode
    (pallas_episode_kernels._im_demand_spec). A law whose table would exceed
    the cap raises NotImplementedError, as the JAX kernels refuse it."""
    if params.dist == dist.USER:
        return None
    return dist.discrete_cdf_table(params.dist, params.dist_param_dict)


class _ImParams(ctypes.Structure):
    """Mirror of ``struct ImParams`` in csrc/im_step.cuh (all fields 4-byte,
    so both sides lay it out without padding)."""
    _fields_ = [
        ("m1", ctypes.c_int), ("lt", ctypes.c_int), ("user", ctypes.c_int),
        ("tab_len", ctypes.c_int), ("base", ctypes.c_int),
        ("c", ctypes.c_int * IM_MAX_M1), ("L", ctypes.c_int * IM_MAX_M1),
        ("I0", ctypes.c_int * IM_MAX_M1),
        ("gain", ctypes.c_float * (IM_MAX_M1 + 1)), ("k", ctypes.c_float * (IM_MAX_M1 + 1)),
        ("h", ctypes.c_float * IM_MAX_M1), ("act_span", ctypes.c_float * IM_MAX_M1),
    ]


@functools.lru_cache(maxsize=32)
def _im_plan(params: im.InvManagementParams, device: str, with_demand: bool = True):
    """A launch's host-built arguments, built once per (params, device):
    the params struct, the f32 alpha^t table (as a list and on ``device``),
    and with ``with_demand`` the demand's plan: the CDF table on ``device``
    ((inf,) when empty, which inverts to 0), its base, and USER mode's
    per-period values. K7 reads no demand plan, so any law runs there.
    Raises ValueError for params beyond the struct's maxima."""
    m1, lt, T = params.m1, params.lt_max, params.periods
    if m1 > IM_MAX_M1 or lt > IM_MAX_LT:
        raise ValueError(f"InvManagement params too large for the CUDA kernels: "
                         f"m1={m1} (max {IM_MAX_M1}), lt_max={lt} (max {IM_MAX_LT})")
    spec = _im_demand_spec(params) if with_demand else None
    user = with_demand and spec is None
    base, table = spec if spec is not None else (0, ())
    st = _ImParams(m1=m1, lt=lt, user=int(user), tab_len=len(table), base=int(base))
    up, uc, hv = params.unit_price, params.unit_cost, params.holding_cost_vec
    for i in range(m1):
        st.c[i], st.L[i], st.I0[i] = params.c[i], params.L[i], params.I0[i]
        st.h[i], st.act_span[i] = float(hv[i]), float(np.float32(params.c[i] + 1))
    for i in range(params.num_stages):
        st.gain[i] = float(np.float32(float(up[i]) - float(uc[i])))
        st.k[i] = float(np.float32(params.k[i]))
    discs = _discounts(params.alpha, T)
    user_d = [int(params.user_D[t]) if t < len(params.user_D) else 0 for t in range(T)]
    return dict(struct=st, discs=discs, user=user, base=int(base),
                disc=torch.tensor(discs, dtype=torch.float32, device=device),
                table=torch.tensor(table or (float("inf"),), dtype=torch.float32,
                                   device=device),
                user_d=torch.tensor(user_d, dtype=torch.int32, device=device))


def _im_actions_plain(params: im.InvManagementParams, words):
    """The random policy's actions from one word each: inclusive uniform
    ints min((int)(u * f32(c_i + 1)), c_i) (csrc/im_step.cuh
    ``im_draw_actions``)."""
    return [torch.clamp_max((rng.uniform01(w) * float(c + 1)).to(torch.int32), c)
            for w, c in zip(words, params.c)]


def _im_demand_plain(plan, word, t: int):
    """Demand of period ``t`` from one word per lane (csrc/im_step.cuh
    ``im_demand``): USER mode's value, else base + #{F <= u}."""
    if plan["user"]:
        return plan["user_d"][t].expand(word.shape)
    d = torch.searchsorted(plan["table"], rng.uniform01(word), right=True)
    return (d + plan["base"]).to(torch.int32)


def _im_reset_rows(params: im.InvManagementParams, n: int, device):
    """(inv, backlog, RH) of ``n`` fresh episodes as lists of int32 rows."""
    zero = torch.zeros(n, dtype=torch.int32, device=device)
    inv = [torch.full((n,), int(i0), dtype=torch.int32, device=device) for i0 in params.I0]
    return inv, [zero] * params.num_stages, [zero] * (params.lt_max * params.m1)


def _episode_returns_im_plain(params, actions, demands, seed=None):
    """Plain version of K7: the episode loop of _im_kernel over (B,) rows.
    ``actions`` (T, m1, B), or None with ``seed``: the random policy's
    actions, K8's action words of episode 0."""
    T, B = demands.shape
    dev = demands.device
    inv, bkl, RH = _im_reset_rows(params, B, dev)
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    total = torch.zeros(B, dtype=torch.float32, device=dev)
    for t, disc in enumerate(_discounts(params.alpha, T)):
        if actions is None:
            act = _im_actions_plain(params, rng.period_words(seed, lanes, 0, t, params.m1))
        else:
            act = list(actions[t])
        inv, bkl, RH, _, profit = _im_step_math(params, t, inv, bkl, RH, act, demands[t])
        total = total + disc * profit
    return total


def _im_draws_plain(params, plan, seed, lanes, episodes, t):
    """Actions (m1 rows) and demand of one period of the random policy."""
    words = rng.period_words(seed, lanes, episodes, t, params.m1 + 1)
    return (_im_actions_plain(params, words[:params.m1]),
            _im_demand_plain(plan, words[params.m1], t))


def _im_fused_plain(params, seed, batch, episodes_per_lane, device, dump=False):
    """Plain version of K8 (returns (E, B)) or, with ``dump``, of K9
    (actions (T, E, m1, B), demand (T, E, B)). All E * B episodes run at
    once, episode-major, each with its own counter."""
    m1, T, E = params.m1, params.periods, episodes_per_lane
    plan = _im_plan(params, str(device))
    idx = torch.arange(E * batch, dtype=torch.int64, device=device)
    episodes, lanes = idx // batch, idx % batch
    if dump:
        i32 = dict(dtype=torch.int32, device=device)
        acts = torch.empty((T, E, m1, batch), **i32)
        dems = torch.empty((T, E, batch), **i32)
        for t in range(T):
            act, d = _im_draws_plain(params, plan, seed, lanes, episodes, t)
            acts[t] = torch.stack(act).reshape(m1, E, batch).transpose(0, 1)
            dems[t] = d.reshape(E, batch)
        return acts, dems
    inv, bkl, RH = _im_reset_rows(params, E * batch, device)
    total = torch.zeros(E * batch, dtype=torch.float32, device=device)
    for t, disc in enumerate(plan["discs"]):
        act, d = _im_draws_plain(params, plan, seed, lanes, episodes, t)
        inv, bkl, RH, _, profit = _im_step_math(params, t, inv, bkl, RH, act, d)
        total = total + disc * profit
    return total.reshape(E, batch)


def _half_c(params: im.InvManagementParams):
    """f32(0.5 * c_i), the factor of ``act = (tanh(raw) + 1) * (0.5 * c_i)``
    (pallas_episode_kernels.py:1670)."""
    return [float(np.float32(0.5 * float(c))) for c in params.c]


def _rollout_traj_im_plain(params, actor, std, seed, batch, device):
    """Plain version of K10: the streams of one stochastic-policy episode
    per lane, as ``rollout_traj_im`` returns them."""
    m1, lt, T = params.m1, params.lt_max, params.periods
    plan = _im_plan(params, str(device))
    layers = kernel_layers(actor, device)
    std = std.to(device)
    half_c = _half_c(params)
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    out = dict(inv=torch.empty((T + 1, m1, batch), **i32),
               actions=torch.empty((T, m1, batch), **i32),
               raw=torch.empty((T, m1, batch), **f32),
               reward=torch.empty((T, batch), **f32),
               demand=torch.empty((T, batch), **i32))
    inv, bkl, RH = _im_reset_rows(params, batch, device)
    AH = list(RH)
    for t in range(T):
        words = rng.period_words(seed, lanes, 0, t, 1 + 2 * m1, key1=rng.POLICY_KEY)
        d = _im_demand_plain(plan, words[0], t)
        out["inv"][t] = torch.stack(inv)
        z = rng.normal01(torch.stack(words[1:1 + m1]), torch.stack(words[1 + m1:]))
        raw, a_norm = traj_policy("ppo", "tanh", m1, layers, std,
                                  _im_obs_rows(params, t, inv, AH), z)
        S = a_norm + 1.0
        acts = [im.trunc_i32(S[i] * half_c[i]) for i in range(m1)]
        out["raw"][t], out["actions"][t] = raw, torch.stack(acts)
        inv, bkl, RH, r_req, profit = _im_step_math(params, t, inv, bkl, RH, acts, d)
        if lt:
            AH = r_req + AH[: (lt - 1) * m1]
        out["reward"][t] = plan["discs"][t] * profit
        out["demand"][t] = d
    out["inv"][T] = torch.stack(inv)
    return out


# ------------------------------------------------------------------ wrappers

def _check_im_streams(params, demands, actions=None):
    if demands.dtype != torch.int32 or (actions is not None and actions.dtype != torch.int32):
        raise TypeError("actions and demands must be int32")
    T, B = params.periods, demands.shape[-1]
    if demands.shape != (T, B):
        raise ValueError(f"expected demands ({T}, B); got {tuple(demands.shape)}")
    if actions is not None and (actions.shape != (T, params.m1, B)
                                or actions.device != demands.device):
        raise ValueError(f"expected actions ({T}, {params.m1}, {B}) on {demands.device}; "
                         f"got {tuple(actions.shape)} on {actions.device}")
    if demands.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {demands.device}")


def _im_returns_call(wrapper, params, actions, demands, seed):
    """K7 for ``wrapper``: ``actions`` streamed in, or drawn from ``seed``."""
    _check_im_streams(params, demands, actions)
    if demands.device.type == "cpu":
        return _episode_returns_im_plain(params, actions, demands, seed)
    if not (demands.is_contiguous() and (actions is None or actions.is_contiguous())):
        raise ValueError("actions and demands must be contiguous")
    dev = demands.device
    T, B = demands.shape
    plan = _im_plan(params, _plan_key(dev), False)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("im_episode", "im_episode_returns", ctypes.addressof(plan["struct"]),
                None if actions is None else actions.data_ptr(), demands.data_ptr(),
                plan["disc"].data_ptr(), out.data_ptr(), seed or 0, int(actions is None),
                int(params.backlog), B, T, _stream(dev))
    wrapper.launches += 1
    return out


def episode_returns_im(params: im.InvManagementParams, actions: torch.Tensor,
                       demands: torch.Tensor) -> torch.Tensor:
    """Discounted episode returns (B,) float32 for pre-sampled int32 streams
    ``actions`` (periods, m1, B), raw requests (negatives clamp as in the
    reference), and ``demands`` (periods, B), on one device. K7: on CUDA
    tensors one thread per env runs the whole episode (csrc/im_episode.cu
    ``k_im_returns``); on CPU tensors the plain version runs."""
    return _im_returns_call(episode_returns_im, params, actions, demands, None)


episode_returns_im.launches = 0


def episode_returns_im_random(params: im.InvManagementParams, demands: torch.Tensor,
                              seed) -> torch.Tensor:
    """Random-policy episode returns (B,) for the int32 demand stream
    ``demands`` (periods, B): inclusive uniform int actions on [0, c_i] drawn
    in the kernel from the words ``episode_returns_im_fused`` draws for its
    episode 0, so that on ``sample_streams_debug_im``'s demand it gives the
    fused kernel's returns. K7 with its action draws switched on."""
    return _im_returns_call(episode_returns_im_random, params, None, demands,
                            int(seed) & rng.MASK32)


episode_returns_im_random.launches = 0


def _im_fused_call(wrapper, params, seed, batch, episodes_per_lane, device, dump):
    dev = resolve_device(device)
    E = int(episodes_per_lane)
    if E < 1 or batch < 1:
        raise ValueError(f"need batch >= 1 and episodes_per_lane >= 1, got {batch}, {E}")
    seed = int(seed) & rng.MASK32
    if dev.type == "cpu":
        return _im_fused_plain(params, seed, batch, E, dev, dump)
    plan = _im_plan(params, _plan_key(dev))
    T, m1 = params.periods, params.m1
    args = (ctypes.addressof(plan["struct"]), plan["table"].data_ptr(),
            plan["user_d"].data_ptr())
    with torch.cuda.device(dev):
        if dump:
            acts = torch.empty((T, E, m1, batch), dtype=torch.int32, device=dev)
            dems = torch.empty((T, E, batch), dtype=torch.int32, device=dev)
            _launch("im_episode", "im_sample_streams", *args, acts.data_ptr(),
                    dems.data_ptr(), seed, batch, E, T, _stream(dev))
            out = (acts, dems)
        else:
            out = torch.empty((E, batch), dtype=torch.float32, device=dev)
            _launch("im_episode", "im_episode_returns_fused", *args,
                    plan["disc"].data_ptr(), out.data_ptr(), seed,
                    int(params.backlog), batch, E, T, _stream(dev))
    wrapper.launches += 1
    return out


def episode_returns_im_fused(params: im.InvManagementParams, seed, batch: int,
                             episodes_per_lane: int = 1, device=None):
    """Random-policy episode returns with both streams drawn in the kernel:
    inclusive uniform int actions on [0, c_i] and demand by inversion of
    the host CDF table for all four stochastic dist modes (USER mode takes
    ``user_D[t]``; a law beyond the table cap raises NotImplementedError).
    K8: one thread per (episode, lane) (csrc/im_episode.cu
    ``k_im_returns_fused``). Returns (batch,) for episodes_per_lane=1, else
    (episodes_per_lane, batch), episode-major."""
    out = _im_fused_call(episode_returns_im_fused, params, seed, batch,
                         episodes_per_lane, device, False)
    return out.reshape(batch) if episodes_per_lane == 1 else out


episode_returns_im_fused.launches = 0


def sample_streams_debug_im(params: im.InvManagementParams, seed, batch: int,
                            episodes_per_lane: int = 1, device=None):
    """The exact action and demand streams ``episode_returns_im_fused``
    draws for ``seed``. K9: it shares K8's draws (csrc/im_step.cuh).
    Returns (actions (T, m1, batch), demands (T, batch)) int32 for
    episodes_per_lane=1, else (T, E, m1, batch) and (T, E, batch)."""
    acts, dems = _im_fused_call(sample_streams_debug_im, params, seed, batch,
                                episodes_per_lane, device, True)
    if episodes_per_lane == 1:
        return acts[:, 0], dems[:, 0]
    return acts, dems


sample_streams_debug_im.launches = 0


def rollout_traj_im(params: im.InvManagementParams, actor, log_std, seed,
                    batch: int, policy: str = "ppo", act_name: str = "tanh",
                    device=None):
    """One full stochastic-policy episode per lane with the training streams
    written out. ``actor`` is ``(Ws, bs)`` from ``fold_actor_params``;
    ``log_std`` the policy's log-std, clipped through ``clipped_std``.
    Returns a dict: ``inv (T+1, m1, batch)`` int32 start-of-period on-hand
    (the final snapshot last), ``actions (T, m1, batch)`` int32,
    ``raw (T, m1, batch)`` f32 pre-squash samples, ``reward (T, batch)`` f32
    (alpha^t-discounted) and ``demand (T, batch)`` int32. K10: one thread
    per lane (csrc/im_policy.cu ``k_im_rollout_traj``); on the CPU the plain
    version runs. Only the PPO head with a tanh trunk is ported: other
    ``policy`` or ``act_name`` values raise NotImplementedError."""
    if policy != "ppo" or act_name != "tanh":
        _refuse_mode(f"policy={policy!r}, act_name={act_name!r}")
    dev = resolve_device(device)
    if batch < 1:
        raise ValueError(f"need batch >= 1, got {batch}")
    m1, T = params.m1, params.periods
    seed = int(seed) & rng.MASK32
    std = clipped_std(torch.as_tensor(log_std).detach())
    obs_dim = im.observation_space(params).shape[0]
    mlp, flat = _pack_actor(actor, std, obs_dim, m1, _half_c(params), dev)
    if dev.type == "cpu":
        return _rollout_traj_im_plain(params, actor, std, seed, batch, dev)
    plan = _im_plan(params, _plan_key(dev))
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(inv=torch.empty((T + 1, m1, batch), **i32),
               actions=torch.empty((T, m1, batch), **i32),
               raw=torch.empty((T, m1, batch), **f32),
               reward=torch.empty((T, batch), **f32),
               demand=torch.empty((T, batch), **i32))
    with torch.cuda.device(dev):
        _launch("im_policy", "im_rollout_traj", ctypes.addressof(plan["struct"]),
                ctypes.addressof(mlp), flat.data_ptr(), flat.numel(),
                plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr(),
                *(out[k].data_ptr() for k in ("inv", "actions", "raw", "reward", "demand")),
                seed, int(params.backlog), batch, T, _stream(dev))
    rollout_traj_im.launches += 1
    return out


rollout_traj_im.launches = 0
