"""InvManagement and Newsvendor whole-episode kernels, the folded actor of
the policy kernels, and the plain versions of the in-kernel helpers.

Port of ``or_gym_inventory_tpu/ops/pallas_episode_kernels.py``: the
InvManagement kernels (``csrc/im_episode.cu``, ``csrc/im_policy.cu``, and
under the LSTM actor ``csrc/im_lstm.cu`` and, past its fixed class,
``csrc/im_lstm_any.cu``) and the Newsvendor kernels
(``csrc/nv_episode.cu``, ``csrc/nv_policy.cu``) with their plain PyTorch
versions, ``fold_lstm_actor`` and ``lstm_forward`` (the LSTM actor's plain
version), and what every MLP policy kernel shares:

- ``clipped_std``, ``fold_actor_params`` (the obs RunningMeanStd folded into
  layer 1), ``folded_actor_mean`` and ``apply_folded_actor``, on host;
- ``fold_offpolicy_actor``, the off-policy learners' actor (relu trunk,
  mean head, and for SAC the log_std head beside it) folded the same way;
- ``_pack_actor``, the actor as the first designs of the PPO trajectory
  kernels took it (``csrc/mlp.cuh``; kept for their copies under
  ``tools/``);
  ``_pack_tile_actor``, the actor of the learned-policy returns kernels K5,
  K11 and K19 and of the PPO trajectory kernels K4 (``ops/net_step.py``),
  K10 and K18 over a tile of lanes on the tensor cores
  (``csrc/mlp_tile.cuh``, its layout ``_mlp_tile_plan``; K18/K19's demand,
  pipeline and Poisson table ``_nv_tile_plan``); ``_pack_cluster_actor``,
  the actor of the off-policy trajectory kernels K27-K29 over a
  thread-block cluster (``csrc/cluster_mlp.cuh``, its layout
  ``_cluster_plan``, its tile ``_cluster_choice``); and
  ``_pack_wide_actor``, the actor of their wide route
  (``csrc/wide_mlp.cuh``);
- the plain versions of the in-kernel helpers ``mlp_forward`` (tanh or
  relu trunk), ``traj_policy`` (heads ``"ppo"``, ``"det"``, ``"sac"`` and
  ``"uniform"``), ``_im_step_math``, ``_im_obs_rows``,
  ``_nv_step_math``, ``_nv_obs_rows`` and ``_nv_econ_from_uniforms``
  (the Poisson inversion is ``ops.nv_poisson``'s). Those of ``_uniform01`` and ``_normal01`` are
  ``ops.rng.uniform01`` and ``normal01``, which turn Philox words into the
  kernels' draws where the TPU drew from its own generator.

| wrapper                           | replaces (pallas_episode_kernels.py)         |
| ``episode_returns_im``            | ``episode_returns_im`` :802 (K7)             |
| ``episode_returns_im_random``     | ``episode_returns_im_random`` :815 (K7)      |
| ``episode_returns_im_fused``      | ``episode_returns_im_fused`` :919 (K8)       |
| ``sample_streams_debug_im``       | ``sample_streams_debug_im`` :1873 (K9)       |
| ``rollout_traj_im``               | ``rollout_traj_im`` :1683 (K10)              |
| ``rollout_traj_im_offpolicy``     | ``rollout_traj_im`` :1683, off-policy heads (K27) |
| ``episode_returns_im_policy``     | ``episode_returns_im_policy`` :1264 (K11)    |
| ``sample_policy_streams_debug_im`` | ``sample_policy_streams_debug_im`` :1287 (K12) |
| ``episode_returns_im_lstm``       | ``episode_returns_im_lstm`` :1459 (K22)      |
| ``sample_lstm_streams_debug_im``  | ``sample_lstm_streams_debug_im`` :1470 (K23) |
| ``rollout_traj_im_lstm``          | ``rollout_traj_im_lstm`` :1551 (K24)         |
| ``episode_returns_nv``            | ``episode_returns_nv`` :146 (K13)            |
| ``episode_returns_nv_random``     | ``episode_returns_nv_random`` :157 (K13)     |
| ``episode_returns_nv_fused``      | ``episode_returns_nv_fused`` :368 (K14)      |
| ``sample_streams_debug_nv``       | ``sample_streams_debug_nv`` :529 (K15)       |
| ``episode_returns_nv_reset_fused`` | ``episode_returns_nv_reset_fused`` :495 (K16) |
| ``sample_streams_debug_nv_reset`` | ``sample_streams_debug_nv_reset`` :513 (K17) |
| ``rollout_traj_nv``               | ``rollout_traj_nv`` :1796 (K18)              |
| ``rollout_traj_nv_offpolicy``     | ``rollout_traj_nv`` :1796, off-policy heads (K28) |
| ``episode_returns_nv_policy``     | ``episode_returns_nv_policy`` :648 (K19)     |
| ``sample_policy_streams_debug_nv`` | ``sample_policy_streams_debug_nv`` :665 (K20) |
| ``sample_normals_debug``          | ``sample_normals_debug`` :1849 (K21)         |

The InvManagement kernels take any stage count and lead time: params within
``IM_MAX_M1`` stocked stages and lead times up to ``IM_MAX_LT`` pack the
fixed ``struct ImParams`` (``_ImParams``); any other takes the chain route
(``_ImParamsG``, the C entry points ``*_chain``): the per-stage records
(``_im_records``) staged by each block into its shared memory and each
lane's state a column of ``_im_lane_words`` words (csrc/im_step.cuh).
``_im_plan`` picks the route and raises ValueError only where a lane's
state fits no block of 32 lanes.

Each wrapper runs the plain version for CPU tensors; on CUDA it launches its
kernel and raises if the launch fails; nothing falls back. It counts its
launches in ``<wrapper>.launches``. Layout follows the JAX package, the
batch last; InvManagement streams are int32, Newsvendor streams float32.
The wrappers drop the JAX entry points' ``block``, ``interpret`` and
``precision`` (and the Newsvendor ones ``demand_chunk``): they set the TPU's
tiling, the order in which it consumed its random numbers and its register
pressure. The random streams are Philox4x32-10 words (``ops/rng.py``): the
InvManagement random policy's under key (seed, 0), m1 action words then one
demand word per period; the InvManagement policy kernels' (K10-K12, and the
LSTM kernels K22-K24) under (seed, 1), one demand word, then, when
stochastic, m1 u1 and m1 u2 words (K27, the off-policy heads: the demand
word, then m1 u1 and m1 u2 words, or for ``"uniform"`` the m1 u1 words
alone); the Newsvendor random-policy kernels' (K13-K17) under (seed, 0), the
reset's 5 words at period ``NV_ECON_PERIOD``, then per period one action
word and one demand word; the Newsvendor policy kernels' (K18-K20) under
(seed, 1), the reset's 5 words at ``NV_ECON_PERIOD``, then per period one
demand word and, when stochastic, the u1 and u2 words of the normal (K28:
the u1 and u2 words, or for ``"uniform"`` the u1 word alone); K21
dumps normal01 of words 0 and 1 of period ``row`` under (seed, 1). The
Newsvendor dumps are laid out as K17's: econ (E, 5, B), streams (T, E, B).

An actor is ``(Ws, bs)``: Ws[l] (in, out), bs[l] (out,), float32, as the JAX
package has it. The plain versions compute with the layers as (out, in), as
the Pallas kernels did (``kernel_layers``); the CUDA kernels take them as
(in, out) with the outputs padded to 8 for the wide kernels
(``_pack_wide_actor``), or as tensor-core A fragments
(``_pack_tile_actor``, ``_pack_lstm_actor``), or as each CTA's slices
of a cluster (``_pack_cluster_actor``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from or_gym_inventory_torch.agents import networks
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import newsvendor as nv
from or_gym_inventory_torch.ops import distributions as dist
from or_gym_inventory_torch.ops import nv_poisson
from or_gym_inventory_torch.ops import rng

# maxima of the first design's actor (csrc/mlp.cuh) and of the tile's fixed
# class (csrc/mlp_tile.cuh MlpTile); an actor past them, or whose layout fits
# no block, takes the general class (MlpTileG). A block's layout must fit the
# dynamic shared memory a Hopper block may opt in to (227 KB)
MAX_LAYERS, MAX_WIDTH, MAX_ACT = 8, 256, 32
SMEM_OPTIN_BYTES = 232_448
# the device workspace of the general classes' activations (MlpTileG,
# WideMlpG), where they fit no block: a block's slice must fit it, and the
# persistent grid holds as many blocks as it has slices for
WORKSPACE_MAX_BYTES = 1 << 32
# an H100 SM's shared memory, the share the runtime reserves per resident
# block, and the SM's limits on resident threads and blocks
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 233_472, 1_024
THREADS_PER_SM, BLOCKS_PER_SM = 2_048, 32
# and of the InvManagement params struct (csrc/im_step.cuh): params past
# them take the chain route (ImParamsG, the C entry points named *_chain)
IM_MAX_M1, IM_MAX_LT = 8, 32
# the trajectory kernels' heads (csrc/wide_mlp.cuh WideHead) and trunks
HEADS = {"ppo": 0, "det": 1, "sac": 2, "uniform": 3}
_TRUNKS = {"tanh": torch.tanh, "relu": torch.relu}


def _check_head(policy: str, act_name: str):
    """Raise ValueError for a head or a trunk that traj_policy does not have."""
    if policy not in HEADS:
        raise ValueError(f"unknown traj_policy mode {policy!r}")
    if act_name not in _TRUNKS:
        raise ValueError(f"unknown act_name {act_name!r}; the trunks are tanh and relu")


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
        raise ValueError("policy-in-kernel supports tanh trunks (the benchmark default); "
                         f"got activation={cfg.activation!r}")
    layers = list(model.pi) + [model.mean]
    Ws = [layer.weight.detach().to(torch.float32).T.clone() for layer in layers]
    bs = [layer.bias.detach().to(torch.float32).clone() for layer in layers]
    if rms is not None and getattr(cfg, "normalize_obs", True):
        invstd = 1.0 / torch.sqrt(rms.var.to(torch.float32) + 1e-8)
        mu = rms.mean.to(torch.float32)
        bs[0] = bs[0] - (mu * invstd) @ Ws[0]
        Ws[0] = Ws[0] * invstd[:, None]
    return tuple(Ws), tuple(bs)


def fold_offpolicy_actor(pi_arch, actor, rms=None, stochastic: bool = False):
    """The off-policy learners' actor (``agents.off_policy._Actor``: relu
    trunk, mean head and, for SAC, a log_std head) as plain (Ws, bs) float32
    tensors for the trajectory kernels, the obs normalisation folded into
    the first layer as ``fold_actor_params`` folds it. With ``stochastic``
    the mean and log_std heads are concatenated into one output layer of
    2 * act_dim outputs, which ``traj_policy("sac", ...)`` splits apart
    (pallas_episode_kernels.fold_offpolicy_actor :1000)."""
    if len(actor.trunk) != len(pi_arch):
        raise ValueError(f"actor has {len(actor.trunk)} trunk layers, pi_arch {tuple(pi_arch)}")

    def wb(layer):
        return (layer.weight.detach().to(torch.float32).T.clone(),
                layer.bias.detach().to(torch.float32).clone())

    Ws, bs = (list(x) for x in zip(*(wb(layer) for layer in actor.trunk))) \
        if len(actor.trunk) else ([], [])
    W_out, b_out = wb(actor.mean)
    if stochastic:
        W_ls, b_ls = wb(actor.log_std)
        W_out, b_out = torch.cat([W_out, W_ls], dim=1), torch.cat([b_out, b_ls])
    Ws.append(W_out)
    bs.append(b_out)
    if rms is not None:
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


# ------------------------------------------------ the float64 plain oracle
#
# The plain versions run in float32 by default, the kernels' own arithmetic
# in another order. With dtype=torch.float64 they are the oracle: the same
# function of the same float32 inputs (weights, obs, the period's words)
# computed in float64, with each output's float32 forward bound beside it.
# The bound is what any float32 evaluation of that function may miss the
# float64 one by: gamma_n times the running magnitude of each sum (sum |W|
# |h| + |b| a layer, a step's sum of |terms|), carried through the
# activations by their largest slope within the error so far, plus each
# activation's own rounding (Higham, Accuracy and Stability of Numerical
# Algorithms, 2nd ed., Lemma 3.1 and section 3.5). The kernels' 6xTF32
# products (csrc/mma_tf32.cuh) miss a product by under 2^-32 of it, within it.
# Nothing on the card's main path calls these twins.

F32_U = 2.0 ** -24   # float32's unit roundoff
# ulps of the float32 functions at their worst (CUDA's tanhf, expf and cosf
# are within 2 ulp), as relative errors of 2u an ulp
_FN_REL = 4 * F32_U
# the Box-Muller normal's float32 error: its radius (at most 5.77) times
# f32(2 pi) u2 rounded and cosf, and its log, sqrt and product, per unit of
# |z|; bounded as _Z_ABS + _Z_REL |z|
_Z_ABS, _Z_REL = 48 * F32_U, 8 * F32_U
_FLOAT_DTYPES = (torch.float32, torch.float64)


def gamma_f32(n) -> float:
    """gamma_n = n u / (1 - n u), u = 2^-24: the relative forward bound of a
    float32 sum of n + 1 terms (n roundings) in any order, or of n roundings
    in a row."""
    nu = n * F32_U
    return nu / (1.0 - nu)


def _check_dtype(dtype):
    if dtype not in _FLOAT_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, not {dtype}")


def _tanh_slope(y, e):
    """The largest slope of tanh within e of y: 1 - tanh(max(|y| - e, 0))^2."""
    return 1.0 - torch.tanh(torch.clamp_min(y.abs() - e, 0.0)) ** 2


def _sigmoid_slope(y, e):
    """The largest slope of the logistic function within e of y."""
    s = torch.sigmoid(torch.clamp_min(y.abs() - e, 0.0))
    return s * (1.0 - s)


def _dense64(W, b, H, e):
    """One layer W @ H + b in float64 and its float32 forward bound, the
    input H carrying the bound e: gamma_{in + 1} (|W| (|H| + e) + |b|) + |W| e."""
    aW = W.abs()
    carried = aW @ e
    mag = aW @ H.abs() + carried + b.abs()
    return W @ H + b, gamma_f32(W.shape[1] + 1) * mag + carried


def _tanh64(Y, e):
    """tanh of Y in float64, and the bound: the slope within e times e, and
    tanhf's own rounding."""
    H = torch.tanh(Y)
    return H, _tanh_slope(Y, e) * e + _FN_REL * H.abs()


def _relu64(Y, e):
    """relu of Y in float64 (a NaN kept, as the float32 trunk keeps it), and
    the bound: e, or 0 where Y + e < 0 leaves both sides at 0."""
    H = torch.relu(Y)
    return H, torch.where(Y + e < 0.0, torch.zeros_like(e), e)


_TRUNKS64 = {"tanh": _tanh64, "relu": _relu64}


def _noise_bound(mode: str, z):
    """The float32 noise's bound against its float64 twin: the normals'
    (_Z_ABS + _Z_REL |z|), none for the exact 24-bit uniforms."""
    if mode == "uniform":
        return torch.zeros_like(z)
    return _Z_ABS + _Z_REL * z.abs()


def kernel_layers(actor, device, dtype=torch.float32):
    """The actor as the plain versions of the kernels use it:
    [(W (out, in), b (out, 1))] on ``device``, its float32 values in
    ``dtype`` (float32, or float64 for the oracle)."""
    _check_dtype(dtype)
    Ws, bs = actor
    return [(torch.as_tensor(W, dtype=torch.float32, device=device).to(dtype).T.contiguous(),
             torch.as_tensor(b, dtype=torch.float32, device=device).to(dtype).reshape(-1, 1))
            for W, b in zip(Ws, bs)]


def mlp_forward(layers, act_name: str, obs_rows, dtype=torch.float32):
    """Plain version of the in-kernel trunk and head: the obs rows, each (B,),
    stacked to (obs_dim, B), then W @ H + b per layer of ``kernel_layers``
    with ``act_name`` ("tanh" or "relu", which keeps a NaN as jnp.maximum
    does) after every layer but the last. Returns (outputs, B); with
    ``dtype=torch.float64`` (layers of that dtype, the obs rows their
    float32 values) (outputs, their float32 forward bound), both float64."""
    if act_name not in _TRUNKS:
        raise ValueError(f"unknown act_name {act_name!r}; the trunks are tanh and relu")
    _check_dtype(dtype)
    if dtype == torch.float64:
        H = torch.stack([r.to(torch.float32) for r in obs_rows]).to(torch.float64)
        e = torch.zeros_like(H)
        for i, (W, b) in enumerate(layers):
            H, e = _dense64(W, b, H, e)
            if i < len(layers) - 1:
                H, e = _TRUNKS64[act_name](H, e)
        return H, e
    act = _TRUNKS[act_name]
    H = torch.stack([r.to(torch.float32) for r in obs_rows])
    for i, (W, b) in enumerate(layers):
        H = W @ H + b
        if i < len(layers) - 1:
            H = act(H)
    return H


def traj_policy(mode: str, act_name: str, act_dim: int, layers, std, obs_rows,
                z: torch.Tensor, dtype=torch.float32):
    """Plain version of the trajectory kernels' policy head
    (pallas_episode_kernels.traj_policy :1036-1081). ``z`` (act_dim, B) is
    the period's noise: standard normals, or for ``"uniform"`` the 24-bit
    uniforms in [0, 1). Returns (store, a_norm): what the kernel writes to
    its raw stream, and the normalised action in [-1, 1] the env consumes.

    - ``"ppo"``: raw = H + std * z, stored; a_norm = tanh(raw).
    - ``"det"`` (TD3/DDPG): a = clip(tanh(H) + std * z, -1, 1).
    - ``"sac"``: the actor's 2 * act_dim outputs split into mean and ls,
      a = tanh(mean + exp(clip(ls, -10, 2)) * z).
    - ``"uniform"`` (warmup): a = 2 z - 1; the actor does not run.

    The off-policy heads store a_norm. An unknown mode raises ValueError.
    With ``dtype=torch.float64`` (``kernel_layers`` and ``_head_noise`` in
    that dtype) returns (store, a_norm, the store's float32 forward bound),
    the noise's own float32 error in the bound."""
    _check_dtype(dtype)
    if dtype == torch.float64:
        return _traj_policy64(mode, act_name, act_dim, layers, std, obs_rows, z)
    if mode == "uniform":
        a = 2.0 * z - 1.0
        return a, a
    if mode not in HEADS:
        raise ValueError(f"unknown traj_policy mode {mode!r}")
    H = mlp_forward(layers, act_name, obs_rows)
    want = 2 * act_dim if mode == "sac" else act_dim
    if H.shape[0] != want:
        raise ValueError(f"the actor has {H.shape[0]} outputs, expected {want}")
    if mode == "ppo":
        raw = H + std * z
        return raw, torch.tanh(raw)
    if mode == "det":
        a = torch.clamp(torch.tanh(H) + std * z, -1.0, 1.0)
        return a, a
    mean, ls = H[:act_dim], H[act_dim:]
    a = torch.tanh(mean + torch.exp(torch.clamp(ls, -10.0, 2.0)) * z)
    return a, a


def _traj_policy64(mode, act_name, act_dim, layers, std, obs_rows, z):
    """``traj_policy`` in float64 with the store's float32 forward bound:
    the trunk's (``mlp_forward``), the noise's (``_noise_bound``), the
    head's sums and products (gamma_2) and its tanhf and expf ulps."""
    ez = _noise_bound(mode, z)
    if mode == "uniform":
        a = 2.0 * z - 1.0
        return a, a, ez
    if mode not in HEADS:
        raise ValueError(f"unknown traj_policy mode {mode!r}")
    H, e = mlp_forward(layers, act_name, obs_rows, torch.float64)
    want = 2 * act_dim if mode == "sac" else act_dim
    if H.shape[0] != want:
        raise ValueError(f"the actor has {H.shape[0]} outputs, expected {want}")
    if mode in ("ppo", "det"):
        s = torch.as_tensor(std, dtype=torch.float32, device=H.device).to(torch.float64)
        if mode == "ppo":
            raw = H + s * z
            bound = e + s.abs() * ez + gamma_f32(2) * (H.abs() + (s * z).abs())
            return raw, torch.tanh(raw), bound
        t, et = _tanh64(H, e)
        a = torch.clamp(t + s * z, -1.0, 1.0)
        return a, a, et + s.abs() * ez + gamma_f32(2) * (t.abs() + (s * z).abs())
    mean, ls = H[:act_dim], H[act_dim:]
    em, els = e[:act_dim], e[act_dim:]
    s = torch.exp(torch.clamp(ls, -10.0, 2.0))
    es = s * torch.expm1(els) + _FN_REL * s
    pre = mean + s * z
    epre = em + s * ez + (z.abs() + ez) * es + gamma_f32(2) * (mean.abs() + (s * z).abs())
    a, ea = _tanh64(pre, epre)
    return a, a, ea


def _head_noise(mode: str, words, dtype=torch.float32):
    """The head's noise (act_dim, B) from the period's words after the
    demand's: the act_dim u1 then act_dim u2 words as Box-Muller normals,
    or for ``"uniform"`` the act_dim u1 words as uniforms, in ``dtype``."""
    if mode == "uniform":
        return rng.uniform01(torch.stack(words), dtype)
    n = len(words) // 2
    return rng.normal01(torch.stack(words[:n]), torch.stack(words[n:]), dtype)


def _head_words(mode: str, act_dim: int, stochastic: bool = True) -> int:
    """Words of the head's noise per period: 0 for the deterministic PPO
    head, act_dim for "uniform", else 2 * act_dim."""
    if mode == "uniform":
        return act_dim
    return 2 * act_dim if stochastic or mode != "ppo" else 0


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


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _actor_dims(actor, obs_dim: int, act_dim):
    """The actor's widths [obs_dim, ..., outputs]; raises ValueError for an
    actor that does not fit the env. ``act_dim`` is the output width, or a
    tuple of the widths allowed."""
    Ws, bs = actor
    if len(Ws) != len(bs) or not Ws:
        raise ValueError("actor must be (Ws, bs) with one bias per layer")
    dims = [int(Ws[0].shape[0])] + [int(W.shape[1]) for W in Ws]
    for layer, (W, b) in enumerate(zip(Ws, bs)):
        if tuple(W.shape) != (dims[layer], dims[layer + 1]) or tuple(b.shape) != (dims[layer + 1],):
            raise ValueError(f"layer {layer}: W {tuple(W.shape)} and b {tuple(b.shape)} "
                             f"do not chain to widths {dims}")
    outs = act_dim if isinstance(act_dim, tuple) else (act_dim,)
    if dims[0] != obs_dim or dims[-1] not in outs:
        raise ValueError(f"actor maps {dims[0]} -> {dims[-1]}; the env needs "
                         f"obs_dim {obs_dim} -> act_dim {act_dim}")
    return dims


def _head_dims(actor, obs_dim: int, act_dim: int, policy: str):
    """``_actor_dims`` for ``policy``'s head: act_dim outputs, 2 * act_dim
    for "sac", either for "uniform" (whose actor does not run)."""
    outs = {"sac": (2 * act_dim,), "uniform": (act_dim, 2 * act_dim)}.get(policy, (act_dim,))
    return _actor_dims(actor, obs_dim, outs)


def _mlp_dims(actor, obs_dim: int, act_dim: int):
    """``_actor_dims``, raising ValueError beyond the first design's maxima
    (``_pack_actor``, which only tools/ uses)."""
    dims = _actor_dims(actor, obs_dim, act_dim)
    if len(dims) - 1 > MAX_LAYERS or max(dims) > MAX_WIDTH or act_dim > MAX_ACT:
        raise ValueError(f"actor widths {dims}: the kernels take at most "
                         f"{MAX_LAYERS} layers of width <= {MAX_WIDTH} and "
                         f"{MAX_ACT} actions")
    return dims


def _pack_actor(actor, std, obs_dim: int, act_dim: int, half_hi, device):
    """The actor arguments of the first designs of K4, K10 and K18 (one
    forward pass a thread, csrc/mlp.cuh; kept as copies under ``tools/``
    for the sweeps that time them against the tile): the Mlp struct
    (``half_hi[i]`` the f32 factor that maps tanh(raw_i) + 1 onto action
    i's range) and one flat float32 buffer on ``device``, each layer as W^T
    (in, out16) then b (out16), the outputs zero-padded to a multiple of 16,
    then the std when given. Raises ValueError for an actor beyond the
    kernels' maxima, or if the buffer and the activation buffers exceed the
    shared memory of a block."""
    dims = _mlp_dims(actor, obs_dim, act_dim)
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


# ------------------------------------------ the tensor-core fragments

# the float32 NaN the tile kernels' TF32 split keeps a NaN (csrc/mma_tf32.cuh
# split_tf32: rounding 0x7fffffff carries into the sign bit)
_QUIET_NAN_BITS = 0x7FC00000


def _mma_fragments(A) -> torch.Tensor:
    """A (16 m, 8 k) as the A fragments of csrc/mma_tf32.cuh's
    mma.sync m16n8k8: per (M-tile, k-step, lane) the float4 {a0, a1, a2, a3} =
    A[gid][tig], A[gid + 8][tig], A[gid][tig + 4], A[gid + 8][tig + 4] of
    the tile's 16 x 8 block, gid = lane / 4, tig = lane % 4."""
    m, k = A.shape[0] // 16, A.shape[1] // 8
    # [mt][half][gid][ks][c4][tig] -> [mt][ks][gid][tig][c4][half]
    T = A.reshape(m, 2, 8, k, 2, 4).permute(0, 3, 2, 5, 4, 1)
    return T.reshape(-1)


def _encoder_fragments(W, b):
    """A dense layer's W (out, in) (an LSTM encoder layer, a tile MLP layer)
    as ``_mma_fragments`` of its zero-padded (pad16(out), pad8(in)) block,
    and b padded to pad16(out)."""
    n_out, n_in = W.shape
    Wp = torch.zeros((_pad16(n_out), _pad8(n_in)), dtype=torch.float32, device=W.device)
    Wp[:n_out, :n_in] = W
    bp = torch.zeros(_pad16(n_out), dtype=torch.float32, device=W.device)
    bp[:n_out] = b.reshape(-1)
    return _mma_fragments(Wp), bp


def _quiet_nans(flat: torch.Tensor) -> torch.Tensor:
    """``flat`` with every NaN written as the quiet NaN 0x7fc00000, which
    csrc/mma_tf32.cuh split_tf32 keeps a NaN (the fill value, a Python
    float, reaches float32 as those bits)."""
    quiet = float(np.array([_QUIET_NAN_BITS], np.uint32).view(np.float32)[0])
    return flat.masked_fill(torch.isnan(flat), quiet).contiguous()


# ------------------------------------- the MLP actor over a tile of lanes

class _MlpTile(ctypes.Structure):
    """Mirror of ``struct MlpTile`` in csrc/mlp_tile.cuh (all fields 4-byte,
    so both sides lay it out without padding)."""
    _fields_ = [("n_layers", ctypes.c_int), ("dims", ctypes.c_int * (MAX_LAYERS + 1)),
                ("w", ctypes.c_int * MAX_LAYERS), ("b", ctypes.c_int * MAX_LAYERS),
                ("std", ctypes.c_int), ("lanes", ctypes.c_int), ("stride", ctypes.c_int),
                ("s_x0", ctypes.c_int), ("s_x1", ctypes.c_int), ("s_dem", ctypes.c_int),
                ("s_z", ctypes.c_int), ("s_scratch", ctypes.c_int), ("s_state", ctypes.c_int),
                ("s_total", ctypes.c_int), ("half_hi", ctypes.c_float * MAX_ACT)]


@dataclasses.dataclass(frozen=True)
class MlpTilePlan:
    """A block's tile and shared-memory layout for K5/K6 and K11/K12:
    ``lanes`` (lane, episode) pairs a block, one thread each; every buffer
    [row][lane] with rows ``stride`` floats apart, except the state
    ([word][lane], rows ``lanes`` apart); ``rows`` of each activation
    buffer, one buffer when ``in_place``; the float offsets ``offsets``
    (x0, x1; dem, z and scratch, the transient rows inside H's buffer;
    state), ``floats`` in all."""
    lanes: int
    stride: int
    rows: int
    in_place: bool
    offsets: dict
    floats: int


# M-tiles of 16 outputs a warp holds at once (csrc/mlp_tile.cuh MLP_TILE_GROUP;
# K18-K20's general class half as many, csrc/nv_policy.cu NvTileGroup)
_MLP_TILE_GROUP = 4
_NV_TILE_GROUP_ANY = _MLP_TILE_GROUP // 2
# the tiles the entry points take, in order of preference: the first whose
# shared memory fits a block (the kernels take any multiple of 32)
_MLP_TILES = (64, 32)


def _mlp_tile_plan(dims, dem_rows: int, scratch_rows: int, state_words: int,
                   lanes: int, topo_floats: int = 0) -> MlpTilePlan:
    """The layout of a tile of ``lanes`` pairs for an actor of widths
    ``dims``: the activations (the obs rows padded to 8, each layer's
    outputs to 16; in place when each layer is one product, since it reads
    all of its inputs before it writes: a hidden layer of one M-tile or of
    a group of ``_MLP_TILE_GROUP``, an output layer of one M-tile; else
    two ping-pong buffers), then ``state_words``
    words a lane of state that lasts the episode, then ``topo_floats`` for the
    block (K4-K6: the topology's records, ops/net_step.py). The period's transient
    rows lie in the buffer that ends with H, from row pad16(act), dead
    until the next period's obs: ``dem_rows`` of demand, a row of normals
    per action and ``scratch_rows`` of step scratch; the buffers have rows
    enough for them."""
    stride = lanes + 8   # B-fragment loads and the float2 stores hit 32 banks
    act = dims[-1]
    rows = max([_pad8(dims[0])] + [_pad16(d) for d in dims[1:]]
               + [_pad16(act) + dem_rows + act + scratch_rows])
    in_place = (all(_pad16(d) // 16 in (1, _MLP_TILE_GROUP) for d in dims[1:-1])
                and _pad16(act) == 16)
    x1 = 0 if in_place else rows * stride
    h = x1 if (len(dims) - 1) % 2 else 0   # layer l writes buffer (l + 1) & 1
    dem = h + _pad16(act) * stride
    state = x1 + rows * stride
    offsets = {"x0": 0, "x1": x1, "dem": dem, "z": dem + dem_rows * stride,
               "scratch": dem + (dem_rows + act) * stride, "state": state}
    return MlpTilePlan(lanes, stride, rows, in_place, offsets,
                       state + state_words * lanes + topo_floats)


def _set_mlp_tile(st: _MlpTile, plan: MlpTilePlan) -> None:
    """Write ``plan``'s tile and layout into ``st`` (the packed buffer does
    not depend on the tile)."""
    st.lanes, st.stride = plan.lanes, plan.stride
    for name, offset in plan.offsets.items():
        setattr(st, f"s_{name}", offset)
    st.s_total = plan.floats


def _gather_source(dims, with_std: bool):
    """The source offsets of a cached gather's concatenation: each layer's W
    (in, out) row-major, then each b, then the std (``with_std``), then one
    zero. Returns (W offsets, b offsets, the std's offset, the zero's)."""
    pairs = list(zip(dims, dims[1:]))
    w_src = np.cumsum([0] + [i * o for i, o in pairs])
    b_src = w_src[-1] + np.cumsum([0] + [o for _, o in pairs])
    std_src = int(b_src[-1])
    return w_src, b_src, std_src, std_src + (dims[-1] if with_std else 0)


def _gather(actor, std, index, zero, dev) -> torch.Tensor:
    """The packed buffer of a cached plan: the actor's layers (and the std
    when given) concatenated as ``_gather_source`` counts them, with a
    zero, indexed by ``index``: one cat and one index."""
    f32 = dict(dtype=torch.float32, device=dev)
    Ws, bs = actor
    src = [torch.as_tensor(W, **f32).reshape(-1) for W in Ws]
    src += [torch.as_tensor(b, **f32).reshape(-1) for b in bs]
    if std is not None:
        src.append(torch.as_tensor(std, **f32).reshape(-1))
    return torch.cat(src + [zero])[index]


def _within_fixed_tile(dims) -> bool:
    """Whether an actor of widths ``dims`` fits MlpTile's fixed arrays
    (MAX_LAYERS layers, widths up to MAX_WIDTH, MAX_ACT actions): the
    parent's class, which keeps its layout where that fits a block."""
    return len(dims) - 1 <= MAX_LAYERS and max(dims) <= MAX_WIDTH and dims[-1] <= MAX_ACT


def _fixed_tile_plan(dims, dem_rows: int, scratch_rows: int, state_words: int,
                     topo_floats: int = 0):
    """MlpTile's plan: the first of ``_MLP_TILES`` whose ``_mlp_tile_plan``
    fits a block, for an actor within the fixed arrays; else None (the
    general class)."""
    if not _within_fixed_tile(dims):
        return None
    return next((pl for pl in (_mlp_tile_plan(dims, dem_rows, scratch_rows, state_words, lanes,
                                              topo_floats) for lanes in _MLP_TILES)
                 if pl.floats * 4 <= SMEM_OPTIN_BYTES), None)


@dataclasses.dataclass(frozen=True)
class MlpTileAnyPlan:
    """The general class's layout (csrc/mlp_tile.cuh MlpTileG) of a tile of
    ``lanes`` pairs: activation buffer 0 of ``rows[0]`` rows (the obs, the
    outputs of layers 1, 3, ...) and buffer 1 of ``rows[1]`` (layers 0, 2,
    ...; one buffer of ``rows[0]`` when ``in_place``), [row][lane] at
    ``stride``; ``transient``: where the period's transient rows lie, "dead"
    (from row 0 of the buffer that does not hold H) or "after_h" (from row
    pad16(act) of H's); ``workspace``: the buffers in the block's slice of
    the device workspace (``act_floats`` floats a block, rows ``lanes``
    apart) rather than in shared memory. ``offsets``: x0, x1, dem, z and
    scratch from the activation base, state in shared memory; ``floats``:
    the block's shared memory (the activations when not in the workspace,
    the state, the records)."""
    lanes: int
    stride: int
    rows: tuple
    in_place: bool
    transient: str
    workspace: bool
    offsets: dict
    act_floats: int
    floats: int


def _mlp_tile_plan_any(dims, dem_rows: int, scratch_rows: int, state_words: int, lanes: int,
                       topo_floats: int = 0, workspace: bool = False,
                       group: int = _MLP_TILE_GROUP) -> MlpTileAnyPlan:
    """The general class's layout for an actor of widths ``dims`` (see
    ``MlpTileAnyPlan``): layer l writes buffer (l + 1) & 1, so each buffer
    has the rows of what it holds (the obs padded to 8, the outputs to 16);
    in place, one buffer, where each layer is one product (below). The
    ``dem_rows`` + act + ``scratch_rows`` transient rows take the fewer
    rows of the two places the period leaves them: the buffer that H is not
    in (dead from the actor's end to the next obs), or H's from row
    pad16(act); "dead" on a tie. Then, in shared memory, ``state_words`` a
    lane and ``topo_floats``. ``group``: the M-tiles the kernel's warp
    holds at once in a hidden layer (a layer of one group is one product)."""
    stride = lanes if workspace else lanes + 8
    act, n = dims[-1], len(dims) - 1
    trans = dem_rows + act + scratch_rows
    need = [_pad8(dims[0]), 0]
    for layer, d in enumerate(dims[1:]):
        need[(layer + 1) & 1] = max(need[(layer + 1) & 1], _pad16(d))
    in_place = (all(_pad16(d) // 16 in (1, group) for d in dims[1:-1])
                and _pad16(act) == 16)
    h = n & 1   # the buffer that holds H
    if in_place:
        rows = (max(need + [_pad16(act) + trans]), 0)
        where, h = "after_h", 0
    else:
        dead = list(need)
        dead[1 - h] = max(dead[1 - h], trans)
        after = list(need)
        after[h] = max(after[h], _pad16(act) + trans)
        where, rows = (("dead", dead) if sum(dead) <= sum(after) else ("after_h", after))
        rows = tuple(rows)
    x1 = 0 if in_place else rows[0] * stride
    base = {0: 0, 1: x1}
    dem = base[1 - h] if where == "dead" else base[h] + _pad16(act) * stride
    act_floats = (rows[0] + rows[1]) * stride
    state = 0 if workspace else act_floats
    offsets = {"x0": 0, "x1": x1, "dem": dem, "z": dem + dem_rows * stride,
               "scratch": dem + (dem_rows + act) * stride, "state": state}
    return MlpTileAnyPlan(lanes, stride, rows, in_place, where, workspace, offsets, act_floats,
                          state + state_words * lanes + topo_floats)


def _tile_choice_any(dims, dem_rows: int, scratch_rows: int, state_words: int,
                     topo_floats: int = 0) -> MlpTileAnyPlan:
    """The general class's plan: the first of ``_MLP_TILES`` whose layout
    fits a block with the activations in shared memory, else the first
    with them in the workspace (a block's slice within
    WORKSPACE_MAX_BYTES). Raises ValueError past both, naming the bytes
    needed and held."""
    plans = [_mlp_tile_plan_any(dims, dem_rows, scratch_rows, state_words, lanes, topo_floats,
                                workspace) for workspace in (False, True) for lanes in _MLP_TILES]
    for plan in plans:
        if plan.floats * 4 <= SMEM_OPTIN_BYTES and 4 * plan.act_floats <= WORKSPACE_MAX_BYTES:
            return plan
    least = min(plans, key=lambda pl: (pl.floats, pl.act_floats))
    raise ValueError(
        f"actor of widths {list(dims)} with {state_words} words of state a lane: its tile needs "
        f"{least.floats * 4} bytes of shared memory beside {least.act_floats * 4} bytes of "
        f"workspace a block; a block holds {SMEM_OPTIN_BYTES} and the workspace "
        f"{WORKSPACE_MAX_BYTES}")


class _MlpTileG(ctypes.Structure):
    """Mirror of ``struct MlpTileG`` in csrc/mlp_tile.cuh (the workspace's
    pointer, then 4-byte fields)."""
    _fields_ = [("ws", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in
        ("n_layers", "table", "half_hi", "std", "lanes", "stride", "s_x0", "s_x1", "s_dem",
         "s_z", "s_scratch", "s_state", "s_total", "ws_floats", "grid")]


def _set_mlp_tile_any(st: _MlpTileG, plan: MlpTileAnyPlan) -> None:
    """Write the general class's ``plan`` into ``st`` (its grid and
    workspace are the launch's)."""
    st.lanes, st.stride = plan.lanes, plan.stride
    for name, offset in plan.offsets.items():
        setattr(st, f"s_{name}", offset)
    st.s_total = plan.floats
    st.ws_floats = plan.act_floats if plan.workspace else 0


def _int_floats(values) -> torch.Tensor:
    """Int32 ``values`` as the float32 words that hold their bits (the
    general classes' tables in the packed buffer, read as ints)."""
    return torch.from_numpy(np.asarray(values, np.int32).view(np.float32).copy())


@functools.lru_cache(maxsize=32)
def _tile_pack_plan(dims, with_std: bool, half_hi, dem_rows: int, scratch_rows: int,
                    state_words: int, device: str, topo_floats: int = 0, general: bool = False):
    """(the struct, the gather index and a zero on ``device``, and the
    general class's table words or None) of ``_pack_tile_actor``: the packed
    buffer is ``_gather_source``'s concatenation gathered by the index, then
    the table. MlpTile where the actor fits its arrays and its layout a
    block (``_fixed_tile_plan``) and ``general`` is False; else MlpTileG
    (``_tile_choice_any``). Built once per shape, so a call packs with a
    few launches."""
    plan = None if general else _fixed_tile_plan(dims, dem_rows, scratch_rows, state_words,
                                                 topo_floats)
    if plan is None:
        plan = _tile_choice_any(dims, dem_rows, scratch_rows, state_words, topo_floats)
    pairs = list(zip(dims, dims[1:]))
    w_src, b_src, std_src, zero = _gather_source(dims, with_std)
    w_at, b_at, parts, at = [], [], [], 0
    for layer, (i, o) in enumerate(pairs):
        W = torch.full((_pad16(o), _pad8(i)), zero, dtype=torch.int64)   # W^T, zero-padded
        W[:o, :i] = torch.from_numpy(w_src[layer] + np.arange(i)[None, :] * o
                                     + np.arange(o)[:, None])
        b = torch.full((_pad16(o),), zero, dtype=torch.int64)
        b[:o] = torch.from_numpy(b_src[layer] + np.arange(o))
        w_at.append(at)
        b_at.append(at + W.numel())
        parts += [_mma_fragments(W), b]
        at += W.numel() + b.numel()
    std_at = -1
    if with_std:
        std_at = at
        parts.append(torch.from_numpy(std_src + np.arange(dims[-1])))
        at += dims[-1]
    index = torch.cat(parts).to(device)
    zero_t = torch.zeros(1, dtype=torch.float32, device=device)
    if isinstance(plan, MlpTilePlan):
        st = _MlpTile(n_layers=len(pairs), std=std_at)
        for layer in range(len(pairs)):
            st.w[layer], st.b[layer] = w_at[layer], b_at[layer]
        for k, d in enumerate(dims):
            st.dims[k] = d
        for k, h in enumerate(half_hi):
            st.half_hi[k] = h
        _set_mlp_tile(st, plan)
        return st, index, zero_t, None
    # the general class: zero words to 16 bytes, the layer table (an int4
    # {in, out, w, b} a layer), then half_hi
    table = _pad4(at)
    words = [0] * (table - at)
    words += [v for i, o, w, b in zip(dims, dims[1:], w_at, b_at) for v in (i, o, w, b)]
    st = _MlpTileG(n_layers=len(pairs), table=table, half_hi=table + 4 * len(pairs), std=std_at)
    _set_mlp_tile_any(st, plan)
    tail = torch.cat([_int_floats(words), torch.tensor(half_hi, dtype=torch.float32)])
    return st, index, zero_t, tail.to(device)


def _pack_tile_actor(actor, std, obs_dim: int, act_dim: int, half_hi, device,
                     dem_rows: int = 0, scratch_rows: int = 0, state_words: int = 0,
                     topo_floats: int = 0, general: bool = False):
    """The tile kernels' actor arguments: the struct and one flat float32
    buffer on ``device``. The buffer holds each layer's W as the A
    fragments of the tensor-core product (W^T zero-padded to (pad16(out),
    pad8(in)), in ``_mma_fragments``' order) and its b padded to 16, then
    the std when given; every NaN as the quiet NaN 0x7fc00000. For an actor
    within the fixed arrays whose layout fits a block (and ``general``
    False) the struct is MlpTile, carrying their offsets, ``half_hi`` (the
    f32 factor that maps tanh(raw_i) + 1 onto action i's range), the tile
    (the first of ``_MLP_TILES`` whose layout, ``_mlp_tile_plan`` with
    ``dem_rows``, ``scratch_rows``, ``state_words`` and ``topo_floats``,
    fits a block) and the layout; for any other actor a copy of MlpTileG
    (``_tile_choice_any``'s layout, its ``actor_dims`` the widths), the
    buffer then holding the layer table and half_hi, and the launch setting
    its grid and workspace (``_tile_launch``). Cached per shape
    (``_tile_pack_plan``). Raises ValueError for an actor that does not fit
    the env, or whose state fits no block."""
    dims = _actor_dims(actor, obs_dim, act_dim)
    dev = torch.device(device)
    st, index, zero, tail = _tile_pack_plan(
        tuple(dims), std is not None, tuple(float(h) for h in half_hi), dem_rows, scratch_rows,
        state_words, _plan_key(dev) if dev.type == "cuda" else "cpu", topo_floats, general)
    flat = _quiet_nans(_gather(actor, std, index, zero, dev))
    if tail is None:
        return st, flat
    st = _MlpTileG.from_buffer_copy(st)
    st.actor_dims = tuple(dims)
    return st, torch.cat([flat, tail])


# registers a thread of the tile's instances (168-180 on sm_90a, ptxas -v,
# since the six products a k-step of csrc/mma_tf32.cuh): what the persistent
# grid of the general class counts its blocks an SM by
_TILE_REGS = 180


def _persistent_blocks(units: int, slice_floats: int, threads: int, nbytes: int, regs: int,
                       dev) -> int:
    """Blocks of a launch whose blocks each need a workspace slice of
    ``slice_floats``: at most what the card holds at once (its SMs x
    ``_blocks_per_sm``), at most ``units`` (tiles or blocks of lanes), and
    within WORKSPACE_MAX_BYTES; each walks units blockIdx.x, + blocks, ..."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = sms * max(1, _blocks_per_sm(nbytes, threads, regs))
    slots = max(1, min(slots, WORKSPACE_MAX_BYTES // (4 * slice_floats)))
    return min(units, slots)


def _set_workspace(st, blocks: int, dev) -> None:
    """Give a general-class struct ``blocks`` blocks and a workspace of a
    slice a block, allocated for this launch through PyTorch's caching
    allocator on the current stream (no cudaMalloc once the allocator holds
    the size; a launch on another stream gets its own). The struct keeps
    the tensor alive until the launch is queued; the allocator hands its
    memory on only to later work on the same stream."""
    st.grid = blocks
    st.workspace = torch.empty(blocks * st.ws_floats, dtype=torch.float32, device=dev)
    st.ws = st.workspace.data_ptr()


def _tile_launch(st, pairs: int, dev) -> str:
    """Set a general-class struct's grid (a block a tile, or the persistent
    grid over the workspace) and workspace for ``pairs`` (lane, episode)
    pairs; returns the C entry points' suffix ("" for MlpTile, "_any")."""
    if not isinstance(st, _MlpTileG):
        return ""
    tiles = -(-pairs // st.lanes)
    if st.ws_floats:
        _set_workspace(st, _persistent_blocks(tiles, st.ws_floats, st.lanes, 4 * st.s_total,
                                              _TILE_REGS, dev), dev)
    else:
        st.grid, st.ws = tiles, None
    return "_any"


# maxima of the wide actor's fixed class (csrc/wide_mlp.cuh WideMlp) and of
# the cluster's struct (csrc/cluster_mlp.cuh ClusterMlp): layers and the env's
# actions; an actor past them, or whose buffers fit no block, takes the wide
# route's general class (WideMlpG)
WIDE_MAX_LAYERS, WIDE_MAX_ACT = 8, 32
_WIDE_LANES = 32   # kWideLanes of csrc/wide_mlp.cuh: the lanes a block runs
_WIDE_THREADS = 256   # kWideThreads: a block's threads
# registers a thread of the wide instances (ptxas -v on sm_90a prints them in
# phase 2): what the persistent grid counts its blocks an SM by
_WIDE_REGS = 128


class _WideMlp(ctypes.Structure):
    """Mirror of ``struct WideMlp`` in csrc/wide_mlp.cuh."""
    _fields_ = [("n_layers", ctypes.c_int), ("dims", ctypes.c_int * (WIDE_MAX_LAYERS + 1)),
                ("rows", ctypes.c_int), ("act", ctypes.c_int), ("head", ctypes.c_int),
                ("std", ctypes.c_int), ("half_hi", ctypes.c_float * WIDE_MAX_ACT)]


def _wide_index(dims, act_dim: int, with_std: bool):
    """(the gather index of the wide buffer, the std's offset or -1): each
    layer's W^T (in, out8) then b (out8), zero-padded, then the std."""
    w_src, b_src, std_src, zero = _gather_source(dims, with_std)
    parts = []
    for layer, (i, o) in enumerate(zip(dims, dims[1:])):
        W = np.full((i, _pad8(o)), zero, np.int64)   # W^T (in, out8), zero-padded
        W[:, :o] = w_src[layer] + np.arange(i)[:, None] * o + np.arange(o)[None, :]
        b = np.full(_pad8(o), zero, np.int64)
        b[:o] = b_src[layer] + np.arange(o)
        parts += [W.reshape(-1), b]
    std = -1
    if with_std:
        std = sum(x.size for x in parts)
        parts.append(std_src + np.arange(act_dim))
    return np.concatenate(parts), std


@functools.lru_cache(maxsize=32)
def _wide_pack_plan(dims, act_dim: int, policy: str, half_hi, device: str):
    """(the WideMlp struct, the gather index and a zero on ``device``) of
    ``_pack_wide_actor``, built once per shape."""
    index, std = _wide_index(dims, act_dim, policy in ("ppo", "det"))
    rows = max([dims[0]] + [_pad8(d) for d in dims[1:]])
    st = _WideMlp(n_layers=len(dims) - 1, rows=rows, act=act_dim, head=HEADS[policy], std=std)
    for k, d in enumerate(dims):
        st.dims[k] = d
    for i, h in enumerate(half_hi):
        st.half_hi[i] = h
    return (st, torch.from_numpy(index).to(device),
            torch.zeros(1, dtype=torch.float32, device=device))


class _WideMlpG(ctypes.Structure):
    """Mirror of ``struct WideMlpG`` in csrc/wide_mlp.cuh (the workspace's
    pointer, then 4-byte fields)."""
    _fields_ = [("ws", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in
        ("n_layers", "dims", "half_hi", "rows0", "rows1", "act", "head", "std", "ws_floats",
         "grid")]


def _wide_rows_any(dims, actor: bool = True) -> tuple:
    """The general class's activation rows (buffer 0: the obs and the odd
    layers' outputs padded to 8; buffer 1: the even layers'), none where the
    head runs no actor."""
    rows = [dims[0] if actor else 0, 0]
    if actor:
        for layer, d in enumerate(dims[1:]):
            rows[(layer + 1) & 1] = max(rows[(layer + 1) & 1], _pad8(d))
    return tuple(rows)


def _wide_fits_fixed(dims, act_dim: int, extra_floats: int) -> bool:
    """Whether the wide route's fixed class (WideMlp) takes the actor: its
    arrays hold it, and its two buffers of the widest layer beside the
    family's ``extra_floats`` of shared memory fit a block."""
    rows = max([dims[0]] + [_pad8(d) for d in dims[1:]])
    return (len(dims) - 1 <= WIDE_MAX_LAYERS and act_dim <= WIDE_MAX_ACT
            and 4 * (2 * rows * _WIDE_LANES + extra_floats) <= SMEM_OPTIN_BYTES)


@functools.lru_cache(maxsize=32)
def _wide_pack_plan_any(dims, act_dim: int, policy: str, half_hi, device: str,
                        extra_floats: int = 0):
    """(the WideMlpG struct, the gather index and a zero on ``device``, the
    table words) of ``_pack_wide_actor``'s general class: the fixed class's
    layers and std, then the widths (ints) and half_hi; the buffers sized by
    layer parity (``_wide_rows_any``) in shared memory where they fit beside
    ``extra_floats``, else in the workspace. Raises ValueError where
    ``extra_floats`` alone fit no block or a block's slice exceeds
    WORKSPACE_MAX_BYTES, naming the bytes."""
    index, std = _wide_index(dims, act_dim, policy in ("ppo", "det"))
    at = int(index.size)
    rows = _wide_rows_any(dims, policy != "uniform")
    acts = (rows[0] + rows[1]) * _WIDE_LANES
    workspace = 4 * (acts + extra_floats) > SMEM_OPTIN_BYTES
    if 4 * extra_floats > SMEM_OPTIN_BYTES or 4 * acts > WORKSPACE_MAX_BYTES:
        raise ValueError(
            f"actor of widths {list(dims)}: the wide route needs {4 * extra_floats} bytes of "
            f"shared memory beside {4 * acts} bytes of activations a block; a block holds "
            f"{SMEM_OPTIN_BYTES} and the workspace {WORKSPACE_MAX_BYTES}")
    st = _WideMlpG(n_layers=len(dims) - 1, dims=at, half_hi=at + len(dims), rows0=rows[0],
                   rows1=rows[1], act=act_dim, head=HEADS[policy], std=std,
                   ws_floats=acts if workspace else 0)
    tail = torch.cat([_int_floats(dims), torch.tensor(half_hi, dtype=torch.float32)])
    return (st, torch.from_numpy(index).to(device),
            torch.zeros(1, dtype=torch.float32, device=device), tail.to(device))


def _pack_wide_actor(actor, std, obs_dim: int, act_dim: int, policy: str, half_hi, device,
                     extra_floats: int = 0, noise_rows: bool = False, general: bool = False):
    """The wide kernels' actor arguments: the struct (the head, ``half_hi[i]``
    the f32 factor that maps a_norm_i + 1 onto action i's range) and one
    flat float32 buffer on ``device``, each layer as W^T (in, out8) then b
    (out8), the outputs zero-padded to a multiple of 8, then the std when
    the head takes one ("ppo", "det"). WideMlp where ``_wide_fits_fixed``
    (the family keeping ``extra_floats`` of shared memory a block beside
    the activations); else a copy of WideMlpG (``_wide_pack_plan_any``,
    with a row of head noise a lane and action beside ``extra_floats`` when
    ``noise_rows``: K29's), the buffer then holding the widths and half_hi,
    the launch setting its grid and workspace (``_wide_launch``); WideMlpG
    too where ``general`` (tools/actor_sweep.py times the two classes on one
    actor). The layouts and gather indices are cached per shape, so a call
    packs with one cat and one index.
    Raises ValueError for an actor that does not fit the env, or past the
    general class's bounds."""
    dims = _head_dims(actor, obs_dim, act_dim, policy)
    dev = torch.device(device)
    key = _plan_key(dev) if dev.type == "cuda" else "cpu"
    hi = tuple(float(h) for h in half_hi[:act_dim])
    if not general and _wide_fits_fixed(dims, act_dim, extra_floats):
        st, index, zero = _wide_pack_plan(tuple(dims), act_dim, policy, hi, key)
        return st, _gather(actor, std if st.std >= 0 else None, index, zero, dev)
    extra = int(extra_floats) + (act_dim * _WIDE_LANES if noise_rows else 0)
    st, index, zero, tail = _wide_pack_plan_any(tuple(dims), act_dim, policy, hi, key, extra)
    flat = _gather(actor, std if st.std >= 0 else None, index, zero, dev)
    return _WideMlpG.from_buffer_copy(st), torch.cat([flat, tail])


def _wide_launch(st, batch: int, dev) -> str:
    """Set a WideMlpG's grid (a block per 32 lanes, or the persistent grid
    over the workspace) and workspace for ``batch`` lanes; returns the C
    entry points' suffix ("" for WideMlp, "_any")."""
    if not isinstance(st, _WideMlpG):
        return ""
    blocks = -(-batch // _WIDE_LANES)
    if st.ws_floats:
        _set_workspace(st, _persistent_blocks(blocks, st.ws_floats, _WIDE_THREADS, 0,
                                              _WIDE_REGS, dev), dev)
    else:
        st.grid, st.ws = blocks, None
    return "_any"


# ------------------------- the off-policy actor over a cluster (K27, K28, K29)

# csrc/cluster_mlp.cuh: threads a CTA (16 warps) and the portable cluster size
_CLUSTER_THREADS, CLUSTER_MAX_SIZE = 512, 8
# the (CTAs a cluster, lanes a tile) that the entry points try for an actor,
# in order: the first whose CTA fits the shared memory of a block; if none
# does, the wrapper takes the wide route (csrc/wide_mlp.cuh). Four CTAs over
# 64 lanes is the fastest FP32 tile of K27 and K28 at 65,536 lanes
# (tools/wide_cluster_sweep.py, PERF.md). At the learners' 1,024 lanes eight
# over 96 ran K27 3% faster (K28 no faster) but 21% slower at 65,536: not
# kept, since a tile chosen by the batch is a second layout to hold for 3%
_CLUSTER_TILES = ((4, 64), (4, 32), (8, 64), (8, 32))
# "uniform" runs no actor: one CTA a cluster of 64 lanes, or 32 where its
# demand and noise rows would not fit
_CLUSTER_UNIFORM_LANES = (64, 32)


class _ClusterMlp(ctypes.Structure):
    """Mirror of ``struct ClusterMlp`` in csrc/cluster_mlp.cuh (all fields
    4-byte, so both sides lay it out without padding)."""
    _fields_ = [("n_layers", ctypes.c_int), ("dims", ctypes.c_int * (WIDE_MAX_LAYERS + 1)),
                ("kin", ctypes.c_int * WIDE_MAX_LAYERS), ("rows", ctypes.c_int * WIDE_MAX_LAYERS),
                ("ws", ctypes.c_int * WIDE_MAX_LAYERS), ("w", ctypes.c_int * WIDE_MAX_LAYERS),
                ("b", ctypes.c_int * WIDE_MAX_LAYERS), ("std", ctypes.c_int),
                ("block", ctypes.c_int), ("act", ctypes.c_int), ("head", ctypes.c_int),
                ("cluster", ctypes.c_int), ("lanes", ctypes.c_int), ("lanes_cta", ctypes.c_int),
                ("stride", ctypes.c_int), ("s_xo", ctypes.c_int), ("s_x0", ctypes.c_int),
                ("s_x1", ctypes.c_int), ("s_xl", ctypes.c_int), ("s_red", ctypes.c_int),
                ("s_h", ctypes.c_int),
                ("s_dem", ctypes.c_int), ("s_z", ctypes.c_int), ("s_q", ctypes.c_int),
                ("s_state", ctypes.c_int), ("state_words", ctypes.c_int),
                ("floats", ctypes.c_int), ("clusters", ctypes.c_int),
                ("half_hi", ctypes.c_float * WIDE_MAX_ACT)]


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """One launch's layout of csrc/cluster_mlp.cuh: ``cluster`` CTAs a
    cluster run a tile of ``lanes`` lanes, ``lanes_cta`` a CTA; per layer
    its input rows ``kin`` (pad8(obs_dim), then the padded widths), the
    rows ``rows`` a CTA holds (a hidden layer's width padded to 16 C, over
    C; the output layer's pad8(outputs), whole), the row stride ``ws`` of
    its W slice (rows + the layout's pad for a hidden layer; ``stride``,
    the activations', is lanes + the pad) and the float offsets ``w``
    and ``b`` of its W slice ([k][ws]) and bias in a CTA's block of
    ``block`` floats, then the std at ``std`` (or -1): a hidden layer's R
    rows are its width padded to 16 C, over C. In shared memory,
    the block at 0, then the regions ``offsets`` (xo, the tile's obs, and
    x0 and x1, the outputs of the hidden layers but the last, [row][stride],
    as many as they need, up to two; xl, the last hidden layer's outputs for
    the CTA's lanes; red, the output layer's partial sums (32 groups x 8 x
    the CTA's lanes); h, the CTA's
    lanes' outputs (red and h inside x0 under the layout's out_in_x0, where
    x0 holds them); dem and z, the lanes' demand [lane][T][dem_rows] and
    head noise [lane][T][act] ([lane][act] under noise_per_period); q, K28's
    Poisson anchors; state, ``state_words`` a lane), ``floats`` in all.
    Every region starts on 16 bytes."""
    cluster: int
    lanes: int
    lanes_cta: int
    stride: int
    kin: tuple
    rows: tuple
    ws: tuple
    w: tuple
    b: tuple
    std: int
    block: int
    state_words: int
    offsets: dict
    floats: int


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


@dataclasses.dataclass(frozen=True)
class ClusterLayout:
    """What a family's cluster kernel keeps a CTA beside the actor, as
    ``_cluster_plan`` lays it out: ``dem_rows`` demands a (lane, period);
    ``pad`` floats past each row of the hidden layers' W slices and of the
    activations (8 keeps the A fragment loads of a 3xTF32 form on 32
    banks; the FP32 products' loads are conflict-free at 0);
    ``out_in_x0``, the output layer's partial sums and outputs in x0, which
    is dead from the last hidden layer's barrier to the next period's obs
    barrier, where it holds them; ``noise_per_period``, the head's noise of
    one period a lane (drawn each period) rather than the episode's (drawn
    at the reset; "uniform" keeps the episode's); ``topo_floats``, floats a
    CTA keeps after its last region (K29: the topology's records)."""
    dem_rows: int = 1
    pad: int = 8
    out_in_x0: bool = False
    noise_per_period: bool = False
    topo_floats: int = 0


# K27 and K28's layout; K29's (``net_step._net_cluster_layout``) keeps one
# demand a retail link, no padding, the output layer in x0 and a period's
# noise, which is what lets 4 CTAs hold 64 lanes of its (68, 256, 256, 11)
# actor (tools/net_traj_sweep.py, PERF.md)
_K27_LAYOUT = ClusterLayout()


def _cluster_plan(dims, act_dim: int, with_std: bool, T: int, state_words: int,
                  anchors: bool, cluster: int, lanes: int, actor: bool = True,
                  layout: ClusterLayout = _K27_LAYOUT) -> ClusterPlan:
    """The layout of a cluster of ``cluster`` CTAs over a tile of ``lanes``
    lanes for an actor of widths ``dims`` (``actor`` False: the "uniform"
    head, no weights and no activations), a horizon of ``T``,
    ``state_words`` words of state a lane (K27: on-hand and the ring of
    requested orders, obs_dim; K28: econ, the pipeline and its head,
    obs_dim + 1; K29: net_step._shared_layout's words with the step's
    scratch), the family's ``layout`` (``ClusterLayout``) and, when
    ``anchors``, K28's Poisson anchors. Raises
    ValueError for a tile the kernels do not take: lanes a multiple of 32
    (of 16 per n-tile pair and 32 per FP32 warp item), an even number of
    lanes a CTA (the float2 stores), at most a thread each."""
    lanes_cta = lanes // cluster
    if not (1 <= cluster <= CLUSTER_MAX_SIZE and lanes % 32 == 0 and lanes_cta * cluster == lanes
            and lanes_cta <= _CLUSTER_THREADS and lanes_cta % 2 == 0):
        raise ValueError(f"no cluster tile of {cluster} CTAs over {lanes} lanes")
    stride = lanes + layout.pad
    kin, rows, ws, w, b = [], [], [], [], []
    at, obs_rows, full, last_rows, out_rows, std = 0, 0, [], 0, 0, -1
    if actor:
        k = _pad8(dims[0])
        for layer, out in enumerate(dims[1:]):
            if layer < len(dims) - 2:
                width = -(-out // (16 * cluster)) * 16 * cluster
                R, RS = width // cluster, width // cluster + layout.pad
            else:
                width = R = RS = _pad8(out)
            kin.append(k)
            rows.append(R)
            ws.append(RS)
            w.append(at)
            at = _pad4(at + k * RS)
            b.append(at)
            at = _pad4(at + R)
            k = width
        if with_std:
            std = at
            at = _pad4(at + act_dim)
        # the hidden layers' outputs but the last's, whole; the last's for the
        # CTA's lanes
        full, last_rows = kin[1:-1], (kin[-1] if len(kin) > 1 else 0)
        obs_rows, out_rows = kin[0], rows[-1]
    x_rows = max(full, default=0)
    noise_rows = 1 if layout.noise_per_period and actor else T
    out_sizes = {"red": 32 * 8 * lanes_cta if actor else 0, "h": _pad4(out_rows * lanes_cta)}
    in_x0 = layout.out_in_x0 and x_rows * stride >= sum(out_sizes.values())
    sizes = {"xo": obs_rows * stride, "x0": x_rows * stride,
             "x1": x_rows * stride if len(full) > 1 else 0, "xl": last_rows * lanes_cta,
             **({"red": 0, "h": 0} if in_x0 else out_sizes),
             "dem": _pad4(lanes_cta * T * layout.dem_rows),
             "z": _pad4(lanes_cta * noise_rows * act_dim), "q": 4 * lanes_cta if anchors else 0,
             "state": _pad4(lanes_cta * state_words)}
    offsets, floats = {}, at
    for name, size in sizes.items():
        offsets[name] = floats
        floats += size
    floats += layout.topo_floats
    if in_x0:
        offsets["red"] = offsets["x0"]
        offsets["h"] = offsets["x0"] + out_sizes["red"]
    return ClusterPlan(cluster, lanes, lanes_cta, stride, tuple(kin), tuple(rows), tuple(ws),
                       tuple(w), tuple(b), std, at, state_words, offsets, floats)


def _cluster_choice(dims, act_dim: int, with_std: bool, T: int, state_words: int,
                    anchors: bool, actor: bool = True, layout: ClusterLayout = _K27_LAYOUT):
    """The entry points' plan (``_cluster_plan``'s arguments): for an
    actor, the first of ``_CLUSTER_TILES`` whose CTA fits the shared memory
    of a block; for "uniform" (no actor) one CTA a cluster with the first
    of ``_CLUSTER_UNIFORM_LANES`` lanes that fits. None when nothing fits:
    then K27-K29 take the wide route (csrc/wide_mlp.cuh), decided from the
    sizes before any launch."""
    tiles = _CLUSTER_TILES if actor else [(1, n) for n in _CLUSTER_UNIFORM_LANES]
    for cluster, lanes in tiles:
        plan = _cluster_plan(dims, act_dim, with_std, T, state_words, anchors, cluster, lanes,
                             actor, layout)
        if plan.floats * 4 <= SMEM_OPTIN_BYTES:
            return plan
    return None


def _cluster_index(dims, act_dim: int, with_std: bool, plan: ClusterPlan) -> np.ndarray:
    """The gather index of the packed buffer (C blocks of ``plan.block``
    floats, rank r's at r block) into ``_gather_source``'s concatenation:
    rank r's rows of each hidden layer's W^T as [k][ws] and of its b, the
    output layer's W^T [k][pad8(outputs)] and b whole, the std; the zero
    everywhere else (padded rows and columns)."""
    w_src, b_src, std_src, zero = _gather_source(dims, with_std)
    index = np.full((plan.cluster, plan.block), zero, np.int64)
    for layer, (i, o) in enumerate(zip(dims, dims[1:])):
        R, RS = plan.rows[layer], plan.ws[layer]
        for r in range(plan.cluster):
            first = r * R if layer < len(dims) - 2 else 0
            cols = np.arange(first, min(first + R, o)) if first < o else np.arange(0)
            c = cols - first
            Wi = w_src[layer] + np.arange(i)[:, None] * o + cols[None, :]
            index[r, plan.w[layer] + np.arange(i)[:, None] * RS + c[None, :]] = Wi
            index[r, plan.b[layer] + c] = b_src[layer] + cols
    if with_std:
        index[:, plan.std:plan.std + act_dim] = std_src + np.arange(act_dim)
    return index.reshape(-1)


def _cluster_struct(dims, act_dim: int, policy: str, half_hi, plan: ClusterPlan) -> _ClusterMlp:
    """The ClusterMlp struct of ``plan`` for an actor of widths ``dims``
    under ``policy``'s head (its ``clusters`` left for the launch)."""
    st = _ClusterMlp(n_layers=len(dims) - 1, std=plan.std, block=plan.block, act=act_dim,
                     head=HEADS[policy], cluster=plan.cluster, lanes=plan.lanes,
                     lanes_cta=plan.lanes_cta, stride=plan.stride,
                     state_words=plan.state_words, floats=plan.floats)
    for k, d in enumerate(dims):
        st.dims[k] = d
    for name in ("kin", "rows", "ws", "w", "b"):
        for k, v in enumerate(getattr(plan, name)):
            getattr(st, name)[k] = v
    for name, offset in plan.offsets.items():
        setattr(st, f"s_{name}", offset)
    for i, h in enumerate(half_hi):
        st.half_hi[i] = h
    return st


@functools.lru_cache(maxsize=32)
def _cluster_pack_plan(dims, act_dim: int, policy: str, half_hi, T: int, state_words: int,
                       anchors: bool, device: str, layout: ClusterLayout = _K27_LAYOUT):
    """(the ClusterMlp struct, the gather index and a zero on ``device``) of
    ``_pack_cluster_actor`` at ``_cluster_choice``'s tile, built once per
    shape; None for the wide route."""
    actor = policy != "uniform"
    with_std = policy in ("ppo", "det")
    plan = _cluster_choice(dims, act_dim, with_std, T, state_words, anchors, actor, layout)
    if plan is None:
        return None
    st = _cluster_struct(dims, act_dim, policy, half_hi, plan)
    zero = torch.zeros(1, dtype=torch.float32, device=device)
    if not actor:
        return st, None, zero
    index = _cluster_index(dims, act_dim, with_std, plan)
    return st, torch.from_numpy(index).to(device), zero


def _pack_cluster_actor(actor, std, obs_dim: int, act_dim: int, policy: str, half_hi, T: int,
                        state_words: int, anchors: bool, device,
                        layout: ClusterLayout = _K27_LAYOUT):
    """K27-K29's actor arguments on the cluster (csrc/cluster_mlp.cuh): a
    copy of the ClusterMlp struct (its ``clusters`` left for the launch)
    and one flat float32 buffer on ``device``, C blocks of ``block`` floats
    (``_cluster_index``), gathered with one cat and one index from the
    layout cached per shape (``_cluster_pack_plan``; ``T``,
    ``state_words``, ``anchors`` and ``layout`` as ``_cluster_plan``
    takes them), at
    the entry points' tile (``_cluster_choice``). Returns None when no
    cluster tile fits, or the actor has more than WIDE_MAX_LAYERS layers or
    WIDE_MAX_ACT actions (ClusterMlp's arrays): the wide route, whose
    general class takes any actor."""
    dims = _head_dims(actor, obs_dim, act_dim, policy)
    if len(dims) - 1 > WIDE_MAX_LAYERS or act_dim > WIDE_MAX_ACT:
        return None
    dev = torch.device(device)
    plan = _cluster_pack_plan(tuple(dims), act_dim, policy,
                              tuple(float(h) for h in half_hi[:act_dim]), int(T),
                              int(state_words), bool(anchors),
                              _plan_key(dev) if dev.type == "cuda" else "cpu", layout)
    if plan is None:
        return None
    st, index, zero = plan
    st = _ClusterMlp.from_buffer_copy(st)
    if index is None:   # "uniform": no actor
        return st, zero
    return st, _gather(actor, std if st.std >= 0 else None, index, zero, dev)


def _cluster_grid(tiles: int, max_active: int) -> int:
    """The persistent grid's clusters: one a tile, at most ``max_active``
    (what the card holds at once). Raises RuntimeError when it holds none."""
    if max_active < 1:
        raise RuntimeError("the card holds no cluster of this launch's CTAs at once")
    return min(tiles, max_active)


@functools.lru_cache(maxsize=64)
def _cluster_max_active(lib_name: str, fn_name: str, cluster: int, floats: int, flags: tuple,
                        device: str) -> int:
    """The clusters the card holds at once for a launch of ``fn_name``'s
    instance (``flags``: relu[, backlog]) with ``cluster`` CTAs of
    ``floats`` floats of shared memory, from
    cudaOccupancyMaxActiveClusters; cached per card."""
    from or_gym_inventory_torch.ops import _build
    st = _ClusterMlp(cluster=cluster, floats=floats)
    out = ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        rc = getattr(_build.library(lib_name), fn_name)(ctypes.addressof(st), *flags,
                                                         ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc}: {_build.error_string(lib_name, rc)}")
    return out.value


def _set_cluster_grid(st: _ClusterMlp, batch: int, lib_name: str, fn_name: str, flags,
                      dev) -> None:
    """Write the persistent grid's clusters for ``batch`` lanes into ``st``."""
    max_active = _cluster_max_active(lib_name, fn_name, st.cluster, st.floats, tuple(flags),
                                      _plan_key(dev))
    st.clusters = _cluster_grid(-(-batch // st.lanes), max_active)


def _offpolicy_std(policy: str, log_std):
    """The std the head takes: clipped_std(log_std) for "ppo" and "det"
    (which raise ValueError without one), None for "sac" and "uniform"."""
    if policy not in ("ppo", "det"):
        return None
    if log_std is None:
        raise ValueError(f"the {policy!r} head samples around the actor: log_std is required")
    return clipped_std(torch.as_tensor(log_std).detach())


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
def _im_host_plan(params: im.InvManagementParams, device: str, with_demand: bool = True):
    """What the plain versions and the kernels both take, built once per
    (params, device): the f32 alpha^t table (as a list and on ``device``),
    and with ``with_demand`` the demand's plan: the CDF table on ``device``
    ((inf,) when empty, which inverts to 0), its base, and USER mode's
    per-period values. K7 reads no demand plan, so any law runs there. No
    size cap applies: the plain versions run any params the JAX package
    runs."""
    T = params.periods
    spec = _im_demand_spec(params) if with_demand else None
    user = with_demand and spec is None
    base, table = spec if spec is not None else (0, ())
    discs = _discounts(params.alpha, T)
    user_d = [int(params.user_D[t]) if t < len(params.user_D) else 0 for t in range(T)]
    return dict(discs=discs, user=user, base=int(base), tab_len=len(table),
                disc=torch.tensor(discs, dtype=torch.float32, device=device),
                table=torch.tensor(table or (float("inf"),), dtype=torch.float32,
                                   device=device),
                user_d=torch.tensor(user_d, dtype=torch.int32, device=device))


class _ImParamsG(ctypes.Structure):
    """Mirror of ``struct ImParamsG`` in csrc/im_step.cuh: the chain route's
    records and (the LSTM kernels') state workspace on the card, then 4-byte
    fields."""
    _fields_ = [("rec", ctypes.c_void_p), ("ws", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in
        ("m1", "lt", "user", "tab_len", "base", "rec_words", "state_words", "ws_stride")]


def _im_fixed(m1: int, lt: int) -> bool:
    """Whether params of ``m1`` stocked stages and lead times up to ``lt``
    fit ImParams's arrays: the parent's route; any other takes the chain
    route."""
    return m1 <= IM_MAX_M1 and lt <= IM_MAX_LT


def _im_record_words(m1: int) -> int:
    """Words of the chain route's records (csrc/im_step.cuh im_stage_records):
    c, L, I0, h, act_span and half_c of m1 stages, gain and k of m1 + 1."""
    return 8 * m1 + 2


def _im_lane_words(m1: int, lt: int, policy: bool = True) -> int:
    """Words of a chain lane's column (csrc/im_step.cuh im_lane): on-hand
    (m1), backlog (m1 + 1), the ring of fulfilled orders (lt m1) and the
    actions (m1); for the policy kernels (``policy``) also the ring of
    requested orders (lt m1) and a float an action (the wide route's head
    noise, the LSTM's raw samples)."""
    return 3 * m1 + 1 + lt * m1 + (lt * m1 + m1 if policy else 0)


def _im_records(params: im.InvManagementParams) -> torch.Tensor:
    """The chain route's records as int32 words (floats as their bits), in
    im_stage_records' order: c, L, I0, gain, k, h, act_span, half_c."""
    m1 = params.m1
    up, uc = params.unit_price, params.unit_cost
    ints = np.array([*params.c[:m1], *params.L[:m1], *params.I0[:m1]], np.int32)
    floats = np.array([*(np.float32(float(up[i]) - float(uc[i])) for i in range(m1 + 1)),
                       *(np.float32(params.k[i]) for i in range(m1 + 1)),
                       *params.holding_cost_vec[:m1],
                       *(np.float32(params.c[i] + 1) for i in range(m1)),
                       *_half_c(params)], np.float32)
    words = np.concatenate([ints, floats.view(np.int32)])
    assert words.size == _im_record_words(m1)
    return torch.from_numpy(words)


@functools.lru_cache(maxsize=32)
def _im_plan(params: im.InvManagementParams, device: str, with_demand: bool = True):
    """A launch's host-built arguments: ``_im_host_plan``, the params struct
    of the CUDA kernels and K8's and K7's layouts. Params within the struct
    maxima pack ImParams (``chain`` False), the parent's struct; any other
    takes the chain route (``chain`` True): ImParamsG, its records copied to
    ``device`` (kept as ``rec``). Raises ValueError where a lane's state
    (``_im_lane_words``, the policy kernels') and the records fit no block
    of 32 lanes, naming the words needed and held."""
    m1, lt = params.m1, params.lt_max
    chain = not _im_fixed(m1, lt)
    if chain:
        rec_words, words = _im_record_words(m1), _im_lane_words(m1, lt)
        held = (SMEM_OPTIN_BYTES // 4 - rec_words) // 32
        if words > held:
            raise ValueError(
                f"InvManagement params of m1={m1} stocked stages and lt_max={lt}: a lane's state "
                f"takes {words} words; a block of 32 lanes holds {held} words a lane beside the "
                f"{rec_words} words of records")
    host = _im_host_plan(params, device, with_demand)
    if chain:
        rec = _im_records(params).to(device)
        st = _ImParamsG(rec=rec.data_ptr(), m1=m1, lt=lt, user=int(host["user"]),
                        tab_len=host["tab_len"], base=host["base"], rec_words=rec_words,
                        state_words=words)
        fused = _im_fused_plan(m1, lt, True)
        return dict(host, struct=st, rec=rec, chain=True,
                    fused=_ImSmem(threads=fused.threads, words=fused.words),
                    k7=_im_k7_plan(m1, lt, chain=True).struct())
    st = _ImParams(m1=m1, lt=lt, user=int(host["user"]), tab_len=host["tab_len"],
                   base=host["base"])
    up, uc, hv = params.unit_price, params.unit_cost, params.holding_cost_vec
    for i in range(m1):
        st.c[i], st.L[i], st.I0[i] = params.c[i], params.L[i], params.I0[i]
        st.h[i], st.act_span[i] = float(hv[i]), float(np.float32(params.c[i] + 1))
    for i in range(params.num_stages):
        st.gain[i] = float(np.float32(float(up[i]) - float(uc[i])))
        st.k[i] = float(np.float32(params.k[i]))
    fused = _im_fused_plan(m1, lt)
    return dict(host, struct=st, chain=False,
                fused=_ImSmem(threads=fused.threads, words=fused.words),
                k7=_im_k7_plan(m1, lt).struct())


def _im_fn(plan, name: str, suffix: str = "") -> str:
    """The C entry point ``name`` of ``plan``'s route: ``name`` + "_chain"
    on the chain route, else ``name`` + ``suffix`` (the actor class's,
    ``_tile_launch``'s or ``_wide_launch``'s)."""
    return name + ("_chain" if plan["chain"] else suffix)


def _blocks_per_sm(nbytes: int, threads: int, regs: int) -> int:
    """Resident blocks of ``threads`` an H100 SM holds with ``nbytes`` of
    shared memory a block and ``regs`` registers a thread (allocated to
    each warp in multiples of 8 a thread)."""
    warps_by_regs = REGS_PER_SM // (32 * (-(-regs // 8) * 8))
    return min(SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK_RESERVED), warps_by_regs // (threads // 32),
               THREADS_PER_SM // threads, BLOCKS_PER_SM)


class _ImSmem(ctypes.Structure):
    """Mirror of ``struct ImSmem`` in csrc/im_episode.cu."""
    _fields_ = [("threads", ctypes.c_int), ("words", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class ImFusedPlan:
    """K8's launch: ``threads`` a block, ``words`` of ring a thread (lt m1,
    [word][thread] in dynamic shared memory), ``bytes`` a block, resident
    ``blocks_per_sm``."""
    threads: int
    words: int
    bytes: int
    blocks_per_sm: int


# the registers a thread of K8's instance for each m1 (csrc/im_episode.cu,
# the stage loops unrolled to exactly m1; the most ptxas -v reports on
# sm_90a for backlog and lost sales, which phase 2 of chip_smoke.py
# checks), of its chain route's looped kernel (k_im_returns_fused_chain;
# phase 55 checks it); the largest block the plan tries
_IM_FUSED_REGS = {1: 32, 2: 32, 3: 32, 4: 40, 5: 44, 6: 46, 7: 47, 8: 54}
_IM_FUSED_CHAIN_REGS = 47
_IM_FUSED_MAX_THREADS = 256


@functools.lru_cache(maxsize=64)
def _im_fused_plan(m1: int, lt: int, chain: bool = False) -> ImFusedPlan:
    """The block size, among multiples of 32 up to 256, at which an SM holds
    the most threads of K8 (the smallest such block, for the fullest last
    wave) with ``lt * m1`` words of ring a thread, counting the SM's shared
    memory, registers (``_IM_FUSED_REGS`` a thread of the instance for
    this m1), threads and blocks. Every (m1, lt) within the struct maxima
    fits a block of 32 (256 words, 32 KB). On the chain route (``chain``)
    a thread's column holds ``_im_lane_words(m1, lt, False)`` words and the
    block the records beside them; raises ValueError where no block of 32
    holds them, naming the words."""
    words = _im_lane_words(m1, lt, False) if chain else lt * m1
    rec = _im_record_words(m1) if chain else 0
    regs = _IM_FUSED_CHAIN_REGS if chain else _IM_FUSED_REGS[m1]
    best = None
    for threads in range(32, _IM_FUSED_MAX_THREADS + 1, 32):
        nbytes = 4 * (words * threads + rec)
        if nbytes > SMEM_OPTIN_BYTES:
            break
        plan = ImFusedPlan(threads, words, nbytes, _blocks_per_sm(nbytes, threads, regs))
        if best is None or plan.blocks_per_sm * threads > best.blocks_per_sm * best.threads:
            best = plan
    if best is None:
        raise ValueError(f"K8's column of {words} words a thread and {rec} words of records fit "
                         f"no block of 32 threads ({SMEM_OPTIN_BYTES} bytes)")
    return best


class _ImStage(ctypes.Structure):
    """Mirror of ``struct ImStage`` in csrc/im_episode.cu: K7's threads a
    block, words a thread, first staging word and periods a buffer."""
    _fields_ = [(name, ctypes.c_int) for name in ("threads", "words", "stage", "chunk")]


@dataclasses.dataclass(frozen=True)
class ImK7Plan:
    """K7's launch: the ring of ``stage`` (lt m1) words a thread, then two
    staging buffers of ``chunk`` periods of m1 + 1 words (the actions, then
    the demand), ``words`` a thread in all, [word][thread] in dynamic
    shared memory at ``threads`` a block: ``bytes`` a block, resident
    ``blocks_per_sm`` by shared memory, threads and blocks."""
    threads: int
    words: int
    stage: int
    chunk: int
    bytes: int
    blocks_per_sm: int

    def struct(self) -> _ImStage:
        return _ImStage(threads=self.threads, words=self.words, stage=self.stage,
                        chunk=self.chunk)


# K7's layouts in order of preference: periods a staging buffer, then
# threads a block; the plan takes the first at which an SM holds
# IM_K7_RESIDENT threads, else the one at which it holds the most. On an
# H100 four periods a buffer ran 10% faster than one at the defaults (m1 =
# 3, lt 10; 3 to 21 blocks an SM, every block size within 1%), but at the
# struct maxima (m1 = 8, lt 32) 128 threads an SM ran 17% slower than 192
# (tools/k3_k7_sweep.py).
IM_K7_CHUNKS = (4, 2, 1)
IM_K7_THREADS = (128, 64, 32)
IM_K7_RESIDENT = 256


def _im_k7_layout(m1: int, lt: int, chunk: int, threads: int, chain: bool = False):
    """K7's layout at ``chunk`` periods a buffer and ``threads`` a block, or
    None where the block exceeds the shared memory a block may opt in to.
    On the chain route the ring's place holds the thread's state column
    (on-hand, backlog and the ring, im_lane) and the block the records."""
    ring = (_im_lane_words(m1, lt, False) - m1) if chain else lt * m1
    words = ring + 2 * chunk * (m1 + 1)
    nbytes = 4 * (words * threads + (_im_record_words(m1) if chain else 0))
    if nbytes > SMEM_OPTIN_BYTES:
        return None
    blocks = min(SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK_RESERVED), THREADS_PER_SM // threads,
                 BLOCKS_PER_SM)
    return ImK7Plan(threads, words, ring, chunk, nbytes, blocks)


@functools.lru_cache(maxsize=64)
def _im_k7_plan(m1: int, lt: int, chunk: int = None, threads: int = None,
                chain: bool = False) -> ImK7Plan:
    """K7's shared memory for ``m1`` stocked stages and lead-time ring depth
    ``lt``: the ring's lt m1 words (on the chain route, ``chain``, the
    thread's state column, ``_im_k7_layout``), then 2 x ``chunk`` x (m1 + 1)
    staging words a thread, at ``threads`` a block; either left None is
    chosen from ``IM_K7_CHUNKS`` / ``IM_K7_THREADS`` (the first layout that
    holds ``IM_K7_RESIDENT`` threads an SM, else the first that holds the
    most). Raises ValueError where no block holds a layout."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"K7 stages at least one period a buffer, got {chunk}")
    layouts = [_im_k7_layout(m1, lt, c, n, chain)
               for c in (IM_K7_CHUNKS if chunk is None else (chunk,))
               for n in (IM_K7_THREADS if threads is None else (threads,))]
    layouts = [plan for plan in layouts if plan is not None]
    if not layouts:
        ring = (_im_lane_words(m1, lt, False) - m1) if chain else lt * m1
        raise ValueError(f"K7's ring of {ring} words and its staging fit no block "
                         f"(chunk {chunk or IM_K7_CHUNKS}, threads {threads or IM_K7_THREADS})")
    return max(layouts, key=lambda plan: min(plan.blocks_per_sm * plan.threads, IM_K7_RESIDENT))


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
    plan = _im_host_plan(params, str(device))
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


def _im_policy_period_plain(params, plan, layers, std, seed, lanes, episodes, t,
                            inv, AH, policy="ppo", act_name="tanh"):
    """Demand, raw samples and int actions of period ``t`` of the policy
    kernels (csrc/im_policy.cu ``policy_period``, and K27's period) for every
    (lane, episode): one demand word under key (seed, 1), then the head's
    words (``_head_words``: none for the deterministic PPO head); the actor
    on ``_im_obs_rows``; the action (int)((a_norm + 1) * f32(0.5 c_i))
    (pallas_episode_kernels.py :1149-1167, :1666-1671). Returns (demand,
    stored (m1, N), [m1 int32 action rows])."""
    m1 = params.m1
    n_head = _head_words(policy, m1, std is not None)
    words = rng.period_words(seed, lanes, episodes, t, 1 + n_head, key1=rng.POLICY_KEY)
    d = _im_demand_plain(plan, words[0], t)
    obs = _im_obs_rows(params, t, inv, AH)
    if not n_head:
        raw = mlp_forward(layers, "tanh", obs)
        a_norm = torch.tanh(raw)
    else:
        raw, a_norm = traj_policy(policy, act_name, m1, layers, std, obs,
                                  _head_noise(policy, words[1:]))
    S = a_norm + 1.0
    half_c = _half_c(params)
    return d, raw, [im.trunc_i32(S[i] * half_c[i]) for i in range(m1)]


def _rollout_traj_im_plain(params, actor, std, seed, batch, device, policy="ppo",
                           act_name="tanh"):
    """Plain version of K10 (and, with another head or trunk, of K27): the
    streams of one stochastic-policy episode per lane, as
    ``rollout_traj_im`` returns them."""
    m1, lt, T = params.m1, params.lt_max, params.periods
    plan = _im_host_plan(params, str(device))
    layers = kernel_layers(actor, device)
    std = None if std is None else std.to(device)
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
        out["inv"][t] = torch.stack(inv)
        d, raw, acts = _im_policy_period_plain(params, plan, layers, std, seed, lanes, 0,
                                               t, inv, AH, policy, act_name)
        out["raw"][t], out["actions"][t] = raw, torch.stack(acts)
        inv, bkl, RH, r_req, profit = _im_step_math(params, t, inv, bkl, RH, acts, d)
        if lt:
            AH = r_req + AH[: (lt - 1) * m1]
        out["reward"][t] = plan["discs"][t] * profit
        out["demand"][t] = d
    out["inv"][T] = torch.stack(inv)
    return out


def _im_policy_plain(params, actor, std, seed, batch, E, device, dump=False):
    """Plain version of K11 (and, with ``dump``, K12): returns (E, B), and
    the int32 actions (T, E, m1, B) and demand (T, E, B) they came from
    (None without ``dump``). ``std`` None is the deterministic policy. All
    E * B episodes run at once, episode-major, each with its own counter."""
    m1, lt, T = params.m1, params.lt_max, params.periods
    plan = _im_host_plan(params, str(device))
    layers = kernel_layers(actor, device)
    std = None if std is None else std.to(device)
    idx = torch.arange(E * batch, dtype=torch.int64, device=device)
    episodes, lanes = idx // batch, idx % batch
    i32 = dict(dtype=torch.int32, device=device)
    acts = torch.empty((T, E, m1, batch), **i32) if dump else None
    dems = torch.empty((T, E, batch), **i32) if dump else None
    inv, bkl, RH = _im_reset_rows(params, E * batch, device)
    AH = list(RH)
    total = torch.zeros(E * batch, dtype=torch.float32, device=device)
    for t, disc in enumerate(plan["discs"]):
        d, _raw, act = _im_policy_period_plain(params, plan, layers, std, seed, lanes,
                                               episodes, t, inv, AH)
        if dump:
            acts[t] = torch.stack(act).reshape(m1, E, batch).transpose(0, 1)
            dems[t] = d.reshape(E, batch)
        inv, bkl, RH, r_req, profit = _im_step_math(params, t, inv, bkl, RH, act, d)
        if lt:
            AH = r_req + AH[: (lt - 1) * m1]
        total = total + disc * profit
    return total.reshape(E, batch), acts, dems


# ------------------------------------------------------------------ wrappers

def _im_tile_actor(params: im.InvManagementParams, actor, std, device, general: bool = False):
    """The actor arguments of K10-K12 on the tensor-core tile
    (``_pack_tile_actor`` at the env's obs and act widths and ``_half_c``):
    the struct (MlpTile, or MlpTileG past its arrays or a block, or where
    ``general``) and the packed buffer. Params on the chain route take
    MlpTileG, its state region holding each lane's column
    (``_im_lane_words``) and the records after it."""
    m1, lt = params.m1, params.lt_max
    chain = not _im_fixed(m1, lt)
    return _pack_tile_actor(actor, std, im.observation_space(params).shape[0], m1,
                            _half_c(params), device,
                            state_words=_im_lane_words(m1, lt) if chain else 0,
                            topo_floats=_im_record_words(m1) if chain else 0,
                            general=general or chain)


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
        _launch("im_episode", _im_fn(plan, "im_episode_returns"), ctypes.addressof(plan["struct"]),
                ctypes.addressof(plan["k7"]),
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
    tensors one thread per env runs the whole episode on K8's state, its
    streams staged into shared memory ahead of the step (csrc/im_episode.cu
    ``k_im_returns``, laid out by ``_im_k7_plan``); on CPU tensors the plain
    version runs."""
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
            _launch("im_episode", _im_fn(plan, "im_sample_streams"), *args, acts.data_ptr(),
                    dems.data_ptr(), seed, batch, E, T, _stream(dev))
            out = (acts, dems)
        else:
            out = torch.empty((E, batch), dtype=torch.float32, device=dev)
            lay = plan["fused"]
            _launch("im_episode", _im_fn(plan, "im_episode_returns_fused"), args[0],
                    ctypes.addressof(lay),
                    *args[1:], plan["disc"].data_ptr(), out.data_ptr(), seed,
                    int(params.backlog), batch, E, T, _stream(dev))
    wrapper.launches += 1
    return out


def episode_returns_im_fused(params: im.InvManagementParams, seed, batch: int,
                             episodes_per_lane: int = 1, device=None):
    """Random-policy episode returns with both streams drawn in the kernel:
    inclusive uniform int actions on [0, c_i] and demand by inversion of
    the host CDF table for all four stochastic dist modes (USER mode takes
    ``user_D[t]``; a law beyond the table cap raises NotImplementedError).
    K8: one thread per (episode, lane), its ring of fulfilled orders in
    shared memory and its stages in registers (csrc/im_episode.cu
    ``k_im_returns_fused``, the block sized by ``_im_fused_plan``). Returns
    (batch,) for episodes_per_lane=1, else (episodes_per_lane, batch),
    episode-major."""
    out = _im_fused_call(episode_returns_im_fused, params, seed, batch,
                         episodes_per_lane, device, False)
    return out.reshape(batch) if episodes_per_lane == 1 else out


episode_returns_im_fused.launches = 0


def sample_streams_debug_im(params: im.InvManagementParams, seed, batch: int,
                            episodes_per_lane: int = 1, device=None):
    """The exact action and demand streams ``episode_returns_im_fused``
    draws for ``seed``. K9: it shares K8's draws (csrc/im_step.cuh); a
    thread draws four periods of one (lane, episode), each from its own
    counter, on a 2-D grid, an instance per m1 (csrc/im_episode.cu
    ``k_im_sample_streams<M1>``). Returns (actions (T, m1, batch), demands
    (T, batch)) int32 for episodes_per_lane=1, else (T, E, m1, batch) and
    (T, E, batch)."""
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
    (alpha^t-discounted) and ``demand (T, batch)`` int32. K10: K11's tile
    with one stochastic episode a lane and the streams written, the actor on
    the tensor cores (csrc/im_policy.cu ``k_im_policy_returns<1, 0, 1,
    BACKLOG>`` on csrc/mlp_tile.cuh), so its streams are the stochastic
    K11's episode 0 for the same seed; a launch that fails raises. On the
    CPU the plain version runs. ``policy``/``act_name`` select the head and
    the trunk (``traj_policy``): the default ("ppo", "tanh") is K10's; any
    other pair (the off-policy heads "det", "sac", "uniform", a relu trunk)
    is ``rollout_traj_im_offpolicy``'s (K27), whose ``raw`` holds the
    normalised [-1, 1] actions."""
    _check_head(policy, act_name)
    if (policy, act_name) != ("ppo", "tanh"):
        return rollout_traj_im_offpolicy(params, actor, log_std, seed, batch, policy,
                                         act_name, device)
    dev = resolve_device(device)
    if batch < 1:
        raise ValueError(f"need batch >= 1, got {batch}")
    m1, T = params.m1, params.periods
    seed = int(seed) & rng.MASK32
    std = clipped_std(torch.as_tensor(log_std).detach())
    obs_dim = im.observation_space(params).shape[0]
    if dev.type == "cpu":
        _actor_dims(actor, obs_dim, m1)
        return _rollout_traj_im_plain(params, actor, std, seed, batch, dev)
    plan = _im_plan(params, _plan_key(dev))
    st, flat = _im_tile_actor(params, actor, std, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(inv=torch.empty((T + 1, m1, batch), **i32),
               actions=torch.empty((T, m1, batch), **i32),
               raw=torch.empty((T, m1, batch), **f32),
               reward=torch.empty((T, batch), **f32),
               demand=torch.empty((T, batch), **i32))
    with torch.cuda.device(dev):
        fn = _im_fn(plan, "im_rollout_traj", _tile_launch(st, batch, dev))
        _launch("im_policy", fn, ctypes.addressof(plan["struct"]),
                ctypes.addressof(st), flat.data_ptr(),
                plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr(),
                *(out[k].data_ptr() for k in ("inv", "actions", "raw", "reward", "demand")),
                seed, int(params.backlog), batch, T, _stream(dev))
    rollout_traj_im.launches += 1
    return out


rollout_traj_im.launches = 0


def rollout_traj_im_offpolicy(params: im.InvManagementParams, actor, log_std, seed,
                              batch: int, policy: str = "det", act_name: str = "relu",
                              device=None):
    """``rollout_traj_im`` under the off-policy heads: one episode per lane
    of the folded actor (``fold_offpolicy_actor``) with the head ``policy``
    ("det": TD3/DDPG's clipped post-squash noise of std
    ``clipped_std(log_std)``; "sac": the squashed state-dependent Gaussian
    of the actor's 2 * m1 outputs; "uniform": the warmup's uniform actions;
    or "ppo") on a ``act_name`` ("relu" or "tanh") trunk. Returns
    ``rollout_traj_im``'s dict, ``raw`` holding the normalised [-1, 1]
    actions (the pre-squash samples for "ppo"). The stream is K10's: per
    period the demand word, then the head's words, so its demand is K10's
    for the same seed. K27 on the card: a thread-block cluster a tile of
    lanes (csrc/im_offpolicy.cu ``k_im_rollout_traj_cluster`` on
    csrc/cluster_mlp.cuh), the actor's slices in the CTAs' shared memory,
    for any actor a cluster tile holds (``_cluster_choice``: the SB3
    default (256, 256) actor and anything as small); a wider one takes the
    wide route, a block per 32 lanes with the weights streamed from L2
    (``k_im_rollout_traj_wide`` on csrc/wide_mlp.cuh), chosen from the
    sizes before the launch. Either launch that fails raises. On the CPU
    the plain version runs."""
    _check_head(policy, act_name)
    dev = resolve_device(device)
    if batch < 1:
        raise ValueError(f"need batch >= 1, got {batch}")
    m1, T = params.m1, params.periods
    seed = int(seed) & rng.MASK32
    std = _offpolicy_std(policy, log_std)
    obs_dim = im.observation_space(params).shape[0]
    if dev.type == "cpu":
        _head_dims(actor, obs_dim, m1, policy)
        return _rollout_traj_im_plain(params, actor, std, seed, batch, dev, policy, act_name)
    flags = (int(act_name == "relu"), int(params.backlog))
    plan = _im_plan(params, _plan_key(dev))
    words, layout, extra = _k27_state(params)
    packed = _pack_cluster_actor(actor, std, obs_dim, m1, policy, _half_c(params), T, words,
                                 False, dev, layout)
    if packed is None:   # the wide route: no cluster tile holds the actor
        st, flat = _pack_wide_actor(actor, std, obs_dim, m1, policy, _half_c(params), dev, extra,
                                    general=plan["chain"])
        fn = _im_fn(plan, "im_rollout_traj_wide", _wide_launch(st, batch, dev))
    else:
        fn = _im_fn(plan, "im_rollout_traj_cluster")
        st, flat = packed
        with torch.cuda.device(dev):
            _set_cluster_grid(st, batch, "im_offpolicy",
                              _im_fn(plan, "im_rollout_traj_cluster_occupancy"), flags, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(inv=torch.empty((T + 1, m1, batch), **i32),
               actions=torch.empty((T, m1, batch), **i32),
               raw=torch.empty((T, m1, batch), **f32),
               reward=torch.empty((T, batch), **f32),
               demand=torch.empty((T, batch), **i32))
    with torch.cuda.device(dev):
        _launch("im_offpolicy", fn, ctypes.addressof(plan["struct"]),
                ctypes.addressof(st), flat.data_ptr(), plan["table"].data_ptr(),
                plan["user_d"].data_ptr(), plan["disc"].data_ptr(),
                *(out[k].data_ptr() for k in ("inv", "actions", "raw", "reward", "demand")),
                seed, *flags, batch, T, _stream(dev))
    rollout_traj_im_offpolicy.launches += 1
    rollout_traj_im_offpolicy.route = "wide" if packed is None else "cluster"
    return out


rollout_traj_im_offpolicy.launches = 0
rollout_traj_im_offpolicy.route = None   # the last launch's: "cluster" or "wide"


def _k27_state(params: im.InvManagementParams):
    """K27's state words a lane, the cluster's layout and the wide route's
    shared memory beside its activations: the fixed route's on-hand and
    ring of requested orders (obs_dim words; the wide route keeps its
    lanes' state in their frames), or the chain route's columns
    (``_im_lane_words``) with the records after them."""
    m1, lt = params.m1, params.lt_max
    if _im_fixed(m1, lt):
        return im.observation_space(params).shape[0], _K27_LAYOUT, 0
    words, rec = _im_lane_words(m1, lt), _im_record_words(m1)
    return words, ClusterLayout(topo_floats=rec), _WIDE_LANES * words + rec


def _im_policy_call(wrapper, params, actor, seed, batch, episodes_per_lane, log_std,
                    dump, device):
    """K11 (``dump`` False) or K12 for ``wrapper``: (returns (E, B), actions,
    demands), the streams None without ``dump``."""
    dev = resolve_device(device)
    E = int(episodes_per_lane)
    if E < 1 or batch < 1:
        raise ValueError(f"need batch >= 1 and episodes_per_lane >= 1, got {batch}, {E}")
    m1, T = params.m1, params.periods
    seed = int(seed) & rng.MASK32
    std = None if log_std is None else clipped_std(torch.as_tensor(log_std).detach())
    obs_dim = im.observation_space(params).shape[0]
    if dev.type == "cpu":
        _actor_dims(actor, obs_dim, m1)
        return _im_policy_plain(params, actor, std, seed, batch, E, dev, dump)
    plan = _im_plan(params, _plan_key(dev))
    st, flat = _im_tile_actor(params, actor, std, dev)
    out = torch.empty((E, batch), dtype=torch.float32, device=dev)
    acts = dems = None
    if dump:
        acts = torch.empty((T, E, m1, batch), dtype=torch.int32, device=dev)
        dems = torch.empty((T, E, batch), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        fn = _im_fn(plan, "im_policy_returns", _tile_launch(st, E * batch, dev))
        _launch("im_policy", fn, ctypes.addressof(plan["struct"]),
                ctypes.addressof(st), flat.data_ptr(),
                plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr(),
                out.data_ptr(), acts.data_ptr() if dump else None,
                dems.data_ptr() if dump else None, seed, int(std is not None),
                int(params.backlog), batch, E, T, _stream(dev))
    wrapper.launches += 1
    return out, acts, dems


def episode_returns_im_policy(params: im.InvManagementParams, actor, seed, batch: int,
                              episodes_per_lane: int = 1, log_std=None, device=None):
    """Learned-policy episode returns, the policy run inside the kernel on
    the live state. ``actor`` is ``(Ws, bs)`` from ``fold_actor_params``.
    Demand is drawn by inverting the demand law's CDF table (USER mode reads
    ``user_D[t]``; a law beyond the table cap raises NotImplementedError).
    Deterministic by default; with the trained ``log_std`` ((m1,)) the
    actions come from tanh-squashed Gaussian samples around the mean. K11:
    a block per tile of (episode, lane) pairs, one thread each, the actor on
    the tensor cores (csrc/im_policy.cu ``k_im_policy_returns`` on
    csrc/mlp_tile.cuh); on the CPU the plain version runs. Returns (batch,)
    for episodes_per_lane=1, else (episodes_per_lane, batch)."""
    out, _, _ = _im_policy_call(episode_returns_im_policy, params, actor, seed, batch,
                                episodes_per_lane, log_std, False, device)
    return out.reshape(batch) if episodes_per_lane == 1 else out


episode_returns_im_policy.launches = 0


def sample_policy_streams_debug_im(params: im.InvManagementParams, actor, seed,
                                   batch: int, episodes_per_lane: int = 1, log_std=None,
                                   device=None):
    """(returns, actions (T, E, m1, batch) int32, demands (T, E, batch)
    int32): ``episode_returns_im_policy`` with the int actions and the
    demand it used written out. K12: the same kernel with its dump switched
    on, so the streams are exactly the ones K11 consumes for the same seed.
    Returns are (batch,) for episodes_per_lane=1, else (E, batch)."""
    out, acts, dems = _im_policy_call(sample_policy_streams_debug_im, params, actor, seed,
                                      batch, episodes_per_lane, log_std, True, device)
    return (out.reshape(batch) if episodes_per_lane == 1 else out), acts, dems


sample_policy_streams_debug_im.launches = 0


# ======================================= InvManagement LSTM kernels K22-K24
#
# The recurrent actor of RecurrentPPO / A2C_LSTM, folded, in the episode:
# per period the obs rows of the live state, a tanh encoder, the LSTM cell
# G = Wx @ E + Wh @ H + bh with gate row blocks [i, f, g, o], C = f C + i g,
# H = o tanh(C), and the mean head (pallas_episode_kernels.py:1304-1610).
# The (hidden, lanes) carry stays in the kernel (csrc/lstm.cuh).

# maxima of the LSTM kernels' fixed class (csrc/lstm.cuh Lstm): encoder
# layers, the hidden width (a multiple of 4, padded to the unit groups of 8 of
# the tensor-core product; at most LSTM_MAX_GROUPS groups), actions (on the
# fixed route: the chain route reads the half ranges from its records). An
# actor past them, or whose layout fits no block, takes the general class
# (LstmG): any encoder depth and width, any hidden width >= 1, any action
# count, its regions in shared memory or, past a block of 32 lanes, in a
# device workspace
LSTM_MAX_ENC, LSTM_MAX_HIDDEN, LSTM_MAX_ACT = 4, 128, 8
# registers a thread of the LSTM kernels (their launch bounds: two blocks of
# 256 threads an SM): what the general class's persistent grid counts by
_LSTM_REGS = 128


def fold_lstm_actor(cfg, model, rms=None) -> dict:
    """The deterministic LSTM actor of a RecurrentPPO / A2C_LSTM model
    (``networks.LSTMActorCritic``) as plain (out, in)-layout float32 tensors,
    the obs normalisation folded into the first encoder layer as
    ``fold_actor_params`` folds it (pallas_episode_kernels.fold_lstm_actor
    :1326). Returns a dict: ``enc`` [(W (out, in), b (out, 1))], ``wx``
    (4h, enc), ``wh`` (4h, h), ``bh`` (4h, 1), ``wm`` (act, h), ``bm``
    (act, 1), the gate row blocks in the order i, f, g, o. As in the JAX
    package, an actor without encoder layers keeps no normalisation."""
    if getattr(cfg, "activation", "tanh") != "tanh":
        raise NotImplementedError(
            f"fold_lstm_actor: the LSTM kernels run a tanh encoder, as the JAX "
            f"package's do; got activation={cfg.activation!r}")
    enc = []
    for i, layer in enumerate(model.enc):
        W = layer.weight.detach().to(torch.float32).T   # (in, out), flax's kernel
        b = layer.bias.detach().to(torch.float32)
        if i == 0 and rms is not None and getattr(cfg, "normalize_obs", True):
            invstd = 1.0 / torch.sqrt(rms.var.to(torch.float32) + 1e-8)
            mu = rms.mean.to(torch.float32)
            b = b - (mu * invstd) @ W
            W = W * invstd[:, None]
        enc.append((W.T.contiguous(), b.reshape(-1, 1).clone()))
    cell = model.cell

    def f32(p):
        return p.detach().to(torch.float32)

    return dict(enc=enc, wx=f32(cell.wi).T.contiguous(), wh=f32(cell.wh).T.contiguous(),
                bh=f32(cell.bh).reshape(-1, 1).clone(),
                wm=f32(model.mean.weight).clone(), bm=f32(model.mean.bias).reshape(-1, 1).clone())


def _lstm_on(actor, device, dtype=torch.float32) -> dict:
    """``actor`` with every tensor's float32 values on ``device`` in
    ``dtype``."""
    _check_dtype(dtype)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device).to(dtype)
    return dict(enc=[(t(W), t(b)) for W, b in actor["enc"]],
                **{k: t(actor[k]) for k in ("wx", "wh", "bh", "wm", "bm")})


def _lstm_forward64(actor, obs_rows, H, C, err):
    """``lstm_forward`` in float64 with the float32 forward bounds: ``err``
    = (bound of H, bound of C), zeros at the episode's start; returns
    (mean, H', C', (bound of mean, of H', of C')). The gate sums' gamma
    bound over [E; H] (one product of e + h inputs, as the kernels run
    it), the sigmoid's and tanh's slopes within the error so far and their
    float32 ulps, the cell's two products and sum (gamma_2), the head's
    sum."""
    eH, eC = err
    X = torch.stack([r.to(torch.float32) for r in obs_rows]).to(torch.float64)
    eX = torch.zeros_like(X)
    for W, b in actor["enc"]:
        X, eX = _tanh64(*_dense64(W, b, X, eX))
    h = actor["wh"].shape[1]
    W = torch.cat([actor["wx"], actor["wh"]], 1)
    G, eG = _dense64(W, actor["bh"], torch.cat([X, H]), torch.cat([eX, eH]))

    def sig(k):
        y, e = G[k * h:(k + 1) * h], eG[k * h:(k + 1) * h]
        s = torch.sigmoid(y)
        return s, _sigmoid_slope(y, e) * e + 2 * _FN_REL * s
    (i, ei), (f, ef), (o, eo) = sig(0), sig(1), sig(3)
    g, eg = _tanh64(G[2 * h:3 * h], eG[2 * h:3 * h])
    C2 = f * C + i * g
    eC2 = (f * eC + (C.abs() + eC) * ef + i * eg + (g.abs() + eg) * ei
           + gamma_f32(2) * ((f * C).abs() + (i * g).abs()))
    tc, etc = _tanh64(C2, eC2)
    H2 = o * tc
    eH2 = o * etc + (tc.abs() + etc) * eo + F32_U * H2.abs()
    mean, em = _dense64(actor["wm"], actor["bm"], H2, eH2)
    return mean, H2, C2, em, (eH2, eC2)


def lstm_forward(actor, obs_rows, H, C, dtype=torch.float32, err=None):
    """Plain version of the in-kernel LSTM actor (csrc/lstm.cuh
    ``lstm_forward``; pallas_episode_kernels.py:1391-1403): the obs rows,
    each (B,), stacked to (obs_dim, B), the tanh encoder, the gates
    G = Wx @ E + Wh @ H + bh, the cell, and the mean head. ``H`` and ``C``
    are (hidden, B). Returns (mean (act, B), H', C'). With
    ``dtype=torch.float64`` (``_lstm_on`` in that dtype; ``err`` the bounds
    of H and C carried, None at the episode's start) returns (mean, H', C',
    the float32 forward bound of mean, the bounds of H' and C' to carry)."""
    _check_dtype(dtype)
    if dtype == torch.float64:
        if err is None:
            err = (torch.zeros_like(H), torch.zeros_like(C))
        return _lstm_forward64(actor, obs_rows, H, C, err)
    X = torch.stack([r.to(torch.float32) for r in obs_rows])
    for W, b in actor["enc"]:
        X = torch.tanh(W @ X + b)
    h = actor["wh"].shape[1]
    G = actor["wx"] @ X + actor["wh"] @ H + actor["bh"]
    i, f, o = (torch.sigmoid(G[k * h:(k + 1) * h]) for k in (0, 1, 3))
    C = f * C + i * torch.tanh(G[2 * h:3 * h])
    H = o * torch.tanh(C)
    return actor["wm"] @ H + actor["bm"], H, C


def _im_lstm_period_plain(params, plan, actor, std, seed, lanes, t, inv, AH, H, C):
    """Demand, raw samples and int actions of period ``t`` of the LSTM
    kernels (csrc/im_lstm.cuh ``lane_draws``/``lane_act``), K10's stream
    layout: under key (seed, 1) one demand word, then, with ``std``, the m1
    u1 and the m1 u2 words of the normals; the actor on ``_im_obs_rows``;
    the action (int)((tanh(raw) + 1) * f32(0.5 c_i)). Returns (demand, raw
    (m1, B), [m1 int32 action rows], H', C')."""
    m1 = params.m1
    words = rng.period_words(seed, lanes, 0, t, 1 if std is None else 1 + 2 * m1,
                             key1=rng.POLICY_KEY)
    d = _im_demand_plain(plan, words[0], t)
    raw, H, C = lstm_forward(actor, _im_obs_rows(params, t, inv, AH), H, C)
    if std is not None:
        raw = raw + std * rng.normal01(torch.stack(words[1:1 + m1]), torch.stack(words[1 + m1:]))
    S = torch.tanh(raw) + 1.0
    half_c = _half_c(params)
    return d, raw, [im.trunc_i32(S[i] * half_c[i]) for i in range(m1)], H, C


def _im_lstm_episodes_plain(params, actor, std, seed, batch, device, traj):
    """The episode loop shared by the plain K22-K24: one episode per lane,
    zero carry at the start. With ``traj`` (K24) returns ``rollout_traj_im_lstm``'s
    dict; otherwise (returns (B,), actions (T, m1, B), demand (T, B))."""
    m1, lt, T = params.m1, params.lt_max, params.periods
    plan = _im_host_plan(params, str(device))
    actor = _lstm_on(actor, device)
    std = None if std is None else std.to(device)
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
    H = torch.zeros((actor["wh"].shape[1], batch), **f32)
    C = torch.zeros_like(H)
    total = torch.zeros(batch, **f32)
    for t, disc in enumerate(plan["discs"]):
        out["inv"][t] = torch.stack(inv)
        d, raw, acts, H, C = _im_lstm_period_plain(params, plan, actor, std, seed, lanes, t,
                                                   inv, AH, H, C)
        out["raw"][t], out["actions"][t], out["demand"][t] = raw, torch.stack(acts), d
        inv, bkl, RH, r_req, profit = _im_step_math(params, t, inv, bkl, RH, acts, d)
        if lt:
            AH = r_req + AH[: (lt - 1) * m1]
        out["reward"][t] = disc * profit
        total = total + disc * profit
    out["inv"][T] = torch.stack(inv)
    if traj:
        return out
    return total, out["actions"], out["demand"]


def _im_lstm_plain(params, actor, seed, batch, device, dump=False):
    """Plain version of K22 (and, with ``dump``, K23): (returns (B,),
    actions (T, m1, B), demand (T, B)), the streams None without
    ``dump``."""
    total, acts, dems = _im_lstm_episodes_plain(params, actor, None, seed, batch, device,
                                                False)
    return (total, acts, dems) if dump else (total, None, None)


def _rollout_traj_im_lstm_plain(params, actor, std, seed, batch, device):
    """Plain version of K24: the streams of one stochastic LSTM-policy
    episode per lane, as ``rollout_traj_im_lstm`` returns them."""
    return _im_lstm_episodes_plain(params, actor, std, seed, batch, device, True)


def _lstm_dims(actor, obs_dim: int, act_dim: int):
    """(widths [obs_dim, enc...], hidden) of a folded LSTM actor; raises
    ValueError for an actor that does not chain or fit the env."""
    dims = [obs_dim]
    for layer, (W, b) in enumerate(actor["enc"]):
        if W.ndim != 2 or W.shape[1] != dims[-1] or tuple(b.shape) != (W.shape[0], 1):
            raise ValueError(f"encoder layer {layer}: W {tuple(W.shape)} and b "
                             f"{tuple(b.shape)} do not chain from obs_dim {obs_dim} "
                             f"through widths {dims}")
        dims.append(int(W.shape[0]))
    h = int(actor["wh"].shape[1])
    shapes = {"wx": (4 * h, dims[-1]), "wh": (4 * h, h), "bh": (4 * h, 1),
              "wm": (act_dim, h), "bm": (act_dim, 1)}
    for k, want in shapes.items():
        if tuple(actor[k].shape) != want:
            raise ValueError(f"LSTM actor {k} {tuple(actor[k].shape)}, expected {want} "
                             f"(widths {dims}, hidden {h}, act_dim {act_dim})")
    return dims, h


class _Lstm(ctypes.Structure):
    """Mirror of ``struct Lstm`` in csrc/lstm.cuh (all fields 4-byte, so
    both sides lay it out without padding)."""
    _fields_ = [("n_enc", ctypes.c_int), ("dims", ctypes.c_int * (LSTM_MAX_ENC + 1)),
                ("hidden", ctypes.c_int), ("act", ctypes.c_int),
                ("w_enc", ctypes.c_int * LSTM_MAX_ENC), ("b_enc", ctypes.c_int * LSTM_MAX_ENC),
                ("w_gate", ctypes.c_int), ("b_gate", ctypes.c_int), ("w_mean", ctypes.c_int),
                ("b_mean", ctypes.c_int), ("std", ctypes.c_int), ("lanes", ctypes.c_int),
                ("warps_m", ctypes.c_int), ("threads", ctypes.c_int), ("e_pad", ctypes.c_int),
                ("h_pad", ctypes.c_int), ("k_steps", ctypes.c_int), ("stride", ctypes.c_int),
                ("s_e", ctypes.c_int), ("s_h0", ctypes.c_int), ("s_h1", ctypes.c_int),
                ("s_x0", ctypes.c_int), ("s_x1", ctypes.c_int), ("s_m", ctypes.c_int),
                ("s_z", ctypes.c_int), ("s_total", ctypes.c_int),
                ("half_hi", ctypes.c_float * LSTM_MAX_ACT)]


@dataclasses.dataclass(frozen=True)
class LstmPlan:
    """A block's tile and shared-memory layout for the LSTM kernels:
    ``lanes`` a block, ``warps_m`` warps along the units (lanes / 32
    along the lanes), ``threads``; the gate product's inputs (``e_pad``:
    the encoder's output padded to 16, or the obs to 8) and units (``h_pad``,
    to 8) and its ``k_steps``; every
    activation buffer [row][lane] with rows ``stride`` floats apart, at the
    float offsets ``offsets`` (e, h0, h1, [c,] x0, x1, m, z), ``floats`` in
    all; with ``workspace`` (the general class past a block) in the block's
    slice of a device workspace rather than shared memory."""
    lanes: int
    warps_m: int
    threads: int
    e_pad: int
    h_pad: int
    k_steps: int
    stride: int
    offsets: dict
    floats: int
    workspace: bool = False


def _lstm_plan(dims, h: int, act_dim: int, tile, general: bool = False,
               workspace: bool = False) -> LstmPlan:
    """The layout of tile ``(lanes, warps_m)`` for an actor of widths
    ``dims`` [obs_dim, enc...] and hidden ``h``: E (the encoder's output,
    or the obs rows without an encoder), H twice, the encoder's input and
    ping-pong buffers, the means, and two buffers of the draws (each
    ``act_dim`` rows of normals and a row of demand). A product's input rows
    are padded to 8 (its k-steps) and an encoder layer's outputs to 16 (its
    M-tiles); the padding rows stay zero. The ``general`` class keeps C in a
    region of its own after H (``h_pad`` rows); on the ``workspace`` its rows
    are ``lanes`` floats apart and its floats padded to 4."""
    lanes, warps_m = tile
    n_enc = len(dims) - 1
    e_pad, h_pad = (_pad16(dims[-1]) if n_enc else _pad8(dims[0])), _pad8(h)
    # B-fragment loads and the float2 stores hit 32 banks of shared memory
    stride = lanes if workspace else lanes + 8
    x_rows = max([_pad8(dims[0])] + [_pad16(d) for d in dims[1:-1]]) if n_enc else 0
    rows = {"e": e_pad, "h0": h_pad, "h1": h_pad, **({"c": h_pad} if general else {}),
            "x0": x_rows, "x1": x_rows if n_enc > 1 else 0, "m": act_dim,
            "z": 2 * (act_dim + 1)}
    offsets, at = {}, 0
    for name, r in rows.items():
        offsets[name] = at
        at += r * stride
    if not n_enc:
        offsets["x0"] = offsets["e"]   # the obs rows are the gate input
    return LstmPlan(lanes, warps_m, lanes * warps_m, e_pad, h_pad, (e_pad + h_pad) // 8,
                    stride, offsets, -(-at // 4) * 4 if workspace else at, workspace)


def _gate_fragments(wx, wh, e_pad: int, h_pad: int) -> torch.Tensor:
    """The gate weights [Wx | Wh] (4h, e + h), gate row blocks i, f, g, o,
    as ``_mma_fragments``: zero-padded to (4, h_pad, e_pad + h_pad) (inputs
    e..e_pad and units h..h_pad are 0), and unit group g (units 8g..8g+7)
    the M-tiles 2g ([i; f], 16 rows) and 2g + 1 ([g; o])."""
    h, e = wh.shape[1], wx.shape[1]
    kp = e_pad + h_pad
    W = torch.zeros((4, h_pad, kp), dtype=torch.float32, device=wx.device)
    W[:, :h, :e] = wx.reshape(4, h, e)
    W[:, :h, e_pad:e_pad + h] = wh.reshape(4, h, h)
    # [s][half][ug][gid][k] -> [ug][s][half][gid][k]: M-tile 2 ug + s, row half * 8 + gid
    rows = W.reshape(2, 2, h_pad // 8, 8, kp).permute(2, 0, 1, 3, 4)
    return _mma_fragments(rows.reshape(-1, kp))


# the tiles of the LSTM kernels (csrc/im_lstm.cu LSTM_TILES, and
# csrc/im_lstm_any.cu LSTM_ANY_TILES for the general class) the entry points
# take, in order of preference: the first whose shared memory fits
_LSTM_TILES = ((64, 4), (32, 8))


class _LstmG(ctypes.Structure):
    """Mirror of ``struct LstmG`` in csrc/lstm.cuh: the workspace pointer,
    then 4-byte fields."""
    _fields_ = [("ws", ctypes.c_void_p)] + [(name, ctypes.c_int) for name in (
        "n_enc", "table", "half_hi", "hidden", "act", "w_gate", "b_gate", "w_mean", "b_mean",
        "std", "lanes", "warps_m", "threads", "e_pad", "h_pad", "k_steps", "stride", "s_e",
        "s_h0", "s_h1", "s_c", "s_x0", "s_x1", "s_m", "s_z", "s_total", "smem_floats",
        "ws_floats", "grid")]


def _lstm_choice_any(dims, h: int, act_dim: int, records: int = 0) -> LstmPlan:
    """The general class's plan (``_lstm_plan``'s, C a region of its own):
    the first of ``_LSTM_TILES`` whose regions, with ``records`` words after
    them, fit a block's shared memory; else the first tile on the workspace.
    Raises ValueError where one block's slice of the workspace passes
    WORKSPACE_MAX_BYTES or a region offset passes 32 bits, naming the
    bytes."""
    for tile in _LSTM_TILES:
        plan = _lstm_plan(dims, h, act_dim, tile, general=True)
        if (plan.floats + records) * 4 <= SMEM_OPTIN_BYTES:
            return plan
    plan = _lstm_plan(dims, h, act_dim, _LSTM_TILES[0], general=True, workspace=True)
    if 4 * plan.floats > WORKSPACE_MAX_BYTES or plan.floats >= 1 << 31:
        raise ValueError(f"LSTM actor of widths {dims}, hidden {h}: a block's slice of the "
                         f"workspace takes {4 * plan.floats} bytes; a launch holds "
                         f"{WORKSPACE_MAX_BYTES}")
    return plan


def _lstm_fixed(n_enc: int, h: int, act_dim: int, records: int) -> bool:
    """Whether an actor fits struct Lstm's arrays (the parent's class):
    LSTM_MAX_ENC encoder layers, a hidden width that is a multiple of 4 and
    at most LSTM_MAX_HIDDEN, LSTM_MAX_ACT actions where the half ranges are
    the struct's (not on the chain route, ``records`` > 0)."""
    return (n_enc <= LSTM_MAX_ENC and h % 4 == 0 and h <= LSTM_MAX_HIDDEN
            and (act_dim <= LSTM_MAX_ACT or bool(records)))


def _pack_lstm_actor(actor, std, obs_dim: int, act_dim: int, half_hi, device,
                     records: int = 0):
    """The LSTM kernels' actor arguments: the struct and one flat float32
    buffer on ``device``. The buffer holds the gate weights as the A
    fragments of the tensor-core product (``_gate_fragments``); the gate
    biases (h_pad, 4), row j the four gates [i, f, g, o] of unit j; each
    encoder layer's W and b, as fragments too (``_encoder_fragments``); the
    mean head's W (act, h) and b; the std when given; every NaN as the
    quiet NaN 0x7fc00000 (``_QUIET_NAN_BITS``). An actor within struct
    Lstm's arrays (``_lstm_fixed``) whose layout fits a block takes the
    fixed class, the parent's: the struct carries the offsets, the tile (the
    first of ``_LSTM_TILES`` whose layout, and ``records`` words after it,
    fit a block's shared memory) and the layout (``_lstm_plan``). Any other
    takes the general class (``_LstmG``, ``_lstm_choice_any``): the buffer
    then ends with the encoder's layer table (an int4 {in, out, w, b} a
    layer, 16-byte aligned) and half_hi. ``records`` > 0 is the
    InvManagement chain route's (its records staged after the activations,
    csrc/im_lstm.cu), whose half ranges come from the records. Raises
    ValueError past the workspace of a launch or a 32-bit offset, naming the
    bytes."""
    dims, h = _lstm_dims(actor, obs_dim, act_dim)
    n_enc = len(dims) - 1
    plan = None
    if _lstm_fixed(n_enc, h, act_dim, records):
        plans = [_lstm_plan(dims, h, act_dim, t) for t in _LSTM_TILES]
        plan = next((pl for pl in plans if (pl.floats + records) * 4 <= SMEM_OPTIN_BYTES), None)
    general = plan is None
    if general:
        plan = _lstm_choice_any(dims, h, act_dim, records)
    a = _lstm_on(actor, device)
    bias = torch.zeros((plan.h_pad, 4), dtype=torch.float32, device=device)
    bias[:h] = a["bh"].reshape(4, h).T
    parts = [_gate_fragments(a["wx"], a["wh"], plan.e_pad, plan.h_pad), bias.reshape(-1)]
    st = (_LstmG if general else _Lstm)(n_enc=n_enc, hidden=h, act=act_dim, w_gate=0,
                                        b_gate=parts[0].numel())

    def append(x) -> int:
        offset = sum(p.numel() for p in parts)
        parts.append(x.reshape(-1))
        return offset

    layers = []
    for W, b in a["enc"]:
        frag, bias_l = _encoder_fragments(W, b)
        layers.append((append(frag), append(bias_l)))
    st.w_mean, st.b_mean = append(a["wm"]), append(a["bm"])
    st.std = -1 if std is None else append(std.to(device=device, dtype=torch.float32))
    if general:
        at = sum(p.numel() for p in parts)
        append(torch.zeros(-at % 4, dtype=torch.float32, device=device))
        st.table = append(_int_floats([[dims[k], dims[k + 1], w, b]
                                       for k, (w, b) in enumerate(layers)]).to(device))
        st.half_hi = append(torch.tensor([float(v) for v in half_hi], dtype=torch.float32,
                                         device=device))
        if sum(p.numel() for p in parts) >= 1 << 31:
            raise ValueError(f"LSTM actor of widths {dims}, hidden {h}: the packed actor "
                             f"takes {4 * sum(p.numel() for p in parts)} bytes, past the "
                             f"kernels' 32-bit float offsets")
    else:
        for layer, (w, b) in enumerate(layers):
            st.w_enc[layer], st.b_enc[layer] = w, b
        for k, d in enumerate(dims):
            st.dims[k] = d
        for i, v in enumerate(half_hi[:LSTM_MAX_ACT]):
            st.half_hi[i] = v
    _set_lstm_tile(st, plan)
    return st, _quiet_nans(torch.cat(parts))


def _set_lstm_tile(st, plan: LstmPlan) -> None:
    """Write ``plan``'s tile and layout into ``st`` (the packed buffer does
    not depend on the tile); the general class also where its regions lie
    (``smem_floats`` of shared memory, or ``ws_floats`` a block's slice of
    the workspace)."""
    for field in ("lanes", "warps_m", "threads", "e_pad", "h_pad", "k_steps", "stride"):
        setattr(st, field, getattr(plan, field))
    for name, offset in plan.offsets.items():
        setattr(st, f"s_{name}", offset)
    st.s_total = plan.floats
    if isinstance(st, _LstmG):
        st.smem_floats = 0 if plan.workspace else plan.floats
        st.ws_floats = plan.floats if plan.workspace else 0


# the grid dimension's limit: a general-class launch of more tiles walks them
_MAX_GRID = (1 << 31) - 1


def _lstm_launch(st, batch: int, dev) -> str:
    """Set a general-class struct's grid (a block a tile, or the persistent
    grid over the workspace) and workspace for ``batch`` lanes; returns the
    C entry points' suffix ("" for Lstm, "_any")."""
    if not isinstance(st, _LstmG):
        return ""
    tiles = -(-batch // st.lanes)
    if st.ws_floats:
        _set_workspace(st, _persistent_blocks(tiles, st.ws_floats, st.threads,
                                              4 * st.smem_floats, _LSTM_REGS, dev), dev)
    else:
        st.grid, st.ws = min(tiles, _MAX_GRID), None
    return "_any"


def _lstm_lib(suffix: str) -> str:
    """The source of an LSTM entry point's suffix: csrc/im_lstm_any.cu for
    the general class's, csrc/im_lstm.cu for the fixed class's."""
    return "im_lstm_any" if suffix.endswith("_any") else "im_lstm"


def _im_lstm_launch(params, actor, std, batch, dev):
    """(the params struct, the LSTM struct, the packed actor, the entry
    points' suffix) of a K22-K24 launch on the card. On the chain route a
    copy of the ImParamsG with the lanes' state in a workspace taken for
    the launch (``_im_lane_words`` a lane, [word][lane] over the grid's
    lanes; kept alive on the struct until the launch is queued, as
    ``_set_workspace`` keeps its). The general class adds "_any" to the
    suffix (``_lstm_launch``)."""
    plan = _im_plan(params, _plan_key(dev))
    rec = _im_record_words(params.m1) if plan["chain"] else 0
    st, flat = _pack_lstm_actor(actor, std, im.observation_space(params).shape[0], params.m1,
                                _half_c(params), dev, rec)
    suffix = _lstm_launch(st, batch, dev)
    if not plan["chain"]:
        return plan["struct"], st, flat, suffix
    g = _ImParamsG.from_buffer_copy(plan["struct"])
    g.ws_stride = -(-batch // st.lanes) * st.lanes
    g.workspace = torch.empty(g.state_words * g.ws_stride, dtype=torch.int32, device=dev)
    g.ws = g.workspace.data_ptr()
    return g, st, flat, "_chain" + suffix


def _im_lstm_args(params, actor, batch, device):
    """(device, obs_dim) of a K22-K24 call, the actor checked against the env."""
    dev = resolve_device(device)
    if batch < 1:
        raise ValueError(f"need batch >= 1, got {batch}")
    obs_dim = im.observation_space(params).shape[0]
    _lstm_dims(actor, obs_dim, params.m1)
    return dev, obs_dim


def _im_lstm_call(wrapper, params, actor, seed, batch, dump, device):
    """K22 (``dump`` False) or K23 for ``wrapper``: (returns (B,), actions,
    demands), the streams None without ``dump``."""
    dev, _ = _im_lstm_args(params, actor, batch, device)
    seed = int(seed) & rng.MASK32
    if dev.type == "cpu":
        return _im_lstm_plain(params, actor, seed, batch, dev, dump)
    plan = _im_plan(params, _plan_key(dev))
    T, m1 = params.periods, params.m1
    out = torch.empty(batch, dtype=torch.float32, device=dev)
    acts = torch.empty((T, m1, batch), dtype=torch.int32, device=dev) if dump else None
    dems = torch.empty((T, batch), dtype=torch.int32, device=dev) if dump else None
    with torch.cuda.device(dev):
        g, st, flat, suffix = _im_lstm_launch(params, actor, None, batch, dev)
        _launch(_lstm_lib(suffix), "im_lstm_returns" + suffix, ctypes.addressof(g),
                ctypes.addressof(st), flat.data_ptr(), plan["table"].data_ptr(),
                plan["user_d"].data_ptr(), plan["disc"].data_ptr(), out.data_ptr(),
                acts.data_ptr() if dump else None, dems.data_ptr() if dump else None,
                seed, int(params.backlog), batch, T, _stream(dev))
    wrapper.launches += 1
    return out, acts, dems


def episode_returns_im_lstm(params: im.InvManagementParams, actor, seed, batch: int,
                            device=None) -> torch.Tensor:
    """Deterministic LSTM-policy episode returns (batch,) float32, the
    recurrent actor run inside the kernel on the live state with its
    (hidden, lanes) carry kept there. ``actor`` is the dict of
    ``fold_lstm_actor``. Demand is drawn by inverting the demand law's CDF
    table (USER mode reads ``user_D[t]``; a law beyond the table cap raises
    NotImplementedError). K22: a block per 64 or 32 lanes, the gate product
    on the tensor cores (csrc/im_lstm.cu ``k_im_lstm_returns``, and
    csrc/im_lstm_any.cu ``k_im_lstm_returns_g`` for an actor past the fixed
    class, any encoder depth and width and any hidden width); on the CPU the
    plain version runs."""
    return _im_lstm_call(episode_returns_im_lstm, params, actor, seed, batch, False,
                         device)[0]


episode_returns_im_lstm.launches = 0


def sample_lstm_streams_debug_im(params: im.InvManagementParams, actor, seed, batch: int,
                                 device=None):
    """(returns (batch,), actions (T, m1, batch) int32, demands (T, batch)
    int32): ``episode_returns_im_lstm`` with the int actions and the demand
    it used written out. K23: the same kernel with its dump switched on, so
    the streams are exactly the ones K22 consumes for the same seed."""
    return _im_lstm_call(sample_lstm_streams_debug_im, params, actor, seed, batch, True,
                         device)


sample_lstm_streams_debug_im.launches = 0


def rollout_traj_im_lstm(params: im.InvManagementParams, actor, log_std, seed, batch: int,
                         device=None):
    """One full stochastic LSTM-policy episode per lane, zero carry at the
    start, with the training streams written out. ``actor`` is the dict of
    ``fold_lstm_actor``; ``log_std`` the policy's log-std, clipped through
    ``clipped_std``. Returns a dict: ``inv (T+1, m1, batch)`` int32
    start-of-period on-hand (the final snapshot last), ``actions (T, m1,
    batch)`` int32, ``raw (T, m1, batch)`` f32 pre-squash samples, ``reward
    (T, batch)`` f32 (alpha^t-discounted) and ``demand (T, batch)`` int32.
    It draws K10's stream, so its demand is K23's for the same seed. K24: a
    block per 64 or 32 lanes, the gate product on the tensor cores
    (csrc/im_lstm.cu ``k_im_lstm_traj``, and csrc/im_lstm_any.cu
    ``k_im_lstm_traj_g`` for an actor past the fixed class); on the CPU the
    plain version runs."""
    dev, _ = _im_lstm_args(params, actor, batch, device)
    seed = int(seed) & rng.MASK32
    std = clipped_std(torch.as_tensor(log_std).detach())
    if dev.type == "cpu":
        return _rollout_traj_im_lstm_plain(params, actor, std, seed, batch, dev)
    plan = _im_plan(params, _plan_key(dev))
    T, m1 = params.periods, params.m1
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(inv=torch.empty((T + 1, m1, batch), **i32),
               actions=torch.empty((T, m1, batch), **i32),
               raw=torch.empty((T, m1, batch), **f32),
               reward=torch.empty((T, batch), **f32),
               demand=torch.empty((T, batch), **i32))
    with torch.cuda.device(dev):
        g, st, flat, suffix = _im_lstm_launch(params, actor, std, batch, dev)
        _launch(_lstm_lib(suffix), "im_lstm_rollout_traj" + suffix, ctypes.addressof(g),
                ctypes.addressof(st), flat.data_ptr(), plan["table"].data_ptr(),
                plan["user_d"].data_ptr(), plan["disc"].data_ptr(),
                *(out[k].data_ptr() for k in ("inv", "actions", "raw", "reward", "demand")),
                seed, int(params.backlog), batch, T, _stream(dev))
    rollout_traj_im_lstm.launches += 1
    return out


rollout_traj_im_lstm.launches = 0


# =============================================== Newsvendor kernels K13-K17

# the local ring's slots and K13's register instances (csrc/nv_step.cuh):
# past this lead time K13, K14 and K16 keep the pipeline in a thread's column
# of shared memory (their column instances)
NV_MAX_L = 32
NV_ECON_PERIOD = 0xFFFFFFFF  # the period index of the reset's five words


def _nv_step_math(params: nv.NewsvendorParams, P, price, cost, h, k, order_raw, d):
    """One Newsvendor period over (N,) f32 tensors
    (pallas_episode_kernels._nv_step_math), event order per
    newsvendor.py:125-204. ``P`` is the pipeline as a list of L tensors,
    oldest first. Returns (P', reward, capped order)."""
    L = params.lead_time
    zero = torch.zeros_like(order_raw)
    if L == 0:
        pipeline_sum = zero
        inv_on_hand = order_raw  # reference quirk: pre-cap order on hand
    else:
        pipeline_sum = sum(P[1:], P[0])
        inv_on_hand = P[0]
    order_qty = torch.maximum(zero, torch.minimum(
        order_raw, nv.as_f32(params.max_inventory) - pipeline_sum))
    sales = torch.minimum(inv_on_hand, d)
    excess = torch.maximum(zero, inv_on_hand - d)
    short = torch.maximum(zero, d - inv_on_hand)
    reward = sales * price - order_qty * cost - excess * h - short * k
    if L > 0:
        P = P[1:] + [order_qty]
    return P, reward, order_qty


# the reset's formulas on the kernel's five uniforms
# (pallas_episode_kernels._nv_econ_from_uniforms): the env's own
_nv_econ_from_uniforms = nv.econ_from_uniforms


class _NvParams(ctypes.Structure):
    """Mirror of ``struct NvParams`` in csrc/nv_step.cuh (all fields 4-byte,
    so both sides lay it out without padding)."""
    _fields_ = [("L", ctypes.c_int), ("K", ctypes.c_int), ("threads", ctypes.c_int),
                ("table", ctypes.c_int), ("kc_max", ctypes.c_int),
                ("wb", ctypes.c_float), ("max_inv", ctypes.c_float),
                ("max_order", ctypes.c_float), ("p_max", ctypes.c_float),
                ("h_max", ctypes.c_float), ("k_max", ctypes.c_float),
                ("mu_max", ctypes.c_float), ("k13_threads", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class NvTablePlan:
    """K14-K17's launch: ``threads`` a block, ``bytes`` of dynamic shared
    memory a block for the stepping instances (the [k][thread] table of the
    K suffix sums, then, past NV_MAX_L, ``ring`` words of pipeline a
    thread), resident ``blocks_per_sm``; ``table`` False picks the linear
    count instead."""
    threads: int
    bytes: int
    blocks_per_sm: int
    table: bool
    ring: int = 0


# a block of 256 threads launches at any register count (65,536 / 256)
_NV_TABLE_MAX_THREADS = 256
# registers a thread of K13-K17: the most ptxas -v reports for an instance
# of k_nv_episodes (80-96 on sm_90a), and for its column instances (96-98;
# chip_smoke.py checks both); an SM's 65,536 registers go to warps in whole
# allocations of 32 x this, rounded up to a multiple of 8
_NV_TABLE_REGS = 96
_NV_COLUMN_REGS = 98
REGS_PER_SM = 65_536


def _nv_column_words() -> int:
    """The words a thread of a block of 32 may take of its shared memory."""
    return SMEM_OPTIN_BYTES // (4 * 32)


def _nv_best_block(words: int, table: bool, ring: int) -> NvTablePlan:
    """The block size, among multiples of 32 up to 256, at which an SM holds
    the most threads of ``words`` words of shared memory each (the smallest
    such block, for the fullest last wave), counting the SM's shared
    memory, registers (``_NV_TABLE_REGS`` a thread, ``_NV_COLUMN_REGS``
    for the column instances, ``ring`` > 0), threads and blocks. Raises
    ValueError where no block of 32 holds them, naming the words."""
    regs = -(-(_NV_COLUMN_REGS if ring else _NV_TABLE_REGS) // 8) * 8
    warps_by_regs = REGS_PER_SM // (32 * regs)
    best = None
    for threads in range(32, _NV_TABLE_MAX_THREADS + 1, 32):
        nbytes = 4 * words * threads
        if nbytes > SMEM_OPTIN_BYTES:
            break
        blocks = min(SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK_RESERVED),
                     warps_by_regs // (threads // 32), THREADS_PER_SM // threads,
                     BLOCKS_PER_SM)
        if best is None or blocks * threads > best.blocks_per_sm * best.threads:
            best = NvTablePlan(threads, nbytes, blocks, table, ring)
    if best is None:
        raise ValueError(f"K14/K16's column of {words} words a thread (a pipeline of {ring}) "
                         f"fits no block: a block of 32 threads holds {_nv_column_words()} "
                         "words a thread")
    return best


def _nv_table_plan(K: int, ring: int = 0) -> NvTablePlan:
    """The block of K14-K17 with a table of ``K`` floats a thread and, for
    the column instances (a lead time past NV_MAX_L), ``ring`` words of
    pipeline after it (``_nv_best_block``); for a K whose table and ring a
    block of 32 cannot hold (K > 1,816 with no ring: mu_max > ~24,500), the
    linear count: at ``_POLICY_THREADS`` (csrc/launch.cuh kThreads) with no
    shared memory where ``ring`` is 0, else sized to the ring alone. Raises
    ValueError where not even the ring fits a block of 32."""
    if 32 * 4 * (K + ring) <= SMEM_OPTIN_BYTES:
        return _nv_best_block(K + ring, True, ring)
    if ring:
        return _nv_best_block(ring, False, ring)
    warps_by_regs = REGS_PER_SM // (32 * _NV_TABLE_REGS)
    blocks = min(warps_by_regs // (_POLICY_THREADS // 32), THREADS_PER_SM // _POLICY_THREADS,
                 BLOCKS_PER_SM)
    return NvTablePlan(_POLICY_THREADS, 0, blocks, False)


@dataclasses.dataclass(frozen=True)
class NvK13Plan:
    """K13's launch: two staging buffers of ``chunk`` periods of
    ``per_period`` words (the order, then the demand; ``_random`` the demand
    alone), then, for the column instance (a lead time past NV_MAX_L),
    ``ring`` words of pipeline: ``words`` a thread, [word][thread] in
    dynamic shared memory at ``threads`` a block: ``bytes`` a block,
    resident ``blocks_per_sm`` by shared memory, threads and blocks (within
    NV_MAX_L the pipeline is in registers)."""
    threads: int
    words: int
    per_period: int
    chunk: int
    bytes: int
    blocks_per_sm: int
    ring: int = 0


# K13's periods a staging buffer and an unrolled chunk (kK13Chunk of
# csrc/nv_episode.cu), and its block: launch.cuh's kThreads. On an H100, 64
# and 256 threads ran within 2% of 128 (tools/k13_sweep.py, the shared-memory
# form). The column instance takes the first of NV_K13_COLUMN_THREADS whose
# block holds its columns.
NV_K13_CHUNK = 8
NV_K13_THREADS = 128
NV_K13_COLUMN_THREADS = (NV_K13_THREADS, 64, 32)


@functools.lru_cache(maxsize=64)
def _nv_k13_plan(random: bool = False, threads: int = NV_K13_THREADS,
                 ring: int = 0) -> NvK13Plan:
    """K13's shared memory: 2 x ``NV_K13_CHUNK`` periods of 2 words a
    thread (1 for ``random``) and ``ring`` words of pipeline at ``threads``
    a block. Raises ValueError where no block holds it."""
    per_period = 1 if random else 2
    words = 2 * NV_K13_CHUNK * per_period + ring
    nbytes = 4 * words * threads
    if threads < 32 or threads % 32 or threads > 1024 or nbytes > SMEM_OPTIN_BYTES:
        raise ValueError(f"K13 launches whole warps, at most 1,024 threads and "
                         f"{SMEM_OPTIN_BYTES} bytes a block; got {threads} threads, {nbytes} B")
    blocks = min(SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK_RESERVED), THREADS_PER_SM // threads,
                 BLOCKS_PER_SM)
    return NvK13Plan(threads, words, per_period, NV_K13_CHUNK, nbytes, blocks, ring)


def _nv_k13_launch(ring: int) -> NvK13Plan:
    """K13's plan for a pipeline of ``ring`` words (0: the register
    instances): ``_nv_k13_plan`` at NV_K13_THREADS, or for the column
    instance at the first of NV_K13_COLUMN_THREADS whose block holds the
    streamed mode's columns (the larger; ``_random``'s fit the same block).
    Raises ValueError where no block of 32 holds them, naming the words."""
    words = 4 * NV_K13_CHUNK + ring
    for threads in (NV_K13_COLUMN_THREADS if ring else (NV_K13_THREADS,)):
        if 4 * words * threads <= SMEM_OPTIN_BYTES:
            return _nv_k13_plan(False, threads, ring)
    raise ValueError(f"K13's column of {words} words a thread (two buffers of {NV_K13_CHUNK} "
                     f"periods and a pipeline of {ring}) fits no block: a block of 32 threads "
                     f"holds {_nv_column_words()} words a thread")


@functools.lru_cache(maxsize=32)
def _nv_plan(params: nv.NewsvendorParams, device: str):
    """A launch's host-built arguments, built once per (params, device): the
    params struct (with K14-K17's ``_nv_table_plan`` and K13's
    ``_nv_k13_launch``), the f32 gamma^t table (as a list and on
    ``device``) and the lgamma pairs on ``device``. Any lead time runs:
    past NV_MAX_L the kernels keep the pipeline in a column of shared
    memory, sized here. Raises ValueError, naming the words needed and held,
    where a block of 32 threads holds no column (K13's, the largest, 32 + L
    words: a lead time past 1,784)."""
    L = params.lead_time
    ring = L if L > NV_MAX_L else 0   # the column instances' pipeline, words a thread
    Wb, K, lgam = nv_poisson.window(params)
    try:
        k13 = _nv_k13_launch(ring)
        launch = _nv_table_plan(K, ring)
    except ValueError as e:
        raise ValueError(f"Newsvendor lead_time={L}: {e}") from None
    st = _NvParams(L=L, K=K, threads=launch.threads, table=int(launch.table),
                   kc_max=len(lgam) - 1, wb=float(Wb),
                   max_inv=params.max_inventory, max_order=params.max_order_quantity,
                   p_max=params.p_max, h_max=params.h_max, k_max=params.k_max,
                   mu_max=params.mu_max, k13_threads=k13.threads)
    discs = _discounts(params.gamma, params.step_limit)
    return dict(struct=st, discs=discs,
                disc=torch.tensor(discs, dtype=torch.float32, device=device),
                lgam=torch.as_tensor(nv_poisson.lgamma_pairs(params), device=device).reshape(-1))


def _nv_order(params, word):
    """The random policy's order from its word: u * max_order."""
    return rng.uniform01(word) * nv.as_f32(params.max_order_quantity)


def _nv_returns(params, econ, orders, dems):
    """gamma^t-discounted returns of episodes run with the (N,) econ rows
    and the per-period orders and demand (lists of (N,) tensors)."""
    price, cost, h, k = econ[:4]
    P = [torch.zeros_like(price)] * params.lead_time
    total = torch.zeros_like(price)
    for t, disc in enumerate(_discounts(params.gamma, params.step_limit)):
        P, reward, _ = _nv_step_math(params, P, price, cost, h, k, orders[t], dems[t])
        total = total + disc * reward
    return total


def _episode_returns_nv_plain(params, econ, actions, demands, seed=None):
    """Plain version of K13: the episode loop of _nv_kernel over (B,) rows.
    ``actions`` (T, B), clipped to [0, max_order], or None with ``seed``:
    the random policy's orders, K16's action words of episode 0."""
    T, B = demands.shape
    lanes = torch.arange(B, dtype=torch.int64, device=demands.device)
    if actions is None:
        orders = [_nv_order(params, rng.period_words(seed, lanes, 0, t, 1)[0])
                  for t in range(T)]
    else:
        orders = [nv.clip_order(params, actions[t]) for t in range(T)]
    return _nv_returns(params, list(econ), orders, list(demands))


def _nv_fused_plain(params, seed, batch, E, device, econ=None, dump=False):
    """Plain version of K14-K17 for E * batch episodes, episode-major: the
    econ drawn from the words of period NV_ECON_PERIOD (K16, K17), or
    ``econ`` (5, batch) given (K14, K15, E = 1); each period's order and
    demand words, the demand inverted for all periods at once (the count
    does not depend on the chunk). Returns (E, batch) returns, or with
    ``dump`` (econ (E, 5, batch), actions (T, E, batch), demands
    (T, E, batch))."""
    T = params.step_limit
    idx = torch.arange(E * batch, dtype=torch.int64, device=device)
    episodes, lanes = idx // batch, idx % batch
    if econ is None:
        words = rng.period_words(seed, lanes, episodes, NV_ECON_PERIOD, 5)
        econ = list(_nv_econ_from_uniforms(params, [rng.uniform01(w) for w in words]))
    else:
        econ = list(econ.to(torch.float32))
    orders, us = [], []
    for t in range(T):
        w_act, w_dem = rng.period_words(seed, lanes, episodes, t, 2)
        orders.append(_nv_order(params, w_act))
        us.append(rng.uniform01(w_dem))
    dems = nv_poisson.demand(params, econ[4], us)
    if dump:
        return (torch.stack(econ).reshape(5, E, batch).transpose(0, 1),
                torch.stack(orders).reshape(T, E, batch),
                torch.stack(dems).reshape(T, E, batch))
    return _nv_returns(params, econ, orders, dems).reshape(E, batch)


def _check_nv_inputs(params, econ, *streams):
    tensors = (econ,) + tuple(s for s in streams if s is not None)
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError("econ, actions and demands must be float32")
    B = econ.shape[-1]
    if tuple(econ.shape) != (5, B):
        raise ValueError(f"expected econ (5, B); got {tuple(econ.shape)}")
    for s in tensors[1:]:
        if tuple(s.shape) != (params.step_limit, B) or s.device != econ.device:
            raise ValueError(f"expected streams ({params.step_limit}, {B}) on "
                             f"{econ.device}; got {tuple(s.shape)} on {s.device}")
    if econ.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {econ.device}")
    if econ.device.type == "cuda" and not all(x.is_contiguous() for x in tensors):
        raise ValueError("econ, actions and demands must be contiguous")


def _nv_returns_call(wrapper, params, econ, actions, demands, seed):
    """K13 for ``wrapper``: ``actions`` streamed in, or drawn from ``seed``."""
    _check_nv_inputs(params, econ, actions, demands)
    if econ.device.type == "cpu":
        return _episode_returns_nv_plain(params, econ, actions, demands, seed)
    dev = econ.device
    T, B = demands.shape
    plan = _nv_plan(params, _plan_key(dev))
    out = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("nv_episode", "nv_episode_returns", ctypes.addressof(plan["struct"]),
                econ.data_ptr(), None if actions is None else actions.data_ptr(),
                demands.data_ptr(), plan["disc"].data_ptr(), out.data_ptr(), seed or 0,
                int(actions is None), B, T, _stream(dev))
    wrapper.launches += 1
    return out


def episode_returns_nv(params: nv.NewsvendorParams, econ: torch.Tensor,
                       actions: torch.Tensor, demands: torch.Tensor) -> torch.Tensor:
    """gamma^t-discounted episode returns (B,) float32 for per-lane
    economics ``econ`` (5, B) [price, cost, h, k, mu] (mu unused: demand is
    given) and float32 streams ``actions`` (step_limit, B), clipped to
    [0, max_order] as the reference clips them, and ``demands``
    (step_limit, B), on one device. K13: on CUDA tensors one thread per env
    runs the whole episode, its pipeline in registers (an instance per lead
    time up to NV_MAX_L; past it the column instance, the pipeline in the
    thread's column of shared memory) and its streams staged into shared
    memory ahead of the step (csrc/nv_episode.cu ``k_nv_returns``, laid out
    by ``_nv_k13_launch``); on CPU tensors the plain version runs."""
    return _nv_returns_call(episode_returns_nv, params, econ, actions, demands, None)


episode_returns_nv.launches = 0


def episode_returns_nv_random(params: nv.NewsvendorParams, econ: torch.Tensor,
                              demands: torch.Tensor, seed) -> torch.Tensor:
    """Random-policy episode returns (B,) for ``econ`` (5, B) and the demand
    stream ``demands`` (step_limit, B): orders uniform on [0, max_order)
    drawn in the kernel from the words ``episode_returns_nv_reset_fused``
    draws for its episode 0, so that on ``sample_streams_debug_nv_reset``'s
    econ and demand it gives the reset-fused kernel's returns. K13 with its
    action draws switched on."""
    return _nv_returns_call(episode_returns_nv_random, params, econ, None, demands,
                            int(seed) & rng.MASK32)


episode_returns_nv_random.launches = 0


def _nv_fused_call(wrapper, params, seed, batch, episodes_per_lane, device, econ, dump):
    """K14/K15 (``econ`` given, E = 1) or K16/K17 for ``wrapper``: returns
    (E, B), or with ``dump`` (econ (E, 5, B), actions, demands (T, E, B))."""
    E = int(episodes_per_lane)
    if econ is not None:
        _check_nv_inputs(params, econ)
        dev, batch = econ.device, econ.shape[1]
    else:
        dev = resolve_device(device)
    if E < 1 or batch < 1:
        raise ValueError(f"need batch >= 1 and episodes_per_lane >= 1, got {batch}, {E}")
    seed = int(seed) & rng.MASK32
    if dev.type == "cpu":
        return _nv_fused_plain(params, seed, batch, E, dev, econ, dump)
    plan = _nv_plan(params, _plan_key(dev))
    T = params.step_limit
    f32 = dict(dtype=torch.float32, device=dev)
    out = None if dump else torch.empty((E, batch), **f32)
    econ_out = torch.empty((E, 5, batch), **f32) if dump and econ is None else None
    acts = torch.empty((T, E, batch), **f32) if dump else None
    dems = torch.empty((T, E, batch), **f32) if dump else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        _launch("nv_episode", "nv_episodes", ctypes.addressof(plan["struct"]),
                plan["lgam"].data_ptr(), ptr(econ), plan["disc"].data_ptr(), ptr(out),
                ptr(econ_out), ptr(acts), ptr(dems), seed, batch, E, T, _stream(dev))
    wrapper.launches += 1
    return (econ_out, acts, dems) if dump else out


def episode_returns_nv_fused(params: nv.NewsvendorParams, econ: torch.Tensor, seed):
    """Random-policy episode returns (B,) with the orders and the per-lane
    Poisson(mu) demand drawn in the kernel, for the economics ``econ``
    (5, B) of ``nv.draw_econ``-style resets. K14: one thread per lane
    (csrc/nv_episode.cu ``k_nv_episodes``); the demand inverts the CDF by
    ``nv_poisson.setup``/``invert``'s recurrence, run once per
    episode into a shared-memory table that each period searches. It draws
    ``episode_returns_nv_reset_fused``'s action and demand words of episode
    0."""
    return _nv_fused_call(episode_returns_nv_fused, params, seed, None, 1, None, econ,
                          False).reshape(-1)


episode_returns_nv_fused.launches = 0


def sample_streams_debug_nv(params: nv.NewsvendorParams, econ: torch.Tensor, seed):
    """The exact order and demand streams ``episode_returns_nv_fused`` draws
    for ``econ`` and ``seed``: (actions (T, B), demands (T, B)) float32. K15:
    the same kernel with its dump switched on."""
    _, acts, dems = _nv_fused_call(sample_streams_debug_nv, params, seed, None, 1, None,
                                   econ, True)
    return acts[:, 0], dems[:, 0]


sample_streams_debug_nv.launches = 0


def episode_returns_nv_reset_fused(params: nv.NewsvendorParams, seed, batch: int,
                                   episodes_per_lane: int = 1, device=None):
    """Random-policy Newsvendor episode returns with the reset fused too: the
    economics, the orders and the per-lane Poisson(mu) demand are all drawn
    in the kernel, gamma^t-discounted. K16: one thread per (episode, lane)
    (csrc/nv_episode.cu ``k_nv_episodes``, the Poisson table in shared
    memory, the block sized by ``_nv_table_plan``; past NV_MAX_L
    ``k_nv_episodes_column``, the pipeline after the table). Returns (batch,) for
    episodes_per_lane=1, else (episodes_per_lane, batch), episode-major.
    This is ``vector.fast_episodes.random_episode_returns``' Newsvendor
    path."""
    out = _nv_fused_call(episode_returns_nv_reset_fused, params, seed, batch,
                         episodes_per_lane, device, None, False)
    return out.reshape(batch) if episodes_per_lane == 1 else out


episode_returns_nv_reset_fused.launches = 0


def sample_streams_debug_nv_reset(params: nv.NewsvendorParams, seed, batch: int,
                                  episodes_per_lane: int = 1, device=None):
    """The exact econ, order and demand streams
    ``episode_returns_nv_reset_fused`` draws for ``seed``: (econ
    (E, 5, batch), actions (T, E, batch), demands (T, E, batch)) float32.
    K17: the same kernel with its dump switched on."""
    return _nv_fused_call(sample_streams_debug_nv_reset, params, seed, batch,
                          episodes_per_lane, device, None, True)


sample_streams_debug_nv_reset.launches = 0


# ====================================== Newsvendor policy kernels K18-K21

def _nv_half_hi(params: nv.NewsvendorParams):
    """[f32(0.5 * max_order)], the factor of ``order = (tanh(raw) + 1) *
    (0.5 * max_order)`` (pallas_episode_kernels.py:591, :1788)."""
    return [nv.as_f32(0.5 * float(params.max_order_quantity))]


def _nv_obs_rows(econ, P):
    """The Newsvendor observation as a list of (N,) rows
    (pallas_episode_kernels.py:586, :1783): [price, cost, h, k, mu], then the
    pipeline oldest first; for lead time 0 the econ alone (obs_dim 5)."""
    return list(econ) + list(P)


def _nv_policy_econ_plain(params, seed, lanes, episodes):
    """The reset's economics from the first five words of period
    NV_ECON_PERIOD under key (seed, 1)."""
    words = rng.period_words(seed, lanes, episodes, NV_ECON_PERIOD, 5, key1=rng.POLICY_KEY)
    return list(_nv_econ_from_uniforms(params, [rng.uniform01(w) for w in words]))


def _nv_policy_demand_plain(params, seed, lanes, episodes, mu):
    """Every period's demand from word 0 of its block under key (seed, 1),
    inverted at once (the count does not depend on the chunk)."""
    us = [rng.uniform01(rng.period_words(seed, lanes, episodes, t, 1, key1=rng.POLICY_KEY)[0])
          for t in range(params.step_limit)]
    return nv_poisson.demand(params, mu, us)


def _nv_policy_period_plain(params, layers, std, seed, lanes, episodes, t, econ, P,
                            policy="ppo", act_name="tanh"):
    """The stored value and the order of period ``t`` of the policy kernels
    (csrc/nv_policy.cu ``policy_period``, and K28's period) for every (lane,
    episode): the period's block under key (seed, 1), whose word 0 is the
    demand's and words 1.. the head's (``_head_words``: u1 and u2 of the
    normal, u1 alone for "uniform", none for the deterministic PPO head);
    the actor on ``_nv_obs_rows``; order = (a_norm + 1) * f32(0.5
    max_order). Returns (stored (N,), order (N,))."""
    obs = _nv_obs_rows(econ, P)
    n_head = _head_words(policy, 1, std is not None)
    if not n_head:
        raw = mlp_forward(layers, "tanh", obs)
        a_norm = torch.tanh(raw)
    else:
        words = rng.period_words(seed, lanes, episodes, t, 1 + n_head, key1=rng.POLICY_KEY)
        raw, a_norm = traj_policy(policy, act_name, 1, layers, std, obs,
                                  _head_noise(policy, words[1:]))
    return raw[0], (a_norm[0] + 1.0) * _nv_half_hi(params)[0]


def _rollout_traj_nv_plain(params, actor, std, seed, batch, device, policy="ppo",
                           act_name="tanh"):
    """Plain version of K18 (and, with another head or trunk, of K28): the
    streams of one stochastic-policy episode per lane, as
    ``rollout_traj_nv`` returns them."""
    T = params.step_limit
    layers = kernel_layers(actor, device)
    std = None if std is None else std.to(device)
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    econ = _nv_policy_econ_plain(params, seed, lanes, 0)
    dems = _nv_policy_demand_plain(params, seed, lanes, 0, econ[4])
    f32 = dict(dtype=torch.float32, device=device)
    out = dict(econ=torch.stack(econ), orders=torch.empty((T, batch), **f32),
               raw=torch.empty((T, 1, batch), **f32), reward=torch.empty((T, batch), **f32),
               demand=torch.stack(dems))
    P = [torch.zeros(batch, **f32)] * params.lead_time
    for t in range(T):
        raw, order = _nv_policy_period_plain(params, layers, std, seed, lanes, 0, t, econ, P,
                                             policy, act_name)
        P, reward, q = _nv_step_math(params, P, *econ[:4], order, dems[t])
        out["raw"][t, 0], out["orders"][t], out["reward"][t] = raw, q, reward
    return out


def _nv_policy_plain(params, actor, std, seed, batch, E, device, dump=False):
    """Plain version of K19 (and, with ``dump``, K20): returns (E, B), and
    the econ (E, 5, B), orders (T, E, B) and demand (T, E, B) they came from
    (None without ``dump``). ``std`` None is the deterministic policy. All
    E * B episodes run at once, episode-major, each with its own counter."""
    T = params.step_limit
    layers = kernel_layers(actor, device)
    std = None if std is None else std.to(device)
    idx = torch.arange(E * batch, dtype=torch.int64, device=device)
    episodes, lanes = idx // batch, idx % batch
    econ = _nv_policy_econ_plain(params, seed, lanes, episodes)
    dems = _nv_policy_demand_plain(params, seed, lanes, episodes, econ[4])
    orders = []
    P = [torch.zeros_like(econ[0])] * params.lead_time
    total = torch.zeros_like(econ[0])
    for t, disc in enumerate(_discounts(params.gamma, T)):
        _raw, order = _nv_policy_period_plain(params, layers, std, seed, lanes, episodes, t,
                                              econ, P)
        P, reward, _ = _nv_step_math(params, P, *econ[:4], order, dems[t])
        total = total + disc * reward
        orders.append(order)
    if not dump:
        return total.reshape(E, batch), None, None, None
    return (total.reshape(E, batch), torch.stack(econ).reshape(5, E, batch).transpose(0, 1),
            torch.stack(orders).reshape(T, E, batch), torch.stack(dems).reshape(T, E, batch))


def _sample_normals_plain(seed, rows, batch, device):
    """Plain version of K21: normal01(word 0, word 1) of counter (lane, 0,
    row, 0) under key (seed, 1), as (rows, batch) float32."""
    lanes = torch.arange(batch, dtype=torch.int64, device=device)
    return torch.stack([rng.normal01(*rng.period_words(seed, lanes, 0, r, 2,
                                                       key1=rng.POLICY_KEY))
                        for r in range(rows)])


def _nv_tile_actor(params: nv.NewsvendorParams, actor, std, device, general: bool = False):
    """The actor arguments of K18-K20 on the tensor-core tile
    (``_pack_tile_actor`` at the env's obs width, one action, and
    ``_nv_half_hi``): the struct and the packed buffer, the std last when
    given; ``_nv_tile_launch`` lays the tile out. MlpTile where the actor
    fits its arrays and ``_nv_tile_choice`` a block for it; else MlpTileG
    (``_nv_tile_choice_any``), as where ``general``."""
    dims = _actor_dims(actor, params.obs_dim, 1)
    general = general or not _within_fixed_tile(dims)
    if not general:
        st = _nv_plan(params, "cpu")["struct"]
        try:
            _nv_tile_choice(tuple(dims), st.L, st.K, params.step_limit, st.kc_max)
        except ValueError:
            general = True
    return _pack_tile_actor(actor, std, params.obs_dim, 1, _nv_half_hi(params), device,
                            general=general)


def _nv_policy_args(params, actor, log_std, batch, E, device):
    """(device, std or None, MlpTile struct, packed actor) of a K18-K20
    call (``_nv_tile_actor``); raises ValueError for a batch, E or actor
    the kernels do not take. The actor is packed only on the card (None,
    None on the CPU, where any actor that fits the env runs)."""
    dev = resolve_device(device)
    if E < 1 or batch < 1:
        raise ValueError(f"need batch >= 1 and episodes_per_lane >= 1, got {batch}, {E}")
    std = None if log_std is None else clipped_std(torch.as_tensor(log_std).detach())
    if dev.type == "cpu":
        _actor_dims(actor, params.obs_dim, 1)
        return dev, std, None, None
    st, flat = _nv_tile_actor(params, actor, std, dev)
    return dev, std, st, flat


class _NvTile(ctypes.Structure):
    """Mirror of ``struct NvTile`` in csrc/nv_policy.cu."""
    _fields_ = [("layout", ctypes.c_int), ("s_dem", ctypes.c_int), ("s_ring", ctypes.c_int),
                ("s_table", ctypes.c_int)]


NV_CHUNK = 16   # csrc/nv_step.cuh: the periods whose demand is inverted at once
# K19/K20's demand layouts (csrc/nv_policy.cu NV_DEM_*): the episode's
# demand searched up front where its table fits a block, else the linear
# count
NV_TILE_LAYOUTS = {"linear": 0, "upfront": 1}
# registers a thread of K19/K20's instances, the most ptxas -v reports on
# sm_90a (phase 2 of chip_smoke.py checks every fixed-class instance
# against it): what the plan's blocks an SM count
_NV_TILE_REGS = 178


@dataclasses.dataclass(frozen=True)
class NvTilePlan:
    """K19/K20's tile: ``lanes`` (lane, episode) pairs a block; the MLP
    tile's activation buffer (``rows`` at ``stride``, as ``_mlp_tile_plan``
    lays it out), the demand rows (``dem_rows``), the pipeline's L rows and,
    for the up-front layout, the table's K rows, each [row][lane] at a
    stride of ``lanes``, at the float ``offsets`` (x0, dem, ring, table; -1:
    none); ``floats`` in all, ``bytes``, and the blocks an SM holds by
    shared memory, registers (``_NV_TILE_REGS``) and threads."""
    layout: str
    lanes: int
    stride: int
    rows: int
    in_place: bool
    offsets: dict
    dem_rows: int
    floats: int
    bytes: int
    blocks_per_sm: int
    ws_floats: int = 0   # the general class's workspace slice a block (0: none)


def _nv_tile_plan(dims, L: int, K: int, T: int, lanes: int, layout: str) -> NvTilePlan:
    """The shared-memory layout of K19/K20's tile of ``lanes`` pairs for an
    actor of widths ``dims``, lead time ``L``, ``K`` recurrence steps and
    ``T`` periods, with the demand ``layout``:
    - "upfront": ceil(T / 2) rows of the episode's demand, two 16-bit
      values a word, then one region that holds the table while the reset
      searches it and the activation buffer and the pipeline after (a block
      barrier between): max(K rows, the buffer and L rows);
    - "linear": the activation buffer, then NV_CHUNK rows of the chunk's
      demand and the L rows of the pipeline."""
    act = _mlp_tile_plan(dims, 0, 0, 0, lanes)
    buf, N = act.floats, lanes
    if layout == "upfront":
        dem_rows = -(-T // 2)
        x0 = dem_rows * N
        offsets = {"x0": x0, "dem": 0, "ring": x0 + buf, "table": x0}
        floats = x0 + max(K * N, buf + L * N)
    else:
        dem_rows = NV_CHUNK
        offsets = {"x0": 0, "dem": buf, "ring": buf + NV_CHUNK * N, "table": -1}
        floats = buf + (NV_CHUNK + L) * N
    return NvTilePlan(layout, lanes, act.stride, act.rows, act.in_place, offsets, dem_rows,
                      floats, 4 * floats, _blocks_per_sm(4 * floats, lanes, _NV_TILE_REGS))


def _nv_tile_choice(dims, L: int, K: int, T: int, kc_max: int) -> NvTilePlan:
    """The entry points' plan: "upfront" at the first of ``_MLP_TILES``
    whose shared memory fits a block, else the linear count. "upfront"
    needs every demand below 2^16 (kc_max + 1 < 65,536). Raises ValueError
    if not even the linear count fits."""
    layouts = ["upfront"] if kc_max + 1 < 1 << 16 else []
    for name in layouts + ["linear"]:
        for lanes in _MLP_TILES:
            plan = _nv_tile_plan(dims, L, K, T, lanes, name)
            if plan.bytes <= SMEM_OPTIN_BYTES:
                return plan
    raise ValueError(f"actor of widths {list(dims)} at lead time {L}: K19's tile needs "
                     f"{plan.bytes} bytes; the shared memory of a block holds {SMEM_OPTIN_BYTES}")


def _nv_tile_plan_any(dims, L: int, K: int, T: int, lanes: int, layout: str,
                      workspace: bool = False) -> NvTilePlan:
    """``_nv_tile_plan`` for the general class (MlpTileG): the activation
    buffers of ``_mlp_tile_plan_any`` in shared memory, laid out as
    ``_nv_tile_plan`` lays out the fixed class's, or, with ``workspace``,
    in the workspace ("x0" then an offset from the block's slice), shared
    memory holding the demand rows, then one region for the table and, after
    it, the pipeline (both [row][lane] at a stride of ``lanes``, so a
    pair's rows are its own): dem_rows + max(K, L) rows for "upfront",
    NV_CHUNK + L for "linear"."""
    act = _mlp_tile_plan_any(dims, 0, 0, 0, lanes, workspace=workspace,
                             group=_NV_TILE_GROUP_ANY)
    N = lanes
    buf = 0 if workspace else act.act_floats
    if layout == "upfront":
        dem_rows = -(-T // 2)
        x0 = dem_rows * N
        offsets = {"x0": 0 if workspace else x0, "dem": 0, "ring": x0 + buf, "table": x0}
        floats = x0 + max(K * N, buf + L * N)
    else:
        dem_rows = NV_CHUNK
        offsets = {"x0": 0, "dem": buf, "ring": buf + NV_CHUNK * N, "table": -1}
        floats = buf + (NV_CHUNK + L) * N
    return NvTilePlan(layout, lanes, act.stride, act.rows, act.in_place, offsets, dem_rows,
                      floats, 4 * floats, _blocks_per_sm(4 * floats, lanes, _NV_TILE_REGS),
                      act.act_floats if workspace else 0)


def _nv_tile_choice_any(dims, L: int, K: int, T: int, kc_max: int) -> NvTilePlan:
    """The general class's plan: as ``_nv_tile_choice``, "upfront" (where
    every demand is below 2^16) before "linear", the activations in shared
    memory at the first of ``_MLP_TILES`` that fits, else in the workspace.
    Raises ValueError where none fits, naming the bytes."""
    layouts = ["upfront"] if kc_max + 1 < 1 << 16 else []
    plans = [_nv_tile_plan_any(dims, L, K, T, lanes, name, workspace)
             for name in layouts + ["linear"] for workspace in (False, True)
             for lanes in _MLP_TILES]
    for plan in plans:
        if plan.bytes <= SMEM_OPTIN_BYTES and 4 * plan.ws_floats <= WORKSPACE_MAX_BYTES:
            return plan
    least = min(plans, key=lambda pl: pl.bytes)
    raise ValueError(f"actor of widths {list(dims)} at lead time {L}: K19's tile needs "
                     f"{least.bytes} bytes of shared memory beside {4 * least.ws_floats} of "
                     f"workspace; a block holds {SMEM_OPTIN_BYTES} and the workspace "
                     f"{WORKSPACE_MAX_BYTES}")


def _nv_tile_structs(st, plan: NvTilePlan):
    """(a copy of the packed actor's tile struct laid out as ``plan``, its
    NvTile). MlpTileG's second buffer follows its first's rows[0] rows, its
    workspace slice is the plan's."""
    tile = type(st).from_buffer_copy(st)
    tile.lanes, tile.stride = plan.lanes, plan.stride
    x0 = plan.offsets["x0"]
    tile.s_x0 = x0
    rows = plan.rows[0] if isinstance(plan.rows, tuple) else plan.rows
    tile.s_x1 = x0 if plan.in_place else x0 + rows * plan.stride
    tile.s_dem = tile.s_z = tile.s_scratch = -1   # the demand has rows of its own
    tile.s_state = plan.offsets["ring"]
    tile.s_total = plan.floats
    nt = _NvTile(layout=NV_TILE_LAYOUTS[plan.layout], s_dem=plan.offsets["dem"],
                 s_ring=plan.offsets["ring"], s_table=plan.offsets["table"])
    if isinstance(tile, _MlpTileG):
        tile.ws_floats = plan.ws_floats
    return tile, nt


def _nv_tile_launch(st, nv_st: _NvParams, T: int):
    """K18-K20's (tile struct, NvTile) for the packed actor's ``st`` and the
    launch plan's params struct ``nv_st`` at ``T`` periods: the layout
    ``_nv_tile_choice`` takes (``_nv_tile_choice_any`` for MlpTileG)."""
    if isinstance(st, _MlpTileG):
        return _nv_tile_structs(st, _nv_tile_choice_any(st.actor_dims, nv_st.L, nv_st.K, T,
                                                        nv_st.kc_max))
    return _nv_tile_structs(st, _nv_tile_choice(tuple(st.dims[:st.n_layers + 1]), nv_st.L,
                                                nv_st.K, T, nv_st.kc_max))


def rollout_traj_nv(params: nv.NewsvendorParams, actor, log_std, seed, batch: int,
                    policy: str = "ppo", act_name: str = "tanh", device=None):
    """One full stochastic-policy Newsvendor episode per lane with the
    training streams written out. ``actor`` is ``(Ws, bs)`` from
    ``fold_actor_params``; ``log_std`` the policy's log-std, clipped through
    ``clipped_std``. Returns a dict, all float32: ``econ (5, batch)``,
    ``orders (T, batch)`` (the capped orders, the obs pipeline's stream),
    ``raw (T, 1, batch)`` (pre-squash samples), ``reward (T, batch)``
    (undiscounted, env semantics) and ``demand (T, batch)``. K18: K19's tile
    with one stochastic episode a lane and the streams written, the actor on
    the tensor cores and every period's demand searched at the reset
    (csrc/nv_policy.cu ``k_nv_policy_returns<1, 0, 1, LAYOUT>`` on
    csrc/mlp_tile.cuh, laid out by ``_nv_tile_choice`` as K19), so its
    streams are the stochastic K19's episode 0 for the same seed; a launch
    that fails raises. On the CPU the plain version runs.
    ``policy``/``act_name`` select the head and the trunk (``traj_policy``):
    the default ("ppo", "tanh") is K18's; any other pair is
    ``rollout_traj_nv_offpolicy``'s (K28), whose ``raw`` holds the
    normalised [-1, 1] orders."""
    _check_head(policy, act_name)
    if (policy, act_name) != ("ppo", "tanh"):
        return rollout_traj_nv_offpolicy(params, actor, log_std, seed, batch, policy,
                                         act_name, device)
    if log_std is None:
        raise ValueError("rollout_traj_nv samples the stochastic policy: log_std is required")
    dev, std, st, flat = _nv_policy_args(params, actor, log_std, batch, 1, device)
    seed = int(seed) & rng.MASK32
    if dev.type == "cpu":
        return _rollout_traj_nv_plain(params, actor, std, seed, batch, dev)
    plan = _nv_plan(params, _plan_key(dev))
    T = params.step_limit
    tile, nt = _nv_tile_launch(st, plan["struct"], T)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(econ=torch.empty((5, batch), **f32), orders=torch.empty((T, batch), **f32),
               raw=torch.empty((T, 1, batch), **f32), reward=torch.empty((T, batch), **f32),
               demand=torch.empty((T, batch), **f32))
    with torch.cuda.device(dev):
        fn = "nv_rollout_traj" + _tile_launch(tile, batch, dev)
        _launch("nv_policy", fn, ctypes.addressof(plan["struct"]),
                ctypes.addressof(tile), ctypes.addressof(nt), flat.data_ptr(),
                plan["lgam"].data_ptr(),
                *(out[k].data_ptr() for k in ("econ", "orders", "raw", "reward", "demand")),
                seed, batch, T, _stream(dev))
    rollout_traj_nv.launches += 1
    return out


rollout_traj_nv.launches = 0


def _nv_wide_extra(params: nv.NewsvendorParams) -> int:
    """Floats of shared memory K28's wide route keeps a block beside the
    activations: the 32 lanes' pipelines, L rows of ``_WIDE_LANES``."""
    return _WIDE_LANES * params.lead_time


def rollout_traj_nv_offpolicy(params: nv.NewsvendorParams, actor, log_std, seed, batch: int,
                              policy: str = "det", act_name: str = "relu", device=None):
    """``rollout_traj_nv`` under the off-policy heads (see
    ``rollout_traj_im_offpolicy``): one episode per lane of the folded
    actor with the head ``policy`` on an ``act_name`` trunk. Returns
    ``rollout_traj_nv``'s dict, ``raw (T, 1, batch)`` holding the normalised
    [-1, 1] orders (the pre-squash samples for "ppo"). The stream is K18's:
    the reset's words, per period the demand's word 0, then the head's, so
    its econ and demand are K18's for the same seed. K28 on the card: a
    thread-block cluster a tile of lanes (csrc/nv_policy.cu
    ``k_nv_rollout_traj_cluster`` on csrc/cluster_mlp.cuh), each tile's
    demand counted up front into shared memory, for any actor and horizon
    a cluster tile holds (``_cluster_choice``); otherwise the wide route
    (``k_nv_rollout_traj_wide`` on csrc/wide_mlp.cuh), chosen from the
    sizes before the launch. Either launch that fails raises. On the CPU
    the plain version runs."""
    _check_head(policy, act_name)
    dev = resolve_device(device)
    if batch < 1:
        raise ValueError(f"need batch >= 1, got {batch}")
    seed = int(seed) & rng.MASK32
    std = _offpolicy_std(policy, log_std)
    if dev.type == "cpu":
        _head_dims(actor, params.obs_dim, 1, policy)
        return _rollout_traj_nv_plain(params, actor, std, seed, batch, dev, policy, act_name)
    plan = _nv_plan(params, _plan_key(dev))
    T = params.step_limit
    relu = int(act_name == "relu")
    packed = _pack_cluster_actor(actor, std, params.obs_dim, 1, policy, _nv_half_hi(params), T,
                                 params.obs_dim + 1, True, dev)
    if packed is None:   # the wide route: no cluster tile holds the actor and the demand
        st, flat = _pack_wide_actor(actor, std, params.obs_dim, 1, policy, _nv_half_hi(params),
                                    dev, _nv_wide_extra(params))
        fn = "nv_rollout_traj_wide" + _wide_launch(st, batch, dev)
    else:
        fn = "nv_rollout_traj_cluster"
        st, flat = packed
        with torch.cuda.device(dev):
            _set_cluster_grid(st, batch, "nv_policy", "nv_rollout_traj_cluster_occupancy",
                              (relu,), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(econ=torch.empty((5, batch), **f32), orders=torch.empty((T, batch), **f32),
               raw=torch.empty((T, 1, batch), **f32), reward=torch.empty((T, batch), **f32),
               demand=torch.empty((T, batch), **f32))
    with torch.cuda.device(dev):
        _launch("nv_policy", fn, ctypes.addressof(plan["struct"]),
                ctypes.addressof(st), flat.data_ptr(), plan["lgam"].data_ptr(),
                *(out[k].data_ptr() for k in ("econ", "orders", "raw", "reward", "demand")),
                seed, relu, batch, T, _stream(dev))
    rollout_traj_nv_offpolicy.launches += 1
    rollout_traj_nv_offpolicy.route = "wide" if packed is None else "cluster"
    return out


rollout_traj_nv_offpolicy.launches = 0
rollout_traj_nv_offpolicy.route = None   # the last launch's: "cluster" or "wide"


def _nv_policy_call(wrapper, params, actor, seed, batch, episodes_per_lane, log_std, dump,
                    device):
    """K19 (``dump`` False) or K20 for ``wrapper``: (returns (E, B), econ
    (E, 5, B), orders (T, E, B), demands (T, E, B)), the streams None
    without ``dump``."""
    E = int(episodes_per_lane)
    dev, std, st, flat = _nv_policy_args(params, actor, log_std, batch, E, device)
    seed = int(seed) & rng.MASK32
    if dev.type == "cpu":
        return _nv_policy_plain(params, actor, std, seed, batch, E, dev, dump)
    plan = _nv_plan(params, _plan_key(dev))
    T = params.step_limit
    nv_st = plan["struct"]
    tile, nt = _nv_tile_launch(st, nv_st, T)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((E, batch), **f32)
    econ = acts = dems = None
    if dump:
        econ = torch.empty((E, 5, batch), **f32)
        acts = torch.empty((T, E, batch), **f32)
        dems = torch.empty((T, E, batch), **f32)
    with torch.cuda.device(dev):
        fn = "nv_policy_returns" + _tile_launch(tile, E * batch, dev)
        _launch("nv_policy", fn, ctypes.addressof(nv_st),
                ctypes.addressof(tile), ctypes.addressof(nt), flat.data_ptr(),
                plan["lgam"].data_ptr(), plan["disc"].data_ptr(), out.data_ptr(),
                *(None if x is None else x.data_ptr() for x in (econ, acts, dems)),
                seed, int(std is not None), batch, E, T, _stream(dev))
    wrapper.launches += 1
    return out, econ, acts, dems


def episode_returns_nv_policy(params: nv.NewsvendorParams, actor, seed, batch: int,
                              episodes_per_lane: int = 1, log_std=None, device=None):
    """Learned-policy Newsvendor episode returns with the reset, the per-lane
    Poisson(mu) demand and the MLP actor all run inside the kernel,
    gamma^t-discounted. ``actor`` is ``(Ws, bs)`` from ``fold_actor_params``.
    Deterministic by default; with the trained ``log_std`` ((1,)) the orders
    come from tanh-squashed Gaussian samples around the mean. K19: a block
    per tile of (episode, lane) pairs, one thread each, the actor on the
    tensor cores and every period's demand searched at the reset
    (csrc/nv_policy.cu ``k_nv_policy_returns`` on csrc/mlp_tile.cuh, laid
    out by ``_nv_tile_choice``); on the CPU the plain version runs. Returns
    (batch,) for episodes_per_lane=1, else (episodes_per_lane, batch),
    episode-major. This is ``vector.fast_episodes.policy_episode_returns``'
    Newsvendor path."""
    out = _nv_policy_call(episode_returns_nv_policy, params, actor, seed, batch,
                          episodes_per_lane, log_std, False, device)[0]
    return out.reshape(batch) if episodes_per_lane == 1 else out


episode_returns_nv_policy.launches = 0


def sample_policy_streams_debug_nv(params: nv.NewsvendorParams, actor, seed, batch: int,
                                   episodes_per_lane: int = 1, log_std=None, device=None):
    """(returns, econ (E, 5, batch), orders (T, E, batch), demands
    (T, E, batch)), all float32: ``episode_returns_nv_policy`` with the
    economics, the orders (before the max_inventory cap) and the demand it
    used written out. K20: the same kernel with its dump switched on, so the
    streams are exactly the ones K19 consumes for the same seed. Returns are
    (batch,) for episodes_per_lane=1, else (E, batch)."""
    out, econ, acts, dems = _nv_policy_call(sample_policy_streams_debug_nv, params, actor,
                                            seed, batch, episodes_per_lane, log_std, True,
                                            device)
    return (out.reshape(batch) if episodes_per_lane == 1 else out), econ, acts, dems


sample_policy_streams_debug_nv.launches = 0


def sample_normals_debug(seed, rows: int, batch: int, device=None) -> torch.Tensor:
    """(rows, batch) float32 of the policy kernels' Box-Muller standard
    normals, for a goodness-of-fit pin: element (row, lane) is normal01 of
    words 0 and 1 of counter (lane, 0, row, 0) under key (seed, 1). K21: a
    thread walks eight rows of one lane on a 2-D grid (csrc/nv_policy.cu
    ``k_sample_normals``); on the CPU the plain version runs."""
    dev = resolve_device(device)
    if rows < 1 or batch < 1:
        raise ValueError(f"need rows >= 1 and batch >= 1, got {rows}, {batch}")
    seed = int(seed) & rng.MASK32
    if dev.type == "cpu":
        return _sample_normals_plain(seed, rows, batch, dev)
    out = torch.empty((rows, batch), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("nv_policy", "sample_normals", out.data_ptr(), seed, batch, rows, _stream(dev))
    sample_normals_debug.launches += 1
    return out


sample_normals_debug.launches = 0
