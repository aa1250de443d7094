"""InvManagement and Newsvendor whole-episode kernels, the folded actor of
the policy kernels, and the plain versions of the in-kernel helpers.

Port of ``or_gym_inventory_tpu/ops/pallas_episode_kernels.py``: the
InvManagement kernels (``csrc/im_episode.cu``, ``csrc/im_policy.cu``, and
under the LSTM actor ``csrc/im_lstm.cu``) and the Newsvendor kernels
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

# maxima of the actor the policy kernels take (csrc/mlp.cuh); a block's
# layout must fit the dynamic shared memory a Hopper block may opt in to
# (227 KB)
MAX_LAYERS, MAX_WIDTH, MAX_ACT = 8, 256, 32
SMEM_OPTIN_BYTES = 232_448
# an H100 SM's shared memory, the share the runtime reserves per resident
# block, and the SM's limits on resident threads and blocks
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 233_472, 1_024
THREADS_PER_SM, BLOCKS_PER_SM = 2_048, 32
# and of the InvManagement params struct (csrc/im_step.cuh)
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
    with ``act_name`` ("tanh" or "relu", which keeps a NaN as jnp.maximum
    does) after every layer but the last. Returns (outputs, B)."""
    if act_name not in _TRUNKS:
        raise ValueError(f"unknown act_name {act_name!r}; the trunks are tanh and relu")
    act = _TRUNKS[act_name]
    H = torch.stack([r.to(torch.float32) for r in obs_rows])
    for i, (W, b) in enumerate(layers):
        H = W @ H + b
        if i < len(layers) - 1:
            H = act(H)
    return H


def traj_policy(mode: str, act_name: str, act_dim: int, layers, std, obs_rows,
                z: torch.Tensor):
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

    The off-policy heads store a_norm. An unknown mode raises ValueError."""
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


def _head_noise(mode: str, words):
    """The head's noise (act_dim, B) from the period's words after the
    demand's: the act_dim u1 then act_dim u2 words as Box-Muller normals,
    or for ``"uniform"`` the act_dim u1 words as uniforms."""
    if mode == "uniform":
        return rng.uniform01(torch.stack(words))
    n = len(words) // 2
    return rng.normal01(torch.stack(words[:n]), torch.stack(words[n:]))


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
    """``_actor_dims``, raising ValueError beyond the MLP kernels' maxima."""
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


# M-tiles of 16 outputs a warp holds at once (csrc/mlp_tile.cuh MLP_TILE_GROUP)
_MLP_TILE_GROUP = 4
# the tiles the entry points take, in order of preference: the first whose
# shared memory fits a block (the kernels take any multiple of 32)
_MLP_TILES = (64, 32)


def _mlp_tile_plan(dims, dem_rows: int, scratch_rows: int, state_words: int,
                   lanes: int) -> MlpTilePlan:
    """The layout of a tile of ``lanes`` pairs for an actor of widths
    ``dims``: the activations (the obs rows padded to 8, each layer's
    outputs to 16; in place when each layer is one product, since it reads
    all of its inputs before it writes: a hidden layer of one M-tile or of
    a group of ``_MLP_TILE_GROUP``, an output layer of one M-tile; else
    two ping-pong buffers), then ``state_words``
    words a lane of state that lasts the episode. The period's transient
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
    return MlpTilePlan(lanes, stride, rows, in_place, offsets, state + state_words * lanes)


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


@functools.lru_cache(maxsize=32)
def _tile_pack_plan(dims, with_std: bool, half_hi, dem_rows: int, scratch_rows: int,
                    state_words: int, device: str):
    """(the MlpTile struct, the gather index and a zero, both on ``device``)
    of ``_pack_tile_actor``: the packed buffer is ``_gather_source``'s
    concatenation gathered by the index. Built once per shape, so a call
    packs with a few launches."""
    plans = [_mlp_tile_plan(dims, dem_rows, scratch_rows, state_words, lanes)
             for lanes in _MLP_TILES]
    plan = next((pl for pl in plans if pl.floats * 4 <= SMEM_OPTIN_BYTES), None)
    if plan is None:
        raise ValueError(f"actor of widths {list(dims)} with {state_words} words of state a "
                         f"lane needs {min(pl.floats for pl in plans) * 4} bytes; the shared "
                         f"memory of a block holds {SMEM_OPTIN_BYTES}")
    pairs = list(zip(dims, dims[1:]))
    w_src, b_src, std_src, zero = _gather_source(dims, with_std)
    st = _MlpTile(n_layers=len(pairs), std=-1)
    parts, at = [], 0
    for layer, (i, o) in enumerate(pairs):
        W = torch.full((_pad16(o), _pad8(i)), zero, dtype=torch.int64)   # W^T, zero-padded
        W[:o, :i] = torch.from_numpy(w_src[layer] + np.arange(i)[None, :] * o
                                     + np.arange(o)[:, None])
        b = torch.full((_pad16(o),), zero, dtype=torch.int64)
        b[:o] = torch.from_numpy(b_src[layer] + np.arange(o))
        st.w[layer], st.b[layer] = at, at + W.numel()
        parts += [_mma_fragments(W), b]
        at += W.numel() + b.numel()
    if with_std:
        st.std = at
        parts.append(torch.from_numpy(std_src + np.arange(dims[-1])))
    for k, d in enumerate(dims):
        st.dims[k] = d
    for k, h in enumerate(half_hi):
        st.half_hi[k] = h
    _set_mlp_tile(st, plan)
    return (st, torch.cat(parts).to(device),
            torch.zeros(1, dtype=torch.float32, device=device))


def _pack_tile_actor(actor, std, obs_dim: int, act_dim: int, half_hi, device,
                     dem_rows: int = 0, scratch_rows: int = 0, state_words: int = 0):
    """The tile kernels' actor arguments: the MlpTile struct and one flat
    float32 buffer on ``device``. The buffer holds each layer's W as the A
    fragments of the tensor-core product (W^T zero-padded to (pad16(out),
    pad8(in)), in ``_mma_fragments``' order) and its b padded to 16, then
    the std when given; every NaN as the quiet NaN 0x7fc00000. The struct
    carries their offsets, ``half_hi`` (the f32 factor that maps
    tanh(raw_i) + 1 onto action i's range), the tile (the first of
    ``_MLP_TILES`` whose layout, ``_mlp_tile_plan`` with ``dem_rows``,
    ``scratch_rows`` and ``state_words``, fits a block) and the layout
    (``_tile_pack_plan``, cached). Raises ValueError for an actor beyond the
    kernels' maxima, as ``_pack_actor`` does, or beyond the shared memory
    of a block."""
    dims = _mlp_dims(actor, obs_dim, act_dim)
    dev = torch.device(device)
    st, index, zero = _tile_pack_plan(tuple(dims), std is not None,
                                      tuple(float(h) for h in half_hi), dem_rows, scratch_rows,
                                      state_words, _plan_key(dev) if dev.type == "cuda" else "cpu")
    return st, _quiet_nans(_gather(actor, std, index, zero, dev))


# maxima of the wide actor of K27-K29 (csrc/wide_mlp.cuh): layers and the
# env's actions; its widths are bounded by the shared memory of a block
WIDE_MAX_LAYERS, WIDE_MAX_ACT = 8, 32
_WIDE_LANES = 32   # kWideLanes of csrc/wide_mlp.cuh: the lanes a block runs


class _WideMlp(ctypes.Structure):
    """Mirror of ``struct WideMlp`` in csrc/wide_mlp.cuh."""
    _fields_ = [("n_layers", ctypes.c_int), ("dims", ctypes.c_int * (WIDE_MAX_LAYERS + 1)),
                ("rows", ctypes.c_int), ("act", ctypes.c_int), ("head", ctypes.c_int),
                ("std", ctypes.c_int), ("half_hi", ctypes.c_float * WIDE_MAX_ACT)]


@functools.lru_cache(maxsize=32)
def _wide_pack_plan(dims, act_dim: int, policy: str, half_hi, device: str):
    """(the WideMlp struct, the gather index and a zero on ``device``) of
    ``_pack_wide_actor``, built once per shape."""
    with_std = policy in ("ppo", "det")
    w_src, b_src, std_src, zero = _gather_source(dims, with_std)
    parts = []
    for layer, (i, o) in enumerate(zip(dims, dims[1:])):
        W = np.full((i, _pad8(o)), zero, np.int64)   # W^T (in, out8), zero-padded
        W[:, :o] = w_src[layer] + np.arange(i)[:, None] * o + np.arange(o)[None, :]
        b = np.full(_pad8(o), zero, np.int64)
        b[:o] = b_src[layer] + np.arange(o)
        parts += [W.reshape(-1), b]
    rows = max([dims[0]] + [_pad8(d) for d in dims[1:]])
    st = _WideMlp(n_layers=len(dims) - 1, rows=rows, act=act_dim, head=HEADS[policy], std=-1)
    if with_std:
        st.std = sum(x.size for x in parts)
        parts.append(std_src + np.arange(act_dim))
    for k, d in enumerate(dims):
        st.dims[k] = d
    for i, h in enumerate(half_hi):
        st.half_hi[i] = h
    return (st, torch.from_numpy(np.concatenate(parts)).to(device),
            torch.zeros(1, dtype=torch.float32, device=device))


def _pack_wide_actor(actor, std, obs_dim: int, act_dim: int, policy: str, half_hi, device):
    """The wide kernels' actor arguments: the WideMlp struct (the head,
    ``half_hi[i]`` the f32 factor that maps a_norm_i + 1 onto action i's
    range) and one flat float32 buffer on ``device``, each layer as W^T
    (in, out8) then b (out8), the outputs zero-padded to a multiple of 8,
    then the std when the head takes one ("ppo", "det"). The layout and its
    gather index are cached per shape (``_wide_pack_plan``), so a call packs
    with one cat and one index. Raises ValueError for an actor beyond the
    kernels' maxima or whose two activation buffers of 32 lanes exceed the
    shared memory of a block."""
    dims = _head_dims(actor, obs_dim, act_dim, policy)
    if len(dims) - 1 > WIDE_MAX_LAYERS or act_dim > WIDE_MAX_ACT:
        raise ValueError(f"actor widths {dims}: the wide kernels take at most "
                         f"{WIDE_MAX_LAYERS} layers and {WIDE_MAX_ACT} actions")
    rows = max([dims[0]] + [_pad8(d) for d in dims[1:]])
    smem = 2 * rows * _WIDE_LANES * 4
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"actor of widths {dims}: two activation buffers of {rows} rows x "
                         f"{_WIDE_LANES} lanes need {smem} bytes; the shared memory of a block "
                         f"holds {SMEM_OPTIN_BYTES}")
    dev = torch.device(device)
    st, index, zero = _wide_pack_plan(tuple(dims), act_dim, policy,
                                      tuple(float(h) for h in half_hi[:act_dim]),
                                      _plan_key(dev) if dev.type == "cuda" else "cpu")
    return st, _gather(actor, std if st.std >= 0 else None, index, zero, dev)


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
    at the reset; "uniform" keeps the episode's)."""
    dem_rows: int = 1
    pad: int = 8
    out_in_x0: bool = False
    noise_per_period: bool = False


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
    cluster tile fits (the wide route); raises ValueError for an actor
    beyond the maxima."""
    dims = _head_dims(actor, obs_dim, act_dim, policy)
    if len(dims) - 1 > WIDE_MAX_LAYERS or act_dim > WIDE_MAX_ACT:
        raise ValueError(f"actor widths {dims}: the wide kernels take at most "
                         f"{WIDE_MAX_LAYERS} layers and {WIDE_MAX_ACT} actions")
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


@functools.lru_cache(maxsize=32)
def _im_plan(params: im.InvManagementParams, device: str, with_demand: bool = True):
    """A launch's host-built arguments: ``_im_host_plan`` and the params
    struct of the CUDA kernels. Raises ValueError for params beyond the
    struct's maxima."""
    m1, lt = params.m1, params.lt_max
    if m1 > IM_MAX_M1 or lt > IM_MAX_LT:
        raise ValueError(f"InvManagement params too large for the CUDA kernels: "
                         f"m1={m1} (max {IM_MAX_M1}), lt_max={lt} (max {IM_MAX_LT})")
    host = _im_host_plan(params, device, with_demand)
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
    return dict(host, struct=st, fused=_ImSmem(threads=fused.threads, words=fused.words),
                k7=_im_k7_plan(m1, lt).struct())


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
# checks); the largest block the plan tries
_IM_FUSED_REGS = {1: 32, 2: 32, 3: 32, 4: 40, 5: 44, 6: 46, 7: 47, 8: 54}
_IM_FUSED_MAX_THREADS = 256


@functools.lru_cache(maxsize=64)
def _im_fused_plan(m1: int, lt: int) -> ImFusedPlan:
    """The block size, among multiples of 32 up to 256, at which an SM holds
    the most threads of K8 (the smallest such block, for the fullest last
    wave) with ``lt * m1`` words of ring a thread, counting the SM's shared
    memory, registers (``_IM_FUSED_REGS`` a thread of the instance for
    this m1), threads and blocks. Every (m1, lt) within the struct maxima
    fits a block of 32 (256 words, 32 KB)."""
    words = lt * m1
    regs = _IM_FUSED_REGS[m1]
    best = None
    for threads in range(32, _IM_FUSED_MAX_THREADS + 1, 32):
        nbytes = 4 * words * threads
        if nbytes > SMEM_OPTIN_BYTES:
            break
        plan = ImFusedPlan(threads, words, nbytes, _blocks_per_sm(nbytes, threads, regs))
        if best is None or plan.blocks_per_sm * threads > best.blocks_per_sm * best.threads:
            best = plan
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


def _im_k7_layout(m1: int, lt: int, chunk: int, threads: int):
    """K7's layout at ``chunk`` periods a buffer and ``threads`` a block, or
    None where the block exceeds the shared memory a block may opt in to."""
    ring = lt * m1
    words = ring + 2 * chunk * (m1 + 1)
    nbytes = 4 * words * threads
    if nbytes > SMEM_OPTIN_BYTES:
        return None
    blocks = min(SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK_RESERVED), THREADS_PER_SM // threads,
                 BLOCKS_PER_SM)
    return ImK7Plan(threads, words, ring, chunk, nbytes, blocks)


@functools.lru_cache(maxsize=64)
def _im_k7_plan(m1: int, lt: int, chunk: int = None, threads: int = None) -> ImK7Plan:
    """K7's shared memory for ``m1`` stocked stages and lead-time ring depth
    ``lt``: the ring's lt m1 words, then 2 x ``chunk`` x (m1 + 1) staging
    words a thread, at ``threads`` a block; either left None is chosen from
    ``IM_K7_CHUNKS`` / ``IM_K7_THREADS`` (the first layout that holds
    ``IM_K7_RESIDENT`` threads an SM, else the first that holds the most).
    Raises ValueError where no block holds a layout."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"K7 stages at least one period a buffer, got {chunk}")
    layouts = [_im_k7_layout(m1, lt, c, n)
               for c in (IM_K7_CHUNKS if chunk is None else (chunk,))
               for n in (IM_K7_THREADS if threads is None else (threads,))]
    layouts = [plan for plan in layouts if plan is not None]
    if not layouts:
        raise ValueError(f"K7's ring of {lt * m1} words and its staging fit no block "
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

def _im_tile_actor(params: im.InvManagementParams, actor, std, device):
    """The actor arguments of K10-K12 on the tensor-core tile
    (``_pack_tile_actor`` at the env's obs and act widths and ``_half_c``):
    the MlpTile struct and the packed buffer, the std last when given."""
    return _pack_tile_actor(actor, std, im.observation_space(params).shape[0], params.m1,
                            _half_c(params), device)


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
            _launch("im_episode", "im_sample_streams", *args, acts.data_ptr(),
                    dems.data_ptr(), seed, batch, E, T, _stream(dev))
            out = (acts, dems)
        else:
            out = torch.empty((E, batch), dtype=torch.float32, device=dev)
            lay = plan["fused"]
            _launch("im_episode", "im_episode_returns_fused", args[0], ctypes.addressof(lay),
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
    st, flat = _im_tile_actor(params, actor, std, dev)
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
    lanes (csrc/im_policy.cu ``k_im_rollout_traj_cluster`` on
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
    packed = _pack_cluster_actor(actor, std, obs_dim, m1, policy, _half_c(params), T, obs_dim,
                                 False, dev)
    if packed is None:   # the wide route: no cluster tile holds the actor
        fn = "im_rollout_traj_wide"
        st, flat = _pack_wide_actor(actor, std, obs_dim, m1, policy, _half_c(params), dev)
    else:
        fn = "im_rollout_traj_cluster"
        st, flat = packed
        with torch.cuda.device(dev):
            _set_cluster_grid(st, batch, "im_policy", "im_rollout_traj_cluster_occupancy", flags,
                              dev)
    plan = _im_plan(params, _plan_key(dev))
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(inv=torch.empty((T + 1, m1, batch), **i32),
               actions=torch.empty((T, m1, batch), **i32),
               raw=torch.empty((T, m1, batch), **f32),
               reward=torch.empty((T, batch), **f32),
               demand=torch.empty((T, batch), **i32))
    with torch.cuda.device(dev):
        _launch("im_policy", fn, ctypes.addressof(plan["struct"]),
                ctypes.addressof(st), flat.data_ptr(), plan["table"].data_ptr(),
                plan["user_d"].data_ptr(), plan["disc"].data_ptr(),
                *(out[k].data_ptr() for k in ("inv", "actions", "raw", "reward", "demand")),
                seed, *flags, batch, T, _stream(dev))
    rollout_traj_im_offpolicy.launches += 1
    rollout_traj_im_offpolicy.route = "wide" if packed is None else "cluster"
    return out


rollout_traj_im_offpolicy.launches = 0
rollout_traj_im_offpolicy.route = None   # the last launch's: "cluster" or "wide"


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
    st, flat = _im_tile_actor(params, actor, std, dev)
    plan = _im_plan(params, _plan_key(dev))
    out = torch.empty((E, batch), dtype=torch.float32, device=dev)
    acts = dems = None
    if dump:
        acts = torch.empty((T, E, m1, batch), dtype=torch.int32, device=dev)
        dems = torch.empty((T, E, batch), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("im_policy", "im_policy_returns", ctypes.addressof(plan["struct"]),
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

# maxima of the LSTM kernels (csrc/lstm.cuh): encoder layers, the hidden
# width (a multiple of 4, padded to the unit groups of 8 of the tensor-core
# product; at most LSTM_MAX_GROUPS groups), actions; the widths are bounded
# by the shared memory of a block
LSTM_MAX_ENC, LSTM_MAX_HIDDEN, LSTM_MAX_ACT = 4, 128, 8


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


def _lstm_on(actor, device) -> dict:
    """``actor`` with every tensor float32 on ``device``."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return dict(enc=[(t(W), t(b)) for W, b in actor["enc"]],
                **{k: t(actor[k]) for k in ("wx", "wh", "bh", "wm", "bm")})


def lstm_forward(actor, obs_rows, H, C):
    """Plain version of the in-kernel LSTM actor (csrc/lstm.cuh
    ``lstm_forward``; pallas_episode_kernels.py:1391-1403): the obs rows,
    each (B,), stacked to (obs_dim, B), the tanh encoder, the gates
    G = Wx @ E + Wh @ H + bh, the cell, and the mean head. ``H`` and ``C``
    are (hidden, B). Returns (mean (act, B), H', C')."""
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
    kernels (csrc/im_lstm.cu ``lane_draws``/``lane_act``), K10's stream
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
    float offsets ``offsets`` (e, h0, h1, x0, x1, m, z), ``floats`` in all."""
    lanes: int
    warps_m: int
    threads: int
    e_pad: int
    h_pad: int
    k_steps: int
    stride: int
    offsets: dict
    floats: int


def _lstm_plan(dims, h: int, act_dim: int, tile) -> LstmPlan:
    """The layout of tile ``(lanes, warps_m)`` for an actor of widths
    ``dims`` [obs_dim, enc...] and hidden ``h``: E (the encoder's output,
    or the obs rows without an encoder), H twice, the encoder's input and
    ping-pong buffers, the means, and two buffers of the draws (each
    ``act_dim`` rows of normals and a row of demand). A product's input rows
    are padded to 8 (its k-steps) and an encoder layer's outputs to 16 (its
    M-tiles); the padding rows stay zero."""
    lanes, warps_m = tile
    n_enc = len(dims) - 1
    e_pad, h_pad = (_pad16(dims[-1]) if n_enc else _pad8(dims[0])), _pad8(h)
    stride = lanes + 8   # B-fragment loads and the float2 stores hit 32 banks
    x_rows = max([_pad8(dims[0])] + [_pad16(d) for d in dims[1:-1]]) if n_enc else 0
    rows = {"e": e_pad, "h0": h_pad, "h1": h_pad, "x0": x_rows,
            "x1": x_rows if n_enc > 1 else 0, "m": act_dim, "z": 2 * (act_dim + 1)}
    offsets, at = {}, 0
    for name, r in rows.items():
        offsets[name] = at
        at += r * stride
    if not n_enc:
        offsets["x0"] = offsets["e"]   # the obs rows are the gate input
    return LstmPlan(lanes, warps_m, lanes * warps_m, e_pad, h_pad, (e_pad + h_pad) // 8,
                    stride, offsets, at)


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


# the tiles of the LSTM kernels (csrc/im_lstm.cu LSTM_TILES) the entry
# points take, in order of preference: the first whose shared memory fits
_LSTM_TILES = ((64, 4), (32, 8))


def _pack_lstm_actor(actor, std, obs_dim: int, act_dim: int, half_hi, device):
    """The LSTM kernels' actor arguments: the Lstm struct and one flat
    float32 buffer on ``device``. The buffer holds the gate weights as the
    A fragments of the tensor-core product (``_gate_fragments``); the gate
    biases (h_pad, 4), row j the four gates [i, f, g, o] of unit j; each
    encoder layer's W and b, as fragments too (``_encoder_fragments``); the
    mean head's W (act, h) and b; the std when given; every NaN as the
    quiet NaN 0x7fc00000 (``_QUIET_NAN_BITS``). The struct carries
    their offsets, the tile (the first of ``_LSTM_TILES`` whose layout fits
    a block's shared memory) and the layout (``_lstm_plan``). Raises
    ValueError for an actor beyond the kernels' maxima or the shared memory
    of a block."""
    dims, h = _lstm_dims(actor, obs_dim, act_dim)
    n_enc = len(dims) - 1
    if n_enc > LSTM_MAX_ENC or h % 4 or h > LSTM_MAX_HIDDEN or act_dim > LSTM_MAX_ACT:
        raise ValueError(f"LSTM actor of widths {dims}, hidden {h}, {act_dim} actions: the "
                         f"kernels take at most {LSTM_MAX_ENC} encoder layers, a hidden width "
                         f"that is a multiple of 4 and <= {LSTM_MAX_HIDDEN}, and "
                         f"{LSTM_MAX_ACT} actions")
    plans = [_lstm_plan(dims, h, act_dim, t) for t in _LSTM_TILES]
    plan = next((pl for pl in plans if pl.floats * 4 <= SMEM_OPTIN_BYTES), None)
    if plan is None:
        raise ValueError(f"LSTM actor of widths {dims}, hidden {h}: "
                         f"{min(pl.floats for pl in plans) * 4} bytes of shared memory a "
                         f"block; a block holds {SMEM_OPTIN_BYTES}")
    a = _lstm_on(actor, device)
    bias = torch.zeros((plan.h_pad, 4), dtype=torch.float32, device=device)
    bias[:h] = a["bh"].reshape(4, h).T
    parts = [_gate_fragments(a["wx"], a["wh"], plan.e_pad, plan.h_pad), bias.reshape(-1)]
    st = _Lstm(n_enc=n_enc, hidden=h, act=act_dim, w_gate=0, b_gate=parts[0].numel())

    def append(x) -> int:
        offset = sum(p.numel() for p in parts)
        parts.append(x.reshape(-1))
        return offset

    for layer, (W, b) in enumerate(a["enc"]):
        frag, bias_l = _encoder_fragments(W, b)
        st.w_enc[layer], st.b_enc[layer] = append(frag), append(bias_l)
    st.w_mean, st.b_mean = append(a["wm"]), append(a["bm"])
    st.std = -1 if std is None else append(std.to(device=device, dtype=torch.float32))
    for k, d in enumerate(dims):
        st.dims[k] = d
    for i, v in enumerate(half_hi):
        st.half_hi[i] = v
    _set_lstm_tile(st, plan)
    return st, _quiet_nans(torch.cat(parts))


def _set_lstm_tile(st: _Lstm, plan: LstmPlan) -> None:
    """Write ``plan``'s tile and shared-memory layout into ``st`` (the
    packed buffer does not depend on the tile)."""
    for field in ("lanes", "warps_m", "threads", "e_pad", "h_pad", "k_steps", "stride"):
        setattr(st, field, getattr(plan, field))
    for name, offset in plan.offsets.items():
        setattr(st, f"s_{name}", offset)
    st.s_total = plan.floats


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
    dev, obs_dim = _im_lstm_args(params, actor, batch, device)
    seed = int(seed) & rng.MASK32
    if dev.type == "cpu":
        return _im_lstm_plain(params, actor, seed, batch, dev, dump)
    st, flat = _pack_lstm_actor(actor, None, obs_dim, params.m1, _half_c(params), dev)
    plan = _im_plan(params, _plan_key(dev))
    T, m1 = params.periods, params.m1
    out = torch.empty(batch, dtype=torch.float32, device=dev)
    acts = torch.empty((T, m1, batch), dtype=torch.int32, device=dev) if dump else None
    dems = torch.empty((T, batch), dtype=torch.int32, device=dev) if dump else None
    with torch.cuda.device(dev):
        _launch("im_lstm", "im_lstm_returns", ctypes.addressof(plan["struct"]),
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
    NotImplementedError). K22: a block per 64 lanes, the gate product on
    the tensor cores (csrc/im_lstm.cu ``k_im_lstm_returns``); on the CPU
    the plain version runs."""
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
    block per 64 lanes, the gate product on the tensor cores
    (csrc/im_lstm.cu ``k_im_lstm_traj``); on the CPU the plain version
    runs."""
    dev, obs_dim = _im_lstm_args(params, actor, batch, device)
    seed = int(seed) & rng.MASK32
    std = clipped_std(torch.as_tensor(log_std).detach())
    if dev.type == "cpu":
        return _rollout_traj_im_lstm_plain(params, actor, std, seed, batch, dev)
    st, flat = _pack_lstm_actor(actor, std, obs_dim, params.m1, _half_c(params), dev)
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
        _launch("im_lstm", "im_lstm_rollout_traj", ctypes.addressof(plan["struct"]),
                ctypes.addressof(st), flat.data_ptr(), plan["table"].data_ptr(),
                plan["user_d"].data_ptr(), plan["disc"].data_ptr(),
                *(out[k].data_ptr() for k in ("inv", "actions", "raw", "reward", "demand")),
                seed, int(params.backlog), batch, T, _stream(dev))
    rollout_traj_im_lstm.launches += 1
    return out


rollout_traj_im_lstm.launches = 0


# =============================================== Newsvendor kernels K13-K17

NV_MAX_L = 32                # the pipeline ring's depth (csrc/nv_step.cuh)
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
    memory a block (the [k][thread] table of the K suffix sums), resident
    ``blocks_per_sm``; ``table`` False picks the linear count instead."""
    threads: int
    bytes: int
    blocks_per_sm: int
    table: bool


# a block of 256 threads launches at any register count (65,536 / 256)
_NV_TABLE_MAX_THREADS = 256
# registers a thread of K13-K17: the most ptxas -v reports for an instance
# of k_nv_episodes (80-96 on sm_90a); an SM's 65,536 registers go to warps
# in whole allocations of 32 x this (a multiple of 8)
_NV_TABLE_REGS = 96
REGS_PER_SM = 65_536


def _nv_table_plan(K: int) -> NvTablePlan:
    """The block size, among multiples of 32 up to 256, at which an SM holds
    the most threads with a table of ``K`` floats a thread (the smallest
    such block, for the fullest last wave), counting the SM's shared
    memory, registers (``_NV_TABLE_REGS`` a thread), threads and blocks;
    for a K whose table a block of 32 cannot hold (K > 1,816: mu_max >
    ~24,500), the linear count at ``_POLICY_THREADS`` (csrc/launch.cuh
    kThreads) with no table."""
    per_thread = 4 * K
    warps_by_regs = REGS_PER_SM // (32 * _NV_TABLE_REGS)
    if 32 * per_thread > SMEM_OPTIN_BYTES:
        blocks = min(warps_by_regs // (_POLICY_THREADS // 32),
                     THREADS_PER_SM // _POLICY_THREADS, BLOCKS_PER_SM)
        return NvTablePlan(_POLICY_THREADS, 0, blocks, False)
    best = None
    for threads in range(32, _NV_TABLE_MAX_THREADS + 1, 32):
        nbytes = per_thread * threads
        if nbytes > SMEM_OPTIN_BYTES:
            break
        blocks = min(SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK_RESERVED),
                     warps_by_regs // (threads // 32), THREADS_PER_SM // threads,
                     BLOCKS_PER_SM)
        if best is None or blocks * threads > best.blocks_per_sm * best.threads:
            best = NvTablePlan(threads, nbytes, blocks, True)
    return best


@dataclasses.dataclass(frozen=True)
class NvK13Plan:
    """K13's launch: two staging buffers of ``chunk`` periods of
    ``per_period`` words (the order, then the demand; ``_random`` the demand
    alone), ``words`` a thread, [word][thread] in dynamic shared memory at
    ``threads`` a block: ``bytes`` a block, resident ``blocks_per_sm`` by
    shared memory, threads and blocks (the pipeline is in registers)."""
    threads: int
    words: int
    per_period: int
    chunk: int
    bytes: int
    blocks_per_sm: int


# K13's periods a staging buffer and an unrolled chunk (kK13Chunk of
# csrc/nv_episode.cu), and its block: launch.cuh's kThreads. On an H100, 64
# and 256 threads ran within 2% of 128 (tools/k13_sweep.py, the shared-memory
# form).
NV_K13_CHUNK = 8
NV_K13_THREADS = 128


@functools.lru_cache(maxsize=16)
def _nv_k13_plan(random: bool = False, threads: int = NV_K13_THREADS) -> NvK13Plan:
    """K13's shared memory: 2 x ``NV_K13_CHUNK`` periods of 2 words a
    thread (1 for ``random``) at ``threads`` a block. Raises ValueError
    where no block holds it."""
    per_period = 1 if random else 2
    words = 2 * NV_K13_CHUNK * per_period
    nbytes = 4 * words * threads
    if threads < 32 or threads % 32 or threads > 1024 or nbytes > SMEM_OPTIN_BYTES:
        raise ValueError(f"K13 launches whole warps, at most 1,024 threads and "
                         f"{SMEM_OPTIN_BYTES} bytes a block; got {threads} threads, {nbytes} B")
    blocks = min(SMEM_PER_SM // (nbytes + SMEM_PER_BLOCK_RESERVED), THREADS_PER_SM // threads,
                 BLOCKS_PER_SM)
    return NvK13Plan(threads, words, per_period, NV_K13_CHUNK, nbytes, blocks)


@functools.lru_cache(maxsize=32)
def _nv_plan(params: nv.NewsvendorParams, device: str):
    """A launch's host-built arguments, built once per (params, device): the
    params struct (with K14-K17's ``_nv_table_plan`` and K13's
    ``_nv_k13_plan``), the f32 gamma^t table (as a list and on ``device``) and
    the lgamma pairs on ``device``. Raises ValueError for a lead time beyond
    the ring's depth."""
    if params.lead_time > NV_MAX_L:
        raise ValueError(f"lead_time={params.lead_time}: the CUDA kernels' pipeline "
                         f"ring holds at most {NV_MAX_L}")
    Wb, K, lgam = nv_poisson.window(params)
    launch = _nv_table_plan(K)
    k13 = _nv_k13_plan()
    st = _NvParams(L=params.lead_time, K=K, threads=launch.threads, table=int(launch.table),
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
    time) and its streams staged into shared memory ahead of the step
    (csrc/nv_episode.cu ``k_nv_returns``, laid out by ``_nv_k13_plan``); on
    CPU tensors the plain version runs."""
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
    memory, the block sized by ``_nv_table_plan``). Returns (batch,) for
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


def _nv_tile_actor(params: nv.NewsvendorParams, actor, std, device):
    """The actor arguments of K18-K20 on the tensor-core tile
    (``_pack_tile_actor`` at the env's obs width, one action, and
    ``_nv_half_hi``): the MlpTile struct and the packed buffer, the std
    last when given; ``_nv_tile_launch`` lays the tile out."""
    return _pack_tile_actor(actor, std, params.obs_dim, 1, _nv_half_hi(params), device)


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
# sm_90a (the stochastic linear count's; phase 2 of chip_smoke.py checks
# every instance against it): what the plan's blocks an SM count
_NV_TILE_REGS = 171


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


def _nv_tile_structs(st: _MlpTile, plan: NvTilePlan):
    """(a copy of the packed actor's MlpTile laid out as ``plan``, its
    NvTile)."""
    tile = _MlpTile.from_buffer_copy(st)
    tile.lanes, tile.stride = plan.lanes, plan.stride
    x0 = plan.offsets["x0"]
    tile.s_x0 = x0
    tile.s_x1 = x0 if plan.in_place else x0 + plan.rows * plan.stride
    tile.s_dem = tile.s_z = tile.s_scratch = -1   # the demand has rows of its own
    tile.s_state = plan.offsets["ring"]
    tile.s_total = plan.floats
    nt = _NvTile(layout=NV_TILE_LAYOUTS[plan.layout], s_dem=plan.offsets["dem"],
                 s_ring=plan.offsets["ring"], s_table=plan.offsets["table"])
    return tile, nt


def _nv_tile_launch(st: _MlpTile, nv_st: _NvParams, T: int):
    """K18-K20's (MlpTile, NvTile) for the packed actor's ``st`` and the
    launch plan's params struct ``nv_st`` at ``T`` periods: the layout
    ``_nv_tile_choice`` takes."""
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
        _launch("nv_policy", "nv_rollout_traj", ctypes.addressof(plan["struct"]),
                ctypes.addressof(tile), ctypes.addressof(nt), flat.data_ptr(),
                plan["lgam"].data_ptr(),
                *(out[k].data_ptr() for k in ("econ", "orders", "raw", "reward", "demand")),
                seed, batch, T, _stream(dev))
    rollout_traj_nv.launches += 1
    return out


rollout_traj_nv.launches = 0


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
    T = params.step_limit
    relu = int(act_name == "relu")
    packed = _pack_cluster_actor(actor, std, params.obs_dim, 1, policy, _nv_half_hi(params), T,
                                 params.obs_dim + 1, True, dev)
    if packed is None:   # the wide route: no cluster tile holds the actor and the demand
        fn = "nv_rollout_traj_wide"
        st, flat = _pack_wide_actor(actor, std, params.obs_dim, 1, policy, _nv_half_hi(params),
                                    dev)
    else:
        fn = "nv_rollout_traj_cluster"
        st, flat = packed
        with torch.cuda.device(dev):
            _set_cluster_grid(st, batch, "nv_policy", "nv_rollout_traj_cluster_occupancy",
                              (relu,), dev)
    plan = _nv_plan(params, _plan_key(dev))
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
        _launch("nv_policy", "nv_policy_returns", ctypes.addressof(nv_st),
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
