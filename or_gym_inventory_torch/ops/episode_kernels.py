"""The folded actor of the policy kernels, and the plain versions of the
in-kernel policy helpers.

Port of ``or_gym_inventory_tpu/ops/pallas_episode_kernels.py:43-72,
966-1105, 1124-1146``. The kernels themselves live in ``ops/net_step.py``
(wrappers) and ``csrc/net_policy.cu``; this module holds what surrounds them:

- ``clipped_std``, ``fold_actor_params`` (the obs RunningMeanStd folded into
  layer 1), ``folded_actor_mean`` and ``apply_folded_actor``, on host;
- the plain versions of the in-kernel helpers ``mlp_forward`` and
  ``traj_policy`` (mode ``"ppo"``). Those of ``_uniform01`` and ``_normal01``
  are ``ops.rng.uniform01`` and ``normal01``, which turn Philox words into
  the kernels' draws where the TPU drew from its own generator.

An actor is ``(Ws, bs)``: Ws[l] (in, out), bs[l] (out,), float32, as the JAX
package has it. The plain versions compute with the layers as (out, in), as
the Pallas kernels did (``kernel_layers``); the CUDA kernels take them as
(in, out) with the outputs padded to 16 (``net_step._pack_actor``).
"""

from __future__ import annotations

import torch

from or_gym_inventory_torch.agents import networks


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
