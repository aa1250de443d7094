"""Policy and value networks of the port (port of
``or_gym_inventory_tpu/agents/networks.py:32-58, 107-133``).

``MLPActorCritic`` is the flax module as an ``nn.Module``: separate pi and vf
trunks (SB3 layout), orthogonal initialisation with gain sqrt(2) for the
trunks, 0.01 for the mean head and 1.0 for the value head, zero biases and a
zero ``log_std`` parameter. Torch needs the input width up front, so the
constructor takes ``obs_dim`` where flax inferred it. ``nn.Linear`` keeps its
weight as (out, in); the flax kernel is the transpose (``utils.interop``
carries one into the other).

Actions are tanh-squashed Gaussians rescaled to the env's action box.
``QNetwork`` and ``LSTMActorCritic`` wait for ROADMAP.md A9 and A10.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

_ACTS = {"tanh": torch.tanh, "relu": torch.relu,
         "gelu": lambda x: nn.functional.gelu(x, approximate="tanh")}


def _dense(n_in: int, n_out: int, gain: float, generator) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        nn.init.orthogonal_(layer.weight, gain=gain, generator=generator)
        layer.bias.zero_()
    return layer


def _trunk(n_in: int, arch: Sequence[int], generator) -> nn.ModuleList:
    layers = []
    for width in arch:
        layers.append(_dense(n_in, width, math.sqrt(2), generator))
        n_in = width
    return nn.ModuleList(layers)


class MLPActorCritic(nn.Module):
    """Gaussian actor + value critic with separate trunks (SB3 layout).
    ``forward(obs)`` returns (mean, log_std, value), as the flax module's
    ``__call__`` does. ``generator`` seeds the initialisation."""

    def __init__(self, obs_dim: int, action_dim: int,
                 pi_arch: Tuple[int, ...] = (64, 64),
                 vf_arch: Tuple[int, ...] = (64, 64),
                 activation: str = "tanh", generator: torch.Generator = None):
        super().__init__()
        self.activation = activation
        self.pi = _trunk(obs_dim, pi_arch, generator)
        self.mean = _dense(pi_arch[-1] if pi_arch else obs_dim, action_dim,
                           0.01, generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        self.vf = _trunk(obs_dim, vf_arch, generator)
        self.value = _dense(vf_arch[-1] if vf_arch else obs_dim, 1, 1.0,
                            generator)

    def forward(self, obs: torch.Tensor):
        act = _ACTS[self.activation]
        h = obs
        for layer in self.pi:
            h = act(layer(h))
        g = obs
        for layer in self.vf:
            g = act(layer(g))
        return self.mean(h), self.log_std, self.value(g).squeeze(-1)


# ------------------------------------------------------- action squashing

def squash_action(raw: torch.Tensor, low, high) -> torch.Tensor:
    """R^d Gaussian sample -> env action box via tanh rescale."""
    return low + (torch.tanh(raw) + 1.0) * 0.5 * (high - low)


def gaussian_sample(generator: torch.Generator, mean: torch.Tensor,
                    log_std: torch.Tensor) -> torch.Tensor:
    std = torch.exp(torch.clamp(log_std, -10.0, 2.0))
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean + std * noise


def gaussian_log_prob(raw: torch.Tensor, mean: torch.Tensor,
                      log_std: torch.Tensor) -> torch.Tensor:
    """Diagonal Gaussian log-prob with the tanh-squash correction (summed
    over action dims). ``raw`` is the pre-squash sample."""
    log_std = torch.clamp(log_std, -10.0, 2.0)
    var = torch.exp(2.0 * log_std)
    lp = -0.5 * (((raw - mean) ** 2) / var + 2.0 * log_std
                 + math.log(2.0 * math.pi))
    # log det of d(squash)/d(raw), up to the constant (high-low)/2 scale,
    # which cancels in PPO ratios
    corr = 2.0 * (math.log(2.0) - raw - nn.functional.softplus(-2.0 * raw))
    return torch.sum(lp - corr, dim=-1)


def entropy_bonus(log_std: torch.Tensor) -> torch.Tensor:
    """Gaussian entropy (pre-squash; standard PPO practice)."""
    log_std = torch.clamp(log_std, -10.0, 2.0)
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)
