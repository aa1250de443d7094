"""Policy and value networks of the port (port of
``or_gym_inventory_tpu/agents/networks.py:32-58, 74-133``).

``MLPActorCritic`` is the flax module as an ``nn.Module``: separate pi and vf
trunks (SB3 layout), orthogonal initialisation with gain sqrt(2) for the
trunks, 0.01 for the mean head and 1.0 for the value head, zero biases and a
zero ``log_std`` parameter. Torch needs the input width up front, so the
constructor takes ``obs_dim`` where flax inferred it. ``nn.Linear`` keeps its
weight as (out, in); the flax kernel is the transpose (``utils.interop``
carries one into the other).

``LSTMActorCritic`` is the recurrent one: a tanh Dense encoder, flax's
``OptimizedLSTMCell`` written out in tensor ops (so that a sequence can be
re-run with episode boundaries inside it), and mean and value heads on the
cell's output.

``QNetwork`` is the Q(s, a) critic of the off-policy learners
(``agents/off_policy.py``): orthogonal sqrt(2) trunk, a lecun-normal output,
as flax initialises them.

Actions are tanh-squashed Gaussians rescaled to the env's action box.
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


def _lecun_normal(n_in: int, n_out: int, generator) -> torch.Tensor:
    """flax's default kernel init, (in, out): a normal of variance 1 / n_in
    truncated at two standard deviations, rescaled to keep that variance."""
    w = torch.empty(n_in, n_out)
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return w


def _lecun_dense(n_in: int, n_out: int, generator) -> nn.Linear:
    """flax's default ``nn.Dense``: a lecun-normal kernel and a zero bias."""
    layer = nn.Linear(n_in, n_out)
    with torch.no_grad():
        layer.weight.copy_(_lecun_normal(n_in, n_out, generator).T)
        layer.bias.zero_()
    return layer


class QNetwork(nn.Module):
    """Q(s, a) critic for the off-policy learners (JAX networks.QNetwork
    :61-71): the observation and the action concatenated, an ``activation``
    trunk of widths ``arch`` (orthogonal sqrt(2), zero biases) and one
    lecun-normal output. ``forward(obs, action)`` returns (B,)."""

    def __init__(self, obs_dim: int, act_dim: int, arch: Tuple[int, ...] = (256, 256),
                 activation: str = "relu", generator: torch.Generator = None):
        super().__init__()
        self.activation = activation
        self.trunk = _trunk(obs_dim + act_dim, arch, generator)
        self.out = _lecun_dense(arch[-1] if arch else obs_dim + act_dim, 1, generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        act = _ACTS[self.activation]
        x = torch.cat([obs, action], dim=-1)
        for layer in self.trunk:
            x = act(layer(x))
        return self.out(x).squeeze(-1)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell(hidden)`` in its own layout: ``wi`` (in, 4h)
    is the input kernels [ii | if | ig | io] side by side, without a bias;
    ``wh`` (h, 4h) the recurrent kernels [hi | hf | hg | ho] and ``bh`` (4h,)
    their biases. Gates i, f, o are sigmoids and g a tanh; c' = f c + i g and
    h' = o tanh(c'). flax's inits: lecun-normal input kernels, orthogonal
    recurrent kernels (gain 1, one per gate), zero biases."""

    def __init__(self, n_in: int, hidden: int, generator: torch.Generator = None):
        super().__init__()
        self.hidden = hidden
        self.wi = nn.Parameter(torch.cat([_lecun_normal(n_in, hidden, generator)
                                          for _ in range(4)], dim=1))
        wh = torch.empty(hidden, 4 * hidden)
        for g in range(4):
            nn.init.orthogonal_(wh[:, g * hidden:(g + 1) * hidden], generator=generator)
        self.wh = nn.Parameter(wh)
        self.bh = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, carry, x):
        c, h = carry
        gates = (h @ self.wh + self.bh) + x @ self.wi
        i, f, g, o = gates.split(self.hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class LSTMActorCritic(nn.Module):
    """Recurrent actor-critic: tanh Dense encoder -> LSTM cell -> mean and
    value heads (JAX networks.LSTMActorCritic). ``forward(carry, obs, done)``
    returns (carry, (mean, log_std, value)) with the carry (c, h); a ``done``
    row zeroes that env's carry before the cell. Inits as flax's: encoder
    orthogonal sqrt(2), mean head orthogonal 0.01, value head lecun-normal,
    zero biases, zero ``log_std``."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 128,
                 encoder: Tuple[int, ...] = (64,), activation: str = "tanh",
                 generator: torch.Generator = None):
        super().__init__()
        self.activation = activation
        self.hidden = hidden
        self.enc = _trunk(obs_dim, encoder, generator)
        self.cell = LSTMCell(encoder[-1] if encoder else obs_dim, hidden, generator)
        self.mean = _dense(hidden, action_dim, 0.01, generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        self.value = nn.Linear(hidden, 1)
        with torch.no_grad():
            self.value.weight.copy_(_lecun_normal(hidden, 1, generator).T)
            self.value.bias.zero_()

    def initial_carry(self, batch: int, device=None):
        zeros = torch.zeros((batch, self.hidden), dtype=torch.float32, device=device)
        return zeros, zeros.clone()

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        act = _ACTS[self.activation]
        x = obs
        for layer in self.enc:
            x = act(layer(x))
        return x

    def heads(self, h: torch.Tensor):
        return self.mean(h), self.log_std, self.value(h).squeeze(-1)

    def step(self, carry, x, done=None):
        """One cell step on the encoded input ``x``: (carry, h)."""
        if done is not None:
            keep = (1.0 - done.to(torch.float32))[..., None]
            carry = (carry[0] * keep, carry[1] * keep)
        return self.cell(carry, x)

    def forward(self, carry, obs, done=None):
        carry, h = self.step(carry, self.encode(obs), done)
        return carry, self.heads(h)

    def forward_sequence(self, carry, obs_seq, done_seq):
        """``forward`` scanned over time-major (T, B, ...) inputs, the
        encoder and heads batched over all T at once. Returns (final carry,
        (mean (T, B, act), log_std, value (T, B)))."""
        x = self.encode(obs_seq)
        hs = []
        for t in range(obs_seq.shape[0]):
            carry, h = self.step(carry, x[t], done_seq[t])
            hs.append(h)
        return carry, self.heads(torch.stack(hs))


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
