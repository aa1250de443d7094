"""Off-policy actor-learners, SAC, TD3 and DDPG, collecting through the
trajectory kernels' off-policy heads.

Port of ``or_gym_inventory_tpu/agents/off_policy.py:47-256, 257-376,
480-666, 678-804``, the ``OffPolicyConfig(collect="kernel")`` path without a
mesh, on all three families. Each iteration runs one full episode per env
in the family's trajectory kernel with the folded relu actor and the head
of the phase (``"uniform"`` while warming up, then ``"sac"`` for SAC's
squashed state-dependent Gaussian or ``"det"`` for TD3/DDPG's clipped
post-squash noise): ``ops.episode_kernels.rollout_traj_im_offpolicy`` (K27),
``rollout_traj_nv_offpolicy`` (K28) or ``ops.net_step.
rollout_traj_net_offpolicy`` (K29). It inserts the ``num_envs * horizon``
n-step transitions into the replay buffer in one contiguous write, then runs
``horizon * updates_per_iter`` gradient updates (the XLA path's
update:env-step ratio). The gradient steps are plain PyTorch (``nn`` layers,
autograd), as the JAX package left them to XLA.

Where the port differs in form:

- The state holds ``nn.Module``s (``actor_params``, ``q_params`` and the
  two targets keep JAX's field names) that an update changes in place, and
  the optimizer states of ``agents.ppo.Optimizer`` (``optax.adam(lr)``
  exactly: eps 1e-8, no clipping, no anneal).
- The replay buffer is written in place; ``insert`` and ``insert_chunk``
  return it, so JAX's ``buf = buf.insert(...)`` reads the same.
- One ``torch.Generator`` replaces the JAX key chain: it draws each
  iteration's kernel seed and, up front, its minibatch indices and normals.
  ``one_update`` takes those as tensors, so a test can feed JAX's.
- The kernels run in full f32; the JAX package ran the off-policy heads'
  matmuls at DEFAULT (bf16-class) precision to fit its TPU compiler
  (``off_policy.py:599-606``).
- JAX's ``num_envs % 1024`` check and its TPU-backend check were tile and
  platform constraints: the CUDA kernels mask the batch tail.
- ``collect="xla"`` (the step-interleaved path), ``OffPolicyAgent`` (and
  ``SACAgent``, ``TD3Agent``, ``DDPGAgent``) and the mesh are still to port
  (ROADMAP.md A9b); they raise NotImplementedError.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from or_gym_inventory_torch.agents import networks
from or_gym_inventory_torch.agents.ppo import Optimizer, OptState, PPOConfig, RunningMeanStd
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import inv_management, net_inv_management, newsvendor
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.ops import episode_kernels, net_step
from or_gym_inventory_torch.vector import vecenv

_A9B = ("is still to port (ROADMAP.md A9b); use OffPolicyConfig(collect='kernel') "
        "with off_policy.train")


@dataclasses.dataclass(frozen=True)
class OffPolicyConfig:
    """The JAX package's OffPolicyConfig field for field; see its comments."""
    algo: str = "sac"   # sac | td3 | ddpg
    num_envs: int = 128
    buffer_size: int = 200_000
    batch_size: int = 256
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    start_steps: int = 2_000
    updates_per_iter: int = 1
    policy_delay: int = 2   # td3
    target_noise: float = 0.2
    noise_clip: float = 0.5
    explore_noise: float = 0.1
    pretanh_penalty: float = 1e-3
    n_step: int = 1
    pi_arch: Tuple[int, ...] = (256, 256)
    q_arch: Tuple[int, ...] = (256, 256)
    normalize_obs: bool = True
    collect: str = "xla"

    def replace(self, **kw) -> "OffPolicyConfig":
        return dataclasses.replace(self, **kw)


class _Actor(nn.Module):
    """The off-policy actor (JAX off_policy._Actor): a relu trunk, a mean
    head and, when ``stochastic``, a log_std head clipped to [-10, 2], every
    layer flax's default Dense (lecun-normal kernel, zero bias).
    ``forward(obs)`` returns (mean, log_std or None)."""

    def __init__(self, obs_dim: int, action_dim: int, arch: Tuple[int, ...] = (256, 256),
                 stochastic: bool = True, generator: torch.Generator = None):
        super().__init__()
        self.stochastic = stochastic
        widths = [obs_dim] + list(arch)
        self.trunk = nn.ModuleList(networks._lecun_dense(a, b, generator)
                                   for a, b in zip(widths, widths[1:]))
        self.mean = networks._lecun_dense(widths[-1], action_dim, generator)
        self.log_std = (networks._lecun_dense(widths[-1], action_dim, generator)
                        if stochastic else None)

    def forward(self, obs: torch.Tensor):
        x = obs
        for layer in self.trunk:
            x = torch.relu(layer(x))
        mean = self.mean(x)
        if not self.stochastic:
            return mean, None
        return mean, torch.clamp(self.log_std(x), -10.0, 2.0)


class TwinQ(nn.Module):
    """The critics: two ``networks.QNetwork``s, or one for DDPG, whose
    ``forward`` returns it twice (JAX make_offpolicy's TwinQ)."""

    def __init__(self, obs_dim: int, act_dim: int, arch: Tuple[int, ...], single: bool,
                 generator: torch.Generator = None):
        super().__init__()
        self.qs = nn.ModuleList(networks.QNetwork(obs_dim, act_dim, arch, generator=generator)
                                for _ in range(1 if single else 2))

    def forward(self, obs: torch.Tensor, action: torch.Tensor):
        q1 = self.qs[0](obs, action)
        return q1, (self.qs[1](obs, action) if len(self.qs) > 1 else q1)


class ReplayBuffer:
    """Fixed-size ring of transitions on one device: obs and next_obs
    (size, obs_dim), the normalised [-1, 1] action (size, act_dim), the
    n-step reward, done and the bootstrap discount gamma^k (size,). ``ptr``
    and ``filled`` are host ints. Written in place; ``insert`` and
    ``insert_chunk`` return the buffer."""

    FIELDS = ("obs", "action", "reward", "next_obs", "done", "disc")

    def __init__(self, obs, action, reward, next_obs, done, disc, ptr=0, filled=0):
        self.obs, self.action, self.reward = obs, action, reward
        self.next_obs, self.done, self.disc = next_obs, done, disc
        self.ptr, self.filled = ptr, filled

    @classmethod
    def create(cls, size: int, obs_dim: int, act_dim: int, device=None):
        f32 = dict(dtype=torch.float32, device=device)
        return cls(obs=torch.zeros((size, obs_dim), **f32),
                   action=torch.zeros((size, act_dim), **f32),
                   reward=torch.zeros((size,), **f32),
                   next_obs=torch.zeros((size, obs_dim), **f32),
                   done=torch.zeros((size,), dtype=torch.bool, device=device),
                   disc=torch.zeros((size,), **f32))

    @property
    def size(self) -> int:
        return self.obs.shape[0]

    def _values(self, obs, action, reward, next_obs, done, disc):
        return (obs.to(torch.float32), action, reward, next_obs.to(torch.float32), done, disc)

    def insert(self, obs, action, reward, next_obs, done, disc):
        """Row-scatter insert of n transitions at ptr, wrapping."""
        n = obs.shape[0]
        idx = (self.ptr + torch.arange(n, device=self.obs.device)) % self.size
        for name, v in zip(self.FIELDS, self._values(obs, action, reward, next_obs, done, disc)):
            getattr(self, name)[idx] = v
        self.ptr = (self.ptr + n) % self.size
        self.filled = min(self.filled + n, self.size)
        return self

    def insert_chunk(self, obs, action, reward, next_obs, done, disc):
        """Contiguous insert of one collection chunk of n transitions at
        ptr: the capacity is a whole number of chunks, so the pointer stays
        chunk-aligned and the write never wraps mid-chunk. Equal to
        ``insert`` at an aligned pointer. Raises AssertionError unless
        ``size % n == 0`` and the pointer is aligned (the JAX version clamps
        an unaligned start)."""
        n = obs.shape[0]
        assert self.size % n == 0, (
            f"insert_chunk needs capacity ({self.size}) % chunk ({n}) == 0")
        assert self.ptr % n == 0, f"insert_chunk needs ptr ({self.ptr}) % chunk ({n}) == 0"
        p = self.ptr
        for name, v in zip(self.FIELDS, self._values(obs, action, reward, next_obs, done, disc)):
            getattr(self, name)[p:p + n] = v
        self.ptr = (p + n) % self.size
        self.filled = min(self.filled + n, self.size)
        return self

    def gather(self, idx: torch.Tensor) -> dict:
        """The transitions at ``idx`` as a dict of tensors."""
        return {name: getattr(self, name)[idx] for name in self.FIELDS}

    def sample(self, generator: torch.Generator, batch_size: int) -> dict:
        """A minibatch uniform over the filled rows, from ``generator``."""
        idx = torch.randint(0, max(self.filled, 1), (batch_size,), generator=generator,
                            device=generator.device).to(self.obs.device)
        return self.gather(idx)


def nstep_aggregate(wrew, wdone, wnext, gamma: float):
    """Collapse an oldest-first window of transitions into one n-step
    transition for its first entry (JAX nstep_aggregate): ``wrew``/``wdone``
    (n, B), ``wnext`` (n, B, obs_dim). A done inside the window cuts the
    return after it. Returns (reward_n (B,), next_obs (B, obs_dim), done
    (B,), disc = gamma^k (B,)), k the included steps."""
    n = wrew.shape[0]
    d = wdone.to(torch.float32)
    no_done_before = torch.cumprod(1.0 - d, dim=0)
    include = torch.cat([torch.ones_like(d[:1]), no_done_before[:-1]], dim=0)
    gammas = (gamma ** torch.arange(n, dtype=torch.float32, device=d.device))[:, None]
    reward_n = torch.sum(include * gammas * wrew, dim=0)
    k = torch.sum(include, dim=0)
    inc_next = torch.cat([include[1:], torch.zeros_like(include[:1])], dim=0)
    sel = include * (1.0 - inc_next)
    next_obs = torch.sum(sel[:, :, None] * wnext, dim=0)
    done = torch.sum(sel * d, dim=0) > 0.5
    return reward_n, next_obs, done, gamma ** k


def episode_transitions(obs_all, a_norm, reward, n_step: int, gamma: float):
    """Collapse one fixed-horizon episode batch into flat n-step
    transitions, t-major and oldest first (JAX episode_transitions):
    ``obs_all`` (T+1, B, D) with the final snapshot, ``a_norm`` (T, B, A),
    ``reward`` (T, B). With k(t) = min(n, T - t): reward_n[t] =
    sum_{j<k} gamma^j r[t+j], next_obs[t] = obs[t+k], done[t] = (t+k == T),
    disc[t] = gamma^k. Returns the (T*B, ...) tuple (obs, action, reward_n,
    next_obs, done, disc)."""
    T, B = reward.shape
    dev = reward.device
    n = min(n_step, T)
    t_idx = np.arange(T)
    k = np.minimum(n, T - t_idx)
    rew_pad = torch.cat([reward, torch.zeros((n - 1, B), dtype=reward.dtype, device=dev)], 0) \
        if n > 1 else reward
    reward_n = sum((gamma ** j) * rew_pad[j:j + T] for j in range(n))
    next_obs = obs_all[torch.as_tensor(np.minimum(t_idx + n, T), device=obs_all.device)]
    done = torch.as_tensor((t_idx + k) == T, device=dev)[:, None].expand(T, B)
    disc = torch.as_tensor(gamma ** k, dtype=torch.float32, device=dev)[:, None].expand(T, B)
    D, A = obs_all.shape[-1], a_norm.shape[-1]
    return (obs_all[:T].reshape(T * B, D), a_norm.reshape(T * B, A), reward_n.reshape(T * B),
            next_obs.reshape(T * B, D), done.reshape(T * B), disc.reshape(T * B))


@dataclasses.dataclass
class OffPolicyState:
    actor_params: _Actor
    q_params: TwinQ            # the twin critics (one for DDPG)
    target_q_params: TwinQ
    target_actor_params: _Actor
    log_alpha: torch.Tensor    # SAC's temperature, a 0-d tensor
    actor_opt: OptState
    q_opt: OptState
    alpha_opt: OptState
    rms: RunningMeanStd
    buffer: ReplayBuffer
    env_state: object
    last_obs: torch.Tensor
    step_idx: int


def _adam(cfg: OffPolicyConfig) -> Optimizer:
    """``optax.adam(cfg.lr)``: eps 1e-8, no clipping, no anneal."""
    return Optimizer(PPOConfig(lr=cfg.lr, anneal_lr=False), 1, eps=1e-8, clip=False)


def _polyak(target: nn.Module, source: nn.Module, tau: float):
    """target = (1 - tau) * target + tau * source, in place."""
    with torch.no_grad():
        for t, s in zip(target.parameters(), source.parameters()):
            t.copy_((1.0 - tau) * t + tau * s)


def make_offpolicy(env: Environment, env_params, cfg: OffPolicyConfig,
                   axis_name: Optional[str] = None, local_envs: Optional[int] = None,
                   device=None):
    """Build ``(init, update_kernel, eval_policy)`` for the configured
    algorithm (JAX make_offpolicy with ``collect="kernel"``):

    - ``init(generator) -> OffPolicyState`` initialises the actor and the
      critics from ``generator`` (on its device), fresh optimizer states,
      unit statistics, an empty buffer (the capacity rounded down to whole
      collection chunks) and ``num_envs`` reset envs;
    - ``update_kernel(state, generator, warmup=False) -> (state, metrics)``
      runs one episode-chunked iteration (``warmup``: the uniform head);
      ``update_kernel.iterate(state, seed, idx, z, warmup)`` is the same
      iteration on given draws, and ``update_kernel.one_update(state, idx,
      z_next, z_pi, uidx)`` one gradient step on given minibatch indices
      and normals;
    - ``eval_policy((actor, rms), obs, generator, t)`` is the deterministic
      squashed mean, rescaled to the action box (int-cast for integer
      actions).

    ``collect="xla"`` and a mesh (``axis_name``) raise NotImplementedError."""
    if cfg.n_step < 1:
        raise ValueError(f"n_step must be >= 1, got {cfg.n_step}")
    if cfg.collect not in ("xla", "kernel"):
        raise ValueError(f"collect must be 'xla' or 'kernel', got {cfg.collect!r}")
    if cfg.collect == "xla":
        raise NotImplementedError(f"collect='xla' (the step-interleaved path) {_A9B}")
    if axis_name is not None or local_envs is not None:
        raise NotImplementedError(f"data-parallel off-policy training over a mesh {_A9B}")
    if cfg.algo not in ("sac", "td3", "ddpg"):
        raise ValueError(f"algo must be 'sac', 'td3' or 'ddpg', got {cfg.algo!r}")
    dev = resolve_device(device)
    fam = getattr(env, "name", None)
    if fam not in ("inv_management", "newsvendor", "net_inv_management"):
        raise NotImplementedError(
            "collect='kernel' supports the InvManagement, Newsvendor and NetInvMgmt "
            f"families (got {fam!r})")
    n_local = cfg.num_envs
    horizon = env.horizon(env_params)
    if cfg.n_step > horizon:
        raise ValueError(
            f"collect='kernel' runs episode-aligned collection: n_step ({cfg.n_step}) "
            f"cannot exceed the env horizon ({horizon})")
    chunk = n_local * horizon
    if cfg.buffer_size < chunk:
        raise ValueError(
            "collect='kernel' inserts num_envs * horizon transitions per iteration "
            f"({n_local} * {horizon} = {chunk}); buffer_size must hold at least one "
            f"collection chunk (got {cfg.buffer_size})")
    # the capacity rounded down to whole chunks keeps insert_chunk's pointer aligned
    buffer_local = (cfg.buffer_size // chunk) * chunk

    space = env.action_space(env_params)
    obs_dim = int(env.observation_space(env_params).shape[0])
    act_dim = int(np.prod(space.shape))
    low = torch.as_tensor(space.low, dtype=torch.float32, device=dev)
    high = torch.as_tensor(np.where(np.isinf(space.high), 1e4, space.high),
                           dtype=torch.float32, device=dev)
    int_actions = np.issubdtype(space.dtype, np.integer)
    stochastic = cfg.algo == "sac"
    target_entropy = -float(act_dim)
    opt = _adam(cfg)

    def to_env_action(a_norm):
        a = low.to(a_norm.device) + (a_norm + 1.0) * 0.5 * (high - low).to(a_norm.device)
        return a.to(torch.int32) if int_actions else a

    def norm(rms, x):
        return rms.normalize(x) if cfg.normalize_obs else x.to(torch.float32)

    def init(generator: torch.Generator) -> OffPolicyState:
        with torch.device(generator.device):
            actor = _Actor(obs_dim, act_dim, cfg.pi_arch, stochastic, generator)
            twin_q = TwinQ(obs_dim, act_dim, cfg.q_arch, cfg.algo == "ddpg", generator)
        actor, twin_q = actor.to(dev), twin_q.to(dev)
        log_alpha = torch.zeros((), dtype=torch.float32, device=dev)
        env_state, ts0 = vecenv.batch_reset(env, env_params, generator, n_local, device=dev)
        return OffPolicyState(
            actor_params=actor, q_params=twin_q, target_q_params=copy.deepcopy(twin_q),
            target_actor_params=copy.deepcopy(actor), log_alpha=log_alpha,
            actor_opt=opt.init(list(actor.parameters())),
            q_opt=opt.init(list(twin_q.parameters())), alpha_opt=opt.init([log_alpha]),
            rms=RunningMeanStd.create(obs_dim, dev),
            buffer=ReplayBuffer.create(buffer_local, obs_dim, act_dim, dev),
            env_state=env_state, last_obs=ts0.obs, step_idx=0)

    def actor_raw(actor, nobs, z):
        """SAC's pre-squash sample mean + std * z and its log-prob."""
        mean, log_std = actor(nobs)
        raw = mean + torch.exp(torch.clamp(log_std, -10.0, 2.0)) * z
        return raw, networks.gaussian_log_prob(raw, mean, log_std)

    def one_update(state: OffPolicyState, idx, z_next, z_pi, uidx: int):
        """One critic/actor/alpha gradient step (JAX _make_one_update's
        one_update) on the buffer rows ``idx`` (batch,); ``z_next`` and
        ``z_pi`` (batch, act_dim) are the standard normals of SAC's target
        and actor samples (TD3's target smoothing takes ``z_next``).
        ``uidx`` gates TD3's delayed actor update. Updates ``state`` in
        place."""
        actor, twin_q = state.actor_params, state.q_params
        mb = state.buffer.gather(idx)
        nob, nnext = norm(state.rms, mb["obs"]), norm(state.rms, mb["next_obs"])
        alpha = torch.exp(state.log_alpha)
        with torch.no_grad():
            if stochastic:
                next_raw, next_logp = actor_raw(actor, nnext, z_next)
                q1t, q2t = state.target_q_params(nnext, torch.tanh(next_raw))
                qt = torch.minimum(q1t, q2t) - alpha * next_logp
            else:
                next_a = torch.tanh(state.target_actor_params(nnext)[0])
                if cfg.algo == "td3":
                    smooth = torch.clamp(cfg.target_noise * z_next, -cfg.noise_clip,
                                         cfg.noise_clip)
                    next_a = torch.clamp(next_a + smooth, -1.0, 1.0)
                q1t, q2t = state.target_q_params(nnext, next_a)
                qt = torch.minimum(q1t, q2t)
            target = mb["reward"] + mb["disc"] * qt

        q_params = list(twin_q.parameters())
        q1, q2 = twin_q(nob, mb["action"])
        q_loss = ((q1 - target) ** 2).mean()
        if cfg.algo != "ddpg":
            q_loss = q_loss + ((q2 - target) ** 2).mean()
        state.q_opt = opt.step(q_params, torch.autograd.grad(q_loss, q_params), state.q_opt)

        a_params = list(actor.parameters())
        do_actor = cfg.algo != "td3" or uidx % cfg.policy_delay == 0
        logp = None
        if stochastic:
            raw, logp = actor_raw(actor, nob, z_pi)
            q1, q2 = twin_q(nob, torch.tanh(raw))
            a_loss = (alpha.detach() * logp - torch.minimum(q1, q2)).mean()
        elif do_actor:
            mean, _ = actor(nob)
            q1, _ = twin_q(nob, torch.tanh(mean))
            sat = torch.clamp_min(torch.abs(mean) - 1.0, 0.0)
            qscale = torch.abs(q1).mean().detach() + 1.0
            a_loss = -q1.mean() + cfg.pretanh_penalty * qscale * (sat ** 2).mean()
        if do_actor:
            a_grads = torch.autograd.grad(a_loss, a_params)
        else:   # TD3 between delayed updates: Adam still steps on zero gradients
            a_grads = [torch.zeros_like(p) for p in a_params]
        state.actor_opt = opt.step(a_params, a_grads, state.actor_opt)

        if stochastic:
            la = state.log_alpha.detach().requires_grad_(True)
            al_loss = -(torch.exp(la) * (logp.detach() + target_entropy)).mean()
            la_grad, = torch.autograd.grad(al_loss, [la])
            log_alpha = state.log_alpha.detach().clone()
            state.alpha_opt = opt.step([log_alpha], [la_grad], state.alpha_opt)
            state.log_alpha = log_alpha

        _polyak(state.target_q_params, twin_q, cfg.tau)
        _polyak(state.target_actor_params, actor, cfg.tau)
        return dict(q_loss=q_loss.detach(), actor_loss=a_loss.detach() if do_actor else None)

    def collect(state: OffPolicyState, seed: int, mode: str):
        """One episode per env through the family's trajectory kernel:
        (obs_all (T+1, B, D) f32, a_norm (T, B, A), reward (T, B))."""
        actor_f = episode_kernels.fold_offpolicy_actor(
            cfg.pi_arch, state.actor_params, state.rms if cfg.normalize_obs else None,
            stochastic)
        # TD3/DDPG's noise sigma rides the kernels' clipped-std input, so an
        # explore_noise of 0 becomes exp(-10) ~ 4.54e-5, as in the JAX package
        log_std = torch.full((act_dim,), float(np.log(np.float32(max(cfg.explore_noise, 1e-8)))),
                             dtype=torch.float32)
        if fam == "inv_management":
            tr = episode_kernels.rollout_traj_im_offpolicy(env_params, actor_f, log_std, seed,
                                                           n_local, mode, "relu", dev)
            obs_all = inv_management.assemble_obs_from_streams(env_params, tr["inv"],
                                                               tr["actions"])
        elif fam == "newsvendor":
            tr = episode_kernels.rollout_traj_nv_offpolicy(env_params, actor_f, log_std, seed,
                                                           n_local, mode, "relu", dev)
            obs_all = newsvendor.assemble_obs_from_streams(env_params, tr["econ"],
                                                           tr["orders"])
        else:
            tr = net_step.rollout_traj_net_offpolicy(env_params, actor_f, log_std, seed,
                                                     n_local, mode, "relu", dev)
            obs_all = net_inv_management.assemble_obs_from_streams(env_params, tr["x"],
                                                                   tr["u"], tr["r"])
        return obs_all.to(torch.float32), tr["raw"].transpose(1, 2), tr["reward"]

    def iterate(state: OffPolicyState, seed: int, idx, z, warmup: bool = False):
        """One episode-chunked iteration on given draws: the kernel's
        ``seed``, the minibatch rows ``idx`` (horizon * updates_per_iter,
        batch) and the normals ``z`` (horizon * updates_per_iter, 2, batch,
        act_dim) of ``one_update``. Updates ``state`` in place and returns
        (state, metrics)."""
        mode = "uniform" if warmup else ("sac" if stochastic else "det")
        obs_all, a_norm, reward = collect(state, seed, mode)
        T_h = reward.shape[0]
        state.buffer.insert_chunk(*episode_transitions(obs_all, a_norm, reward, cfg.n_step,
                                                       cfg.gamma))
        if cfg.normalize_obs:
            state.rms = state.rms.update(obs_all[:T_h].reshape(-1, obs_all.shape[-1]))
        n_upd = len(idx)
        for u in range(n_upd):
            one_update(state, idx[u], z[u, 0], z[u, 1], state.step_idx * n_upd + u)
        state.step_idx += 1
        return state, dict(mean_step_reward=torch.mean(reward),
                           alpha=torch.exp(state.log_alpha))

    def update_kernel(state: OffPolicyState, generator: torch.Generator,
                      warmup: bool = False):
        """One episode-chunked iteration (JAX update_kernel): a full episode
        per env in the kernel (``warmup``: the uniform head), all
        ``num_envs * horizon`` transitions inserted oldest first, the obs
        statistics updated, then ``horizon * updates_per_iter`` gradient
        steps, TD3's delay counting gradient steps. The generator draws the
        kernel's seed, then every step's minibatch indices (uniform over the
        rows filled once this chunk is in) and normals; ``iterate`` runs the
        iteration on them. Returns (state, metrics)."""
        gdev = generator.device
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator, device=gdev))
        n_upd = horizon * cfg.updates_per_iter
        filled = min(state.buffer.filled + chunk, state.buffer.size)
        idx = torch.randint(0, filled, (n_upd, cfg.batch_size), generator=generator,
                            device=gdev).to(dev)
        z = torch.randn((n_upd, 2, cfg.batch_size, act_dim), generator=generator,
                        device=gdev).to(dev)
        return iterate(state, seed, idx, z, warmup)

    update_kernel.one_update = one_update
    update_kernel.iterate = iterate
    update_kernel.collect = collect

    @torch.no_grad()
    def eval_policy(policy_state, obs, _generator, _t):
        actor, rms = policy_state
        mean, _ = actor(norm(rms, obs))
        return to_env_action(torch.tanh(mean))

    return init, update_kernel, eval_policy


def train(env: Environment, env_params, cfg: OffPolicyConfig, generator: torch.Generator,
          total_timesteps: int, log_every: int = 500, progress=None, mesh=None,
          axis_name: str = "env", device=None):
    """Run off-policy training with ``collect="kernel"`` (JAX train): exactly
    ``total_timesteps // (num_envs * horizon)`` iterations (at least one),
    the first ``ceil(start_steps / (num_envs * horizon))`` of them the
    uniform warmup, metrics averaged over chunks of ``log_every``
    iterations (each chunk within one phase). Returns (state, eval_policy,
    metrics as a dict of numpy arrays with mean_step_reward, alpha and
    timesteps). ``progress(metrics, state)`` is called after each chunk. A
    ``mesh`` raises NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError(f"data-parallel off-policy training over a mesh {_A9B}")
    init, update, eval_policy = make_offpolicy(env, env_params, cfg, device=device)
    state = init(generator)
    steps_per_iter = cfg.num_envs * env.horizon(env_params)
    n_iters = max(1, total_timesteps // steps_per_iter)
    warm_iters = min(n_iters, -(-cfg.start_steps // steps_per_iter)) \
        if cfg.start_steps > 0 else 0
    log_every = max(1, min(log_every, n_iters))
    metrics_log = []
    done_iters = 0
    while done_iters < n_iters:
        n = min(log_every, n_iters - done_iters)
        warm = done_iters < warm_iters
        if warm:
            n = min(n, warm_iters - done_iters)
        chunk = []
        for _ in range(n):
            state, metrics = update(state, generator, warmup=warm)
            chunk.append(metrics)
        done_iters += n
        m = {k: float(torch.stack([c[k] for c in chunk]).mean()) for k in chunk[0]}
        m["timesteps"] = done_iters * steps_per_iter
        metrics_log.append(m)
        if progress:
            progress(m, state)
    stacked = {k: np.array([m[k] for m in metrics_log]) for k in metrics_log[0]}
    return state, eval_policy, stacked


class OffPolicyAgent:
    """The BaseAgent-protocol wrapper of the JAX package (checkpoints,
    save/load, get_action) is still to port (ROADMAP.md A9b)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{type(self).__name__} {_A9B}")


class SACAgent(OffPolicyAgent):
    pass


class TD3Agent(OffPolicyAgent):
    pass


class DDPGAgent(OffPolicyAgent):
    pass
