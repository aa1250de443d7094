"""Off-policy actor-learners, SAC, TD3 and DDPG, on a replay buffer on the
device, and their agents.

Port of ``or_gym_inventory_tpu/agents/off_policy.py`` without the mesh, on
all three families, on both collection paths:

- ``collect="xla"`` (the default): each iteration takes one fused
  policy+env step of every env through ``vector.vecenv`` (``batch_step``,
  then ``auto_reset``), pushes the transition into a rolling n-step window,
  inserts the window's collapsed transition into the buffer, then runs
  ``updates_per_iter`` gradient updates, TD3's delay counted in iterations.
  Plain PyTorch on the device it is given, as the JAX package left it to
  XLA: no kernel is launched.
- ``collect="kernel"``: each iteration runs one full episode per env in the
  family's trajectory kernel with the folded relu actor and the head of the
  phase (``"uniform"`` while warming up, then ``"sac"`` for SAC's squashed
  state-dependent Gaussian or ``"det"`` for TD3/DDPG's clipped post-squash
  noise): ``ops.episode_kernels.rollout_traj_im_offpolicy`` (K27),
  ``rollout_traj_nv_offpolicy`` (K28) or ``ops.net_step.
  rollout_traj_net_offpolicy`` (K29). It inserts the ``num_envs * horizon``
  n-step transitions in one contiguous write, then runs ``horizon *
  updates_per_iter`` gradient updates (the xla path's update:env-step
  ratio), TD3's delay counted in gradient updates.

The gradient steps are plain PyTorch (``nn`` layers, autograd) on both.
``OffPolicyAgent`` (``SACAgent``, ``TD3Agent``, ``DDPGAgent``) wraps them in
the ``BaseAgent`` protocol with checkpoints, as ``agents.ppo.PPOAgent``.

Where the port differs in form:

- The state holds ``nn.Module``s (``actor_params``, ``q_params`` and the
  two targets keep JAX's field names) that an update changes in place, and
  the optimizer states of ``agents.ppo.Optimizer`` (``optax.adam(lr)``
  exactly: eps 1e-8, no clipping, no anneal).
- The replay buffer is written in place; ``insert`` and ``insert_chunk``
  return it, so JAX's ``buf = buf.insert(...)`` reads the same.
- One ``torch.Generator`` replaces the JAX key chain. On the kernel path it
  draws each iteration's kernel seed, then its minibatch indices and
  normals; on the xla path each iteration's action normals and warmup
  uniforms, then its minibatch indices and normals, then the env's draws.
  ``iterate`` takes those as tensors on either path, so a test can feed
  JAX's.
- The kernels run in full f32; the JAX package ran the off-policy heads'
  matmuls at DEFAULT (bf16-class) precision to fit its TPU compiler
  (``off_policy.py:599-606``).
- JAX's ``num_envs % 1024`` check and its TPU-backend check were tile and
  platform constraints: the CUDA kernels mask the batch tail.
- The data-parallel path (``mesh=``, ``axis_name``) is still to port
  (ROADMAP.md A14); it raises NotImplementedError.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from or_gym_inventory_torch.agents import networks
from or_gym_inventory_torch.agents.base import (BaseAgent, ckpt_trained_timesteps,
                                                write_ckpt_meta)
from or_gym_inventory_torch.agents.ppo import Optimizer, OptState, PPOConfig, RunningMeanStd
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import inv_management, net_inv_management, newsvendor
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.ops import episode_kernels, net_step
from or_gym_inventory_torch.utils import checkpoint
from or_gym_inventory_torch.vector import vecenv

_MESH = ("data-parallel off-policy training over a mesh is still to port "
         "(ROADMAP.md A14, torch.distributed)")


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
    window: dict               # the rolling n-step window, oldest first (xla path)


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
    """Build ``(init, update, eval_policy)`` for the configured algorithm and
    collection path (JAX make_offpolicy):

    - ``init(generator) -> OffPolicyState`` initialises the actor and the
      critics from ``generator`` (on its device), fresh optimizer states,
      unit statistics, an empty buffer (on the kernel path the capacity
      rounded down to whole collection chunks), ``num_envs`` reset envs and
      a zero n-step window;
    - with ``collect="xla"``, ``update(state, generator) -> (state,
      metrics)`` runs one step-interleaved iteration;
      ``update.iterate(state, generator, a_z, a_u, idx, z)`` is the same
      iteration on given draws (the action normals and warmup uniforms
      (num_envs, act_dim), the minibatch rows (updates_per_iter, batch) and
      normals (updates_per_iter, 2, batch, act_dim)), ``generator`` then
      drawing only the env's steps and resets;
    - with ``collect="kernel"``, ``update(state, generator, warmup=False)
      -> (state, metrics)`` runs one episode-chunked iteration
      (``warmup``: the uniform head); ``update.iterate(state, seed, idx, z,
      warmup)`` is the same iteration on given draws;
    - ``update.one_update(state, idx, z_next, z_pi, uidx)`` is one gradient
      step on given minibatch indices and normals, on either path;
    - ``eval_policy((actor, rms), obs, generator, t)`` is the deterministic
      squashed mean, rescaled to the action box (int-cast for integer
      actions).

    A mesh (``axis_name``, ``local_envs``) raises NotImplementedError."""
    if cfg.n_step < 1:
        raise ValueError(f"n_step must be >= 1, got {cfg.n_step}")
    if cfg.collect not in ("xla", "kernel"):
        raise ValueError(f"collect must be 'xla' or 'kernel', got {cfg.collect!r}")
    if axis_name is not None or local_envs is not None:
        raise NotImplementedError(_MESH)
    if cfg.algo not in ("sac", "td3", "ddpg"):
        raise ValueError(f"algo must be 'sac', 'td3' or 'ddpg', got {cfg.algo!r}")
    dev = resolve_device(device)
    fam = getattr(env, "name", None)
    n_local = cfg.num_envs
    buffer_local = cfg.buffer_size
    kernel_mode = cfg.collect == "kernel"
    if kernel_mode:
        if fam not in ("inv_management", "newsvendor", "net_inv_management"):
            raise NotImplementedError(
                "collect='kernel' supports the InvManagement, Newsvendor and NetInvMgmt "
                f"families (got {fam!r})")
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
        f32 = dict(dtype=torch.float32, device=dev)
        n = cfg.n_step
        window = dict(obs=torch.zeros((n, n_local, obs_dim), **f32),
                      action=torch.zeros((n, n_local, act_dim), **f32),
                      reward=torch.zeros((n, n_local), **f32),
                      next_obs=torch.zeros((n, n_local, obs_dim), **f32),
                      done=torch.zeros((n, n_local), dtype=torch.bool, device=dev))
        return OffPolicyState(
            actor_params=actor, q_params=twin_q, target_q_params=copy.deepcopy(twin_q),
            target_actor_params=copy.deepcopy(actor), log_alpha=log_alpha,
            actor_opt=opt.init(list(actor.parameters())),
            q_opt=opt.init(list(twin_q.parameters())), alpha_opt=opt.init([log_alpha]),
            rms=RunningMeanStd.create(obs_dim, dev),
            buffer=ReplayBuffer.create(buffer_local, obs_dim, act_dim, dev),
            env_state=env_state, last_obs=ts0.obs, step_idx=0, window=window)

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

    # ------------------------------------------- the step-interleaved path
    ins = "insert_chunk" if buffer_local % n_local == 0 else "insert"

    def act(state: OffPolicyState, a_z, a_u):
        """The iteration's normalised action: ``a_u`` (uniform in [-1, 1])
        until ``start_steps`` env steps, then SAC's squashed sample or
        TD3/DDPG's clipped tanh(mean) + explore_noise * ``a_z``, the noise
        after the squash."""
        if state.step_idx * cfg.num_envs < cfg.start_steps:
            return a_u
        with torch.no_grad():
            mean, log_std = state.actor_params(norm(state.rms, state.last_obs))
            if stochastic:
                return torch.tanh(mean + torch.exp(torch.clamp(log_std, -10.0, 2.0)) * a_z)
            return torch.clamp(torch.tanh(mean) + cfg.explore_noise * a_z, -1.0, 1.0)

    def iterate_xla(state: OffPolicyState, generator: torch.Generator, a_z, a_u, idx, z):
        """One step-interleaved iteration on given draws (JAX update): the
        action, one step of every env and its auto-reset (``generator``
        draws their demand and resets), the transition pushed into the
        oldest-first window, whose collapse is inserted once the window is
        full, the obs statistics updated on the pre-step obs, then
        ``len(idx)`` gradient steps, each with TD3's phase ``step_idx``.
        Updates ``state`` in place and returns (state, metrics)."""
        a_norm = act(state, a_z, a_u)
        env_state, ts = vecenv.batch_step(env, env_params, state.env_state,
                                          to_env_action(a_norm), generator)
        env_state, next_obs = vecenv.auto_reset(env, env_params, env_state, ts, generator,
                                                n_local)
        new = dict(obs=state.last_obs.to(torch.float32), action=a_norm, reward=ts.reward,
                   next_obs=ts.obs.to(torch.float32), done=ts.done)
        window = {k: v[None] if cfg.n_step == 1 else torch.cat([state.window[k][1:], v[None]])
                  for k, v in new.items()}
        # the window starts at zero: its oldest row holds a real transition
        # only after n_step - 1 pushes
        if state.step_idx >= cfg.n_step - 1:
            reward_n, next_obs_n, done_n, disc_n = nstep_aggregate(
                window["reward"], window["done"], window["next_obs"], cfg.gamma)
            getattr(state.buffer, ins)(window["obs"][0], window["action"][0], reward_n,
                                       next_obs_n, done_n, disc_n)
        if cfg.normalize_obs:
            state.rms = state.rms.update(state.last_obs)
        for u in range(len(idx)):
            one_update(state, idx[u], z[u, 0], z[u, 1], state.step_idx)
        state.env_state, state.last_obs, state.window = env_state, next_obs, window
        state.step_idx += 1
        return state, dict(mean_step_reward=torch.mean(ts.reward),
                           alpha=torch.exp(state.log_alpha))

    def update(state: OffPolicyState, generator: torch.Generator):
        """One step-interleaved iteration (JAX update): ``generator`` draws
        the action normals and warmup uniforms, the minibatch rows (uniform
        over the rows filled once this iteration's transition is in) and
        normals, then the env's steps and resets; ``iterate`` runs it.
        Returns (state, metrics)."""
        gdev = generator.device
        shape = (n_local, act_dim)
        a_z = torch.randn(shape, generator=generator, device=gdev).to(dev)
        a_u = (torch.rand(shape, generator=generator, device=gdev) * 2.0 - 1.0).to(dev)
        filled = state.buffer.filled + (n_local if state.step_idx >= cfg.n_step - 1 else 0)
        filled = min(filled, state.buffer.size)
        idx = torch.randint(0, max(filled, 1), (cfg.updates_per_iter, cfg.batch_size),
                            generator=generator, device=gdev).to(dev)
        z = torch.randn((cfg.updates_per_iter, 2, cfg.batch_size, act_dim),
                        generator=generator, device=gdev).to(dev)
        return iterate_xla(state, generator, a_z, a_u, idx, z)

    # ------------------------------------------------ the kernel path
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
    update.one_update = one_update
    update.iterate = iterate_xla

    @torch.no_grad()
    def eval_policy(policy_state, obs, _generator, _t):
        actor, rms = policy_state
        mean, _ = actor(norm(rms, obs))
        return to_env_action(torch.tanh(mean))

    return init, (update_kernel if kernel_mode else update), eval_policy


def train(env: Environment, env_params, cfg: OffPolicyConfig, generator: torch.Generator,
          total_timesteps: int, log_every: int = 500, progress=None, mesh=None,
          axis_name: str = "env", device=None):
    """Run off-policy training (JAX train): exactly ``total_timesteps //
    steps_per_iter`` iterations (at least one), an iteration covering
    ``num_envs`` env steps with ``collect="xla"`` and ``num_envs * horizon``
    with ``collect="kernel"``, whose first ``ceil(start_steps /
    steps_per_iter)`` iterations run the uniform head as their own phase
    (the xla path warms up inside its iterations). Metrics stay on the
    device and are averaged over chunks of ``log_every`` iterations (each
    chunk within one phase). Returns (state, eval_policy, metrics as a dict
    of numpy arrays with mean_step_reward, alpha and timesteps).
    ``progress(metrics, state)`` is called after each chunk. A ``mesh``
    raises NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    kernel_mode = cfg.collect == "kernel"
    init, update, eval_policy = make_offpolicy(env, env_params, cfg, device=device)
    state = init(generator)
    steps_per_iter = cfg.num_envs * (env.horizon(env_params) if kernel_mode else 1)
    n_iters = max(1, total_timesteps // steps_per_iter)
    warm_iters = min(n_iters, -(-cfg.start_steps // steps_per_iter)) \
        if kernel_mode and cfg.start_steps > 0 else 0
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
            if kernel_mode:
                state, metrics = update(state, generator, warmup=warm)
            else:
                state, metrics = update(state, generator)
            chunk.append(metrics)
        done_iters += n
        m = {k: float(torch.stack([c[k] for c in chunk]).mean()) for k in chunk[0]}
        m["timesteps"] = done_iters * steps_per_iter
        metrics_log.append(m)
        if progress:
            progress(m, state)
    stacked = {k: np.array([m[k] for m in metrics_log]) for k in metrics_log[0]}
    return state, eval_policy, stacked


# ======================================================== host agent wrapper

class OffPolicyAgent(BaseAgent):
    """The ``BaseAgent``-protocol wrapper over SAC, TD3 and DDPG (JAX
    ``off_policy.py:809-979``), with SB3AgentWrapper's ergonomics: the
    checkpoint shortcut unless ``force_retrain``, ``save``/``load``, the
    training log, deterministic evaluation actions.

    ``eval_every_chunks`` > 0 is the EvalCallback analogue: every so many
    training chunks a deterministic ``vecenv.evaluate_episodes`` of
    ``eval_episodes`` envs, the best actor and statistics kept and restored
    after training (benchmark_InvManagementBacklogEnv.py:275-281, 303-311).
    ``device`` is where training runs (None: the card); ``get_action``
    answers from a CPU copy of the actor, since one observation at a time
    is bound by latency. A ``mesh`` raises NotImplementedError in ``train``
    (ROADMAP.md A14)."""

    def __init__(self, env: Environment, params_factory, algo: str = "sac",
                 name: Optional[str] = None, config: Optional[OffPolicyConfig] = None,
                 model_dir: str = "./models", log_dir: str = "./logs",
                 force_retrain: bool = False, seed: int = 0, eval_every_chunks: int = 0,
                 eval_episodes: int = 64, mesh=None, device=None):
        super().__init__(name=name or algo.upper())
        self.env = env
        self.params_factory = params_factory
        self.config = (config or OffPolicyConfig()).replace(algo=algo)
        self.model_dir, self.log_dir = model_dir, log_dir
        self.force_retrain = force_retrain
        self.seed = seed
        self.mesh = mesh
        self.eval_every_chunks = eval_every_chunks
        self.eval_episodes = eval_episodes
        self.device = device
        self.env_params = None
        self.state = None
        self.training_log = None
        self.trained_timesteps = 0
        self._eval = None

    # -- persistence -----------------------------------------------------
    def _ckpt_path(self, prefix: str = "") -> str:
        return os.path.join(self.model_dir, f"{prefix}{self.name}.pt")

    def save(self, path: Optional[str] = None) -> str:
        """The actor and the obs statistics to ``path`` (the agent's
        checkpoint by default), with the trained budget beside it."""
        path = path or self._ckpt_path()
        rms = self.state.rms
        checkpoint.save_pytree(path, {
            "actor": checkpoint.to_tree(self.state.actor_params),
            "rms": {"mean": rms.mean, "var": rms.var, "count": rms.count}})
        write_ckpt_meta(path, self.trained_timesteps)
        return path

    def _xla(self, dev, params=None):
        """(init, update, eval_policy) of the xla path on ``dev``: init and
        evaluation do not depend on the collection path, so a kernel-trained
        checkpoint loads and evaluates on any device."""
        return make_offpolicy(self.env, params or self.env_params,
                              self.config.replace(collect="xla"), device=dev)

    def load(self, path: str):
        """A state holding the checkpoint's actor and obs statistics (and a
        template's one env, critics and buffer), on the agent's device."""
        dev = resolve_device(self.device)
        payload = checkpoint.load_pytree(path, map_location=dev)
        if self.env_params is None:
            self.env_params = self.params_factory()
        init, _, _ = make_offpolicy(
            self.env, self.env_params,
            self.config.replace(collect="xla", num_envs=1, buffer_size=1), device=dev)
        state = init(torch.Generator(device=dev).manual_seed(self.seed))
        state.actor_params.load_state_dict(payload["actor"])
        state.rms = RunningMeanStd(**payload["rms"])
        self.state = state
        self.trained_timesteps = ckpt_trained_timesteps(path)
        self._eval = None

    # -- training --------------------------------------------------------
    def _fit(self, total_timesteps: int, dev):
        """(state, metrics) of a training run on ``dev``, with the
        EvalCallback analogue's best actor restored."""
        best = {"reward": -np.inf, "actor": None, "rms": None}
        progress = None
        if self.eval_every_chunks > 0:
            _, _, eval_pol = self._xla(dev)
            chunks = [0]

            def progress(_m, st):
                chunks[0] += 1
                if chunks[0] % self.eval_every_chunks:
                    return
                totals, _ = vecenv.evaluate_episodes(
                    self.env, self.env_params, eval_pol, (st.actor_params, st.rms),
                    torch.Generator(device=dev).manual_seed(self.seed + 1),
                    self.eval_episodes, device=dev)
                mean = float(totals.double().mean())
                if mean > best["reward"]:
                    best.update(reward=mean, actor=copy.deepcopy(st.actor_params), rms=st.rms)

        state, _, metrics = train(self.env, self.env_params, self.config,
                                  torch.Generator(device=dev).manual_seed(self.seed),
                                  total_timesteps, progress=progress, mesh=self.mesh, device=dev)
        if best["actor"] is not None:
            print(f"Loading best model (eval reward {best['reward']:.2f})")
            state.actor_params, state.rms = best["actor"], best["rms"]
        return state, metrics

    def train(self, env_config: dict, total_timesteps: int, save_path_prefix: str = ""):
        self.env_params = self.params_factory(env_config=env_config or None)
        ckpt = self._ckpt_path(save_path_prefix)
        if not self.force_retrain and os.path.exists(ckpt):
            trained = ckpt_trained_timesteps(ckpt)
            if trained >= total_timesteps:
                print(f"Loading existing model for {self.name} from {ckpt} "
                      f"(trained {trained} >= {total_timesteps})")
                self.load(ckpt)
                self.training_time = 0.0
                return
            print(f"Checkpoint {ckpt} trained only {trained} < {total_timesteps} steps; "
                  "retraining")
        print(f"Training {self.name} ({self.config.algo}) for {total_timesteps} steps...")
        start = time.time()
        self.state, metrics = self._fit(total_timesteps, resolve_device(self.device))
        self._eval = None
        self.training_log = metrics
        self.training_time = time.time() - start
        self.trained_timesteps = total_timesteps
        self.save(ckpt)
        if metrics:
            os.makedirs(self.log_dir, exist_ok=True)
            with open(os.path.join(self.log_dir, f"{self.name}_train_log.csv"), "w",
                      newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(metrics.keys()))
                w.writeheader()
                for i in range(len(metrics["timesteps"])):
                    w.writerow({k: metrics[k][i] for k in metrics})
        print(f"Training for {self.name} finished in {self.training_time:.2f}s "
              f"({total_timesteps / max(self.training_time, 1e-9):,.0f} trained-steps/s)")

    # -- evaluation ------------------------------------------------------
    def _eval_policy(self):
        """The deterministic policy on the CPU and CPU copies of the actor
        and statistics it reads (a round trip to the card a step would cost
        more than the step)."""
        if self._eval is None:
            rms = self.state.rms
            cpu_rms = RunningMeanStd(mean=rms.mean.cpu(), var=rms.var.cpu(),
                                     count=rms.count.cpu())
            _, _, eval_policy = self._xla("cpu")
            self._eval = (eval_policy, (copy.deepcopy(self.state.actor_params).cpu(), cpu_rms))
        return self._eval

    def get_action(self, observation, env):
        if self.state is None:
            return env.action_space.sample().astype(env.action_space.dtype)
        policy, ps = self._eval_policy()
        obs = torch.as_tensor(np.asarray(observation, np.float32))[None]
        return np.asarray(policy(ps, obs, None, 0)[0]).astype(env.action_space.dtype)

    def device_policy(self, env, params):
        _, _, eval_policy = self._xla(resolve_device(self.device), self.env_params or params)
        ps = (self.state.actor_params, self.state.rms)
        return lambda _s, obs, generator, t: eval_policy(ps, obs, generator, t)


class SACAgent(OffPolicyAgent):
    def __init__(self, env, params_factory, name="SAC", **kw):
        super().__init__(env, params_factory, algo="sac", name=name, **kw)


class TD3Agent(OffPolicyAgent):
    def __init__(self, env, params_factory, name="TD3", **kw):
        super().__init__(env, params_factory, algo="td3", name=name, **kw)


class DDPGAgent(OffPolicyAgent):
    def __init__(self, env, params_factory, name="DDPG", **kw):
        super().__init__(env, params_factory, algo="ddpg", name=name, **kw)
