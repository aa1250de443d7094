"""PPO: the fused policy+env update and the trajectory-kernel update.

Port of ``or_gym_inventory_tpu/agents/ppo.py`` on all three families, on
one device or data-parallel over a ``parallel.Mesh``. Two ways to make an
update's experience:

- ``rollout="xla"`` (the default; JAX :589-673): ``rollout_steps`` periods
  of the policy and ``vecenv.batch_step`` / ``vecenv.auto_reset`` in a
  Python loop over ``num_envs`` envs, episodes carried across updates and
  reset where they end, the bootstrap taken from the pre-reset obs of a
  step whose episode ended. Plain PyTorch, as the JAX package left it to
  XLA: no kernel runs on this path.
- ``rollout="kernel"`` (JAX :486-587): episode-aligned updates, one
  stochastic-policy episode per env in the family's trajectory kernel
  (``ops.net_step.rollout_traj_net``, K4, ``ops.episode_kernels.
  rollout_traj_im``, K10, or ``rollout_traj_nv``, K18); the obs batch is
  rebuilt from the dumped streams and logp and values recomputed in one
  forward pass.

Both then run GAE and epochs of minibatched clipped-surrogate SGD
(``sgd_phase``: ``nn`` layers, autograd, matmuls). ``PPOAgent`` wraps the
learner in the reference's agent protocol (checkpoints, the skip-retrain
shortcut, the EvalCallback analogue, the training log).

Where the port differs in form:

- ``PPOTrainState.params`` is an ``MLPActorCritic``; an update changes its
  parameters and the optimizer state in place (JAX returned new trees).
- ``jax.random`` keys become one ``torch.Generator``: it draws the
  policy's noise, the envs' demand and resets, the kernel seed of every
  update and the minibatch permutations.
- With ``mesh=`` (JAX :678-765) every rank runs ``num_envs / world`` envs
  and the same update on them: the parameters start from the replicated
  generator and stay equal on every rank; the minibatch gradient is averaged
  over the ranks before the optimizer step (so the clip acts on the mean);
  ``RunningMeanStd`` sums its counts and moments over the ranks; the
  advantage statistics stay the shard's own; ``mean_step_reward`` is
  averaged. The envs' draws, the kernel seeds and the permutations come
  from the rank generator that ``train`` forks from the replicated one
  (``Mesh.rank_generator``), where JAX folded the axis index into its key.
- The JAX package's ``num_envs % 1024`` check was a TPU tile constraint;
  the CUDA kernels mask the batch tail, so any ``num_envs`` works.
- ``updates_per_call`` chunked updates into one device program; here every
  update is one Python call, and the metrics log keeps its keys.
- ``minibatch_chunks=0`` picks chunks of at most 32,768 samples, the JAX
  package's TPU-measured value, except on a CUDA device, where it keeps each
  minibatch whole (``_chunk_count``).
- Checkpoints are ``torch.save`` files with the suffix ``.pt``
  (``utils.checkpoint``), where the JAX package wrote flax msgpack.
"""

from __future__ import annotations

import copy
import csv
import dataclasses
import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from or_gym_inventory_torch.agents import networks
from or_gym_inventory_torch.agents.base import (BaseAgent, checkpoint_budget,
                                                ckpt_trained_timesteps, training_device,
                                                write_ckpt_meta, writes_files)
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import inv_management, net_inv_management, newsvendor
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.ops import episode_kernels, net_step
from or_gym_inventory_torch.utils import checkpoint
from or_gym_inventory_torch.vector import vecenv

# Below this env count the classic shuffled minibatch recipe is kept; at or
# above it minibatches are env slices (agents/ppo.py:42-46 of the JAX package)
NOSHUFFLE_ENVS_THRESHOLD = 16384


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX package's PPOConfig field for field; see its comments."""
    num_envs: int = 1024
    rollout_steps: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    update_epochs: int = 4
    num_minibatches: int = 8
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    pi_arch: Tuple[int, ...] = (64, 64)
    vf_arch: Tuple[int, ...] = (64, 64)
    activation: str = "tanh"
    anneal_lr: bool = True
    normalize_obs: bool = True
    normalize_reward: bool = True
    optimizer: str = "adam"
    shuffle_minibatches: Optional[bool] = None
    rollout: str = "xla"
    compute_dtype: Optional[str] = None
    minibatch_chunks: int = 0
    updates_per_call: int = 16

    def replace(self, **kw) -> "PPOConfig":
        return dataclasses.replace(self, **kw)

    def num_updates(self, total_timesteps: int) -> int:
        return max(1, total_timesteps // (self.num_envs * self.rollout_steps))

    def resolved_shuffle(self, n_envs: int) -> bool:
        """The effective minibatch recipe for ``n_envs``: with
        ``shuffle_minibatches=None`` the shuffled recipe below
        ``NOSHUFFLE_ENVS_THRESHOLD`` envs or when the env count does not
        divide into minibatches, env-sliced minibatches otherwise."""
        if self.shuffle_minibatches is None:
            return (n_envs < NOSHUFFLE_ENVS_THRESHOLD
                    or n_envs % self.num_minibatches != 0)
        return self.shuffle_minibatches


@dataclasses.dataclass(frozen=True)
class RunningMeanStd:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, dim: int, device=None) -> "RunningMeanStd":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(mean=torch.zeros((dim,), **f32), var=torch.ones((dim,), **f32),
                   count=torch.tensor(1e-4, **f32))

    def update(self, batch: torch.Tensor, mesh=None) -> "RunningMeanStd":
        """Welford batch update over every row of ``batch`` (..., dim); with
        a ``mesh`` the row count, sums and sums of squares are summed over
        the ranks first, so every rank holds the same statistics."""
        x = batch.reshape(-1, batch.shape[-1]).to(torch.float32)
        n = torch.tensor(float(x.shape[0]), dtype=torch.float32, device=x.device)
        s = torch.sum(x, dim=0)
        ss = torch.sum(x * x, dim=0)
        if mesh is not None:
            n, s, ss = mesh.sum([n, s, ss])
        b_mean = s / n
        b_var = torch.clamp_min(ss / n - b_mean ** 2, 0.0)
        delta = b_mean - self.mean
        tot = self.count + n
        new_mean = self.mean + delta * n / tot
        m_a = self.var * self.count
        m_b = b_var * n
        new_var = (m_a + m_b + delta ** 2 * self.count * n / tot) / tot
        return RunningMeanStd(mean=new_mean, var=new_var, count=tot)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x.to(torch.float32) - self.mean) / torch.sqrt(self.var + 1e-8)


@dataclasses.dataclass
class PPOTrainState:
    params: networks.MLPActorCritic
    opt_state: "OptState"
    rms: RunningMeanStd
    ret_rms: RunningMeanStd   # running std of discounted returns (reward norm)
    ret_accum: torch.Tensor   # (num_envs,) discounted return accumulator
    env_state: object
    last_obs: torch.Tensor
    update_idx: int


def _make_model(env: Environment, env_params, cfg: PPOConfig,
                generator: torch.Generator = None) -> networks.MLPActorCritic:
    """The actor-critic for ``env``, initialised from ``generator`` on the
    generator's device."""
    obs_dim = int(env.observation_space(env_params).shape[0])
    act_dim = int(np.prod(env.action_space(env_params).shape))
    with torch.device(generator.device if generator is not None else "cpu"):
        return networks.MLPActorCritic(obs_dim, act_dim, pi_arch=cfg.pi_arch,
                                       vf_arch=cfg.vf_arch,
                                       activation=cfg.activation,
                                       generator=generator)


def apply_actor_critic(params: networks.MLPActorCritic, obs_f: torch.Tensor,
                       cfg: PPOConfig, dtype: Optional[str] = None):
    """The model's forward as layer-by-layer math, with optional
    low-precision activations: ``dtype="bfloat16"`` rounds each matmul's
    inputs to bf16 and sums their products in f32 (the JAX package's
    ``preferred_element_type=f32``), leaving parameters, biases and outputs
    f32. Returns (mean, log_std, value).

    logp_old and logp_new are both computed through this function, so the
    epoch-0 PPO ratio is exactly 1; the kernel's sampling mean sums in
    another order, a small fixed off-policy-ness the clip absorbs."""
    act = networks._ACTS[cfg.activation]
    if dtype is None:
        cast = lambda x: x  # noqa: E731
    else:
        low = getattr(torch, dtype)
        cast = lambda x: x.to(low).to(torch.float32)  # noqa: E731

    def dense(x, layer):
        return cast(x) @ cast(layer.weight).T + layer.bias

    h = obs_f
    for layer in params.pi:
        h = act(dense(h, layer))
    mean = dense(h, params.mean)
    g = obs_f
    for layer in params.vf:
        g = act(dense(g, layer))
    value = dense(g, params.value)[..., 0]
    return mean, params.log_std, value


# ------------------------------------------------------------- optimizer

@dataclasses.dataclass
class OptState:
    count: int
    mu: list   # Adam's first moments (empty for RMSprop)
    nu: list   # second moments


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=1e-5)
    | rmsprop(lr, decay=0.99, eps=1e-5))`` step for step, on lists of
    tensors, updating the parameters in place:

    - the clip scales by max_norm / norm only when norm >= max_norm, as
      (g / norm) * max_norm (torch's clip_grad_norm_ adds 1e-6 to the norm);
    - with ``anneal_lr`` optimizer step k (from 0) takes lr * (1 - k / N),
      N = updates * epochs * minibatches, in f32 as optax computes it;
    - Adam: bias-corrected moments, update m / (sqrt(v) + eps);
    - RMSprop: nu from 0, update g / sqrt(nu + eps) (eps inside the root,
      optax's default).

    ``clip=False`` drops the clip and ``eps`` sets Adam's epsilon: with
    ``anneal_lr=False``, ``Optimizer(cfg, 1, eps=1e-8, clip=False)`` is
    ``optax.adam(lr)``, the off-policy learners' optimizer."""

    def __init__(self, cfg: PPOConfig, total_updates: int, eps: float = 1e-5,
                 clip: bool = True):
        self.cfg = cfg
        self.steps = max(1, total_updates * cfg.update_epochs * cfg.num_minibatches)
        self.eps, self.clip = eps, clip

    def init(self, params) -> OptState:
        zeros = [torch.zeros_like(p) for p in params]
        mu = [] if self.cfg.optimizer == "rmsprop" else [z.clone() for z in zeros]
        return OptState(count=0, mu=mu, nu=zeros)

    def _lr(self, count: int) -> float:
        lr = np.float32(self.cfg.lr)
        if not self.cfg.anneal_lr:
            return float(lr)
        k = np.float32(min(max(count, 0), self.steps))
        return float(lr * (np.float32(1.0) - k / np.float32(self.steps)))

    @torch.no_grad()
    def step(self, params, grads, state: OptState) -> OptState:
        if self.clip:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < self.cfg.max_grad_norm
            grads = [torch.where(trigger, g, (g / g_norm) * self.cfg.max_grad_norm)
                     for g in grads]
        count = state.count + 1
        if self.cfg.optimizer == "rmsprop":
            nu = [(1 - 0.99) * g ** 2 + 0.99 * n for g, n in zip(grads, state.nu)]
            updates = [torch.rsqrt(n + 1e-5) * g for g, n in zip(grads, nu)]
            mu = []
        else:
            b1, b2 = 0.9, 0.999
            mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
            nu = [(1 - b2) * g ** 2 + b2 * n for g, n in zip(grads, state.nu)]
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            updates = [(m / bc1) / (torch.sqrt(n / bc2) + self.eps)
                       for m, n in zip(mu, nu)]
        step_size = -self._lr(state.count)
        for p, u in zip(params, updates):
            p.add_(step_size * u)
        return OptState(count=count, mu=mu, nu=nu)


# ------------------------------------------------------------ train state

def init_train_state(env: Environment, env_params, cfg: PPOConfig,
                     generator: torch.Generator, total_updates: int,
                     device=None, local_envs: Optional[int] = None,
                     env_generator: Optional[torch.Generator] = None) -> PPOTrainState:
    """A fresh model initialised from ``generator``, a fresh optimizer
    state, unit running statistics and ``local_envs`` (by default
    ``num_envs``) envs on ``device``, reset from ``env_generator`` (by
    default ``generator``; a rank generator under a mesh)."""
    dev = resolve_device(device)
    model = _make_model(env, env_params, cfg, generator).to(dev)
    obs_dim = int(env.observation_space(env_params).shape[0])
    n = local_envs or cfg.num_envs
    opt_state = Optimizer(cfg, total_updates).init(list(model.parameters()))
    env_state, ts0 = vecenv.batch_reset(env, env_params, env_generator or generator, n,
                                        device=dev)
    return PPOTrainState(
        params=model, opt_state=opt_state,
        rms=RunningMeanStd.create(obs_dim, dev),
        ret_rms=RunningMeanStd.create(1, dev),
        ret_accum=torch.zeros((n,), dtype=torch.float32, device=dev),
        env_state=env_state, last_obs=ts0.obs, update_idx=0)


def gae_advantages(cfg: PPOConfig, reward, done, values, next_values):
    """Generalized advantage estimates over time-major (T, B) tensors; delta
    bootstraps through ``next_values`` and ``done`` stops propagation across
    episode boundaries."""
    adv = torch.zeros_like(values[0])
    advs = []
    for t in range(reward.shape[0] - 1, -1, -1):
        nd = 1.0 - done[t].to(torch.float32)
        delta = reward[t] + cfg.gamma * next_values[t] - values[t]
        adv = delta + cfg.gamma * cfg.gae_lambda * nd * adv
        advs.append(adv)
    return torch.stack(advs[::-1])


def _chunk_count(cfg: PPOConfig, mb_samples: int, device_type: str = "cpu") -> int:
    """Sequential sub-chunks of a minibatch's gradient: ``minibatch_chunks``,
    or with 0 the automatic value: 1 on a CUDA device, where the update is
    bound by the host's launches and one pass per minibatch was 4.3x faster
    than 8 chunks (PERF.md), elsewhere the JAX package's largest chunk of at
    most 32,768 samples. A divisor is searched up to twice the start, else
    the minibatch stays whole."""
    if cfg.minibatch_chunks > 0:
        k0 = cfg.minibatch_chunks
    elif device_type == "cuda":
        return 1
    else:
        k0 = -(-mb_samples // 32768)
    k = k0
    while k <= 2 * k0 and mb_samples % k:
        k += 1
    if k > 2 * k0 or mb_samples % k:
        return 1
    return min(k, mb_samples)


def sgd_phase(cfg: PPOConfig, opt: Optimizer, state: PPOTrainState, batch: dict,
              n_envs: int, generator: torch.Generator, mesh=None):
    """Epochs of minibatched clipped-surrogate SGD over a time-major batch
    dict (T, n_envs, ...) with keys obs/raw/logp/value/adv/ret, the obs
    normalised already (the kernel path stores them once per update). The
    forward is ``apply_actor_critic`` at ``cfg.compute_dtype``; with a
    ``mesh`` each minibatch gradient is averaged over the ranks before the
    step. Updates ``state.params`` and ``state.opt_state`` in place;
    returns the (pg_loss, v_loss, entropy) means over every minibatch."""
    model = state.params
    params = list(model.parameters())
    T_steps = batch["obs"].shape[0]
    batch_size = T_steps * n_envs
    mb_size = batch_size // cfg.num_minibatches

    def loss_fn(mb, adv_stats):
        mean, log_std, value = apply_actor_critic(model, mb["obs"], cfg,
                                                  cfg.compute_dtype)
        logp = networks.gaussian_log_prob(mb["raw"], mean, log_std)
        ratio = torch.exp(logp - mb["logp"])
        a_mean, a_std = adv_stats
        adv = (mb["adv"] - a_mean) / (a_std + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_clip = mb["value"] + torch.clamp(value - mb["value"], -cfg.clip_eps,
                                           cfg.clip_eps)
        v_loss = 0.5 * torch.maximum((value - mb["ret"]) ** 2,
                                     (v_clip - mb["ret"]) ** 2).mean()
        ent = networks.entropy_bonus(log_std).mean()
        total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        return total, torch.stack([pg_loss, v_loss, ent]).detach()

    def minibatch_grads(mb):
        """The minibatch gradient, whole or as the mean of equal sequential
        chunk gradients; the advantages are normalised with the whole
        minibatch's statistics either way."""
        n = mb["adv"].shape[0]
        k = _chunk_count(cfg, n, mb["adv"].device.type)
        stats = (mb["adv"].mean(), mb["adv"].std(correction=0))
        if k <= 1:
            loss, aux = loss_fn(mb, stats)
            return list(torch.autograd.grad(loss, params)), aux
        g_sum = [torch.zeros_like(p) for p in params]
        auxs = []
        for c in range(k):
            ch = {key: v[c * (n // k):(c + 1) * (n // k)] for key, v in mb.items()}
            loss, aux = loss_fn(ch, stats)
            g_sum = [s + g for s, g in zip(g_sum, torch.autograd.grad(loss, params))]
            auxs.append(aux)
        return [g / k for g in g_sum], torch.stack(auxs).mean(dim=0)

    shuffle = cfg.resolved_shuffle(n_envs)
    if cfg.num_minibatches > 1 and cfg.shuffle_minibatches is False \
            and n_envs % cfg.num_minibatches:
        warnings.warn(
            f"shuffle_minibatches=False needs num_envs ({n_envs}) divisible "
            f"by num_minibatches ({cfg.num_minibatches}); using the shuffled "
            "path", RuntimeWarning)
    shuffled = cfg.num_minibatches > 1 and (shuffle or n_envs % cfg.num_minibatches)
    nm = cfg.num_minibatches
    if shuffled:
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}
    else:
        # env-sliced minibatches, built once per update
        w = n_envs // nm
        fixed = {k: v.reshape((T_steps, nm, w) + v.shape[2:]).transpose(0, 1)
                 .reshape((nm, T_steps * w) + v.shape[2:]) for k, v in batch.items()}
    auxs = []
    for _epoch in range(cfg.update_epochs):
        if shuffled:
            perm = torch.randperm(batch_size, generator=generator,
                                  device=generator.device).to(batch["obs"].device)
            mbs = {k: v[perm][: mb_size * nm].reshape((nm, mb_size) + v.shape[1:])
                   for k, v in flat.items()}
        else:
            mbs = fixed
        for i in range(nm):
            grads, aux = minibatch_grads({k: v[i] for k, v in mbs.items()})
            if mesh is not None:
                grads = mesh.mean(grads)
            state.opt_state = opt.step(params, grads, state.opt_state)
            auxs.append(aux)
    return torch.stack(auxs).mean(dim=0)


def _action_bounds(env: Environment, env_params, device):
    """(low, high, int actions) of the env's action box on ``device``; an
    infinite high bound becomes 1e4, as the JAX package squashes to it."""
    space = env.action_space(env_params)
    high = np.where(np.isinf(space.high), 1e4, space.high)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(space.low, **f32), torch.as_tensor(high, **f32),
            bool(np.issubdtype(space.dtype, np.integer)))


def env_action_fn(env: Environment, env_params, device):
    """``to_env_action(raw)``: raw actions squashed into the env's action
    box on ``device``, cast to int32 for an integer box."""
    low, high, int_actions = _action_bounds(env, env_params, device)

    def to_env_action(raw):
        a = networks.squash_action(raw, low, high)
        return a.to(torch.int32) if int_actions else a
    return to_env_action


def _make_xla_update(env: Environment, env_params, cfg: PPOConfig, opt: Optimizer, dev,
                     mesh=None):
    """The fused policy+env update of JAX ``ppo.py:589-673``."""
    to_env_action = env_action_fn(env, env_params, dev)

    def update(state: PPOTrainState, generator: torch.Generator):
        """``rollout_steps`` periods of the policy and the envs from the
        state's envs and obs, then GAE and the SGD epochs. Where an episode
        ends mid-rollout its envs reset, and its last step bootstraps from
        the pre-reset obs (fixed-horizon truncation)."""
        n_envs = state.last_obs.shape[0]
        norm = state.rms.normalize if cfg.normalize_obs else \
            (lambda x: x.to(torch.float32))
        env_state, obs, ret_accum = state.env_state, state.last_obs, state.ret_accum
        tr = {k: [] for k in ("obs", "raw", "logp", "value", "reward", "ret_accum", "done",
                              "final_obs")}
        with torch.no_grad():
            for _ in range(cfg.rollout_steps):
                mean, log_std, value = apply_actor_critic(state.params, norm(obs), cfg)
                raw = networks.gaussian_sample(generator, mean, log_std)
                logp = networks.gaussian_log_prob(raw, mean, log_std)
                env_state, ts = vecenv.batch_step(env, env_params, env_state,
                                                  to_env_action(raw), generator)
                env_state, next_obs = vecenv.auto_reset(env, env_params, env_state, ts,
                                                        generator, n_envs)
                # VecNormalize's order (SB3): accumulate, record, then zero at
                # the episode's end, so a whole episode's discounted return
                # enters the statistics
                ret_rec = ret_accum * cfg.gamma + ts.reward
                ret_accum = ret_rec * (1.0 - ts.done.to(torch.float32))
                for k, v in (("obs", obs), ("raw", raw), ("logp", logp), ("value", value),
                             ("reward", ts.reward), ("ret_accum", ret_rec),
                             ("done", ts.done), ("final_obs", ts.obs)):
                    tr[k].append(v)
                obs = next_obs
        tr = {k: torch.stack(v) for k, v in tr.items()}
        reward_raw, done, values = tr["reward"], tr["done"], tr["value"]
        if cfg.normalize_reward:
            # scale the rewards by the running std of discounted returns
            ret_rms = state.ret_rms.update(tr["ret_accum"].reshape(-1, 1), mesh)
            scale = torch.rsqrt(ret_rms.var[0] + 1e-8)
            reward = torch.clamp(reward_raw * scale, -10.0, 10.0)
        else:
            ret_rms, reward = state.ret_rms, reward_raw

        # each step's next value: V(next obs), but V(final obs) where the
        # episode ended at that step
        T, D = cfg.rollout_steps, tr["obs"].shape[-1]
        with torch.no_grad():
            _, _, bootstrap = apply_actor_critic(state.params, norm(tr["final_obs"][-1]), cfg)
            _, _, v_final = apply_actor_critic(
                state.params, norm(tr["final_obs"].reshape(-1, D)), cfg)
        next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
        next_values = torch.where(done, v_final.reshape(values.shape), next_values)
        advs = gae_advantages(cfg, reward, done, values, next_values)

        # the batch holds the obs normalised with the pre-update statistics,
        # as JAX's loss normalises each minibatch with them
        batch = dict(obs=norm(tr["obs"].reshape(-1, D)).reshape(T, n_envs, D), raw=tr["raw"],
                     logp=tr["logp"], value=values, adv=advs, ret=advs + values)
        pg_loss, v_loss, ent = sgd_phase(cfg, opt, state, batch, n_envs, generator, mesh)
        rms = state.rms.update(tr["obs"].reshape(-1, D), mesh) if cfg.normalize_obs \
            else state.rms
        metrics = dict(mean_step_reward=_mean_over(mesh, torch.mean(reward_raw)),
                       episodes=torch.clamp_min(torch.sum(done), 1),
                       pg_loss=pg_loss, v_loss=v_loss, entropy=ent)
        new_state = PPOTrainState(
            params=state.params, opt_state=state.opt_state, rms=rms, ret_rms=ret_rms,
            ret_accum=ret_accum, env_state=env_state, last_obs=obs,
            update_idx=state.update_idx + 1)
        return new_state, metrics

    return update


def _mean_over(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the mesh's ranks (itself without a mesh)."""
    return x if mesh is None else mesh.mean([x])[0]


def make_update_fn(env: Environment, env_params, cfg: PPOConfig,
                   total_updates: int, device=None, mesh=None):
    """One PPO update ``update(state, generator) -> (state, metrics)``:
    ``cfg.rollout`` picks the fused policy+env rollout ("xla") or the
    trajectory kernel ("kernel"). With a ``mesh`` the update is one rank's
    part of the data-parallel update (the module's docstring). Raises
    ValueError for a config the path refuses, NotImplementedError for a
    family the kernels do not run."""
    dev = resolve_device(device)
    if cfg.rollout not in ("xla", "kernel"):
        raise ValueError(f"rollout must be 'xla' or 'kernel', got {cfg.rollout!r}")
    opt = Optimizer(cfg, total_updates)
    if cfg.rollout == "xla":
        if cfg.compute_dtype is not None:
            raise ValueError(
                "compute_dtype is a kernel-rollout option (the xla path computes "
                "logp_old in the rollout at f32; mixing precisions would skew the "
                "epoch-0 ratio)")
        return _make_xla_update(env, env_params, cfg, opt, dev, mesh)
    family = getattr(env, "name", None)
    if family not in ("net_inv_management", "inv_management", "newsvendor"):
        raise NotImplementedError(
            "rollout='kernel' runs the NetInvMgmt, InvManagement and Newsvendor "
            f"families; got {family!r}")
    horizon = env.horizon(env_params)
    if cfg.rollout_steps != horizon:
        raise ValueError(
            "rollout='kernel' runs episode-aligned updates: rollout_steps "
            f"({cfg.rollout_steps}) must equal the env horizon ({horizon})")

    def update_kernel(state: PPOTrainState, generator: torch.Generator):
        """One episode-aligned update off the trajectory kernel: the
        stochastic actor runs in the kernel (obs normalisation folded into
        layer 1), the dumped streams rebuild the obs batch, and logp and
        values are recomputed in one batched forward."""
        n_envs = state.last_obs.shape[0]
        T = cfg.rollout_steps
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=generator.device))
        actor = episode_kernels.fold_actor_params(
            cfg, state.params, state.rms if cfg.normalize_obs else None)
        log_std = state.params.log_std.detach()
        if family == "inv_management":
            tr = episode_kernels.rollout_traj_im(env_params, actor, log_std, seed,
                                                 n_envs, device=dev)
            obs_all = inv_management.assemble_obs_from_streams(
                env_params, tr["inv"], tr["actions"])     # (T+1, B, D) i32
        elif family == "newsvendor":
            tr = episode_kernels.rollout_traj_nv(env_params, actor, log_std, seed, n_envs,
                                                 device=dev)
            obs_all = newsvendor.assemble_obs_from_streams(
                env_params, tr["econ"], tr["orders"])     # (T+1, B, D) f32
        else:
            tr = net_step.rollout_traj_net(env_params, actor, log_std, seed, n_envs,
                                           device=dev)
            obs_all = net_inv_management.assemble_obs_from_streams(
                env_params, tr["x"], tr["u"], tr["r"])    # (T+1, B, D) f32
        raw = tr["raw"].transpose(1, 2)                   # (T, B, act_dim)
        reward_raw = tr["reward"]                         # (T, B)

        # running discounted return; episodes start fresh every update
        acc = torch.zeros((n_envs,), dtype=torch.float32, device=dev)
        ret_accs = []
        for t in range(T):
            acc = acc * cfg.gamma + reward_raw[t]
            ret_accs.append(acc)
        if cfg.normalize_reward:
            ret_rms = state.ret_rms.update(torch.stack(ret_accs).reshape(-1, 1), mesh)
            scale = torch.rsqrt(ret_rms.var[0] + 1e-8)
            reward = torch.clamp(reward_raw * scale, -10.0, 10.0)
        else:
            ret_rms = state.ret_rms
            reward = reward_raw

        D = obs_all.shape[-1]
        # statistics from the raw obs; the batch stores the obs normalised
        # once, with the pre-update statistics
        rms = state.rms.update(obs_all[:T].reshape(-1, D), mesh) if cfg.normalize_obs \
            else state.rms
        norm = state.rms.normalize if cfg.normalize_obs else \
            (lambda x: x.to(torch.float32))
        obs_n = norm(obs_all.reshape(-1, D))
        if cfg.compute_dtype is not None:
            obs_n = obs_n.to(getattr(torch, cfg.compute_dtype))

        with torch.no_grad():
            mean_all, _, value_all = apply_actor_critic(state.params, obs_n, cfg,
                                                        cfg.compute_dtype)
            mean_all = mean_all.reshape(T + 1, n_envs, -1)
            value_all = value_all.reshape(T + 1, n_envs)
            logp = networks.gaussian_log_prob(raw, mean_all[:T], log_std)
        values = value_all[:T]
        next_values = torch.cat([values[1:], value_all[T][None]], dim=0)
        done = torch.zeros((T, n_envs), dtype=torch.bool, device=dev)
        done[T - 1] = True
        advs = gae_advantages(cfg, reward, done, values, next_values)

        batch = dict(obs=obs_n.reshape(T + 1, n_envs, D)[:T], raw=raw,
                     logp=logp, value=values, adv=advs, ret=advs + values)
        pg_loss, v_loss, ent = sgd_phase(cfg, opt, state, batch, n_envs, generator, mesh)
        metrics = dict(mean_step_reward=_mean_over(mesh, torch.mean(reward_raw)),
                       episodes=n_envs,
                       pg_loss=pg_loss, v_loss=v_loss, entropy=ent)
        new_state = PPOTrainState(
            params=state.params, opt_state=state.opt_state, rms=rms,
            ret_rms=ret_rms, ret_accum=torch.zeros_like(state.ret_accum),
            env_state=state.env_state, last_obs=state.last_obs,
            update_idx=state.update_idx + 1)
        return new_state, metrics

    return update_kernel


def train(env: Environment, env_params, cfg: PPOConfig, generator: torch.Generator,
          total_timesteps: int, mesh=None, progress=None, device=None):
    """Run PPO; returns (train_state, metrics per update as a dict of numpy
    arrays with the keys mean_step_reward, episodes, pg_loss, v_loss,
    entropy, update and timesteps). ``generator`` initialises the model and
    drives every update; ``progress(metrics, state)`` is called after each
    update.

    With a ``mesh`` (``parallel.make_mesh``) every rank calls ``train`` with
    the same arguments and the same ``generator`` seed: each runs
    ``num_envs / world`` envs (asserted to divide) on the mesh's device
    unless ``device`` is given. ``train`` first forks the rank generator
    (``Mesh.rank_generator``), which resets the envs and drives the
    updates, then initialises the model from ``generator``; the returned
    state's parameters are equal on every rank and ``timesteps`` counts the
    global batch."""
    dev = training_device(device, mesh)
    total_updates = cfg.num_updates(total_timesteps)
    local = None
    if mesh is not None:
        assert cfg.num_envs % mesh.size == 0, (cfg.num_envs, mesh.size)
        local = cfg.num_envs // mesh.size
        generator, model_generator = mesh.rank_generator(generator), generator
    else:
        model_generator = generator
    update = make_update_fn(env, env_params, cfg, total_updates, device=dev, mesh=mesh)
    state = init_train_state(env, env_params, cfg, model_generator, total_updates,
                             device=dev, local_envs=local, env_generator=generator)
    metrics_log = []
    for i in range(total_updates):
        state, metrics = update(state, generator)
        m = {k: float(v) for k, v in metrics.items()}
        m["update"] = i + 1
        m["timesteps"] = (i + 1) * cfg.num_envs * cfg.rollout_steps
        metrics_log.append(m)
        if progress is not None:
            progress(m, state)
    stacked = {k: np.array([m[k] for m in metrics_log]) for k in metrics_log[0]}
    return state, stacked


def make_eval_policy(env: Environment, env_params, cfg: PPOConfig,
                     deterministic: bool = True):
    """``policy_fn(policy_state=(model, rms), obs, generator, t)`` for the
    vecenv rollouts: the squashed mean, or with ``deterministic=False`` a
    squashed Gaussian sample."""
    @torch.no_grad()
    def policy(policy_state, obs, generator, _t):
        model, rms = policy_state
        norm_obs = rms.normalize(obs) if (cfg.normalize_obs and rms is not None) \
            else obs.to(torch.float32)
        mean, log_std, _ = model(norm_obs)
        raw = mean if deterministic else networks.gaussian_sample(generator, mean,
                                                                  log_std)
        return env_action_fn(env, env_params, obs.device)(raw)
    return policy



# ======================================================== host agent wrapper

class PPOAgent(BaseAgent):
    """The ``BaseAgent``-protocol wrapper over the PPO learner (JAX
    ``ppo.py:790-965``), with SB3AgentWrapper's ergonomics
    (benchmark_InvManagementBacklogEnv.py:201-342): the checkpoint shortcut
    unless ``force_retrain``, ``save``/``load``, the training log for
    learning curves, deterministic evaluation actions.

    ``eval_every_updates`` > 0 is the EvalCallback analogue: every so many
    updates a deterministic ``vecenv.evaluate_episodes`` of
    ``eval_episodes`` envs, the best parameters kept and restored after
    training (benchmark_InvManagementBacklogEnv.py:275-281, 303-311).
    ``device`` is where training runs (None: the card, or the mesh's
    device); ``get_action`` answers from a CPU copy of the policy, since one
    observation at a time is bound by latency. With a ``mesh`` every rank
    constructs and trains the agent alike: rank 0 alone writes the
    checkpoint, its ``.meta.json`` and the training log while the others
    wait at a barrier, and rank 0's checkpoint decides the skip-retrain
    shortcut on every rank."""

    def __init__(self, env: Environment, params_factory, name: str = "PPO",
                 config: Optional[PPOConfig] = None, model_dir: str = "./models",
                 log_dir: str = "./logs", force_retrain: bool = False, mesh=None,
                 seed: int = 0, eval_every_updates: int = 0, eval_episodes: int = 64,
                 device=None):
        super().__init__(name=name)
        self.env = env
        self.params_factory = params_factory
        self.config = config or PPOConfig()
        self.model_dir, self.log_dir = model_dir, log_dir
        self.force_retrain = force_retrain
        self.mesh = mesh
        self.seed = seed
        self.eval_every_updates = eval_every_updates
        self.eval_episodes = eval_episodes
        self.device = device
        self.env_params = None
        self.train_state = None
        self.training_log = None
        self.trained_timesteps = 0
        self._eval = None

    # -- persistence -----------------------------------------------------
    def _ckpt_path(self, prefix: str = "") -> str:
        return os.path.join(self.model_dir, f"{prefix}{self.name}.pt")

    def save(self, path: Optional[str] = None) -> str:
        """The parameters and the obs statistics to ``path`` (the agent's
        checkpoint by default), with the trained budget beside it."""
        path = path or self._ckpt_path()
        rms = self.train_state.rms
        checkpoint.save_pytree(path, {
            "params": checkpoint.to_tree(self.train_state.params),
            "rms": {"mean": rms.mean, "var": rms.var, "count": rms.count}})
        write_ckpt_meta(path, self.trained_timesteps)
        return path

    def _template_state(self, dev):
        """A fresh train state of one env on ``dev``, whose model a
        checkpoint's parameters fill."""
        return init_train_state(self.env, self.env_params, self.config.replace(num_envs=1),
                                torch.Generator(device=dev).manual_seed(self.seed), 1,
                                device=dev)

    def load(self, path: str):
        """A train state of one env holding the checkpoint's parameters and
        obs statistics, on the agent's device."""
        dev = training_device(self.device, self.mesh)
        payload = checkpoint.load_pytree(path, map_location=dev)
        if self.env_params is None:
            self.env_params = self.params_factory()
        state = self._template_state(dev)
        state.params.load_state_dict(payload["params"])
        self.train_state = dataclasses.replace(state, rms=RunningMeanStd(**payload["rms"]))
        self.trained_timesteps = ckpt_trained_timesteps(path)
        self._eval = None

    # -- training --------------------------------------------------------
    def _fit(self, total_timesteps: int, dev):
        """(train state, metrics) of a training run on ``dev``, with the
        EvalCallback analogue's best parameters restored."""
        best = {"reward": -np.inf, "params": None, "rms": None}
        progress = None
        if self.eval_every_updates > 0:
            eval_pol = make_eval_policy(self.env, self.env_params, self.config)

            def progress(m, st):
                if m["update"] % self.eval_every_updates:
                    return
                totals, _ = vecenv.evaluate_episodes(
                    self.env, self.env_params, eval_pol, (st.params, st.rms),
                    torch.Generator(device=dev).manual_seed(self.seed + 1),
                    self.eval_episodes, device=dev)
                mean = float(totals.double().mean())
                if mean > best["reward"]:
                    best.update(reward=mean, params=copy.deepcopy(st.params), rms=st.rms)

        state, metrics = train(self.env, self.env_params, self.config,
                               torch.Generator(device=dev).manual_seed(self.seed),
                               total_timesteps, mesh=self.mesh, progress=progress, device=dev)
        if best["params"] is not None:
            print(f"Loading best model (eval reward {best['reward']:.2f})")
            state = dataclasses.replace(state, params=best["params"], rms=best["rms"])
        return state, metrics

    def train(self, env_config: dict, total_timesteps: int, save_path_prefix: str = ""):
        self.env_params = self.params_factory(env_config=env_config or None)
        ckpt = self._ckpt_path(save_path_prefix)
        trained = None if self.force_retrain else checkpoint_budget(ckpt, self.mesh)
        if trained is not None:
            if trained >= total_timesteps:
                print(f"Loading existing model for {self.name} from {ckpt} "
                      f"(trained {trained} >= {total_timesteps})")
                self.load(ckpt)
                self.training_time = 0.0
                return
            print(f"Checkpoint {ckpt} trained only {trained} < {total_timesteps} steps; "
                  "retraining")
        print(f"Training {self.name} for {total_timesteps} steps...")
        start = time.time()
        state, metrics = self._fit(total_timesteps, training_device(self.device, self.mesh))
        self.train_state = state
        self._eval = None
        self.training_log = metrics
        self.training_time = time.time() - start
        self.trained_timesteps = total_timesteps
        if writes_files(self.mesh):
            self._write(ckpt, metrics)
        if self.mesh is not None:
            self.mesh.barrier()
        print(f"Training for {self.name} finished in {self.training_time:.2f}s "
              f"({total_timesteps / max(self.training_time, 1e-9):,.0f} trained-steps/s)")

    def _write(self, ckpt: str, metrics: dict):
        """The checkpoint and the training log."""
        self.save(ckpt)
        if metrics:
            os.makedirs(self.log_dir, exist_ok=True)
            log_path = os.path.join(self.log_dir, f"{self.name}_train_log.csv")
            with open(log_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(metrics.keys()))
                w.writeheader()
                for i in range(len(metrics["update"])):
                    w.writerow({k: metrics[k][i] for k in metrics})

    # -- evaluation ------------------------------------------------------
    def _eval_policy(self):
        """The deterministic policy and a CPU copy of the parameters and
        statistics it reads (a round trip to the card a step would cost
        more than the step)."""
        if self._eval is None:
            rms = self.train_state.rms
            cpu_rms = RunningMeanStd(mean=rms.mean.cpu(), var=rms.var.cpu(),
                                     count=rms.count.cpu())
            self._eval = (make_eval_policy(self.env, self.env_params, self.config),
                          (copy.deepcopy(self.train_state.params).cpu(), cpu_rms),
                          torch.Generator().manual_seed(0))
        return self._eval

    def get_action(self, observation, env):
        if self.train_state is None:
            return env.action_space.sample().astype(env.action_space.dtype)
        policy, ps, generator = self._eval_policy()
        obs = torch.as_tensor(np.asarray(observation, np.float32))[None]
        return np.asarray(policy(ps, obs, generator, 0)[0]).astype(env.action_space.dtype)

    def device_policy(self, env, params):
        policy = make_eval_policy(self.env, self.env_params or params, self.config)
        ps = (self.train_state.params, self.train_state.rms)
        return lambda _s, obs, generator, t: policy(ps, obs, generator, t)
