"""PPO trained through the trajectory kernels.

Port of ``or_gym_inventory_tpu/agents/ppo.py:46-785``, the
``rollout="kernel"`` path without a mesh, on NetInvMgmt and InvManagement:
each update runs one stochastic-policy episode per env in the family's
trajectory kernel (``ops.net_step.rollout_traj_net``, K4, or
``ops.episode_kernels.rollout_traj_im``, K10), rebuilds the observation
batch from the dumped streams, recomputes logp and values in one forward
pass, and runs epochs of minibatched clipped-surrogate SGD. The SGD phase
is plain PyTorch (``nn`` layers, autograd, matmuls), as the JAX package left
it to XLA.

Where the port differs in form:

- ``PPOTrainState.params`` is an ``MLPActorCritic``; an update changes its
  parameters and the optimizer state in place (JAX returned new trees).
- ``jax.random`` keys become one ``torch.Generator``: it draws the
  kernel seed of every update and the minibatch permutations.
- ``rollout="xla"`` (the fused policy+env rollout), ``PPOAgent``,
  checkpoints and the mesh are still to port (ROADMAP.md A6b, A14); they
  raise NotImplementedError.
- The JAX package's ``num_envs % 1024`` check was a TPU tile constraint;
  the CUDA kernels mask the batch tail, so any ``num_envs`` works.
- ``updates_per_call`` chunked updates into one device program; here every
  update is one Python call, and the metrics log keeps its keys.
- ``minibatch_chunks=0`` picks chunks of at most 32,768 samples, the JAX
  package's TPU-measured value, except on a CUDA device, where it keeps each
  minibatch whole (``_chunk_count``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from or_gym_inventory_torch.agents import networks
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import inv_management, net_inv_management
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.ops import episode_kernels, net_step
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

    def update(self, batch: torch.Tensor) -> "RunningMeanStd":
        """Welford batch update over every row of ``batch`` (..., dim)."""
        x = batch.reshape(-1, batch.shape[-1]).to(torch.float32)
        n = torch.tensor(float(x.shape[0]), dtype=torch.float32, device=x.device)
        b_mean = torch.sum(x, dim=0) / n
        b_var = torch.clamp_min(torch.sum(x * x, dim=0) / n - b_mean ** 2, 0.0)
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
      optax's default)."""

    def __init__(self, cfg: PPOConfig, total_updates: int):
        self.cfg = cfg
        self.steps = max(1, total_updates * cfg.update_epochs * cfg.num_minibatches)

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
            updates = [(m / bc1) / (torch.sqrt(n / bc2) + 1e-5)
                       for m, n in zip(mu, nu)]
        step_size = -self._lr(state.count)
        for p, u in zip(params, updates):
            p.add_(step_size * u)
        return OptState(count=count, mu=mu, nu=nu)


# ------------------------------------------------------------ train state

def init_train_state(env: Environment, env_params, cfg: PPOConfig,
                     generator: torch.Generator, total_updates: int,
                     device=None) -> PPOTrainState:
    """A fresh model initialised from ``generator``, a fresh optimizer
    state, unit running statistics and ``num_envs`` reset envs on
    ``device``."""
    dev = resolve_device(device)
    model = _make_model(env, env_params, cfg, generator).to(dev)
    obs_dim = int(env.observation_space(env_params).shape[0])
    n = cfg.num_envs
    opt_state = Optimizer(cfg, total_updates).init(list(model.parameters()))
    env_state, ts0 = vecenv.batch_reset(env, env_params, generator, n, device=dev)
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
              n_envs: int, generator: torch.Generator):
    """Epochs of minibatched clipped-surrogate SGD over a time-major batch
    dict (T, n_envs, ...) with keys obs/raw/logp/value/adv/ret, the obs
    normalised already (the kernel path stores them once per update). The
    forward is ``apply_actor_critic`` at ``cfg.compute_dtype``. Updates
    ``state.params`` and ``state.opt_state`` in place; returns the
    (pg_loss, v_loss, entropy) means over every minibatch."""
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
            state.opt_state = opt.step(params, grads, state.opt_state)
            auxs.append(aux)
    return torch.stack(auxs).mean(dim=0)


def make_update_fn(env: Environment, env_params, cfg: PPOConfig,
                   total_updates: int, device=None):
    """One PPO update ``update(state, generator) -> (state, metrics)`` on the
    kernel path. Raises NotImplementedError for what is still to port."""
    dev = resolve_device(device)
    if cfg.rollout not in ("xla", "kernel"):
        raise ValueError(f"rollout must be 'xla' or 'kernel', got {cfg.rollout!r}")
    if cfg.rollout == "xla":
        raise NotImplementedError(
            "rollout='xla' (the fused policy+env rollout) is still to port "
            "(ROADMAP.md A6b); use rollout='kernel'")
    family = getattr(env, "name", None)
    if family not in ("net_inv_management", "inv_management"):
        raise NotImplementedError(
            "rollout='kernel' runs the NetInvMgmt and InvManagement families "
            f"in the port; got {family!r} (Newsvendor: ROADMAP.md A7b, kernel B14)")
    horizon = env.horizon(env_params)
    if cfg.rollout_steps != horizon:
        raise ValueError(
            "rollout='kernel' runs episode-aligned updates: rollout_steps "
            f"({cfg.rollout_steps}) must equal the env horizon ({horizon})")
    opt = Optimizer(cfg, total_updates)

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
            ret_rms = state.ret_rms.update(torch.stack(ret_accs).reshape(-1, 1))
            scale = torch.rsqrt(ret_rms.var[0] + 1e-8)
            reward = torch.clamp(reward_raw * scale, -10.0, 10.0)
        else:
            ret_rms = state.ret_rms
            reward = reward_raw

        D = obs_all.shape[-1]
        # statistics from the raw obs; the batch stores the obs normalised
        # once, with the pre-update statistics
        rms = state.rms.update(obs_all[:T].reshape(-1, D)) if cfg.normalize_obs \
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
        pg_loss, v_loss, ent = sgd_phase(cfg, opt, state, batch, n_envs, generator)
        metrics = dict(mean_step_reward=torch.mean(reward_raw), episodes=n_envs,
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
    update. A ``mesh`` raises NotImplementedError (ROADMAP.md A14)."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over a mesh is still to port "
            "(ROADMAP.md A14, torch.distributed)")
    dev = resolve_device(device)
    total_updates = cfg.num_updates(total_timesteps)
    update = make_update_fn(env, env_params, cfg, total_updates, device=dev)
    state = init_train_state(env, env_params, cfg, generator, total_updates,
                             device=dev)
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
    space = env.action_space(env_params)
    int_actions = np.issubdtype(space.dtype, np.integer)
    high_np = np.where(np.isinf(space.high), 1e4, space.high)

    @torch.no_grad()
    def policy(policy_state, obs, generator, _t):
        model, rms = policy_state
        low = torch.as_tensor(space.low, dtype=torch.float32, device=obs.device)
        high = torch.as_tensor(high_np, dtype=torch.float32, device=obs.device)
        norm_obs = rms.normalize(obs) if (cfg.normalize_obs and rms is not None) \
            else obs.to(torch.float32)
        mean, log_std, _ = model(norm_obs)
        raw = mean if deterministic else networks.gaussian_sample(generator, mean,
                                                                  log_std)
        a = networks.squash_action(raw, low, high)
        return a.to(torch.int32) if int_actions else a
    return policy

