"""Recurrent PPO (LSTM actor-critic) trained through the LSTM trajectory
kernel.

Port of ``or_gym_inventory_tpu/agents/recurrent_ppo.py:31-380, 594-608``,
the ``rollout="kernel"`` path without a mesh, on InvManagement: each update
runs one stochastic LSTM-policy episode per env in the trajectory kernel
(``ops.episode_kernels.rollout_traj_im_lstm``, K24), rebuilds the
observation batch from the dumped streams, recomputes logp and values with
the carry threaded over the episode (zero carry, ``done_in[0]`` set), and
runs epochs of clipped-surrogate SGD over minibatches that are slices of the
env axis, so that every sequence stays whole and is re-run from its start.
The value loss is unclipped, as the JAX package's recurrent loss is. The SGD
phase is plain PyTorch, as the JAX package left it to XLA; it reuses
``ppo.Optimizer``, ``ppo.RunningMeanStd`` and ``ppo.gae_advantages``.

Where the port differs in form, as ``agents/ppo.py`` does:

- ``RPPOTrainState.params`` is an ``LSTMActorCritic`` that each update
  changes in place; one ``torch.Generator`` replaces the JAX key chain
  (kernel seeds and env permutations).
- ``rollout="xla"`` (the fused policy+env rollout, the only path of the
  NetInvMgmt and Newsvendor families), the mesh, ``RecurrentPPOAgent`` and
  ``A2CLSTMAgent`` are still to port (ROADMAP.md A6b, A14); they raise
  NotImplementedError.
- The JAX package's ``num_envs % 1024`` check was a TPU tile constraint;
  the CUDA kernel masks the batch tail, so any ``num_envs`` works.
- ``updates_per_call`` chunked updates into one device program; here every
  update is one Python call, and the metrics log keeps its keys.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from or_gym_inventory_torch.agents import networks
from or_gym_inventory_torch.agents.ppo import (Optimizer, OptState, PPOConfig,
                                               RunningMeanStd, gae_advantages)
from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs import inv_management
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.ops import episode_kernels
from or_gym_inventory_torch.vector import vecenv


@dataclasses.dataclass(frozen=True)
class RecurrentPPOConfig(PPOConfig):
    """PPOConfig with the LSTM's widths: ``hidden`` units and the tanh
    ``encoder`` before the cell (the JAX RecurrentPPOConfig)."""
    hidden: int = 128
    encoder: Tuple[int, ...] = (64,)


@dataclasses.dataclass
class RPPOTrainState:
    params: networks.LSTMActorCritic
    opt_state: OptState
    rms: RunningMeanStd
    ret_rms: RunningMeanStd
    ret_accum: torch.Tensor   # (num_envs,) discounted return accumulator
    env_state: object
    last_obs: torch.Tensor
    last_done: torch.Tensor
    carry: Tuple[torch.Tensor, torch.Tensor]
    update_idx: int


def _make_model(env: Environment, env_params, cfg: RecurrentPPOConfig,
                generator: torch.Generator = None) -> networks.LSTMActorCritic:
    """The recurrent actor-critic for ``env``, initialised from
    ``generator`` on the generator's device."""
    obs_dim = int(env.observation_space(env_params).shape[0])
    act_dim = int(np.prod(env.action_space(env_params).shape))
    with torch.device(generator.device if generator is not None else "cpu"):
        return networks.LSTMActorCritic(obs_dim, act_dim, hidden=cfg.hidden,
                                        encoder=cfg.encoder, activation=cfg.activation,
                                        generator=generator)


def env_slices(n_envs: int, num_minibatches: int, generator: torch.Generator):
    """One epoch's minibatches: a permutation of the env indices cut into
    ``num_minibatches`` equal slices, so that each minibatch holds whole
    sequences (recurrent_ppo.py:139-149)."""
    if n_envs % num_minibatches:
        raise ValueError(f"num_envs ({n_envs}) must divide into num_minibatches "
                         f"({num_minibatches}): minibatches are slices of whole envs")
    perm = torch.randperm(n_envs, generator=generator, device=generator.device)
    return perm.reshape(num_minibatches, n_envs // num_minibatches)


def sgd_epochs(cfg: RecurrentPPOConfig, opt: Optimizer, state: RPPOTrainState, batch: dict,
               norm, generator: torch.Generator):
    """Epochs of env-sliced minibatch SGD over a time-major batch dict
    (T, n_envs, ...) with keys obs/done_in/raw/logp/adv/ret, the LSTM re-run
    from a zero carry over each slice's whole sequence (recurrent_ppo.py
    :111-164). The value loss is unclipped. Updates ``state.params`` and
    ``state.opt_state`` in place; returns the (pg_loss, v_loss, entropy)
    means over every minibatch."""
    model = state.params
    params = list(model.parameters())
    n_envs = batch["obs"].shape[1]

    def loss_fn(mb):
        carry = model.initial_carry(mb["obs"].shape[1], device=mb["obs"].device)
        _, (mean, log_std, value) = model.forward_sequence(carry, norm(mb["obs"]),
                                                           mb["done_in"])
        logp = networks.gaussian_log_prob(mb["raw"], mean, log_std)
        ratio = torch.exp(logp - mb["logp"])
        adv = (mb["adv"] - mb["adv"].mean()) / (mb["adv"].std(correction=0) + 1e-8)
        pg = -torch.minimum(ratio * adv,
                            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
        v_loss = 0.5 * ((value - mb["ret"]) ** 2).mean()
        ent = networks.entropy_bonus(log_std).mean()
        total = pg + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        return total, torch.stack([pg, v_loss, ent]).detach()

    auxs = []
    for _epoch in range(cfg.update_epochs):
        for idx in env_slices(n_envs, cfg.num_minibatches, generator):
            idx = idx.to(batch["obs"].device)
            loss, aux = loss_fn({k: v[:, idx] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, params)
            state.opt_state = opt.step(params, grads, state.opt_state)
            auxs.append(aux)
    return torch.stack(auxs).mean(dim=0)


def make_train_fns(env: Environment, env_params, cfg: RecurrentPPOConfig,
                   total_updates: int, device=None):
    """``(init, update, eval_episodes)`` of the kernel path:
    ``init(generator) -> state``, ``update(state, generator) -> (state,
    metrics)`` and ``eval_episodes(params, rms, generator, num_envs)``, the
    deterministic carry-threading evaluator. Raises NotImplementedError for
    what is still to port."""
    dev = resolve_device(device)
    if cfg.rollout not in ("xla", "kernel"):
        raise ValueError(f"rollout must be 'xla' or 'kernel', got {cfg.rollout!r}")
    if cfg.rollout == "xla":
        raise NotImplementedError(
            "rollout='xla' (the fused policy+env rollout) is still to port "
            "(ROADMAP.md A6b); use rollout='kernel' on InvManagement")
    if getattr(env, "name", None) != "inv_management":
        raise NotImplementedError(
            "RecurrentPPO rollout='kernel' supports the InvManagement family (the LSTM "
            "trajectory kernel, ops.episode_kernels.rollout_traj_im_lstm); got "
            f"{getattr(env, 'name', None)!r}")
    horizon = env.horizon(env_params)
    if cfg.rollout_steps != horizon:
        raise ValueError(
            "rollout='kernel' runs episode-aligned updates: rollout_steps "
            f"({cfg.rollout_steps}) must equal the env horizon ({horizon})")
    space = env.action_space(env_params)
    int_actions = np.issubdtype(space.dtype, np.integer)
    high_np = np.where(np.isinf(space.high), 1e4, space.high)
    obs_dim = int(env.observation_space(env_params).shape[0])
    opt = Optimizer(cfg, total_updates)

    def norm_of(rms):
        return rms.normalize if cfg.normalize_obs else (lambda x: x.to(torch.float32))

    def init(generator: torch.Generator) -> RPPOTrainState:
        model = _make_model(env, env_params, cfg, generator).to(dev)
        n = cfg.num_envs
        env_state, ts0 = vecenv.batch_reset(env, env_params, generator, n, device=dev)
        return RPPOTrainState(
            params=model, opt_state=opt.init(list(model.parameters())),
            rms=RunningMeanStd.create(obs_dim, dev), ret_rms=RunningMeanStd.create(1, dev),
            ret_accum=torch.zeros((n,), dtype=torch.float32, device=dev),
            env_state=env_state, last_obs=ts0.obs,
            last_done=torch.zeros((n,), dtype=torch.bool, device=dev),
            carry=model.initial_carry(n, device=dev), update_idx=0)

    def update_kernel(state: RPPOTrainState, generator: torch.Generator):
        """One episode-aligned update off the LSTM trajectory kernel
        (recurrent_ppo.py:259-348): the stochastic LSTM actor runs in the
        kernel (obs normalisation folded into the encoder), the dumped
        streams rebuild the obs batch, and logp and values come from the
        same carry-threaded re-forward the SGD epochs run, so logp_old and
        logp_new agree by construction."""
        model = state.params
        n_envs = state.last_obs.shape[0]
        T = cfg.rollout_steps
        norm = norm_of(state.rms)
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=generator.device))
        actor = episode_kernels.fold_lstm_actor(cfg, model,
                                                state.rms if cfg.normalize_obs else None)
        tr = episode_kernels.rollout_traj_im_lstm(env_params, actor, model.log_std.detach(),
                                                  seed, n_envs, device=dev)
        obs_all = inv_management.assemble_obs_from_streams(
            env_params, tr["inv"], tr["actions"])          # (T+1, B, D) i32
        raw = tr["raw"].transpose(1, 2)                    # (T, B, act_dim)
        reward_raw = tr["reward"]                          # (T, B)

        # running discounted return; the full-episode return enters ret_rms
        acc = torch.zeros((n_envs,), dtype=torch.float32, device=dev)
        ret_accs = []
        for t in range(T):
            acc = acc * cfg.gamma + reward_raw[t]
            ret_accs.append(acc)
        if cfg.normalize_reward:
            ret_rms = state.ret_rms.update(torch.stack(ret_accs).reshape(-1, 1))
            reward = torch.clamp(reward_raw * torch.rsqrt(ret_rms.var[0] + 1e-8), -10.0, 10.0)
        else:
            ret_rms, reward = state.ret_rms, reward_raw

        obs_seq = obs_all[:T]
        done_in = torch.zeros((T, n_envs), dtype=torch.bool, device=dev)
        done_in[0] = True
        with torch.no_grad():
            carry = model.initial_carry(n_envs, device=dev)
            carry, (mean, log_std, values) = model.forward_sequence(carry, norm(obs_seq),
                                                                    done_in)
            logp = networks.gaussian_log_prob(raw, mean, log_std)
            # the truncation bootstrap on the final obs with done=True (a
            # fresh carry), the XLA path's convention
            _, (_, _, bootstrap) = model(carry, norm(obs_all[T]),
                                         torch.ones((n_envs,), dtype=torch.bool, device=dev))
        done = torch.zeros((T, n_envs), dtype=torch.bool, device=dev)
        done[T - 1] = True
        next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
        advs = gae_advantages(cfg, reward, done, values, next_values)

        batch = dict(obs=obs_seq, done_in=done_in, raw=raw, logp=logp, adv=advs,
                     ret=advs + values)
        pg_loss, v_loss, ent = sgd_epochs(cfg, opt, state, batch, norm, generator)
        rms = state.rms.update(obs_seq.reshape(-1, obs_dim)) if cfg.normalize_obs \
            else state.rms
        metrics = dict(mean_step_reward=torch.mean(reward_raw), pg_loss=pg_loss,
                       v_loss=v_loss, entropy=ent)
        new_state = dataclasses.replace(state, rms=rms, ret_rms=ret_rms,
                                        ret_accum=torch.zeros_like(state.ret_accum),
                                        update_idx=state.update_idx + 1)
        return new_state, metrics

    @torch.no_grad()
    def eval_episodes(params: networks.LSTMActorCritic, rms: RunningMeanStd,
                      generator: torch.Generator, num_envs: int) -> torch.Tensor:
        """Deterministic full-horizon episodes on ``vecenv`` with the carry
        threaded (recurrent_ppo.py:356-377): the squashed mean each step.
        Returns the (num_envs,) summed rewards."""
        env_state, ts = vecenv.batch_reset(env, env_params, generator, num_envs, device=dev)
        low = torch.as_tensor(space.low, dtype=torch.float32, device=dev)
        high = torch.as_tensor(high_np, dtype=torch.float32, device=dev)
        normf = norm_of(rms)
        carry = params.initial_carry(num_envs, device=dev)
        obs, done = ts.obs, torch.zeros((num_envs,), dtype=torch.bool, device=dev)
        total = torch.zeros((num_envs,), dtype=torch.float32, device=dev)
        for _ in range(horizon):
            carry, (mean, _, _) = params(carry, normf(obs), done)
            a = networks.squash_action(mean, low, high)
            env_state, ts = vecenv.batch_step(env, env_params, env_state,
                                              a.to(torch.int32) if int_actions else a,
                                              generator)
            obs, done = ts.obs, ts.done
            total = total + ts.reward
        return total

    return init, update_kernel, eval_episodes


def train(env: Environment, env_params, cfg: RecurrentPPOConfig, generator: torch.Generator,
          total_timesteps: int, progress=None, mesh=None, device=None):
    """Run recurrent PPO; returns (train_state, eval_episodes, metrics per
    update as a dict of numpy arrays with the keys mean_step_reward,
    pg_loss, v_loss, entropy, update and timesteps). ``generator``
    initialises the model and drives every update; ``progress(metrics,
    state)`` is called after each update. A ``mesh`` raises
    NotImplementedError (ROADMAP.md A14)."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel training over a mesh is still to port "
            "(ROADMAP.md A14, torch.distributed)")
    total_updates = cfg.num_updates(total_timesteps)
    init, update, eval_episodes = make_train_fns(env, env_params, cfg, total_updates,
                                                 device=device)
    state = init(generator)
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
    return state, eval_episodes, stacked


def A2CLSTMConfig(num_envs: int = 256, rollout_steps: int = 8, lr: float = 7e-4,
                  gamma: float = 0.99, gae_lambda: float = 1.0, hidden: int = 128,
                  encoder: Tuple[int, ...] = (64,), **kw) -> RecurrentPPOConfig:
    """SB3-A2C-shaped defaults on the recurrent machinery, the reference's
    A2C_LSTM roster entry: one epoch, one full-batch minibatch, an
    effectively unclipped ratio, RMSprop and no LR anneal
    (recurrent_ppo.py:594-608)."""
    return RecurrentPPOConfig(
        num_envs=num_envs, rollout_steps=rollout_steps, lr=lr, gamma=gamma,
        gae_lambda=gae_lambda, clip_eps=10.0, update_epochs=1, num_minibatches=1,
        ent_coef=0.0, vf_coef=0.5, max_grad_norm=0.5, anneal_lr=False, optimizer="rmsprop",
        hidden=hidden, encoder=encoder, **kw)


class RecurrentPPOAgent:
    """The host wrapper of the JAX package (BaseAgent protocol, checkpoints,
    ``get_action`` with a carried state): still to port with the recurrent
    ``rollout="xla"`` update, on ``ppo.PPOAgent``'s pattern (ROADMAP.md
    A6b)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is still to port with the recurrent rollout='xla' "
            "update (ROADMAP.md A6b); use recurrent_ppo.train")


class A2CLSTMAgent(RecurrentPPOAgent):
    """A2C_LSTM's host wrapper; see ``RecurrentPPOAgent``."""
