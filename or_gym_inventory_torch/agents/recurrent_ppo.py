"""Recurrent PPO (LSTM actor-critic): the fused policy+env update and the
LSTM trajectory-kernel update, with ``RecurrentPPOAgent`` and
``A2CLSTMAgent``.

Port of ``or_gym_inventory_tpu/agents/recurrent_ppo.py``, on one device or
data-parallel over a ``parallel.Mesh``. Two ways to make an update's
experience:

- ``rollout="xla"`` (the default; JAX :186-256), on all three families:
  ``rollout_steps`` periods of the LSTM policy and ``vecenv.batch_step`` /
  ``vecenv.auto_reset`` in a Python loop, the carry threaded across steps
  and updates and zeroed where an episode ended (each step's ``done_in`` is
  the previous step's ``done``). Advantages bootstrap from the
  post-rollout carry on the last obs; each step's next value is the next
  step's value, with no final-obs correction at a done step, as the JAX
  package's recurrent GAE has it. Plain PyTorch, as the JAX package left
  it to XLA: no kernel runs on this path.
- ``rollout="kernel"`` (JAX :259-348), on InvManagement: each update runs
  one stochastic LSTM-policy episode per env in the trajectory kernel
  (``ops.episode_kernels.rollout_traj_im_lstm``, K24), rebuilds the
  observation batch from the dumped streams and recomputes logp and values
  with the carry threaded over the episode (zero carry, ``done_in[0]``
  set).

Both run epochs of clipped-surrogate SGD over minibatches that are slices
of the env axis, so that every sequence stays whole and is re-run from the
update's initial carry, sliced with the envs (``sgd_epochs``). The value
loss is unclipped, as the JAX package's recurrent loss is. The SGD phase
reuses ``ppo.Optimizer``, ``ppo.RunningMeanStd`` and
``ppo.gae_advantages``.

Where the port differs in form, as ``agents/ppo.py`` does:

- ``RPPOTrainState.params`` is an ``LSTMActorCritic`` that each update
  changes in place; one ``torch.Generator`` replaces the JAX key chain
  (the policy's noise, the envs' draws, kernel seeds and env
  permutations).
- With ``mesh=`` (JAX :383-440) the envs, their LSTM carries and
  ``last_done`` are each rank's own (``num_envs / world`` envs, which must
  divide into the minibatches), the parameters are replicated, the
  minibatch gradients and the running statistics' sums are reduced over the
  ranks and ``mean_step_reward`` is averaged, as in ``agents/ppo.py``; the
  rank generator that ``train`` forks drives each rank's draws.
- The JAX package's ``num_envs % 1024`` check was a TPU tile constraint;
  the CUDA kernel masks the batch tail, so any ``num_envs`` works.
- ``updates_per_call`` chunked updates into one device program; here every
  update is one Python call, and the metrics log keeps its keys.
- Checkpoints are ``ppo.PPOAgent``'s ``.pt`` files.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from or_gym_inventory_torch.agents import networks
from or_gym_inventory_torch.agents.base import training_device
from or_gym_inventory_torch.agents.ppo import (Optimizer, OptState, PPOAgent, PPOConfig,
                                               RunningMeanStd, _mean_over, env_action_fn,
                                               gae_advantages)
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
               norm, generator: torch.Generator, init_carry=None, mesh=None):
    """Epochs of env-sliced minibatch SGD over a time-major batch dict
    (T, n_envs, ...) with keys obs/done_in/raw/logp/adv/ret, the LSTM re-run
    over each slice's whole sequence from ``init_carry`` (the update's
    initial (c, h), each (n_envs, hidden)) sliced with the slice's envs, or
    from a zero carry when it is None (recurrent_ppo.py:111-164). ``norm``
    normalises the raw obs of a minibatch. The value loss is unclipped; with
    a ``mesh`` each minibatch gradient is averaged over the ranks.
    Updates ``state.params`` and ``state.opt_state`` in place; returns the
    (pg_loss, v_loss, entropy) means over every minibatch."""
    model = state.params
    params = list(model.parameters())
    n_envs = batch["obs"].shape[1]
    if init_carry is None:
        init_carry = model.initial_carry(n_envs, device=batch["obs"].device)

    def loss_fn(mb, carry):
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
            loss, aux = loss_fn({k: v[:, idx] for k, v in batch.items()},
                                tuple(c[idx] for c in init_carry))
            grads = torch.autograd.grad(loss, params)
            if mesh is not None:
                grads = mesh.mean(grads)
            state.opt_state = opt.step(params, grads, state.opt_state)
            auxs.append(aux)
    return torch.stack(auxs).mean(dim=0)


def make_train_fns(env: Environment, env_params, cfg: RecurrentPPOConfig,
                   total_updates: int, device=None, mesh=None,
                   local_envs: Optional[int] = None):
    """``(init, update, eval_episodes)``: ``init(generator, env_generator=None)
    -> state`` (the model from ``generator``, ``local_envs`` or ``num_envs``
    envs reset from ``env_generator``, by default ``generator``),
    ``update(state, generator) -> (state, metrics)`` of ``cfg.rollout``'s
    path and ``eval_episodes(params, rms, generator, num_envs)``, the
    deterministic carry-threading evaluator. With a ``mesh`` the update is
    one rank's part of the data-parallel update. The kernel path refuses a
    family other than InvManagement (NotImplementedError) and a
    ``rollout_steps`` other than the horizon (ValueError), as JAX :80-99
    does; its actor fold refuses a trunk other than tanh."""
    dev = resolve_device(device)
    if cfg.rollout not in ("xla", "kernel"):
        raise ValueError(f"rollout must be 'xla' or 'kernel', got {cfg.rollout!r}")
    horizon = env.horizon(env_params)
    if cfg.rollout == "kernel":
        if getattr(env, "name", None) != "inv_management":
            raise NotImplementedError(
                "RecurrentPPO rollout='kernel' supports the InvManagement family (the LSTM "
                "trajectory kernel, ops.episode_kernels.rollout_traj_im_lstm); got "
                f"{getattr(env, 'name', None)!r}")
        if cfg.rollout_steps != horizon:
            raise ValueError(
                "rollout='kernel' runs episode-aligned updates: rollout_steps "
                f"({cfg.rollout_steps}) must equal the env horizon ({horizon})")
    to_env_action = env_action_fn(env, env_params, dev)
    obs_dim = int(env.observation_space(env_params).shape[0])
    opt = Optimizer(cfg, total_updates)

    def norm_of(rms):
        return rms.normalize if cfg.normalize_obs else (lambda x: x.to(torch.float32))

    def init(generator: torch.Generator,
             env_generator: Optional[torch.Generator] = None) -> RPPOTrainState:
        model = _make_model(env, env_params, cfg, generator).to(dev)
        n = local_envs or cfg.num_envs
        env_state, ts0 = vecenv.batch_reset(env, env_params, env_generator or generator, n,
                                            device=dev)
        return RPPOTrainState(
            params=model, opt_state=opt.init(list(model.parameters())),
            rms=RunningMeanStd.create(obs_dim, dev), ret_rms=RunningMeanStd.create(1, dev),
            ret_accum=torch.zeros((n,), dtype=torch.float32, device=dev),
            env_state=env_state, last_obs=ts0.obs,
            last_done=torch.zeros((n,), dtype=torch.bool, device=dev),
            carry=model.initial_carry(n, device=dev), update_idx=0)

    def normalized_rewards(state, reward_raw, ret_accs):
        """(ret_rms, rewards): the rewards scaled by the running std of the
        discounted returns ``ret_accs`` and clipped to +-10, when
        ``normalize_reward``."""
        if not cfg.normalize_reward:
            return state.ret_rms, reward_raw
        ret_rms = state.ret_rms.update(ret_accs.reshape(-1, 1), mesh)
        return ret_rms, torch.clamp(reward_raw * torch.rsqrt(ret_rms.var[0] + 1e-8),
                                    -10.0, 10.0)

    def update(state: RPPOTrainState, generator: torch.Generator):
        """One fused policy+env update (recurrent_ppo.py:186-256):
        ``rollout_steps`` periods from the state's envs, obs, dones and
        carry, the envs reset where an episode ends; GAE bootstrapped from
        the post-rollout carry on the last obs; the SGD epochs re-run each
        env slice from the update's initial carry. The batch holds the raw
        obs, which the loss normalises with the pre-update statistics;
        ``rms`` then takes the raw obs."""
        model = state.params
        n_envs = state.last_obs.shape[0]
        norm = norm_of(state.rms)
        env_state, obs, done = state.env_state, state.last_obs, state.last_done
        carry, ret_accum = state.carry, state.ret_accum
        tr = {k: [] for k in ("obs", "done_in", "raw", "logp", "value", "reward",
                              "ret_accum", "done")}
        with torch.no_grad():
            for _ in range(cfg.rollout_steps):
                carry_next, (mean, log_std, value) = model(carry, norm(obs), done)
                raw = networks.gaussian_sample(generator, mean, log_std)
                logp = networks.gaussian_log_prob(raw, mean, log_std)
                env_state, ts = vecenv.batch_step(env, env_params, env_state,
                                                  to_env_action(raw), generator)
                env_state, next_obs = vecenv.auto_reset(env, env_params, env_state, ts,
                                                        generator, n_envs)
                # VecNormalize's order: accumulate, record, then zero at the
                # episode's end
                ret_rec = ret_accum * cfg.gamma + ts.reward
                ret_accum = ret_rec * (1.0 - ts.done.to(torch.float32))
                for k, v in (("obs", obs), ("done_in", done), ("raw", raw), ("logp", logp),
                             ("value", value), ("reward", ts.reward), ("ret_accum", ret_rec),
                             ("done", ts.done)):
                    tr[k].append(v)
                obs, done, carry = next_obs, ts.done, carry_next
            # the bootstrap from the post-rollout carry
            _, (_, _, bootstrap) = model(carry, norm(obs), done)
        tr = {k: torch.stack(v) for k, v in tr.items()}
        reward_raw, values = tr["reward"], tr["value"]
        ret_rms, reward = normalized_rewards(state, reward_raw, tr["ret_accum"])
        next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
        advs = gae_advantages(cfg, reward, tr["done"], values, next_values)

        batch = dict(obs=tr["obs"], done_in=tr["done_in"], raw=tr["raw"], logp=tr["logp"],
                     adv=advs, ret=advs + values)
        pg_loss, v_loss, ent = sgd_epochs(cfg, opt, state, batch, norm, generator,
                                          state.carry, mesh)
        rms = state.rms.update(tr["obs"].reshape(-1, obs_dim), mesh) if cfg.normalize_obs \
            else state.rms
        metrics = dict(mean_step_reward=_mean_over(mesh, torch.mean(reward_raw)),
                       pg_loss=pg_loss,
                       v_loss=v_loss, entropy=ent)
        new_state = dataclasses.replace(
            state, rms=rms, ret_rms=ret_rms, ret_accum=ret_accum, env_state=env_state,
            last_obs=obs, last_done=done, carry=carry, update_idx=state.update_idx + 1)
        return new_state, metrics

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
        ret_rms, reward = normalized_rewards(state, reward_raw, torch.stack(ret_accs))

        obs_seq = obs_all[:T]
        done_in = torch.zeros((T, n_envs), dtype=torch.bool, device=dev)
        done_in[0] = True
        init_carry = model.initial_carry(n_envs, device=dev)
        with torch.no_grad():
            carry, (mean, log_std, values) = model.forward_sequence(init_carry, norm(obs_seq),
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
        pg_loss, v_loss, ent = sgd_epochs(cfg, opt, state, batch, norm, generator,
                                          init_carry, mesh)
        rms = state.rms.update(obs_seq.reshape(-1, obs_dim), mesh) if cfg.normalize_obs \
            else state.rms
        metrics = dict(mean_step_reward=_mean_over(mesh, torch.mean(reward_raw)),
                       pg_loss=pg_loss,
                       v_loss=v_loss, entropy=ent)
        new_state = dataclasses.replace(state, rms=rms, ret_rms=ret_rms,
                                        ret_accum=torch.zeros_like(state.ret_accum),
                                        update_idx=state.update_idx + 1)
        return new_state, metrics

    @torch.no_grad()
    def eval_episodes(params: networks.LSTMActorCritic, rms: RunningMeanStd,
                      generator: torch.Generator, num_envs: int) -> torch.Tensor:
        """Deterministic full-horizon episodes on ``vecenv`` with the carry
        threaded (recurrent_ppo.py:356-377): ``_stateful_policy``'s squashed
        mean each step. Returns the (num_envs,) summed rewards."""
        policy = _stateful_policy(env, env_params, cfg, params, rms, dev)
        env_state, ts = vecenv.batch_reset(env, env_params, generator, num_envs, device=dev)
        carry, obs = params.initial_carry(num_envs, device=dev), ts.obs
        total = torch.zeros((num_envs,), dtype=torch.float32, device=dev)
        for t in range(horizon):
            carry, action = policy(carry, obs, generator, t)
            env_state, ts = vecenv.batch_step(env, env_params, env_state, action, generator)
            obs, total = ts.obs, total + ts.reward
        return total

    return init, (update_kernel if cfg.rollout == "kernel" else update), eval_episodes


def train(env: Environment, env_params, cfg: RecurrentPPOConfig, generator: torch.Generator,
          total_timesteps: int, progress=None, mesh=None, device=None):
    """Run recurrent PPO; returns (train_state, eval_episodes, metrics per
    update as a dict of numpy arrays with the keys mean_step_reward,
    pg_loss, v_loss, entropy, update and timesteps). ``generator``
    initialises the model and drives every update; ``progress(metrics,
    state)`` is called after each update. With a ``mesh`` every rank calls
    ``train`` alike, as ``agents.ppo.train`` documents: ``num_envs / world``
    envs a rank (asserted to divide, and to divide into the minibatches) on
    the mesh's device unless ``device`` is given, the rank generator forked
    first."""
    total_updates = cfg.num_updates(total_timesteps)
    local, model_generator = None, generator
    if mesh is not None:
        assert cfg.num_envs % mesh.size == 0, (cfg.num_envs, mesh.size)
        local = cfg.num_envs // mesh.size
        assert local % cfg.num_minibatches == 0, (
            "per-rank env count must divide into minibatches", local, cfg.num_minibatches)
        generator = mesh.rank_generator(generator)
        device = training_device(device, mesh)
    init, update, eval_episodes = make_train_fns(env, env_params, cfg, total_updates,
                                                 device=device, mesh=mesh, local_envs=local)
    state = init(model_generator, generator)
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


class RecurrentPPOAgent(PPOAgent):
    """The ``BaseAgent``-protocol wrapper over recurrent PPO (JAX
    recurrent_ppo.py:468-591), on ``PPOAgent``'s checkpoints, skip-retrain
    shortcut and training log (no EvalCallback analogue, as in the JAX
    package: a non-zero ``eval_every_updates`` raises ValueError).
    ``get_action`` answers from a CPU copy of the model and carries the
    LSTM state from one call to the next, starting afresh when the env's
    period (or step count) is 0.
    ``device_policy`` is None: a recurrent policy needs the stateful
    protocol, ``device_policy_stateful``, which feeds
    ``vecenv.evaluate_episodes_seeded_stateful``."""

    def __init__(self, env: Environment, params_factory, name: str = "PPO_LSTM",
                 config: Optional[RecurrentPPOConfig] = None, **kwargs):
        if kwargs.get("eval_every_updates", 0):
            raise ValueError("eval_every_updates: the recurrent agents have no EvalCallback "
                             "analogue (nor has the JAX package)")
        super().__init__(env, params_factory, name=name,
                         config=config or RecurrentPPOConfig(), **kwargs)
        self._carry = None

    def _template_state(self, dev):
        """The recurrent ``init`` at one env on the xla path (which the
        kernel path's init equals, without its shape checks)."""
        init, _, _ = make_train_fns(self.env, self.env_params,
                                    self.config.replace(num_envs=1, rollout="xla"), 1,
                                    device=dev)
        return init(torch.Generator(device=dev).manual_seed(self.seed))

    def _fit(self, total_timesteps: int, dev):
        state, _, metrics = train(self.env, self.env_params, self.config,
                                  torch.Generator(device=dev).manual_seed(self.seed),
                                  total_timesteps, mesh=self.mesh, device=dev)
        return state, metrics

    def _eval_policy(self):
        """The deterministic step on a CPU copy of the model and statistics:
        ``step(carry, obs) -> (carry, action)``."""
        if self._eval is None:
            model = copy.deepcopy(self.train_state.params).cpu()
            rms = self.train_state.rms
            rms = RunningMeanStd(mean=rms.mean.cpu(), var=rms.var.cpu(), count=rms.count.cpu())
            self._eval = (model, _stateful_policy(self.env, self.env_params, self.config,
                                                  model, rms, "cpu"))
        return self._eval

    def get_action(self, observation, env):
        if self.train_state is None:
            return env.action_space.sample().astype(env.action_space.dtype)
        model, policy = self._eval_policy()
        period = int(getattr(env, "period", getattr(env, "step_count", 0)))
        if self._carry is None or period == 0:
            self._carry = model.initial_carry(1)
        obs = torch.as_tensor(np.asarray(observation, np.float32))[None]
        self._carry, a = policy(self._carry, obs, None, period)
        return np.asarray(a[0]).astype(env.action_space.dtype)

    def device_policy(self, env, params):
        return None   # the stateless protocol cannot thread the carry

    def device_policy_stateful(self, env, params):
        """(carry0_fn, policy_fn) for ``vecenv.evaluate_episodes_seeded_stateful``
        on the trained model's device: ``carry0_fn(num_envs)`` a zero carry,
        ``policy_fn(carry, obs, generator, t) -> (carry, action)`` the
        squashed mean over full-horizon episodes. None before training."""
        if self.train_state is None:
            return None
        st = self.train_state
        dev = st.rms.mean.device
        policy = _stateful_policy(env, self.env_params or params, self.config, st.params,
                                  st.rms, dev)
        return (lambda num_envs: st.params.initial_carry(num_envs, device=dev)), policy


def _stateful_policy(env: Environment, env_params, cfg: RecurrentPPOConfig,
                     model: networks.LSTMActorCritic, rms: RunningMeanStd, device):
    """``policy_fn(carry, obs, generator, t) -> (carry, action)``: one cell
    step of ``model`` on the normalised obs (``done`` False: full-horizon
    episodes), the squashed mean as the env's action."""
    to_env_action = env_action_fn(env, env_params, device)
    normf = rms.normalize if cfg.normalize_obs else (lambda x: x.to(torch.float32))

    @torch.no_grad()
    def policy_fn(carry, obs, _generator, _t):
        done = torch.zeros((obs.shape[0],), dtype=torch.bool, device=obs.device)
        carry, (mean, _, _) = model(carry, normf(obs), done)
        return carry, to_env_action(mean)
    return policy_fn


class A2CLSTMAgent(RecurrentPPOAgent):
    """A2C_LSTM's host wrapper: ``RecurrentPPOAgent`` with
    ``A2CLSTMConfig()`` unless a config is given (recurrent_ppo.py:611)."""

    def __init__(self, env: Environment, params_factory, name: str = "A2C_LSTM",
                 config: Optional[RecurrentPPOConfig] = None, **kwargs):
        super().__init__(env, params_factory, name=name, config=config or A2CLSTMConfig(),
                         **kwargs)
