"""The recurrent agents (agents/recurrent_ppo.py ``RecurrentPPOAgent`` and
``A2CLSTMAgent``) on the CPU. No JAX: the host env each ``get_action`` is
handed is a stand-in with the env's Gymnasium action space and its period.

- Both agents train a few updates on InvManagement and Newsvendor (the xla
  path, and ``RecurrentPPOAgent`` with ``rollout="kernel"`` on
  InvManagement through plain K24), writing the ``.pt`` checkpoint, its
  ``.meta.json`` budget and the CSV log;
- ``save``/``load`` round-trips the parameters and obs statistics exactly,
  and the loaded agent acts as the trained one, bit for bit;
- the skip-retrain shortcut loads a checkpoint whose recorded budget is at
  least the request and retrains otherwise or with ``force_retrain``;
- ``get_action`` returns the action space's shape and dtype, carries the
  LSTM state from call to call and starts it afresh at period 0, equal to
  stepping the model by hand;
- ``device_policy`` is None and ``device_policy_stateful`` runs through
  ``evaluate_episodes_seeded_stateful``.
"""

import json

import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import A2CLSTMAgent, RecurrentPPOAgent
from or_gym_inventory_torch.agents import networks as tnetworks
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.agents import recurrent_ppo as trppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.vector import evaluate_episodes_seeded_stateful

CPU = "cpu"
SMALL = dict(num_envs=8, rollout_steps=8, num_minibatches=2, update_epochs=2, hidden=16,
             encoder=(16,))
FAMILIES = {"inv_management": (tim, {"periods": 10}), "newsvendor": (tnv, {"step_limit": 12})}
AGENTS = {
    "ppo_lstm": (RecurrentPPOAgent, trppo.RecurrentPPOConfig(**SMALL)),
    "a2c_lstm": (A2CLSTMAgent, trppo.A2CLSTMConfig(num_envs=8, hidden=16, encoder=(16,))),
}


class _HostEnv:
    """What ``get_action`` reads of a host env: its Gymnasium action space
    and the period."""

    def __init__(self, env, params, period=0):
        self.action_space = env.action_space(params).to_gymnasium()
        self.action_space.seed(0)
        self.period = period


def _agent(cls, mod, tmp_path, config, **kw):
    return cls(mod.ENV, mod.default_params, config=config, model_dir=str(tmp_path / "models"),
               log_dir=str(tmp_path / "logs"), device=CPU, **kw)


def _episode_obs(mod, params, n=4):
    """A few obs of one episode: reset and three steps of a fixed action."""
    g = torch.Generator().manual_seed(2)
    state, ts = mod.ENV.reset(params, g, 1, device=CPU)
    space = mod.ENV.action_space(params)
    action = torch.from_numpy(np.asarray((space.low + np.minimum(space.high, 1e4)) / 4,
                                         space.dtype))[None]
    obs = [ts.obs[0].numpy()]
    for _ in range(n - 1):
        state, ts = mod.ENV.step(params, state, action, g)
        obs.append(ts.obs[0].numpy())
    return obs


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("algo", list(AGENTS))
def test_train_save_load_act(tmp_path, family, algo):
    mod, env_config = FAMILIES[family]
    cls, cfg = AGENTS[algo]
    agent = _agent(cls, mod, tmp_path, cfg)
    assert agent.device_policy(mod.ENV, None) is None
    assert agent.device_policy_stateful(mod.ENV, None) is None
    steps = 3 * cfg.num_envs * cfg.rollout_steps
    agent.train(env_config, steps)
    log = agent.training_log
    assert list(log["update"]) == [1, 2, 3]
    assert all(np.isfinite(log[k]).all() for k in ("pg_loss", "v_loss", "entropy"))
    ckpt = tmp_path / "models" / f"{agent.name}.pt"
    assert ckpt.exists() and json.loads((tmp_path / "models" / f"{agent.name}.pt.meta.json")
                                        .read_text()) == {"trained_timesteps": steps}
    with open(tmp_path / "logs" / f"{agent.name}_train_log.csv") as f:
        assert f.readline().strip().split(",") == list(log)

    fresh = _agent(cls, mod, tmp_path, cfg)
    fresh.load(str(ckpt))
    want, got = agent.train_state.params.state_dict(), fresh.train_state.params.state_dict()
    assert set(want) == set(got) and all(torch.equal(want[k], got[k]) for k in want)
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(agent.train_state.rms, f), getattr(fresh.train_state.rms, f))
    assert fresh.trained_timesteps == steps

    params = agent.env_params
    host = _HostEnv(mod.ENV, params)
    for t, obs in enumerate(_episode_obs(mod, params)):
        host.period = t
        a, b = agent.get_action(obs, host), fresh.get_action(obs, host)
        assert a.shape == host.action_space.shape and a.dtype == host.action_space.dtype
        assert np.array_equal(a, b)

    seeds = torch.arange(4000, 4016)
    runs = [evaluate_episodes_seeded_stateful(mod.ENV, params,
                                              *x.device_policy_stateful(mod.ENV, params),
                                              seeds, device=CPU) for x in (agent, fresh)]
    assert runs[0][0].shape == (16,) and torch.isfinite(runs[0][0]).all()
    assert torch.equal(runs[0][0], runs[1][0])


def test_get_action_carries_and_resets_the_state(tmp_path):
    mod, env_config = FAMILIES["inv_management"]
    agent = _agent(RecurrentPPOAgent, mod, tmp_path, AGENTS["ppo_lstm"][1])
    agent.train(env_config, 8 * 8)
    params = agent.env_params
    model, rms = agent.train_state.params, agent.train_state.rms
    low, high, _ = tppo._action_bounds(mod.ENV, params, CPU)
    obs = _episode_obs(mod, params)

    def by_hand(seq):
        carry, out = model.initial_carry(1), []
        with torch.no_grad():
            for o in seq:
                x = rms.normalize(torch.as_tensor(o, dtype=torch.float32)[None])
                carry, (mean, _, _) = model(carry, x, torch.zeros(1, dtype=torch.bool))
                out.append(tnetworks.squash_action(mean, low, high)[0].to(torch.int32).numpy())
        return out

    host = _HostEnv(mod.ENV, params)
    got = []
    for t, o in enumerate(obs):
        host.period = t
        got.append(agent.get_action(o, host))
    assert all(np.array_equal(g, w) for g, w in zip(got, by_hand(obs)))
    # a new episode (period 0) starts from a zero carry: the first action
    # is again the first action of a fresh sequence
    host.period = 0
    again = agent.get_action(obs[2], host)
    assert np.array_equal(again, by_hand(obs[2:3])[0])
    host.period = 1
    assert np.array_equal(agent.get_action(obs[3], host), by_hand(obs[2:4])[1])


def test_skip_retrain_shortcut(tmp_path, capsys):
    mod, env_config = FAMILIES["newsvendor"]
    cfg = AGENTS["a2c_lstm"][1]
    steps = 2 * cfg.num_envs * cfg.rollout_steps
    agent = _agent(A2CLSTMAgent, mod, tmp_path, cfg)
    assert agent.name == "A2C_LSTM" and agent.config == trppo.A2CLSTMConfig(
        num_envs=8, hidden=16, encoder=(16,))
    assert A2CLSTMAgent(mod.ENV, mod.default_params).config == trppo.A2CLSTMConfig()
    agent.train(env_config, steps)
    trained = agent.train_state.params.state_dict()

    again = _agent(A2CLSTMAgent, mod, tmp_path, cfg)
    again.train(env_config, steps)            # the checkpoint holds this budget
    assert "Loading existing model" in capsys.readouterr().out
    assert again.training_time == 0.0 and again.training_log is None
    assert all(torch.equal(trained[k], v) for k, v in again.train_state.params.state_dict().items())

    more = _agent(A2CLSTMAgent, mod, tmp_path, cfg)
    more.train(env_config, 2 * steps)         # a larger budget retrains
    assert "retraining" in capsys.readouterr().out and len(more.training_log["update"]) == 4
    forced = _agent(A2CLSTMAgent, mod, tmp_path, cfg, force_retrain=True)
    forced.train(env_config, steps)
    assert "Training A2C_LSTM" in capsys.readouterr().out


def test_kernel_rollout_agent_on_cpu(tmp_path):
    """``rollout="kernel"`` (plain K24 on the CPU) trains through the agent
    and its checkpoint loads into the xla path's template."""
    mod = tim
    cfg = trppo.RecurrentPPOConfig(**dict(SMALL, rollout_steps=6, rollout="kernel"))
    agent = _agent(RecurrentPPOAgent, mod, tmp_path, cfg)
    agent.train({"periods": 6}, 2 * 8 * 6)
    assert list(agent.training_log["update"]) == [1, 2]
    fresh = _agent(RecurrentPPOAgent, mod, tmp_path, cfg)
    fresh.load(agent._ckpt_path())
    assert fresh.train_state.last_obs.shape[0] == 1
    want = agent.train_state.params.state_dict()
    assert all(torch.equal(want[k], v) for k, v in fresh.train_state.params.state_dict().items())


@pytest.mark.parametrize("algo", list(AGENTS))
def test_eval_callback_option_refused(tmp_path, algo):
    """The recurrent agents have no EvalCallback analogue, as the JAX
    package's have none: a non-zero ``eval_every_updates`` raises instead
    of being ignored, and 0 constructs."""
    cls, cfg = AGENTS[algo]
    with pytest.raises(ValueError, match="eval_every_updates"):
        _agent(cls, tim, tmp_path, cfg, eval_every_updates=1)
    assert _agent(cls, tim, tmp_path, cfg, eval_every_updates=0).eval_every_updates == 0
