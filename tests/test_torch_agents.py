"""The port's agents (agents/base.py, ``PPOAgent``, ``A2CAgent``) and
checkpoints (utils/checkpoint.py) on the CPU. No JAX: the host env each
``get_action`` is handed is a stand-in with the env's Gymnasium action space
(``core.spaces.Box.to_gymnasium``) and its period.

- ``BaseAgent``'s protocol and ``RandomAgent``/``PolicyAgent``'s actions:
  shapes, dtypes, bounds, on the host and batched through
  ``device_policy``.
- ``PPOAgent`` trains on all three families (``rollout="xla"``, the
  default), writes its ``.pt`` checkpoint, its ``.meta.json`` budget and its
  CSV log; ``save``/``load`` round-trips the parameters and the obs
  statistics exactly, and a loaded agent answers ``get_action`` as the
  trained one does, bit for bit; the skip-retrain rule loads a checkpoint
  whose recorded budget is at least the request and retrains otherwise or
  with ``force_retrain``; the EvalCallback analogue keeps the best
  evaluation's parameters.
- ``A2CAgent`` takes ``A2CConfig()`` and trains.
- ``save_pytree``/``load_pytree`` and ``to_tree``/``restore``: a nested tree
  of tensors and numbers round-trips exactly, and a PPO run stopped after
  an update that ends mid-episode and resumed from the file (train state,
  env state, optimizer, the generator's state) continues exactly as the run
  that was not stopped.
"""

import copy
import csv

import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import A2CAgent, PPOAgent, RandomAgent
from or_gym_inventory_torch.agents import a2c as ta2c
from or_gym_inventory_torch.agents import base as tbase
from or_gym_inventory_torch.agents import ppo as tppo
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.utils import checkpoint

CPU = "cpu"
SMALL = dict(num_envs=8, rollout_steps=8, num_minibatches=2, update_epochs=2,
             pi_arch=(16,), vf_arch=(16,))
FAMILIES = {
    "newsvendor": (tnv, {"step_limit": 12}),
    "inv_management": (tim, {"periods": 10}),
    "net_inv_management": (tnet, {"num_periods": 10}),
}


class _HostEnv:
    """What ``get_action`` reads of a host env: its Gymnasium action space
    and the period."""

    def __init__(self, env, params):
        self.action_space = env.action_space(params).to_gymnasium()
        self.action_space.seed(0)
        self.period = 3


def _obs(mod, params):
    _, ts = mod.ENV.reset(params, torch.Generator().manual_seed(0), 1, device=CPU)
    return ts.obs[0].numpy()


def _agent(cls, mod, tmp_path, name, **kw):
    kw.setdefault("config", tppo.PPOConfig(**SMALL))
    return cls(mod.ENV, mod.default_params, name=name, model_dir=str(tmp_path / "models"),
               log_dir=str(tmp_path / "logs"), device=CPU, **kw)


def test_base_agent_protocol(capsys):
    agent = tbase.BaseAgent("b")
    with pytest.raises(NotImplementedError):
        agent.get_action(np.zeros(3), None)
    agent.train({}, 10)
    agent.load("nowhere")
    out = capsys.readouterr().out
    assert "does not require training" in out and "does not support loading" in out
    assert agent.get_training_time() == 0.0 and agent.device_policy(None, None) is None


@pytest.mark.parametrize("family", list(FAMILIES))
def test_random_agent(family):
    mod, cfg = FAMILIES[family]
    params = mod.default_params(env_config=cfg)
    host = _HostEnv(mod.ENV, params)
    agent = RandomAgent()
    a = agent.get_action(_obs(mod, params), host)
    assert a.shape == host.action_space.shape and a.dtype == host.action_space.dtype
    assert host.action_space.contains(a)
    policy = agent.device_policy(mod.ENV, params)
    obs = torch.zeros((5,) + _obs(mod, params).shape)
    acts = policy(None, obs, torch.Generator().manual_seed(1), 0)
    space = mod.ENV.action_space(params)
    assert acts.shape == (5,) + space.shape
    assert bool((acts >= torch.as_tensor(space.low)).all())
    assert bool((acts <= torch.as_tensor(space.high)).all())


def test_policy_agent_answers_from_its_policy():
    params = tnv.default_params(env_config={"step_limit": 12})
    seen = []

    def policy(state, obs, generator, t):
        seen.append((state, tuple(obs.shape), t))
        return torch.full((obs.shape[0], 1), 7.5)

    agent = tbase.PolicyAgent("fixed", policy, policy_state="s")
    obs = _obs(tnv, params)
    a = agent.get_action(obs, _HostEnv(tnv.ENV, params))
    assert a.dtype == np.float32 and a.tolist() == [7.5]
    assert seen == [("s", (1,) + obs.shape, 3)]
    assert agent.device_policy(tnv.ENV, params) is policy


def test_ckpt_meta(tmp_path):
    path = str(tmp_path / "m.pt")
    assert tbase.ckpt_trained_timesteps(path) == 0
    tbase.write_ckpt_meta(path, 1234)
    assert tbase.ckpt_trained_timesteps(path) == 1234
    with open(path + ".meta.json", "w") as f:
        f.write("not json")
    assert tbase.ckpt_trained_timesteps(path) == 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ppo_agent_trains_saves_and_loads(tmp_path, family, capsys):
    mod, cfg = FAMILIES[family]
    agent = _agent(PPOAgent, mod, tmp_path, "PPO")
    assert agent.get_action(_obs(mod, mod.default_params(env_config=cfg)),
                            _HostEnv(mod.ENV, mod.default_params(env_config=cfg))) is not None
    budget = 2 * 8 * 8
    agent.train(cfg, budget)
    ckpt = tmp_path / "models" / "PPO.pt"
    assert ckpt.exists() and tbase.ckpt_trained_timesteps(str(ckpt)) == budget
    with open(tmp_path / "logs" / "PPO_train_log.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["update"]) for r in rows] == [1, 2]
    assert {"mean_step_reward", "pg_loss", "v_loss", "entropy", "timesteps"} <= set(rows[0])
    assert "trained-steps/s" in capsys.readouterr().out

    params = agent.env_params
    host, obs = _HostEnv(mod.ENV, params), _obs(mod, params)
    a = agent.get_action(obs, host)
    space = mod.ENV.action_space(params)
    assert a.shape == space.shape and a.dtype == space.dtype and host.action_space.contains(a)

    fresh = _agent(PPOAgent, mod, tmp_path, "PPO")
    fresh.load(str(ckpt))
    for k, v in agent.train_state.params.state_dict().items():
        assert torch.equal(fresh.train_state.params.state_dict()[k], v), k
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(fresh.train_state.rms, f), getattr(agent.train_state.rms, f))
    assert fresh.trained_timesteps == budget
    np.testing.assert_array_equal(fresh.get_action(obs, host), a)

    batch = torch.as_tensor(np.stack([obs, obs]))
    acts = agent.device_policy(mod.ENV, params)(None, batch, torch.Generator(), 0)
    assert acts.shape == (2,) + space.shape
    assert np.array_equal(acts[0].numpy().astype(space.dtype), a)


def test_skip_retrain_rule(tmp_path, capsys):
    cfg = FAMILIES["newsvendor"][1]
    first = _agent(PPOAgent, tnv, tmp_path, "PPO")
    first.train(cfg, 128)
    trained = copy.deepcopy(first.train_state.params.state_dict())
    capsys.readouterr()

    again = _agent(PPOAgent, tnv, tmp_path, "PPO")
    again.train(cfg, 128)                       # the checkpoint holds the budget
    assert "Loading existing model" in capsys.readouterr().out
    assert again.get_training_time() == 0.0 and again.trained_timesteps == 128
    for k, v in trained.items():
        assert torch.equal(again.train_state.params.state_dict()[k], v)

    more = _agent(PPOAgent, tnv, tmp_path, "PPO")
    more.train(cfg, 192)                        # a larger budget retrains
    out = capsys.readouterr().out
    assert "trained only 128 < 192" in out and "Training PPO for 192" in out
    assert tbase.ckpt_trained_timesteps(str(tmp_path / "models" / "PPO.pt")) == 192

    forced = _agent(PPOAgent, tnv, tmp_path, "PPO", force_retrain=True)
    forced.train(cfg, 64)
    assert "Training PPO for 64" in capsys.readouterr().out
    prefixed = _agent(PPOAgent, tnv, tmp_path, "PPO")
    prefixed.train(cfg, 64, save_path_prefix="run1_")
    assert (tmp_path / "models" / "run1_PPO.pt").exists()


def test_eval_callback_keeps_the_best(tmp_path, capsys):
    agent = _agent(PPOAgent, tnv, tmp_path, "PPO", eval_every_updates=1, eval_episodes=4)
    agent.train(FAMILIES["newsvendor"][1], 3 * 64)
    assert "Loading best model (eval reward" in capsys.readouterr().out
    assert agent.training_log["update"].tolist() == [1, 2, 3]


def test_a2c_agent(tmp_path):
    agent = A2CAgent(tnv.ENV, tnv.default_params, model_dir=str(tmp_path / "m"),
                     log_dir=str(tmp_path / "l"), device=CPU)
    assert agent.name == "A2C" and agent.config == ta2c.A2CConfig()
    agent.config = ta2c.A2CConfig(num_envs=8)
    agent.train({"step_limit": 12}, 2 * 8 * 8)
    assert (tmp_path / "m" / "A2C.pt").exists()
    assert np.isfinite(agent.training_log["v_loss"]).all()
    assert agent.training_log["update"].tolist() == [1, 2]


def test_pytree_round_trip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": 7, "x": 0.25,
            "nested": {"list": [torch.ones(2, dtype=torch.int32), 3], "none": None,
                       "tuple": (1, torch.zeros(1))}}
    path = checkpoint.save_pytree(str(tmp_path / "sub" / "t.pt"), tree)
    back = checkpoint.load_pytree(path)
    assert back["n"] == 7 and back["x"] == 0.25 and back["nested"]["none"] is None
    assert torch.equal(back["a"], tree["a"]) and back["a"].dtype == torch.float32
    assert torch.equal(back["nested"]["list"][0], tree["nested"]["list"][0])
    assert back["nested"]["tuple"][0] == 1


def test_mid_episode_resume_is_exact(tmp_path):
    """Newsvendor's horizon 12 against rollout_steps 8: after one update
    every env is 8 periods into its episode. Stop there, save, restore into
    a train state built from another seed, and the next two updates equal
    the run that never stopped."""
    params = tnv.default_params(step_limit=12)
    cfg = tppo.PPOConfig(**SMALL)
    gen = torch.Generator().manual_seed(3)
    state = tppo.init_train_state(tnv.ENV, params, cfg, gen, 3, device=CPU)
    update = tppo.make_update_fn(tnv.ENV, params, cfg, 3, device=CPU)
    state, _ = update(state, gen)
    assert int(state.env_state.step_count[0]) == 8
    path = checkpoint.save_pytree(str(tmp_path / "resume.pt"),
                                  {"state": checkpoint.to_tree(state),
                                   "generator": checkpoint.to_tree(gen)})
    runs = []
    for resumed in (False, True):
        if resumed:
            g = torch.Generator().manual_seed(99)
            tmpl = tppo.init_train_state(tnv.ENV, params, cfg, g, 3, device=CPU)
            tree = checkpoint.load_pytree(path)
            s = checkpoint.restore(tmpl, tree["state"])
            g = checkpoint.restore(g, tree["generator"])
            assert s.params is tmpl.params and s.update_idx == 1
        else:
            s, g = state, gen
        metrics = []
        for _ in range(2):
            s, m = update(s, g)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((checkpoint.to_tree(s), metrics))
    (a, ma), (b, mb) = runs
    assert ma == mb

    def same(x, y):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif isinstance(x, dict):
            assert set(x) == set(y)
            for k in x:
                same(x[k], y[k])
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                same(u, v)
        else:
            assert x == y
    same(a, b)
    assert a["update_idx"] == 3
