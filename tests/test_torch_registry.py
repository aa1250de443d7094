"""The registries (``envs/registry.py``, ``agents/algo_registry.py``) against
the JAX package's, and the off-policy agents (``SACAgent``, ``TD3Agent``,
``DDPGAgent``) on both collection paths, on the CPU.

- ``make_functional`` of the eight functional ids gives the port's params
  equal to JAX's, field for field (the NetInvMgmt LostSales ids run
  ``backlog=True``, QUIRKS.md #1); ``make`` of a reference host id builds
  the port's ``envs.adapters`` class JAX's registry builds, of an unknown
  id raises KeyError; the NetInvMgmt functional ids agree with their
  adapters on the backlog quirk (tests/test_registry.py:34).
- ``make_agent`` builds all seven names with JAX's defaults and each trains
  a few steps; the SB3/RLlib aliases and the two errors behave as
  tests/test_registry.py:45-70 holds JAX's.
- The off-policy agents, ``collect="xla"`` and ``"kernel"`` (the plain
  K27-K29 on the CPU): the checkpoint and its metadata, save/load exact,
  the skip-retrain shortcut, ``get_action``'s shape and dtype, the
  EvalCallback analogue, and ``device_policy`` through
  ``evaluate_episodes_seeded`` equal before and after a load.
"""

import csv
import dataclasses

import numpy as np
import pytest
import torch

from or_gym_inventory_torch.agents import (DDPGAgent, SACAgent, TD3Agent, heuristics,
                                           make_agent)
from or_gym_inventory_torch.agents import base as tbase
from or_gym_inventory_torch.agents import off_policy as top
from or_gym_inventory_torch.envs import inv_management as tim
from or_gym_inventory_torch.envs import net_inv_management as tnet
from or_gym_inventory_torch.envs import newsvendor as tnv
from or_gym_inventory_torch.envs import adapters as tadapters
from or_gym_inventory_torch.envs import registry as treg
from or_gym_inventory_torch.utils import interop
from or_gym_inventory_torch.vector import evaluate_episodes_seeded
from or_gym_inventory_tpu.agents import algo_registry as jalgo
from or_gym_inventory_tpu.envs import registry as jreg
from test_torch_agents import _HostEnv, _obs

CPU = "cpu"
FUNCTIONAL = ["Newsvendor-v0", "InvManagementBacklog-v0", "InvManagementLostSales-v0",
              "NetInvMgmtBacklog-v0", "NetInvMgmtLostSales-v0", "NetInvMgmtCustomBacklog-v0",
              "NetInvMgmtCustomLostSales-v0"]
CONFIGS = {"Newsvendor-v0": {"step_limit": 7, "lead_time": 3},
           "InvManagementBacklog-v0": {"periods": 12},
           "InvManagementLostSales-v0": None,
           "NetInvMgmtBacklog-v0": {"num_periods": 9},
           "NetInvMgmtLostSales-v0": None,
           "NetInvMgmtCustomBacklog-v0": {"num_periods": 6},
           "NetInvMgmtCustomLostSales-v0": None}


def _port_of(jenv, jp):
    """The port's params carried from JAX's, for the family ``jenv`` runs."""
    if jenv.name == "newsvendor":
        return tnv.NewsvendorParams(**dataclasses.asdict(jp))
    if jenv.name == "inv_management":
        return interop.im_params_from_numpy(dataclasses.asdict(jp))
    return interop.net_params_from_numpy(dataclasses.asdict(jp.topology), jp.num_periods,
                                         jp.backlog, jp.alpha)


@pytest.mark.parametrize("env_id", FUNCTIONAL)
@pytest.mark.parametrize("with_config", [False, True])
def test_make_functional_matches_jax(env_id, with_config):
    cfg = CONFIGS[env_id] if with_config else None
    jenv, jp = jreg.make_functional(env_id, cfg)
    tenv, tp = treg.make_functional(env_id, cfg)
    assert tenv.name == jenv.name
    assert tp == _port_of(jenv, jp)
    if tenv.name == "net_inv_management":
        assert tp.backlog is True    # the LostSales ids too (QUIRKS.md #1)
    _, ts = tenv.reset(tp, torch.Generator().manual_seed(0), 2, device=CPU)
    assert tuple(ts.obs.shape[1:]) == tenv.observation_space(tp).shape


def test_make_functional_covers_jax_ids():
    """The eight functional ids (FUNCTIONAL and the InvManagement LostSales
    one) and the ten host ids, as JAX registers them."""
    assert set(treg._FUNC_REGISTRY) == set(jreg._FUNC_REGISTRY)
    assert set(treg._HOST_REGISTRY) == set(jreg._HOST_REGISTRY) == set(treg.REFERENCE_HOST_IDS)
    assert treg.registered_envs() == jreg.registered_envs()


def test_make_host_ids_wait_for_adapters():
    """``make`` builds each reference host id as the port's adapter class
    of JAX's class's name, which resets and steps (the name is kept from
    when these ids waited for the adapters and raised)."""
    for name in treg.REFERENCE_HOST_IDS:
        env = treg.make(name)
        assert type(env) is getattr(tadapters, type(jreg.make(name)).__name__)
        obs, _ = env.reset(seed=0)
        assert env.observation_space.contains(obs)
        assert np.isfinite(env.step(env.action_space.sample())[1])
    assert treg.make("InvManagementBacklog-v0", periods=7).periods == 7
    with pytest.raises(KeyError, match="Unknown env"):
        treg.make("Nope-v0")
    with pytest.raises(KeyError, match="Unknown env"):
        treg.make_functional("Nope-v0")
    treg.register_env("Custom-v0", lambda **cfg: ("custom", cfg))
    treg.register_functional("CustomNV-v0", tnv.ENV, tnv.default_params)
    try:
        assert treg.make("Custom-v0", a=1) == ("custom", {"a": 1})
        assert treg.make_functional("CustomNV-v0", {"step_limit": 3})[1].step_limit == 3
        assert {"Custom-v0", "CustomNV-v0"} <= set(treg.registered_envs())
    finally:
        treg._HOST_REGISTRY.pop("Custom-v0")
        treg._FUNC_REGISTRY.pop("CustomNV-v0")


def test_net_lost_sales_functional_matches_adapter_quirk():
    """QUIRKS.md #1 (tests/test_registry.py:34 on the port): the reference's
    NetInvMgmt LostSales subclasses de facto run backlog=True; the
    functional ids agree with the adapters the same ids build."""
    for name in ["NetInvMgmtLostSales-v0", "NetInvMgmtCustomLostSales-v0",
                 "NetInvMgmtBacklog-v0", "NetInvMgmtCustomBacklog-v0"]:
        _, params = treg.make_functional(name)
        assert params.backlog is True, name
        assert treg.make(name).backlog is True, name


NAMES = {   # name -> (class, env id, a small config, steps)
    "PPO": ("PPOAgent", "Newsvendor-v0",
            dict(num_envs=8, rollout_steps=4, num_minibatches=2, pi_arch=(8,), vf_arch=(8,)),
            64),
    "A2C": ("A2CAgent", "InvManagementBacklog-v0",
            dict(num_envs=8, pi_arch=(8,), vf_arch=(8,)), 64),
    "SAC": ("SACAgent", "NetInvMgmtBacklog-v0",
            dict(num_envs=4, buffer_size=64, batch_size=8, start_steps=4, pi_arch=(8,),
                 q_arch=(8,)), 12),
    "TD3": ("TD3Agent", "InvManagementLostSales-v0",
            dict(num_envs=4, buffer_size=64, batch_size=8, start_steps=4, pi_arch=(8,),
                 q_arch=(8,)), 12),
    "DDPG": ("DDPGAgent", "Newsvendor-v0",
             dict(num_envs=4, buffer_size=64, batch_size=8, start_steps=4, pi_arch=(8,),
                  q_arch=(8,)), 12),
    "PPO_LSTM": ("RecurrentPPOAgent", "InvManagementBacklog-v0",
                 dict(num_envs=8, rollout_steps=4, num_minibatches=2, hidden=8, encoder=(8,)),
                 64),
    "a2c_lstm": ("A2CLSTMAgent", "NetInvMgmtCustomBacklog-v0",
                 dict(num_envs=8, hidden=8, encoder=(8,)), 64),
}


@pytest.mark.parametrize("name", list(NAMES))
def test_make_agent_builds_and_trains(tmp_path, name):
    cls, env_id, small, steps = NAMES[name]
    jagent = jalgo.make_agent(name, env_id)
    agent = make_agent(name, env_id, device=CPU, model_dir=str(tmp_path / "m"),
                       log_dir=str(tmp_path / "l"))
    assert type(agent).__name__ == type(jagent).__name__ == cls
    assert agent.name == jagent.name == name.upper()
    for f in dataclasses.fields(agent.config):      # JAX's defaults per algorithm
        assert getattr(agent.config, f.name) == getattr(jagent.config, f.name), f.name
    small_agent = make_agent(name, env_id, config_updates=small, name="small", device=CPU,
                             model_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"))
    assert small_agent.name == "small"
    small_agent.train(CONFIGS.get(env_id), steps)
    assert (tmp_path / "m" / "small.pt").exists()
    assert all(np.isfinite(v).all() for v in small_agent.training_log.values())


def test_make_agent_aliases_and_errors():
    a = make_agent("PPO", "Newsvendor-v0", {"n_steps": 64, "learning_rate": 1e-4})
    assert a.config.rollout_steps == 64 and a.config.lr == 1e-4
    b = make_agent("sac", "Newsvendor-v0", {"train_batch_size": 128, "learning_starts": 500})
    assert b.config.batch_size == 128 and b.config.start_steps == 500
    assert b.config.algo == "sac" and b.config.num_envs == 32
    with pytest.raises(KeyError, match="bogus"):
        make_agent("SAC", "Newsvendor-v0", config_updates={"bogus": 1})
    with pytest.raises(KeyError, match="n_steps"):       # the user's spelling
        make_agent("TD3", "Newsvendor-v0", config_updates={"n_steps": 4})
    with pytest.raises(ValueError, match="twice"):
        make_agent("PPO", "Newsvendor-v0", {"lr": 1e-3, "learning_rate": 1e-4})
    with pytest.raises(ValueError, match="Unknown algorithm"):
        make_agent("DQN", "Newsvendor-v0")
    with pytest.raises(KeyError, match="Unknown env"):
        make_agent("PPO", "Nope-v0")
    assert heuristics.BaseStockAgent().name == "BaseStock_SF=1.0"


# ------------------------------------------------ the off-policy agents

SMALL_OFF = dict(num_envs=4, buffer_size=4 * 6 * 4, batch_size=8, start_steps=8, pi_arch=(8,),
                 q_arch=(8,), n_step=2)
FAMILIES = {"inv_management": (tim, {"periods": 6}), "newsvendor": (tnv, {"step_limit": 6}),
            "net_inv_management": (tnet, {"num_periods": 6})}
AGENTS = {"sac": SACAgent, "td3": TD3Agent, "ddpg": DDPGAgent}


def _off_agent(cls, mod, tmp_path, collect, **kw):
    return cls(mod.ENV, mod.default_params, config=top.OffPolicyConfig(**SMALL_OFF,
                                                                       collect=collect),
               model_dir=str(tmp_path / "models"), log_dir=str(tmp_path / "logs"), device=CPU,
               **kw)


@pytest.mark.parametrize("collect", ["xla", "kernel"])
@pytest.mark.parametrize("algo,family", [("sac", "newsvendor"), ("td3", "inv_management"),
                                         ("ddpg", "net_inv_management")])
def test_offpolicy_agent_trains_saves_loads_and_acts(tmp_path, capsys, algo, family, collect):
    mod, cfg = FAMILIES[family]
    cls = AGENTS[algo]
    agent = _off_agent(cls, mod, tmp_path, collect)
    assert agent.name == algo.upper() and agent.config.algo == algo
    params = mod.default_params(env_config=cfg)
    host, obs = _HostEnv(mod.ENV, params), _obs(mod, params)
    assert host.action_space.contains(agent.get_action(obs, host))   # untrained: random
    budget = 3 * 4 * 6 if collect == "kernel" else 3 * 4
    agent.train(cfg, budget)
    assert f"Training {algo.upper()} ({algo})" in capsys.readouterr().out
    ckpt = tmp_path / "models" / f"{algo.upper()}.pt"
    assert ckpt.exists() and tbase.ckpt_trained_timesteps(str(ckpt)) == budget
    with open(tmp_path / "logs" / f"{algo.upper()}_train_log.csv") as f:
        rows = list(csv.DictReader(f))
    assert {"mean_step_reward", "alpha", "timesteps"} == set(rows[0])
    assert int(rows[-1]["timesteps"]) == budget
    assert agent.state.step_idx == 3

    a = agent.get_action(obs, host)
    space = mod.ENV.action_space(params)
    assert a.shape == space.shape and a.dtype == space.dtype and host.action_space.contains(a)

    fresh = _off_agent(cls, mod, tmp_path, collect)
    fresh.load(str(ckpt))
    for k, v in agent.state.actor_params.state_dict().items():
        assert torch.equal(fresh.state.actor_params.state_dict()[k], v), k
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(fresh.state.rms, f), getattr(agent.state.rms, f))
    assert fresh.trained_timesteps == budget
    np.testing.assert_array_equal(fresh.get_action(obs, host), a)

    seeds = torch.arange(4000, 4016)
    totals = [evaluate_episodes_seeded(mod.ENV, params, x.device_policy(mod.ENV, params), None,
                                       seeds, device=CPU) for x in (agent, fresh)]
    assert torch.equal(totals[0][0], totals[1][0]) and torch.isfinite(totals[0][0]).all()
    assert torch.equal(totals[0][1].action, totals[1][1].action)

    again = _off_agent(cls, mod, tmp_path, collect)    # the skip-retrain shortcut
    again.train(cfg, budget)
    assert "Loading existing model" in capsys.readouterr().out
    assert again.get_training_time() == 0.0
    np.testing.assert_array_equal(again.get_action(obs, host), a)
    more = _off_agent(cls, mod, tmp_path, collect)
    more.train(cfg, 2 * budget)
    assert f"trained only {budget} < {2 * budget}" in capsys.readouterr().out
    assert tbase.ckpt_trained_timesteps(str(ckpt)) == 2 * budget


def test_offpolicy_agent_eval_callback_and_mesh(tmp_path, capsys, monkeypatch):
    """Every chunk evaluated (train's chunks of one iteration here), the
    best actor restored; a mesh raises naming A14."""
    agent = _off_agent(TD3Agent, tnv, tmp_path, "xla", eval_every_chunks=1, eval_episodes=4)
    train = top.train
    monkeypatch.setattr(top, "train", lambda *a, **k: train(*a, **{**k, "log_every": 1}))
    agent.train(FAMILIES["newsvendor"][1], 3 * 4)
    assert "Loading best model (eval reward" in capsys.readouterr().out
    assert agent.training_log["timesteps"].tolist() == [4, 8, 12]
    meshed = _off_agent(SACAgent, tnv, tmp_path, "xla", mesh=object(), force_retrain=True)
    with pytest.raises(NotImplementedError, match="A14"):
        meshed.train(FAMILIES["newsvendor"][1], 8)
