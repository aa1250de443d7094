"""Algorithm-by-name construction, the RLlib wrapper's capability (port of
``or_gym_inventory_tpu/agents/algo_registry.py``).

The reference's RLlibAgentWrapper builds algorithms from name strings with
config-update dicts (``AlgorithmConfig(algo_class="PPO").training(gamma=...,
lr=...)``, benchmark_NetInvMgmtLostSalesEnv_sb3_rllib.py:281-295). The same
over the port's learners:

    agent = make_agent("PPO", "NetInvMgmtBacklog-v0",
                       config_updates={"lr": 1e-4, "gamma": 0.99})
    agent.train(env_config, total_timesteps)

Algo names: PPO, A2C, SAC, TD3, DDPG, PPO_LSTM, A2C_LSTM (case-insensitive).
``config_updates`` keys map onto the learner's config (any field of it, and
the SB3/RLlib spellings in ``_ALIASES``); ``agent_kwargs`` go to the agent
(``device=``, ``model_dir=``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from or_gym_inventory_torch.agents.a2c import A2CAgent, A2CConfig
from or_gym_inventory_torch.agents.base import BaseAgent
from or_gym_inventory_torch.agents.off_policy import (DDPGAgent, OffPolicyConfig, SACAgent,
                                                      TD3Agent)
from or_gym_inventory_torch.agents.ppo import PPOAgent, PPOConfig
from or_gym_inventory_torch.agents.recurrent_ppo import (A2CLSTMAgent, A2CLSTMConfig,
                                                         RecurrentPPOAgent,
                                                         RecurrentPPOConfig)
from or_gym_inventory_torch.envs import registry

# SB3/RLlib kwarg names accepted for migration convenience (the reference's
# agent rosters configure SB3/RLlib by these names, e.g.
# benchmark_InvManagementBacklogEnv.py:697-717, *_sb3_rllib.py config blocks)
_ALIASES = {
    "n_steps": "rollout_steps",
    "learning_rate": "lr",
    "train_batch_size": "batch_size",
    "learning_starts": "start_steps",
}


def _apply_updates(cfg, updates: Dict):
    fields = {f.name for f in dataclasses.fields(cfg)}
    known, unknown = {}, []
    for k, v in updates.items():
        canon = _ALIASES.get(k, k)
        if canon not in fields:
            unknown.append(k)  # the user's spelling, not the alias
            continue
        if canon in known:
            other = next(kk for kk in updates if kk != k and _ALIASES.get(kk, kk) == canon)
            raise ValueError(
                f"config_updates sets {canon!r} twice: {k!r} and {other!r} "
                "(alias and canonical name) — pass only one")
        known[canon] = v
    if unknown:
        raise KeyError(f"Unknown config keys for {type(cfg).__name__}: {sorted(unknown)}")
    return cfg.replace(**known) if known else cfg


def make_agent(algo_name: str, env_id: str, config_updates: Optional[Dict] = None,
               name: Optional[str] = None, **agent_kwargs) -> BaseAgent:
    """An on-device learner by algorithm name for a registered functional env."""
    updates = dict(config_updates or {})
    env, _ = registry.make_functional(env_id)
    _, params_factory = registry._FUNC_REGISTRY[env_id]
    algo = algo_name.upper()
    name = name or algo
    if algo == "PPO":
        cfg = _apply_updates(PPOConfig(num_envs=256, rollout_steps=32), updates)
        return PPOAgent(env, params_factory, name=name, config=cfg, **agent_kwargs)
    if algo == "A2C":
        cfg = _apply_updates(A2CConfig(num_envs=256), updates)
        return A2CAgent(env, params_factory, name=name, config=cfg, **agent_kwargs)
    if algo in ("SAC", "TD3", "DDPG"):
        cfg = _apply_updates(OffPolicyConfig(num_envs=32, buffer_size=100_000, batch_size=256,
                                             start_steps=1_000), updates)
        cls = {"SAC": SACAgent, "TD3": TD3Agent, "DDPG": DDPGAgent}[algo]
        return cls(env, params_factory, name=name, config=cfg, **agent_kwargs)
    if algo in ("PPO_LSTM", "PPO-LSTM", "RECURRENTPPO"):
        cfg = _apply_updates(RecurrentPPOConfig(num_envs=256, rollout_steps=32,
                                                num_minibatches=8), updates)
        return RecurrentPPOAgent(env, params_factory, name=name, config=cfg, **agent_kwargs)
    if algo in ("A2C_LSTM", "A2C-LSTM"):
        cfg = _apply_updates(A2CLSTMConfig(), updates)
        return A2CLSTMAgent(env, params_factory, name=name, config=cfg, **agent_kwargs)
    raise ValueError(f"Unknown algorithm {algo_name!r}; "
                     "known: PPO, A2C, SAC, TD3, DDPG, PPO_LSTM, A2C_LSTM")
