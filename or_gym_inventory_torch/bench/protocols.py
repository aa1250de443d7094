"""The ten reference benchmark protocols as data and rosters.

Each protocol is one of the JAX package's ``benchmarks/benchmark_*.py``
scripts, named by the script's stem, with its settings (the adapter class,
``ENV_CONFIG``, the first seed, the episode count and the RL budget) and its
``build_agents()`` roster on the port's agents, under the same names and
configs (``PPO_CFG``, ``OFF_CFG``, ``A2C_MB32``, ``PPO_LSTM``,
``SAC_LargeNet``, the ``RLlib_*`` rows through ``make_agent``, and
``PPO_Kernel`` under ``OGT_KERNEL_ROSTER=1``).

    python -m or_gym_inventory_torch.bench.protocols benchmark_inv_management_backlog

runs one through ``bench.runner.run_benchmark``. The scripts' environment
variables keep their meaning, read when a protocol runs: ``OGT_EPISODES``,
``OGT_TIMESTEPS``, ``OGT_FAST=1`` (the vectorized evaluator on the device),
``OGT_DETAILS`` (the step-details JSONL of the InvManagement backlog
protocol, on by default there) and ``OGT_AGENTS`` (a subset of the roster,
read by ``run_benchmark``). Artifacts go under ``root``:
``benchmark_results_torch_<short>/``, ``models_torch_<short>/`` and
``logs_torch_<short>/``, beside and never over the JAX scripts' own. The
learners train, and ``OGT_FAST`` evaluates, on ``device`` (None: the GPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

from or_gym_inventory_torch.agents import heuristics as H
from or_gym_inventory_torch.agents.a2c import A2CAgent, A2CConfig
from or_gym_inventory_torch.agents.algo_registry import make_agent
from or_gym_inventory_torch.agents.base import BaseAgent, RandomAgent
from or_gym_inventory_torch.agents.off_policy import (DDPGAgent, OffPolicyConfig, SACAgent,
                                                      TD3Agent)
from or_gym_inventory_torch.agents.ppo import PPOAgent, PPOConfig
from or_gym_inventory_torch.agents.recurrent_ppo import (A2CLSTMAgent, A2CLSTMConfig,
                                                         RecurrentPPOAgent, RecurrentPPOConfig)
from or_gym_inventory_torch.bench.runner import run_benchmark
from or_gym_inventory_torch.envs import adapters as ad
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import net_inv_management as net
from or_gym_inventory_torch.envs import newsvendor as nv
from or_gym_inventory_torch.envs import topology as topo

Roster = List[Tuple[str, BaseAgent]]

# every script's off-policy config
OFF_CFG = OffPolicyConfig(num_envs=32, buffer_size=100_000, batch_size=256, start_steps=1_000)
# minibatched single-pass A2C (tools/a2c_sweep4.py's recipe), in four rosters
A2C_MB32 = A2CConfig(num_envs=256, rollout_steps=50, num_minibatches=32, updates_per_call=16)


def _net_params(env_config=None, custom=False, backlog=True):
    """benchmark_net_inv_backlog.py's ``params_factory``: the default or the
    custom graph at the config's periods."""
    cfg = dict(env_config or {})
    periods = int(cfg.get("num_periods", 30))
    topology = topo.custom_topology(periods) if custom else topo.default_topology(periods)
    return net.default_params(env_config=cfg, topology=topology, backlog=backlog)


# ------------------------------------------------------------------ rosters
# Each takes the protocol's params factory and the learners' keyword
# arguments (model and log directories, device) and returns the roster.

def _newsvendor_roster(pf, rl) -> Roster:
    """benchmark_newsvendor.py:57-77."""
    E = nv.ENV
    cfg = PPOConfig(num_envs=256, rollout_steps=50, num_minibatches=8, update_epochs=4,
                    ent_coef=0.0)
    return [
        ("Random", RandomAgent()),
        ("OrderUpTo_SF=1.0", H.OrderUpToHeuristicAgent(1.0)),
        ("OrderUpTo_SF=1.2", H.OrderUpToHeuristicAgent(1.2)),
        ("OrderUpTo_SF=0.8", H.OrderUpToHeuristicAgent(0.8)),
        ("ClassicNV_SF=1.0_k_vs_h", H.ClassicNewsvendorAgent("k_vs_h", 1.0)),
        ("PPO", PPOAgent(E, pf, name="PPO", config=cfg, **rl)),
        ("SAC", SACAgent(E, pf, config=OFF_CFG, **rl)),
        ("TD3", TD3Agent(E, pf, config=OFF_CFG, **rl)),
        ("A2C", A2CAgent(E, pf, config=A2CConfig(), **rl)),
        ("A2C_MB32", A2CAgent(E, pf, name="A2C_MB32", config=A2C_MB32, **rl)),
    ]


def _newsvendor_combined_roster(pf, rl) -> Roster:
    """benchmark_newsvendor_combined.py:46-73."""
    E = nv.ENV
    cfg = PPOConfig(num_envs=256, rollout_steps=25, num_minibatches=8)
    return [
        ("Random", RandomAgent()),
        ("OrderUpTo_SF=1.0", H.OrderUpToHeuristicAgent(1.0)),
        ("ClassicNV_SF=1.0_k_vs_h", H.ClassicNewsvendorAgent("k_vs_h", 1.0)),
        ("sS_Policy(s=0.50,S=1.2s)", H.sSPolicyAgent(0.5, 1.2)),
        ("sS_Policy(s=0.90,S=1.5s)", H.sSPolicyAgent(0.9, 1.5)),
        ("PPO", PPOAgent(E, pf, name="PPO", config=cfg, **rl)),
        ("SAC", SACAgent(E, pf, config=OFF_CFG, **rl)),
        ("TD3", TD3Agent(E, pf, config=OFF_CFG, **rl)),
        ("A2C", A2CAgent(E, pf, config=A2CConfig(num_envs=256), **rl)),
        ("A2C_MB32", A2CAgent(E, pf, name="A2C_MB32", config=A2C_MB32, **rl)),
        ("DDPG", DDPGAgent(E, pf, config=OFF_CFG, **rl)),
        ("PPO_LargeBuffer", PPOAgent(E, pf, name="PPO_LargeBuffer",
                                     config=cfg.replace(rollout_steps=50, num_envs=512), **rl)),
        ("SAC_LowLR", SACAgent(E, pf, name="SAC_LowLR", config=OFF_CFG.replace(lr=1e-4), **rl)),
    ]


IM_PPO_CFG = PPOConfig(num_envs=256, rollout_steps=50, num_minibatches=8, update_epochs=4)


def _inv_management_roster(pf, rl) -> Roster:
    """benchmark_inv_management_backlog.py:51-99, the lost-sales protocol's
    too; ``PPO_Kernel`` (K10's trajectory rollout) under
    ``OGT_KERNEL_ROSTER=1``."""
    E = im.ENV
    agents = [
        ("Random", RandomAgent()),
        ("BaseStock_SF=1.0", H.BaseStockAgent(1.0)),
        ("BaseStock_SF=1.2", H.BaseStockAgent(1.2)),
        ("BaseStock_SF=0.8", H.BaseStockAgent(0.8)),
        ("PPO", PPOAgent(E, pf, name="PPO", config=IM_PPO_CFG, **rl)),
        ("SAC", SACAgent(E, pf, config=OFF_CFG, **rl)),
        ("TD3", TD3Agent(E, pf, config=OFF_CFG, **rl)),
        ("A2C", A2CAgent(E, pf, config=A2CConfig(), **rl)),
        ("A2C_MB32", A2CAgent(E, pf, name="A2C_MB32", config=A2C_MB32, **rl)),
        ("DDPG", DDPGAgent(E, pf, config=OFF_CFG, **rl)),
        ("PPO_LargeBuffer", PPOAgent(E, pf, name="PPO_LargeBuffer",
                                     config=IM_PPO_CFG.replace(rollout_steps=100), **rl)),
        ("SAC_LowLR", SACAgent(E, pf, name="SAC_LowLR", config=OFF_CFG.replace(lr=1e-4), **rl)),
        ("PPO_SmallNet", PPOAgent(E, pf, name="PPO_SmallNet",
                                  config=IM_PPO_CFG.replace(pi_arch=(64,), vf_arch=(64,)), **rl)),
        ("SAC_LargeNet", SACAgent(E, pf, name="SAC_LargeNet",
                                  config=OFF_CFG.replace(pi_arch=(400, 300), q_arch=(400, 300)),
                                  **rl)),
        ("PPO_LSTM", RecurrentPPOAgent(E, pf, name="PPO_LSTM",
                                       config=RecurrentPPOConfig(num_envs=512, rollout_steps=50,
                                                                 num_minibatches=8), **rl)),
        ("A2C_LSTM", A2CLSTMAgent(E, pf, config=A2CLSTMConfig(), **rl)),
    ]
    if os.environ.get("OGT_KERNEL_ROSTER") == "1":
        agents.append(("PPO_Kernel", PPOAgent(E, pf, name="PPO_Kernel", config=PPOConfig(
            num_envs=1024, rollout_steps=50, num_minibatches=8, update_epochs=4,
            rollout="kernel"), **rl)))
    return agents


def _inv_management_lost_sales_roster(pf, rl) -> Roster:
    """benchmark_inv_management_lost_sales.py:30-39: the backlog roster
    with FORCE_RETRAIN (the reference script's) on every learner."""
    agents = _inv_management_roster(pf, rl)
    for _, agent in agents:
        if hasattr(agent, "force_retrain"):
            agent.force_retrain = True
    return agents


def _combined_roster(env, pf, rl, heuristics, ppo_cfg, lstm_cfg, env_id, rllib) -> Roster:
    """The combined scripts' roster: the heuristics, the SB3_* rows, and the
    RLlib_* rows by name through ``make_agent`` (the reference's
    RLlibAgentWrapper)."""
    agents = [("Random", RandomAgent())] + heuristics + [
        ("SB3_PPO", PPOAgent(env, pf, name="SB3_PPO", config=ppo_cfg, **rl)),
        ("SB3_SAC", SACAgent(env, pf, name="SB3_SAC", config=OFF_CFG, **rl)),
        ("SB3_TD3", TD3Agent(env, pf, name="SB3_TD3", config=OFF_CFG, **rl)),
        ("SB3_A2C", A2CAgent(env, pf, name="SB3_A2C", config=A2CConfig(), **rl)),
        ("SB3_DDPG", DDPGAgent(env, pf, name="SB3_DDPG", config=OFF_CFG, **rl)),
        ("SB3_PPO-LSTM", RecurrentPPOAgent(env, pf, name="SB3_PPO-LSTM", config=lstm_cfg, **rl)),
    ]
    for algo, cfg_updates in rllib:
        name = f"RLlib_{algo}"
        agents.append((name, make_agent(algo, env_id, config_updates=cfg_updates, name=name,
                                        **rl)))
    return agents


def _im_heuristics() -> Roster:
    return [(f"BaseStock_SF={sf}", H.BaseStockAgent(sf)) for sf in (1.0, 1.2, 0.8)]


def _net_heuristics() -> Roster:
    return [("ConstantOrder_5%", H.ConstantOrderAgent(0.05)),
            ("ConstantOrder_10%", H.ConstantOrderAgent(0.10))]


_IM_RLLIB = [("PPO", {"lr": 5e-5}), ("SAC", {"gamma": 0.98}), ("TD3", {}), ("A2C", {}),
             ("DDPG", {})]
_NET_RLLIB = [("PPO", {"lr": 1e-4}), ("SAC", {"gamma": 0.99})]


def _inv_management_combined_roster(pf, rl, env_id="InvManagementBacklog-v0",
                                    rllib=_IM_RLLIB) -> Roster:
    """benchmark_inv_management_backlog_combined.py:49-75."""
    return _combined_roster(im.ENV, pf, rl, _im_heuristics(), IM_PPO_CFG,
                            RecurrentPPOConfig(num_envs=512, rollout_steps=50, num_minibatches=8),
                            env_id, rllib)


def _net_roster(pf, rl) -> Roster:
    """benchmark_net_inv_backlog.py:50-62, the lost-sales protocol's too."""
    E = net.ENV
    cfg = PPOConfig(num_envs=256, rollout_steps=40, num_minibatches=8, update_epochs=4)
    return [("Random", RandomAgent())] + _net_heuristics() + [
        ("PPO", PPOAgent(E, pf, name="PPO", config=cfg, **rl)),
        ("SAC", SACAgent(E, pf, config=OFF_CFG, **rl)),
        ("TD3", TD3Agent(E, pf, config=OFF_CFG, **rl)),
        ("A2C", A2CAgent(E, pf, config=A2CConfig(), **rl)),
        ("DDPG", DDPGAgent(E, pf, config=OFF_CFG, **rl)),
    ]


def _net_combined_roster(pf, rl, env_id="NetInvMgmtBacklog-v0", rllib=_NET_RLLIB) -> Roster:
    """benchmark_net_inv_backlog_combined.py:46-70."""
    return _combined_roster(net.ENV, pf, rl, _net_heuristics(),
                            PPOConfig(num_envs=256, rollout_steps=30, num_minibatches=8,
                                      update_epochs=4),
                            RecurrentPPOConfig(num_envs=256, rollout_steps=30, num_minibatches=8),
                            env_id, rllib)


# ---------------------------------------------------------------- protocols

@dataclasses.dataclass(frozen=True)
class Protocol:
    """One benchmark script's settings: its ``ENV_NAME_SHORT``, adapter
    class, functional env and params factory, ``ENV_CONFIG``, episode count,
    RL budget, ``SEED_OFFSET``, roster, and whether it writes the step
    details (``OGT_DETAILS``, the InvManagement backlog script alone)."""

    env_name_short: str
    env_factory: Callable
    env: object
    params_factory: Callable
    env_config: Dict
    episodes: int
    timesteps: int
    seed_offset: int
    roster: Callable[..., Roster]
    step_details: bool = False


PROTOCOLS: Dict[str, Protocol] = {
    "benchmark_newsvendor": Protocol(
        "Newsvendor", ad.NewsvendorEnv, nv.ENV, nv.default_params,
        {"lead_time": 5, "step_limit": 50, "p_max": 100.0, "h_max": 5.0, "k_max": 10.0,
         "mu_max": 200.0}, 30, 30_000, 2000, _newsvendor_roster),
    "benchmark_newsvendor_combined": Protocol(
        "NewsvendorCombined", ad.CustomizableNewsvendorEnv, nv.ENV, nv.default_params,
        {"lead_time": 5, "step_limit": 50}, 30, 50_000, 8000, _newsvendor_combined_roster),
    "benchmark_inv_management_backlog": Protocol(
        "InvMgmt", ad.InvManagementBacklogEnv, im.ENV, partial(im.default_params, backlog=True),
        {"periods": 50}, 30, 50_000, 4000, _inv_management_roster, step_details=True),
    "benchmark_inv_management_lost_sales": Protocol(
        "InvMgmtLS", ad.InvManagementLostSalesEnv, im.ENV,
        partial(im.default_params, backlog=False), {"periods": 30, "dist_param": {"mu": 20}},
        30, 50_000, 5000, _inv_management_lost_sales_roster),
    "benchmark_inv_management_backlog_combined": Protocol(
        "InvMgmtCombined", ad.InvManagementBacklogEnv, im.ENV,
        partial(im.default_params, backlog=True), {"periods": 50}, 30, 75_000, 9000,
        _inv_management_combined_roster),
    "benchmark_inv_management_lost_sales_combined": Protocol(
        "InvMgmtLSCombined", ad.InvManagementLostSalesEnv, im.ENV,
        partial(im.default_params, backlog=False), {"periods": 50}, 20, 75_000, 10000,
        partial(_inv_management_combined_roster, env_id="InvManagementLostSales-v0",
                rllib=_IM_RLLIB[:2])),
    "benchmark_net_inv_backlog": Protocol(
        "NetInvMgmt", ad.NetInvMgmtBacklogEnv, net.ENV, _net_params, {"num_periods": 40}, 20,
        75_000, 6000, _net_roster),
    # the custom graph; its LostSales adapter runs backlog=True (QUIRKS.md #1)
    "benchmark_net_inv_lost_sales": Protocol(
        "NetInvMgmtLS", ad.NetInvMgmtCustomLostSalesEnv, net.ENV,
        partial(_net_params, custom=True), {"num_periods": 40}, 20, 75_000, 7000, _net_roster),
    "benchmark_net_inv_backlog_combined": Protocol(
        "NetInvMgmtCombined", ad.NetInvMgmtBacklogEnv, net.ENV,
        partial(net.default_params, backlog=True), {"num_periods": 30}, 10, 100_000, 11000,
        _net_combined_roster),
    # NetInvMgmtLostSalesEnv runs backlog=True too (QUIRKS.md #1), and so do its params
    "benchmark_net_inv_lost_sales_combined": Protocol(
        "NetInvMgmtLSCombined", ad.NetInvMgmtLostSalesEnv, net.ENV,
        partial(net.default_params, backlog=True), {"num_periods": 30}, 10, 75_000, 12000,
        partial(_net_combined_roster, env_id="NetInvMgmtLostSales-v0",
                rllib=_NET_RLLIB + [("TD3", {}), ("A2C", {}), ("DDPG", {})])),
}


def _dirs(proto: Protocol, root: str) -> Tuple[str, str, str]:
    short = proto.env_name_short
    return tuple(os.path.join(root, f"{kind}_torch_{short}")
                 for kind in ("benchmark_results", "models", "logs"))


def build_agents(name: str, root: str = ".", device=None) -> Roster:
    """The protocol's roster, its learners writing under ``root`` and
    training on ``device``."""
    proto = PROTOCOLS[name]
    _, model_dir, log_dir = _dirs(proto, root)
    return proto.roster(proto.params_factory,
                        dict(model_dir=model_dir, log_dir=log_dir, device=device))


def run(name: str, root: str = ".", device=None, episodes: Optional[int] = None,
        timesteps: Optional[int] = None, fast: Optional[bool] = None,
        make_plots: bool = True):
    """Run the protocol ``name`` (a script stem) through ``run_benchmark``;
    ``episodes``, ``timesteps`` and ``fast`` default to the script's
    settings under ``OGT_EPISODES``, ``OGT_TIMESTEPS`` and ``OGT_FAST``.
    Returns ``run_benchmark``'s (summary, raw)."""
    proto = PROTOCOLS[name]
    if episodes is None:
        episodes = int(os.environ.get("OGT_EPISODES", proto.episodes))
    if timesteps is None:
        timesteps = int(os.environ.get("OGT_TIMESTEPS", proto.timesteps))
    if fast is None:
        fast = os.environ.get("OGT_FAST", "0") == "1"
    details = proto.step_details and os.environ.get("OGT_DETAILS", "1") == "1"
    results_dir, _, log_dir = _dirs(proto, root)
    return run_benchmark(proto.env_name_short, build_agents(name, root, device),
                         proto.env_factory, proto.env_config, episodes, proto.seed_offset,
                         timesteps, results_dir=results_dir, log_dir=log_dir,
                         collect_step_details=details, fast=fast, env=proto.env,
                         params=proto.params_factory(env_config=proto.env_config),
                         make_plots=make_plots, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("name", choices=sorted(PROTOCOLS))
    parser.add_argument("--root", default=".", help="where the artifacts go")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    run(args.name, root=args.root, device=args.device)
    print("\nBenchmark script finished.")


if __name__ == "__main__":
    main()
