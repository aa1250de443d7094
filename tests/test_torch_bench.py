"""The port's benchmark harness (``bench/``) on the CPU, against the JAX
package's.

- The port's forms of tests/test_bench.py:20-124 (``evaluate_agent`` on
  the three families, the vectorized evaluator against the host path on
  user demand, ``run_benchmark`` end to end and its ``OGT_AGENTS``
  filter); :127 tests JAX's bench.py and has no counterpart.
- The seven ``evaluate_agent_vectorized`` cases of
  tests/test_vectorized_eval.py:14-141 on the port.
- Across the packages: the port's ``evaluate_agent`` on the port's adapters
  with the port's heuristics equals JAX's on JAX's, row for row, exactly
  on TotalReward, AvgServiceLevel, TotalStockoutQty and AvgEndingInv (3
  episodes from each protocol's SEED_OFFSET, the backlog protocols'
  configs of the three families).
- ``bench.protocols``: each of the ten JAX scripts, run by path with JAX's
  ``run_benchmark`` replaced by a recorder (so nothing trains or
  evaluates), hands over the roster, settings and configs that the port's
  protocol of the same stem builds: the same names, agent classes, learner
  configs (the fields both packages have), adapter class, ENV_CONFIG,
  seeds, episode count, budget and step-details flag.
- C4: the port's and JAX's vectorized evaluators on the Newsvendor
  protocol's config at 4,096 seeds each, OrderUpTo 1.0 and ClassicNV:
  equal laws, other bits, so the two means must lie within 4 combined
  standard errors.
"""

import dataclasses
import json
import os
import runpy
import sys

import numpy as np
import pandas as pd
import pytest

from or_gym_inventory_torch.agents import heuristics as H
from or_gym_inventory_torch.agents.base import RandomAgent
from or_gym_inventory_torch.agents.ppo import PPOAgent, PPOConfig
from or_gym_inventory_torch.bench import protocols
from or_gym_inventory_torch.bench.evaluate import evaluate_agent, evaluate_agent_vectorized
from or_gym_inventory_torch.bench.report import numpy_encoder
from or_gym_inventory_torch.bench.runner import run_benchmark
from or_gym_inventory_torch.envs import adapters as ad
from or_gym_inventory_torch.envs import inv_management as im
from or_gym_inventory_torch.envs import net_inv_management as net
from or_gym_inventory_torch.envs import newsvendor as nv
from or_gym_inventory_tpu.agents import heuristics as JH
from or_gym_inventory_tpu.bench import evaluate as jevaluate
from or_gym_inventory_tpu.envs import adapters as jad
from or_gym_inventory_tpu.envs import newsvendor as jnv

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------- tests/test_bench.py:20-124

def test_evaluate_agent_host_reference_protocol():
    res = evaluate_agent(H.OrderUpToHeuristicAgent(1.0), ad.NewsvendorEnv, n_episodes=3,
                         seed_offset=2000, env_config={"step_limit": 10})
    df = res["summary"]
    assert len(df) == 3
    assert list(df["Seed"]) == [2000, 2001, 2002]
    assert df["Error"].isna().all()
    assert (df["Steps"] == 10).all()


def test_evaluate_agent_inv_metrics():
    res = evaluate_agent(H.BaseStockAgent(1.0), ad.InvManagementBacklogEnv, n_episodes=2,
                         seed_offset=0, env_config={"periods": 8})
    df = res["summary"]
    assert ((0.0 <= df["AvgServiceLevel"]) & (df["AvgServiceLevel"] <= 1.0)).all()
    assert (df["AvgEndingInv"] >= 0).all()


def test_evaluate_agent_net_metrics():
    res = evaluate_agent(H.ConstantOrderAgent(0.05), ad.NetInvMgmtBacklogEnv, n_episodes=2,
                         seed_offset=0, env_config={"num_periods": 6})
    df = res["summary"]
    assert len(df) == 2 and df["Error"].isna().all()


def test_evaluate_agent_failure_rows():
    """A failing episode becomes a NaN row with its Error (the reference's
    SuccessRate accounting), and no successful episode an empty summary."""
    class Flaky(H.BaseStockAgent):
        def get_action(self, obs, env):
            if env.period == 3 and self.calls == 0:
                self.calls += 1
                raise RuntimeError("boom")
            return super().get_action(obs, env)

    agent = Flaky(1.0)
    agent.calls = 0
    df = evaluate_agent(agent, ad.InvManagementBacklogEnv, 2, env_config={"periods": 5})["summary"]
    assert df["TotalReward"].isna().tolist() == [True, False]
    assert df["Error"].tolist()[0] == "boom" and df["Steps"].tolist()[0] == 0
    agent.calls, agent.get_action = 0, None   # every episode fails
    assert evaluate_agent(agent, ad.InvManagementBacklogEnv, 1)["summary"].empty


def test_vectorized_eval_consistent_with_host():
    """Vectorized and host evaluators agree on a deterministic policy on a
    user-demand env (other RNG streams elsewhere)."""
    params = im.default_params(periods=10, dist=5, user_D=tuple([20] * 10))
    agent = H.BaseStockAgent(1.0)
    res_v = evaluate_agent_vectorized(agent, im.ENV, params, 4, seed=0, device=CPU)
    env_config = {"periods": 10, "dist": 5, "user_D": tuple([20] * 10)}
    res_h = evaluate_agent(agent, ad.InvManagementBacklogEnv, 1, seed_offset=0,
                           env_config=env_config)
    np.testing.assert_allclose(res_v["summary"]["TotalReward"],
                               res_h["summary"]["TotalReward"].iloc[0], rtol=1e-4)
    assert res_v["steps_per_second"] > 0


def _tiny_ppo(tmp_path):
    return PPOAgent(nv.ENV, nv.default_params, name="PPO",
                    config=PPOConfig(num_envs=8, rollout_steps=5, num_minibatches=2,
                                     update_epochs=2, pi_arch=(8,), vf_arch=(8,)),
                    model_dir=str(tmp_path / "models"), log_dir=str(tmp_path / "logs"),
                    device=CPU)


@pytest.mark.parametrize("fast", [False, True])
def test_run_benchmark_end_to_end(tmp_path, fast):
    agents = [("Random", RandomAgent()),
              ("OrderUpTo_SF=1.0", H.OrderUpToHeuristicAgent(1.0)),
              ("PPO", _tiny_ppo(tmp_path))]
    summary, raw = run_benchmark(
        "TestNV", agents, ad.NewsvendorEnv, {"step_limit": 5}, n_eval_episodes=2,
        seed_offset=100, rl_training_timesteps=80, results_dir=str(tmp_path / "results"),
        log_dir=str(tmp_path / "logs"), collect_step_details=True, fast=fast, env=nv.ENV,
        params=nv.default_params(step_limit=5), device=CPU)
    assert summary is not None and len(summary) == 3
    out = tmp_path / "results"
    for name in ("summary.csv", "raw_summary.csv", "rewards_boxplot.png"):
        assert os.path.exists(out / f"TestNV_benchmark_{name}"), name
    # the reference's summary columns, in its order (tests/test_bench.py:88-92)
    assert list(summary.columns) == [
        "AvgReward", "MedianReward", "StdReward", "MinReward", "MaxReward", "AvgServiceLevel",
        "AvgStockoutQty", "AvgEndInv", "AvgTimePerEp", "TrainingTime(s)", "AvgSteps",
        "SuccessfulEpisodes", "EpisodesAttempted", "SuccessRate(%)"]
    assert (summary["SuccessRate(%)"] == 100).all()
    assert list(raw["Seed"][raw.Agent == "PPO"]) == [100, 101]
    # the device rows' evaluator rate and warm-up ride in the summary's attrs
    vec = summary.attrs["vectorized"]
    assert set(vec) == ({"Random", "OrderUpTo_SF=1.0", "PPO"} if fast else set())
    assert all(r["steps_per_second"] > 0 and r["compile_seconds"] > 0 for r in vec.values())
    details = out / "TestNV_benchmark_step_details.jsonl"
    rows = [json.loads(line) for line in open(details)]
    # the host path writes the step details; the vectorized path writes none
    assert {r["agent"] for r in rows} == (set() if fast else {"Random", "OrderUpTo_SF=1.0",
                                                               "PPO"})
    assert json.dumps({"a": np.int64(3), "b": np.arange(2), "c": np.bool_(True)},
                      cls=numpy_encoder) == '{"a": 3, "b": [0, 1], "c": true}'


def test_run_benchmark_roster_filter(tmp_path, monkeypatch):
    """OGT_AGENTS restricts the roster; filtered rows land in a sibling
    _subset dir even when results_dir is passed; unknown names exit."""
    agents = [("Random", RandomAgent()), ("OrderUpTo_SF=1.0", H.OrderUpToHeuristicAgent(1.0))]
    monkeypatch.setenv("OGT_AGENTS", "Random")
    kw = dict(n_eval_episodes=1, seed_offset=100, rl_training_timesteps=0,
              results_dir=str(tmp_path / "results"), log_dir=str(tmp_path / "logs"),
              make_plots=False)
    summary, _ = run_benchmark("TestNVF", agents, ad.NewsvendorEnv, {"step_limit": 5}, **kw)
    assert list(summary.index) == ["Random"]
    assert os.path.exists(tmp_path / "results_subset" / "TestNVF_benchmark_summary.csv")
    assert not os.path.exists(tmp_path / "results" / "TestNVF_benchmark_summary.csv")
    monkeypatch.setenv("OGT_AGENTS", "NoSuchAgent")
    with pytest.raises(SystemExit):
        run_benchmark("TestNVF", agents, ad.NewsvendorEnv, {"step_limit": 5}, **kw)
    monkeypatch.setenv("OGT_AGENTS", " , ")
    with pytest.raises(SystemExit):
        run_benchmark("TestNVF", agents, ad.NewsvendorEnv, {"step_limit": 5}, **kw)


# -------------------------------------- tests/test_vectorized_eval.py:14-141

def test_vectorized_eval_newsvendor_metrics():
    params = nv.default_params(step_limit=10)
    res = evaluate_agent_vectorized(H.OrderUpToHeuristicAgent(1.0), nv.ENV, params, 8, seed=0,
                                    device=CPU)
    df = res["summary"]
    assert len(df) == 8
    assert (df["Steps"] == 10).all()
    assert ((0 <= df["AvgServiceLevel"]) & (df["AvgServiceLevel"] <= 1)).all()
    assert (df["TotalStockoutQty"] >= 0).all()
    assert res["steps_per_second"] > 0


def test_vectorized_eval_net_metrics():
    params = net.default_params(num_periods=8, backlog=True)
    res = evaluate_agent_vectorized(H.ConstantOrderAgent(0.05), net.ENV, params, 4, seed=1,
                                    device=CPU)
    df = res["summary"]
    assert len(df) == 4 and np.isfinite(df["TotalReward"]).all()
    assert (df["AvgEndingInv"] > 0).all()


def test_vectorized_eval_seed_protocol_matches_host():
    """Seed = seed_offset + i, and episode i is a function of its seed
    alone: the same seed gives the same row at any batch size or lane."""
    params = im.default_params(periods=8)
    agent = H.BaseStockAgent(1.0)
    df = evaluate_agent_vectorized(agent, im.ENV, params, 6, seed=4000, device=CPU)["summary"]
    assert list(df["Seed"]) == [4000 + i for i in range(6)]
    solo = evaluate_agent_vectorized(agent, im.ENV, params, 1, seed=4003,
                                     device=CPU)["summary"].iloc[0]
    row = df.iloc[3]
    assert solo["Seed"] == row["Seed"] == 4003
    np.testing.assert_allclose(solo["TotalReward"], row["TotalReward"], rtol=1e-6)
    np.testing.assert_allclose(solo["TotalStockoutQty"], row["TotalStockoutQty"], rtol=1e-6)
    shift = evaluate_agent_vectorized(agent, im.ENV, params, 6, seed=4002, device=CPU)["summary"]
    np.testing.assert_allclose(shift["TotalReward"][:4], df["TotalReward"][2:].to_numpy(),
                               rtol=1e-6)


def test_vectorized_eval_host_row_comparability_injected_demand():
    """With injected deterministic demand, device rows and host rows of the
    same Seed agree on reward and stockouts."""
    user_d = (17, 23, 20, 25, 14, 22, 19, 21)
    params = im.default_params(periods=8, dist=5, user_D=user_d)
    agent = H.BaseStockAgent(1.0)
    dv = evaluate_agent_vectorized(agent, im.ENV, params, 3, seed=4000, device=CPU)["summary"]
    dh = evaluate_agent(agent, ad.InvManagementBacklogEnv, 3, seed_offset=4000,
                        env_config={"periods": 8, "dist": 5, "user_D": user_d})["summary"]
    assert list(dv["Seed"]) == list(dh["Seed"])
    np.testing.assert_allclose(dv["TotalReward"], dh["TotalReward"], rtol=1e-4)
    np.testing.assert_allclose(dv["TotalStockoutQty"], dh["TotalStockoutQty"], rtol=1e-4)


def test_vectorized_eval_custom_topology_matches_host():
    """The custom 7-node graph through the device evaluator (the fast path
    of the NetInvMgmt lost-sales protocol) on injected per-link demand:
    device rows equal host rows of the same Seed."""
    from or_gym_inventory_torch.envs import topology as topo

    T = topo.custom_topology(6)
    user = {(1, 0): (17.0, 23.0, 20.0, 25.0, 14.0, 22.0),
            (2, 0): (11.0, 9.0, 15.0, 13.0, 12.0, 10.0),
            (3, 0): (20.0, 20.0, 20.0, 20.0, 20.0, 20.0)}
    T = dataclasses.replace(T, rt_demand=tuple(("user", user[e]) for e in T.retail_links))
    params = net.default_params(topology=T, num_periods=6, backlog=True)
    agent = H.ConstantOrderAgent(0.05)
    dv = evaluate_agent_vectorized(agent, net.ENV, params, 3, seed=7000, device=CPU)["summary"]
    dh = evaluate_agent(agent, ad.NetInvMgmtCustomLostSalesEnv, 3, seed_offset=7000,
                        env_config={"num_periods": 6,
                                    "user_D": {e: list(user[e]) for e in T.retail_links}}
                        )["summary"]
    assert list(dv["Seed"]) == list(dh["Seed"])
    np.testing.assert_allclose(dv["TotalReward"], dh["TotalReward"], rtol=1e-4)
    np.testing.assert_allclose(dv["AvgServiceLevel"], dh["AvgServiceLevel"], rtol=1e-4)


def test_vectorized_eval_time_excludes_warmup():
    """Time measures the second call: the first (warm-up) call goes to
    ``compile_seconds``, so a cold call's Time is of the warm call's order."""
    params = nv.default_params(step_limit=9, mu_max=150.0)
    agent = H.OrderUpToHeuristicAgent(1.0)
    cold = evaluate_agent_vectorized(agent, nv.ENV, params, 5, seed=0, device=CPU)
    warm = evaluate_agent_vectorized(agent, nv.ENV, params, 5, seed=0, device=CPU)
    assert cold["compile_seconds"] > 0
    t_cold = cold["summary"]["Time"].iloc[0]
    t_warm = warm["summary"]["Time"].iloc[0]
    assert t_cold < max(10 * t_warm, t_warm + 0.2 / 5)
    pd.testing.assert_frame_equal(cold["summary"].drop(columns="Time"),
                                  warm["summary"].drop(columns="Time"))


def test_vectorized_eval_requires_device_policy():
    class HostOnly(H.BaseStockAgent):
        def device_policy(self, env, params):
            return None

    params = im.default_params(periods=5)
    with pytest.raises(ValueError):
        evaluate_agent_vectorized(HostOnly(), im.ENV, params, 2, device=CPU)


# ------------------------------------------------------- across the packages

CROSS = {   # family -> (the backlog protocol of its family, heuristic pairs)
    "nv": ("benchmark_newsvendor",
           [(H.OrderUpToHeuristicAgent(1.0), JH.OrderUpToHeuristicAgent(1.0)),
            (H.ClassicNewsvendorAgent("k_vs_h", 1.0), JH.ClassicNewsvendorAgent("k_vs_h", 1.0)),
            (H.sSPolicyAgent(0.5, 1.2), JH.sSPolicyAgent(0.5, 1.2))]),
    "im": ("benchmark_inv_management_backlog",
           [(H.BaseStockAgent(1.0), JH.BaseStockAgent(1.0))]),
    "net": ("benchmark_net_inv_backlog",
            [(H.ConstantOrderAgent(0.05), JH.ConstantOrderAgent(0.05))]),
}
CROSS_CASES = [(fam, i) for fam, (_, pairs) in CROSS.items() for i in range(len(pairs))]


@pytest.mark.parametrize("fam,i", CROSS_CASES)
def test_evaluate_agent_equals_jax(fam, i):
    name, pairs = CROSS[fam]
    proto = protocols.PROTOCOLS[name]
    tagent, jagent = pairs[i]
    assert tagent.name == jagent.name
    jfactory = getattr(jad, proto.env_factory.__name__)
    got = evaluate_agent(tagent, proto.env_factory, 3, seed_offset=proto.seed_offset,
                         env_config=proto.env_config)["summary"]
    want = jevaluate.evaluate_agent(jagent, jfactory, 3, seed_offset=proto.seed_offset,
                                    env_config=proto.env_config)["summary"]
    assert list(got["Seed"]) == list(want["Seed"]) == [proto.seed_offset + k for k in range(3)]
    for col in ("TotalReward", "AvgServiceLevel", "TotalStockoutQty", "AvgEndingInv", "Steps"):
        assert got[col].tolist() == want[col].tolist(), col


# --------------------------------------------------------- bench.protocols

STEMS = sorted(protocols.PROTOCOLS)


def _jax_script(stem, monkeypatch):
    """Run benchmarks/<stem>.py as __main__ with JAX's run_benchmark
    replaced by a recorder: the call's arguments, nothing trained."""
    from or_gym_inventory_tpu.bench import runner

    calls = []
    monkeypatch.setattr(runner, "run_benchmark", lambda *a, **k: calls.append((a, k)))
    for mod in [m for m in sys.modules if m.startswith("benchmark_")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(os.path.join(ROOT, "benchmarks", f"{stem}.py"), run_name="__main__")
    (args, kw), = calls
    names = ("env_name_short", "agents", "env_factory", "env_config", "n_eval_episodes",
             "seed_offset", "rl_training_timesteps")
    return {**dict(zip(names, args)), **kw}


def _config_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("stem", STEMS)
def test_protocol_equals_jax_script(stem, monkeypatch, tmp_path):
    for var in ("OGT_EPISODES", "OGT_TIMESTEPS", "OGT_FAST", "OGT_DETAILS", "OGT_AGENTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("OGT_KERNEL_ROSTER", "1")
    want = _jax_script(stem, monkeypatch)
    proto = protocols.PROTOCOLS[stem]
    roster = protocols.build_agents(stem, root=str(tmp_path), device=CPU)
    assert [n for n, _ in roster] == [n for n, _ in want["agents"]]
    assert (proto.env_name_short, proto.env_factory.__name__, proto.env_config,
            proto.episodes, proto.seed_offset, proto.timesteps) == (
        want["env_name_short"], want["env_factory"].__name__, want["env_config"],
        want["n_eval_episodes"], want["seed_offset"], want["rl_training_timesteps"])
    assert proto.step_details == want.get("collect_step_details", False)
    assert not want["fast"] and proto.env.name == want["env"].name
    tp, jp = proto.params_factory(env_config=proto.env_config), want["params"]
    if proto.env.name == "net_inv_management":   # the default or the custom graph
        assert (tp.num_periods, tp.backlog, tp.alpha) == (jp.num_periods, jp.backlog, jp.alpha)
        assert tp.topology.reorder_links == jp.topology.reorder_links
    else:
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for (name, tagent), (_, jagent) in zip(roster, want["agents"]):
        assert type(tagent).__name__ == type(jagent).__name__, name
        assert tagent.name == jagent.name
        if hasattr(jagent, "config"):
            tcfg, jcfg = _config_fields(tagent.config), _config_fields(jagent.config)
            shared = set(tcfg) & set(jcfg)
            assert {"num_envs", "lr"} <= shared
            assert {k: tcfg[k] for k in shared} == {k: jcfg[k] for k in shared}, name
            assert tagent.force_retrain == jagent.force_retrain, name


# ------------------------------------------------------------------- C4

@pytest.mark.parametrize("pair", [0, 1])
def test_newsvendor_heuristics_law_matches_jax(pair):
    """ROADMAP C4: OrderUpTo 1.0 and ClassicNV on the Newsvendor protocol's
    config at 4,096 seeds from 2000 through both vectorized evaluators; the
    means within 4 combined standard errors."""
    tagent, jagent = CROSS["nv"][1][pair]
    cfg = protocols.PROTOCOLS["benchmark_newsvendor"].env_config
    n = 4096
    got = evaluate_agent_vectorized(tagent, nv.ENV, nv.default_params(env_config=cfg), n,
                                    seed=2000, device=CPU)["summary"]["TotalReward"]
    want = jevaluate.evaluate_agent_vectorized(jagent, jnv.ENV, jnv.default_params(env_config=cfg),
                                               n, seed=2000)["summary"]["TotalReward"]
    (m1, s1), (m2, s2) = [(float(x.mean()), float(x.std(ddof=1)) / np.sqrt(n))
                          for x in (got, want)]
    print(f"{tagent.name} at {n} seeds: port {m1:.1f} +- {s1:.1f}, JAX {m2:.1f} +- {s2:.1f}, "
          f"{abs(m1 - m2) / np.hypot(s1, s2):.2f} combined SE apart")
    assert abs(m1 - m2) <= 4 * np.hypot(s1, s2), (m1, s1, m2, s2)


def test_protocols_command_line(tmp_path, monkeypatch, capsys):
    """``python -m or_gym_inventory_torch.bench.protocols <stem>`` (its
    ``main``) runs the protocol under the scripts' variables, its artifacts
    under ``--root``; an unknown stem is refused."""
    for var, value in (("OGT_AGENTS", "Random,OrderUpTo_SF=1.0"), ("OGT_EPISODES", "2"),
                       ("OGT_FAST", "1")):
        monkeypatch.setenv(var, value)
    protocols.main(["benchmark_newsvendor", "--root", str(tmp_path), "--device", CPU])
    assert "Benchmark script finished." in capsys.readouterr().out
    raw = pd.read_csv(tmp_path / "benchmark_results_torch_Newsvendor_subset"
                      / "Newsvendor_benchmark_raw_summary.csv")
    assert sorted(set(raw["Agent"])) == ["OrderUpTo_SF=1.0", "Random"]
    assert raw["Seed"].tolist() == [2000, 2001] * 2
    with pytest.raises(SystemExit):
        protocols.main(["benchmark_nope"])
