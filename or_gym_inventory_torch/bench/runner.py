"""Shared benchmark pipeline: define agents, train, evaluate, report, plot
(port of ``or_gym_inventory_tpu/bench/runner.py``).

The reference re-declares this pipeline by copy-paste in every benchmark
script (its own comment: benchmark_InvManagementLostSalesEnv.py:122-124
"Copying them here for completeness of the script file."); here it is one
function. Each protocol in ``bench.protocols`` is just config + roster
(mirroring the reference's __main__ blocks, e.g.
benchmark_InvManagementBacklogEnv.py:686-773).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Sequence, Tuple

from or_gym_inventory_torch.agents.base import BaseAgent
from or_gym_inventory_torch.bench import plots
from or_gym_inventory_torch.bench.evaluate import evaluate_agent, evaluate_agent_vectorized
from or_gym_inventory_torch.bench.report import process_and_report_results


def run_benchmark(env_name_short: str,
                  agents: Sequence[Tuple[str, BaseAgent]],
                  env_factory: Callable,
                  env_config: Dict,
                  n_eval_episodes: int,
                  seed_offset: int,
                  rl_training_timesteps: int,
                  results_dir: str = None,
                  log_dir: str = None,
                  collect_step_details: bool = False,
                  fast: bool = False,
                  env=None, params=None,
                  make_plots: bool = True,
                  device=None):
    """Train RL agents, evaluate the roster, aggregate, persist, plot.

    ``fast=True`` uses the vectorized device evaluator (one episode per lane,
    on ``device``, None meaning the GPU) for agents exposing a device
    policy; the others take the host path, with a printed line saying so.
    Each learner trains on its own ``device``.

    ``OGT_AGENTS`` (comma-separated names) restricts the roster — used to
    re-measure a subset of rows without re-training the whole table.

    The returned summary's ``attrs["vectorized"]`` maps each row evaluated
    on the device to its evaluator's ``steps_per_second`` and
    ``compile_seconds`` (the CSVs are the JAX package's). Unlike the JAX
    runner, it enables no compile cache: the port has none to enable
    (``utils.compile_cache``).
    """
    only = os.environ.get("OGT_AGENTS")
    if only is not None:
        wanted = {n.strip() for n in only.split(",") if n.strip()}
        if not wanted:
            raise SystemExit("OGT_AGENTS is set but contains no agent names")
        agents = [(n, a) for n, a in agents if n in wanted]
        missing = wanted - {n for n, _ in agents}
        if missing:
            raise SystemExit(f"OGT_AGENTS names not in roster: {sorted(missing)}")
        print(f"Roster restricted via OGT_AGENTS to: {[n for n, _ in agents]}")
        # A subset re-measure must not clobber the full-roster CSVs with
        # filtered rows; route its artifacts to a sibling directory — ALSO
        # when the script passed an explicit results_dir (every benchmark
        # script does, which used to defeat this guard).
        base = (results_dir or
                f"./benchmark_results_{env_name_short}").rstrip("/")
        subset_dir = base if base.endswith("_subset") else base + "_subset"
        if results_dir not in (None, subset_dir):
            print(f"Subset run: artifacts redirected to {subset_dir} "
                  f"(full-roster CSVs in {results_dir} left untouched)")
        results_dir = subset_dir
    results_dir = results_dir or f"./benchmark_results_{env_name_short}"
    log_dir = log_dir or f"./logs_{env_name_short}"

    agent_objects = {name: agent for name, agent in agents}

    print("\n--- Training Phase ---")
    for name, agent in agents:
        agent.train(env_config, rl_training_timesteps,
                    save_path_prefix=f"{env_name_short}_")
        if agent.get_training_time():
            print(f"  {name}: trained in {agent.get_training_time():.1f}s")

    print("\n--- Evaluation Phase ---")
    all_results, vectorized = [], {}
    for name, agent in agents:
        use_device = False
        if fast and params is not None and env is not None:
            use_device = agent.device_policy(env, params) is not None
            if not use_device:
                sf = getattr(agent, "device_policy_stateful", None)
                use_device = sf is not None and sf(env, params) is not None
            if not use_device:
                # say so — a silent host fallback looks like the device
                # path the caller asked for but runs orders slower
                print(f"  [fast] {name}: no device policy "
                      "(stateless or stateful); using the host episode path")
        if use_device:
            res = evaluate_agent_vectorized(agent, env, params,
                                            n_eval_episodes, seed=seed_offset,
                                            device=device)
            vectorized[name] = {k: res[k] for k in ("steps_per_second", "compile_seconds")}
        else:
            res = evaluate_agent(agent, env_factory, n_eval_episodes,
                                 seed_offset=seed_offset,
                                 collect_details=collect_step_details,
                                 env_config=env_config)
        if not res["summary"].empty:
            all_results.append(res)

    summary, raw = process_and_report_results(
        all_results, agent_objects, results_dir=results_dir,
        env_name_short=env_name_short,
        collect_step_details=collect_step_details)
    if summary is not None:
        summary.attrs["vectorized"] = vectorized

    if make_plots and summary is not None:
        try:
            log_dirs = {name: log_dir for name, a in agents
                        if a.get_training_time() > 0 or hasattr(a, "training_log")}
            plots.plot_learning_curves(log_dirs, results_dir, env_name_short)
            plots.plot_benchmark_results(summary, raw, results_dir,
                                         env_name_short, n_eval_episodes)
        except Exception as e:
            print(f"Error generating plots: {e}")
    return summary, raw
