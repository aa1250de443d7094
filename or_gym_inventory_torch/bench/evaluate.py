"""Seeded agent evaluation: the reference's protocol and a vectorized path
(port of ``or_gym_inventory_tpu/bench/evaluate.py``).

Host path (``evaluate_agent``) reproduces the reference protocol exactly:
N episodes on a single adapter env, episode i seeded ``seed_offset + i``
(benchmark_newsvendor.py:227-228), per-episode wall time, operational metrics
per env family:
- newsvendor: reward/steps/time (benchmark_newsvendor.py:219-275)
- InvManagement: + retailer service level, stockout qty, avg ending inventory
  from the step info (benchmark_InvManagementBacklogEnv.py:346-469)
- NetInvMgmt: metrics read from the env's D/S/U/X frames
  (benchmark_NetInvMgmtBacklogEnv.py:223-307)
Per-episode failures are caught and recorded as NaN rows with an Error
string, preserving the reference's SuccessRate accounting (:449-458). It
runs on the host, NumPy in and out, and is the JAX package's line for line.

Device path (``evaluate_agent_vectorized``) runs all episodes as one batch
on the device (``device=None`` means the GPU) through the agent's device
policy and ``vector.evaluate_episodes_seeded[_stateful]``, lane i seeded
``seed + i`` alone.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import pandas as pd
import torch

from or_gym_inventory_torch.agents.base import BaseAgent
from or_gym_inventory_torch.core.device import resolve_device, synchronize, to_numpy
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.vector import vecenv


# --------------------------------------------------- per-family metric hooks

def _metrics_newsvendor(env, info, acc):
    # richer variant back-computes stockout/excess from cost components
    # (benchmark_newsvendor_sb3_rllib.py:782-843)
    k = info.get("penalty_cost_rate", 0.0)
    h = info.get("holding_cost_rate", 0.0)
    if k and k > 1e-9:
        acc["stockout_qty"] += info.get("lost_sales_penalty", 0.0) / k
    if h and h > 1e-9:
        acc["ending_inv"] += info.get("holding_cost", 0.0) / h
    acc["demand"] += info.get("demand", 0.0)
    sale_rev = info.get("revenue", 0.0)
    price = info.get("price", 0.0)
    if price and price > 1e-9:
        acc["sales"] += sale_rev / price


def _metrics_inv_management(env, info, acc):
    acc["demand"] += info.get("demand_realized", 0)
    sales = info.get("sales")
    if sales is not None:
        acc["sales"] += sales[0]
    unf = info.get("unfulfilled")
    if unf is not None:
        acc["stockout_qty"] += unf[0]
    einv = info.get("ending_inventory")
    if einv is not None:
        acc["ending_inv"] += float(np.sum(np.maximum(0, einv)))


def _metrics_net_inv(env, info, acc):
    t = env.period - 1  # step just completed
    acc["demand"] += float(env.D.loc[t].sum())
    acc["sales"] += float(env.S.loc[t, env.retail_links].sum())
    acc["stockout_qty"] += float(env.U.loc[t + 1].sum())
    acc["ending_inv_nodes"].append(env.X.loc[t + 1].to_numpy(copy=True))


def _pick_metric_hook(env) -> Callable:
    if hasattr(env, "retail_links"):
        return _metrics_net_inv
    if hasattr(env, "num_stages"):
        return _metrics_inv_management
    return _metrics_newsvendor


# ----------------------------------------------------------------- host path

def evaluate_agent(agent: BaseAgent, env_factory: Callable, n_episodes: int,
                   seed_offset: int = 0, collect_details: bool = False,
                   env_config: Optional[Dict] = None) -> Dict:
    """Reference-protocol evaluation. ``env_factory(**env_config)`` builds the
    adapter env. Returns {'summary': DataFrame, 'details': [...]}."""
    eval_env = env_factory(**(env_config or {}))
    metric_hook = _pick_metric_hook(eval_env)
    episode_summaries, all_details = [], []
    successful = 0
    print(f"\nEvaluating {agent.name} for {n_episodes} episodes...")
    for i in range(n_episodes):
        episode_seed = seed_offset + i
        details = []
        try:
            obs, info = eval_env.reset(seed=episode_seed)
            acc = dict(demand=0.0, sales=0.0, stockout_qty=0.0,
                       ending_inv=0.0, ending_inv_nodes=[])
            total, steps = 0.0, 0
            terminated = truncated = False
            start = time.perf_counter()
            while not (terminated or truncated):
                action = agent.get_action(obs, eval_env)
                obs, reward, terminated, truncated, info = eval_env.step(action)
                total += reward
                steps += 1
                metric_hook(eval_env, info, acc)
                if collect_details:
                    details.append({
                        "step": steps, "reward": float(reward),
                        "action": np.asarray(action).tolist()})
            elapsed = time.perf_counter() - start

            if acc["ending_inv_nodes"]:
                avg_end_inv = float(np.mean(acc["ending_inv_nodes"]))
            else:
                avg_end_inv = acc["ending_inv"] / steps if steps else 0.0
            service = (acc["sales"] / max(1e-6, acc["demand"])
                       if acc["demand"] > 1e-6 else 1.0)
            episode_summaries.append({
                "Agent": agent.name, "Episode": i + 1, "TotalReward": total,
                "Steps": steps, "Time": elapsed, "Seed": episode_seed,
                "AvgServiceLevel": service,
                "TotalStockoutQty": acc["stockout_qty"],
                "AvgEndingInv": avg_end_inv, "Error": None})
            all_details.append(details)
            successful += 1
            if n_episodes <= 20 or (i + 1) % max(1, n_episodes // 5) == 0:
                print(f"  Ep {i + 1}/{n_episodes}: Reward={total:.2f}, "
                      f"ServiceLvL={service:.2%}")
        except Exception as e:  # NaN-row failure accounting (reference :449-458)
            import traceback
            print(f"!!! ERROR during evaluation episode {i + 1} for "
                  f"{agent.name}: {e}")
            traceback.print_exc()
            episode_summaries.append({
                "Agent": agent.name, "Episode": i + 1, "TotalReward": np.nan,
                "Steps": 0, "Time": 0, "Seed": episode_seed,
                "AvgServiceLevel": np.nan, "TotalStockoutQty": np.nan,
                "AvgEndingInv": np.nan, "Error": str(e)})
            all_details.append([])
    eval_env.close()
    if successful == 0:
        print(f"Evaluation FAILED for {agent.name}. No successful episodes.")
        return {"summary": pd.DataFrame(), "details": []}
    return {"summary": pd.DataFrame(episode_summaries), "details": all_details}


# --------------------------------------------------------------- device path

def evaluate_agent_vectorized(agent: BaseAgent, env: Environment, params,
                              n_episodes: int, seed: int = 0, device=None) -> Dict:
    """All episodes as one batch on the device (one episode per lane).

    Seeding follows the reference protocol: episode i is driven by seed
    ``seed + i`` (benchmark_newsvendor.py:227-228); each lane's reset and
    per-period draws are a function of its recorded Seed alone
    (``evaluate_episodes_seeded``), so a row does not depend on the batch.

    Operational metrics come from the stacked trajectory infos. Wall time is
    one timed call divided across episodes, the device synchronised before
    each clock read and the totals fetched to the host inside the window.
    The call before it (kernel builds, first launches, caches) is reported
    as ``compile_seconds``: the port compiles no program there, so it is a
    warm-up, never folded into Time or ``steps_per_second``; the evaluation
    runs twice in all.
    """
    dev = resolve_device(device)
    policy = agent.device_policy(env, params)
    stateful = None
    if policy is None:
        # recurrent agents expose the carry-threading protocol instead
        sf = getattr(agent, "device_policy_stateful", None)
        stateful = sf(env, params) if sf is not None else None
        if stateful is None:
            raise ValueError(f"{agent.name} has no device policy; "
                             "use evaluate_agent instead")
    episode_seeds = seed + np.arange(n_episodes)
    seeds_dev = torch.as_tensor(episode_seeds, dtype=torch.int64, device=dev)
    if stateful is not None:
        carry0_fn, pol = stateful

        def run():
            return vecenv.evaluate_episodes_seeded_stateful(env, params, carry0_fn, pol,
                                                            seeds_dev, device=dev)
    else:
        def run():
            return vecenv.evaluate_episodes_seeded(env, params, policy, None, seeds_dev,
                                                   device=dev)
    synchronize(seeds_dev)
    start = time.perf_counter()
    totals, traj = run()
    to_numpy(totals)
    synchronize(traj)
    compile_seconds = time.perf_counter() - start
    start = time.perf_counter()
    totals, traj = run()
    totals = to_numpy(totals)
    synchronize(traj)
    elapsed = time.perf_counter() - start

    info = {k: to_numpy(v) for k, v in traj.info.items()}
    if "retail_sales" in info:          # net inv management
        demand = info["demand"].sum(axis=(0, 2))
        sales = info["retail_sales"].sum(axis=(0, 2))
        stockout = info["backlog_start"].sum(axis=(0, 2))
        end_inv = info["inventory"].mean(axis=(0, 2))
    elif "sales" in info:               # inv management
        demand = info["demand_realized"].sum(axis=0)
        sales = info["sales"][:, :, 0].sum(axis=0)
        stockout = info["unfulfilled"][:, :, 0].sum(axis=0)
        end_inv = np.maximum(0, info["ending_inventory"]).sum(axis=2).mean(axis=0)
    else:                               # newsvendor
        demand = info["demand"].sum(axis=0)
        k = info["penalty_cost_rate"]
        h = info["holding_cost_rate"]
        price = info["price"]
        sales = np.where(price > 1e-9, info["revenue"] / np.maximum(price, 1e-9),
                         0.0).sum(axis=0)
        stockout = np.where(k > 1e-9, info["lost_sales_penalty"] / np.maximum(k, 1e-9),
                            0.0).sum(axis=0)
        end_inv = np.where(h > 1e-9, info["holding_cost"] / np.maximum(h, 1e-9),
                           0.0).mean(axis=0)

    horizon = env.horizon(params)
    service = np.where(demand > 1e-6, sales / np.maximum(demand, 1e-6), 1.0)
    rows = [{
        "Agent": agent.name, "Episode": i + 1, "TotalReward": float(totals[i]),
        "Steps": horizon, "Time": elapsed / n_episodes,
        "Seed": int(episode_seeds[i]),
        "AvgServiceLevel": float(service[i]),
        "TotalStockoutQty": float(stockout[i]),
        "AvgEndingInv": float(end_inv[i]), "Error": None,
    } for i in range(n_episodes)]
    return {"summary": pd.DataFrame(rows), "details": [],
            "steps_per_second": n_episodes * horizon / elapsed,
            "compile_seconds": compile_seconds}
