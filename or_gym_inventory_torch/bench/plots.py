"""Benchmark plots, the reference's 5 comparison charts + learning curves
(port of ``or_gym_inventory_tpu/bench/plots.py``, a copy: matplotlib on the
Agg backend, seaborn where installed). matplotlib is imported at the first
plot, so that the rest of ``bench`` runs on a host without it.

Mirrors plot_benchmark_results (benchmark_InvManagementBacklogEnv.py:602-682):
reward boxplot, log-scale eval-time barh, train-time barh, reward-vs-service
scatter, reward-vs-inventory scatter; and plot_learning_curves (:557-599)
reading this framework's per-update training CSVs (the analogue of SB3
Monitor files / custom RLlib CSVs).
"""

from __future__ import annotations

import glob
import os
from typing import Dict

import numpy as np
import pandas as pd


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.style.use("seaborn-v0_8-darkgrid")
    return plt


def plot_learning_curves(log_dirs: Dict[str, str], results_dir: str,
                         env_name_short: str,
                         title: str = "RL Learning Curves"):
    """Overlay per-agent training curves from *_train_log.csv files
    (columns: timesteps + mean_step_reward or reward)."""
    plt = _plt()
    plt.figure(figsize=(12, 7))
    plt.title(title)
    plt.xlabel("Timesteps")
    plt.ylabel("Reward")
    plotted = False
    for agent_name, log_dir in log_dirs.items():
        files = glob.glob(os.path.join(log_dir, f"{agent_name}_train_log.csv"))
        if not files:
            print(f"Warning: No training log found for {agent_name} in {log_dir}")
            continue
        try:
            df = pd.read_csv(files[0])
            ycol = ("mean_step_reward" if "mean_step_reward" in df
                    else "reward" if "reward" in df else None)
            if ycol is None or df.empty:
                continue
            y = df[ycol]
            if len(y) > 10:
                y = y.rolling(window=10, min_periods=1).mean()
            plt.plot(df["timesteps"], y, label=agent_name)
            plotted = True
        except Exception as e:
            print(f"Error loading/plotting logs for {agent_name}: {e}")
    if plotted:
        plt.legend(loc="lower right")
        plt.tight_layout()
        os.makedirs(results_dir, exist_ok=True)
        path = os.path.join(results_dir,
                            f"{env_name_short}_benchmark_learning_curves.png")
        plt.savefig(path)
        print(f"Saved learning curves plot to {path}")
    else:
        print("Skipping learning curve plot - no data found.")
    plt.close("all")


def plot_benchmark_results(df_summary: pd.DataFrame, df_raw: pd.DataFrame,
                           results_dir: str, env_name_short: str,
                           n_eval_episodes: int = 0):
    """The reference's 5 comparison charts."""
    if df_summary is None or df_raw is None:
        print("Skipping plotting due to missing summary data.")
        return
    plt = _plt()
    try:
        import seaborn as sns
    except ImportError:
        sns = None
    os.makedirs(results_dir, exist_ok=True)
    n_agents = df_summary.shape[0]
    ordered = df_summary.sort_values("AvgReward", ascending=False)
    agent_order = ordered.index

    def save(name):
        path = os.path.join(results_dir, f"{env_name_short}_benchmark_{name}.png")
        plt.tight_layout()
        plt.savefig(path)
        print(f"Saved {name} plot to {path}")
        plt.close()

    # 1. reward boxplot
    plt.figure(figsize=(10, max(6, n_agents * 0.5)))
    if sns is not None:
        sns.boxplot(data=df_raw, x="TotalReward", y="Agent", hue="Agent",
                    palette="viridis", showfliers=False, order=agent_order,
                    legend=False)
    else:
        groups = [df_raw[df_raw.Agent == a]["TotalReward"].dropna()
                  for a in agent_order]
        plt.boxplot(groups, tick_labels=list(agent_order), vert=False,
                    showfliers=False)
    plt.title(f"Distribution of Total Rewards ({env_name_short} - "
              f"{n_eval_episodes} Eps)")
    plt.xlabel("Total Reward (Higher is Better)")
    plt.ylabel("Agent")
    save("rewards_boxplot")

    # 2. eval time (log barh)
    by_time = ordered.sort_values("AvgTimePerEp", ascending=True)
    plt.figure(figsize=(10, max(6, n_agents * 0.4)))
    idx = np.arange(len(by_time))
    plt.barh(idx, by_time["AvgTimePerEp"], color="skyblue", log=True)
    plt.yticks(idx, by_time.index)
    plt.xlabel("Average Evaluation Time per Episode (s) - Log Scale")
    plt.ylabel("Agent")
    plt.title(f"Average Evaluation Time per Episode ({env_name_short})")
    save("eval_time_log")

    # 3. training time
    df_train = ordered[ordered["TrainingTime(s)"] > 1].sort_values(
        "TrainingTime(s)", ascending=True)
    if not df_train.empty:
        plt.figure(figsize=(8, max(4, len(df_train) * 0.5)))
        idx = np.arange(len(df_train))
        plt.barh(idx, df_train["TrainingTime(s)"], color="lightcoral")
        plt.yticks(idx, df_train.index)
        plt.xlabel("Total Training Time (s)")
        plt.ylabel("Agent (RL)")
        plt.title(f"Training Time for RL Agents ({env_name_short})")
        save("train_time")
    else:
        print("Skipping training time plot.")

    # 4/5. reward vs service / inventory scatters
    for metric, xlabel, name in [
            ("AvgServiceLevel", "Average Service Level (Fill Rate)",
             "reward_vs_service"),
            ("AvgEndInv", "Average Ending Inventory", "reward_vs_inventory")]:
        plt.figure(figsize=(9, 7))
        if sns is not None:
            sns.scatterplot(data=ordered, x=metric, y="AvgReward",
                            hue=ordered.index, s=100, palette="viridis",
                            legend=False)
        else:
            plt.scatter(ordered[metric], ordered["AvgReward"], s=100)
        for _, row in ordered.iterrows():
            plt.text(row[metric] * 1.005 + 1e-9, row["AvgReward"], row.name,
                     fontsize=9)
        plt.title(f"Reward vs. {xlabel} ({env_name_short})")
        plt.xlabel(xlabel)
        plt.ylabel("Average Total Reward")
        plt.grid(True)
        save(name)
