"""Results aggregation and persistence, the reference's L3 reporting (port
of ``or_gym_inventory_tpu/bench/report.py``, a copy: pandas and NumPy on
the host).

``process_and_report_results`` mirrors benchmark_InvManagementBacklogEnv.py:
474-552: concat per-episode rows, groupby-Agent aggregation (avg/median/std/
min/max reward, service, stockouts, inventory, timings, success rate),
sorted summary + raw CSVs, optional step-details JSONL with numpy-safe
serialization (numpy_encoder, benchmark_InvManagementLostSalesEnv.py:20-28).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from or_gym_inventory_torch.agents.base import BaseAgent


class numpy_encoder(json.JSONEncoder):
    """JSON encoder handling numpy scalars/arrays."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.bool_):
            return bool(obj)
        return super().default(obj)


def process_and_report_results(all_eval_results: List[Dict],
                               agent_objects: Dict[str, BaseAgent],
                               results_dir: str = "./benchmark_results",
                               env_name_short: str = "Env",
                               collect_step_details: bool = False,
                               n_eval_episodes: Optional[int] = None):
    """Returns (summary_df, raw_df); writes summary/raw CSVs (+JSONL)."""
    if not all_eval_results:
        print("No evaluation results to process.")
        return None, None
    summaries = [r["summary"] for r in all_eval_results
                 if "summary" in r and not r["summary"].empty]
    if not summaries:
        print("No successful evaluation summaries found.")
        return None, None
    raw = pd.concat(summaries, ignore_index=True)

    print("\n--- Benchmark Summary ---")
    summary = raw.dropna(subset=["TotalReward"]).groupby("Agent").agg(
        AvgReward=("TotalReward", "mean"),
        MedianReward=("TotalReward", "median"),
        StdReward=("TotalReward", "std"),
        MinReward=("TotalReward", "min"),
        MaxReward=("TotalReward", "max"),
        AvgServiceLevel=("AvgServiceLevel", "mean"),
        AvgStockoutQty=("TotalStockoutQty", "mean"),
        AvgEndInv=("AvgEndingInv", "mean"),
        AvgTimePerEp=("Time", "mean"),
        AvgSteps=("Steps", "mean"),
        SuccessfulEpisodes=("Episode", "count"),
    )
    summary["TrainingTime(s)"] = summary.index.map(
        lambda name: agent_objects.get(name, BaseAgent(name))
        .get_training_time()).fillna(0.0)
    summary["EpisodesAttempted"] = raw.groupby("Agent")["Episode"].count()
    summary["SuccessRate(%)"] = (summary["SuccessfulEpisodes"]
                                 / summary["EpisodesAttempted"]) * 100
    summary = summary.sort_values(by="AvgReward", ascending=False)
    summary = summary[[
        "AvgReward", "MedianReward", "StdReward", "MinReward", "MaxReward",
        "AvgServiceLevel", "AvgStockoutQty", "AvgEndInv",
        "AvgTimePerEp", "TrainingTime(s)", "AvgSteps",
        "SuccessfulEpisodes", "EpisodesAttempted", "SuccessRate(%)"]]

    with pd.option_context("display.float_format", lambda x: f"{x:.2f}",
                           "display.width", 200):
        print(summary)

    os.makedirs(results_dir, exist_ok=True)
    raw_path = os.path.join(results_dir,
                            f"{env_name_short}_benchmark_raw_summary.csv")
    summary_path = os.path.join(results_dir,
                                f"{env_name_short}_benchmark_summary.csv")
    try:
        raw.to_csv(raw_path, index=False)
        summary.to_csv(summary_path)
        print(f"\nRaw summary results saved to {raw_path}")
        print(f"Summary saved to {summary_path}")
        if collect_step_details:
            details_path = os.path.join(
                results_dir, f"{env_name_short}_benchmark_step_details.jsonl")
            with open(details_path, "w") as f:
                for res in all_eval_results:
                    if "summary" not in res or res["summary"].empty:
                        continue
                    agent_name = res["summary"]["Agent"].iloc[0]
                    for ep_num, steps in enumerate(res.get("details", [])):
                        for step_data in steps:
                            row = dict(step_data, agent=agent_name,
                                       episode=ep_num + 1)
                            f.write(json.dumps(row, cls=numpy_encoder) + "\n")
            print(f"Detailed step data saved to {details_path}")
    except Exception as e:
        print(f"\nError saving results: {e}")
    return summary, raw
