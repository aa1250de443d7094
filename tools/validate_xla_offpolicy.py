"""Reward of TD3 and SAC on the IM-backlog protocol of
tools/validate_kernel_collect.py, on the port and one CUDA card, evaluated
on the reference's seeded protocol.

Trains, for 2M env-steps at seed 0, on InvManagement backlog (the default
params, 30 periods) at 1,024 envs, buffer 200,704, batch 256, 32 gradient
updates an iteration (validate_kernel_collect.py run_row):

- ``td3_xla``, ``sac_xla``: ``collect="xla"``, the step-interleaved update
  (plain PyTorch, no kernel), 1,953 iterations of 32 updates;
- ``td3_kernel``: ``collect="kernel"``, episode-chunked collection
  through K27, 65 iterations of 960 updates.

Each trained actor is evaluated deterministically through
``vector.evaluate_episodes_seeded`` on 30 episodes, seeds 4000-4029. It
prints one JSON line a row (the mean return and its standard error, the
training wall time, trained-steps/s and the card's name and power limit)
and a last line of all rows. The JAX package's rows on a TPU
(PERFORMANCE.md:688-697, seed 0: xla TD3 +5,947, SAC +4,816; kernel TD3
+5,061, SAC +5,420) are rewards, not speeds.

    python3 tools/validate_xla_offpolicy.py [row ...]

Without a CUDA card it exits 1. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED = 0
BUDGET = 2_000_000
EVAL_SEEDS = range(4000, 4030)
RECIPE = dict(num_envs=1024, buffer_size=200_704, batch_size=256, updates_per_iter=32)
ROWS = ("td3_xla", "sac_xla", "td3_kernel")


def run_row(row, params, dev, smi):
    import torch

    from or_gym_inventory_torch.agents import off_policy as op
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.vector import evaluate_episodes_seeded
    algo, collect = row.split("_")
    cfg = op.OffPolicyConfig(algo=algo, collect=collect, **RECIPE)
    t0 = time.perf_counter()
    state, eval_policy, metrics = op.train(
        im.ENV, params, cfg, torch.Generator(device=dev).manual_seed(SEED), BUDGET,
        log_every=200, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals, _ = evaluate_episodes_seeded(im.ENV, params, eval_policy,
                                         (state.actor_params, state.rms),
                                         torch.tensor(list(EVAL_SEEDS)), device=dev)
    if not torch.isfinite(totals).all():
        raise AssertionError(f"{row}: non-finite returns")
    totals = totals.double()
    steps = int(metrics["timesteps"][-1])
    out = {"row": row, "algo": algo, "collect": collect, "iterations": state.step_idx,
           "env_steps": steps, "seeded_avg_reward": float(totals.mean()),
           "seeded_se": float(totals.std() / math.sqrt(totals.numel())),
           "seeded_episodes": len(EVAL_SEEDS),
           "last_mean_step_reward": float(metrics["mean_step_reward"][-1]),
           "train_wall_s": wall, "trained_steps_s": steps / wall, "card": smi}
    print(json.dumps(out), flush=True)
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("validate_xla_offpolicy: no CUDA device", file=sys.stderr)
        return 1
    from or_gym_inventory_torch.envs import inv_management as im
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    params = im.default_params(backlog=True)
    rows = [run_row(r, params, dev, smi) for r in (argv or ROWS)]
    print(json.dumps({"validate_xla_offpolicy": rows, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
