"""Reward of recurrent PPO on the IM-backlog protocol of
tools/validate_kernel_ppo.py (its ``run_rppo_row`` rows, :75-101), on the
port and one CUDA card, evaluated on the reference's seeded protocol.

Trains, for 2M env-steps (39 updates) at seed 0, on InvManagement backlog
with 50 periods, the benchmark PPO_LSTM architecture (encoder 64, LSTM of
128) at 1,024 envs x 50, 8 env-sliced minibatches, 4 epochs:

- ``rppo_xla``: ``rollout="xla"``, the fused policy+env update (plain
  PyTorch, no kernel);
- ``rppo_kernel``: ``rollout="kernel"``, through the LSTM trajectory
  kernel (K24).

Each trained model is evaluated deterministically through
``vector.evaluate_episodes_seeded_stateful`` on 30 episodes, seeds
4000-4029 (validate_kernel_ppo.py:47-55, the reference seeds episode i
with 4000 + i), and, as chip_smoke.py phase 29 does, through the learner's
``eval_episodes`` on 64 envs. It prints one JSON line a row (the mean
returns and their standard errors, the training wall time, trained-steps/s
and the card's name and power limit) and a last line of all rows. The JAX
package's rows on a TPU (PERFORMANCE.md:686-687: xla +7,741, kernel
+8,306) are rewards over its 64-episode carry-threading evaluator, not
speeds.

    python3 tools/validate_xla_rppo.py [row ...]

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
EVAL_ENVS = 64
RECIPE = dict(num_envs=1024, rollout_steps=50, num_minibatches=8, update_epochs=4)
ROWS = ("rppo_xla", "rppo_kernel")


def mean_se(x):
    x = x.double()
    return float(x.mean()), float(x.std() / math.sqrt(x.numel()))


def run_row(row, params, dev, smi):
    import torch

    from or_gym_inventory_torch.agents import recurrent_ppo as rppo
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.vector import evaluate_episodes_seeded_stateful
    cfg = rppo.RecurrentPPOConfig(**RECIPE, rollout=row.split("_")[1])
    t0 = time.perf_counter()
    state, eval_episodes, metrics = rppo.train(
        im.ENV, params, cfg, torch.Generator(device=dev).manual_seed(SEED), BUDGET, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    agent = rppo.RecurrentPPOAgent(im.ENV, im.default_params, config=cfg, device=dev)
    agent.env_params, agent.train_state = params, state
    seeded, _ = evaluate_episodes_seeded_stateful(
        im.ENV, params, *agent.device_policy_stateful(im.ENV, params),
        torch.tensor(list(EVAL_SEEDS)), device=dev)
    carry_eval = eval_episodes(state.params, state.rms,
                               torch.Generator(device=dev).manual_seed(4000), EVAL_ENVS)
    if not (torch.isfinite(seeded).all() and torch.isfinite(carry_eval).all()):
        raise AssertionError(f"{row}: non-finite returns")
    avg, se = mean_se(seeded)
    c_avg, c_se = mean_se(carry_eval)
    steps = len(metrics["update"]) * cfg.num_envs * cfg.rollout_steps
    out = {"row": row, "rollout": cfg.rollout, "updates": len(metrics["update"]),
           "env_steps": steps, "seeded_avg_reward": avg, "seeded_se": se,
           "seeded_episodes": len(EVAL_SEEDS), "eval_episodes_avg": c_avg,
           "eval_episodes_se": c_se, "eval_envs": EVAL_ENVS, "train_wall_s": wall,
           "trained_steps_s": steps / wall, "card": smi}
    print(json.dumps(out), flush=True)
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("validate_xla_rppo: no CUDA device", file=sys.stderr)
        return 1
    from or_gym_inventory_torch.envs import inv_management as im
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    params = im.default_params(backlog=True, periods=50)
    rows = [run_row(r, params, dev, smi) for r in (argv or ROWS)]
    print(json.dumps({"validate_xla_rppo": rows, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
