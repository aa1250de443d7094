"""Reward of the Newsvendor learners of benchmarks/benchmark_newsvendor.py
on the port's fused policy+env update (``rollout="xla"``), on one CUDA card.

Trains, for the benchmark's 4M env-steps (RESULTS.md:56) on its
ENV_CONFIG_EVAL (lead time 5, 50 periods, mu_max 200), seed 0:

- ``ppo_xla``: PPO at the benchmark's PPO_CFG (256 envs x 50, 8
  minibatches, 4 epochs, ent_coef 0; benchmark_newsvendor.py:46-47);
- ``a2c_xla``: ``A2CConfig()`` (256 envs x 8, one minibatch, RMSprop),
  the benchmark's A2C row;
- ``ppo_kernel``: PPO_CFG on ``rollout="kernel"`` (K18), for a comparison
  within one call.

Each trained actor is evaluated deterministically by
``vector.fast_episodes.policy_episode_returns`` (K19) over 65,536 lanes x
16 episodes, as chip_smoke.py phase 24 evaluates the kernel path; the
random policy's mean return comes from ``random_episode_returns`` (K16) on
the same shape. It prints one JSON line a row (the mean return, its
standard error, the training wall time, trained-steps/s and the card's name
and power limit) and a last line of all rows. The JAX package's rows on a
TPU (RESULTS.md:63 PPO +97,569, :66 A2C -30,813) are rewards over 30
seeded episodes, not speeds, and another evaluator.

    python3 tools/validate_xla_ppo.py [row ...]

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
BUDGET = 4_000_000
EVAL_LANES, EVAL_EPISODES = 65_536, 16
ENV_CONFIG = {"lead_time": 5, "step_limit": 50, "p_max": 100.0, "h_max": 5.0,
              "k_max": 10.0, "mu_max": 200.0}      # benchmark_newsvendor.py:35-38
PPO_CFG = dict(num_envs=256, rollout_steps=50, num_minibatches=8, update_epochs=4,
               ent_coef=0.0)                      # benchmark_newsvendor.py:46-47
ROWS = ("ppo_xla", "a2c_xla", "ppo_kernel")


def config(row):
    from or_gym_inventory_torch.agents import a2c, ppo
    if row == "a2c_xla":
        return a2c.A2CConfig()
    return ppo.PPOConfig(**PPO_CFG, rollout="kernel" if row == "ppo_kernel" else "xla")


def mean_se(x):
    x = x.double()
    return float(x.mean()), float(x.std() / math.sqrt(x.numel()))


def run_row(row, params, dev, smi):
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.vector import fast_episodes
    cfg = config(row)
    t0 = time.perf_counter()
    state, metrics = ppo.train(nv.ENV, params, cfg,
                               torch.Generator(device=dev).manual_seed(SEED), BUDGET,
                               device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    actor = ek.fold_actor_params(cfg, state.params, state.rms)
    ret = fast_episodes.policy_episode_returns(
        params, actor, torch.Generator(device=dev).manual_seed(2000), EVAL_LANES,
        EVAL_EPISODES, True, None, dev)
    if not torch.isfinite(ret).all():
        raise AssertionError(f"{row}: non-finite returns")
    avg, se = mean_se(ret)
    steps = len(metrics["update"]) * cfg.num_envs * cfg.rollout_steps
    out = {"row": row, "rollout": cfg.rollout, "num_envs": cfg.num_envs,
           "rollout_steps": cfg.rollout_steps, "updates": len(metrics["update"]),
           "env_steps": steps, "avg_return": avg, "return_se": se,
           "eval_episodes": ret.numel(), "train_wall_s": wall,
           "trained_steps_s": steps / wall, "card": smi}
    print(json.dumps(out), flush=True)
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("validate_xla_ppo: no CUDA device", file=sys.stderr)
        return 1
    from or_gym_inventory_torch.envs import newsvendor as nv
    from or_gym_inventory_torch.vector import fast_episodes
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    params = nv.default_params(env_config=ENV_CONFIG)
    rand = fast_episodes.random_episode_returns(
        params, torch.Generator(device=dev).manual_seed(2000), EVAL_LANES,
        episodes_per_lane=EVAL_EPISODES, device=dev)
    r_avg, r_se = mean_se(rand)
    print(json.dumps({"row": "random", "avg_return": r_avg, "return_se": r_se,
                      "eval_episodes": rand.numel(), "card": smi}), flush=True)
    rows = [run_row(r, params, dev, smi) for r in (argv or ROWS)]
    print(json.dumps({"validate_xla_ppo": rows, "random_avg_return": r_avg, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
