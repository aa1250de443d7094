"""Reward parity of the port's learners against the JAX package's: both
packages train the same config at the same budget from several seeds, and
one evaluator, the port's seeded one, scores every trained actor on the
same demand seeds.

The rows (the learners' reference budgets):

- ``R1``: Newsvendor at ``ENV_CONFIG_EVAL`` (benchmark_newsvendor.py:35-38),
  PPO at ``PPO_CFG`` (:46-47), 4M env-steps, evaluation seeds 2000+.
- ``R2``: Newsvendor as R1, ``A2CConfig()``, 4M env-steps, seeds 2000+.
- ``R3``: InvManagement backlog with 50 periods, PPO at
  tools/validate_kernel_ppo.py's ``BASE`` (1,024 envs x 50, 8 env-sliced
  minibatches, 4 epochs), 2M env-steps, seeds 4000+.
- ``R4``: InvManagement backlog with 50 periods, recurrent PPO at
  tools/validate_xla_rppo.py's ``RECIPE`` (encoder 64, LSTM 128, 1,024 envs
  x 50), 2M env-steps, seeds 4000+.
- ``R5``, ``R6``: InvManagement backlog (30 periods), TD3 and SAC at
  tools/validate_xla_offpolicy.py's ``RECIPE`` (1,024 envs, buffer 200,704,
  batch 256, 32 updates an iteration), 2M env-steps, seeds 4000+.

A run trains one row in one package (``--package torch`` or ``jax``) on
``rollout="xla"`` / ``collect="xla"`` for each of ``--seeds``, carries a
JAX-trained actor and its obs statistics into the port
(``utils.interop``), and evaluates it deterministically through the port's
``vector.evaluate_episodes_seeded`` (the stateful form for R4) on the CPU,
``EVAL_EPISODES`` episodes from the row's seed offset. On R1 and R3 a
JAX-trained actor is also evaluated through the JAX package's own
``evaluate_episodes_seeded`` on the same seeds: the two evaluators draw the
same laws with other bits, so they should agree within 3 combined standard
errors. Each seed appends one JSON line to ``LOG``.

``--card`` trains the port on the first CUDA card (``--rollout kernel``
for the kernel path: PPO's trajectory kernels on R1 and R3, the LSTM
trajectory kernel on R4, TD3's collection kernel on R5) and evaluates on
the CPU as above; its lines carry the card's name and power limit.

``--verdict`` reads ``LOG`` (the newest line of each package and seed) and
appends one line for the row: each side's mean over training seeds, its
standard error over seeds and Welch's t of the port against the JAX
package (with ``--card``: the port's kernel path against its xla path on
the card). A gap is shown when |t| > 3; t < -3 means the port trains
worse.

    python3 tools/reward_parity.py R1 --package jax --seeds 0 1 2 3 4
    python3 tools/reward_parity.py R1 --package torch --seeds 0 1 2 3 4
    python3 tools/reward_parity.py R1 --verdict
    python3 tools/reward_parity.py R1 --card --rollout kernel --seeds 0 1 2
    python3 tools/reward_parity.py R1 --card --verdict

``--init-from-jax`` (PPO and A2C rows, the port on the CPU) starts the
port's run from the parameters the JAX package's run of the same seed
starts from, carried across: the first step of a bisection of a gap. Its
lines carry ``"init": "jax"`` and no verdict reads them.

``--log`` sends a training run's lines elsewhere (a card run writes them
under ``chiprun_out/`` and they are appended to ``LOG`` afterwards).
``--threads`` bounds each package's CPU threads (set before either package
is imported). ``--budget`` overrides the row's budget for a trial run,
whose lines are printed and not logged. The JAX package runs only on the
CPU and only with ``--package jax``.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LOG = ROOT / "tools" / "remeasure_logs" / "reward_parity.jsonl"
EVAL_EPISODES = 4096
NV_ENV_CONFIG = {"lead_time": 5, "step_limit": 50, "p_max": 100.0, "h_max": 5.0,
                 "k_max": 10.0, "mu_max": 200.0}          # benchmark_newsvendor.py:35-38
PPO_CFG = dict(num_envs=256, rollout_steps=50, num_minibatches=8, update_epochs=4,
               ent_coef=0.0)                                # benchmark_newsvendor.py:46-47
IM_PPO = dict(num_envs=1024, rollout_steps=50, num_minibatches=8, update_epochs=4,
              shuffle_minibatches=False)                    # validate_kernel_ppo.py:41-44
RPPO = dict(num_envs=1024, rollout_steps=50, num_minibatches=8,
            update_epochs=4)                                # validate_xla_rppo.py:46
OFF = dict(num_envs=1024, buffer_size=200_704, batch_size=256,
           updates_per_iter=32)                             # validate_xla_offpolicy.py:42
# row: (env, learner, budget, evaluation seed offset, JAX evaluator cross-check)
ROWS = {
    "R1": ("nv", "ppo", 4_000_000, 2000, True),
    "R2": ("nv", "a2c", 4_000_000, 2000, False),
    "R3": ("im50", "ppo", 2_000_000, 4000, True),
    "R4": ("im50", "rppo", 2_000_000, 4000, False),
    "R5": ("im30", "td3", 2_000_000, 4000, False),
    "R6": ("im30", "sac", 2_000_000, 4000, False),
}
KERNEL_ROWS = ("R1", "R3", "R4", "R5")
GAP_T = 3.0


# ------------------------------------------------------------- statistics

def seed_stats(values):
    """(mean, standard error of the mean) of per-seed values: the sample
    standard deviation (ddof 1) over sqrt(n); nan for one value."""
    n = len(values)
    mean = sum(values) / n
    if n < 2:
        return mean, float("nan")
    var = sum((v - mean) ** 2 for v in values) / (n - 1)
    return mean, math.sqrt(var / n)


def welch(a, b):
    """Welch's comparison of the means of ``a`` and ``b``: (mean a - mean b,
    the combined standard error, t, Welch-Satterthwaite degrees of
    freedom)."""
    ma, sa = seed_stats(a)
    mb, sb = seed_stats(b)
    va, vb = sa * sa, sb * sb
    se = math.sqrt(va + vb)
    dof = (va + vb) ** 2 / (va * va / (len(a) - 1) + vb * vb / (len(b) - 1))
    return ma - mb, se, (ma - mb) / se, dof


def verdict(t: float) -> str:
    """The 3-combined-SE rule on t = (port - reference) / combined SE."""
    if t < -GAP_T:
        return "gap: below"
    if t > GAP_T:
        return "gap: above"
    return "no gap shown"


# --------------------------------------------------------------- packages

class Package:
    """One package's env and agent modules under common names."""

    def __init__(self, name: str):
        import importlib
        root = "or_gym_inventory_torch" if name == "torch" else "or_gym_inventory_tpu"
        self.name = name
        for mod in ("envs.newsvendor", "envs.inv_management", "agents.ppo", "agents.a2c",
                    "agents.recurrent_ppo", "agents.off_policy", "vector.vecenv"):
            setattr(self, mod.split(".")[1], importlib.import_module(f"{root}.{mod}"))

    def env(self, row):
        """(env module, env params) of ``row``."""
        kind = ROWS[row][0]
        if kind == "nv":
            return self.newsvendor, self.newsvendor.default_params(env_config=NV_ENV_CONFIG)
        if kind == "im50":
            return self.inv_management, self.inv_management.default_params(backlog=True,
                                                                           periods=50)
        return self.inv_management, self.inv_management.default_params(backlog=True)

    def config(self, row, rollout="xla"):
        kind, learner = ROWS[row][:2]
        if learner == "ppo":
            return self.ppo.PPOConfig(**(PPO_CFG if kind == "nv" else IM_PPO), rollout=rollout)
        if learner == "a2c":
            return self.a2c.A2CConfig(rollout=rollout)
        if learner == "rppo":
            return self.recurrent_ppo.RecurrentPPOConfig(**RPPO, rollout=rollout)
        return self.off_policy.OffPolicyConfig(algo=learner, collect=rollout, **OFF)


# --------------------------------------------------------------- training

def jax_initial_params(row: str, seed: int, budget: int):
    """The state dict of the parameters the JAX package's run of ``row``
    starts from at ``seed`` (PPO and A2C rows), for the port's model."""
    import jax
    import numpy as np

    from or_gym_inventory_torch.utils import interop
    jpkg = Package("jax")
    mod, params = jpkg.env(row)
    cfg = jpkg.config(row)
    tree = jpkg.ppo.init_train_state(mod.ENV, params, cfg, jax.random.PRNGKey(seed),
                                     cfg.num_updates(budget)).params
    return interop.ppo_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                         device="cpu")


def train_torch(port: Package, row: str, seed: int, budget: int, rollout: str, dev,
                init=None):
    """Train the port, from the state dict ``init`` when it is given;
    returns (actor module, RunningMeanStd) on the CPU and the run's facts."""
    import torch
    learner = ROWS[row][1]
    mod, params = port.env(row)
    cfg = port.config(row, rollout)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    if learner in ("ppo", "a2c"):
        make_model = port.ppo._make_model

        def from_init(*args, **kw):
            model = make_model(*args, **kw)
            model.load_state_dict(init)
            return model

        if init is not None:
            port.ppo._make_model = from_init
        try:
            state, metrics = port.ppo.train(mod.ENV, params, cfg, gen, budget, device=dev)
        finally:
            port.ppo._make_model = make_model
        actor, steps = state.params, len(metrics["update"]) * cfg.num_envs * cfg.rollout_steps
    elif learner == "rppo":
        state, _, metrics = port.recurrent_ppo.train(mod.ENV, params, cfg, gen, budget,
                                                     device=dev)
        actor, steps = state.params, len(metrics["update"]) * cfg.num_envs * cfg.rollout_steps
    else:
        state, _, metrics = port.off_policy.train(mod.ENV, params, cfg, gen, budget,
                                                  log_every=200, device=dev)
        actor, steps = state.actor_params, int(metrics["timesteps"][-1])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rms = port.ppo.RunningMeanStd(mean=state.rms.mean.cpu(), var=state.rms.var.cpu(),
                                  count=state.rms.count.cpu())
    facts = {"env_steps": steps, "train_wall_s": wall,
             "last_mean_step_reward": float(metrics["mean_step_reward"][-1])}
    return copy.deepcopy(actor).cpu(), rms, facts


def train_jax(jpkg: Package, port: Package, row: str, seed: int, budget: int):
    """Train the JAX package on the CPU; returns its actor carried into the
    port (module, RunningMeanStd), the run's facts and, on rows with the
    cross-check, the JAX evaluator's totals on the row's seeds."""
    import jax
    import numpy as np

    from or_gym_inventory_torch.utils import interop
    learner, _, offset, cross = ROWS[row][1:]
    mod, params = jpkg.env(row)
    cfg = jpkg.config(row)
    key = jax.random.PRNGKey(seed)
    t0 = time.perf_counter()
    if learner in ("ppo", "a2c", "rppo"):
        train = jpkg.recurrent_ppo.train if learner == "rppo" else jpkg.ppo.train
        out = train(mod.ENV, params, cfg, key, budget)
        state, metrics = out[0], out[-1]
        tree = state.params
        steps = len(metrics["update"]) * cfg.num_envs * cfg.rollout_steps
    else:
        state, _, metrics = jpkg.off_policy.train(mod.ENV, params, cfg, key, budget,
                                                  log_every=200)
        tree = state.actor_params
        steps = int(metrics["timesteps"][-1])
    jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    facts = {"env_steps": steps, "train_wall_s": wall,
             "last_mean_step_reward": float(metrics["mean_step_reward"][-1])}
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    rms = interop.rms_from_numpy(np.asarray(state.rms.mean), np.asarray(state.rms.var),
                                 np.asarray(state.rms.count), device="cpu")
    actor = empty_actor(port, row)
    if learner in ("ppo", "a2c"):
        actor.load_state_dict(interop.ppo_params_from_numpy(np_tree, device="cpu"))
    elif learner == "rppo":
        actor.load_state_dict(interop.lstm_params_from_numpy(np_tree, device="cpu"))
    else:
        q_tree = jax.tree_util.tree_map(np.asarray, state.q_params)
        actor.load_state_dict(interop.offpolicy_params_from_numpy(
            np_tree, q_tree, learner == "sac", device="cpu")[0])
    jax_totals = None
    if cross:
        policy = jpkg.ppo.make_eval_policy(mod.ENV, params, cfg, deterministic=True)
        seeds = jax.numpy.asarray(offset + np.arange(EVAL_EPISODES), jax.numpy.uint32)
        jax_totals, _ = jpkg.vecenv.evaluate_episodes_seeded(mod.ENV, params, policy,
                                                             (state.params, state.rms), seeds)
        jax_totals = np.asarray(jax_totals, np.float64)
    return actor, rms, facts, jax_totals


def empty_actor(port: Package, row: str):
    """The port's actor module of ``row`` on the CPU, to load weights into."""
    import numpy as np
    import torch
    learner = ROWS[row][1]
    mod, params = port.env(row)
    cfg = port.config(row)
    gen = torch.Generator().manual_seed(0)
    if learner in ("ppo", "a2c"):
        return port.ppo._make_model(mod.ENV, params, cfg, gen)
    if learner == "rppo":
        return port.recurrent_ppo._make_model(mod.ENV, params, cfg, gen)
    obs_dim = int(mod.ENV.observation_space(params).shape[0])
    act_dim = int(np.prod(mod.ENV.action_space(params).shape))
    return port.off_policy._Actor(obs_dim, act_dim, cfg.pi_arch, learner == "sac", gen)


# ------------------------------------------------------------- evaluation

def evaluate(port: Package, row: str, actor, rms):
    """Totals (float64 NumPy) of ``actor`` over the row's EVAL_EPISODES
    seeds through the port's seeded evaluator on the CPU."""
    import numpy as np
    import torch
    learner, _, offset = ROWS[row][1:4]
    mod, params = port.env(row)
    cfg = port.config(row)
    cpu = torch.device("cpu")
    seeds = torch.arange(offset, offset + EVAL_EPISODES)
    if learner == "rppo":
        policy = port.recurrent_ppo._stateful_policy(mod.ENV, params, cfg, actor, rms, cpu)
        totals, _ = port.vecenv.evaluate_episodes_seeded_stateful(
            mod.ENV, params, lambda n: actor.initial_carry(n, device=cpu), policy, seeds,
            device=cpu)
    else:
        if learner in ("ppo", "a2c"):
            policy = port.ppo.make_eval_policy(mod.ENV, params, cfg, deterministic=True)
        else:
            policy = port.off_policy.make_offpolicy(mod.ENV, params, cfg, device=cpu)[2]
        totals, _ = port.vecenv.evaluate_episodes_seeded(mod.ENV, params, policy,
                                                         (actor, rms), seeds, device=cpu)
    totals = totals.double().numpy()
    if not np.isfinite(totals).all():
        raise AssertionError(f"{row}: non-finite returns")
    return totals


def episode_stats(totals):
    n = totals.shape[0]
    return float(totals.mean()), float(totals.std(ddof=1) / math.sqrt(n))


# ----------------------------------------------------------------- records

def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def append(line: dict, log: pathlib.Path = LOG):
    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)


def read_seed_lines(row: str, card: bool):
    """The newest full-budget line of each (package, path, seed) of ``row``:
    on the CPU (``card`` False) or on a card."""
    if not LOG.exists():
        return {}
    newest = {}
    for text in LOG.read_text().splitlines():
        line = json.loads(text)
        if (line.get("kind") != "seed" or line["row"] != row or "init" in line
                or (line["device"] != "cpu") != card):
            continue
        newest[(line["package"], line["path"], line["seed"])] = line
    return newest


def row_verdict(row: str, card: bool) -> dict:
    """The row's line: each side's per-seed means, their mean and SE over
    seeds, and Welch's t of the port (or, on the card, its kernel path)
    against the reference side."""
    lines = read_seed_lines(row, card)
    if card:
        sides = {"kernel": ("torch", "kernel"), "xla": ("torch", "xla")}
        test, ref = "kernel", "xla"
    else:
        sides = {"torch": ("torch", "xla"), "jax": ("jax", "xla")}
        test, ref = "torch", "jax"
    out = {"kind": "row", "row": row, "device": "card" if card else "cpu",
           "budget": ROWS[row][2], "evaluator": "port vector.evaluate_episodes_seeded"
           + ("_stateful" if ROWS[row][1] == "rppo" else "") + " on the CPU",
           "eval_seeds": [ROWS[row][3], ROWS[row][3] + EVAL_EPISODES]}
    per = {}
    for side, (pkg, path) in sides.items():
        picked = sorted((k[2], v) for k, v in lines.items() if k[:2] == (pkg, path))
        per[side] = [v["eval"]["mean"] for _, v in picked]
        mean, se = seed_stats(per[side]) if per[side] else (float("nan"), float("nan"))
        out[side] = {"package": pkg, "path": path, "seeds": [s for s, _ in picked],
                     "means": per[side], "mean": mean, "se": se}
        if card and picked and picked[0][1].get("card"):
            out["card"] = picked[0][1]["card"]
    if len(per[test]) >= 2 and len(per[ref]) >= 2:
        diff, se, t, dof = welch(per[test], per[ref])
        out.update(diff=diff, combined_se=se, t=t, dof=dof, verdict=verdict(t))
    return out


# -------------------------------------------------------------------- main

def set_threads(n: int):
    """Bound both packages' CPU threads; call before importing either."""
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_cpu_multi_thread_eigen=false"
                               f" intra_op_parallelism_threads={n}").strip()
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(n)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("row", choices=sorted(ROWS))
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--card", action="store_true", help="train the port on CUDA card 0")
    ap.add_argument("--rollout", choices=("xla", "kernel"), default="xla")
    ap.add_argument("--budget", type=int, default=None, help="a trial run's budget")
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--note", default=None, help="a remark kept on each line")
    ap.add_argument("--init-from-jax", action="store_true",
                    help="start the port from the JAX run's initial parameters")
    ap.add_argument("--verdict", action="store_true")
    ap.add_argument("--log", type=pathlib.Path, default=LOG,
                    help="where a training run appends its lines (a card run: under "
                         "chiprun_out/, to be merged into LOG)")
    args = ap.parse_args(argv)
    if args.verdict:
        append(row_verdict(args.row, args.card))
        return 0
    if args.package == "jax" and (args.card or args.rollout != "xla"):
        ap.error("the JAX package trains only on the CPU, on its xla path")
    if args.rollout == "kernel" and (not args.card or args.row not in KERNEL_ROWS):
        ap.error(f"the kernel path runs on the card, on rows {KERNEL_ROWS}")
    if args.init_from_jax and (args.package != "torch" or args.card
                               or ROWS[args.row][1] not in ("ppo", "a2c")):
        ap.error("--init-from-jax starts the port on the CPU, on a PPO or A2C row")
    if args.threads:
        set_threads(args.threads)
    if args.package == "jax" or args.init_from_jax:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import torch
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.card and not torch.cuda.is_available():
        print("reward_parity: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    port = Package("torch")
    jpkg = Package("jax") if args.package == "jax" else None
    dev = torch.device("cuda", 0) if args.card else torch.device("cpu")
    budget = args.budget or ROWS[args.row][2]
    card = card_name() if args.card else None
    for seed in args.seeds:
        if jpkg is not None:
            actor, rms, facts, jax_totals = train_jax(jpkg, port, args.row, seed, budget)
        else:
            init = jax_initial_params(args.row, seed, budget) if args.init_from_jax else None
            actor, rms, facts = train_torch(port, args.row, seed, budget, args.rollout, dev,
                                            init)
            jax_totals = None
        t0 = time.perf_counter()
        mean, se = episode_stats(evaluate(port, args.row, actor, rms))
        line = {"kind": "seed", "row": args.row, "package": args.package,
                "path": args.rollout, "device": "cuda" if args.card else "cpu",
                "seed": seed, "budget": budget, **facts,
                "eval": {"mean": mean, "se": se, "episodes": EVAL_EPISODES,
                         "first_seed": ROWS[args.row][3],
                         "wall_s": time.perf_counter() - t0},
                "torch": torch.__version__, "threads": torch.get_num_threads(),
                "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
        if jax_totals is not None:
            j_mean, j_se = episode_stats(jax_totals)
            z = (mean - j_mean) / math.sqrt(se * se + j_se * j_se)
            line["jax_evaluator"] = {"mean": j_mean, "se": j_se, "z": z,
                                     "agree": abs(z) <= GAP_T}
        if card:
            line["card"] = card
        if args.init_from_jax:
            line["init"] = "jax"
        if args.note:
            line["note"] = args.note
        if budget != ROWS[args.row][2]:
            line["trial"] = True
            print(json.dumps(line), flush=True)
        else:
            append(line, args.log)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
