#!/usr/bin/env python3
"""Smoke run of the PyTorch port (or_gym_inventory_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc (one process per source, all
at once), then drives the port's four main paths, each with every launch
counter set to 0 just before it and read just after:

- slice 1, NetInvMgmt random-policy episode returns (phases 3-4): what
  bench.py does on the JAX package, a cross-check of the fused kernel on its
  own dumped streams followed by random-policy returns of the default graph
  at 4,194,304 lanes x 16 episodes x 30 periods, through
  ``vector.fast_episodes.random_episode_returns``;
- slice 2, NetInvMgmt PPO and learned-policy evaluation (phase 8):
  ``agents.ppo.train`` with ``rollout="kernel"`` at 65,536 envs x 30
  periods, the default 64x64 tanh actor-critic, 4 epochs x 8 minibatches,
  3 updates, then ``policy_episode_returns`` of the trained actor at
  65,536 x 16, deterministic and stochastic. After the counts are read, the
  deterministic returns of the first 1,024 lanes are held against plain K5;
- slice 3, InvManagement random-policy returns (phase 11):
  ``random_episode_returns`` with ``inv_management.default_params()`` at
  4,194,304 x 16 x 30 launches K8 once, nothing else and no plain version
  (K9 and K7 are held on the same seed's streams before the count);
- slice 3, InvManagement PPO (phase 13): ``train`` with ``rollout="kernel"``
  at 65,536 x 30, 64x64 (obs_dim 33, act_dim 3), 4 epochs x 8 minibatches,
  3 updates: 3 launches of K10 and no plain version.

Every kernel output on those paths is held against the kernel's plain
PyTorch version on the same inputs: K1-K3 in phases 3-4, K4-K6 in phase 7
(at the main path's shapes, with a seeded actor whose obs statistics are
folded into layer 1), which also holds the NaN propagation of the shared
step, K7-K9 in phase 10 for all five demand modes in backlog and lost
sales, and K10 in phase 12 (with the env step chain on its streams and a
NaN std). Three kernels are on no main path and are launched only to be
held: K6, K5 with its streams dumped (phase 7), K9 and K7, the streams and
the stream-in replay of K8's draws (phases 10-12). Then it times the vecenv rollout (phase
5), each kernel against its plain version (phases 6, 9 and 14), one PPO
update with its gradient in 8 chunks per minibatch against 1 (phase 9),
and trains InvManagement at the protocol of tools/validate_kernel_ppo.py
for its reward (phase 15). Every phase prints its lines; any failure raises
and exits non-zero. Without a CUDA device it exits 1 and prints no result.

The last five lines are one JSON object of per-kernel numbers
(``launches`` is the sum of a kernel's launches in the four main-path runs,
so 0 for K6, K7 and K9; for K4, K5 and K10, ``max_abs_err`` is over the lanes that
agree with the plain version), one JSON object of the NetInvMgmt PPO path's
rates, one of the InvManagement paths' rates and reward, the card's name
and power limit as nvidia-smi gives them, and
``{"ok": true, "device": {...}}``.

Tolerances: streams of draws (actions of K3 and K9, demand of K3, K4, K6,
K9 and K10) bit for bit; the InvManagement int32 state of the env step
chain against K10's inv exactly; K1-K3 and K7-K8 against their plain
versions, the fused kernels against the stream-in kernels, and the
stream-in kernels on K4/K6/K10's streams against their rewards and K5's
returns, rtol=1e-5 atol=1e-3 (f32 sums in another order, FMA contraction);
the env step chain against the stream-in kernel and K4/K10's reward
streams rtol=1e-4 atol=1e-2 (bench.py:156); K4's raws against the folded
actor on the assembled obs plus the plain normals atol=1e-4 (matmul sums
in another order, an ulp of logf/cosf); K4-K6 and K10 free-running against
their plain versions: at least 99% of lanes agree over the whole episode
within rtol=1e-4 atol=1e-2, since a rounding tie in rint (NetInvMgmt) or a
truncation boundary (InvManagement) lets a lane take the other integer and
diverge (the fraction-closeness rule, ROADMAP.md Queue C).
"""

import json
import math
import subprocess
import sys
import time

NUM_STEPS = 30
MAIN_LANES = 4_194_304       # bench.py NUM_ENVS_PALLAS
MAIN_EPISODES = 16           # bench.py EPISODES_PER_LANE
CHECK_LANES = 65_536         # cross-check size, and the K1/K3 main-path shape
MULTI_LANES = 1_024          # bench.py:115, E=16 dumped in ranges of 8
ROLLOUT_ENVS = 262_144       # bench.py NUM_ENVS_XLA
SEED = 2024
PPO_ENVS = 65_536            # the PPO main path: envs x 30 periods per update
PPO_UPDATES = 3
EVAL_EPISODES = 16           # policy evaluation: PPO_ENVS lanes x 16 episodes
LANE_SHARE = 0.99            # free-running policy kernels vs plain

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet; FP32 outside
# the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

KERNEL_ROWS = [  # wrapper, source, the Pallas entry it replaces
    ("episode_returns", "or_gym_inventory_torch/csrc/net_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:820"),
    ("episode_returns_fully_fused", "or_gym_inventory_torch/csrc/net_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:379"),
    ("sample_streams_debug", "or_gym_inventory_torch/csrc/net_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:427"),
    ("rollout_traj_net", "or_gym_inventory_torch/csrc/net_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:683"),
    ("episode_returns_net_policy", "or_gym_inventory_torch/csrc/net_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:611"),
    ("sample_policy_streams_debug_net", "or_gym_inventory_torch/csrc/net_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_net_step.py:756"),
    ("episode_returns_im", "or_gym_inventory_torch/csrc/im_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:779"),
    ("episode_returns_im_fused", "or_gym_inventory_torch/csrc/im_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:919"),
    ("sample_streams_debug_im", "or_gym_inventory_torch/csrc/im_episode.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1873"),
    ("rollout_traj_im", "or_gym_inventory_torch/csrc/im_policy.cu",
     "or_gym_inventory_tpu/ops/pallas_episode_kernels.py:1683"),
]
IM_KERNELS = [name for name, _, _ in KERNEL_ROWS[6:]]
# the five demand modes of InvManagement (inventory_management.py:169-184)
IM_DIST_MODES = [
    ("poisson", {}),
    ("binomial", {"dist": 2, "dist_param": {"n": 40, "p": 0.5}}),
    ("randint", {"dist": 3, "dist_param": {"low": 10, "high": 30}}),
    ("geometric", {"dist": 4, "dist_param": {"p": 0.05}}),
    ("user", {"dist": 5, "user_D": tuple((7 * t) % 41 for t in range(NUM_STEPS))}),
]


def close(name, got, want, rtol, atol):
    """Max |got - want|; raises unless every element is within tolerance."""
    import torch
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {int(bad.sum())} of {got.numel()} elements "
                             f"outside rtol={rtol} atol={atol}; max |diff| "
                             f"{float(err.max()):.6g}")
    return float(err.max())


def exact(name, got, want):
    if not (got.shape == want.shape and bool((got == want).all())):
        raise AssertionError(f"{name}: streams differ from the plain Philox twin")


def lane_share(name, got, want, rtol=1e-4, atol=1e-2):
    """(share of lanes, last axis, on which every element of ``got`` is
    within tolerance of ``want``; max |diff| over those lanes). Raises below
    LANE_SHARE or on a non-finite value."""
    import torch
    err = (got.double() - want.double()).abs()
    ok = (err <= atol + rtol * want.double().abs()).reshape(-1, got.shape[-1]).all(0)
    share = float(ok.double().mean())
    if share < LANE_SHARE or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: {share:.4%} of lanes within rtol={rtol} "
                             f"atol={atol}, need {LANE_SHARE:.0%}")
    return share, float(err.reshape(-1, got.shape[-1])[:, ok].max())


# ------------------------------------------------------------- work model

def step_ops(T):
    """Arithmetic operations of one period of step_period in
    csrc/net_episode.cu for topology T, an FMA counted as two."""
    ops = 2 * T.n_main + 7 * T.n_retail + 5 * T.n_retail + 2  # X update, retail, profit, discount
    for i, L in enumerate(T.ro_L):
        sup = T.ro_sup_main[i]
        ops += 2                                   # rint, max
        if sup >= 0:
            ops += 5 + (3 if T.is_factory[sup] else 0)  # avail, cap, min, div, add
            ops += 2                               # SR, sold
        ops += 3 + (2 if L > 0 else 0)             # Y, arrivals, ring slot
        ops += 1 + 1 + 3                           # rev, PC, max + FMA into HCp
    for n in range(T.n_main):
        ops += 3 + (3 if T.is_factory[n] else 0) + 5  # HC, OC, node total
    return ops


def draw_ops(T, link_specs):
    """Operations of draw_period in csrc/net_step.cuh for one period: the
    Philox blocks, the word conversions, and for each table link the binary
    search this table needs."""
    words = T.n_reorder + T.n_retail
    ops = math.ceil(words / 4) * (10 * 8 + 9 * 2) + 3 * words
    for spec in link_specs:
        if spec[0] == "table":
            ops += 4 * math.ceil(math.log2(len(spec[2]) + 1)) + 2
        else:
            ops += 1
    return ops


def mlp_ops(dims):
    """Operations of one forward pass of the folded actor in
    csrc/net_policy.cu: an FMA per weight counted as two, a bias add per
    output, a tanh per hidden output (transcendentals counted as one)."""
    ops = sum(2 * a * b + b for a, b in zip(dims, dims[1:]))
    return ops + sum(dims[1:-1])


def policy_draw_ops(T, link_specs, stochastic):
    """Operations of one period's draws of the policy kernels: the Philox
    blocks, the word conversions, each table link's binary search, and per
    action the Box-Muller normal (log, sqrt, cos and five arithmetic ops)
    when stochastic, plus the squash (tanh, add, multiply)."""
    words = T.n_retail + (2 * T.n_reorder if stochastic else 0)
    ops = math.ceil(words / 4) * (10 * 8 + 9 * 2) + 3 * words
    for spec in link_specs:
        ops += 4 * math.ceil(math.log2(len(spec[2]) + 1)) + 2 if spec[0] == "table" else 1
    return ops + T.n_reorder * ((8 if stochastic else 0) + 3)


def im_step_ops(params):
    """Operations of one period of im_step in csrc/im_step.cuh for params
    with m1 stocked stages: per stage the order (max, add, two min), the
    arrival (compare, slot, add), the decrement, the history store; per
    stage of m1 + 1 the profit (two products, two sums, two casts), the
    holding term (max, cast, product, sum) and the backlog; the retail
    sale, the slot and the discount."""
    m1 = params.m1
    return 4 * m1 + 3 * m1 + (m1 - 1) + m1 + 7 * (m1 + 1) + 4 * m1 + 4 + 2 + 2


def im_draw_ops(params, table_len):
    """Operations of one period's random-policy draws (im_draw_actions,
    im_demand): the Philox blocks of m1 + 1 words, the word conversions,
    per action a product, a cast and a min, and the binary search of this
    table (one load for USER mode)."""
    words = params.m1 + 1
    ops = math.ceil(words / 4) * (10 * 8 + 9 * 2) + 3 * words + 3 * params.m1
    return ops + (4 * math.ceil(math.log2(table_len + 1)) + 2 if table_len else 1)


def im_policy_draw_ops(params, table_len):
    """Operations of one period's draws and head in K10: the Philox blocks of
    1 + 2 m1 words, the conversions, the demand's binary search, the obs
    (m1 (lt + 1) casts), and per action the Box-Muller normal (log, sqrt,
    cos and five arithmetic ops), the sample and the squash (tanh, add,
    product, cast)."""
    m1 = params.m1
    words = 1 + 2 * m1
    ops = math.ceil(words / 4) * (10 * 8 + 9 * 2) + 3 * words
    ops += 4 * math.ceil(math.log2(table_len + 1)) + 2 if table_len else 1
    return ops + m1 * (params.lt_max + 1) + m1 * (8 + 2 + 4)


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases

def reset_counts(wrappers):
    for ws in wrappers.values():
        for w in ws:
            w.launches = 0


def read_counts(wrappers):
    """Launches per kernel row: the sum over the row's wrappers (K7 has two,
    ``episode_returns_im`` and ``episode_returns_im_random``)."""
    return {name: sum(w.launches for w in ws) for name, ws in wrappers.items()}


class no_plain_versions:
    """Within the block, every plain version of K1-K10 raises, so a counted
    main-path run shows that it went through the kernels alone."""

    NAMES = {"net_step": ("_episode_returns_plain", "_episode_returns_fully_fused_plain",
                          "_sample_streams_plain", "_rollout_traj_plain",
                          "_policy_returns_plain"),
             "episode_kernels": ("_episode_returns_im_plain", "_im_fused_plain",
                                 "_rollout_traj_im_plain")}

    def __enter__(self):
        import importlib

        def refuse(*_a, **_k):
            raise AssertionError("a plain version ran on the counted main path")

        self.saved = []
        for mod_name, names in self.NAMES.items():
            mod = importlib.import_module(f"or_gym_inventory_torch.ops.{mod_name}")
            for n in names:
                self.saved.append((mod, n, getattr(mod, n)))
                setattr(mod, n, refuse)

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)


def timed_once(fn, *args):
    """(milliseconds between CUDA events around one call, its result)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def cross_check(params, dev):
    """Phase 3, the main path's cross-check (bench.py:79-161): the fused
    kernel against the stream-in kernel on its own dumped streams, at one
    episode per lane and at E=16 dumped in ranges of 8, and the env step
    chain on the same streams. Every kernel output is also held against its
    plain version on the same inputs. Returns the max |diff| per kernel and
    the streams, which phase 6 times the kernels on."""
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import net_step as ns
    hi = float(params.topology.order_cap_heuristic * 2)
    err = {}

    acts, dems = ns.sample_streams_debug(params, SEED, hi, CHECK_LANES, device=dev)
    pa, pd = ns._sample_streams_plain(params, SEED, hi, CHECK_LANES, NUM_STEPS, 0, 1, dev)
    exact("K3 actions", acts, pa.reshape(acts.shape))
    exact("K3 demands", dems, pd.reshape(dems.shape))
    err["sample_streams_debug"] = 0.0
    k1 = ns.episode_returns(params, acts, dems)
    err["episode_returns"] = close("K1 vs plain K1", k1,
                                   ns._episode_returns_plain(params, acts, dems),
                                   1e-5, 1e-3)
    k2 = ns.episode_returns_fully_fused(params, SEED, hi, CHECK_LANES, device=dev)
    close("K2 vs K1 on K3's streams", k2, k1, 1e-5, 1e-3)
    err["episode_returns_fully_fused"] = close(
        "K2 vs plain K2", k2, ns._episode_returns_fully_fused_plain(
            params, SEED, hi, CHECK_LANES, NUM_STEPS, 1, dev)[0], 1e-5, 1e-3)

    E = MAIN_EPISODES
    multi = ns.episode_returns_fully_fused(params, SEED, hi, MULTI_LANES,
                                           episodes_per_lane=E, device=dev)
    plain_multi = ns._episode_returns_fully_fused_plain(params, SEED, hi, MULTI_LANES,
                                                        NUM_STEPS, E, dev)
    err["episode_returns_fully_fused"] = max(
        err["episode_returns_fully_fused"],
        close("K2 vs plain K2, E=16", multi, plain_multi, 1e-5, 1e-3))
    for e0 in range(0, E, 8):
        a_e, d_e = ns.sample_streams_debug(params, SEED, hi, MULTI_LANES,
                                           episodes_per_lane=E, dump_range=(e0, e0 + 8),
                                           device=dev)
        pa_e, pd_e = ns._sample_streams_plain(params, SEED, hi, MULTI_LANES, NUM_STEPS,
                                              e0, e0 + 8, dev)
        exact(f"K3 actions, episodes [{e0}, {e0 + 8})", a_e, pa_e)
        exact(f"K3 demands, episodes [{e0}, {e0 + 8})", d_e, pd_e)
        for e in range(e0, e0 + 8):
            per = ns.episode_returns(params, a_e[:, e - e0].contiguous(),
                                     d_e[:, e - e0].contiguous())
            close(f"K2 episode {e} vs K1", multi[e], per, 1e-5, 1e-3)

    state, _ = net.reset(params, batch=CHECK_LANES, device=dev)
    chain = torch.zeros(CHECK_LANES, dtype=torch.float32, device=dev)
    for t in range(NUM_STEPS):
        state, ts = net.step_with_demand(params, state, acts[t].T, dems[t].T)
        chain = chain + ts.reward
    close("env step chain vs K1", chain, k1, 1e-4, 1e-2)
    torch.cuda.synchronize()
    return err, acts, dems


def episode_returns_at_scale(params, dev, err):
    """Phase 4, random-policy returns at the operating point through
    ``random_episode_returns``, held element by element against plain K2 on
    the same seed. Returns the plain version's milliseconds."""
    import torch

    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.vector import fast_episodes
    gen = torch.Generator(device=dev).manual_seed(0)
    replay = torch.Generator(device=dev)
    replay.set_state(gen.get_state())
    ret = fast_episodes.random_episode_returns(params, gen, MAIN_LANES,
                                               episodes_per_lane=MAIN_EPISODES,
                                               device=dev)
    torch.cuda.synchronize()
    if ret.shape != (MAIN_LANES * MAIN_EPISODES,):
        raise AssertionError(f"main path: returns of shape {tuple(ret.shape)}")
    hi = float(params.topology.order_cap_heuristic * 2)
    plain_ms, plain = timed_once(ns._episode_returns_fully_fused_plain, params,
                                 fast_episodes.kernel_seed(replay), hi, MAIN_LANES,
                                 NUM_STEPS, MAIN_EPISODES, dev)
    err["episode_returns_fully_fused"] = max(
        err["episode_returns_fully_fused"],
        close("main path: K2 vs plain K2", ret, plain.reshape(-1), 1e-5, 1e-3))
    mean = float(ret.double().mean())
    del ret, plain
    return mean, plain_ms


def seeded_actor(obs_dim, act_dim, dev):
    """Phases 7 and 12's actor: the default 64x64 actor-critic of
    (obs_dim, act_dim) drawn from its own initialisation, and obs statistics
    with mean ~50 and std ~20 folded into its first layer. Returns (folded
    actor, log_std), on ``dev``."""
    import torch

    from or_gym_inventory_torch.agents import networks, ppo
    from or_gym_inventory_torch.ops import episode_kernels as ek
    g = torch.Generator().manual_seed(SEED)
    model = networks.MLPActorCritic(obs_dim, act_dim, generator=g)
    rms = ppo.RunningMeanStd(mean=50.0 + 5.0 * torch.randn(obs_dim, generator=g),
                             var=(20.0 + 5.0 * torch.rand(obs_dim, generator=g)) ** 2,
                             count=torch.tensor(1e3))
    Ws, bs = ek.fold_actor_params(ppo.PPOConfig(), model, rms)
    actor = (tuple(W.to(dev) for W in Ws), tuple(b.to(dev) for b in bs))
    return actor, model.log_std.detach().to(dev)


def policy_cross_check(params, dev, actor, log_std):
    """Phase 7: K4-K6 against their plain versions at the main path's shapes
    (65,536 lanes x 30 periods; K5/K6 at 16 episodes per lane,
    deterministic and stochastic), K4's streams replayed teacher-forced
    through K1, the env step chain and the folded actor, and the NaN lane
    of the shared step. Returns (max |diff| per kernel, plain ms per
    kernel)."""
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.ops import rng
    T = params.topology
    B, E = CHECK_LANES, EVAL_EPISODES
    std = ek.clipped_std(log_std)
    err, plain_ms, lines = {}, {}, []

    # K4, free-running against its plain version
    tr = ns.rollout_traj_net(params, actor, log_std, SEED, B, device=dev)
    plain_ms["rollout_traj_net"], want = timed_once(
        ns._rollout_traj_plain, params, actor, std, SEED, B, dev)
    exact("K4 demand", tr["demand"], want["demand"])
    shares = {k: lane_share(f"K4 {k} vs plain", tr[k], want[k]) for k in tr}
    err["rollout_traj_net"] = max(e for _, e in shares.values())
    lines.append("K4 vs plain: lanes agreeing " + ", ".join(
        f"{k} {sh:.4%}" for k, (sh, _) in shares.items()))
    del want

    # K4, teacher-forced: its own streams through K1, the step chain, the actor
    acts = (torch.tanh(tr["raw"]) + 1.0) * ns._half_hi(T)
    close("K1 on K4's streams vs K4 rewards",
          ns.episode_returns(params, acts.contiguous(), tr["demand"]),
          tr["reward"].sum(0), 1e-5, 1e-3)
    state, _ = net.reset(params, batch=B, device=dev)
    for t in range(NUM_STEPS):
        close(f"step chain X[{t}] vs K4 x", state.X.T, tr["x"][t], 1e-4, 1e-2)
        close(f"step chain U[{t}] vs K4 u", state.U.T, tr["u"][t], 1e-4, 1e-2)
        state, ts = net.step_with_demand(params, state, acts[t].T, tr["demand"][t].T)
        close(f"step chain r[{t}] vs K4 r", ts.info["fulfilled_orders"].T, tr["r"][t],
              1e-4, 1e-2)
    close("step chain final X vs K4 x", state.X.T, tr["x"][NUM_STEPS], 1e-4, 1e-2)
    obs = net.assemble_obs_from_streams(params, tr["x"], tr["u"], tr["r"])
    lanes = torch.arange(B, dtype=torch.int64, device=dev)
    n_rt, n_ro = T.n_retail, T.n_reorder
    for t in range(NUM_STEPS):
        w = rng.period_words(SEED, lanes, 0, t, n_rt + 2 * n_ro, key1=rng.POLICY_KEY)
        z = rng.normal01(torch.stack(w[n_rt:n_rt + n_ro]), torch.stack(w[n_rt + n_ro:]))
        close(f"K4 raw[{t}] vs folded actor + plain normals", tr["raw"][t],
              ek.folded_actor_mean(actor, obs[t]).T + std * z, 0.0, 1e-4)
    lines.append("K4 teacher-forced: K1, the step chain and the folded actor "
                 "reproduce its streams")

    # the NaN lane: K1 and plain K1 both give NaN there and agree elsewhere
    nan_acts = acts.clone()
    nan_lane = B // 3
    nan_acts[7, 3, nan_lane] = float("nan")
    k1 = ns.episode_returns(params, nan_acts, tr["demand"])
    p1 = ns._episode_returns_plain(params, nan_acts, tr["demand"])
    nan_k, nan_p = torch.isnan(k1), torch.isnan(p1)
    if nan_k.nonzero().flatten().tolist() != [nan_lane] or not torch.equal(nan_k, nan_p):
        raise AssertionError(f"NaN lane: K1 NaN at {nan_k.nonzero().flatten()[:5].tolist()}"
                             f", plain at {nan_p.nonzero().flatten()[:5].tolist()}")
    keep = ~nan_k
    close("K1 vs plain K1 beside the NaN lane", k1[keep], p1[keep], 1e-5, 1e-3)
    lines.append("NaN action: K1 and plain K1 NaN in that lane only, equal elsewhere")
    del tr, acts, nan_acts, obs

    # K5 and K6, deterministic and stochastic, E episodes per lane
    err["episode_returns_net_policy"] = err["sample_policy_streams_debug_net"] = 0.0
    for ls in (None, log_std):
        kind = "deterministic" if ls is None else "stochastic"
        k5 = ns.episode_returns_net_policy(params, actor, SEED, B, episodes_per_lane=E,
                                           log_std=ls, device=dev)
        k6, a6, d6 = ns.sample_policy_streams_debug_net(
            params, actor, SEED, B, episodes_per_lane=E, log_std=ls, device=dev)
        pstd = None if ls is None else std
        ms5, (want, _, _) = timed_once(ns._policy_returns_plain, params, actor, pstd,
                                       SEED, B, E, dev, False)
        ms6, (_, _, want_d) = timed_once(ns._policy_returns_plain, params, actor, pstd,
                                         SEED, B, E, dev, True)
        if ls is None:
            plain_ms["episode_returns_net_policy"] = ms5
            plain_ms["sample_policy_streams_debug_net"] = ms6
        exact(f"K6 demand, {kind}", d6, want_d)
        err["sample_policy_streams_debug_net"] = max(
            err["sample_policy_streams_debug_net"],
            close(f"K6 vs K5 returns, {kind}", k6, k5, 1e-5, 1e-3))
        replay = ns.episode_returns(
            params, a6.permute(0, 2, 1, 3).reshape(NUM_STEPS, n_ro, E * B).contiguous(),
            d6.permute(0, 2, 1, 3).reshape(NUM_STEPS, n_rt, E * B).contiguous())
        close(f"K1 on K6's streams vs K5, {kind}", replay.reshape(E, B), k5, 1e-5, 1e-3)
        share, e5 = lane_share(f"K5 vs plain, {kind}", k5, want)
        err["episode_returns_net_policy"] = max(err["episode_returns_net_policy"], e5)
        lines.append(f"K5/K6 {kind}, {B} x {E}: K6 demand bit-exact, K1 replays "
                     f"K6's streams, {share:.4%} of lanes agree with plain K5")
        del k5, k6, a6, d6, want, want_d, replay
    torch.cuda.synchronize()
    return err, plain_ms, lines


def ppo_main_path(env, params, dev, smi, label, kernel):
    """Phases 8 and 13: ``train`` with ``rollout="kernel"`` at 65,536 envs x
    30 periods, 64x64, 4 epochs x 8 minibatches, 3 updates, no plain version
    allowed; ``kernel``, the trajectory kernel's wrapper, must launch once
    per update (its count set to 0 just before). Returns (lines, best
    update ms, (cfg, state, generator), rates for the summary)."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import ppo
    cfg = ppo.PPOConfig(num_envs=PPO_ENVS, rollout_steps=NUM_STEPS, num_minibatches=8,
                        update_epochs=4, pi_arch=(64, 64), vf_arch=(64, 64),
                        rollout="kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stamps = [time.perf_counter()]

    def progress(_m, _s):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    with no_plain_versions():
        state, metrics = ppo.train(env, params, cfg, gen,
                                   PPO_UPDATES * PPO_ENVS * NUM_STEPS, device=dev,
                                   progress=progress)
    bad = [k for k, v in metrics.items() if not np.isfinite(v).all()]
    if bad or len(metrics["update"]) != PPO_UPDATES:
        raise AssertionError(f"{label} PPO metrics not finite: {bad}; {metrics}")
    if kernel.launches != PPO_UPDATES:
        raise AssertionError(f"{kernel.__name__} launched {kernel.launches} times in "
                             f"{PPO_UPDATES} updates")
    update_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    best = min(update_ms[1:])     # the first update also builds the model
    samples = PPO_ENVS * NUM_STEPS
    lines = [f"{label} PPO {PPO_ENVS} x {NUM_STEPS}, 64x64, 4 epochs x 8 minibatches: "
             f"update ms {', '.join(f'{t:.3f}' for t in update_ms)}; best {best:.3f} ms = "
             f"{samples / best * 1e3:.6g} trained-steps/s on {smi}",
             f"{label} PPO metrics: " + "; ".join(f"{k} {', '.join(f'{x:.6g}' for x in v)}"
                                                  for k, v in metrics.items())]
    rates = {"update_ms": best, "trained_steps_s": samples / best * 1e3}
    return lines, best, (cfg, state, gen), rates


def evaluate_trained(params, dev, smi, trained):
    """Phase 8, after the NetInvMgmt ``train``: the trained actor's
    ``policy_episode_returns`` at 65,536 x 16, deterministic and stochastic,
    no plain version allowed. Returns (lines, folded actor, log_std, the
    deterministic returns, the kernel seed they came from, rates)."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.vector import fast_episodes
    cfg, state, _ = trained
    actor = ek.fold_actor_params(cfg, state.params, state.rms)
    log_std = state.params.log_std.detach()
    E = EVAL_EPISODES
    env_steps = PPO_ENVS * E * NUM_STEPS
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    replay_gen = torch.Generator(device=dev)
    replay_gen.set_state(g.get_state())
    with no_plain_versions():
        det_ms, det = timed_once(fast_episodes.policy_episode_returns, params, actor, g,
                                 PPO_ENVS, E, True, None, dev)
        sto_ms, sto = timed_once(fast_episodes.policy_episode_returns, params, actor, g,
                                 PPO_ENVS, E, False, log_std, dev)
    for name, ret in (("deterministic", det), ("stochastic", sto)):
        if ret.shape != (PPO_ENVS * E,) or not torch.isfinite(ret).all():
            raise AssertionError(f"{name} evaluation: shape {tuple(ret.shape)} or non-finite")
    lines = [f"policy_episode_returns {PPO_ENVS} x {E} x {NUM_STEPS}: deterministic "
             f"{det_ms:.3f} ms = {env_steps / det_ms * 1e3:.6g} env-steps/s, mean "
             f"{float(det.double().mean()):.3f}; stochastic {sto_ms:.3f} ms = "
             f"{env_steps / sto_ms * 1e3:.6g} env-steps/s, mean "
             f"{float(sto.double().mean()):.3f}; on {smi}"]
    torch.cuda.synchronize()
    rates = {"eval_det_steps_s": env_steps / det_ms * 1e3,
             "eval_sto_steps_s": env_steps / sto_ms * 1e3}
    return lines, actor, log_std, det, fast_episodes.kernel_seed(replay_gen), rates


def check_evaluation(params, dev, actor, det, seed):
    """After phase 8's counts are read: the deterministic evaluation's first
    1,024 lanes against plain K5 on the same seed (lanes keep their
    counters, so a slice of lanes replays alone)."""
    from or_gym_inventory_torch.ops import net_step as ns
    E = EVAL_EPISODES
    plain, _, _ = ns._policy_returns_plain(params, actor, None, seed, MULTI_LANES, E, dev)
    share, _ = lane_share("main path: evaluation vs plain K5",
                          det.reshape(E, PPO_ENVS)[:, :MULTI_LANES].contiguous(), plain)
    return (f"the deterministic evaluation's first {MULTI_LANES} lanes: {share:.4%} "
            "agree with plain K5")


def profile_update(params, dev, trained):
    """One more PPO update of the trained state under torch.profiler: its
    wall time (the profiler's host overhead included), the device's busy
    time (the sum of the device events, kernels and copies; one stream, so
    they do not overlap), their count and the ones that take most device
    time. Outside the counted main path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import net_inv_management as net
    cfg, state, gen = trained
    update = ppo.make_update_fn(net.ENV, params, cfg, PPO_UPDATES + 1, device=dev)
    update(state, gen)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        update(state, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    line = (f"profiled PPO update: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
            f"({busy_ms / wall_ms:.1%}), {n_kernels} device kernels and copies; top by "
            "device time: "
            + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                        for e in top))
    return line, {"busy_ms": busy_ms, "profiled_wall_ms": wall_ms, "events": n_kernels}


def time_chunks(params, dev, trained, order=(8, 1, 1, 8)):
    """Wall ms of one PPO update of the trained state per explicit
    ``minibatch_chunks`` value, in the given order (8 is the JAX package's
    automatic value at this shape: chunks of at most 32,768 samples).
    Returns {chunks: [ms, ...]}."""
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import net_inv_management as net
    cfg, state, gen = trained
    out = {}
    for k in order:
        update = ppo.make_update_fn(net.ENV, params, cfg.replace(minibatch_chunks=k),
                                    PPO_UPDATES + 1, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update(state, gen)
        torch.cuda.synchronize()
        out.setdefault(k, []).append((time.perf_counter() - t0) * 1e3)
    return out


# ------------------------------------------------ InvManagement (slice 3)

def im_cross_check(dev):
    """Phase 10: K7-K9 against their plain versions and each other, for each
    of the five demand modes in backlog and lost sales: at 65,536 x 30
    (E = 1) and at 1,024 lanes x 16 episodes, K9's streams bit for bit
    against plain K9, K8 against K7 on K9's streams and against plain K8,
    K7 _random on K9's demand against K8, and K7 against plain K7. Returns
    the max |diff| per kernel."""
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    err = dict.fromkeys(IM_KERNELS, 0.0)

    def track(name, *args):
        err[name] = max(err[name], close(*args, 1e-5, 1e-3))

    for label, kw in IM_DIST_MODES:
        for backlog in (True, False):
            params = im.default_params(backlog=backlog, **kw)
            case = f"{label}, {'backlog' if backlog else 'lost sales'}"
            a, d = ek.sample_streams_debug_im(params, SEED, CHECK_LANES, device=dev)
            pa, pd = ek._im_fused_plain(params, SEED, CHECK_LANES, 1, dev, dump=True)
            exact(f"K9 actions, {case}", a, pa[:, 0])
            exact(f"K9 demand, {case}", d, pd[:, 0])
            k8 = ek.episode_returns_im_fused(params, SEED, CHECK_LANES, device=dev)
            k7 = ek.episode_returns_im(params, a, d)
            close(f"K8 vs K7 on K9's streams, {case}", k8, k7, 1e-5, 1e-3)
            close(f"K7 _random on K9's demand vs K8, {case}",
                  ek.episode_returns_im_random(params, d, SEED), k8, 1e-5, 1e-3)
            track("episode_returns_im", f"K7 vs plain K7, {case}", k7,
                  ek._episode_returns_im_plain(params, a, d))
            track("episode_returns_im_fused", f"K8 vs plain K8, {case}", k8,
                  ek._im_fused_plain(params, SEED, CHECK_LANES, 1, dev)[0])
            E = MAIN_EPISODES
            a, d = ek.sample_streams_debug_im(params, SEED, MULTI_LANES, E, device=dev)
            pa, pd = ek._im_fused_plain(params, SEED, MULTI_LANES, E, dev, dump=True)
            exact(f"K9 actions, E={E}, {case}", a, pa)
            exact(f"K9 demand, E={E}, {case}", d, pd)
            k8 = ek.episode_returns_im_fused(params, SEED, MULTI_LANES, E, device=dev)
            track("episode_returns_im_fused", f"K8 vs plain K8, E={E}, {case}", k8,
                  ek._im_fused_plain(params, SEED, MULTI_LANES, E, dev))
            for e in range(E):
                close(f"K8 episode {e} vs K7 on K9's streams, {case}", k8[e],
                      ek.episode_returns_im(params, a[:, e].contiguous(),
                                            d[:, e].contiguous()), 1e-5, 1e-3)
    return err


def im_main_path(dev, wrappers):
    """Phase 11, the InvManagement random-policy path. Before the count, K9
    dumps the streams of the main path's seed at 65,536 x 30 and K7 replays
    them (stream-in and _random). Then, counting launches from 0,
    ``random_episode_returns`` at 4,194,304 x 16 must launch K8 exactly
    once, nothing else and no plain version. After the counts are read, the
    first 65,536 lanes of episode 0 are held against K7 (the same counters)
    and the first 1,024 lanes of every episode against plain K8. Returns
    (launches, max |diff| of K8, mean return, streams and seed for phase
    14)."""
    import torch

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.vector import fast_episodes
    params = im.default_params(backlog=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    replay = torch.Generator(device=dev)
    replay.set_state(gen.get_state())
    seed = fast_episodes.kernel_seed(replay)
    a, d = ek.sample_streams_debug_im(params, seed, CHECK_LANES, device=dev)
    k7 = ek.episode_returns_im(params, a, d)
    k7r = ek.episode_returns_im_random(params, d, seed)
    reset_counts(wrappers)
    with no_plain_versions():
        ret = fast_episodes.random_episode_returns(params, gen, MAIN_LANES,
                                                   episodes_per_lane=MAIN_EPISODES,
                                                   device=dev)
    launches = read_counts(wrappers)
    torch.cuda.synchronize()
    moved = {n: c for n, c in launches.items() if c}
    if moved != {"episode_returns_im_fused": 1}:
        raise AssertionError(f"random_episode_returns launched {moved}, not K8 once")
    if ret.shape != (MAIN_LANES * MAIN_EPISODES,):
        raise AssertionError(f"IM main path: returns of shape {tuple(ret.shape)}")
    ret = ret.reshape(MAIN_EPISODES, MAIN_LANES)
    err = close("IM main path: K8 episode 0 vs K7 on K9's streams", ret[0, :CHECK_LANES],
                k7, 1e-5, 1e-3)
    close("IM main path: K7 _random vs K8 episode 0", k7r, ret[0, :CHECK_LANES], 1e-5, 1e-3)
    err = max(err, close("IM main path: first lanes vs plain K8",
                         ret[:, :MULTI_LANES].contiguous(),
                         ek._im_fused_plain(params, seed, MULTI_LANES, MAIN_EPISODES, dev),
                         1e-5, 1e-3))
    mean = float(ret.double().mean())
    del ret
    return launches, err, mean, (params, a, d, seed)


def im_policy_cross_check(dev, actor, log_std):
    """Phase 12: K10 at 65,536 x 30, backlog and lost sales, against plain
    K10 (demand bit for bit; inv, actions, raw and reward by the share of
    lanes); the env step chain on K10's actions and demand reproduces its
    inv exactly and its rewards within rtol=1e-4 atol=1e-2 on every lane; K7
    on K10's streams gives the sum of its rewards; a NaN std gives NaN raws
    and actions 0 in the kernel and the plain version. Returns (max |diff|
    over agreeing lanes, plain ms, lines)."""
    import torch

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    B = CHECK_LANES
    std = ek.clipped_std(log_std)
    err, plain_ms, lines = 0.0, None, []
    for backlog in (True, False):
        params = im.default_params(backlog=backlog)
        case = "backlog" if backlog else "lost sales"
        tr = ek.rollout_traj_im(params, actor, log_std, SEED, B, device=dev)
        ms, want = timed_once(ek._rollout_traj_im_plain, params, actor, std, SEED, B, dev)
        plain_ms = plain_ms or ms
        exact(f"K10 demand, {case}", tr["demand"], want["demand"])
        shares = {k: lane_share(f"K10 {k} vs plain, {case}", tr[k], want[k])
                  for k in ("inv", "actions", "raw", "reward")}
        err = max([err] + [e for _, e in shares.values()])
        lines.append(f"K10 vs plain, {case}: lanes agreeing " + ", ".join(
            f"{k} {sh:.4%}" for k, (sh, _) in shares.items()))
        del want
        state, _ = im.reset(params, batch=B, device=dev)
        for t in range(NUM_STEPS):
            exact(f"step chain inv[{t}] vs K10 inv, {case}", state.inv.T, tr["inv"][t])
            state, ts = im.step_with_demand(params, state, tr["actions"][t].T,
                                            tr["demand"][t])
            close(f"step chain reward[{t}] vs K10, {case}", ts.reward, tr["reward"][t],
                  1e-4, 1e-2)
        exact(f"step chain final inv vs K10, {case}", state.inv.T, tr["inv"][NUM_STEPS])
        close(f"K7 on K10's streams vs its rewards, {case}",
              ek.episode_returns_im(params, tr["actions"], tr["demand"]),
              tr["reward"].sum(0), 1e-5, 1e-3)
        lines.append(f"K10 teacher-forced, {case}: the env step chain gives its inv "
                     "exactly and its rewards, K7 its returns")
        nan_std = torch.full_like(log_std, float("nan"))
        got = ek.rollout_traj_im(params, actor, nan_std, SEED, MULTI_LANES, device=dev)
        plain = ek._rollout_traj_im_plain(params, actor, ek.clipped_std(nan_std), SEED,
                                          MULTI_LANES, dev)
        if not (torch.isnan(got["raw"]).all() and int(got["actions"].abs().max()) == 0
                and torch.equal(got["actions"], plain["actions"])):
            raise AssertionError(f"K10 with a NaN std, {case}: actions not all 0 or "
                                 "not the plain version's")
    lines.append("NaN raws: K10 and plain K10 cast them to 0, as JAX does")
    torch.cuda.synchronize()
    return err, plain_ms, lines


def im_reward_check(dev):
    """Phase 15, the IM-backlog protocol of tools/validate_kernel_ppo.py:
    periods 50, 1,024 envs, 4 epochs x 8 env-sliced minibatches, 2M steps
    (39 updates), seed 0, rollout="kernel"; then 30 deterministic episodes
    through ``vecenv.evaluate_episodes``. Returns (AvgReward, its standard
    error, training seconds, updates)."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.vector import vecenv
    params = im.default_params(backlog=True, periods=50)
    cfg = ppo.PPOConfig(num_envs=1024, rollout_steps=50, num_minibatches=8,
                        update_epochs=4, shuffle_minibatches=False, rollout="kernel")
    t0 = time.perf_counter()
    state, metrics = ppo.train(im.ENV, params, cfg, torch.Generator(device=dev).manual_seed(0),
                               2_000_000, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    policy = ppo.make_eval_policy(im.ENV, params, cfg, deterministic=True)
    totals, _ = vecenv.evaluate_episodes(im.ENV, params, policy, (state.params, state.rms),
                                         torch.Generator(device=dev).manual_seed(4000), 30,
                                         device=dev)
    totals = totals.double().cpu().numpy()
    if not np.isfinite(totals).all():
        raise AssertionError("IM reward check: non-finite episode totals")
    return (float(totals.mean()), float(totals.std(ddof=1) / np.sqrt(len(totals))), wall,
            len(metrics["update"]))


RANDOM_KERNELS = ("episode_returns", "episode_returns_fully_fused",
                  "sample_streams_debug")
POLICY_KERNELS = ("rollout_traj_net", "episode_returns_net_policy",
                  "sample_policy_streams_debug_net")
PPO_PATH_KERNELS = POLICY_KERNELS[:2]   # K6 is held in phase 7, off the path
# K7 and K9 are held in phases 10-12, off the paths: random_episode_returns
# runs K8 alone, as the JAX package's does (fast_episodes.py:80-94)
IM_PATH_KERNELS = ("episode_returns_im_fused", "rollout_traj_im")


def print_kernel(phase, name, kt, work, launches):
    (b_ms, b_by), (t, pt) = work, kt
    print(f"[{phase} kernel] {name}: {t['best_ms']:.4f} ms (mean "
          f"{t.get('mean_ms', t['best_ms']):.4f}), plain {pt['best_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by} ({b_ms / t['best_ms']:.1%} of it), launches on the "
          f"main paths {launches}, library none", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 1

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.utils.profiling import cuda_time
    from or_gym_inventory_torch.vector import fast_episodes, vecenv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {name: [getattr(ns, name)] for name, _, _ in KERNEL_ROWS[:6]}
    wrappers.update({name: [getattr(ek, name)] for name in IM_KERNELS})
    wrappers["episode_returns_im"].append(ek.episode_returns_im_random)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[1 device] {kind}, {torch.cuda.device_count()} card(s); nvidia-smi: "
          f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    for lib in _build.SIGNATURES:
        _build.library(lib)
    ptxas = [ln.split("info    :")[-1].strip() for out in logs.values()
             for ln in out.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.1f} s, {len(logs)} source(s) "
          f"compiled; ptxas: {' | '.join(ptxas)}", flush=True)

    # 3-4. the main path, counting launches: bench.py's cross-check, then
    # random-policy returns at the operating point
    params = net.default_params(num_periods=NUM_STEPS)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    err, acts, dems = cross_check(params, dev)
    print(f"[3 cross-check] K3 streams bit-exact; K1, K2 within rtol=1e-5 atol=1e-3 "
          f"of their plain versions and of each other; step chain within rtol=1e-4 "
          f"atol=1e-2; {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mean, k2_plain_ms = episode_returns_at_scale(params, dev, err)
    launches = read_counts(wrappers)
    missing = [name for name in RANDOM_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    print(f"[4 main path] {MAIN_LANES * MAIN_EPISODES} episode returns within "
          f"rtol=1e-5 atol=1e-3 of plain K2 on the same seed, mean {mean:.3f}; "
          f"max |diff| {err}; launches {launches}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    main_t = cuda_time(fast_episodes.random_episode_returns, params, gen, MAIN_LANES,
                       MAIN_EPISODES, dev, warmup=1, iters=5)
    env_steps = MAIN_LANES * MAIN_EPISODES * NUM_STEPS
    print(f"[4 main path] random_episode_returns {MAIN_LANES} x {MAIN_EPISODES} x "
          f"{NUM_STEPS}: best {main_t['best_ms']:.3f} ms, mean {main_t['mean_ms']:.3f} "
          f"ms, {env_steps / main_t['best_ms'] * 1e3:.6g} env-steps/s on {smi}",
          flush=True)

    # 5. the vecenv path
    space = net.action_space(params)

    def policy(_s, obs, g, _t):
        return space.sample(g, (obs.shape[0],), device=dev)

    def run_rollout(g):
        _, traj = vecenv.rollout(net.ENV, params, policy, None, g, ROLLOUT_ENVS,
                                 NUM_STEPS, device=dev)
        return traj.reward.sum()

    gen = torch.Generator(device=dev).manual_seed(2)
    roll_t = cuda_time(run_rollout, gen, warmup=1, iters=3)
    print(f"[5 vecenv] rollout {ROLLOUT_ENVS} x {NUM_STEPS}: best "
          f"{roll_t['best_ms']:.3f} ms, {ROLLOUT_ENVS * NUM_STEPS / roll_t['best_ms'] * 1e3:.6g} "
          f"env-steps/s on {smi}", flush=True)

    # 6. per-kernel times of K1-K3 at the main path's shapes
    T = params.topology
    hi = float(T.order_cap_heuristic * 2)
    specs = ns._topology_link_specs(T, NUM_STEPS)
    words = T.n_reorder + T.n_retail
    k1_t = cuda_time(ns.episode_returns, params, acts, dems, warmup=2, iters=20)
    k1_p = cuda_time(ns._episode_returns_plain, params, acts, dems, warmup=1, iters=3)
    k3_t = cuda_time(ns.sample_streams_debug, params, SEED, hi, CHECK_LANES,
                     NUM_STEPS, 1, None, dev, warmup=2, iters=20)
    k3_p = cuda_time(ns._sample_streams_plain, params, SEED, hi, CHECK_LANES,
                     NUM_STEPS, 0, 1, dev, warmup=1, iters=3)
    k2_t = cuda_time(ns.episode_returns_fully_fused, params, SEED, hi, MAIN_LANES,
                     NUM_STEPS, MAIN_EPISODES, dev, warmup=1, iters=5)
    del acts, dems
    main_envs = MAIN_LANES * MAIN_EPISODES
    work = {
        "episode_returns": bound(CHECK_LANES * (NUM_STEPS * words + 1) * 4,
                                 CHECK_LANES * NUM_STEPS * step_ops(T)),
        "episode_returns_fully_fused": bound(
            main_envs * 4, main_envs * NUM_STEPS * (step_ops(T) + draw_ops(T, specs))),
        "sample_streams_debug": bound(CHECK_LANES * NUM_STEPS * words * 4,
                                      CHECK_LANES * NUM_STEPS * draw_ops(T, specs)),
    }
    times = {"episode_returns": (k1_t, k1_p),
             "episode_returns_fully_fused": (k2_t, {"best_ms": k2_plain_ms}),
             "sample_streams_debug": (k3_t, k3_p)}
    print(f"[6 work] per env-step: step {step_ops(T)} ops, draw {draw_ops(T, specs)} "
          f"ops; peaks {HBM_BYTES_PER_S:.3g} B/s, {FP32_OPS_PER_S:.3g} op/s", flush=True)
    for name in RANDOM_KERNELS:
        print_kernel(6, name, times[name], work[name], launches[name])

    # 7. the policy kernels against their plain versions, at the main path's
    # shapes, with a seeded actor
    t0 = time.perf_counter()
    actor, log_std = seeded_actor(T.obs_dim, T.n_reorder, dev)
    err2, policy_plain_ms, lines = policy_cross_check(params, dev, actor, log_std)
    err.update(err2)
    for line in lines:
        print(f"[7 policy kernels] {line}", flush=True)
    print(f"[7 policy kernels] max |diff| {err2}; plain ms {policy_plain_ms}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 8. the second main path, counting launches: PPO, then the evaluation
    reset_counts(wrappers)
    t0 = time.perf_counter()
    lines, best_update_ms, trained, summary = ppo_main_path(
        net.ENV, params, dev, smi, "NetInvMgmt", ns.rollout_traj_net)
    eval_lines, actor, log_std, det, det_seed, eval_rates = evaluate_trained(
        params, dev, smi, trained)
    launches2 = read_counts(wrappers)
    lines += eval_lines
    summary.update(eval_rates)
    missing = [name for name in PPO_PATH_KERNELS if launches2[name] == 0]
    if missing:
        raise AssertionError(f"PPO main path launched no {missing}")
    lines.append(check_evaluation(params, dev, actor, det, det_seed))
    del det
    for line in lines:
        print(f"[8 main path] {line}", flush=True)
    print(f"[8 main path] launches {launches2}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {name: launches[name] + launches2[name] for name in wrappers}

    # 9. per-kernel times of K4-K6 at the main path's shapes, with the
    # trained actor
    E = EVAL_EPISODES
    dims = [T.obs_dim, 64, 64, T.n_reorder]
    step_all = step_ops(T) + mlp_ops(dims)
    k4_t = cuda_time(ns.rollout_traj_net, params, actor, log_std, SEED, PPO_ENVS,
                     "ppo", "tanh", dev, warmup=1, iters=5)
    k5_t = cuda_time(ns.episode_returns_net_policy, params, actor, SEED, PPO_ENVS, E,
                     None, dev, warmup=1, iters=3)
    k5s_t = cuda_time(ns.episode_returns_net_policy, params, actor, SEED, PPO_ENVS, E,
                      log_std, dev, warmup=1, iters=3)
    k6_t = cuda_time(ns.sample_policy_streams_debug_net, params, actor, SEED, PPO_ENVS,
                     E, None, dev, warmup=1, iters=3)
    k4_rows = (NUM_STEPS + 1) * (T.n_main + T.n_retail) + NUM_STEPS * (
        2 * T.n_reorder + 1 + T.n_retail)
    n_eval = PPO_ENVS * E * NUM_STEPS
    work.update({
        "rollout_traj_net": bound(
            PPO_ENVS * k4_rows * 4,
            PPO_ENVS * NUM_STEPS * (step_all + policy_draw_ops(T, specs, True))),
        "episode_returns_net_policy": bound(
            PPO_ENVS * E * 4, n_eval * (step_all + policy_draw_ops(T, specs, False))),
        "sample_policy_streams_debug_net": bound(
            PPO_ENVS * E * (1 + NUM_STEPS * words) * 4,
            n_eval * (step_all + policy_draw_ops(T, specs, False))),
    })
    times.update({name: (t, {"best_ms": policy_plain_ms[name]}) for name, t in (
        ("rollout_traj_net", k4_t), ("episode_returns_net_policy", k5_t),
        ("sample_policy_streams_debug_net", k6_t))})
    print(f"[9 work] per env-step: MLP {mlp_ops(dims)} ops, step {step_ops(T)} ops, "
          f"draws {policy_draw_ops(T, specs, True)} (stochastic) / "
          f"{policy_draw_ops(T, specs, False)} (deterministic) ops", flush=True)
    for name in POLICY_KERNELS:
        print_kernel(9, name, times[name], work[name], launches[name])
    print(f"[9 kernel] episode_returns_net_policy, stochastic: {k5s_t['best_ms']:.4f} ms "
          f"(mean {k5s_t['mean_ms']:.4f}); rollout_traj_net is "
          f"{k4_t['best_ms'] / best_update_ms:.1%} of the best PPO update "
          f"({best_update_ms:.3f} ms)", flush=True)
    line, prof = profile_update(params, dev, trained)
    print(f"[9 profile] {line}", flush=True)
    chunk_ms = time_chunks(params, dev, trained)
    print("[9 chunks] one PPO update per minibatch_chunks value, in the order 8, 1, 1, "
          "8: " + "; ".join(f"{k}: {', '.join(f'{t:.3f}' for t in v)} ms"
                            for k, v in chunk_ms.items()) + f" on {smi}", flush=True)
    summary.update(prof)
    summary.update({f"update_ms_chunks_{k}": min(v) for k, v in chunk_ms.items()})
    summary["k4_share_of_update"] = k4_t["best_ms"] / best_update_ms

    # 10. the InvManagement kernels against their plain versions, every
    # demand mode, backlog and lost sales
    t0 = time.perf_counter()
    err.update(im_cross_check(dev))
    print(f"[10 IM cross-check] 5 demand modes x backlog/lost sales at {CHECK_LANES} x "
          f"{NUM_STEPS} and {MULTI_LANES} x {MAIN_EPISODES}: K9 streams bit-exact; K8 = K7 "
          "on K9's streams = K7 _random on K9's demand, and K7, K8 = their plain versions, "
          f"within rtol=1e-5 atol=1e-3; max |diff| "
          f"{ {k: err[k] for k in IM_KERNELS[:2]} }; {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 11. the third main path, counting launches: IM random-policy returns
    t0 = time.perf_counter()
    launches3, k8_err, im_mean, (im_params, im_a, im_d, im_seed) = im_main_path(dev, wrappers)
    err["episode_returns_im_fused"] = max(err["episode_returns_im_fused"], k8_err)
    print(f"[11 IM main path] K9 -> K7 and K7 _random at {CHECK_LANES} x {NUM_STEPS} "
          f"before the count, then random_episode_returns {MAIN_LANES} x {MAIN_EPISODES}: "
          f"K8 launched once, nothing else, no plain version; episode 0 = K7 on K9's streams, the first {MULTI_LANES} lanes = "
          f"plain K8; mean {im_mean:.3f}; launches {launches3}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    im_t = cuda_time(fast_episodes.random_episode_returns, im_params, gen, MAIN_LANES,
                     MAIN_EPISODES, dev, warmup=1, iters=5)
    print(f"[11 IM main path] random_episode_returns {MAIN_LANES} x {MAIN_EPISODES} x "
          f"{NUM_STEPS}: best {im_t['best_ms']:.3f} ms, mean {im_t['mean_ms']:.3f} ms, "
          f"{env_steps / im_t['best_ms'] * 1e3:.6g} env-steps/s on {smi}", flush=True)

    # 12. K10 against its plain version and the env chain, a seeded actor
    t0 = time.perf_counter()
    im_actor, im_log_std = seeded_actor(im_params.pipeline_length, im_params.m1, dev)
    err["rollout_traj_im"], k10_plain_ms, lines = im_policy_cross_check(dev, im_actor,
                                                                        im_log_std)
    for line in lines:
        print(f"[12 IM policy kernel] {line}", flush=True)
    print(f"[12 IM policy kernel] max |diff| over agreeing lanes "
          f"{err['rollout_traj_im']}; {time.perf_counter() - t0:.1f} s", flush=True)

    # 13. the fourth main path, counting launches: PPO on InvManagement
    t0 = time.perf_counter()
    reset_counts(wrappers)
    lines, im_update_ms, (im_cfg, im_state, _), im_rates = ppo_main_path(
        im.ENV, im_params, dev, smi, "InvManagement", ek.rollout_traj_im)
    launches4 = read_counts(wrappers)
    im_actor = ek.fold_actor_params(im_cfg, im_state.params, im_state.rms)
    im_log_std = im_state.params.log_std.detach()
    for line in lines:
        print(f"[13 IM main path] {line}", flush=True)
    print(f"[13 IM main path] launches {launches4}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {name: launches[name] + launches3[name] + launches4[name]
                for name in wrappers}
    missing = [name for name in IM_PATH_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the IM main paths launched no {missing}")

    # 14. per-kernel times of K7-K10 at the main paths' shapes
    table_len = len(ek._im_demand_spec(im_params)[1])
    k7_t = cuda_time(ek.episode_returns_im, im_params, im_a, im_d, warmup=2, iters=20)
    k7_p = cuda_time(ek._episode_returns_im_plain, im_params, im_a, im_d, warmup=1, iters=3)
    k8_t = cuda_time(ek.episode_returns_im_fused, im_params, SEED, MAIN_LANES,
                     MAIN_EPISODES, dev, warmup=1, iters=5)
    k8_p = cuda_time(ek._im_fused_plain, im_params, SEED, CHECK_LANES, 1, dev,
                     warmup=1, iters=3)
    k9_t = cuda_time(ek.sample_streams_debug_im, im_params, SEED, CHECK_LANES, 1, dev,
                     warmup=2, iters=20)
    k9_p = cuda_time(ek._im_fused_plain, im_params, SEED, CHECK_LANES, 1, dev, True,
                     warmup=1, iters=3)
    k10_t = cuda_time(ek.rollout_traj_im, im_params, im_actor, im_log_std, SEED, PPO_ENVS,
                      "ppo", "tanh", dev, warmup=1, iters=5)
    del im_a, im_d
    m1, T = im_params.m1, NUM_STEPS
    im_dims = [im_params.pipeline_length, 64, 64, m1]
    work.update({
        "episode_returns_im": bound(CHECK_LANES * (T * (m1 + 1) + 1) * 4,
                                    CHECK_LANES * T * im_step_ops(im_params)),
        "episode_returns_im_fused": bound(
            main_envs * 4,
            main_envs * T * (im_step_ops(im_params) + im_draw_ops(im_params, table_len))),
        "sample_streams_debug_im": bound(CHECK_LANES * T * (m1 + 1) * 4,
                                         CHECK_LANES * T * im_draw_ops(im_params, table_len)),
        "rollout_traj_im": bound(
            PPO_ENVS * ((T + 1) * m1 + 2 * T * m1 + 2 * T) * 4,
            PPO_ENVS * T * (mlp_ops(im_dims) + im_step_ops(im_params)
                            + im_policy_draw_ops(im_params, table_len))),
    })
    times.update({"episode_returns_im": (k7_t, k7_p),
                  "episode_returns_im_fused": (k8_t, k8_p),
                  "sample_streams_debug_im": (k9_t, k9_p),
                  "rollout_traj_im": (k10_t, {"best_ms": k10_plain_ms})})
    print(f"[14 work] IM per env-step: step {im_step_ops(im_params)} ops, random draws "
          f"{im_draw_ops(im_params, table_len)} ops (table of {table_len}), K10 MLP "
          f"{mlp_ops(im_dims)} + draws {im_policy_draw_ops(im_params, table_len)} ops; plain "
          f"K8 timed at {CHECK_LANES} x {T}, E=1", flush=True)
    for name in IM_KERNELS:
        print_kernel(14, name, times[name], work[name], launches[name])
    print(f"[14 kernel] rollout_traj_im is {k10_t['best_ms'] / im_update_ms:.1%} of the "
          f"best IM PPO update ({im_update_ms:.3f} ms)", flush=True)

    # 15. reward at the IM-backlog protocol of tools/validate_kernel_ppo.py
    t0 = time.perf_counter()
    avg, se, wall, n_upd = im_reward_check(dev)
    print(f"[15 IM reward] periods 50, 1,024 envs, 4 epochs x 8 env-sliced minibatches, 2M "
          f"steps ({n_upd} updates, {wall:.1f} s), seed 0: AvgReward {avg:.1f} +- {se:.1f} "
          f"over 30 deterministic episodes; {time.perf_counter() - t0:.1f} s", flush=True)
    im_summary = dict(im_rates, random_ms=im_t["best_ms"],
                      random_env_steps_s=env_steps / im_t["best_ms"] * 1e3,
                      k10_share_of_update=k10_t["best_ms"] / im_update_ms,
                      validate_avg_reward=avg, validate_eval_se=se)

    rows = []
    for name, source, replaces in KERNEL_ROWS:
        (kt, pt), (b_ms, b_by) = times[name], work[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": kt["best_ms"],
                     "plain_ms": pt["best_ms"], "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})

    # the last lines: the kernels, a summary of the PPO main path (kept near
    # the end, where a short tail of the output still holds it), the card
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ppo_main_path": summary}))
    print(json.dumps({"im_main_path": im_summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
