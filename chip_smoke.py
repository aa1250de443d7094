#!/usr/bin/env python3
"""Smoke run of the PyTorch port (or_gym_inventory_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc (one process per source, all
at once), then drives the port's two main paths, each with every launch
counter set to 0 just before it and read just after:

- slice 1, random-policy episode returns (phases 3-4): what bench.py does on
  the JAX package, a cross-check of the fused kernel on its own dumped
  streams followed by random-policy returns of the NetInvMgmt default graph
  at 4,194,304 lanes x 16 episodes x 30 periods, through
  ``vector.fast_episodes.random_episode_returns``;
- slice 2, PPO and learned-policy evaluation (phase 8): ``agents.ppo.train``
  with ``rollout="kernel"`` at 65,536 envs x 30 periods, the default 64x64
  tanh actor-critic, 4 epochs x 8 minibatches, 3 updates, then
  ``policy_episode_returns`` of the trained actor at 65,536 x 16,
  deterministic and stochastic. After the counts are read, the
  deterministic returns of the first 1,024 lanes are held against plain K5.

Every kernel output on those paths is held against the kernel's plain
PyTorch version on the same inputs: K1-K3 in phases 3-4, K4-K6 in phase 7
(at the main path's shapes, with a seeded actor whose obs statistics are
folded into layer 1), which also holds the NaN propagation of the shared
step. K6, K5 with its streams dumped, is on neither main path: it is
launched and held in phase 7 only. Then it times the vecenv rollout (phase
5), each kernel against its plain version (phases 6 and 9), and one PPO
update with its gradient in 8 chunks per minibatch against 1 (phase 9).
Every phase prints its lines; any failure raises and exits non-zero.
Without a CUDA device it exits 1 and prints no result.

The last four lines are one JSON object of per-kernel numbers
(``launches`` is the sum of a kernel's launches in the two main-path runs,
so 0 for K6; for K4 and K5, ``max_abs_err`` is over the lanes that agree
with the plain version), one JSON object of the PPO path's rates, the
card's name and power limit as nvidia-smi gives them, and
``{"ok": true, "device": {...}}``.

Tolerances: streams of draws (actions of K3, demand of K3/K4/K6) bit for
bit; K1-K3 against their plain versions, the fused kernel against the
stream-in kernel, and the stream-in kernel on K4/K6's streams against K4's
rewards and K5's returns, rtol=1e-5 atol=1e-3 (f32 sums in another order,
FMA contraction); the env step chain against the stream-in kernel and K4's
state streams rtol=1e-4 atol=1e-2 (bench.py:156); K4's raws against the
folded actor on the assembled obs plus the plain normals atol=1e-4 (matmul
sums in another order, an ulp of logf/cosf); K4-K6 free-running against
their plain versions: at least 99% of lanes agree over the whole episode
within rtol=1e-4 atol=1e-2, since a rounding tie in rint lets a lane take
the other integer and diverge (the fraction-closeness rule, ROADMAP.md Queue C).
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
    """Operations of draw_period in csrc/philox.cuh for one period: the
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


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases

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


def seeded_actor(params, dev):
    """Phase 7's actor: the default 64x64 actor-critic drawn from its own
    initialisation, and obs statistics with mean ~50 and std ~20 folded into
    its first layer. Returns (folded actor, log_std), on ``dev``."""
    import torch

    from or_gym_inventory_torch.agents import networks, ppo
    from or_gym_inventory_torch.ops import episode_kernels as ek
    T = params.topology
    g = torch.Generator().manual_seed(SEED)
    model = networks.MLPActorCritic(T.obs_dim, T.n_reorder, generator=g)
    rms = ppo.RunningMeanStd(mean=50.0 + 5.0 * torch.randn(T.obs_dim, generator=g),
                             var=(20.0 + 5.0 * torch.rand(T.obs_dim, generator=g)) ** 2,
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


def ppo_main_path(params, dev, smi):
    """Phase 8: PPO through the trajectory kernel, then the trained actor's
    evaluation, deterministic and stochastic. Returns (lines, best update
    ms, folded actor, log_std, (cfg, state, generator), the deterministic
    returns, the kernel seed they came from, rates for the summary)."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.agents import ppo
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.vector import fast_episodes
    cfg = ppo.PPOConfig(num_envs=PPO_ENVS, rollout_steps=NUM_STEPS, num_minibatches=8,
                        update_epochs=4, pi_arch=(64, 64), vf_arch=(64, 64),
                        rollout="kernel")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stamps = [time.perf_counter()]

    def progress(_m, _s):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    state, metrics = ppo.train(net.ENV, params, cfg, gen,
                               PPO_UPDATES * PPO_ENVS * NUM_STEPS, device=dev,
                               progress=progress)
    bad = [k for k, v in metrics.items() if not np.isfinite(v).all()]
    if bad or len(metrics["update"]) != PPO_UPDATES:
        raise AssertionError(f"PPO metrics not finite: {bad}; {metrics}")
    if ns.rollout_traj_net.launches != PPO_UPDATES:
        raise AssertionError(f"rollout_traj_net launched {ns.rollout_traj_net.launches} "
                             f"times in {PPO_UPDATES} updates")
    update_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    best = min(update_ms[1:])     # the first update also builds the model
    samples = PPO_ENVS * NUM_STEPS
    lines = [f"PPO {PPO_ENVS} x {NUM_STEPS}, 64x64, 4 epochs x 8 minibatches: update "
             f"ms {', '.join(f'{t:.3f}' for t in update_ms)}; best {best:.3f} ms = "
             f"{samples / best * 1e3:.6g} trained-steps/s on {smi}",
             "PPO metrics: " + "; ".join(f"{k} {', '.join(f'{x:.6g}' for x in v)}"
                                         for k, v in metrics.items())]

    actor = ek.fold_actor_params(cfg, state.params, state.rms)
    log_std = state.params.log_std.detach()
    E = EVAL_EPISODES
    env_steps = PPO_ENVS * E * NUM_STEPS
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    replay_gen = torch.Generator(device=dev)
    replay_gen.set_state(g.get_state())
    det_ms, det = timed_once(fast_episodes.policy_episode_returns, params, actor, g,
                             PPO_ENVS, E, True, None, dev)
    sto_ms, sto = timed_once(fast_episodes.policy_episode_returns, params, actor, g,
                             PPO_ENVS, E, False, log_std, dev)
    for name, ret in (("deterministic", det), ("stochastic", sto)):
        if ret.shape != (PPO_ENVS * E,) or not torch.isfinite(ret).all():
            raise AssertionError(f"{name} evaluation: shape {tuple(ret.shape)} or non-finite")
    lines.append(f"policy_episode_returns {PPO_ENVS} x {E} x {NUM_STEPS}: deterministic "
                 f"{det_ms:.3f} ms = {env_steps / det_ms * 1e3:.6g} env-steps/s, mean "
                 f"{float(det.double().mean()):.3f}; stochastic {sto_ms:.3f} ms = "
                 f"{env_steps / sto_ms * 1e3:.6g} env-steps/s, mean "
                 f"{float(sto.double().mean()):.3f}; on {smi}")
    torch.cuda.synchronize()
    rates = {"update_ms": best, "trained_steps_s": samples / best * 1e3,
             "eval_det_steps_s": env_steps / det_ms * 1e3,
             "eval_sto_steps_s": env_steps / sto_ms * 1e3}
    return (lines, best, actor, log_std, (cfg, state, gen), det,
            fast_episodes.kernel_seed(replay_gen), rates)


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


RANDOM_KERNELS = ("episode_returns", "episode_returns_fully_fused",
                  "sample_streams_debug")
POLICY_KERNELS = ("rollout_traj_net", "episode_returns_net_policy",
                  "sample_policy_streams_debug_net")
PPO_PATH_KERNELS = POLICY_KERNELS[:2]   # K6 is held in phase 7, off the path


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

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import net_step as ns
    from or_gym_inventory_torch.utils.profiling import cuda_time
    from or_gym_inventory_torch.vector import fast_episodes, vecenv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {name: getattr(ns, name) for name, _, _ in KERNEL_ROWS}

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
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    err, acts, dems = cross_check(params, dev)
    print(f"[3 cross-check] K3 streams bit-exact; K1, K2 within rtol=1e-5 atol=1e-3 "
          f"of their plain versions and of each other; step chain within rtol=1e-4 "
          f"atol=1e-2; {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mean, k2_plain_ms = episode_returns_at_scale(params, dev, err)
    launches = {name: w.launches for name, w in wrappers.items()}
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
    actor, log_std = seeded_actor(params, dev)
    err2, policy_plain_ms, lines = policy_cross_check(params, dev, actor, log_std)
    err.update(err2)
    for line in lines:
        print(f"[7 policy kernels] {line}", flush=True)
    print(f"[7 policy kernels] max |diff| {err2}; plain ms {policy_plain_ms}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 8. the second main path, counting launches: PPO, then the evaluation
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    lines, best_update_ms, actor, log_std, trained, det, det_seed, summary = \
        ppo_main_path(params, dev, smi)
    launches2 = {name: w.launches for name, w in wrappers.items()}
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
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
