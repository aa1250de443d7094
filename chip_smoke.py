#!/usr/bin/env python3
"""Smoke run of the PyTorch port (or_gym_inventory_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, then drives the port's main
path with every launch counter at 0: what bench.py does on the JAX package,
a cross-check of the fused kernel on its own dumped streams followed by
random-policy episode returns of the NetInvMgmt default graph at 4,194,304
lanes x 16 episodes x 30 periods, through
``vector.fast_episodes.random_episode_returns``. Every kernel output on that
path, the returns at full size included, is held against the kernel's plain
PyTorch version on the same inputs. Then it times the vecenv rollout and
each kernel. Every phase prints one line; any failure raises and exits
non-zero. Without a CUDA device it exits 1 and prints no result.

The last three lines are the card's name and power limit as nvidia-smi
gives them, one JSON object of per-kernel numbers, and
``{"ok": true, "device": {...}}``.

Tolerances: streams bit for bit; kernel against plain version, and the
fused kernel against the stream-in kernel, rtol=1e-5 atol=1e-3 (f32 sums in
another order, FMA contraction); the env step chain against the stream-in
kernel rtol=1e-4 atol=1e-2 (bench.py:156).
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
    _build.library()
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
    missing = [name for name, n in launches.items() if n == 0]
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

    # 6. per-kernel times at the main path's shapes
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
    k2_p = {"best_ms": k2_plain_ms}
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
             "episode_returns_fully_fused": (k2_t, k2_p),
             "sample_streams_debug": (k3_t, k3_p)}
    rows = []
    for name, source, replaces in KERNEL_ROWS:
        (kt, pt), (b_ms, b_by) = times[name], work[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err[name], "ms": kt["best_ms"],
                     "plain_ms": pt["best_ms"], "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        print(f"[6 kernel] {name}: {kt['best_ms']:.4f} ms (mean {kt['mean_ms']:.4f}), "
              f"plain {pt['best_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
              f"({b_ms / kt['best_ms']:.1%} of it), launches on the main path "
              f"{launches[name]}, library none", flush=True)
    print(f"[6 work] per env-step: step {step_ops(T)} ops, draw {draw_ops(T, specs)} "
          f"ops; peaks {HBM_BYTES_PER_S:.3g} B/s, {FP32_OPS_PER_S:.3g} op/s", flush=True)

    # 7. the last lines
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
