"""Time K1 and K25, NetInvMgmt's stream-fed episode returns and one-period
step (the PyTorch port's ``net_step.episode_returns`` and
``net_step.batched_step``), on one CUDA card: each against its first
design, split into host work, the launch floor and the kernel alone.

K1 (``net_episode_returns`` in or_gym_inventory_torch/csrc/net_episode.cu)
runs K2's episode body on the lane's state in shared memory, a period's
words staged ahead of the step by cp.async into two buffers of ``chunk``
periods; K25 (``net_batched_step``) steps one period on the state in shared
memory with one ring word per link with L > 0. Their first designs, a
thread a lane on the 1,792-byte Episode frame in local memory, are kept as
copies in ``tools/net_episode_parent.cu``, whose ``net_empty`` launches a
kernel that does nothing. This script builds, into the ignored
``build/net_k1_k25_sweep/`` directory, the first designs and copies of
net_episode.cu with one change each, all at once:

- ``k1_stream``: K1 without its staging, each action and demand word read
  from global memory as the step reaches it (net_step.cuh FromStream), its
  block holding the state alone;
- ``k25_copy_alone``: K25 without its step (timing only): the lane's
  copies in and the grid's copy of RH's rows;
- ``k25_step_alone``: K25 without the grid's copy (timing only);
- ``step_before``: net_step.cuh's link and retail passes as the first
  designs ran them (``step_before_changes``).

Then, on the default graph with K3's streams (chip_smoke.py's seed), it
times each launch alone (CUDA events around the C call, its plan and
inputs made before; best of 20 after a warm-up):

- the launch floor: ``net_empty`` through the same ctypes path;
- K1 at 1,024, 4,096 and 65,536 lanes x 30: the first design and the
  package's kernel in turns (first, new, new, first); the new kernel at
  32, 64 and 128 threads a block with 1, 2 and 4 periods a staging buffer,
  and ``k1_stream`` at each block size; the entry point and the first
  design's entry point (its wrapper as it was, on the first design's
  library), host work inside the events;
- K25 at 65,536 lanes, period 3 of a chained rollout: the first design and
  the new kernel in turns, its copy alone and step alone, both entry
  points, and ``rollout_transposed`` at 65,536 x 30;
- ``step_before``: K1 (at the entry point's plan), K25, K2 (at bench.py's
  4,194,304 x 16 x 30) and K26 (65,536 x 30) on net_step.cuh's link and
  retail passes as the first designs ran them, each load after the store
  before it (the package issues a link's loads first), K2 and K26 in turns
  with the package;
- the host work of the entry points, whole (the host's clock over 200
  queued calls) and piece by piece, and that of the bare C calls (the
  first design and the package in turns).

Every run of the package's arithmetic equals the entry point's outputs bit
for bit; the first designs are checked for equality and the result
printed. It prints each time with the card's name and power limit, ptxas's
registers and stack, and a JSON line of the times.

    python3 tools/net_k1_k25_sweep.py

Without a CUDA card it exits 1.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED = 2024
PERIODS = 30
K1_LANES = (1_024, 4_096, 65_536)
K25_LANES = 65_536
THREADS = (32, 64, 128)
CHUNKS = (1, 2, 4)
ITERS = 20

# each variant: its (file, old, new) text changes of csrc/; "step_before"
# is filled in by ``step_before_changes``
VARIANTS = {
    "k1_stream": (
        ("net_episode.cu",
         "  issue(0);\n  out[b] = shared_episode(tp, s, disc, T, [&](int t) {\n"
         "    const int c = t % C;",
         "  out[b] = shared_episode(tp, s, disc, T, [&](int t) {\n"
         "    return step_view(tp, s, FromStream{acts + (long long)t * n_ro * B + b, B},\n"
         "                     FromStream{dems + (long long)t * n_rt * B + b, B}, NoSink{});\n"
         "    const int c = t % C;"),),
    "k25_copy_alone": (
        ("net_episode.cu",
         "  const float profit = step_view(tp, s, FromColumn{in, n}, "
         "FromColumn{in + n_ro * n, n},\n"
         "                                 ToRows{RHo + b, B, true});",
         "  const float profit = 0.f;"),),
    "k25_step_alone": (
        ("net_episode.cu", "  const long long len = (long long)(lt - 1) * n_ro * B;",
         "  const long long len = 0;"),),
    "step_before": (),
}
# the region of a step body that ``step_before`` swaps: the link pass and
# the retail pass
STEP_REGION = ("  // 0-1) per reorder link", "  // 5) per-node holding")


def step_before_changes():
    """``step_before``'s change of net_step.cuh: the link and retail passes
    of step_view as the first designs ran them (tools/net_episode_parent.cu
    step_view_first), each load issued after the store before it."""
    from or_gym_inventory_torch.ops import _build

    def region(text):
        i, j = text.index(STEP_REGION[0]), text.index(STEP_REGION[1])
        return text[i:j]
    return (("net_step.cuh", region((_build.CSRC / "net_step.cuh").read_text()),
             region((ROOT / "tools" / "net_episode_parent.cu").read_text())),)


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the first designs' C entry points (tools/net_episode_parent.cu)
PARENT = {
    "net_episode_returns": ((_P, _P, _P, _P, _P, _LL, _I, _P), _I),
    "net_batched_step": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _LL,
                          _P), _I),
    "net_empty": ((_P,), _I),
}


def bind(so, signatures):
    from or_gym_inventory_torch.ops import _build
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in {**signatures, **_build._SHARED}.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
    return lib


def build_all():
    """Compile the first designs and every variant at once; returns
    ({name: library}, {name: ptxas's report})."""
    from or_gym_inventory_torch.ops import _build
    root = _build.BUILD_DIR / "net_k1_k25_sweep"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    so = root / "libparent.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
           str(ROOT / "tools" / "net_episode_parent.cu")]
    jobs = {"parent": (so, PARENT, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))}
    for name, changes in VARIANTS.items():
        d = root / name
        shutil.copytree(_build.CSRC, d)
        for fname, old, new in changes or step_before_changes():
            text = (d / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {fname} holds {old!r} {text.count(old)} times")
            (d / fname).write_text(text.replace(old, new))
        so = d / "libnet_episode.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / "net_episode.cu")]
        jobs[name] = (so, _build.SIGNATURES["net_episode"], subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, sigs, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name], logs[name] = bind(so, sigs), out
    return libs, logs


def check(rc, lib, what):
    if rc:
        raise RuntimeError(f"{what}: {lib.cuda_error_message(rc).decode()}")


def host_us(fn, *args, n=2_000):
    """Microseconds a call of ``fn(*args)`` takes on the host's clock, the
    best of three runs of ``n`` calls."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
    return best


def first_k1_entry(lib, params, actions, demands):
    """The first design's entry point: episode_returns' wrapper as it was,
    launching the first design."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    ns._check_streams(params, actions, demands)
    if not (actions.is_contiguous() and demands.is_contiguous()):
        raise ValueError("actions and demands must be contiguous")
    num_steps, _, B = actions.shape
    dev = actions.device
    tp, disc, _ = ns._launch_plan(params, num_steps, ek._plan_key(dev), False)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        check(lib.net_episode_returns(ctypes.addressof(tp), actions.data_ptr(),
                                      demands.data_ptr(), disc.data_ptr(), out.data_ptr(), B,
                                      num_steps, ek._stream(dev)), lib, "first K1")
    return out


def first_k25_entry(lib, params, X, Y, U, RH, action, demand, t):
    """The first design's entry point: batched_step's wrapper as it was
    (six checks, six ``contiguous``, five allocations, alpha^t through
    NumPy, the ``_launch_plan`` lookup), launching the first design."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    T = params.topology
    lt = max(T.lt_max, 1)
    B = X.shape[-1]
    rows = {"X": (X, T.n_main), "Y": (Y, T.n_reorder), "U": (U, T.n_retail),
            "RH": (RH, lt * T.n_reorder), "action": (action, T.n_reorder),
            "demand": (demand, T.n_retail)}
    for name, (x, n) in rows.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
        if tuple(x.shape) != (n, B) or x.device != X.device:
            raise ValueError(f"{name}")
    t = int(t)
    dev = X.device
    tp, _, _ = ns._launch_plan(params, 1, ek._plan_key(dev), False)
    ins = [x.contiguous() for x, _ in rows.values()]
    outs = [torch.empty((n, B), dtype=torch.float32, device=dev)
            for _, n in list(rows.values())[:4]]
    rew = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        check(lib.net_batched_step(ctypes.addressof(tp), *(x.data_ptr() for x in ins),
                                   *(x.data_ptr() for x in outs), rew.data_ptr(),
                                   float(np.float32(params.alpha ** t)), t, lt, B,
                                   ek._stream(dev)), lib, "first K25")
    return (*outs, rew)


def k1_cases(libs, clock, smi, result, dev):
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    params = net.default_params(num_periods=PERIODS)
    T = params.topology
    hi = float(T.order_cap_heuristic * 2)
    key = ek._plan_key(dev)
    tp, disc, _ = ns._launch_plan(params, PERIODS, key, False)
    counts = (T.n_main, T.n_reorder, T.n_retail, sum(T.ro_L))
    stream = ek._stream(dev)
    package, parent = _build.library("net_episode"), libs["parent"]
    for B in K1_LANES:
        acts, dems = ns.sample_streams_debug(params, SEED, hi, B, device=dev)
        out = torch.empty(B, dtype=torch.float32, device=dev)
        want = ns.episode_returns(params, acts, dems)
        entry_plan = ns._k1_layout(*counts)[0]

        def new(lib, plan):
            lay = ns._NetSmem(words=plan.state.words, **plan.state.offsets)
            st = plan.struct()
            check(lib.net_episode_returns(ctypes.addressof(tp), ctypes.addressof(lay),
                                          ctypes.addressof(st), acts.data_ptr(),
                                          dems.data_ptr(), disc.data_ptr(), out.data_ptr(), B,
                                          PERIODS, stream), lib, "K1")

        def first():
            check(parent.net_episode_returns(ctypes.addressof(tp), acts.data_ptr(),
                                             dems.data_ptr(), disc.data_ptr(), out.data_ptr(),
                                             B, PERIODS, stream), parent, "first K1")

        times = result.setdefault(f"k1_{B}x{PERIODS}", {
            "entry_plan": {"threads": entry_plan.threads, "chunk": entry_plan.chunk,
                           "words": entry_plan.words, "blocks_per_sm": entry_plan.blocks_per_sm}})
        times["turns_first_new_new_first"] = [clock(first), clock(new, package, entry_plan),
                                              clock(new, package, entry_plan), clock(first)]
        first()
        times["first_equal_bit_for_bit"] = bool(torch.equal(out, want))
        times["first_max_abs_diff"] = float((out - want).abs().max())
        grid = {}
        for threads in THREADS:
            for chunk in CHUNKS:
                plan = ns._k1_plan(*counts, chunk=chunk, threads=threads)
                out.zero_()
                ms = clock(new, package, plan)
                if not torch.equal(out, want):
                    raise AssertionError(f"K1 at {threads} threads, chunk {chunk}: not the "
                                         "entry point's returns")
                grid[f"t{threads}_c{chunk}"] = [ms, plan.blocks_per_sm]
            state = ns._shared_state_plan(*counts)
            plan = ns._staged_plan(state, 0, 1, threads)
            out.zero_()
            grid[f"t{threads}_stream"] = [clock(new, libs["k1_stream"], plan),
                                          plan.blocks_per_sm]
            if not torch.equal(out, want):
                raise AssertionError(f"k1_stream at {threads} threads: not the entry point's")
        times["kernel_alone_by_threads_chunk"] = grid
        out.zero_()
        times["step_before"] = clock(new, libs["step_before"], entry_plan)
        if not torch.equal(out, want):
            raise AssertionError("K1 on the step as it was: not the entry point's returns")
        times["entry"] = clock(ns.episode_returns, params, acts, dems)
        times["first_entry"] = clock(first_k1_entry, parent, params, acts, dems)
        times["c_call_host_us_first_new_new_first"] = [
            entry_host_us(first), entry_host_us(new, package, entry_plan),
            entry_host_us(new, package, entry_plan), entry_host_us(first)]
        print(f"K1 at {B} x {PERIODS} on {smi}: " + ", ".join(
            f"{k} {v}" for k, v in times.items()), flush=True)
        del acts, dems


def k25_cases(libs, clock, smi, result, dev):
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    params = net.default_params(num_periods=PERIODS)
    T = params.topology
    B = K25_LANES
    hi = float(T.order_cap_heuristic * 2)
    g = torch.Generator(device=dev).manual_seed(SEED)
    X, Y, U, RH = (x.contiguous() for x in ns.init_transposed(params, B, dev))
    for t in range(4):   # period 3 of a chained rollout
        action = torch.rand((T.n_reorder, B), generator=g, device=dev) * hi
        demand = net.sample_demand(params, g, t, B, device=dev).T.contiguous()
        if t < 3:
            X, Y, U, RH, _ = ns.batched_step(params, X, Y, U, RH, action, demand, t)
    t = 3
    want = ns.batched_step(params, X, Y, U, RH, action, demand, t)
    tp_first, _, _ = ns._launch_plan(params, 1, ek._plan_key(dev), False)
    tp, lay, st, lt, out_rows = ns._k25_launch(params)
    outs = torch.empty((sum(out_rows), B), dtype=torch.float32, device=dev).split(out_rows)
    ins = (X, Y, U, RH, action, demand)
    disc = float(params.alpha ** t)
    stream = ek._stream(dev)
    package, parent = _build.library("net_episode"), libs["parent"]

    def new(lib):
        check(lib.net_batched_step(ctypes.addressof(tp), ctypes.addressof(lay),
                                   ctypes.addressof(st), *(x.data_ptr() for x in ins),
                                   *(x.data_ptr() for x in outs), disc, t, lt, B, stream),
              lib, "K25")

    def first():
        check(parent.net_batched_step(ctypes.addressof(tp_first), *(x.data_ptr() for x in ins),
                                      *(x.data_ptr() for x in outs), disc, t, lt, B, stream),
              parent, "first K25")

    def equal():
        return all(torch.equal(a, b.reshape(a.shape)) for a, b in zip(outs, want))

    times = result.setdefault(f"k25_{B}", {"words": st.words, "threads": st.threads})
    times["turns_first_new_new_first"] = [clock(first), clock(new, package),
                                          clock(new, package), clock(first)]
    new(package)
    if not equal():
        raise AssertionError("K25 kernel alone: not the entry point's outputs")
    first()
    times["first_equal_bit_for_bit"] = equal()
    times["step_before"] = clock(new, libs["step_before"])
    if not equal():
        raise AssertionError("K25 on the step as it was: not the entry point's outputs")
    times["copy_alone"] = clock(new, libs["k25_copy_alone"])
    times["step_alone"] = clock(new, libs["k25_step_alone"])
    times["entry"] = clock(ns.batched_step, params, *ins, t)
    times["first_entry"] = clock(first_k25_entry, parent, params, *ins, t)
    times["c_call_host_us_first_new_new_first"] = [
        entry_host_us(first), entry_host_us(new, package), entry_host_us(new, package),
        entry_host_us(first)]
    roll = {}
    for _ in range(2):
        roll.setdefault("rollout_transposed", []).append(clock(
            ns.rollout_transposed, params, torch.Generator(device=dev).manual_seed(3), B,
            PERIODS, None, dev))
    times.update(roll)
    print(f"K25 at {B} on {smi}: " + ", ".join(f"{k} {v}" for k, v in times.items()),
          flush=True)
    return params, ins, t


def k2_k26_cases(libs, clock, smi, result, dev):
    """K2 at bench.py's 4,194,304 x 16 x 30 and K26 at 65,536 x 30, the
    package's step against ``step_before`` in turns: the step's load order
    on the kernels that share it."""
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    params = net.default_params(num_periods=PERIODS)
    hi = float(params.topology.order_cap_heuristic * 2)
    tp, disc, tab = ns._launch_plan(params, PERIODS, ek._plan_key(dev), True)
    _, lay = ns._shared_layout(params.topology)
    stream, scale = ek._stream(dev), ns._act_scale(hi)
    package = _build.library("net_episode")
    lanes, E = 4_194_304, 16
    want2 = ns.episode_returns_fully_fused(params, SEED, hi, lanes, PERIODS, E, device=dev)
    out2 = torch.empty_like(want2)

    def k2(lib):
        check(lib.net_episode_returns_fused(ctypes.addressof(tp), ctypes.addressof(lay),
                                            disc.data_ptr(), tab.data_ptr(), out2.data_ptr(),
                                            SEED, scale, lanes, E, PERIODS, stream), lib, "K2")

    _, dems = ns.sample_streams_debug(params, SEED, hi, K25_LANES, device=dev)
    want26 = ns.episode_returns_random_policy(params, dems, SEED, hi)
    out26 = torch.empty_like(want26)

    def k26(lib):
        check(lib.net_episode_returns_random(ctypes.addressof(tp), ctypes.addressof(lay),
                                             dems.data_ptr(), disc.data_ptr(), out26.data_ptr(),
                                             SEED, scale, K25_LANES, PERIODS, stream), lib, "K26")

    before = libs["step_before"]
    times = {"k2_turns_before_now_now_before": [clock(k2, before), clock(k2, package),
                                                clock(k2, package), clock(k2, before)],
             "k26_turns_before_now_now_before": [clock(k26, before), clock(k26, package),
                                                 clock(k26, package), clock(k26, before)]}
    k2(before)
    k26(before)
    if not (torch.equal(out2, want2) and torch.equal(out26, want26)):
        raise AssertionError("K2 or K26 on the step as it was: not the entry points' returns")
    result["k2_k26_step_order"] = times
    print(f"K2 at {lanes} x {E} x {PERIODS} and K26 at {K25_LANES} x {PERIODS} on {smi}: "
          + ", ".join(f"{k} {v}" for k, v in times.items()), flush=True)


def entry_host_us(fn, *args, n=200):
    """Microseconds of the host's clock a call of an entry point takes,
    ``n`` calls queued behind a synchronise (the card's queue does not fill)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(*args)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def device_ctx(dev):
    import torch
    with torch.cuda.device(dev):
        pass


def host_pieces(libs, params, ins, t, dev, result):
    """The entry points' host work, whole and piece by piece, on the host's
    clock."""
    import numpy as np
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    key = ek._plan_key(dev)
    T = params.topology
    B = ins[0].shape[-1]
    pieces = {
        "hash_params": host_us(hash, params),
        "launch_plan_lookup": host_us(ns._launch_plan, params, 1, key, False),
        "k25_launch_lookup": host_us(ns._k25_launch, params),
        "plan_key": host_us(ek._plan_key, dev),
        "stream": host_us(ek._stream, dev),
        "device_ctx": host_us(device_ctx, dev),
        "empty_one": host_us(lambda: torch.empty((1, B), dtype=torch.float32, device=dev)),
        "empty_split5": host_us(lambda: torch.empty((151, B), dtype=torch.float32,
                                                    device=dev).split((6, 11, 1, 132, 1))),
        "contiguous6": host_us(lambda: [x.contiguous() for x in ins]),
        "alpha_numpy": host_us(lambda: float(np.float32(params.alpha ** t))),
        "k1_layout_lookup": host_us(ns._k1_layout, T.n_main, T.n_reorder, T.n_retail,
                                    sum(T.ro_L)),
    }
    hi = float(T.order_cap_heuristic * 2)
    acts, dems = ns.sample_streams_debug(params, SEED, hi, 1_024, device=dev)
    pieces["k1_entry_1024"] = entry_host_us(ns.episode_returns, params, acts, dems)
    pieces["first_k1_entry_1024"] = entry_host_us(first_k1_entry, libs["parent"], params, acts,
                                                  dems)
    pieces["k25_entry"] = entry_host_us(ns.batched_step, params, *ins, t)
    pieces["first_k25_entry"] = entry_host_us(first_k25_entry, libs["parent"], params, *ins, t)
    result["host_us"] = pieces
    print("host work pieces (us): " + ", ".join(f"{k} {v:.2f}" for k, v in pieces.items()),
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("net_k1_k25_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.utils.profiling import cuda_time

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    logs = _build.build()
    _build.library("net_episode")
    for so, out in logs.items():
        if "libnet_episode-" in so:
            print(f"ptxas ({pathlib.Path(so).name}): {chip_smoke.ptxas_entries(out)}", flush=True)
    libs, vlogs = build_all()
    for name, log in vlogs.items():
        print(f"ptxas ({name}): {chip_smoke.ptxas_entries(log)}", flush=True)
    result = {"card": smi, "ms": {}}

    def clock(fn, *args):
        return cuda_time(fn, *args, warmup=2, iters=ITERS)["best_ms"]

    parent = libs["parent"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    result["ms"]["launch_floor"] = [clock(lambda: check(parent.net_empty(stream), parent,
                                                        "empty")) for _ in range(2)]
    print(f"launch floor (an empty kernel through ctypes) on {smi}: "
          f"{result['ms']['launch_floor']} ms", flush=True)
    k1_cases(libs, clock, smi, result["ms"], dev)
    params, ins, t = k25_cases(libs, clock, smi, result["ms"], dev)
    k2_k26_cases(libs, clock, smi, result["ms"], dev)
    host_pieces(libs, params, ins, t, dev, result)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
