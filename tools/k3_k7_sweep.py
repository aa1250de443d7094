"""Time K3 and K7 on one CUDA card, each against its first design: K3
(``net_step.sample_streams_debug``, NetInvMgmt's random-policy streams) and
K7 (``episode_kernels.episode_returns_im`` and ``episode_returns_im_random``,
InvManagement's stream-fed returns); then, for the tile kernels K5, K11 and
K19, the share of (episode, lane) returns that agree with the plain version
on an unnormalised actor.

K3 (``net_sample_streams`` in or_gym_inventory_torch/csrc/net_episode.cu)
runs one thread a (lane, episode, 4 periods); K7 (``im_episode_returns`` in
csrc/im_episode.cu) runs K8's episode body on ImSharedEpisode<M1>, its
streams staged by cp.async into two buffers of ``chunk`` periods. Their
first designs (K3 a thread a (lane, episode) walking its T periods, K7 on
the 1,232-byte ImEpisode frame) are kept as copies in
``tools/k3_k7_parent.cu``, whose ``k3_k7_empty`` launches a kernel that does
nothing. This script builds, into the ignored ``build/k3_k7_sweep/``
directory, the first designs and copies of net_episode.cu with one change
each, all at once:

- ``k3_p1``, ``k3_p2``: 1 or 2 periods a thread (``kK3Periods``, 4 in the
  package);
- ``k3_smem_tables``: the retail links' CDF tables copied into shared memory
  once a block and searched there;
- ``k3_1d``: the grid as this redesign first had it, one dimension of
  B x rows threads, each dividing its 64-bit index by B.

Then it times each launch alone (CUDA events around the C call, its plan
and inputs made before; best of 20 after a warm-up), in turns with the
first design (first, new, new, first), beside the launch floor (the empty
kernel through the same ctypes path) and the entry points (host work
inside the events; K7's first design also through its wrapper as it was):

- K3 at 65,536 lanes x 30 (E = 1, chip_smoke.py's main-path shape) and at
  1,024 lanes x 16 episodes x 30 dumped as episodes [8, 16); its variants
  in turns with the package's kernel;
- K7 on the ``InvManagementBacklogEnv`` defaults (m1 = 3, lt 10) and on a
  chain of 8 stocked stages with lt 32 (the struct maxima), at 65,536 x 30,
  streamed on K9's streams and ``_random`` on K9's demand; at 64, 128 and
  256 threads a block and 1, 2 and 4 periods a staging buffer.

Every run of the package's kernels equals the entry point's outputs bit for
bit (K7 also K8's returns); the first designs are checked for equality and
the result printed (C6's lane shares, once here, are tools/c6_sweep.py's).
It prints each time with the card's name and power limit, ptxas's
registers and stack, the SASS's LDL/STL of K3 and of every K7 instance,
and a JSON line of the results.

    python3 tools/k3_k7_sweep.py

Without a CUDA card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SEED = 2024
PERIODS = 30
LANES = 65_536
MULTI = (1_024, 16, (8, 16))   # lanes, episodes, dump range
THREADS = (64, 128, 256)
CHUNKS = (1, 2, 4)
ITERS = 20

# K3's variants as text changes of csrc/ (file, old, new)
K3_LOOP = ("  const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;\n"
           "  if (lane >= B) return;\n"
           "  const int rows = k3_groups(T) * W;\n"
           "  for (int q = blockIdx.y; q < rows; q += gridDim.y) {\n")
K3_GRID = "  const dim3 grid(blocks_for(B), rows < 65535 ? rows : 65535);"
K3_PERIODS = "constexpr int kK3Periods = 4;"
K3_CHANGES = {
    # 1 or 2 periods a thread, not the package's 4
    "k3_p1": (("net_episode.cu", K3_PERIODS, K3_PERIODS.replace("4", "1")),),
    "k3_p2": (("net_episode.cu", K3_PERIODS, K3_PERIODS.replace("4", "2")),),
    # the retail links' CDF tables copied into shared memory once a block and
    # searched there (philox.cuh's count_le and net_step.cuh's link_demand
    # read them with plain loads, which a shared pointer needs)
    "k3_smem_tables": (
        ("net_episode.cu", "// K3 on a 2-D grid:",
         "__host__ __device__ int k3_table_words(const NetTopo& tp) {\n"
         "  int n = 0;\n"
         "  for (int j = 0; j < tp.n_rt; ++j) {\n"
         "    const int end = tp.rt_off[j] + tp.rt_len[j];\n"
         "    n = end > n ? end : n;\n"
         "  }\n"
         "  return n;\n"
         "}\n\n// K3 on a 2-D grid:"),
        ("net_episode.cu", K3_LOOP,
         "  extern __shared__ float k3_tab[];\n"
         "  for (int k = threadIdx.x; k < k3_table_words(tp); k += blockDim.x)\n"
         "    k3_tab[k] = __ldg(tables + k);\n"
         "  __syncthreads();\n" + K3_LOOP),
        ("net_episode.cu", "draw_period(tp, tables, seed, (unsigned)lane,",
         "draw_period(tp, k3_tab, seed, (unsigned)lane,"),
        ("net_episode.cu", "k_sample_streams<<<grid, kThreads, 0, stream>>>(",
         "k_sample_streams<<<grid, kThreads, k3_table_words(*topo) * sizeof(float), stream>>>("),
        ("philox.cuh", "if (__ldg(tab + mid) <= u)", "if (tab[mid] <= u)"),
        ("net_step.cuh", "return __ldg(tab + min((int)t, tp.rt_len[j] - 1));",
         "return tab[min((int)t, tp.rt_len[j] - 1)];")),
    # this PR's first redesign: a 1-D grid of B x rows threads, each
    # dividing its 64-bit index by B
    "k3_1d": (
        ("net_episode.cu", K3_LOOP,
         "  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;\n"
         "  const long long lane = idx % B;\n"
         "  const int rows = k3_groups(T) * W;\n"
         "  for (int q = (int)(idx / B); q < rows; q += rows) {\n"),
        ("net_episode.cu", K3_GRID, "  const unsigned grid = blocks_for(B * rows);")),
}

_P, _I, _LL, _F, _U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                         ctypes.c_uint32)
# the first designs' C entry points (tools/k3_k7_parent.cu)
PARENT = {
    "net_sample_streams_first": ((_P, _P, _P, _P, _U32, _F, _LL, _I, _I, _I, _P), _I),
    "im_episode_returns_first": ((_P, _P, _P, _P, _P, _U32, _I, _I, _LL, _I, _P), _I),
    "k3_k7_empty": ((_P,), _I),
}


def bind(so, signatures):
    from or_gym_inventory_torch.ops import _build
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in {**signatures, **_build._SHARED}.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
    return lib


def build_all():
    """Compile the first designs and every variant at once; returns
    ({name: library}, {name: nvcc's output}, {name: library path})."""
    from or_gym_inventory_torch.ops import _build
    root = _build.BUILD_DIR / "k3_k7_sweep"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    so = root / "libparent.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
           str(ROOT / "tools" / "k3_k7_parent.cu")]
    jobs = {"parent": (so, PARENT, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))}
    for name, changes in K3_CHANGES.items():
        d = root / name
        shutil.copytree(_build.CSRC, d)
        for fname, old, new in changes:
            text = (d / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {fname} holds {old[:60]!r} {text.count(old)} times")
            (d / fname).write_text(text.replace(old, new))
        so = d / "libnet_episode.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / "net_episode.cu")]
        jobs[name] = (so, _build.SIGNATURES["net_episode"], subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs, paths = {}, {}, {}
    for name, (so, sigs, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name], logs[name], paths[name] = bind(so, sigs), out, str(so)
    return libs, logs, paths


def check(rc, lib, what):
    if rc:
        raise RuntimeError(f"{what}: {lib.cuda_error_message(rc).decode()}")


def first_k7_entry(lib, params, actions, demands, seed):
    """The first design's entry point: _im_returns_call as it was (no
    staging plan), launching the first design."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    ek._check_im_streams(params, demands, actions)
    dev = demands.device
    T, B = demands.shape
    plan = ek._im_plan(params, ek._plan_key(dev), False)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        check(lib.im_episode_returns_first(
            ctypes.addressof(plan["struct"]), None if actions is None else actions.data_ptr(),
            demands.data_ptr(), plan["disc"].data_ptr(), out.data_ptr(), seed or 0,
            int(actions is None), int(params.backlog), B, T, ek._stream(dev)), lib, "first K7")
    return out


def k3_cases(libs, clock, smi, result, dev):
    import torch

    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    params = net.default_params(num_periods=PERIODS)
    T = params.topology
    hi = float(T.order_cap_heuristic * 2)
    tp, _, tab = ns._launch_plan(params, PERIODS, ek._plan_key(dev), True)
    stream, scale = ek._stream(dev), ns._act_scale(hi)
    package, parent = _build.library("net_episode"), libs["parent"]
    for lanes, E, dump in ((LANES, 1, None), MULTI):
        e0, e1 = dump if dump is not None else (0, E)
        W = e1 - e0
        want = ns.sample_streams_debug(params, SEED, hi, lanes, PERIODS, E, dump, dev)
        want = tuple(x.reshape(PERIODS, W, -1, lanes) for x in want)
        acts, dems = torch.empty_like(want[0]), torch.empty_like(want[1])

        def new(lib):
            check(lib.net_sample_streams(ctypes.addressof(tp), tab.data_ptr(), acts.data_ptr(),
                                         dems.data_ptr(), SEED, scale, lanes, PERIODS, e0, e1,
                                         stream), lib, "K3")

        def first():
            check(parent.net_sample_streams_first(ctypes.addressof(tp), tab.data_ptr(),
                                                  acts.data_ptr(), dems.data_ptr(), SEED, scale,
                                                  lanes, PERIODS, e0, e1, stream),
                  parent, "first K3")

        def equal():
            return torch.equal(acts, want[0]) and torch.equal(dems, want[1])

        shape = f"{lanes}x{E}x{PERIODS}" + (f"_dump{e0}-{e1}" if dump else "")
        times = result.setdefault(f"k3_{shape}", {})
        times["turns_first_new_new_first"] = [clock(first), clock(new, package),
                                              clock(new, package), clock(first)]
        acts.zero_()
        new(package)
        if not equal():
            raise AssertionError(f"K3 alone at {shape}: not the entry point's streams")
        acts.zero_()
        first()
        times["first_equal_bit_for_bit"] = equal()
        for name in K3_CHANGES:
            acts.zero_()
            times[name + "_turns_new_variant_variant_new"] = [
                clock(new, package), clock(new, libs[name]), clock(new, libs[name]),
                clock(new, package)]
            if not equal():
                raise AssertionError(f"K3 {name} at {shape}: not the entry point's streams")
        times["entry"] = clock(ns.sample_streams_debug, params, SEED, hi, lanes, PERIODS, E,
                               dump, dev)
        times["bound_ms_bytes"] = lanes * W * PERIODS * (T.n_reorder + T.n_retail) * 4 / 3.35e9
        print(f"K3 at {shape} on {smi}: " + ", ".join(f"{k} {v}" for k, v in times.items()),
              flush=True)
        del want, acts, dems


def im_maxima():
    """A chain of 8 stocked stages with lt_max 32 (the struct maxima): the
    default's values taken in turn, lead times 3, 5, 10, 32 twice."""
    from or_gym_inventory_torch.envs import inv_management as im
    d = im.default_params()

    def cycle(xs, n):
        return tuple(xs[i % len(xs)] for i in range(n))
    return im.default_params(backlog=True, I0=cycle(d.I0, 8), r=cycle(d.r, 9),
                             k=cycle(d.k, 9), h=cycle(d.h, 8), c=cycle(d.c, 8),
                             L=(3, 5, 10, 32) * 2)


def k7_cases(libs, clock, smi, result, dev):
    import torch

    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    package, parent = _build.library("im_episode"), libs["parent"]
    stream = ek._stream(dev)
    for label, params in (("defaults_m1_3_lt10", im.default_params(backlog=True)),
                          ("maxima_m1_8_lt32", im_maxima())):
        m1, lt, T = params.m1, params.lt_max, params.periods
        plan = ek._im_plan(params, ek._plan_key(dev), False)
        a, d = ek.sample_streams_debug_im(params, SEED, LANES, device=dev)
        k8 = ek.episode_returns_im_fused(params, SEED, LANES, device=dev)
        out = torch.empty(LANES, dtype=torch.float32, device=dev)
        for mode in ("streamed", "random"):
            random = mode == "random"
            want = (ek.episode_returns_im_random(params, d, SEED) if random
                    else ek.episode_returns_im(params, a, d))
            if not torch.equal(want, k8):
                raise AssertionError(f"K7 {mode} at {label}: not K8's returns bit for bit")
            acts_ptr = None if random else a.data_ptr()

            def new(st):
                check(package.im_episode_returns(
                    ctypes.addressof(plan["struct"]), ctypes.addressof(st), acts_ptr,
                    d.data_ptr(), plan["disc"].data_ptr(), out.data_ptr(), SEED, int(random),
                    int(params.backlog), LANES, T, stream), package, "K7")

            def first():
                check(parent.im_episode_returns_first(
                    ctypes.addressof(plan["struct"]), acts_ptr, d.data_ptr(),
                    plan["disc"].data_ptr(), out.data_ptr(), SEED, int(random),
                    int(params.backlog), LANES, T, stream), parent, "first K7")

            entry_st = plan["k7"]
            times = result.setdefault(f"k7_{label}_{mode}", {
                "entry_plan": {f: getattr(entry_st, f) for f, _ in entry_st._fields_}})
            times["turns_first_new_new_first"] = [clock(first), clock(new, entry_st),
                                                  clock(new, entry_st), clock(first)]
            out.zero_()
            new(entry_st)
            if not torch.equal(out, want):
                raise AssertionError(f"K7 alone {mode} at {label}: not the entry point's")
            out.zero_()
            first()
            times["first_equal_bit_for_bit"] = bool(torch.equal(out, want))
            times["first_max_abs_diff"] = float((out - want).abs().max())
            grid = {}
            for threads in THREADS:
                for chunk in CHUNKS:
                    try:
                        p = ek._im_k7_plan(m1, lt, chunk=chunk, threads=threads)
                    except ValueError:
                        grid[f"t{threads}_c{chunk}"] = None   # no block holds it
                        continue
                    out.zero_()
                    grid[f"t{threads}_c{chunk}"] = [clock(new, p.struct()), p.blocks_per_sm]
                    if not torch.equal(out, want):
                        raise AssertionError(f"K7 {mode} at {threads} threads, chunk {chunk}: "
                                             "not the entry point's returns")
            times["kernel_alone_by_threads_chunk"] = grid
            if random:
                times["entry"] = clock(ek.episode_returns_im_random, params, d, SEED)
                times["first_entry"] = clock(first_k7_entry, parent, params, None, d, SEED)
            else:
                times["entry"] = clock(ek.episode_returns_im, params, a, d)
                times["first_entry"] = clock(first_k7_entry, parent, params, a, d, None)
            words = T * (1 if random else m1 + 1) + 1
            times["bound_ms_bytes"] = LANES * words * 4 / 3.35e9
            print(f"K7 {mode} at {label} ({LANES} x {T}) on {smi}: " + ", ".join(
                f"{k} {v}" for k, v in times.items()), flush=True)
        del a, d


def main() -> int:
    import torch
    argparse.ArgumentParser(description=__doc__).parse_args()
    if not torch.cuda.is_available():
        print("k3_k7_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.utils.profiling import cuda_time

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    logs = _build.build()
    for lib in ("net_episode", "im_episode"):
        _build.library(lib)
    for so, out in logs.items():
        if "libnet_episode-" in so or "libim_episode-" in so:
            print(f"ptxas ({pathlib.Path(so).name}): {chip_smoke.ptxas_entries(out)}", flush=True)
    libs, vlogs, paths = build_all()
    for name, log in vlogs.items():
        print(f"ptxas ({name}): {chip_smoke.ptxas_entries(log)}", flush=True)
    for name, so in (("package net_episode", str(_build._target(_build.CSRC / "net_episode.cu"))),
                     ("package im_episode", str(_build._target(_build.CSRC / "im_episode.cu"))),
                     ("parent", paths["parent"])):
        counts = chip_smoke.sass_counts(so)
        print(f"SASS LDL/STL ({name}): " + ("cuobjdump not found" if counts is None else ", ".join(
            f"{k} {ld}/{st}" for k, (ld, st, _) in sorted(counts.items())
            if k.startswith(("k_sample_streams", "k_im_returns<", "k_im_returns_first")))),
            flush=True)
    result = {"card": smi, "ms": {}}

    def clock(fn, *args):
        return cuda_time(fn, *args, warmup=2, iters=ITERS)["best_ms"]

    parent = libs["parent"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    result["ms"]["launch_floor"] = [clock(lambda: check(parent.k3_k7_empty(stream), parent,
                                                        "empty")) for _ in range(2)]
    print(f"launch floor (an empty kernel through ctypes) on {smi}: "
          f"{result['ms']['launch_floor']} ms", flush=True)
    k3_cases(libs, clock, smi, result["ms"], dev)
    k7_cases(libs, clock, smi, result["ms"], dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
