"""Time K13 on one CUDA card against its earlier designs: K13
(``episode_kernels.episode_returns_nv`` and ``episode_returns_nv_random``,
the Newsvendor returns of given or drawn orders on given demand).

K13 (``nv_episode_returns`` in or_gym_inventory_torch/csrc/nv_episode.cu)
runs one thread a lane with its pipeline in registers (an instance per lead
time) and its order and demand words staged into shared memory by cp.async,
two buffers of ``kK13Chunk`` periods, the periods of a chunk unrolled, on
``k13_threads`` a block (``struct NvParams``, from
``episode_kernels._nv_k13_plan``). Its earlier designs are kept in
``tools/k13_parent.cu``: the first (the ring in a local frame, each period's
loads on the chain) and the shared-memory form (the ring in the lane's
column of shared memory, the streams staged as now, one period stepped at a
time, its chunk and block given at the call); ``k13_empty`` launches a
kernel that does nothing.

This script builds, all at once into the ignored ``build/k13_sweep/``
directory, the earlier designs, a copy of the package's nv_episode.cu (for
its ptxas report) and copies with ``kK13Chunk`` at 4 and 16. Then it times
each launch alone (CUDA events around the C call, its plan and output made
before; best of 20 after a warm-up), beside the launch floor (the empty
kernel through the same ctypes path) and the entry point (host work inside
the events), streamed and ``_random``:

- in turns with the first design (first, new, new, first) at 65,536 lanes x
  50 periods (chip_smoke.py's check shape), 1,024 x 50 and 1,048,576 x 50 on
  benchmarks/benchmark_newsvendor.py's ENV_CONFIG_EVAL (lead time 5), and at
  L = 0 and L = 32 (the pipeline's depths at its edges) at 65,536 x 50;
- at 65,536 x 50 and L = 5, each other form in turns with the package's
  (new, form, form, new): the shared-memory form at 8 periods a buffer and
  128 threads (and at 1 period), the chunk of 4 and of 16, and 64 and 256
  threads a block.

Every run of every form equals the entry point's returns bit for bit (the
same step, the same order of sums, the same words); on K17's streams the
entry point also equals K16. It prints each time with the card's name and
power limit, ptxas's registers and stack and the SASS's LDL/STL of every
K13 instance and of the earlier designs, and a JSON line of the results.

    python3 tools/k13_sweep.py

Without a CUDA card it exits 1.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from k3_k7_sweep import bind, check  # noqa: E402  (tools/, this script's directory)

SEED = 2024
SHAPES = ((65_536, 5), (1_024, 5), (1_048_576, 5), (65_536, 0), (65_536, 32))  # lanes, L
CHUNK_CONST = "constexpr int kK13Chunk = {};"
CHUNKS = (4, 16)            # kK13Chunk of the rebuilt copies
THREADS = (64, 256)         # the package's block, set in the params struct
SMEM_FORMS = ((8, 128), (1, 128))   # the shared-memory form's (chunk, threads)
ITERS = 20

_P, _I, _LL, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
# the earlier designs' C entry points (tools/k13_parent.cu)
PARENT = {
    "nv_episode_returns_first": ((_P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I, _P), _I),
    "nv_episode_returns_smem": ((_P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I, _I, _I, _P), _I),
    "k13_empty": ((_P,), _I),
}


def build_all():
    """Compile the earlier designs, a copy of the package's source and its
    chunk variants at once; returns ({name: library}, {name: (library path,
    nvcc's output)})."""
    from or_gym_inventory_torch.ops import _build
    root = _build.BUILD_DIR / "k13_sweep"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    have = CHUNK_CONST.format(8)
    text = (_build.CSRC / "nv_episode.cu").read_text()
    if text.count(have) != 1:
        raise RuntimeError(f"nv_episode.cu holds {have!r} {text.count(have)} times")
    sources = {"parent": ROOT / "tools" / "k13_parent.cu",
               "package": _build.CSRC / "nv_episode.cu"}
    for chunk in CHUNKS:
        d = root / f"chunk{chunk}"
        shutil.copytree(_build.CSRC, d)
        (d / "nv_episode.cu").write_text(text.replace(have, CHUNK_CONST.format(chunk)))
        sources[f"chunk{chunk}"] = d / "nv_episode.cu"
    jobs = {}
    for name, src in sources.items():
        so = root / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src.parent), "-I",
               str(_build.CSRC), "-o", str(so), str(src)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs, built = {}, {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (str(so), log)
        libs[name] = bind(so, PARENT if name == "parent" else
                          _build.SIGNATURES["nv_episode"])
    return libs, built


def timings(libs, clock, smi, result, dev):
    import torch

    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    package, parent = _build.library("nv_episode"), libs["parent"]
    stream = ek._stream(dev)
    for lanes, L in SHAPES:
        params = chip_smoke.nv_params(L=L, gamma=0.99)
        T = params.step_limit
        plan = ek._nv_plan(params, ek._plan_key(dev))
        econ, acts, dems = ek.sample_streams_debug_nv_reset(params, SEED, lanes, 1, dev)
        econ, acts, dems = econ[0].contiguous(), acts[:, 0].contiguous(), dems[:, 0].contiguous()
        k16 = ek.episode_returns_nv_reset_fused(params, SEED, lanes, 1, dev)   # (lanes,)
        out = torch.empty(lanes, dtype=torch.float32, device=dev)
        for mode in ("streamed", "random"):
            rnd = mode == "random"
            want = (ek.episode_returns_nv_random(params, econ, dems, SEED) if rnd
                    else ek.episode_returns_nv(params, econ, acts, dems))
            if not torch.equal(want, k16):
                raise AssertionError(f"K13 {mode} at {lanes} x {T}, L = {L}: not K16's returns")
            args = (econ.data_ptr(), None if rnd else acts.data_ptr(), dems.data_ptr(),
                    plan["disc"].data_ptr(), out.data_ptr(), SEED, int(rnd), lanes, T)

            def new(lib=package, st=plan["struct"]):
                check(lib.nv_episode_returns(ctypes.addressof(st), *args, stream), lib, "K13")

            def first():
                check(parent.nv_episode_returns_first(ctypes.addressof(plan["struct"]), *args,
                                                      stream), parent, "first K13")

            def smem(chunk, threads):
                check(parent.nv_episode_returns_smem(ctypes.addressof(plan["struct"]), *args,
                                                     chunk, threads, stream), parent,
                      "shared-memory K13")

            def equal():
                eq = torch.equal(out, want)
                out.fill_(float("nan"))
                return eq

            shape = f"{lanes}x{T}_L{L}"
            times = result.setdefault(f"k13_{mode}_{shape}", {})
            times["turns_first_new_new_first"] = [clock(first), clock(new), clock(new),
                                                  clock(first)]
            new()
            if not equal():
                raise AssertionError(f"K13 alone, {mode} at {shape}: not the entry point's")
            first()
            times["first_equal_bit_for_bit"] = equal()
            if (lanes, L) == SHAPES[0]:
                forms = {f"smem_chunk{c}_threads{n}": (smem, (c, n)) for c, n in SMEM_FORMS}
                forms.update({f"chunk{c}": (new, (libs[f"chunk{c}"],)) for c in CHUNKS})
                for n in THREADS:
                    st = ek._NvParams.from_buffer_copy(plan["struct"])
                    st.k13_threads = n
                    forms[f"threads{n}"] = (new, (package, st))
                for name, (fn, fargs) in forms.items():
                    times[name + "_turns_new_form_form_new"] = [
                        clock(new), clock(fn, *fargs), clock(fn, *fargs), clock(new)]
                    fn(*fargs)
                    if not equal():
                        raise AssertionError(f"K13 {name}, {mode} at {shape}: not the entry "
                                             "point's")
            times["entry"] = (clock(ek.episode_returns_nv_random, params, econ, dems, SEED)
                              if rnd else clock(ek.episode_returns_nv, params, econ, acts,
                                                dems))
            alone = min(times["turns_first_new_new_first"][1:3])
            times["host_work_ms"] = times["entry"] - alone
            words = 5 + (T if rnd else 2 * T) + 1
            ops = T * (chip_smoke.nv_step_ops(params)
                       + ((10 * 8 + 9 * 2) + 3 if rnd else 0))   # the order's Philox block
            times["bound"] = chip_smoke.bound(lanes * words * 4, lanes * ops)
            times["share_of_bound_alone"] = times["bound"][0] / alone
            print(f"K13 {mode} at {shape} on {smi}: " + ", ".join(
                f"{k} {v}" for k, v in times.items()), flush=True)
            if not times["first_equal_bit_for_bit"]:
                raise AssertionError(f"K13's first design, {mode} at {shape}: not the "
                                     "redesign's")
        del econ, acts, dems, k16, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k13_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.utils.profiling import cuda_time

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    _build.library("nv_episode")
    libs, built = build_all()
    result = {"card": smi, "ms": {}, "ptxas": {}, "sass_ldl_stl": {}}
    for name, (so, log) in built.items():
        entries = [e for e in chip_smoke.ptxas_entries(log).split("; ")
                   if e.startswith("k_nv_returns")]
        counts = chip_smoke.sass_counts(so)
        local = {k: (ld, st) for k, (ld, st, _) in (counts or {}).items()
                 if k.startswith("k_nv_returns")}
        result["ptxas"][name], result["sass_ldl_stl"][name] = entries, local
        print(f"ptxas ({name}): {'; '.join(entries)}; SASS LDL/STL: "
              + ("cuobjdump not found" if counts is None else
                 ", ".join(f"{k} {ld}/{st}" for k, (ld, st) in sorted(local.items()))),
              flush=True)

    def clock(fn, *args):
        return cuda_time(fn, *args, warmup=2, iters=ITERS)["best_ms"]

    parent = libs["parent"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    result["ms"]["launch_floor"] = [clock(lambda: check(parent.k13_empty(stream), parent,
                                                        "empty")) for _ in range(2)]
    print(f"launch floor (an empty kernel through ctypes) on {smi}: "
          f"{result['ms']['launch_floor']} ms", flush=True)
    timings(libs, clock, smi, result["ms"], dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
