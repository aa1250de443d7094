"""Time K9 and K21 on one CUDA card, each against its first design: K9
(``episode_kernels.sample_streams_debug_im``, InvManagement's random-policy
streams) and K21 (``episode_kernels.sample_normals_debug``, the policy
kernels' Box-Muller normals).

K9 (``im_sample_streams`` in or_gym_inventory_torch/csrc/im_episode.cu) runs
one thread a (lane, episode, ``kK9Periods`` periods) on a 2-D grid, an
instance per m1; K21 (``sample_normals`` in csrc/nv_policy.cu) one thread a
(lane, ``kK21Rows`` rows) on a 2-D grid. Their first designs (K9 a thread a
(episode, lane) walking its T periods, the actions in a frame; K21 a thread
an element; both finding their place by a 64-bit division) are kept as
copies in ``tools/k9_k21_parent.cu``, whose ``k9_k21_empty`` launches a
kernel that does nothing. This script builds, into the ignored
``build/k9_k21_sweep/`` directory, the first designs and copies of
im_episode.cu and nv_policy.cu with one change each, all at once: K9 at
each of 1, 2, 4 and 8 periods a thread and K21 at each of 1, 2, 4 and 8 rows
a thread, but the package's own; and K21's row loop in two other forms,
at 4 and 8 rows a thread: ``k21_pipe`` computes the next row's Philox
block past the end of the group too (the package skips it behind a
branch), ``k21_unrolled`` unrolls the rows, a copy of normal01 each (the
redesign's first form, which put cosf's never-run reduction in a stack
frame).

Then it times each launch alone (CUDA events around the C call, its plan
and outputs made before; best of 20 after a warm-up), in turns with the
first design (first, new, new, first) and each variant in turns with the
package's kernel (new, variant, variant, new), beside the launch floor (the
empty kernel through the same ctypes path) and the entry point (host work
inside the events):

- K9 on the ``InvManagementBacklogEnv`` defaults (m1 = 3, Poisson) at
  65,536 lanes x 30 (E = 1, the check shape) and at 1,024 lanes x 16
  episodes x 30 (chip_smoke.py phase 10's dump); on a chain of 8 stocked
  stages with lt 32 (the struct maxima) and in USER mode at 65,536 x 30;
- K21 at 64 rows x 65,536 lanes (the check shape) and 64 x 1,048,576.

Every run of the package's kernels and of every variant equals the entry
point's output bit for bit, and so must each first design. It prints each
time with the card's name and power limit, ptxas's registers and stack and
the SASS's LDL/STL of every K9 instance, of K21 and of the first designs,
K21's SASS instructions by opcode, and a JSON line of the results.

    python3 tools/k9_k21_sweep.py

Without a CUDA card it exits 1.
"""

from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from k3_k7_sweep import bind, check  # noqa: E402  (tools/, this script's directory)

SEED = 2024
PERIODS = 30
LANES = 65_536
MULTI = (1_024, 16)            # lanes, episodes
NORMAL_SHAPES = ((64, 65_536), (64, 1_048_576))   # rows, lanes
SPLITS = (1, 2, 4, 8)          # periods (K9) or rows (K21) a thread
ITERS = 20

K9_CONST = "constexpr int kK9Periods = {};"
K21_CONST = "constexpr int kK21Rows = {};"
# K21's row loop in the package: rolled, one copy of normal01, each pass
# forming this row's normal while it computes the next row's Philox block
# (skipped behind a branch past the group); and two other forms of it:
# ``k21_pipe``, the next block computed past the group too (no branch), and
# ``k21_unrolled``, this redesign's first form: the kK21Rows blocks and
# normals unrolled, then the stores
K21_LOOP = """      unsigned n0 = 0u, n1 = 0u;
      if (row + 1 < r1) {
        WordStream nx(seed, 1u, (unsigned)lane, 0u, (unsigned)(row + 1));
        n0 = nx.next();
        n1 = nx.next();
      }
"""
K21_PIPE = """      WordStream nx(seed, 1u, (unsigned)lane, 0u, (unsigned)(row + 1));
      const unsigned n0 = nx.next(), n1 = nx.next();
"""
K21_ROLLED = """    const int r0 = g * kK21Rows, r1 = min(r0 + kK21Rows, rows);
    WordStream ws(seed, 1u, (unsigned)lane, 0u, (unsigned)r0);
    unsigned w0 = ws.next(), w1 = ws.next();
#pragma unroll 1
    for (int row = r0; row < r1; ++row) {
""" + K21_LOOP + """      out[row * B + lane] = normal01(w0, w1);  // (rows, B)
      w0 = n0;
      w1 = n1;
    }
"""
K21_UNROLLED = """    float z[kK21Rows];
#pragma unroll
    for (int k = 0; k < kK21Rows; ++k) {
      WordStream ws(seed, 1u, (unsigned)lane, 0u, (unsigned)(g * kK21Rows + k));
      const unsigned w0 = ws.next();
      z[k] = normal01(w0, ws.next());
    }
#pragma unroll
    for (int k = 0; k < kK21Rows; ++k) {
      const int row = g * kK21Rows + k;
      if (row < rows) out[row * B + lane] = z[k];  // (rows, B)
    }
"""
K21_FORMS = {"k21_pipe": (K21_LOOP, K21_PIPE), "k21_unrolled": (K21_ROLLED, K21_UNROLLED)}

_P, _I, _LL, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
# the first designs' C entry points (tools/k9_k21_parent.cu)
PARENT = {
    "im_sample_streams_first": ((_P, _P, _P, _P, _P, _U32, _LL, _I, _I, _P), _I),
    "sample_normals_first": ((_P, _U32, _LL, _I, _P), _I),
    "k9_k21_empty": ((_P,), _I),
}


def package_split(src, const):
    """The package's value of ``const`` (K9_CONST or K21_CONST) in csrc/src."""
    from or_gym_inventory_torch.ops import _build
    pattern = re.escape(const).replace(r"\{\}", r"(\d+)")
    return int(re.search(pattern, (_build.CSRC / src).read_text()).group(1))


def variants():
    """{name: (source, [(old, new), ...])}: K9 at each of SPLITS periods a
    thread and K21 at each of SPLITS rows, but the package's own; K21's
    other row loops (``K21_FORMS``) at 4 and 8 rows a thread."""
    out = {}
    for tag, src, const in (("k9_p", "im_episode.cu", K9_CONST),
                            ("k21_r", "nv_policy.cu", K21_CONST)):
        have = package_split(src, const)
        for n in SPLITS:
            if n != have:
                out[f"{tag}{n}"] = (src, [(const.format(have), const.format(n))])
    have = package_split("nv_policy.cu", K21_CONST)
    for name, form in K21_FORMS.items():
        for n in (4, 8):
            rows = [] if n == have else [(K21_CONST.format(have), K21_CONST.format(n))]
            out[f"{name}_r{n}"] = ("nv_policy.cu", [form] + rows)
    return out


def build_all():
    """Compile the first designs and every variant at once; returns
    ({name: library}, {name: nvcc's output}, {name: library path})."""
    from or_gym_inventory_torch.ops import _build
    root = _build.BUILD_DIR / "k9_k21_sweep"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    so = root / "libparent.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
           str(ROOT / "tools" / "k9_k21_parent.cu")]
    jobs = {"parent": (so, PARENT, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))}
    for name, (src, changes) in variants().items():
        d = root / name
        shutil.copytree(_build.CSRC, d)
        text = (d / src).read_text()
        for old, new in changes:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {src} holds {old[:60]!r} {text.count(old)} times")
            text = text.replace(old, new)
        (d / src).write_text(text)
        stem = src.removesuffix(".cu")
        so = d / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / src)]
        jobs[name] = (so, _build.SIGNATURES[stem], subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs, paths = {}, {}, {}
    for name, (so, sigs, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name], logs[name], paths[name] = bind(so, sigs), out, str(so)
    return libs, logs, paths


def sass_opcodes(so_path, kernel):
    """{opcode: count} of the SASS of each function of ``so_path`` whose
    name holds ``kernel`` (cuobjdump -sass), keyed by function; None where
    the toolkit has no cuobjdump."""
    from or_gym_inventory_torch.ops import _build
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", so_path], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    funcs, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                funcs[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and name:
            funcs[name][m.group(1)] += 1
    return funcs


def k9_cases():
    """(label, params, lanes, episodes) of K9's timed shapes; the maxima are
    chip_smoke.py phase 10's chain of 8 stocked stages at lt 32."""
    import chip_smoke
    from or_gym_inventory_torch.envs import inv_management as im
    d = im.default_params(backlog=True)
    user = im.default_params(backlog=True, dist=5,
                             user_D=tuple((7 * t) % 41 for t in range(PERIODS)))
    return (("defaults", d, LANES, 1), ("defaults", d, *MULTI),
            ("maxima_m1_8_lt32", chip_smoke.im_chain(8, True, chip_smoke.IM_MAXIMA_L), LANES, 1),
            ("user", user, LANES, 1))


def k9_timings(libs, clock, smi, result, dev):
    import torch

    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    package, parent = _build.library("im_episode"), libs["parent"]
    stream = ek._stream(dev)
    names = [n for n in libs if n.startswith("k9_")]
    for label, params, lanes, E in k9_cases():
        m1, T = params.m1, params.periods
        plan = ek._im_plan(params, ek._plan_key(dev))
        want = ek.sample_streams_debug_im(params, SEED, lanes, E, device=dev)
        want = (want[0].reshape(T, E, m1, lanes), want[1].reshape(T, E, lanes))
        acts, dems = torch.empty_like(want[0]), torch.empty_like(want[1])
        args = (ctypes.addressof(plan["struct"]), plan["table"].data_ptr(),
                plan["user_d"].data_ptr(), acts.data_ptr(), dems.data_ptr(), SEED, lanes, E,
                T, stream)

        def new(lib):
            check(lib.im_sample_streams(*args), lib, "K9")

        def first():
            check(parent.im_sample_streams_first(*args), parent, "first K9")

        def equal():
            eq = torch.equal(acts, want[0]) and torch.equal(dems, want[1])
            acts.fill_(-1)
            dems.fill_(-1)
            return eq

        shape = f"{lanes}x{E}x{T}"
        times = result.setdefault(f"k9_{label}_{shape}", {"m1": m1})
        times["turns_first_new_new_first"] = [clock(first), clock(new, package),
                                              clock(new, package), clock(first)]
        new(package)
        if not equal():
            raise AssertionError(f"K9 alone, {label} at {shape}: not the entry point's streams")
        first()
        times["first_equal_bit_for_bit"] = equal()
        for name in names:
            times[name + "_turns_new_variant_variant_new"] = [
                clock(new, package), clock(new, libs[name]), clock(new, libs[name]),
                clock(new, package)]
            new(libs[name])
            if not equal():
                raise AssertionError(f"K9 {name}, {label} at {shape}: not the entry point's")
        times["entry"] = clock(ek.sample_streams_debug_im, params, SEED, lanes, E, dev)
        alone = min(times["turns_first_new_new_first"][1:3])
        times["host_work_ms"] = times["entry"] - alone
        times["bound_ms_bytes"] = lanes * E * T * (m1 + 1) * 4 / 3.35e9
        times["share_of_bound_alone"] = times["bound_ms_bytes"] / alone
        print(f"K9 {label} at {shape} on {smi}: " + ", ".join(
            f"{k} {v}" for k, v in times.items()), flush=True)
        if not times["first_equal_bit_for_bit"]:
            raise AssertionError(f"K9's first design, {label} at {shape}: not the redesign's")
        del want, acts, dems


def k21_timings(libs, clock, smi, result, dev):
    import torch

    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    package, parent = _build.library("nv_policy"), libs["parent"]
    stream = ek._stream(dev)
    names = [n for n in libs if n.startswith("k21_")]
    for rows, lanes in NORMAL_SHAPES:
        want = ek.sample_normals_debug(SEED, rows, lanes, device=dev)
        out = torch.empty_like(want)

        def new(lib):
            check(lib.sample_normals(out.data_ptr(), SEED, lanes, rows, stream), lib, "K21")

        def first():
            check(parent.sample_normals_first(out.data_ptr(), SEED, lanes, rows, stream),
                  parent, "first K21")

        def equal():
            eq = torch.equal(out, want)
            out.fill_(float("nan"))
            return eq

        shape = f"{rows}x{lanes}"
        times = result.setdefault(f"k21_{shape}", {})
        times["turns_first_new_new_first"] = [clock(first), clock(new, package),
                                              clock(new, package), clock(first)]
        new(package)
        if not equal():
            raise AssertionError(f"K21 alone at {shape}: not the entry point's normals")
        first()
        times["first_equal_bit_for_bit"] = equal()
        for name in names:
            times[name + "_turns_new_variant_variant_new"] = [
                clock(new, package), clock(new, libs[name]), clock(new, libs[name]),
                clock(new, package)]
            new(libs[name])
            if not equal():
                raise AssertionError(f"K21 {name} at {shape}: not the entry point's normals")
        times["entry"] = clock(ek.sample_normals_debug, SEED, rows, lanes, dev)
        alone = min(times["turns_first_new_new_first"][1:3])
        times["host_work_ms"] = times["entry"] - alone
        n = rows * lanes
        times["bound"] = chip_smoke.bound(n * 4, n * chip_smoke.NORMAL_OPS)
        times["share_of_bound_alone"] = times["bound"][0] / alone
        print(f"K21 at {shape} on {smi}: " + ", ".join(
            f"{k} {v}" for k, v in times.items()), flush=True)
        if not times["first_equal_bit_for_bit"]:
            raise AssertionError(f"K21's first design at {shape}: not the redesign's")
        del want, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k9_k21_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.utils.profiling import cuda_time

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    logs = _build.build()
    for lib in ("im_episode", "nv_policy"):
        _build.library(lib)
    for so, out in logs.items():
        if "libim_episode-" in so or "libnv_policy-" in so:
            print(f"ptxas ({pathlib.Path(so).name}): " + "; ".join(
                e for e in chip_smoke.ptxas_entries(out).split("; ")
                if e.startswith(("k_im_sample_streams", "k_sample_normals"))), flush=True)
    libs, vlogs, paths = build_all()
    for name, log in vlogs.items():
        print(f"ptxas ({name}): " + "; ".join(
            e for e in chip_smoke.ptxas_entries(log).split("; ")
            if e.startswith(("k_im_sample_streams", "k_sample_normals"))), flush=True)
    result = {"card": smi, "ms": {}, "sass": {}}
    for name, so in (("package im_episode", str(_build._target(_build.CSRC / "im_episode.cu"))),
                     ("package nv_policy", str(_build._target(_build.CSRC / "nv_policy.cu"))),
                     *((n, paths[n]) for n in paths if n != "parent" and not n.startswith("k9_")),
                     ("parent", paths["parent"])):
        counts = chip_smoke.sass_counts(so)
        print(f"SASS LDL/STL ({name}): " + ("cuobjdump not found" if counts is None else ", ".join(
            f"{k} {ld}/{st}" for k, (ld, st, _) in sorted(counts.items())
            if k.startswith(("k_im_sample_streams", "k_sample_normals")))), flush=True)
        for fn, ops in (sass_opcodes(so, "k_sample_normals") or {}).items():
            total = sum(ops.values())
            top = dict(ops.most_common(12))
            result["sass"][f"{name} {fn}"] = {"instructions": total, "opcodes": top}
            print(f"SASS ({name}) {fn}: {total} instructions; {top}", flush=True)

    def clock(fn, *args):
        return cuda_time(fn, *args, warmup=2, iters=ITERS)["best_ms"]

    parent = libs["parent"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    result["ms"]["launch_floor"] = [clock(lambda: check(parent.k9_k21_empty(stream), parent,
                                                        "empty")) for _ in range(2)]
    print(f"launch floor (an empty kernel through ctypes) on {smi}: "
          f"{result['ms']['launch_floor']} ms", flush=True)
    k9_timings(libs, clock, smi, result["ms"], dev)
    k21_timings(libs, clock, smi, result["ms"], dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
