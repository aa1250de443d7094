"""Time the Newsvendor kernels of the PyTorch port at their default shapes in
turns with their parent design, on one CUDA card.

The package's Newsvendor kernels (or_gym_inventory_torch/csrc/
nv_episode.cu and nv_policy.cu on nv_step.cuh) take any lead time: within
NV_MAX_L K13 keeps its pipeline in registers (an instance per lead time)
and K14/K16 in a thread's local ring, as the parent did; past it K13, K14
and K16 keep it in a column of shared memory (their column instances), and
K28's wide route keeps every lane's pipeline in a column of shared memory
at any lead time. The parent design refused a lead time past NV_MAX_L:
``tools/nv_caps_parent/`` keeps its three sources as they were
(nv_step.cuh, nv_episode.cu, nv_policy.cu), built here against the
package's other headers into the ignored ``build/nv_caps_sweep/``. At
benchmark_newsvendor.py's ENV_CONFIG_EVAL (lead time 5, 50 periods) both
libraries take the same packed arguments, so both entry points take the
same call. This script times every kernel whose source this change
touched, each launch of its C entry point alone with its plan, packed actor
and outputs made before (CUDA events around ``n`` launches a turn), in
turns parent, package, package, parent, ``rounds`` times, at the shapes of
PERF.md's kernel table:

- K13 (``K13`` streamed, ``K13r`` _random), K14, K15 and K17 at
  65,536 x 50, K16 at 4,194,304 x 16 x 50;
- K18 at 65,536 x 50, K19 and K20 at 65,536 x 16 x 50 (chip_smoke.py's
  seeded 64x64 actor, deterministic), K28 at 1,024 x 50 on the cluster and
  K28wide under a (512, 512) actor on the wide route (det head):
  tools/actor_sweep.py's cases.

Before it times a kernel it holds the package's outputs against the
parent's bit for bit (a difference fails the run). It prints each kernel's
turns, the medians, the spread (the larger of the two sides' max - min) and
whether the package is slower than the parent by more than that spread,
with the card's name and power limit, and a JSON line of all of it.

With ``--designs`` it times K14 and K16 the same way for each of DESIGNS,
the package's nv_episode.cu built on a copy of csrc/ whose nv_step.cuh
bounds the local ring's reset (``nv_reset``) by NV_MAX_L in the loop
itself, in place of the launch that bounds it: what such a bound costs at
lead time 5.

    python3 tools/nv_caps_sweep.py [--rounds 3] [--kernels K13,K16,...] [--designs]

Without a CUDA card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import actor_sweep  # noqa: E402  (tools/: _pair, turns, line; the policy kernels' cases)

PARENT = ROOT / "tools" / "nv_caps_parent"
SOURCES = ("nv_episode", "nv_policy")
SEED = 2024
KERNELS = ("K13", "K13r", "K14", "K15", "K16", "K17", "K18", "K19", "K20", "K28", "K28wide")
POLICY = ("K18", "K19", "K20", "K28", "K28wide")
LANES, EPISODES, MAIN_LANES = 65_536, 16, 4_194_304
# nv_reset's loop (csrc/nv_step.cuh) and the forms of it that bound it by
# NV_MAX_L itself, timed with --designs on DESIGN_KERNELS
RESET = "  for (int j = 0; j < p.L; ++j) s.ring[j] = 0.f;\n  s.head = 0;"
DESIGNS = {
    "clamp_min": "  const int L = p.L < NV_MAX_L ? p.L : NV_MAX_L;\n"
                 "  for (int j = 0; j < L; ++j) s.ring[j] = 0.f;\n  s.head = 0;",
    "clamp_and": "  for (int j = 0; j < p.L && j < NV_MAX_L; ++j) s.ring[j] = 0.f;\n  s.head = 0;",
    "clamp_unroll1": "  const int L = p.L < NV_MAX_L ? p.L : NV_MAX_L;\n#pragma unroll 1\n"
                     "  for (int j = 0; j < L; ++j) s.ring[j] = 0.f;\n  s.head = 0;",
}
DESIGN_KERNELS = ("K14", "K16")


def _parent_so(stem: str) -> pathlib.Path:
    from or_gym_inventory_torch.ops import _build
    return _build.BUILD_DIR / "nv_caps_sweep" / f"lib{stem}_parent.so"


def start_parent_build() -> dict:
    """Start nvcc on the two parent sources (their own nv_step.cuh first,
    then the package's headers); returns {stem: process}."""
    from or_gym_inventory_torch.ops import _build
    out_dir = _build.BUILD_DIR / "nv_caps_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem in SOURCES:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(_parent_so(stem)), str(PARENT / f"{stem}.cu")]
        jobs[stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    return jobs


def finish_parent_build(jobs: dict) -> dict:
    """Wait for ``start_parent_build``'s jobs and bind the libraries with the
    package's signatures (the entry points kept theirs); returns {stem:
    library}. Raises if a build failed."""
    from or_gym_inventory_torch.ops import _build
    libs = {}
    for stem, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent {stem}.cu:\n{out}")
        lib = ctypes.CDLL(str(_parent_so(stem)))
        for fn, (argtypes, restype) in {**_build.SIGNATURES[stem], **_build._SHARED}.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        libs[stem] = lib
    return libs


def cases(dev, parent_libs, names=KERNELS, general=False) -> dict:
    """{name: Case} of the kernels ``names`` at the shapes of the module's
    notes, each side's arguments built once by the package's own plan; the
    policy kernels' are tools/actor_sweep.py's."""
    import torch

    import chip_smoke as cs
    from or_gym_inventory_torch.ops import episode_kernels as ek
    a, key, stream = ctypes.addressof, ek._plan_key(dev), ek._stream(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = actor_sweep.cases(dev, parent_libs, [n for n in names if n in POLICY])
    keep = out.pop("_alive")
    nvp = cs.nv_params()
    T = nvp.step_limit
    plan = ek._nv_plan(nvp, key)
    econ, acts, dems = ek.sample_streams_debug_nv_reset(nvp, SEED, LANES, device=dev)
    econ, acts, dems = (x.contiguous() for x in (econ[0], acts[:, 0], dems[:, 0]))
    keep += [plan, econ, acts, dems]
    B, BM, E = LANES, MAIN_LANES, EPISODES
    st, lgam, disc = a(plan["struct"]), plan["lgam"].data_ptr(), plan["disc"].data_ptr()

    def ptr(x):
        return None if x is None else x.data_ptr()

    def pair(name, shape, stem, fn, args, outs):
        out[name] = actor_sweep._pair(shape, stem, fn, args, outs, parent_libs)

    for name, random in (("K13", 0), ("K13r", 1)):
        if name in names:
            pair(name, f"{B} x {T}{', _random' if random else ''}", "nv_episode",
                 "nv_episode_returns",
                 lambda bs, random=random: (st, econ.data_ptr(), None if random else ptr(acts),
                                            dems.data_ptr(), disc, bs[0].data_ptr(), SEED,
                                            random, B, T, stream),
                 lambda: (torch.empty(B, **f32),))
    # nv_episodes: econ_in given (K14, K15; E = 1) or drawn (K16, K17); the
    # returns, or with the action and demand outputs the streams
    runs = {"K14": (B, 1, True, False), "K15": (B, 1, True, True),
            "K16": (BM, E, False, False), "K17": (B, 1, False, True)}
    for name, (lanes, eps, econ_in, dump) in runs.items():
        if name not in names:
            continue
        pair(name, f"{lanes} x {eps} x {T}" if eps > 1 else f"{lanes} x {T}", "nv_episode",
             "nv_episodes",
             lambda bs, lanes=lanes, eps=eps, econ_in=econ_in: (
                 st, lgam, econ.data_ptr() if econ_in else None, disc, *map(ptr, bs), SEED,
                 lanes, eps, T, stream),
             lambda lanes=lanes, eps=eps, econ_in=econ_in, dump=dump: (
                 None if dump else torch.empty((eps, lanes), **f32),
                 torch.empty((eps, 5, lanes), **f32) if dump and not econ_in else None,
                 torch.empty((T, eps, lanes), **f32) if dump else None,
                 torch.empty((T, eps, lanes), **f32) if dump else None))
    out["_alive"] = keep
    return out


def start_design_builds() -> dict:
    """Start nvcc on the package's nv_episode.cu over a copy of csrc/ for each
    of DESIGNS (its nv_step.cuh's reset loop replaced); returns {name: (the
    library's path, process)}."""
    import shutil

    from or_gym_inventory_torch.ops import _build
    jobs = {}
    for name, loop in DESIGNS.items():
        root = _build.BUILD_DIR / "nv_caps_sweep" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.CSRC, root)
        text = (root / "nv_step.cuh").read_text()
        if text.count(RESET) != 1:
            raise RuntimeError(f"design {name}: nv_reset's loop is not in nv_step.cuh")
        (root / "nv_step.cuh").write_text(text.replace(RESET, loop))
        so = root / "libnv_episode.so"
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(root / "nv_episode.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return jobs


def design_turns(dev, parent_libs, jobs, rounds: int = 3) -> dict:
    """DESIGN_KERNELS of each design of ``jobs`` (``start_design_builds``) in
    turns with the parent, the design in the package's place. Returns
    {design: {name: results}}."""
    from or_gym_inventory_torch.ops import _build
    package = _build.library
    out = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for design {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in {**_build.SIGNATURES["nv_episode"],
                                        **_build._SHARED}.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        _build.library = lambda stem="net_episode", lib=lib: (
            lib if stem == "nv_episode" else package(stem))
        try:
            out[name] = turns(dev, parent_libs, DESIGN_KERNELS, rounds)
        finally:
            _build.library = package
    return out


def turns(dev, parent_libs, names=KERNELS, rounds: int = 3) -> dict:
    """tools/actor_sweep.py's turns on this module's cases: each kernel bit
    for bit against the parent (raises where it differs), then timed in
    turns parent, package, package, parent. Returns {name: results}."""
    return actor_sweep.turns(dev, parent_libs, names, rounds, make=cases)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("nv_caps_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default=None)
    ap.add_argument("--designs", action="store_true",
                    help="also time K14 and K16 under each of DESIGNS (the reset's bound)")
    args = ap.parse_args()
    from or_gym_inventory_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    names = tuple(args.kernels.split(",")) if args.kernels else KERNELS
    jobs = start_parent_build()
    design_jobs = start_design_builds() if args.designs else {}
    _build.build()
    parent = finish_parent_build(jobs)
    dev = torch.device("cuda")
    res = turns(dev, parent, names, args.rounds)
    for name, r in res.items():
        print(f"{actor_sweep.line(name, r)} on {smi}", flush=True)
    designs = design_turns(dev, parent, design_jobs, args.rounds) if design_jobs else {}
    for design, rs in designs.items():
        for name, r in rs.items():
            print(f"[{design}] {actor_sweep.line(name, r)} on {smi}", flush=True)
    print(json.dumps({"nv_caps_sweep": res, "designs": designs, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
