"""Time the InvManagement kernels of the PyTorch port at their default shapes
in turns with their parent design, on one CUDA card.

The package's InvManagement kernels (or_gym_inventory_torch/csrc/
im_episode.cu, im_policy.cu and im_lstm.cu on im_step.cuh and lstm.cuh)
take any stage count and lead time: params within the struct maxima
(IM_MAX_M1 stocked stages, lead times to IM_MAX_LT) keep the parent's
``struct ImParams`` and instances, any other takes the chain route
(``ImParamsG``, the C entry points ``*_chain``). The parent design took the
fixed struct alone: ``tools/im_caps_parent/`` keeps its five sources as
they were (im_step.cuh, im_episode.cu, im_policy.cu, im_lstm.cu, lstm.cuh),
built here against the package's other headers into the ignored
``build/im_caps_sweep/``. At the InvManagementBacklogEnv defaults both
libraries take the same packed arguments, so both entry points take the
same call. This script times every kernel whose source the chain route
changed, each launch of its C entry point alone with its plan, packed
actor and outputs made before (CUDA events around ``n`` launches a turn),
in turns parent, package, package, parent, ``rounds`` times, at the shapes
of PERF.md's kernel table:

- K7 (``K7`` streamed, ``K7r`` _random) and K9 at 65,536 x 30, K8 at
  4,194,304 x 16 x 30;
- K10 at 65,536 x 30, K11 and K12 at 65,536 x 16 x 30 (chip_smoke.py's
  seeded 64x64 actor, deterministic), K27 at 1,024 x 30 on the cluster and
  K27wide under a (512, 512) actor on the wide route (det head):
  tools/actor_sweep.py's cases;
- K22 and K23 at 262,144 x 30, K24 at 65,536 x 30 (the benchmark's
  encoder 64, hidden 128).

Before it times a kernel it holds the package's outputs against the
parent's bit for bit (a difference fails the run). It prints each kernel's
turns, the medians, the spread (the larger of the two sides' max - min) and
whether the package is slower than the parent by more than that spread,
with the card's name and power limit, and a JSON line of all of it.

    python3 tools/im_caps_sweep.py [--rounds 3] [--kernels K7,K8,...]

Without a CUDA card it exits 1. It runs alone; ``chip_smoke.py`` (phase
55) no longer builds the parent or takes these turns.
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

PARENT = ROOT / "tools" / "im_caps_parent"
SOURCES = ("im_episode", "im_policy", "im_lstm")
SEED = 2024
KERNELS = ("K7", "K7r", "K8", "K9", "K10", "K11", "K12", "K22", "K23", "K24", "K27", "K27wide")
POLICY = ("K10", "K11", "K12", "K27", "K27wide")
LANES, EPISODES, MAIN_LANES, LSTM_LANES = 65_536, 16, 4_194_304, 262_144


def _parent_so(stem: str) -> pathlib.Path:
    from or_gym_inventory_torch.ops import _build
    return _build.BUILD_DIR / "im_caps_sweep" / f"lib{stem}_parent.so"


def start_parent_build() -> dict:
    """Start nvcc on the three parent sources (their own headers first, then
    the package's); returns {stem: process}."""
    from or_gym_inventory_torch.ops import _build
    out_dir = _build.BUILD_DIR / "im_caps_sweep"
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
    package's signatures of the fixed route's entry points (the parent had
    no ``*_chain``); returns {stem: library}. Raises if a build failed."""
    from or_gym_inventory_torch.ops import _build
    libs = {}
    for stem, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent {stem}.cu:\n{out}")
        lib = ctypes.CDLL(str(_parent_so(stem)))
        sigs = {fn: sig for src in actor_sweep.split_sources(stem)
                for fn, sig in _build.SIGNATURES[src].items() if not fn.endswith("_chain")}
        for fn, (argtypes, restype) in {**sigs, **_build._SHARED}.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        libs.update({src: lib for src in actor_sweep.split_sources(stem)})
    return libs


def _ptr(x):
    return None if x is None else x.data_ptr()


def cases(dev, parent_libs, names=KERNELS, general=False) -> dict:
    """{name: Case} of the kernels ``names`` at the shapes of the module's
    notes, each side's arguments built once by the package's own plans (the
    fixed route); the policy kernels' are tools/actor_sweep.py's."""
    import torch

    import chip_smoke as cs
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    a, key, stream = ctypes.addressof, ek._plan_key(dev), ek._stream(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = actor_sweep.cases(dev, parent_libs, [n for n in names if n in POLICY])
    keep = out.pop("_alive")
    imp = im.default_params(backlog=True)
    T, m1 = imp.periods, imp.m1
    plan, plan7 = ek._im_plan(imp, key), ek._im_plan(imp, key, False)
    tabs = (plan["table"].data_ptr(), plan["user_d"].data_ptr())
    acts, dems = ek.sample_streams_debug_im(imp, SEED, LANES, device=dev)
    keep += [plan, plan7, acts, dems]
    B = LANES

    def pair(name, shape, stem, fn, args, outs):
        out[name] = actor_sweep._pair(shape, stem, fn, args, outs, parent_libs)

    for name, random in (("K7", 0), ("K7r", 1)):
        if name in names:
            pair(name, f"{B} x {T}{', _random' if random else ''}", "im_episode",
                 "im_episode_returns",
                 lambda bs, random=random: (a(plan7["struct"]), a(plan7["k7"]),
                                            None if random else acts.data_ptr(), dems.data_ptr(),
                                            plan7["disc"].data_ptr(), bs[0].data_ptr(), SEED,
                                            random, 1, B, T, stream),
                 lambda: (torch.empty(B, **f32),))
    BM, E, BL = MAIN_LANES, EPISODES, LSTM_LANES
    if "K8" in names:
        pair("K8", f"{BM} x {E} x {T}", "im_episode", "im_episode_returns_fused",
             lambda bs: (a(plan["struct"]), a(plan["fused"]), *tabs, plan["disc"].data_ptr(),
                         bs[0].data_ptr(), SEED, 1, BM, E, T, stream),
             lambda: (torch.empty((E, BM), **f32),))
    if "K9" in names:
        pair("K9", f"{B} x {T}", "im_episode", "im_sample_streams",
             lambda bs: (a(plan["struct"]), *tabs, bs[0].data_ptr(), bs[1].data_ptr(), SEED, B,
                         1, T, stream),
             lambda: (torch.empty((T, 1, m1, B), **i32), torch.empty((T, 1, B), **i32)))
    if any(n in names for n in ("K22", "K23", "K24")):
        actor, log_std = cs.seeded_lstm_actor(imp, dev)
        obs = im.observation_space(imp).shape[0]
        half = ek._half_c(imp)
        det = ek._pack_lstm_actor(actor, None, obs, m1, half, dev)
        sto = ek._pack_lstm_actor(actor, ek.clipped_std(log_std), obs, m1, half, dev)
        keep += [det, sto]
        for name, dump in (("K22", False), ("K23", True)):
            if name in names:
                pair(name, f"{BL} x {T}", "im_lstm", "im_lstm_returns",
                     lambda bs: (a(plan["struct"]), a(det[0]), det[1].data_ptr(), *tabs,
                                 plan["disc"].data_ptr(), *map(_ptr, bs), SEED, 1, BL, T,
                                 stream),
                     lambda dump=dump: (torch.empty(BL, **f32),
                                        torch.empty((T, m1, BL), **i32) if dump else None,
                                        torch.empty((T, BL), **i32) if dump else None))
        if "K24" in names:
            rows = (((T + 1, m1), i32), ((T, m1), i32), ((T, m1), f32), ((T,), f32),
                    ((T,), i32))
            pair("K24", f"{B} x {T}", "im_lstm", "im_lstm_rollout_traj",
                 lambda bs: (a(plan["struct"]), a(sto[0]), sto[1].data_ptr(), *tabs,
                             plan["disc"].data_ptr(), *map(_ptr, bs), SEED, 1, B, T, stream),
                 lambda: tuple(torch.empty((*s, B), **d) for s, d in rows))
    out["_alive"] = keep
    return out


def turns(dev, parent_libs, names=KERNELS, rounds: int = 3) -> dict:
    """tools/actor_sweep.py's turns on this module's cases: each kernel bit
    for bit against the parent (raises where it differs), then timed in
    turns parent, package, package, parent. Returns {name: results}."""
    return actor_sweep.turns(dev, parent_libs, names, rounds, make=cases)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("im_caps_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default=None)
    args = ap.parse_args()
    from or_gym_inventory_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    names = tuple(args.kernels.split(",")) if args.kernels else KERNELS
    jobs = start_parent_build()
    _build.build()
    parent = finish_parent_build(jobs)
    res = turns(torch.device("cuda"), parent, names, args.rounds)
    for name, r in res.items():
        print(f"{actor_sweep.line(name, r)} on {smi}", flush=True)
    print(json.dumps({"im_caps_sweep": res, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
