"""Time the InvManagement LSTM kernels K22-K24 of the PyTorch port at the
default actor in turns with their parent design, on one CUDA card.

The package's LSTM kernels take an actor of any encoder depth, encoder width
and hidden width: an actor within struct Lstm's arrays whose layout fits a
block keeps the fixed class (or_gym_inventory_torch/csrc/im_lstm.cu on
lstm.cuh, the lane side now in im_lstm.cuh), any other takes the general
class (``LstmG``, csrc/im_lstm_any.cu, the C entry points ``*_any`` and
``*_chain_any``). The parent design took the fixed class alone:
``tools/lstm_caps_parent/`` keeps its two sources as they were (im_lstm.cu,
lstm.cuh), built here against the package's other headers into the ignored
``build/lstm_caps_sweep/``. The benchmark actor (encoder 64, hidden 128)
takes the fixed class on both sides with the same packed arguments, so both
libraries' entry points take the same call. This script times each kernel,
each launch of its C entry point alone with its plan, packed actor and
outputs made before (CUDA events around ``n`` launches a turn), in turns
parent, package, package, parent, ``rounds`` times:

- the fixed route (InvManagementBacklogEnv's defaults): K22 and K23 at
  262,144 x 30, K24 at 65,536 x 30;
- the chain route (IM-chain12-lt40, ``*_chain``, the lanes' state in a
  workspace): K22c and K23c at 65,536 x 60, K24c at 4,096 x 60.

Before it times a kernel it holds the package's outputs against the
parent's bit for bit (a difference fails the run). It prints each kernel's
turns, the medians, the spread (the larger of the two sides' max - min) and
whether the package is slower than the parent by more than that spread,
with the card's name and power limit, and a JSON line of all of it.

    python3 tools/lstm_caps_sweep.py [--rounds 3] [--kernels K22,K24c,...]

Without a CUDA card it exits 1. It runs alone, outside ``chip_smoke.py``.
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

import actor_sweep  # noqa: E402  (tools/: _pair, turns, line)

PARENT = ROOT / "tools" / "lstm_caps_parent"
SEED = 2024
KERNELS = ("K22", "K23", "K24", "K22c", "K23c", "K24c")
LANES, LSTM_LANES, CHAIN_LANES, CHAIN_ENVS = 65_536, 262_144, 65_536, 4_096


def _parent_so() -> pathlib.Path:
    from or_gym_inventory_torch.ops import _build
    return _build.BUILD_DIR / "lstm_caps_sweep" / "libim_lstm_parent.so"


def start_parent_build():
    """Start nvcc on the parent's im_lstm.cu (its own lstm.cuh first, then
    the package's headers); returns the process."""
    from or_gym_inventory_torch.ops import _build
    _parent_so().parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(_parent_so()),
           str(PARENT / "im_lstm.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_parent_build(proc) -> dict:
    """Wait for the parent's build and bind it with the package's signatures
    of im_lstm.cu's entry points (the fixed class's, both routes); returns
    {"im_lstm": library}. Raises if the build failed."""
    from or_gym_inventory_torch.ops import _build
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent im_lstm.cu:\n{out}")
    lib = ctypes.CDLL(str(_parent_so()))
    for fn, (argtypes, restype) in {**_build.SIGNATURES["im_lstm"], **_build._SHARED}.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
    return {"im_lstm": lib}


def _ptr(x):
    return None if x is None else x.data_ptr()


def cases(dev, parent_libs, names=KERNELS, general=False) -> dict:
    """{name: Case} of the kernels ``names`` at the shapes of the module's
    notes, each side's arguments built once by the package's own plans and
    packing (the fixed class; on the chain route ``_im_lstm_launch``'s
    ImParamsG with its workspace, shared by the sides, which run in turn).
    Each closure binds its route's arguments as defaults."""
    import torch

    import chip_smoke as cs
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    a, key, stream = ctypes.addressof, ek._plan_key(dev), ek._stream(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out, keep = {}, []
    routes = (("", im.default_params(backlog=True), LSTM_LANES, LANES),
              ("c", cs.im_caps_params("IM-chain12-lt40"), CHAIN_LANES, CHAIN_ENVS))
    for tag, params, b_ret, b_traj in routes:
        if not any(f"K2{k}{tag}" in names for k in (2, 3, 4)):
            continue
        T, m1 = params.periods, params.m1
        plan = ek._im_plan(params, key)
        tabs = (plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr())
        actor, log_std = cs.seeded_lstm_actor(params, dev)
        std = ek.clipped_std(log_std)
        det = ek._im_lstm_launch(params, actor, None, max(b_ret, b_traj), dev)
        sto = ek._im_lstm_launch(params, actor, std, max(b_ret, b_traj), dev)
        if not isinstance(det[1], ek._Lstm) or det[3] != ("_chain" if tag else ""):
            raise AssertionError(f"the benchmark actor takes {type(det[1]).__name__} "
                                 f"{det[3]!r}, not the fixed class")
        keep += [plan, det, sto]
        suffix = det[3]
        for name, dump in ((f"K22{tag}", False), (f"K23{tag}", True)):
            if name in names:
                out[name] = actor_sweep._pair(
                    f"{b_ret} x {T}", "im_lstm", "im_lstm_returns" + suffix,
                    lambda bs, b=b_ret, det=det, tabs=tabs, T=T: (
                        a(det[0]), a(det[1]), det[2].data_ptr(), *tabs, *map(_ptr, bs), SEED,
                        1, b, T, stream),
                    lambda b=b_ret, dump=dump, T=T, m1=m1: (
                        torch.empty(b, **f32),
                        torch.empty((T, m1, b), **i32) if dump else None,
                        torch.empty((T, b), **i32) if dump else None),
                    parent_libs)
        if f"K24{tag}" in names:
            rows = (((T + 1, m1), i32), ((T, m1), i32), ((T, m1), f32), ((T,), f32),
                    ((T,), i32))
            out[f"K24{tag}"] = actor_sweep._pair(
                f"{b_traj} x {T}", "im_lstm", "im_lstm_rollout_traj" + suffix,
                lambda bs, b=b_traj, sto=sto, tabs=tabs, T=T: (
                    a(sto[0]), a(sto[1]), sto[2].data_ptr(), *tabs, *map(_ptr, bs), SEED, 1, b,
                    T, stream),
                lambda b=b_traj, rows=rows: tuple(torch.empty((*s, b), **d) for s, d in rows),
                parent_libs)
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
        print("lstm_caps_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default=None)
    args = ap.parse_args()
    from or_gym_inventory_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    names = tuple(args.kernels.split(",")) if args.kernels else KERNELS
    proc = start_parent_build()
    _build.build()
    parent = finish_parent_build(proc)
    res = turns(torch.device("cuda"), parent, names, args.rounds)
    for name, r in res.items():
        print(f"{actor_sweep.line(name, r)} on {smi}", flush=True)
    print(json.dumps({"lstm_caps_sweep": res, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
