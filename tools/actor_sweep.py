"""Time the MLP actor kernels of the PyTorch port at their default shapes in
turns with their parent design, on one CUDA card.

The package's actor kernels (or_gym_inventory_torch/csrc/net_policy.cu,
im_policy.cu, nv_policy.cu on mlp_tile.cuh, wide_mlp.cuh and
cluster_mlp.cuh) take an actor of any depth, width and action count: an
actor within the fixed structs' arrays whose layout fits a block keeps the
parent's struct and layout (MlpTile, WideMlp, ClusterMlp), any other takes
the general class (MlpTileG, WideMlpG) through the C entry points named
``*_any``. Their parent design took the fixed structs alone:
``tools/actor_parent/`` keeps its six sources as they were (mlp_tile.cuh,
wide_mlp.cuh, cluster_mlp.cuh, net_policy.cu, im_policy.cu, nv_policy.cu),
built here against the package's other headers into the ignored
``build/actor_sweep/``. The default actors take the fixed class on both
sides, with the same packed arguments, so both libraries' entry points
take the same call. This script times every kernel the general class
changed the source of, each launch of its C entry point alone with its plan,
packed actor and outputs made before (CUDA events around ``n`` launches a
turn), in turns parent, package, package, parent, ``rounds`` times, at the
shapes of PERF.md's kernel table:

- K4 65,536 x 30, K5 and K6 65,536 x 16 x 30 (NetInvMgmt's default graph,
  chip_smoke.py's seeded 64x64 actor; K5/K6 deterministic);
- K10 65,536 x 30, K11 and K12 65,536 x 16 x 30 (InvManagement backlog);
- K18 65,536 x 50, K19 and K20 65,536 x 16 x 50 (Newsvendor
  ENV_CONFIG_EVAL);
- K27, K28 and K29 at 1,024 lanes on the cluster, the (256, 256) relu actor
  under the det head; K27wide and K29wide the same head under a (512, 512)
  actor on the wide route.

Before it times a kernel it holds the package's outputs against the
parent's bit for bit (the same code for the fixed class; a difference fails
the run). It prints each kernel's turns, the medians, the spread (the larger
of the two sides' max - min) and whether the package is slower than the
parent by more than that spread, with the card's name and power limit, and a
JSON line of all of it.

With ``--general`` it times, at the same shapes, the general class against
the fixed class on the same actor, both the package's (GENERAL_KERNELS: the
tile kernels and the wide route; the cluster has no general twin), and
records whether their outputs are equal bit for bit rather than failing:
whether the fixed class is still needed beside the general one.

    python3 tools/actor_sweep.py [--rounds 3] [--kernels K4,K5,...] [--general]

Without a CUDA card it exits 1. ``chip_smoke.py`` (phase 54) calls
``turns`` with ``general=True``; the turns against the parent design run
alone. tools/im_caps_sweep.py and tools/nv_caps_sweep.py take their policy
kernels' cases from ``cases``.
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

import net_graph_sweep as ngs  # noqa: E402  (tools/: Case, _turn, _call, line)

PARENT = ROOT / "tools" / "actor_parent"
SOURCES = ("net_policy", "im_policy", "nv_policy")
SEED = 2024
KERNELS = ("K4", "K5", "K6", "K10", "K11", "K12", "K18", "K19", "K20", "K27", "K28", "K29",
           "K27wide", "K29wide")
# the kernels whose actor has a general twin on the same route (the cluster's
# K27-K29 have none: past ClusterMlp an actor takes the wide route)
GENERAL_KERNELS = ("K4", "K5", "K6", "K10", "K11", "K12", "K18", "K19", "K20", "K27wide",
                   "K29wide")
LANES, EPISODES, LEARN_LANES = 65_536, 16, 1_024


def _parent_so(stem: str) -> pathlib.Path:
    from or_gym_inventory_torch.ops import _build
    return _build.BUILD_DIR / "actor_sweep" / f"lib{stem}_parent.so"


def start_parent_build() -> dict:
    """Start nvcc on the three parent sources (the package's headers on the
    include path after the parent's own); returns {stem: process}."""
    from or_gym_inventory_torch.ops import _build
    out_dir = _build.BUILD_DIR / "actor_sweep"
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
    package's signatures of the fixed class's entry points (the parent had
    no ``*_any`` and no ``*_chain``); returns {stem: library}. Raises if a
    build failed."""
    from or_gym_inventory_torch.ops import _build
    libs = {}
    for stem, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent {stem}.cu:\n{out}")
        lib = ctypes.CDLL(str(_parent_so(stem)))
        sigs = {fn: sig for src in split_sources(stem) for fn, sig in _build.SIGNATURES[src].items()
                if not fn.endswith(("_any", "_chain"))}
        for fn, (argtypes, restype) in {**sigs, **_build._SHARED}.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        libs.update({src: lib for src in split_sources(stem)})
    return libs


def split_sources(stem: str) -> tuple:
    """The package's sources that a parent's ``stem`` source held: the
    parents' im_policy.cu also held K27, now csrc/im_offpolicy.cu's."""
    return ("im_policy", "im_offpolicy") if stem == "im_policy" else (stem,)


def _pair(shape, stem, fn, args_of, outs, parent_libs, general=None):
    """A Case whose two sides call ``fn`` of the package's and the parent's
    ``stem`` library with ``args_of(outputs)``, each on its own copy of
    ``outs`` (a function making the output tensors). ``general``: (the
    general class's entry point, its ``args_of``): the package side calls
    that, and the other side the fixed class's ``fn``, both on the
    package's library."""
    from or_gym_inventory_torch.ops import _build
    bufs = [outs(), outs()]
    package = _build.library(stem)

    def side(lib, name, args, bs):
        ngs._call(lib, name, *args(bs))
        return tuple(x for x in bs if x is not None)
    if general is None:
        return ngs.Case(shape, lambda: side(package, fn, args_of, bufs[0]),
                        lambda: side(parent_libs[stem], fn, args_of, bufs[1]))
    g_fn, g_args = general
    return ngs.Case(shape, lambda: side(package, g_fn, g_args, bufs[0]),
                    lambda: side(package, fn, args_of, bufs[1]))


def _ptr(x):
    return None if x is None else x.data_ptr()


def cases(dev, parent_libs, names=KERNELS, general=False) -> dict:
    """{name: Case} of the kernels ``names`` at the shapes of the module's
    notes, each side's packed arguments built once by the package's own
    packing (the fixed class). ``general``: the package side takes the
    general class (MlpTileG, WideMlpG) on the same actor, the other side the
    fixed class, both the package's (GENERAL_KERNELS; ``parent_libs``
    unused)."""
    import torch

    import chip_smoke as cs
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    a, key, stream = ctypes.addressof, ek._plan_key(dev), ek._stream(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    B, E = LANES, EPISODES
    out, keep = {}, []

    def tile_pair(name, shape, stem, fn, pack, pairs, args, outs):
        """``out[name]`` for a tile kernel: ``pack(general)`` gives its
        struct first, then the rest ``args(*packed)`` takes."""
        fixed = pack(False)
        keep.extend(fixed)
        gen = None
        if general:
            packed = pack(True)
            ek._tile_launch(packed[0], pairs, dev)
            keep.extend(packed)
            gen = (fn + "_any", args(*packed))
        out[name] = _pair(shape, stem, fn, args(*fixed), outs, parent_libs, gen)

    # NetInvMgmt's default graph: K4-K6, K29
    netp = net.default_params(num_periods=30)
    T, steps = netp.topology, 30
    tp, disc, tab = ns._launch_plan(netp, steps, key, True)
    topo = ns._topo_args(tp)
    actor, log_std = cs.seeded_actor(T.obs_dim, T.n_reorder, dev)
    lay5 = ns._shared_layout(T, False)[1]
    keep += [tp, disc, tab, lay5]
    net_rows = ((steps + 1, T.n_main), (steps + 1, T.n_retail), (steps, T.n_reorder),
                (steps, T.n_reorder), (steps,), (steps, T.n_retail))
    if "K4" in names:
        tile_pair(
            "K4", f"{B} x {steps}", "net_policy", "net_rollout_traj",
            lambda g: ns._pack_net_tile_actor(T, actor, ek.clipped_std(log_std), dev, g), B,
            lambda st, flat: lambda bs: (*topo, a(lay5), a(st), flat.data_ptr(), tab.data_ptr(),
                                         disc.data_ptr(), *map(_ptr, bs), SEED, B, steps,
                                         stream),
            lambda: tuple(torch.empty((*s, B), **f32) for s in net_rows))
    for name, dump in (("K5", False), ("K6", True)):
        if name not in names:
            continue
        tile_pair(
            name, f"{B} x {E} x {steps}", "net_policy", "net_policy_returns",
            lambda g: ns._pack_net_tile_actor(T, actor, None, dev, g), B * E,
            lambda st, flat: lambda bs: (*topo, a(lay5), a(st), flat.data_ptr(), tab.data_ptr(),
                                         disc.data_ptr(), *map(_ptr, bs), SEED, B, E, steps, 0,
                                         stream),
            lambda dump=dump: (torch.empty((E, B), **f32),
                               torch.empty((steps, E, T.n_reorder, B), **f32) if dump else None,
                               torch.empty((steps, E, T.n_retail, B), **f32) if dump else None))

    # InvManagement backlog: K10-K12, K27
    imp = im.default_params(backlog=True)
    obs = im.observation_space(imp).shape[0]
    plan = ek._im_plan(imp, key)
    keep.append(plan)
    im_actor, im_log_std = cs.seeded_actor(obs, imp.m1, dev)
    im_head = (a(plan["struct"]),)
    im_tabs = (plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr())
    T_im = imp.periods
    im_rows = (((T_im + 1, imp.m1), i32), ((T_im, imp.m1), i32), ((T_im, imp.m1), f32),
               ((T_im,), f32), ((T_im,), i32))
    if "K10" in names:
        tile_pair(
            "K10", f"{B} x {T_im}", "im_policy", "im_rollout_traj",
            lambda g: ek._im_tile_actor(imp, im_actor, ek.clipped_std(im_log_std), dev, g), B,
            lambda st, flat: lambda bs: (*im_head, a(st), flat.data_ptr(), *im_tabs,
                                         *map(_ptr, bs), SEED, 1, B, T_im, stream),
            lambda: tuple(torch.empty((*s, B), **d) for s, d in im_rows))
    for name, dump in (("K11", False), ("K12", True)):
        if name not in names:
            continue
        tile_pair(
            name, f"{B} x {E} x {T_im}", "im_policy", "im_policy_returns",
            lambda g: ek._im_tile_actor(imp, im_actor, None, dev, g), B * E,
            lambda st, flat: lambda bs: (*im_head, a(st), flat.data_ptr(), *im_tabs,
                                         *map(_ptr, bs), SEED, 0, 1, B, E, T_im, stream),
            lambda dump=dump: (torch.empty((E, B), **f32),
                               torch.empty((T_im, E, imp.m1, B), **i32) if dump else None,
                               torch.empty((T_im, E, B), **i32) if dump else None))

    # Newsvendor ENV_CONFIG_EVAL: K18-K20, K28
    nvp = cs.nv_params()
    nv_plan = ek._nv_plan(nvp, key)
    keep.append(nv_plan)
    nv_actor, nv_log_std = cs.seeded_actor(nvp.obs_dim, 1, dev)
    T_nv = nvp.step_limit

    def nv_pack(std):
        def pack(g):
            st, flat = ek._nv_tile_actor(nvp, nv_actor, std, dev, g)
            return (*ek._nv_tile_launch(st, nv_plan["struct"], T_nv), flat)
        return pack
    if "K18" in names:
        tile_pair(
            "K18", f"{B} x {T_nv}", "nv_policy", "nv_rollout_traj",
            nv_pack(ek.clipped_std(nv_log_std)), B,
            lambda tile, nt, flat: lambda bs: (
                a(nv_plan["struct"]), a(tile), a(nt), flat.data_ptr(),
                nv_plan["lgam"].data_ptr(), *map(_ptr, bs), SEED, B, T_nv, stream),
            lambda: (torch.empty((5, B), **f32), torch.empty((T_nv, B), **f32),
                     torch.empty((T_nv, 1, B), **f32), torch.empty((T_nv, B), **f32),
                     torch.empty((T_nv, B), **f32)))
    for name, dump in (("K19", False), ("K20", True)):
        if name not in names:
            continue
        tile_pair(
            name, f"{B} x {E} x {T_nv}", "nv_policy", "nv_policy_returns", nv_pack(None), B * E,
            lambda tile, nt, flat: lambda bs: (
                a(nv_plan["struct"]), a(tile), a(nt), flat.data_ptr(),
                nv_plan["lgam"].data_ptr(), nv_plan["disc"].data_ptr(), *map(_ptr, bs), SEED,
                0, B, E, T_nv, stream),
            lambda dump=dump: (torch.empty((E, B), **f32),
                               torch.empty((E, 5, B), **f32) if dump else None,
                               torch.empty((T_nv, E, B), **f32) if dump else None,
                               torch.empty((T_nv, E, B), **f32) if dump else None))

    # K27-K29 at the learners' lanes: the cluster, and the wide route
    LB = LEARN_LANES
    lay29 = ns._shared_layout(T)[1]
    keep.append(lay29)
    fams = {"K27": ("im_offpolicy", "im_rollout_traj", obs, imp.m1, ek._half_c(imp), T_im, obs,
                    False, ek._K27_LAYOUT, (1, 1), 0, False),
            "K28": ("nv_policy", "nv_rollout_traj", nvp.obs_dim, 1, ek._nv_half_hi(nvp), T_nv,
                    nvp.obs_dim + 1, True, ek._K27_LAYOUT, (1,), ek._nv_wide_extra(nvp), False),
            "K29": ("net_policy", "net_rollout_traj", T.obs_dim, T.n_reorder,
                    [ns._half_hi(T)] * T.n_reorder, steps, ns._shared_layout(T)[0].words,
                    False, ns._net_cluster_layout(T), (1, int(tp.small is not None)),
                    ns._net_wide_extra(T), True)}
    for name in names:
        base = name.replace("wide", "")
        if base not in fams:
            continue
        (stem, fn, o_dim, act, half, horizon, words, anchors, layout, flags, extra,
         noise_rows) = fams[base]
        wide = name.endswith("wide")
        off_actor, off_log_std = cs.seeded_offpolicy_actor(o_dim, act, False, dev,
                                                           cs.OFF_WIDE if wide else None)
        std = ek._offpolicy_std("det", off_log_std)
        gen = None
        if wide:
            st, flat = ek._pack_wide_actor(off_actor, std, o_dim, act, "det", half, dev)
            fn_name = fn + "_wide"
            if general:
                gst, gflat = ek._pack_wide_actor(off_actor, std, o_dim, act, "det", half, dev,
                                                 extra, noise_rows, general=True)
                gen = fn_name + ek._wide_launch(gst, LB, dev)
                keep += [gst, gflat]
        else:
            st, flat = ek._pack_cluster_actor(off_actor, std, o_dim, act, "det", half, horizon,
                                              words, anchors, dev, layout)
            held = ctypes.c_int(0)
            ngs._call(_build.library(stem), fn + "_cluster_occupancy", a(st), *flags,
                      ctypes.byref(held))
            st.clusters = ek._cluster_grid(-(-LB // st.lanes), held.value)
            fn_name = fn + "_cluster"
        keep += [st, flat]
        if base == "K27":
            def head(st, flat):
                return (a(plan["struct"]), a(st), flat.data_ptr(), *im_tabs)
            tail = (SEED, 1, 1, LB, T_im, stream)
            rows = lambda: tuple(torch.empty((*s, LB), **d) for s, d in im_rows)  # noqa: E731
        elif base == "K28":
            def head(st, flat):
                return (a(nv_plan["struct"]), a(st), flat.data_ptr(), nv_plan["lgam"].data_ptr())
            tail = (SEED, 1, LB, T_nv, stream)
            rows = lambda: (torch.empty((5, LB), **f32),  # noqa: E731
                            *(torch.empty((T_nv, LB), **f32) for _ in range(4)))
        else:
            def head(st, flat):
                return (*topo, a(lay29), a(st), flat.data_ptr(), tab.data_ptr(), disc.data_ptr())
            tail = (SEED, 1, LB, steps, stream)
            rows = lambda: tuple(torch.empty((*s, LB), **f32) for s in net_rows)  # noqa: E731
        if gen is not None:
            gen = (gen, lambda bs, h=head(gst, gflat), tail=tail: (*h, *map(_ptr, bs), *tail))
        out[name] = _pair(f"{LB} x {horizon}, det head, "
                          f"{'(512, 512) on the wide route' if wide else 'cluster'}",
                          stem, fn_name,
                          lambda bs, h=head(st, flat), tail=tail: (*h, *map(_ptr, bs), *tail),
                          rows, parent_libs, gen)
    out["_alive"] = keep
    return out


def _same_bits(a, b) -> bool:
    """Whether two tensors of 4-byte elements hold the same bits (a NaN
    equal to the same NaN)."""
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def turns(dev, parent_libs, names=KERNELS, rounds: int = 3, general=False,
          make=None, bits=True) -> dict:
    """Each kernel of ``names``: its outputs held against the parent's bit
    for bit (raises where they differ), then its launches timed in turns
    parent, package, package, parent (``rounds`` times). ``general``: the
    general class against the fixed one (``cases``), a difference recorded
    with its max |diff| rather than raised; so is it with ``bits=False``
    (a parent of other arithmetic, tools/c6_sweep.py's). ``make``: the
    function that makes the cases in place of ``cases``
    (tools/im_caps_sweep.py's). Returns {name: results}."""
    import statistics

    import torch
    results = {}
    all_cases = (make or cases)(dev, parent_libs, names, general)
    for name in names:
        case = all_cases[name]
        got, want = case.package(), case.parent()
        torch.cuda.synchronize()
        diff = max(float((g.double() - w.double()).abs().nan_to_num(float("inf")).max())
                   if not _same_bits(g, w) else 0.0 for g, w in zip(got, want))
        if diff and not general and bits:
            raise AssertionError(f"{name}: an output differs from the parent design's "
                                 f"(max |diff| {diff})")
        del got, want
        n = max(1, int(ngs.TURN_MS / max(ngs._turn(case.package, 1), 1e-3)))
        sides = {"parent": [], "package": []}
        for _ in range(rounds):
            for side in ("parent", "package", "package", "parent"):
                sides[side].append(ngs._turn(getattr(case, side), n))
        med = {s: statistics.median(v) for s, v in sides.items()}
        spread = max(max(v) - min(v) for v in sides.values())
        results[name] = {
            "shape": case.shape, "launches_a_turn": n, "equal_bit_for_bit": not diff,
            "max_abs_diff": diff,
            "package_ms": sides["package"], "parent_ms": sides["parent"],
            "package_median_ms": med["package"], "parent_median_ms": med["parent"],
            "spread_ms": spread,
            "slower_than_spread": med["package"] - med["parent"] > spread}
    del all_cases
    torch.cuda.synchronize()
    return results


def line(name, r, general=False) -> str:
    """A kernel's turns as a line; with ``general`` the sides are named
    general (the package side) and fixed."""
    text = ngs.line(name, r)
    if not general:
        return text
    text = text.replace("package", "general").replace("parent", "fixed")
    if not r["equal_bit_for_bit"]:
        text = text.replace("within tolerance", f"DIFFERENT (max |diff| {r['max_abs_diff']:.3g})")
    return text


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("actor_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default=None)
    ap.add_argument("--general", action="store_true",
                    help="time the general class against the fixed one (GENERAL_KERNELS)")
    args = ap.parse_args()
    from or_gym_inventory_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    names = args.kernels.split(",") if args.kernels else \
        GENERAL_KERNELS if args.general else KERNELS
    jobs = None if args.general else start_parent_build()
    _build.build()
    parent = None if args.general else finish_parent_build(jobs)
    res = turns(torch.device("cuda"), parent, tuple(names), args.rounds, args.general)
    for name, r in res.items():
        print(f"{line(name, r, args.general)} on {smi}", flush=True)
    print(json.dumps({"actor_sweep": res, "general": args.general, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
