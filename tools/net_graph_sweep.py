"""Time the NetInvMgmt kernels of the PyTorch port on the default graph in
turns with their parent design, on one CUDA card.

The package's kernels (or_gym_inventory_torch/csrc/net_episode.cu,
net_policy.cu) take the supply network as 32-byte records: a graph within
16 main nodes, 32 reorder links and 16 retail links (the default graph) in
the kernel parameters, any other staged by each block into its shared
memory, so they take any graph whose state fits a block. Their parent
design took the topology as a struct of fixed arrays in the kernel
parameters (16 main nodes, 32 reorder links, 16 retail links, 256 ring
words): ``tools/net_graph_parent/`` keeps its four sources as they were
(net_topo.cuh, net_step.cuh, net_episode.cu, net_policy.cu), built here
against the package's other headers. ``cases`` takes ``package_libs`` to
time a variant of the package's sources in the package's place. This script builds both parent
libraries into the ignored ``build/net_graph_sweep/`` directory (the
package's libraries as ``ops/_build.py`` builds them), then times every
kernel both designs have, each launch of its C entry point alone with its
plan, packed actor and outputs made before (CUDA events around ``n``
launches a turn), in turns parent, package, package, parent, ``rounds``
times, at the shapes of PERF.md's kernel table on the default graph:

- K2 4,194,304 x 16 x 30; K1, K3 and K26 65,536 x 30; K25 65,536 lanes;
- K5 and K6 65,536 x 16 x 30 under chip_smoke.py's seeded 64x64 actor
  (deterministic), K4 65,536 x 30 (its log_std);
- K29 1,024 x 30 on the cluster, the (256, 256) relu actor under the det
  head (TD3's) and the sac head.

Before it times a kernel it holds the package's output against the
parent's: K1-K3, K25 and K26 within rtol=1e-5 atol=1e-3 (the same step,
compiled from other code), the policy kernels by chip_smoke.py's share of
lanes. It prints each kernel's turns, the medians, the spread (the larger
of the two sides' max - min) and whether the package is slower than the
parent by more than that spread, with the card's name and power limit, and
a JSON line of all of it.

    python3 tools/net_graph_sweep.py [--rounds 3] [--kernels K2,K1,...] [--designs]

``--designs`` also builds and times ``DESIGNS``, the alternatives weighed
for the small graphs' records: the large graphs' class forced on the
default graph (records staged in shared memory), those records read
through the read-only path from device memory, and the small class
through the large class's step body.

Without a CUDA card it exits 1. It runs alone: ``chip_smoke.py`` no longer
builds the parent or takes these turns (phase 53 times the graphs' kernels
alone).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PARENT = ROOT / "tools" / "net_graph_parent"
PERIODS = 30
SEED = 2024
KERNELS = ("K2", "K1", "K3", "K25", "K26", "K5", "K6", "K4", "K29det", "K29sac")
TURN_MS = 60.0   # a turn's launches take about this long

# the parent's C entry points (the parent commit's ops/_build.py): they take
# the topology struct alone, and K2 and K26 no block size, K29's wide route
# no state layout, its occupancy no size class
_P, _I, _LL, _U32, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32,
                         ctypes.c_float)
PARENT_SIGNATURES = {
    "net_episode": {
        "net_episode_returns": ((_P, _P, _P, _P, _P, _P, _P, _LL, _I, _P), _I),
        "net_episode_returns_fused": ((_P, _P, _P, _P, _P, _U32, _F, _LL, _I, _I, _P), _I),
        "net_sample_streams": ((_P, _P, _P, _P, _U32, _F, _LL, _I, _I, _I, _P), _I),
        "net_batched_step": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                              _I, _I, _LL, _P), _I),
        "net_episode_returns_random": ((_P, _P, _P, _P, _P, _U32, _F, _LL, _I, _P), _I),
    },
    "net_policy": {
        "net_rollout_traj": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _U32, _LL, _I, _P), _I),
        "net_policy_returns": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _LL,
                                _I, _I, _I, _P), _I),
        "net_rollout_traj_wide": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I,
                                   _LL, _I, _P), _I),
        "net_rollout_traj_cluster": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _U32,
                                      _I, _LL, _I, _P), _I),
        "net_rollout_traj_cluster_occupancy": ((_P, _I, _P), _I),
    },
}

# the parent's topology struct (tools/net_graph_parent/net_topo.cuh)
P_MAIN, P_RO, P_RT = 16, 32, 16


class ParentTopo(ctypes.Structure):
    """Mirror of the parent's ``struct NetTopo``: the counts, then fixed
    arrays of each link's, node's and retail link's fields."""
    _fields_ = [
        ("n_main", ctypes.c_int), ("n_ro", ctypes.c_int),
        ("n_rt", ctypes.c_int), ("backlog", ctypes.c_int),
        ("ro_sup", ctypes.c_int * P_RO), ("ro_pur", ctypes.c_int * P_RO),
        ("ro_L", ctypes.c_int * P_RO), ("ro_ring", ctypes.c_int * P_RO),
        ("ro_price", ctypes.c_float * P_RO), ("ro_g", ctypes.c_float * P_RO),
        ("is_factory", ctypes.c_int * P_MAIN),
        ("I0", ctypes.c_float * P_MAIN), ("h", ctypes.c_float * P_MAIN),
        ("C", ctypes.c_float * P_MAIN), ("o", ctypes.c_float * P_MAIN),
        ("v", ctypes.c_float * P_MAIN),
        ("rt_ret", ctypes.c_int * P_RT), ("rt_price", ctypes.c_float * P_RT),
        ("rt_b", ctypes.c_float * P_RT), ("rt_const", ctypes.c_int * P_RT),
        ("rt_off", ctypes.c_int * P_RT), ("rt_len", ctypes.c_int * P_RT),
        ("rt_base", ctypes.c_float * P_RT),
    ]


def parent_topology(packed) -> ParentTopo:
    """The parent's struct of ``net_step.PackedTopology`` ``packed`` (a graph
    within its maxima): the same values, field by field."""
    if packed.n_main > P_MAIN or packed.n_ro > P_RO or packed.n_rt > P_RT:
        raise ValueError("the parent design takes at most 16 main nodes, 32 reorder links "
                         "and 16 retail links")
    tp = ParentTopo(n_main=packed.n_main, n_ro=packed.n_ro, n_rt=packed.n_rt,
                    backlog=packed.backlog)
    for i, lk in enumerate(packed.links):
        for name in ("sup", "pur", "L", "ring", "price", "g"):
            getattr(tp, f"ro_{name}")[i] = getattr(lk, name)
    for n, nd in enumerate(packed.nodes):
        for name in ("is_factory", "I0", "h", "C", "o", "v"):
            getattr(tp, name)[n] = getattr(nd, name)
    for j, rt in enumerate(packed.retail):
        for name, field in (("ret", "ret"), ("price", "price"), ("b", "b"), ("const", "konst"),
                            ("off", "off"), ("len", "len"), ("base", "base")):
            getattr(tp, f"rt_{name}")[j] = getattr(rt, field)
    return tp


def _parent_so(stem: str) -> pathlib.Path:
    from or_gym_inventory_torch.ops import _build
    return _build.BUILD_DIR / "net_graph_sweep" / f"lib{stem}_parent.so"


def start_parent_build() -> dict:
    """Start nvcc on both parent sources (the package's headers on the
    include path after the parent's own); returns {stem: process}."""
    from or_gym_inventory_torch.ops import _build
    out_dir = _build.BUILD_DIR / "net_graph_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem in ("net_episode", "net_policy"):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(_parent_so(stem)), str(PARENT / f"{stem}.cu")]
        jobs[stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    return jobs


def finish_parent_build(jobs: dict) -> dict:
    """Wait for ``start_parent_build``'s jobs and bind both libraries;
    returns {stem: library}. Raises if a build failed."""
    from or_gym_inventory_torch.ops import _build
    libs = {}
    for stem, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent {stem}.cu:\n{out}")
        lib = ctypes.CDLL(str(_parent_so(stem)))
        sigs = {**PARENT_SIGNATURES[stem], **_build._SHARED}
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        libs[stem] = lib
    return libs


@dataclasses.dataclass
class Case:
    """One kernel's two launches: each runs its C entry point once and
    returns its outputs (a tuple of tensors)."""
    shape: str
    package: callable
    parent: callable
    policy: bool = False   # held by the share of lanes, not elementwise


def _call(lib, fn, *args):
    rc = getattr(lib, fn)(*args)
    if rc:
        raise RuntimeError(f"{fn}: CUDA error {rc}: {lib.cuda_error_message(rc).decode()}")


def cases(dev, parent_libs, names=KERNELS, package_libs=None, staged=False) -> dict:
    """{name: Case} of the kernels ``names`` on the default graph at the
    kernel table's shapes (see the module's notes); ``package_libs``
    ({stem: library} with the package's C entry points) in place of the
    package's own libraries; ``staged``: the package's launches take the
    class of large graphs (the records staged in shared memory, the tiles'
    and clusters' plans with their room) in place of the small class the
    default graph takes."""
    import torch

    import chip_smoke as cs
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    params = net.default_params(num_periods=PERIODS)
    T = params.topology
    key, stream = ek._plan_key(dev), ek._stream(dev)
    hi = float(T.order_cap_heuristic * 2)
    scale = ns._act_scale(hi)
    specs = ns._topology_link_specs(T, PERIODS)
    tp, disc, tab = ns._launch_plan(params, PERIODS, key, True)
    ptp = parent_topology(ns._pack_topology(params, specs))
    records = ns.RECORD_FLOATS * (T.n_main + T.n_reorder + T.n_retail) if staged else 0
    libs = package_libs or {stem: _build.library(stem) for stem in ("net_episode", "net_policy")}
    lib_e, lib_p = libs["net_episode"], libs["net_policy"]
    par_e, par_p = parent_libs["net_episode"], parent_libs["net_policy"]
    f32 = dict(dtype=torch.float32, device=dev)
    B = 65_536
    out = {}
    a = ctypes.addressof

    def args(topo):
        """The topology's arguments: the package's header and small struct
        (none when ``staged``), or the parent's struct."""
        if not isinstance(topo, ns._NetTopo):
            return (a(topo),)
        return (a(topo), None) if staged else ns._topo_args(topo)
    state, lay = ns._shared_layout(T)

    if "K2" in names:
        B2, E2 = 4_194_304, 16
        o_new, o_par = torch.empty(E2 * B2, **f32), torch.empty(E2 * B2, **f32)
        out["K2"] = Case(
            f"{B2} x {E2} x {PERIODS}",
            lambda: (_call(lib_e, "net_episode_returns_fused", *args(tp), a(lay), state.threads,
                           disc.data_ptr(), tab.data_ptr(), o_new.data_ptr(), SEED, scale,
                           B2, E2, PERIODS, stream), (o_new,))[1],
            lambda: (_call(par_e, "net_episode_returns_fused", a(ptp), a(lay), disc.data_ptr(),
                           tab.data_ptr(), o_par.data_ptr(), SEED, scale, B2, E2, PERIODS,
                           stream), (o_par,))[1])
    acts, dems = ns.sample_streams_debug(params, SEED, hi, B, device=dev)
    if "K3" in names:
        bufs = [tuple(torch.empty_like(x) for x in (acts, dems)) for _ in range(2)]

        def k3(lib, topo, bs):
            _call(lib, "net_sample_streams", *args(topo), tab.data_ptr(), bs[0].data_ptr(),
                  bs[1].data_ptr(), SEED, scale, B, PERIODS, 0, 1, stream)
            return bs
        out["K3"] = Case(f"{B} x {PERIODS}", lambda bs=bufs[0]: k3(lib_e, tp, bs),
                         lambda bs=bufs[1]: k3(par_e, ptp, bs))
    if "K1" in names:
        _, k1_lay, k1_st = ns._k1_layout(T.n_main, T.n_reorder, T.n_retail, sum(T.ro_L))
        o1 = [torch.empty(B, **f32) for _ in range(2)]

        def k1(lib, topo, o):
            _call(lib, "net_episode_returns", *args(topo), a(k1_lay), a(k1_st), acts.data_ptr(),
                  dems.data_ptr(), disc.data_ptr(), o.data_ptr(), B, PERIODS, stream)
            return (o,)
        out["K1"] = Case(f"{B} x {PERIODS}", lambda: k1(lib_e, tp, o1[0]),
                         lambda: k1(par_e, ptp, o1[1]))
    if "K26" in names:
        o26 = [torch.empty(B, **f32) for _ in range(2)]
        out["K26"] = Case(
            f"{B} x {PERIODS}",
            lambda: (_call(lib_e, "net_episode_returns_random", *args(tp), a(lay), state.threads,
                           dems.data_ptr(), disc.data_ptr(), o26[0].data_ptr(), SEED, scale,
                           B, PERIODS, stream), (o26[0],))[1],
            lambda: (_call(par_e, "net_episode_returns_random", a(ptp), a(lay),
                           dems.data_ptr(), disc.data_ptr(), o26[1].data_ptr(), SEED, scale,
                           B, PERIODS, stream), (o26[1],))[1])
    if "K25" in names:
        k25_tp, k25_lay, k25_st, lt, rows = ns._k25_launch(params, key)
        k25_ptp = parent_topology(ns._pack_topology(params, rings=ns._arriving_words(T.ro_L)))
        g = torch.Generator(device=dev).manual_seed(SEED)
        X, Y, U, RH = (x.contiguous() for x in ns.init_transposed(params, B, dev))
        RH = torch.rand(RH.shape, generator=g, device=dev).mul_(40).round_()
        ins = (X, Y, U, RH, acts[3].contiguous(), dems[3].contiguous())
        outs = [torch.empty((sum(rows), B), **f32).split(rows) for _ in range(2)]

        def k25(lib, topo, o):
            _call(lib, "net_batched_step", *args(topo), a(k25_lay), a(k25_st),
                  *(x.data_ptr() for x in ins), *(x.data_ptr() for x in o),
                  float(params.alpha ** 3), 3, lt, B, stream)
            return o
        out["K25"] = Case(f"{B} lanes", lambda: k25(lib_e, k25_tp, outs[0]),
                          lambda: k25(par_e, k25_ptp, outs[1]))
    if {"K5", "K6", "K4"} & set(names):
        actor, log_std = cs.seeded_actor(T.obs_dim, T.n_reorder, dev)
        w_std = ek.clipped_std(log_std)
        tile_lay = ns._shared_layout(T, False)[1]
        words = ns._shared_layout(T, False)[0].words
        half = [ns._half_hi(T)] * T.n_reorder

        def tiles(std):
            new, flat = ek._pack_tile_actor(actor, std, T.obs_dim, T.n_reorder, half, dev,
                                            dem_rows=T.n_retail, scratch_rows=3 * T.n_main,
                                            state_words=words, topo_floats=records)
            old, _ = ek._pack_tile_actor(actor, std, T.obs_dim, T.n_reorder, half, dev,
                                         dem_rows=T.n_retail, scratch_rows=3 * T.n_main,
                                         state_words=words)
            return new, old, flat
        E = 16
        for name, dump in (("K5", False), ("K6", True)):
            if name not in names:
                continue
            new, old, flat = tiles(None)
            bufs = [(torch.empty((E, B), **f32),
                     torch.empty((PERIODS, E, T.n_reorder, B), **f32) if dump else None,
                     torch.empty((PERIODS, E, T.n_retail, B), **f32) if dump else None)
                    for _ in range(2)]

            def k5(lib, topo, tile, bs, flat=flat):
                _call(lib, "net_policy_returns", *args(topo), a(tile_lay), a(tile),
                      flat.data_ptr(),
                      tab.data_ptr(), disc.data_ptr(), bs[0].data_ptr(),
                      None if bs[1] is None else bs[1].data_ptr(),
                      None if bs[2] is None else bs[2].data_ptr(), SEED, B, E, PERIODS, 0,
                      stream)
                return tuple(x for x in bs if x is not None)
            out[name] = Case(f"{B} x {E} x {PERIODS}",
                             lambda k5=k5, new=new, bs=bufs[0]: k5(lib_p, tp, new, bs),
                             lambda k5=k5, old=old, bs=bufs[1]: k5(par_p, ptp, old, bs),
                             policy=True)
        if "K4" in names:
            new, old, flat = tiles(w_std)
            shapes = ((PERIODS + 1, T.n_main), (PERIODS + 1, T.n_retail),
                      (PERIODS, T.n_reorder), (PERIODS, T.n_reorder), (PERIODS,),
                      (PERIODS, T.n_retail))
            bufs = [tuple(torch.empty((*s, B), **f32) for s in shapes) for _ in range(2)]

            def k4(lib, topo, tile, bs, flat=flat):
                _call(lib, "net_rollout_traj", *args(topo), a(tile_lay), a(tile),
                      flat.data_ptr(),
                      tab.data_ptr(), disc.data_ptr(), *(x.data_ptr() for x in bs), SEED, B,
                      PERIODS, stream)
                return bs
            out["K4"] = Case(f"{B} x {PERIODS}",
                             lambda new=new, bs=bufs[0]: k4(lib_p, tp, new, bs),
                             lambda old=old, bs=bufs[1]: k4(par_p, ptp, old, bs), policy=True)
    for mode in ("det", "sac"):
        name = f"K29{mode}"
        if name not in names:
            continue
        B29 = cs.LEARN_LANES
        actor, log_std = cs.seeded_offpolicy_actor(T.obs_dim, T.n_reorder, mode == "sac", dev)
        std = ek._offpolicy_std(mode, log_std)
        half = [ns._half_hi(T)] * T.n_reorder
        layout = ns._net_cluster_layout(T)
        parts = []
        for lib, lay_k in ((lib_p, dataclasses.replace(layout, topo_floats=records)),
                           (par_p, dataclasses.replace(layout, topo_floats=0))):
            st, flat = ek._pack_cluster_actor(actor, std, T.obs_dim, T.n_reorder, mode, half,
                                              PERIODS, state.words, False, dev, lay_k)
            held = ctypes.c_int(0)
            _call(lib, "net_rollout_traj_cluster_occupancy", a(st), 1,
                  *((int(not staged),) if lib is lib_p else ()), ctypes.byref(held))
            st.clusters = ek._cluster_grid(-(-B29 // st.lanes), held.value)
            parts.append((lib, st, flat))
        shapes = ((PERIODS + 1, T.n_main), (PERIODS + 1, T.n_retail), (PERIODS, T.n_reorder),
                  (PERIODS, T.n_reorder), (PERIODS,), (PERIODS, T.n_retail))
        bufs = [tuple(torch.empty((*s, B29), **f32) for s in shapes) for _ in range(2)]

        def k29(part, topo, bs):
            lib, st, flat = part
            _call(lib, "net_rollout_traj_cluster", *args(topo), a(lay), a(st), flat.data_ptr(),
                  tab.data_ptr(), disc.data_ptr(), *(x.data_ptr() for x in bs), SEED, 1, B29,
                  PERIODS, stream)
            return bs
        out[name] = Case(f"{B29} x {PERIODS}, {mode} head",
                         lambda k29=k29, p=parts[0], bs=bufs[0]: k29(p, tp, bs),
                         lambda k29=k29, p=parts[1], bs=bufs[1]: k29(p, ptp, bs), policy=True)
    out["_alive"] = (tp, ptp, disc, tab, acts, dems)
    return out


def _turn(fn, n) -> float:
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def turns(dev, parent_libs, names=KERNELS, rounds: int = 3) -> dict:
    """Each kernel of ``names``: its outputs held against the parent's, then
    its launches timed in turns parent, package, package, parent
    (``rounds`` times). Returns {name: results}."""
    import torch

    import chip_smoke as cs
    results = {}
    all_cases = cases(dev, parent_libs, names)
    for name in names:
        case = all_cases[name]
        got, want = case.package(), case.parent()
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        if not equal:
            for k, (g, w) in enumerate(zip(got, want)):
                if case.policy:
                    cs.lane_share(f"{name} output {k} vs the parent design", g, w)
                else:
                    cs.close(f"{name} output {k} vs the parent design", g, w, 1e-5, 1e-3)
        del got, want
        n = max(1, int(TURN_MS / max(_turn(case.package, 1), 1e-3)))
        sides = {"parent": [], "package": []}
        for _ in range(rounds):
            for side in ("parent", "package", "package", "parent"):
                sides[side].append(_turn(getattr(case, side), n))
        med = {s: statistics.median(v) for s, v in sides.items()}
        spread = max(max(v) - min(v) for v in sides.values())
        results[name] = {
            "shape": case.shape, "launches_a_turn": n, "equal_bit_for_bit": equal,
            "package_ms": sides["package"], "parent_ms": sides["parent"],
            "package_median_ms": med["package"], "parent_median_ms": med["parent"],
            "spread_ms": spread,
            "slower_than_spread": med["package"] - med["parent"] > spread}
    del all_cases
    torch.cuda.synchronize()
    return results


# the designs ``--designs`` times against each other (each a package build:
# its text changes of csrc/, and whether the default graph takes the class
# of large graphs): the parent; the package (the small class, field arrays
# in the parameters); the large class's records staged in shared memory;
# those records read from device memory through the read-only path instead;
# and the small class through the large class's step body (its records
# assembled from the fields, each link's loaded a link ahead)
DESIGNS = {
    "staged": ((), True),
    "ldg": ((("net_topo.cuh", "const int4 v[2] = {rec[2 * k], rec[2 * k + 1]};",
              "const int4 v[2] = {__ldg(rec + 2 * k), __ldg(rec + 2 * k + 1)};"),
             ("net_topo.cuh", """  int4* d = reinterpret_cast<int4*>(s);
  const int n = net_topo_floats(tp) / 4;
  for (int k = threadIdx.x; k < n; k += blockDim.x) d[k] = __ldg(tp.rec + k);
  __syncthreads();
  return TopoView{tp.n_main, tp.n_ro, tp.n_rt, tp.backlog, d};""",
              "  return TopoView{tp.n_main, tp.n_ro, tp.n_rt, tp.backlog, tp.rec};")), True),
    "generic_step": ((("net_step.cuh", "float step_view(const NetTopoSmall& tp,",
                       "float step_view_first_design(const NetTopoSmall& tp,"),), False),
}


def build_design(name, changes):
    """Start nvcc on a copy of csrc/ with ``changes`` (file, old, new) for
    both NetInvMgmt sources; returns {stem: (library path, process)}."""
    import shutil

    from or_gym_inventory_torch.ops import _build
    root = _build.BUILD_DIR / "net_graph_sweep" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    for fname, old, new in changes:
        text = (root / fname).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"design {name}: its change of {fname} does not apply")
        (root / fname).write_text(text.replace(old, new))
    jobs = {}
    for stem in ("net_episode", "net_policy"):
        so = root / f"lib{stem}.so"
        jobs[stem] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(root / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return jobs


def bind_design(jobs) -> dict:
    """Wait for ``build_design``'s jobs and bind them as the package."""
    from or_gym_inventory_torch.ops import _build
    libs = {}
    for stem, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in {**_build.SIGNATURES[stem], **_build._SHARED}.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        libs[stem] = lib
    return libs


def design_turns(dev, parent_libs, design_libs, names=KERNELS, rounds: int = 3) -> dict:
    """Each kernel of ``names`` under the parent, the package and each design
    of ``design_libs`` ({name: libraries}), its outputs held against the
    parent's as ``turns`` holds them, then timed in turns, the designs in
    order and back, ``rounds`` times. Returns {kernel: {design: ms turns}}."""
    import torch

    import chip_smoke as cs
    results = {}
    for name in names:
        sides = {"parent": cases(dev, parent_libs, (name,))[name].parent,
                 "package": cases(dev, parent_libs, (name,))[name].package}
        policy = cases(dev, parent_libs, (name,))[name].policy
        for d, libs in design_libs.items():
            sides[d] = cases(dev, parent_libs, (name,), libs, DESIGNS[d][1])[name].package
        want = sides["parent"]()
        for d, f in sides.items():
            for g, w in zip(f(), want):
                if policy:
                    cs.lane_share(f"{name} {d} vs the parent design", g, w)
                else:
                    cs.close(f"{name} {d} vs the parent design", g, w, 1e-5, 1e-3)
        torch.cuda.synchronize()
        n = max(1, int(TURN_MS / max(_turn(sides["package"], 1), 1e-3)))
        order = list(sides)
        times = {d: [] for d in order}
        for _ in range(rounds):
            for d in order + order[::-1]:
                times[d].append(_turn(sides[d], n))
        results[name] = times
        del sides
    torch.cuda.synchronize()
    return results


def line(name, r) -> str:
    return (f"{name} {r['shape']}: package {r['package_median_ms']:.4f} ms, parent "
            f"{r['parent_median_ms']:.4f} ms (medians of {len(r['package_ms'])} turns of "
            f"{r['launches_a_turn']} launches; package "
            f"{', '.join(f'{t:.4f}' for t in r['package_ms'])}; parent "
            f"{', '.join(f'{t:.4f}' for t in r['parent_ms'])}), spread {r['spread_ms']:.4f} ms, "
            f"{'SLOWER than the spread' if r['slower_than_spread'] else 'within the spread'}; "
            f"outputs {'bit for bit' if r['equal_bit_for_bit'] else 'within tolerance'}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("net_graph_sweep.py needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--designs", action="store_true",
                    help="time the designs of DESIGNS beside the parent and the package")
    args = ap.parse_args()
    from or_gym_inventory_torch.ops import _build
    jobs = start_parent_build()
    design_jobs = {d: build_design(d, changes) for d, (changes, _) in DESIGNS.items()
                   if changes and args.designs}
    _build.build()
    libs = finish_parent_build(jobs)
    design_libs = {d: bind_design(design_jobs[d]) if d in design_jobs else None
                   for d in (DESIGNS if args.designs else ())}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    names = tuple(args.kernels.split(","))
    if args.designs:
        results = design_turns(dev, libs, design_libs, names, args.rounds)
        for name, times in results.items():
            print(f"[net_graph_sweep] {name}: " + "; ".join(
                f"{d} {statistics.median(v):.4f} ms ({', '.join(f'{t:.4f}' for t in v)})"
                for d, v in times.items()) + f" on {smi}", flush=True)
    else:
        results = turns(dev, libs, names, args.rounds)
        for name, r in results.items():
            print(f"[net_graph_sweep] {line(name, r)} on {smi}", flush=True)
    print(json.dumps({"net_graph_sweep": results, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
