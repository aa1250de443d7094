"""Time K4 and K29, the two heads of NetInvMgmt's trajectory kernel (the
PyTorch port's ``rollout_traj_net``), on one CUDA card: each against its
first design, K29's cluster tiles, and each kernel's actor alone against
its env alone.

K4 (``net_rollout_traj`` in or_gym_inventory_torch/csrc/net_policy.cu) is
K5's tensor-core tile with one stochastic episode a lane and the streams
written; its first design, a thread a lane on the FP32 cores with the state
in a local Episode, is kept as a copy in ``tools/net_traj_parent.cu``. K29
(``net_rollout_traj_cluster``) runs the (256, 256) relu actor over a
thread-block cluster; its first design, a block per 32 lanes with the
weights streamed from L2 (``net_rollout_traj_wide``), is the package's wide
route, unchanged. This script builds, into the ignored
``build/net_traj_sweep/`` directory, the first K4 and copies of
net_policy.cu with one change each, all at once:

- ``k4_actor_alone``: K4 without its draws and step (the obs stay the
  reset's): the actor alone;
- ``k4_env_alone``: K4 without its obs and actor (the actions read from a
  stale buffer; timing only): the draws, the step and the stores;
- ``k29_actor_alone``: K29 without the lane threads' snapshots, head and
  step: the obs, the noise and the actor;
- ``k29_upfront``: K29 with every (lane, period)'s head noise drawn at the
  tile's reset, as the demand is (the package draws a period's noise each
  period), on the plan that keeps the episode's noise; it fits 4 CTAs over
  32 lanes, not 64.

Then it times each launch alone (CUDA events around the C call, the plan
and the packed actor made before), with chip_smoke.py's seeded actors
(K4: the 64x64 tanh actor at 65,536 x 30; K29: the (256, 256) relu actor,
det and sac heads, at the learners' 1,024 lanes and at 65,536):

- K4: the first design and the tile in turns (first, tile, tile, first);
  the tile at 32 lanes (the plan takes 64); its actor alone and env alone;
- K29: the first design and the cluster in turns; each tile (C, N) of
  (4, 64), (4, 32), (8, 64) and (8, 32) on K29's layout
  (``net_step._net_cluster_layout``; the entry points take the first
  that fits); ``k29_upfront`` at 4 over 32; its env alone (the "uniform"
  head on the kept tile: the draws, the steps, no obs and no actor) and
  actor alone; the entry point (its route) and its wide route forced,
  host work inside the events;
- the rounds: a cluster holds one tile at a time, so its time is the
  rounds it walks (tiles over clusters, rounded up) times one tile's
  chain, while the first design's blocks overlap on the card. At B = 64 x
  clusters x w lanes (w = 1, 2, 4, 8, 16) and at 65,536, det head, the
  kept tile and the first design in turns (cluster, wide, wide, cluster).

Every run whose arithmetic is the entry point's equals its streams bit for
bit (K4's tile at 32 lanes; every K29 tile and ``k29_upfront`` equal the
kept tile's, which equals the entry point's where it takes the cluster,
and the first design's equals it where it takes the wide route: a lane's
sums do not depend on the tile or on when its noise was drawn); the first
designs sum in another order (K4 on the FP32 cores, K29's output layer in
one chain) and are held by the share of lanes. It prints each time with
the card's name and power limit, ptxas's registers and stack, and a JSON
line of the times.

    python3 tools/net_traj_sweep.py

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

SEED = 2024
K4_LANES = 65_536
K29_SHAPES = (1_024, 65_536)
K29_TILES = ((4, 64), (4, 32), (8, 64), (8, 32))
ROUNDS = (1, 2, 4, 8, 16)   # tiles a cluster of the rounds' batches
STREAMS = ("x", "u", "r", "raw", "reward", "demand")

# each variant: its (file, old, new) text changes of csrc/
VARIANTS = {
    "k4_actor_alone": (
        ("net_policy.cu", "    pair_draws<STOCH>(tp, tables, seed, lane, e, (unsigned)t, dem, z, S);"
         "  // rows now dead\n", ""),
        ("net_policy.cu", "    if (TRAJ) {\n      const float profit = step_view(",
         "    if (TRAJ && false) {\n      const float profit = step_view("),
        ("net_policy.cu", "    } else {\n      total += __ldg(disc + t) * step_view(",
         "    } else if (!TRAJ) {\n      total += __ldg(disc + t) * step_view(")),
    "k4_env_alone": (
        ("net_policy.cu", "    view_obs(tp, s, obs_pad, x, S);\n    __syncwarp();\n"
         "    float* a = mlp_tile_forward(m, w, smem) + n;",
         "    float* a = smem + m.s_x1 + n;"),),
    "k29_actor_alone": (
        ("net_policy.cu", "      if (lane) {\n        if (live) {\n          for (int k = 0; "
         "k < tp.n_main; ++k) xo[((long long)t",
         "      if (false) {\n        if (live) {\n          for (int k = 0; "
         "k < tp.n_main; ++k) xo[((long long)t"),),
    "k29_upfront": (
        ("net_policy.cu", "      if (!actor) offpolicy_noise(m.head, A, ws, zs + (long long)i * A);",
         "      offpolicy_noise(m.head, A, ws, zs + (long long)i * A);"),
        ("net_policy.cu", "i < Lc * A; i += kClusterThreads) {  // offpolicy_noise's normals",
         "i < 0; i += kClusterThreads) {  // offpolicy_noise's normals"),
        ("net_policy.cu", "zs + (actor ? n : (long long)n * T + t) * A",
         "zs + ((long long)n * T + t) * A")),
}
# the first K4's C entry point (tools/net_traj_parent.cu): topo, mlp,
# params, n_params, tables, disc, x, u, r, raw, reward, demand, seed, B, T,
# stream
_P, _I, _LL, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
PARENT_K4 = ((_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _LL, _I, _P), _I)


def bind(so, signatures):
    from or_gym_inventory_torch.ops import _build
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in {**signatures, **_build._SHARED}.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
    return lib


def build_all():
    """Compile the first K4 and every variant's net_policy.cu at once;
    returns ({name: library}, {name: ptxas's report})."""
    from or_gym_inventory_torch.ops import _build
    root = _build.BUILD_DIR / "net_traj_sweep"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    jobs = {}
    so = root / "libparent_k4.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
           str(ROOT / "tools" / "net_traj_parent.cu")]
    jobs["parent_k4"] = (so, {"net_rollout_traj": PARENT_K4}, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, changes in VARIANTS.items():
        d = root / name
        shutil.copytree(_build.CSRC, d)
        for fname, old, new in changes:
            text = (d / fname).read_text()
            if old not in text:
                raise RuntimeError(f"{name}: {fname} no longer holds {old!r}")
            (d / fname).write_text(text.replace(old, new))
        so = d / "libnet_policy.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / "net_policy.cu")]
        jobs[name] = (so, _build.SIGNATURES["net_policy"], subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, sigs, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name], logs[name] = bind(so, sigs), out
    return libs, logs


class Net:
    """NetInvMgmt's default graph at 30 periods, its launch plan on ``dev``
    and fresh outputs for ``B`` lanes."""

    def __init__(self, dev):
        from or_gym_inventory_torch.envs import net_inv_management as net
        from or_gym_inventory_torch.ops import episode_kernels as ek
        from or_gym_inventory_torch.ops import net_step as ns
        self.dev, self.params = dev, net.default_params(num_periods=30)
        self.topo = self.params.topology
        self.T = self.params.num_periods
        self.tp, self.disc, self.tab = ns._launch_plan(self.params, self.T, ek._plan_key(dev),
                                                       True)
        self.state, self.lay = ns._shared_layout(self.topo)
        self.tile_state = ns._shared_layout(self.topo, False)

    def outputs(self, B):
        import torch
        t, f32 = self.topo, dict(dtype=torch.float32, device=self.dev)
        T = self.T
        return dict(x=torch.empty((T + 1, t.n_main, B), **f32),
                    u=torch.empty((T + 1, t.n_retail, B), **f32),
                    r=torch.empty((T, t.n_reorder, B), **f32),
                    raw=torch.empty((T, t.n_reorder, B), **f32),
                    reward=torch.empty((T, B), **f32),
                    demand=torch.empty((T, t.n_retail, B), **f32))

    def env_args(self, out):
        return (self.tab.data_ptr(), self.disc.data_ptr(),
                *(out[k].data_ptr() for k in STREAMS))


def check(rc, lib, what):
    if rc:
        raise RuntimeError(f"{what}: {lib.cuda_error_message(rc).decode()}")


def same(label, out, want):
    import torch
    for k in STREAMS:
        if not torch.equal(out[k], want[k]):
            raise AssertionError(f"{label}: {k} is not the entry point's")


def shares(out, want):
    import chip_smoke
    return {k: chip_smoke.lane_share(k, out[k], want[k], 1e-4, 1e-4, 0.0)[0] for k in STREAMS}


def k4_cases(net, libs, clock, smi, result):
    """K4 at 65,536 x 30: the first design and the tile in turns, the tile
    at 32 lanes, its actor alone and env alone."""
    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    dev, topo, B, T = net.dev, net.topo, K4_LANES, net.T
    actor, log_std = chip_smoke.seeded_actor(topo.obs_dim, topo.n_reorder, dev)
    std = ek.clipped_std(log_std)
    out = net.outputs(B)
    stream = ek._stream(dev)
    st, flat = ns._pack_net_tile_actor(topo, actor, std, dev)
    mlp, pflat = ek._pack_actor(actor, std, topo.obs_dim, topo.n_reorder,
                                [ns._half_hi(topo)] * topo.n_reorder, dev)
    package = _build.library("net_policy")

    def tile(lib, tst):
        check(lib.net_rollout_traj(ctypes.addressof(net.tp), ctypes.addressof(net.tile_state[1]),
                                   ctypes.addressof(tst), flat.data_ptr(), *net.env_args(out),
                                   SEED, B, T, stream), lib, "K4 tile")

    def first():
        lib = libs["parent_k4"]
        check(lib.net_rollout_traj(ctypes.addressof(net.tp), ctypes.addressof(mlp),
                                   pflat.data_ptr(), pflat.numel(), *net.env_args(out), SEED, B,
                                   T, stream), lib, "K4 first design")

    times = result.setdefault(f"k4_{B}x{T}", {})
    times["turns_first_tile_tile_first"] = [clock(first), clock(tile, package, st),
                                            clock(tile, package, st), clock(first)]
    want = ns.rollout_traj_net(net.params, actor, log_std, SEED, B, device=dev)
    tile(package, st)
    same("K4 tile", out, want)
    first()
    times["first_lanes_agreeing"] = shares(out, want)
    plan32 = ek._mlp_tile_plan(list(st.dims)[:st.n_layers + 1], topo.n_retail,
                               3 * topo.n_main, net.tile_state[0].words, 32)
    st32 = ek._MlpTile.from_buffer_copy(st)
    ek._set_mlp_tile(st32, plan32)
    times["tile_lanes64_bytes"] = st.s_total * 4
    times["tile_lanes32_bytes"] = st32.s_total * 4
    times["tile_lanes32"] = clock(tile, package, st32)
    same("K4 tile at 32 lanes", out, want)
    times["actor_alone"] = clock(tile, libs["k4_actor_alone"], st)
    times["env_alone"] = clock(tile, libs["k4_env_alone"], st)
    times["entry"] = clock(ns.rollout_traj_net, net.params, actor, log_std, SEED, B, "ppo",
                           "tanh", dev)
    print(f"K4 at {B} x {T} on {smi}: " + ", ".join(f"{k} {v}" for k, v in times.items()),
          flush=True)


def k29_pack(net, f, tile, layout):
    """(the ClusterMlp struct, the packed actor) of K29's head ``f`` at
    ``tile`` (C, N) on ``layout``, through the package's plan, struct and
    gather."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    plan = ek._cluster_plan(f["dims"], f["act"], f["with_std"], net.T, net.state.words, False,
                            *tile, True, layout)
    if plan.floats * 4 > ek.SMEM_OPTIN_BYTES:
        return None, plan.floats * 4
    st = ek._cluster_struct(f["dims"], f["act"], f["head"], f["half_hi"], plan)
    index = torch.from_numpy(ek._cluster_index(f["dims"], f["act"], f["with_std"], plan))
    flat = ek._gather(f["actor"], f["std"], index.to(net.dev), torch.zeros(1, device=net.dev),
                      net.dev)
    return (st, flat), plan.floats * 4


def set_grid(lib, st, B):
    """The persistent grid for ``B`` lanes from ``lib``'s own occupancy
    query; returns the clusters the card holds."""
    from or_gym_inventory_torch.ops import episode_kernels as ek
    held = ctypes.c_int(0)
    check(lib.net_rollout_traj_cluster_occupancy(ctypes.addressof(st), 1, ctypes.byref(held)),
          lib, "occupancy")
    st.clusters = ek._cluster_grid(-(-B // st.lanes), held.value)
    return held.value


def k29_heads(net, dev):
    import chip_smoke
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    topo = net.topo
    heads = {}
    for head in ("det", "sac"):
        actor, log_std = chip_smoke.seeded_offpolicy_actor(topo.obs_dim, topo.n_reorder,
                                                           head == "sac", dev)
        act = topo.n_reorder
        heads[head] = dict(head=head, actor=actor, log_std=log_std, act=act,
                           std=ek._offpolicy_std(head, log_std), with_std=head == "det",
                           dims=(topo.obs_dim, 256, 256, 2 * act if head == "sac" else act),
                           half_hi=[ns._half_hi(topo)] * act)
    return heads


def k29_cases(net, libs, clock, smi, result):
    """K29 at 1,024 and 65,536 lanes, det and sac: the first design and the
    cluster in turns, the tiles, ``k29_upfront``, the env and the actor
    alone, the entry point's two routes; then the rounds."""
    import dataclasses

    import torch

    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns
    dev, topo, T = net.dev, net.topo, net.T
    layout = ns._net_cluster_layout(topo)
    upfront = dataclasses.replace(layout, noise_per_period=False)
    package = _build.library("net_policy")
    stream = ek._stream(dev)
    heads = k29_heads(net, dev)
    for head, f in heads.items():
        for tile in K29_TILES:
            for name, lay in (("", layout), ("upfront ", upfront)):
                _, nbytes = k29_pack(net, f, tile, lay)
                result.setdefault("k29_tile_bytes", {})[
                    f"{head} {name}C={tile[0]} N={tile[1]}"] = nbytes
    print(f"K29 bytes a CTA (a block holds {ek.SMEM_OPTIN_BYTES}): {result['k29_tile_bytes']}",
          flush=True)

    def go(lib, st, flat, out, B):
        check(lib.net_rollout_traj_cluster(
            ctypes.addressof(net.tp), ctypes.addressof(net.lay), ctypes.addressof(st),
            flat.data_ptr(), *net.env_args(out), SEED, 1, B, T, stream), lib, "K29 cluster")

    def wide(wst, wflat, out, B):
        check(package.net_rollout_traj_wide(ctypes.addressof(net.tp), ctypes.addressof(wst),
                                            wflat.data_ptr(), *net.env_args(out), SEED, 1, B, T,
                                            stream), package, "K29 first design")

    for head, f in heads.items():
        kept = ek._cluster_choice(f["dims"], f["act"], f["with_std"], T, net.state.words, False,
                                  True, layout)
        kept = (kept.cluster, kept.lanes)
        wst, wflat = ek._pack_wide_actor(f["actor"], f["std"], topo.obs_dim, f["act"], head,
                                         f["half_hi"], dev)
        for B in K29_SHAPES:
            times = result.setdefault(f"k29_{head}_{B}x{T}", {"kept_tile": kept})
            out = net.outputs(B)
            want = ns.rollout_traj_net_offpolicy(net.params, f["actor"], f["log_std"], SEED, B,
                                                 head, "relu", dev)
            packs = {}
            for tile in K29_TILES:
                packed, _ = k29_pack(net, f, tile, layout)
                if packed is not None:
                    packs[tile] = packed
                    times[f"clusters_c{tile[0]}_n{tile[1]}"] = set_grid(package, packed[0], B)
            st, flat = packs[kept]
            times["turns_wide_cluster_cluster_wide"] = [
                clock(wide, wst, wflat, out, B), clock(go, package, st, flat, out, B),
                clock(go, package, st, flat, out, B), clock(wide, wst, wflat, out, B)]
            # the entry point's streams are those of the route it took (past
            # net_step._NET_CLUSTER_MAX_ROUNDS rounds, the first design's)
            times["entry_route"] = ns.rollout_traj_net_offpolicy.route
            go(package, st, flat, out, B)
            ref = {k: v.clone() for k, v in out.items()}
            wide(wst, wflat, out, B)
            same(f"K29 {head} {B} {times['entry_route']} route",
                 ref if times["entry_route"] == "cluster" else out, want)
            times["wide_lanes_agreeing"] = shares(out, ref)
            for tile, (tst, tflat) in packs.items():
                times[f"cluster_c{tile[0]}_n{tile[1]}"] = clock(go, package, tst, tflat, out, B)
                same(f"K29 {head} {B} C={tile[0]} N={tile[1]}", out, ref)
            packed, _ = k29_pack(net, f, (4, 32), upfront)
            ust, uflat = packed
            times["clusters_upfront_c4_n32"] = set_grid(libs["k29_upfront"], ust, B)
            times["upfront_c4_n32"] = clock(go, libs["k29_upfront"], ust, uflat, out, B)
            same(f"K29 {head} {B} k29_upfront", out, ref)
            times["actor_alone"] = clock(go, libs["k29_actor_alone"], st, flat, out, B)
            env_plan = ek._cluster_plan(f["dims"], f["act"], False, T, net.state.words, False,
                                        *kept, False, layout)
            env = ek._cluster_struct(f["dims"], f["act"], "uniform", f["half_hi"], env_plan)
            set_grid(package, env, B)
            times["env_alone"] = clock(go, package, env, flat, out, B)
            entry = ns.rollout_traj_net_offpolicy
            times["entry"] = clock(entry, net.params, f["actor"], f["log_std"], SEED, B, head,
                                   "relu", dev)
            saved = ek._pack_cluster_actor
            ek._pack_cluster_actor = lambda *a, **k: None   # the wrapper's wide route
            try:
                times["entry_wide"] = clock(entry, net.params, f["actor"], f["log_std"], SEED,
                                            B, head, "relu", dev)
            finally:
                ek._pack_cluster_actor = saved
            print(f"K29 {head} at {B} x {T} on {smi}: "
                  + ", ".join(f"{k} {v}" for k, v in times.items()), flush=True)
            del out, ref, want, packs
            torch.cuda.empty_cache()

    # the rounds, det head
    f = heads["det"]
    kept = ek._cluster_choice(f["dims"], f["act"], True, T, net.state.words, False, True, layout)
    (st, flat), _ = k29_pack(net, f, (kept.cluster, kept.lanes), layout)
    wst, wflat = ek._pack_wide_actor(f["actor"], f["std"], topo.obs_dim, f["act"], "det",
                                     f["half_hi"], dev)
    held = set_grid(package, st, kept.lanes)
    for B in [kept.lanes * held * w for w in ROUNDS] + [65_536]:
        out = net.outputs(B)
        set_grid(package, st, B)
        turns = [clock(go, package, st, flat, out, B), clock(wide, wst, wflat, out, B),
                 clock(wide, wst, wflat, out, B), clock(go, package, st, flat, out, B)]
        tiles = -(-B // kept.lanes)
        row = {"clusters": st.clusters, "rounds": -(-tiles // st.clusters),
               "turns_cluster_wide_wide_cluster": turns}
        result[f"k29_rounds_{B}x{T}"] = row
        print(f"K29 rounds, det, {B} lanes x {T} on {smi}: "
              + ", ".join(f"{k} {v}" for k, v in row.items()), flush=True)
        del out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("net_traj_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.utils.profiling import cuda_time

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    logs = _build.build()
    _build.library("net_policy")
    for so, out in logs.items():
        if "libnet_policy-" in so:
            print(f"ptxas (net_policy.cu): {chip_smoke.ptxas_entries(out)}", flush=True)
    libs, vlogs = build_all()
    for name, log in vlogs.items():
        print(f"ptxas ({name}): {chip_smoke.ptxas_entries(log)}", flush=True)
    result = {"card": smi, "ms": {}}

    def clock(fn, *args):
        return cuda_time(fn, *args, warmup=1, iters=5)["best_ms"]

    net = Net(dev)
    k4_cases(net, libs, clock, smi, result["ms"])
    k29_cases(net, libs, clock, smi, result["ms"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
