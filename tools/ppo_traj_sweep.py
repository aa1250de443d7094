"""Time K10 and K18, the PPO trajectory kernels of InvManagement and
Newsvendor (the PyTorch port's ``rollout_traj_im`` and ``rollout_traj_nv``),
on one CUDA card: each against its first design, its tiles, and its actor
alone against its env alone.

K10 (``im_rollout_traj`` in or_gym_inventory_torch/csrc/im_policy.cu) is
K11's tensor-core tile with one stochastic episode a lane and the streams
written; K18 (``nv_rollout_traj`` in csrc/nv_policy.cu) is K19's. Their
first designs, a thread a lane with the 64x64 tanh actor on the FP32 cores
(csrc/mlp.cuh), are kept as copies in ``tools/im_traj_parent.cu`` and
``tools/nv_traj_parent.cu``. This script builds, into the ignored
``build/ppo_traj_sweep/`` directory, the two first designs and copies of
im_policy.cu and nv_policy.cu with one change each, all at once:

- ``k10_actor_alone``/``k18_actor_alone``: the trajectory instance without
  its draws and its step (K18 also without the reset's table and search):
  the obs, the actor, the squash and the stores; the state stays the
  reset's;
- ``k10_env_alone``/``k18_env_alone``: the trajectory instance without its
  obs and actor (the raws read from a stale activation row; timing only):
  the reset, the draws, the step and the stores;
- ``k10_regs128``: K10-K12's kernel under ``__launch_bounds__(64, 8)``, at
  most 128 registers a thread, so that 16 warps an SM hold the 2,048 warps
  of 65,536 lanes in one wave (at K10's 160 registers 12 warps an SM take
  1.29 waves); ptxas reports what it spills.

Then it times each launch alone (CUDA events around the C call, the plan
and the packed actor made before), best of 5 after a warm-up, with
chip_smoke.py's seeded actors, K10 at 65,536 x 30 on
``inv_management.default_params()`` (backlog) and K18 at 65,536 x 50 on
benchmark_newsvendor.py's ENV_CONFIG_EVAL (chip_smoke.py ``nv_params``):

- the first design and the tile in turns (first, tile, tile, first);
- the tile at 32 lanes (the plan takes 64); K18 also on the linear count
  at 64 lanes (the layout past mu_max ~23,900, forced here at the
  defaults); K10 also as ``k10_regs128``;
- the actor alone and the env alone;
- the entry point, its host work (the pack's gather, the plan lookups,
  the allocations) inside the events.

Every run whose arithmetic is the entry point's equals its streams bit for
bit (the tile at 32 lanes: a lane's sums do not depend on the tile; K18's
linear count gives the table search's counts; ``k10_regs128``, the same
code under another register cap); the first designs sum on
the FP32 cores in another order and are held by the share of lanes. It
prints each time with the card's name and power limit, ptxas's registers
and stack, and a JSON line of the times.

    python3 tools/ppo_traj_sweep.py [--reward-seeds 1,2]

With ``--reward-seeds`` it then trains at chip_smoke.py's two reward
protocols (phase 15, InvManagement at tools/validate_kernel_ppo.py's
protocol; phase 24, Newsvendor at benchmark_newsvendor.py's PPO_CFG), once
per seed, both through K10 and K18, and prints each reward: how far a
reward moves with the training seed alone, beside the seed-0 rewards
chip_smoke.py prints. Without a CUDA card it exits 1.
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
LANES = 65_536
IM_STREAMS = ("inv", "actions", "raw", "reward", "demand")
NV_STREAMS = ("econ", "orders", "raw", "reward", "demand")

# each variant: its source and (old, new) text changes of it
VARIANTS = {
    "k10_actor_alone": ("im_policy.cu", (
        ("    const int d = im_demand(p, table, user_d, t, ws.next());",
         "    const int d = TRAJ ? 0 : im_demand(p, table, user_d, t, ws.next());"),
        ("    if (STOCH) {  // the normals into the transient rows",
         "    if (STOCH && !TRAJ) {  // the normals into the transient rows"),
        ("    if ((DUMP || TRAJ) && live) demo[row * B + lane] = d;\n"
         "    const float profit = step_and_record<BACKLOG>(p, s, t, act, d, ah);",
         "    if ((DUMP || TRAJ) && live) demo[row * B + lane] = d;\n"
         "    const float profit = TRAJ ? 0.f "
         ": step_and_record<BACKLOG>(p, s, t, act, d, ah);"))),
    "k10_env_alone": ("im_policy.cu", (
        ("    lane_obs(p, s, t, ah, x, S);  // the obs rows, then zero rows up to pad8\n"
         "    for (int k = m1 * (p.lt + 1); k < obs_pad; ++k) x[k * S] = 0.f;\n"
         "    __syncwarp();\n"
         "    const float* H = mlp_tile_forward(m, w, smem) + n;",
         "    const float* H = x;"),)),
    "k10_regs128": ("im_policy.cu", (
        ("template <bool STOCH, bool DUMP, bool TRAJ, bool BACKLOG>\n"
         "__global__ void k_im_policy_returns(",
         "template <bool STOCH, bool DUMP, bool TRAJ, bool BACKLOG>\n"
         "__global__ void __launch_bounds__(64, 8) k_im_policy_returns("),)),
    "k18_actor_alone": ("nv_policy.cu", (
        ("  dem.setup<LAYOUT>(smem, n);", "  if (!TRAJ) dem.setup<LAYOUT>(smem, n);"),
        ("    dem.upfront(seed, lane, e, T);", "    if (!TRAJ) dem.upfront(seed, lane, e, T);"),
        ("    if (!upfront) dem.chunk(seed, lane, e, t0, T);",
         "    if (!upfront && !TRAJ) dem.chunk(seed, lane, e, t0, T);"),
        ("      if (STOCH) {\n        WordStream ws(seed, 1u, lane, e, (unsigned)t);",
         "      if (STOCH && !TRAJ) {\n        WordStream ws(seed, 1u, lane, e, (unsigned)t);"),
        ("      float qty;\n"
         "      const float reward = nv_step_ring(p, ring, head, c, order, d, qty);",
         "      float qty = order;\n"
         "      const float reward = TRAJ ? 0.f "
         ": nv_step_ring(p, ring, head, c, order, d, qty);"))),
    "k18_env_alone": ("nv_policy.cu", (
        ("      tile_obs(p, c, ring, head, obs_pad, x, S);\n      __syncwarp();\n"
         "      float v = mlp_tile_forward(m, w, smem)[n];",
         "      float v = x[0];"),)),
}
_P, _I, _LL, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
# the first designs' C entry points (tools/im_traj_parent.cu,
# tools/nv_traj_parent.cu): params, mlp, actor, n_actor, then as the
# package's entry points
PARENTS = {
    "parent_k10": ("im_traj_parent.cu", {"im_rollout_traj": (
        (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _U32, _I, _LL, _I, _P), _I)}),
    "parent_k18": ("nv_traj_parent.cu", {"nv_rollout_traj": (
        (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _U32, _LL, _I, _P), _I)}),
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
    root = _build.BUILD_DIR / "ppo_traj_sweep"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    jobs = {}
    for name, (src, sigs) in PARENTS.items():
        so = root / f"lib{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
               str(ROOT / "tools" / src)]
        jobs[name] = (so, sigs, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True))
    for name, (fname, changes) in VARIANTS.items():
        d = root / name
        shutil.copytree(_build.CSRC, d)
        text = (d / fname).read_text()
        for old, new in changes:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {fname} holds {old!r} {text.count(old)} times")
            text = text.replace(old, new)
        (d / fname).write_text(text)
        stem = fname[:-3]
        so = d / f"lib{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / fname)]
        jobs[name] = (so, _build.SIGNATURES[stem], subprocess.Popen(
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


def same(label, out, want, names):
    import torch
    for k in names:
        if not torch.equal(out[k], want[k]):
            raise AssertionError(f"{label}: {k} is not the entry point's")


def shares(out, want, names):
    import chip_smoke
    return {k: chip_smoke.lane_share(k, out[k], want[k], 1e-4, 1e-2, 0.0)[0] for k in names}


def k10_cases(libs, clock, smi, result, dev):
    """K10 at 65,536 x 30: the first design and the tile in turns, the tile
    at 32 lanes, its actor alone and env alone, the entry point."""
    import torch

    import chip_smoke
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    params = im.default_params()
    B, T, m1 = LANES, params.periods, params.m1
    obs_dim = im.observation_space(params).shape[0]
    actor, log_std = chip_smoke.seeded_actor(obs_dim, m1, dev)
    std = ek.clipped_std(log_std)
    plan = ek._im_plan(params, ek._plan_key(dev))
    st, flat = ek._im_tile_actor(params, actor, std, dev)
    mlp, pflat = ek._pack_actor(actor, std, obs_dim, m1, ek._half_c(params), dev)
    i32, f32 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.float32, device=dev)
    out = dict(inv=torch.empty((T + 1, m1, B), **i32), actions=torch.empty((T, m1, B), **i32),
               raw=torch.empty((T, m1, B), **f32), reward=torch.empty((T, B), **f32),
               demand=torch.empty((T, B), **i32))
    env = (plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr(),
           *(out[k].data_ptr() for k in IM_STREAMS))
    stream, backlog = ek._stream(dev), int(params.backlog)
    package = _build.library("im_policy")

    def tile(lib, tst):
        check(lib.im_rollout_traj(ctypes.addressof(plan["struct"]), ctypes.addressof(tst),
                                  flat.data_ptr(), *env, SEED, backlog, B, T, stream),
              lib, "K10 tile")

    def first():
        lib = libs["parent_k10"]
        check(lib.im_rollout_traj(ctypes.addressof(plan["struct"]), ctypes.addressof(mlp),
                                  pflat.data_ptr(), pflat.numel(), *env, SEED, backlog, B, T,
                                  stream), lib, "K10 first design")

    times = result.setdefault(f"k10_{B}x{T}", {})
    times["turns_first_tile_tile_first"] = [clock(first), clock(tile, package, st),
                                            clock(tile, package, st), clock(first)]
    want = ek.rollout_traj_im(params, actor, log_std, SEED, B, device=dev)
    tile(package, st)
    same("K10 tile", out, want, IM_STREAMS)
    first()
    times["first_lanes_agreeing"] = shares(out, want, IM_STREAMS)
    st32 = ek._MlpTile.from_buffer_copy(st)
    ek._set_mlp_tile(st32, ek._mlp_tile_plan(list(st.dims)[:st.n_layers + 1], 0, 0, 0, 32))
    times["tile_bytes_lanes64_lanes32"] = [st.s_total * 4, st32.s_total * 4]
    times["tile_lanes32"] = clock(tile, package, st32)
    same("K10 tile at 32 lanes", out, want, IM_STREAMS)
    times["regs128"] = clock(tile, libs["k10_regs128"], st)
    same("K10 under 128 registers", out, want, IM_STREAMS)
    times["actor_alone"] = clock(tile, libs["k10_actor_alone"], st)
    times["env_alone"] = clock(tile, libs["k10_env_alone"], st)
    times["entry"] = clock(ek.rollout_traj_im, params, actor, log_std, SEED, B, "ppo", "tanh",
                           dev)
    print(f"K10 at {B} x {T} on {smi}: " + ", ".join(f"{k} {v}" for k, v in times.items()),
          flush=True)


def k18_cases(libs, clock, smi, result, dev):
    """K18 at 65,536 x 50: the first design and the tile in turns, the tile
    at 32 lanes and on the linear count, its actor alone and env alone, the
    entry point."""
    import torch

    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    params = chip_smoke.nv_params()
    B, T = LANES, params.step_limit
    actor, log_std = chip_smoke.seeded_actor(params.obs_dim, 1, dev)
    std = ek.clipped_std(log_std)
    plan = ek._nv_plan(params, ek._plan_key(dev))
    nv_st = plan["struct"]
    st, flat = ek._nv_tile_actor(params, actor, std, dev)
    tst, nt = ek._nv_tile_launch(st, nv_st, T)
    dims = tuple(st.dims[:st.n_layers + 1])
    mlp, pflat = ek._pack_actor(actor, std, params.obs_dim, 1, ek._nv_half_hi(params), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = dict(econ=torch.empty((5, B), **f32), orders=torch.empty((T, B), **f32),
               raw=torch.empty((T, 1, B), **f32), reward=torch.empty((T, B), **f32),
               demand=torch.empty((T, B), **f32))
    env = (plan["lgam"].data_ptr(), *(out[k].data_ptr() for k in NV_STREAMS))
    stream = ek._stream(dev)
    package = _build.library("nv_policy")

    def tile(lib, mt, ntile):
        check(lib.nv_rollout_traj(ctypes.addressof(nv_st), ctypes.addressof(mt),
                                  ctypes.addressof(ntile), flat.data_ptr(), *env, SEED, B, T,
                                  stream), lib, "K18 tile")

    def first():
        lib = libs["parent_k18"]
        check(lib.nv_rollout_traj(ctypes.addressof(nv_st), ctypes.addressof(mlp),
                                  pflat.data_ptr(), pflat.numel(), *env, SEED, B, T, stream),
              lib, "K18 first design")

    times = result.setdefault(f"k18_{B}x{T}", {"layout": int(nt.layout)})
    times["turns_first_tile_tile_first"] = [clock(first), clock(tile, package, tst, nt),
                                            clock(tile, package, tst, nt), clock(first)]
    want = ek.rollout_traj_nv(params, actor, log_std, SEED, B, device=dev)
    tile(package, tst, nt)
    same("K18 tile", out, want, NV_STREAMS)
    first()
    times["first_lanes_agreeing"] = shares(out, want, NV_STREAMS)
    for name, lanes, layout in (("tile_lanes32", 32, "upfront"),
                                ("linear_lanes64", 64, "linear")):
        p = ek._nv_tile_plan(dims, nv_st.L, nv_st.K, T, lanes, layout)
        mt, ntile = ek._nv_tile_structs(st, p)
        times[f"{name}_bytes"] = p.bytes
        times[name] = clock(tile, package, mt, ntile)
        same(f"K18 {name}", out, want, NV_STREAMS)
    times["actor_alone"] = clock(tile, libs["k18_actor_alone"], tst, nt)
    times["env_alone"] = clock(tile, libs["k18_env_alone"], tst, nt)
    times["entry"] = clock(ek.rollout_traj_nv, params, actor, log_std, SEED, B, "ppo", "tanh",
                           dev)
    print(f"K18 at {B} x {T} on {smi}: " + ", ".join(f"{k} {v}" for k, v in times.items()),
          flush=True)


def reward_seeds(seeds, smi, result, dev):
    """chip_smoke.py's phase-15 and phase-24 rewards trained from each of
    ``seeds``."""
    import chip_smoke
    for seed in seeds:
        avg, se, wall, n = chip_smoke.im_reward_check(dev, seed)
        nv_avg, nv_se, nv_wall, nv_n = chip_smoke.nv_reward_check(dev, chip_smoke.nv_params(),
                                                                  seed)
        row = {"im_validate": [avg, se, n, wall], "nv_ppo_cfg": [nv_avg, nv_se, nv_n, nv_wall]}
        result[f"rewards_seed_{seed}"] = row
        print(f"rewards, training seed {seed}, on {smi}: InvManagement validate {avg:.1f} +- "
              f"{se:.1f} ({n} updates, {wall:.1f} s), Newsvendor PPO_CFG {nv_avg:.1f} +- "
              f"{nv_se:.1f} ({nv_n} updates, {nv_wall:.1f} s)", flush=True)


def main() -> int:
    import argparse

    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reward-seeds", default="",
                        help="comma-separated training seeds of the two reward protocols")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ppo_traj_sweep: no CUDA device", file=sys.stderr)
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
    for lib in ("im_policy", "nv_policy"):
        _build.library(lib)
    for so, out in logs.items():
        if "libim_policy-" in so or "libnv_policy-" in so:
            print(f"ptxas ({pathlib.Path(so).name}): {chip_smoke.ptxas_entries(out)}", flush=True)
    libs, vlogs = build_all()
    for name, log in vlogs.items():
        print(f"ptxas ({name}): {chip_smoke.ptxas_entries(log)}", flush=True)
    result = {"card": smi, "ms": {}}

    def clock(fn, *args):
        return cuda_time(fn, *args, warmup=1, iters=5)["best_ms"]

    k10_cases(libs, clock, smi, result["ms"], dev)
    k18_cases(libs, clock, smi, result["ms"], dev)
    if args.reward_seeds:
        reward_seeds([int(x) for x in args.reward_seeds.split(",")], smi, result, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
