"""Time K27 and K28 (the PyTorch port's off-policy trajectory kernels) on
one CUDA card: the first design (csrc/wide_mlp.cuh, a block per 32 lanes,
the actor streamed from L2) beside the thread-block cluster
(csrc/cluster_mlp.cuh), split into the actor and the env, at several tiles
and both products.

K27 (``im_rollout_traj_cluster`` in or_gym_inventory_torch/csrc/im_offpolicy.cu)
and K28 (``nv_rollout_traj_cluster`` in csrc/nv_policy.cu) run a cluster of
C CTAs over a tile of N lanes. This script builds, into the ignored
``build/wide_cluster_sweep/`` directory, copies of the two sources with one
change each, all at once:

- ``wide8``, ``wide16``: the first design at 8 and 16 lanes a block
  (``kWideLanes``; the package's is 32), the simple alternative;
- ``threads256``: the cluster kernel with 256 threads a CTA (8 warps, two
  warp items each in turn at the defaults; the package's 512 take one
  each), what the warps in flight save of a period's chain;
- ``actor_alone``: the cluster kernel with the lane threads' head, step and
  stores taken out (the obs stay the reset's): the actor alone;
- ``local_stores``: every layer output and obs written into the CTA's own
  shared memory only, not the peers' (wrong results: timing only), what
  the distributed shared memory writes cost;
- ``no_cluster_barrier``: the barriers between the layers and after the
  obs taken down to __syncthreads (wrong results: timing only), what the
  cluster barriers cost;
- ``fp32_4x4``: the hidden layers' FP32 products with a thread 4 rows x 4
  lanes (``FP32_4X4_LAYER``; the package's holds 4 x 2), half the shared
  memory loads per FMA;
- ``tf32``: the hidden layers' products in 3xTF32 on mma.sync
  (``TF32_LAYER``, a warp one M-tile x 16 lanes, the A fragments read from
  the same weight slices) in place of the FP32 cores'.

At the learners' shape (1,024 lanes x the horizon: 30 for InvManagement
backlog, 50 for Newsvendor's ENV_CONFIG_EVAL) and at 65,536, det head,
chip_smoke.py's seeded (256, 256) relu actor, it times each launch alone
(CUDA events around the C call, the plan and the packed actor made
before): the first design and the cluster in turns (first, cluster,
cluster, first); the first design at 8 and 16 lanes a block; the cluster at
each (C, N) of (4, 64), (8, 96), (8, 64), (4, 32) and (8, 32) (the entry
points take the first of ``_CLUSTER_TILES`` that fits; (8, 128) and
(4, 128) do not fit a CTA, and the script prints their bytes) in FP32 and
in 3xTF32; its env alone (the entry
kernel with the "uniform" head on the actor's tile: the draws, the steps,
no obs and no actor), its actor alone, and the two timing-only variants.
Then each entry point as a whole, host work inside the events: the cluster
(the entry points' route) and the first design (the wrapper's wide route).
Last, the rounds: a cluster holds one tile at a time, so its time should be
the rounds a cluster walks (tiles over clusters, rounded up) times one
tile's chain. At B = 64 x clusters x w lanes (w = 1, 2, 4: one, two and
four tiles a cluster) and at 65,536 it times the kept tile, the
``threads256`` variant and the first design in turns.

Every FP32 cluster run equals the entry point's streams bit for bit (a
lane's sums do not depend on the tile); the first design at 8 and 16 lanes
equals its run at 32 bit for bit; the 3xTF32 form is held by the share of
lanes whose a_norm is within 1e-4 of the entry point's. It prints each
time with the card's name and power limit, ptxas's registers and stack per
kernel, and a JSON line of the times.

    python3 tools/wide_cluster_sweep.py

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
SHAPES = (1_024, 65_536)
TILES = ((4, 64), (8, 96), (8, 64), (4, 32), (8, 32))
NO_FIT = ((8, 128), (4, 128))
SOURCES = ("im_offpolicy", "nv_policy")

# The 3xTF32 form of a hidden layer (csrc/mma_tf32.cuh's split and
# mma.sync m16n8k8), inserted into the ``tf32`` variant's copy of
# cluster_mlp.cuh in place of the FP32 products.
TF32_LAYER = r"""// Hidden layer l on the tensor cores in 3xTF32: a warp item is one M-tile
// (16 rows) x 16 lanes (two n-tiles), the A fragments read from the W
// slice ([k][R + 8]: rows tig and tig + 4, columns gid and gid + 8 fall on
// 32 banks), the B fragments from the [row][N + 8] activations.
template <bool RELU>
__device__ __forceinline__ void cluster_layer_tf32(cg::cluster_group& cl, const ClusterMlp& m,
                                                   int l, const float* W, const float* bias,
                                                   const float* in, float* out, int rank,
                                                   bool last) {
  const int R = m.rows[l], RS = m.ws[l], K = m.kin[l], S = m.stride;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int blocks = m.lanes >> 4, items = (R >> 4) * blocks;
  for (int wi = threadIdx.x >> 5; wi < items; wi += kClusterWarps) {
    const int m0 = (wi / blocks) * 16, c0 = (wi % blocks) * 16;
    float acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const float* a_lo = W + tig * RS + m0 + gid;
    const float* b_lo = in + tig * S + c0 + gid;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float* ap = a_lo + k0 * RS;
      const float fa[4] = {ap[0], ap[8], ap[4 * RS], ap[4 * RS + 8]};
      unsigned ab[4], as[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(fa[r], ab[r], as[r]);
      const float* bp = b_lo + k0 * S;
      unsigned bb[2][2], bs[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        split_tf32(bp[8 * nt], bb[nt][0], bs[nt][0]);
        split_tf32(bp[4 * S + 8 * nt], bb[nt][1], bs[nt][1]);
      }
      // the two n-tiles' chains interleaved; each sums as mma_kstep does
      mma_tf32(acc[0], as, bb[0]);
      mma_tf32(acc[1], as, bb[1]);
      mma_tf32(acc[0], ab, bs[0]);
      mma_tf32(acc[1], ab, bs[1]);
      mma_tf32(acc[0], ab, bb[0]);
      mma_tf32(acc[1], ab, bb[1]);
    }
    const float b0 = bias[m0 + gid], b1 = bias[m0 + gid + 8];
    const int row = rank * R + m0 + gid;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c = c0 + 8 * nt + 2 * tig;
      cluster_store(cl, m, out, row, c, hidden_act<RELU>(acc[nt][0] + b0),
                    hidden_act<RELU>(acc[nt][1] + b0), last);
      cluster_store(cl, m, out, row + 8, c, hidden_act<RELU>(acc[nt][2] + b1),
                    hidden_act<RELU>(acc[nt][3] + b1), last);
    }
  }
}

"""
OUTPUT_LAYER = "// The output layer for the CTA's lanes_cta lanes"
FP32_LAYER = "// Hidden layer l on the FP32 cores"
# An FP32 form of a hidden layer with 4 rows x 4 lanes a thread (half the
# shared-memory loads per FMA of the package's 4 x 2), put in the
# ``fp32_4x4`` variant's copy in place of the package's.
FP32_4X4_LAYER = r"""// Hidden layer l on the FP32 cores, a thread 4 rows x 4 lanes: per k one float4 of weights (a
// broadcast across its row group's threads) and one float4 of activations
// for 16 FMAs. A warp item spans 64 lanes x 8 rows where N is a multiple of
// 64 (16 lane groups; 8 items, every warp busy, at the defaults' R = 64
// rows over N = 64 lanes), else 32 lanes x 16 rows. A sum runs over k in
// order, so it does not depend on the tile.
template <bool RELU>
__device__ __forceinline__ void cluster_layer_fp32(cg::cluster_group& cl, const ClusterMlp& m,
                                                   int l, const float* W, const float* bias,
                                                   const float* in, float* out, int rank,
                                                   bool last) {
  const int R = m.rows[l], RS = m.ws[l], K = m.kin[l], S = m.stride;
  const int LG = m.lanes % 64 ? 8 : 16, RG = 32 / LG;  // lane and row groups a warp
  const int t = threadIdx.x & 31, blocks = m.lanes / (4 * LG);
  const int items = R / (4 * RG) * blocks;
  for (int wi = threadIdx.x >> 5; wi < items; wi += kClusterWarps) {
    const int r0 = (wi / blocks) * 4 * RG + (t / LG) * 4;
    const int c = (wi % blocks) * 4 * LG + (t % LG) * 4;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const float* wp = W + r0;
    const float* xp = in + c;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 wv = *reinterpret_cast<const float4*>(wp + k * RS);
      const float4 xv = *reinterpret_cast<const float4*>(xp + k * S);
      const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
      const float xx[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(ww[j], xx[i], acc[j][i]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bj = bias[r0 + j];
      cluster_store(cl, m, out, rank * R + r0 + j, c, hidden_act<RELU>(acc[j][0] + bj),
                    hidden_act<RELU>(acc[j][1] + bj), last);
      cluster_store(cl, m, out, rank * R + r0 + j, c + 2, hidden_act<RELU>(acc[j][2] + bj),
                    hidden_act<RELU>(acc[j][3] + bj), last);
    }
  }
}

"""

ROUNDS = (1, 2, 4)   # tiles a cluster of the rounds' batches

# each variant: its (file, old, new) text changes of the sources
VARIANTS = {
    "wide8": (("wide_mlp.cuh", "constexpr int kWideLanes = 32;",
               "constexpr int kWideLanes = 8;"),),
    "wide16": (("wide_mlp.cuh", "constexpr int kWideLanes = 32;",
                "constexpr int kWideLanes = 16;"),),
    "threads256": (("cluster_mlp.cuh", "constexpr int kClusterThreads = 512;",
                    "constexpr int kClusterThreads = 256;"),),
    "actor_alone": (
        ("im_offpolicy.cu", "      if (lane) {\n        if (live)\n          for (int i = 0; i < m1;",
         "      if (false) {\n        if (live)\n          for (int i = 0; i < m1;"),
        ("nv_policy.cu", "      if (lane) {\n        float st, qty;\n        const float a = "
         "cluster_head", "      if (false) {\n        float st, qty;\n        const float a = "
         "cluster_head")),
    "local_stores": (
        ("cluster_mlp.cuh", "    const int q = c / m.lanes_cta;\n    float* dst = "
         "cl.map_shared_rank(out, q);",
         "    const int q = c / m.lanes_cta;\n    float* dst = out;"),
        ("cluster_mlp.cuh", "  for (int q = 0; q < m.cluster; ++q) {\n    float* dst = "
         "cl.map_shared_rank(out, q);", "  for (int q = 0; q < 1; ++q) {\n    float* dst = out;"),
        ("cluster_mlp.cuh", "  for (int q = 0; q < m.cluster; ++q) cl.map_shared_rank(local, q)"
         "[off] = v;", "  local[off] = v;")),
    "tf32": (
        ("cluster_mlp.cuh", '#include "launch.cuh"\n',
         '#include "launch.cuh"\n#include "mma_tf32.cuh"\n'),
        ("cluster_mlp.cuh", OUTPUT_LAYER, TF32_LAYER + OUTPUT_LAYER),
        ("cluster_mlp.cuh", "    cluster_layer_fp32<RELU>(cl, m, l,",
         "    cluster_layer_tf32<RELU>(cl, m, l,")),
    "fp32_4x4": (("cluster_mlp.cuh", (FP32_LAYER, OUTPUT_LAYER), FP32_4X4_LAYER),),
    "no_cluster_barrier": (
        ("cluster_mlp.cuh", "  cl.sync();  // the obs are in", "  __syncthreads();"),
        ("cluster_mlp.cuh", "    cl.sync();\n    in = out;",
         "    __syncthreads();\n    in = out;")),
}
STREAMS = {"im": ("inv", "actions", "raw", "reward", "demand"),
           "nv": ("econ", "orders", "raw", "reward", "demand")}


def build_variants():
    """Copy csrc/ per variant, change it, compile both sources of every
    variant at once; returns ({variant: {source: library}}, {variant:
    {source: ptxas's report}})."""
    from or_gym_inventory_torch.ops import _build
    root = _build.BUILD_DIR / "wide_cluster_sweep"
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for name, changes in VARIANTS.items():
        d = root / name
        shutil.copytree(_build.CSRC, d)
        for fname, old, new in changes:   # old: a text, or the (start, end) of a span
            text = (d / fname).read_text()
            if isinstance(old, tuple) and old[0] in text and old[1] in text:
                a, b = text.index(old[0]), text.index(old[1])
                text = text[:a] + new + text[b:]
            elif isinstance(old, str) and old in text:
                text = text.replace(old, new)
            else:
                raise RuntimeError(f"{name}: {fname} no longer holds {old!r}")
            (d / fname).write_text(text)
        for src in SOURCES:
            so = d / f"lib{src}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / f"{src}.cu")]
            jobs[(name, src)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for (name, src), (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{src}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in {**_build.SIGNATURES[src], **_build._SHARED}.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = list(argtypes), restype
        libs.setdefault(name, {})[src] = lib
        logs.setdefault(name, {})[src] = out
    return libs, logs


def family(fam, dev):
    """The family's params, seeded actor and log_std, horizon, obs_dim,
    act_dim, state words, anchors and entry point."""
    import chip_smoke
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek
    if fam == "im":
        params = im.default_params(backlog=True)
        obs_dim, act, T = params.pipeline_length, params.m1, params.periods
        words, anchors, entry = obs_dim, False, ek.rollout_traj_im_offpolicy
    else:
        params = chip_smoke.nv_params()
        obs_dim, act, T = params.obs_dim, 1, params.step_limit
        words, anchors, entry = obs_dim + 1, True, ek.rollout_traj_nv_offpolicy
    actor, log_std = chip_smoke.seeded_offpolicy_actor(obs_dim, act, False, dev)
    half_hi = ek._half_c(params) if fam == "im" else ek._nv_half_hi(params)
    return dict(params=params, actor=actor, log_std=log_std, std=ek.clipped_std(log_std), T=T,
                obs_dim=obs_dim, act=act, words=words, anchors=anchors, entry=entry,
                half_hi=[float(h) for h in half_hi[:act]], dims=(obs_dim, 256, 256, act))


def pack_at(f, tile, dev):
    """The det head's ClusterMlp struct and packed actor at ``tile`` (C, N),
    through the package's plan, struct and gather (the entry points take
    ``_cluster_choice``'s tile)."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    dims, act = f["dims"], f["act"]
    plan = ek._cluster_plan(dims, act, True, f["T"], f["words"], f["anchors"], *tile)
    if plan.floats * 4 > ek.SMEM_OPTIN_BYTES:
        raise ValueError(f"C={tile[0]} N={tile[1]} needs {plan.floats * 4} B a CTA")
    st = ek._cluster_struct(dims, act, "det", f["half_hi"], plan)
    index = torch.from_numpy(ek._cluster_index(dims, act, True, plan)).to(dev)
    return st, ek._gather(f["actor"], f["std"], index, torch.zeros(1, device=dev), dev)


def set_grid(lib, fam, st, B, flags):
    """The persistent grid for ``B`` lanes from ``lib``'s own occupancy
    query (a variant's instance may hold fewer clusters than the package's)."""
    from or_gym_inventory_torch.ops import episode_kernels as ek
    out = ctypes.c_int(0)
    rc = getattr(lib, f"{fam}_rollout_traj_cluster_occupancy")(ctypes.addressof(st), *flags,
                                                                ctypes.byref(out))
    if rc:
        raise RuntimeError(f"{fam} occupancy: {lib.cuda_error_message(rc).decode()}")
    st.clusters = ek._cluster_grid(-(-B // st.lanes), out.value)
    return out.value


def launcher(fam, f, B, dev):
    """(a function that launches a library's wide or cluster kernel with a
    given struct and buffer into fresh outputs, the outputs)."""
    import torch

    from or_gym_inventory_torch.ops import episode_kernels as ek
    T, act, key, params = f["T"], f["act"], ek._plan_key(dev), f["params"]
    i32, f32 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.float32, device=dev)
    if fam == "im":
        plan = ek._im_plan(params, key)
        out = dict(inv=torch.empty((T + 1, act, B), **i32), actions=torch.empty((T, act, B), **i32),
                   raw=torch.empty((T, act, B), **f32), reward=torch.empty((T, B), **f32),
                   demand=torch.empty((T, B), **i32))
        head = (ctypes.addressof(plan["struct"]),)
        tail = (plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr())
        flags = (1, int(params.backlog))
    else:
        plan = ek._nv_plan(params, key)
        out = dict(econ=torch.empty((5, B), **f32), orders=torch.empty((T, B), **f32),
                   raw=torch.empty((T, 1, B), **f32), reward=torch.empty((T, B), **f32),
                   demand=torch.empty((T, B), **f32))
        head = (ctypes.addressof(plan["struct"]),)
        tail = (plan["lgam"].data_ptr(),)
        flags = (1,)
    src = "im_offpolicy" if fam == "im" else "nv_policy"

    def go(lib, fn, st, flat):
        rc = getattr(lib, f"{fam}_rollout_traj_{fn}")(
            *head, ctypes.addressof(st), flat.data_ptr(), *tail,
            *(out[k].data_ptr() for k in STREAMS[fam]), SEED, *flags, B, T, ek._stream(dev))
        if rc:
            raise RuntimeError(f"{fam} {fn}: {lib.cuda_error_message(rc).decode()}")
    return go, out, src, flags


def rounds(fam, f, libs, result, smi, clock, dev):
    """The rounds a cluster walks against the time: at B = 64 x clusters x w
    lanes (one, two and four tiles a cluster) and at 65,536, the kept tile,
    ``threads256`` and the first design in turns (kept, first, 256, 256,
    first, kept); each kept run equal to the entry point's streams."""
    import torch

    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    dims, src = f["dims"], "im_offpolicy" if fam == "im" else "nv_policy"
    package, lib256 = _build.library(src), libs["threads256"][src]
    tile = ek._cluster_choice(dims, f["act"], True, f["T"], f["words"], f["anchors"])
    tile = (tile.cluster, tile.lanes)
    st, flat = pack_at(f, tile, dev)
    wst, wflat = ek._pack_wide_actor(f["actor"], f["std"], f["obs_dim"], f["act"], "det",
                                     f["half_hi"], dev)
    flags = (1, int(f["params"].backlog)) if fam == "im" else (1,)
    held = set_grid(package, fam, st, tile[1], flags)
    for B in [tile[1] * held * w for w in ROUNDS] + [65_536]:
        go, out, _, _ = launcher(fam, f, B, dev)
        set_grid(package, fam, st, B, flags)
        tst = ek._ClusterMlp.from_buffer_copy(st)
        set_grid(lib256, fam, tst, B, flags)
        turns = [clock(go, package, "cluster", st, flat), clock(go, package, "wide", wst, wflat),
                 clock(go, lib256, "cluster", tst, flat), clock(go, lib256, "cluster", tst, flat),
                 clock(go, package, "wide", wst, wflat), clock(go, package, "cluster", st, flat)]
        go(package, "cluster", st, flat)
        entry = f["entry"](f["params"], f["actor"], f["log_std"], SEED, B, "det", "relu", dev)
        for k in STREAMS[fam]:
            if not torch.equal(out[k], entry[k]):
                raise AssertionError(f"{fam} rounds at {B}: {k} is not the entry point's")
        tiles = -(-B // tile[1])
        row = {"clusters": st.clusters, "clusters_threads256": tst.clusters,
               "rounds": -(-tiles // st.clusters),
               "rounds_threads256": -(-tiles // tst.clusters),
               "turns_kept_wide_256_256_wide_kept": turns}
        result["ms"][f"{fam}_rounds_{B}x{f['T']}"] = row
        print(f"{fam} rounds, {B} lanes x {f['T']} on {smi}: "
              + ", ".join(f"{k} {v}" for k, v in row.items()), flush=True)
        del out, entry


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wide_cluster_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.utils.profiling import cuda_time

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    logs = _build.build()
    for src in SOURCES:
        _build.library(src)
    for so, out in logs.items():
        if any(f"lib{src}-" in so for src in SOURCES):
            print(f"ptxas ({pathlib.Path(so).name}): " + "; ".join(
                e for e in chip_smoke.ptxas_entries(out).split("; ")
                if "_wide" in e or "_cluster" in e), flush=True)
    libs, vlogs = build_variants()
    for name in ("wide16", "actor_alone", "threads256"):
        for src, log in vlogs[name].items():
            print(f"ptxas ({name} {src}): " + "; ".join(
                e for e in chip_smoke.ptxas_entries(log).split("; ")
                if "_wide" in e or "_cluster" in e), flush=True)
    result = {"card": smi, "ms": {}}

    def clock(go, *args, iters=5):
        return cuda_time(go, *args, warmup=1, iters=iters)["best_ms"]

    for fam in ("im", "nv"):
        f = family(fam, dev)
        dims = f["dims"]
        for C, N in NO_FIT:
            plan = ek._cluster_plan(dims, f["act"], True, f["T"], f["words"], f["anchors"], C, N)
            print(f"{fam}: C={C} N={N} needs {plan.floats * 4} B a CTA; a block holds "
                  f"{ek.SMEM_OPTIN_BYTES}: not run", flush=True)
        for B in SHAPES:
            key = f"{fam}_{B}x{f['T']}"
            times = result["ms"].setdefault(key, {})
            go, out, src, flags = launcher(fam, f, B, dev)
            entry = f["entry"](f["params"], f["actor"], f["log_std"], SEED, B, "det", "relu", dev)
            package = _build.library(src)

            def cluster(tile):
                st, flat = pack_at(f, tile, dev)
                times[f"clusters_c{tile[0]}_n{tile[1]}"] = set_grid(package, fam, st, B, flags)
                return st, flat
            wst, wflat = ek._pack_wide_actor(
                f["actor"], f["std"], f["obs_dim"], f["act"], "det",
                ek._half_c(f["params"]) if fam == "im" else ek._nv_half_hi(f["params"]), dev)
            main_tile = ek._cluster_choice(dims, f["act"], True, f["T"], f["words"],
                                           f["anchors"])
            cst, cflat = cluster((main_tile.cluster, main_tile.lanes))

            # the first design and the cluster in turns, in one call
            turns = [clock(go, package, "wide", wst, wflat),
                     clock(go, package, "cluster", cst, cflat),
                     clock(go, package, "cluster", cst, cflat),
                     clock(go, package, "wide", wst, wflat)]
            times["turns_wide_cluster_cluster_wide"] = turns
            go(package, "cluster", cst, cflat)
            for k in STREAMS[fam]:
                if not torch.equal(out[k], entry[k]):
                    raise AssertionError(f"{key}: the cluster kernel's {k} is not the entry "
                                         f"point's")
            ref = {k: v.clone() for k, v in out.items()}
            go(package, "wide", wst, wflat)
            wide_ref = {k: v.clone() for k, v in out.items()}
            for name in ("wide8", "wide16"):
                times[name] = clock(go, libs[name][src], "wide", wst, wflat)
                for k in STREAMS[fam]:
                    if not torch.equal(out[k], wide_ref[k]):
                        raise AssertionError(f"{key} {name}: {k} differs from the first design's")
            for tile in TILES:
                st, flat = cluster(tile)
                name = f"cluster_c{tile[0]}_n{tile[1]}"
                times[f"{name}_fp32"] = clock(go, package, "cluster", st, flat)
                for k in STREAMS[fam]:
                    if not torch.equal(out[k], ref[k]):
                        raise AssertionError(f"{key} {name}: {k} is not the entry point's")
                times[f"{name}_tf32"] = clock(go, libs["tf32"][src], "cluster", st, flat)
                share, worst = chip_smoke.lane_share(f"{key} {name} tf32 a_norm", out["raw"],
                                                     ref["raw"], 1e-4, 1e-4, 0.0)
                times[f"{name}_tf32_share"] = share
                times[f"{name}_tf32_max_diff"] = worst
            env = ek._ClusterMlp.from_buffer_copy(cst)
            env.head = ek.HEADS["uniform"]
            times["env_alone"] = clock(go, package, "cluster", env, cflat)
            times["fp32_4x4"] = clock(go, libs["fp32_4x4"][src], "cluster", cst, cflat)
            for k in STREAMS[fam]:
                if not torch.equal(out[k], ref[k]):
                    raise AssertionError(f"{key} fp32_4x4: {k} is not the entry point's")
            for name in ("actor_alone", "local_stores", "no_cluster_barrier"):
                times[name] = clock(go, libs[name][src], "cluster", cst, cflat)
            tst = ek._ClusterMlp.from_buffer_copy(cst)
            times["clusters_threads256"] = set_grid(libs["threads256"][src], fam, tst, B, flags)
            times["threads256"] = clock(go, libs["threads256"][src], "cluster", tst, cflat)
            for k in STREAMS[fam]:
                if not torch.equal(out[k], ref[k]):
                    raise AssertionError(f"{key} threads256: {k} is not the entry point's")
            # the entry points, host work inside the events
            times["entry_cluster"] = cuda_time(f["entry"], f["params"], f["actor"], f["log_std"],
                                               SEED, B, "det", "relu", dev, warmup=1,
                                               iters=5)["best_ms"]
            saved = ek._pack_cluster_actor
            ek._pack_cluster_actor = lambda *a, **k: None   # the wrapper's wide route
            try:
                times["entry_wide"] = cuda_time(f["entry"], f["params"], f["actor"],
                                                f["log_std"], SEED, B, "det", "relu", dev,
                                                warmup=1, iters=3)["best_ms"]
            finally:
                ek._pack_cluster_actor = saved
            times["clusters"] = cst.clusters
            print(f"{key} on {smi}: " + ", ".join(f"{k} {v}" for k, v in times.items()),
                  flush=True)
            del out, ref, wide_ref, entry
        rounds(fam, f, libs, result, smi, clock, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
