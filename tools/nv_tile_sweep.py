"""Time K19 (the PyTorch port's Newsvendor learned-policy returns kernel) on
one CUDA card: its first design beside the tensor-core tile, split into the
actor and the env, with each demand layout and at several tiles.

K19 (``k_nv_policy_returns`` in or_gym_inventory_torch/csrc/nv_policy.cu)
runs a block per tile of (lane, episode) pairs, the actor on the tensor
cores (csrc/mlp_tile.cuh), and takes each period's Poisson demand from the
whole episode's demand searched up front in the episode's table of suffix
sums, the table on the rows the activations take after it, or, where no
table fits a block, from the linear count per chunk of 16 periods
(``NvTile.layout``). This script builds, into the ignored ``build/``
directory, one extra library that includes nv_policy.cu and adds:

- ``first``: the first design (the parent's K19), one thread per pair with
  the actor of csrc/mlp.cuh on the FP32 cores, the pipeline in a local
  NvEpisode and each chunk's demand by the linear count; ``first_actor``
  its actor alone (no draws, no step), ``first_env`` its env alone (the
  reset, the demand, the observation and the step, on a fixed order);
- ``tile_upfront`` and ``tile_linear``: the entry points' kernel with each
  of its layouts (at the defaults they take ``upfront``);
- ``tile_table`` and ``tile_turns``: the tile with two layouts of the
  sweep's own, a search of the table in rows of its own per chunk, and the
  up-front demand with the warps of a block taking turns at one warp's
  table;
- ``tile_actor`` and ``tile_env``: the tile's actor alone and its env alone
  (with the up-front layout);
- ``tile_occ_less``: the entry points' kernel with its shared memory padded
  so that an SM holds one block less.

The tile with the entry points' layout is also timed through their C
function at 32, 64 and 128 lanes. It runs at the learned-policy
evaluation's shape (benchmarks/benchmark_newsvendor.py's ENV_CONFIG_EVAL:
lead time 5, 50 periods, mu_max 200; 65,536 lanes x 16 episodes,
deterministic, chip_smoke.py's seeded 10-64-64-1 actor), in turns: the
first design and the tile, then the tile and the first design (the
parent's kernel and this one, in one call), the tiles forward, reversed and
forward, then each variant three times. Every tile run must equal the entry
point's returns bit for bit (the layouts invert the same demand, and a
lane's sums do not depend on the tile); the first design must agree with it
on >= 99% of lanes; the actor-alone and env-alone outputs are not results.
It prints each time with the card's name and power limit, ptxas's
registers and stack per kernel, and a JSON line of the best times.

Last, the drift of the sums: on a ragged 1,000 x 3 batch at mu_max 200 and
30,000, deterministic and stochastic, the share of lanes whose orders and
returns agree (rtol 1e-4, atol 1e-2, every period) between K20 and the
plain version on the card, and between the plain version on the CPU and on
the card (two FP32 summation orders), for chip_smoke.py's seeded actor
(obs statistics folded into layer 1) and for an unnormalised random one,
whose orders feed back through raw observations in the thousands.

    python3 tools/nv_tile_sweep.py

Without a CUDA card it exits 1.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LANES, EPISODES, SEED = 65_536, 16, 2024
TILES = (64, 32, 128)
LAYOUTS = ("linear", "table", "upfront", "turns")
ENTRY_LAYOUT = "upfront"   # the entry points' layout at the defaults (_nv_tile_choice)
VARIANTS = ("first", "first_actor", "first_env", "tile_linear", "tile_table", "tile_upfront",
            "tile_turns", "tile_actor", "tile_env", "tile_occ_less")

LAUNCHER = r"""
#include "nv_policy.cu"

namespace {

// The first design of K19, deterministic: PART 0 whole, 1 the actor alone,
// 2 the env alone on the order half_hi.
template <int PART>
__global__ void k_first(const __grid_constant__ NvParams p, const __grid_constant__ Mlp m,
                        const float* __restrict__ params, int n_params,
                        const float* __restrict__ lgam, const float* __restrict__ disc,
                        float* __restrict__ out, unsigned seed, long long B, int E, int T) {
  float *h0, *h1;
  const float* sw = load_params(m, params, n_params, h0, h1);
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  for (int k = 0; k < m.act_rows; ++k) col(h0, k) = 0.f;
  NvEpisode s;
  NvPoisson q;
  if (PART != 1) {
    policy_reset(p, seed, lane, e, s);
    q = nv_poisson_setup(p, lgam, s.mu);
  }
  float total = 0.f;
  for (int t0 = 0; t0 < T; t0 += NV_CHUNK) {
    float d[NV_CHUNK];
    if (PART != 1) chunk_demand(p, q, seed, lane, e, t0, T, d);
    const int n = min(NV_CHUNK, T - t0);
    for (int i = 0; i < n; ++i) {
      const int t = t0 + i;
      if (PART == 1) {
        total += col(mlp_forward(m, sw, h0, h1), 0);
        continue;
      }
      float order, raw;
      if (PART == 0) {
        order = policy_period<false>(p, m, sw, 0.f, seed, lane, e, t, s, h0, h1, raw);
      } else {
        col(h0, 0) = s.price;
        col(h0, 1) = s.cost;
        col(h0, 2) = s.h;
        col(h0, 3) = s.k;
        col(h0, 4) = s.mu;
        for (int j = 0; j < p.L; ++j) {
          int k = s.head + j;
          if (k >= p.L) k -= p.L;
          col(h0, 5 + j) = s.ring[k];
        }
        order = m.half_hi[0];
      }
      total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), nv_step(p, s, order, d[i])));
    }
  }
  out[idx] = total;
}

// The sweep's own demand layouts, beside the entry points' NV_DEM_LINEAR
// and NV_DEM_UPFRONT:
#define SWEEP_TABLE 20  // per chunk, a search of the episode's table in K
                        // rows of its own (nt.s_table, at a stride of N)
#define SWEEP_TURNS 21  // NV_DEM_UPFRONT with one warp's table at a time:
                        // the warps of a block take turns at the reset, so
                        // the table needs K rows of 32 lanes

// The tile, deterministic: PART 0 whole, with LAYOUT's demand; 1 the actor
// alone, 2 the env alone on the order half_hi (both with NV_DEM_UPFRONT).
template <int PART, int LAYOUT>
__global__ void k_sweep_tile(const __grid_constant__ NvParams p,
                             const __grid_constant__ MlpTile m, const __grid_constant__ NvTile nt,
                             const float* __restrict__ w, const float* __restrict__ lgam,
                             const float* __restrict__ disc, float* __restrict__ out,
                             unsigned seed, long long B, int E, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = threadIdx.x, S = m.stride, N = m.lanes;
  const long long pair0 = (long long)blockIdx.x * N, idx = pair0 + n;
  const bool past = pair0 + (n & ~31) >= B * E;
  constexpr bool chunked = LAYOUT == SWEEP_TABLE;
  if (chunked && past) return;
  const bool live = idx < B * E;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  TileDemand dem{p, nt, {}, {}, smem + nt.s_dem + n, N};
  NvEcon c{};
  if (PART != 1) {
    c = tile_reset<false>(p, lgam, seed, lane, e, live, nullptr, B, dem.q);
    if (chunked) dem.setup<NV_DEM_UPFRONT>(smem, n);  // the table in rows of its own
  }
  if (!chunked) {
    const int turns = LAYOUT == SWEEP_TURNS ? N >> 5 : 1;
    for (int k = 0; k < turns; ++k) {
      if (PART != 1 && (turns == 1 || (n >> 5) == k)) {
        if (LAYOUT == SWEEP_TURNS)
          dem.tb = nv_table_setup(p, dem.q, smem + nt.s_table + (n & 31), 32);
        else
          dem.setup<NV_DEM_UPFRONT>(smem, n);
        dem.upfront(seed, lane, e, T);
      }
      __syncthreads();
    }
    if (past) return;
  }
  const NvSharedRing ring{smem + nt.s_ring + n, N};
  for (int j = 0; j < p.L; ++j) ring(j) = 0.f;
  int head = 0;
  const int obs_pad = (m.dims[0] + 7) & ~7;
  float* x = smem + m.s_x0 + n;
  for (int k = 0; k < obs_pad; ++k) x[k * S] = 0.f;
  float total = 0.f;
  for (int t0 = 0; t0 < T; t0 += NV_CHUNK) {
    if (PART != 1 && chunked) {
      float v[NV_CHUNK], d[NV_CHUNK];
      chunk_thresholds(dem.q, seed, lane, e, t0, T, v);
      nv_table_invert(p, dem.q, dem.tb, v, d);
#pragma unroll
      for (int i = 0; i < NV_CHUNK; ++i) dem.rows[i * N] = d[i];
    }
    const int cn = min(NV_CHUNK, T - t0);
    for (int i = 0; i < cn; ++i) {
      const int t = t0 + i;
      if (PART == 1) {
        __syncwarp();
        total += mlp_tile_forward(m, w, smem)[n];
        continue;
      }
      tile_obs(p, c, ring, head, obs_pad, x, S);
      float order = m.half_hi[0];
      if (PART == 0) {
        __syncwarp();
        const float v = mlp_tile_forward(m, w, smem)[n];
        order = __fmul_rn(__fadd_rn(tanhf(v), 1.f), m.half_hi[0]);
      }
      const float d = chunked ? dem.at<NV_DEM_LINEAR>(t, i) : dem.at<NV_DEM_UPFRONT>(t, i);
      float qty;
      const float reward = nv_step_ring(p, ring, head, c, order, d, qty);
      total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), reward));
    }
  }
  if (live) out[idx] = total;
}

}  // namespace

extern "C" {

int sweep_first(int part, const NvParams* p, const Mlp* m, const float* params, int n_params,
                const float* lgam, const float* disc, float* out, unsigned seed, long long B,
                int E, int T, cudaStream_t stream) {
  auto kernel = part == 0 ? k_first<0> : part == 1 ? k_first<1> : k_first<2>;
  const size_t smem = smem_bytes(*m, n_params);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks_for(B * E), kThreads, smem, stream>>>(*p, *m, params, n_params, lgam, disc,
                                                         out, seed, B, E, T);
  return (int)cudaGetLastError();
}

// part 1 / 2: the actor / the env alone; 10 + NV_DEM_*: the entry points'
// kernel with that layout; SWEEP_TABLE, SWEEP_TURNS: the sweep's layouts.
int sweep_tile(int part, const NvParams* p, const MlpTile* m, const NvTile* nt, const float* w,
               const float* lgam, const float* disc, float* out, unsigned seed, long long B,
               int E, int T, cudaStream_t stream) {
#define SWEEP_LAUNCH(PART, LAYOUT)                                                           \
  launch_mlp_tile(k_sweep_tile<PART, LAYOUT>, *m, B * E, stream, *p, *m, *nt, w, lgam, disc, \
                  out, seed, B, E, T)
  if (part == 1) return SWEEP_LAUNCH(1, NV_DEM_UPFRONT);
  if (part == 2) return SWEEP_LAUNCH(2, NV_DEM_UPFRONT);
  if (part == SWEEP_TABLE) return SWEEP_LAUNCH(0, SWEEP_TABLE);
  if (part == SWEEP_TURNS) return SWEEP_LAUNCH(0, SWEEP_TURNS);
#undef SWEEP_LAUNCH
  if (part == 10 + NV_DEM_LINEAR)
    return launch_layout<false, false, NV_DEM_LINEAR>(*p, *m, *nt, w, lgam, disc, out, nullptr,
                                                      nullptr, nullptr, seed, B, E, T, stream);
  if (part == 10 + NV_DEM_UPFRONT)
    return launch_layout<false, false, NV_DEM_UPFRONT>(*p, *m, *nt, w, lgam, disc, out, nullptr,
                                                       nullptr, nullptr, seed, B, E, T, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
"""

# sweep_first's and sweep_tile's part of each variant; the tile with an
# entry point layout is part 10 + its NV_DEM_* number
PARTS = {"first": 0, "first_actor": 1, "first_env": 2, "tile_actor": 1, "tile_env": 2,
         "tile_table": 20, "tile_turns": 21}
# the entry points' layout whose regions each of the sweep's layouts extends
BASE_LAYOUT = {"linear": "linear", "upfront": "upfront", "table": "linear", "turns": "upfront"}


def build_launcher():
    """Compile the launcher next to the port's libraries; returns (the
    library bound, ptxas's report)."""
    from or_gym_inventory_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "nv_tile_sweep.cu"
    src.write_text(LAUNCHER)
    so = _build.BUILD_DIR / "libnv_tile_sweep.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the launcher:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.sweep_first.argtypes = [I, P, P, P, I, P, P, P, U, LL, I, I, P]
    lib.sweep_tile.argtypes = [I, P, P, P, P, P, P, P, U, LL, I, I, P]
    lib.sweep_first.restype = lib.sweep_tile.restype = I
    lib.cuda_error_message.argtypes, lib.cuda_error_message.restype = [I], ctypes.c_char_p
    return lib, proc.stdout + proc.stderr


def sweep_plan(dims, L, K, T, lanes, layout):
    """The entry points' plan (``_nv_tile_plan``) for "linear" and
    "upfront"; for the sweep's own layouts, the one derived from it:
    "table" is the linear count's regions with the table's K rows after
    them, "turns" the up-front ones with one warp's table (K rows of 32
    lanes)."""
    from or_gym_inventory_torch.ops import episode_kernels as ek
    base = ek._nv_tile_plan(dims, L, K, T, lanes, BASE_LAYOUT[layout])
    if layout == "table":
        offsets, floats = dict(base.offsets, table=base.floats), base.floats + K * lanes
    elif layout == "turns":
        offsets = base.offsets
        floats = max(offsets["x0"] + K * 32, offsets["ring"] + L * lanes)
    else:
        return base
    return dataclasses.replace(base, layout=layout, offsets=offsets, floats=floats,
                               bytes=4 * floats, blocks_per_sm=ek._blocks_per_sm(
                                   4 * floats, lanes, ek._NV_TILE_REGS))


def raw_actor(dev, seed=3):
    """A 10-64-64-1 actor of random weights with no obs statistics folded
    in: layer 1 scaled down 50x, the obs being prices and orders in the tens
    to thousands."""
    import torch
    g = torch.Generator().manual_seed(seed)
    dims = (10, 64, 64, 1)
    Ws = [torch.randn(a, b, generator=g) / a ** 0.5 for a, b in zip(dims, dims[1:])]
    bs = [torch.randn(b, generator=g) * 0.1 for b in dims[1:]]
    Ws[0] = Ws[0] / 50.0
    return tuple(W.to(dev) for W in Ws), tuple(b.to(dev) for b in bs)


def drift(dev):
    """{case: {"kernel": (orders, returns), "plain_cpu": (orders, returns)}}:
    the lane shares of K20 against the plain version on the card and of the
    plain version on the CPU against it on the card."""
    import torch

    import chip_smoke
    from or_gym_inventory_torch.ops import episode_kernels as ek
    cpu, (b, E) = torch.device("cpu"), (1_000, 3)
    out = {}
    for mu_max in (200.0, 30_000.0):
        params = chip_smoke.nv_params(mu_max=mu_max)
        for name in ("seeded", "raw"):
            actor, log_std = chip_smoke.seeded_actor(params.obs_dim, 1, dev)
            if name == "raw":
                actor, log_std = raw_actor(dev), torch.full((1,), -0.5, device=dev)
            on_cpu = tuple(tuple(x.cpu() for x in part) for part in actor)
            for ls in (None, log_std):
                std = None if ls is None else ek.clipped_std(ls)
                ret, _, acts, _ = ek.sample_policy_streams_debug_nv(params, actor, 9, b, E, ls,
                                                                    dev)
                runs = {"card": ek._nv_policy_plain(params, actor, std, 9, b, E, dev, True),
                        "cpu": ek._nv_policy_plain(params, on_cpu, None if std is None
                                                   else std.cpu(), 9, b, E, cpu, True)}
                want, _, want_a, _ = runs["card"]
                shares = {}
                for what, (r, a) in (("kernel", (ret, acts)),
                                     ("plain_cpu", (runs["cpu"][0], runs["cpu"][2]))):
                    r, a = r.to(dev), a.to(dev)
                    shares[what] = tuple(chip_smoke.lane_share(
                        what, x.reshape(-1, E * b), y.reshape(-1, E * b), need=0.0)[0]
                        for x, y in ((a, want_a), (r, want)))
                case = (f"mu_max {mu_max:g}, {name} actor, "
                        f"{'stochastic' if ls is not None else 'deterministic'}")
                out[case] = shares
                print(f"drift, {case}: lanes agreeing with the plain version on the card "
                      f"(orders, returns): K20 {shares['kernel'][0]:.4f}, "
                      f"{shares['kernel'][1]:.4f}; the plain version on the CPU "
                      f"{shares['plain_cpu'][0]:.4f}, {shares['plain_cpu'][1]:.4f}", flush=True)
    return out


def timed(launch):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("nv_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    lib, log = build_launcher()
    print("ptxas (nv launcher): " + chip_smoke.ptxas_entries(log), flush=True)
    stream = ek._stream(dev)
    params = chip_smoke.nv_params()
    T = params.step_limit
    actor, _ = chip_smoke.seeded_actor(params.obs_dim, 1, dev)
    dims = tuple([params.obs_dim] + [int(W.shape[1]) for W in actor[0]])
    plan = ek._nv_plan(params, ek._plan_key(dev))
    nv_st = plan["struct"]
    st, flat = ek._pack_tile_actor(actor, None, params.obs_dim, 1, ek._nv_half_hi(params), dev)
    mlp, flat_first = ek._pack_actor(actor, None, params.obs_dim, 1, ek._nv_half_hi(params), dev)
    entry = ek.episode_returns_nv_policy(params, actor, SEED, LANES, EPISODES, device=dev)
    ref = entry.reshape(-1).clone()
    out = torch.empty(LANES * EPISODES, dtype=torch.float32, device=dev)
    entry_lib = _build.library("nv_policy")
    args = (plan["lgam"].data_ptr(), plan["disc"].data_ptr(), out.data_ptr(), SEED, LANES,
            EPISODES, T, stream)
    kept = []   # the structs of every launch stay alive until it has run

    def structs(layout, lanes, fewer_blocks=False):
        pl = sweep_plan(dims, nv_st.L, nv_st.K, T, lanes, layout)
        tile, nt = ek._nv_tile_structs(st, dataclasses.replace(pl, layout=BASE_LAYOUT[layout]))
        if fewer_blocks:   # pad the shared memory so that an SM holds one block less
            blocks = pl.blocks_per_sm - 1
            tile.s_total = (ek.SMEM_PER_SM // blocks - ek.SMEM_PER_BLOCK_RESERVED) // 4
        kept.append((tile, nt))
        return pl, tile, nt

    def check(rc, what, where=lib):
        if rc:
            raise RuntimeError(f"{what}: {where.cuda_error_message(rc).decode()}")

    def tile(lanes, fewer_blocks=False):
        _, t, nt = structs(ENTRY_LAYOUT, lanes, fewer_blocks)
        check(entry_lib.nv_policy_returns(ctypes.addressof(nv_st), ctypes.addressof(t),
                                          ctypes.addressof(nt), flat.data_ptr(), *args[:3],
                                          None, None, None, SEED, 0, LANES, EPISODES, T, stream),
              f"tile {lanes}", entry_lib)

    def variant(kind):
        if kind == "tile_occ_less":
            return tile(64, fewer_blocks=True)
        if kind.startswith("first"):
            rc = lib.sweep_first(PARTS[kind], ctypes.addressof(nv_st), ctypes.addressof(mlp),
                                 flat_first.data_ptr(), flat_first.numel(), *args)
        else:
            layout = ENTRY_LAYOUT if kind in ("tile_actor", "tile_env") else kind[len("tile_"):]
            _, t, nt = structs(layout, 64)
            part = PARTS[kind] if kind in PARTS else 10 + ek.NV_TILE_LAYOUTS[layout]
            rc = lib.sweep_tile(part, ctypes.addressof(nv_st), ctypes.addressof(t),
                                ctypes.addressof(nt), flat.data_ptr(), *args)
        check(rc, kind)

    if ek._nv_tile_choice(dims, nv_st.L, nv_st.K, T, nv_st.kc_max).layout != ENTRY_LAYOUT:
        raise AssertionError(f"the entry points do not take the {ENTRY_LAYOUT} layout here")
    layouts = {name: sweep_plan(dims, nv_st.L, nv_st.K, T, 64, name) for name in LAYOUTS}
    for name, pl in layouts.items():
        print(f"layout {name} at 64 lanes: {pl.bytes} B a block, {pl.blocks_per_sm} blocks an SM "
              f"by shared memory and {ek._NV_TILE_REGS} registers; offsets {pl.offsets}",
              flush=True)
    for kind in VARIANTS:   # one untimed launch each, and the checks
        variant(kind)
        torch.cuda.synchronize()
        if kind == "first":
            share, _ = chip_smoke.lane_share("first vs the entry point",
                                             out.reshape(EPISODES, LANES),
                                             ref.reshape(EPISODES, LANES))
            print(f"first: {share:.4%} of lanes agree with the entry point", flush=True)
        elif kind.startswith("tile_") and kind not in ("tile_actor", "tile_env"):
            if not torch.equal(out, ref):
                raise AssertionError(f"{kind} differs from the entry point")
            print(f"{kind}: equal to the entry point bit for bit", flush=True)
    for lanes in TILES:
        tile(lanes)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"tile {lanes} differs from the entry point")
    turns = {"first": [], "tile": []}
    for kind in ("first", "tile", "tile", "first"):
        turns[kind].append(timed(lambda: variant("first") if kind == "first" else tile(64)))
        print(f"turn {kind}: {turns[kind][-1]:.4f} ms on {smi}", flush=True)
    runs = {lanes: [] for lanes in TILES}
    for lanes in TILES + TILES[::-1] + TILES:
        runs[lanes].append(timed(lambda: tile(lanes)))
        print(f"tile {lanes}: {runs[lanes][-1]:.4f} ms on {smi}", flush=True)
    var_ms = {k: [] for k in VARIANTS}
    for _ in range(3):
        for kind in VARIANTS:
            var_ms[kind].append(timed(lambda: variant(kind)))
            print(f"variant {kind}: {var_ms[kind][-1]:.4f} ms on {smi}", flush=True)
    entry_ms = min(timed(lambda: ek.episode_returns_nv_policy(params, actor, SEED, LANES,
                                                              EPISODES, device=dev))
                   for _ in range(3))
    result = {"card": smi, "shape": [LANES, EPISODES, T], "entry_layout": ENTRY_LAYOUT,
              "turns_ms": turns, "tiles_best_ms": {str(k): min(v) for k, v in runs.items()},
              "variants_best_ms": {k: min(v) for k, v in var_ms.items()},
              "entry_point_ms": entry_ms,
              "layouts": {k: {"bytes": v.bytes, "blocks_per_sm": v.blocks_per_sm}
                          for k, v in layouts.items()},
              "drift": drift(dev)}
    print(json.dumps({"nv_tile_sweep": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
