"""Time K22 (the PyTorch port's LSTM-policy returns kernel) at several tiles,
and split its time into the actor, the weight fetch and the env phase, on
one CUDA card.

K22 (``k_im_lstm_returns`` in or_gym_inventory_torch/csrc/im_lstm.cu) runs
its gate product on the tensor cores over a block of LANES lanes with WM
warps along the units (csrc/lstm.cuh); the entry points launch the tiles of
im_lstm.cu's ``LSTM_TILES``. This script builds, into the ignored
``build/`` directory, one extra library whose only source includes
im_lstm.cu and adds:

- launchers of K22 and K24 (``k_im_lstm_traj``) at the tiles in
  ``SWEEP_TILES``: the entry points' two and a 128-lane tile of 4 x 4 warps,
  which no entry point launches;
- three variants at the 64-lane tile, each timed only: the actor alone (no
  env phase; ``actor``), the actor with every gate A fragment read from a
  small shared-memory block instead of L2 (``actor_smem_a``: what staging
  the weights in shared memory by cp.async or TMA could save at most, its
  copies free), and the env phase alone (observations, actions and step on
  the lane threads, the next period's draws on the next LANES threads,
  with the actor's barriers but not its work; ``env``).

It runs at the LSTM evaluation's operating point (InvManagement defaults,
the benchmark LSTM of encoder 64 and hidden 128 with chip_smoke.py's seeded
weights, 1,048,576 lanes x 30 periods), in turns: every tile, then the same
in reverse, then forward again, then the variants three times; and K24
(65,536 lanes) once per tile. Every K22 and K24 run must give the entry
point's outputs bit for bit (a lane's sums do not depend on the tile); the
variants' outputs are not results. It prints each run's time, ptxas's
registers and stack of each kernel, and a JSON line of the best times.

    python3 tools/lstm_tile_sweep.py

Without a CUDA card it exits 1.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LANES, TRAJ_LANES, SEED = 1_048_576, 65_536, 2024
TILES = ((64, 4), (32, 8), (128, 4))
VARIANTS = ("actor", "actor_smem_a", "env")

LAUNCHER = r"""
#include "im_lstm.cu"

#define SWEEP_TILES(X) X(64, 4) X(32, 8) X(128, 4)

namespace {

__device__ __forceinline__ float4 lds128(const float4* p) {
  float4 v;
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}

// lstm.cuh's mma_rows with the A fragments of k-step ks read from slot ks % 4
// of a shared-memory block (NS M-tiles a slot; the values repeat) in place
// of L2, prefetched one k-step ahead as there.
template <int NS>
__device__ __forceinline__ void mma_rows_smem(const float4* a_s, int k_steps, int ke,
                                              const float* x_lo, const float* x_hi, int S,
                                              int col, int tig, float (&acc)[NS][4][4]) {
  float4 next[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) next[s] = lds128(a_s + s * 32);
#pragma unroll 2
  for (int ks = 0; ks < k_steps; ++ks) {
    float4 cur[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      cur[s] = next[s];
      if (ks + 1 < k_steps) next[s] = lds128(a_s + (((ks + 1) & 3) * NS + s) * 32);
    }
    const float* x = ks < ke ? x_lo + 8 * ks * S : x_hi + 8 * (ks - ke) * S;
    mma_kstep<NS>(cur, x, S, col, tig, acc);
  }
}

// lstm.cuh's lstm_cell on mma_rows_smem.
template <int LANES, int WM>
__device__ __forceinline__ void cell_smem_a(const Lstm& L, const float* __restrict__ w,
                                            const float* smem, const float4* a_s,
                                            const float* hold, float* hnew,
                                            float (&c)[lstm_groups_per_warp(WM)][4][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tig = lane & 3;
  const int S = L.stride, col = 32 * wn + gid, ke = L.e_pad / 8, kh = L.h_pad / 8;
  const float4* bias = reinterpret_cast<const float4*>(w + L.b_gate);
#pragma unroll
  for (int j = 0; j < lstm_groups_per_warp(WM); ++j) {
    const int ug = wm + j * WM;
    if (ug >= kh) break;
    const float4 b = __ldg(bias + 8 * ug + gid);
    float acc[2][4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[0][nt][0] = acc[0][nt][1] = b.x;
      acc[0][nt][2] = acc[0][nt][3] = b.y;
      acc[1][nt][0] = acc[1][nt][1] = b.z;
      acc[1][nt][2] = acc[1][nt][3] = b.w;
    }
    mma_rows_smem<2>(a_s + lane, L.k_steps, ke, smem + L.s_e, hold, S, col, tig, acc);
    float* hrow = hnew + (8 * ug + gid) * S + 32 * wn + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float hv[2];
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const float ig = sigmoidf(acc[0][nt][l]), fg = sigmoidf(acc[0][nt][2 + l]);
        const float gg = tanhf(acc[1][nt][l]), og = sigmoidf(acc[1][nt][2 + l]);
        c[j][nt][l] = __fadd_rn(__fmul_rn(fg, c[j][nt][l]), __fmul_rn(ig, gg));
        hv[l] = keep_nan(__fmul_rn(og, tanhf(c[j][nt][l])));
      }
      *reinterpret_cast<float2*>(hrow + 8 * nt) = make_float2(hv[0], hv[1]);
    }
  }
}

// The actor alone, T periods on zero observations (its work does not
// depend on them); with SMEM_A the gate fragments come from shared memory.
template <int LANES, int WM, bool SMEM_A>
__global__ void __launch_bounds__(LANES * WM, lstm_min_blocks(LANES * WM))
    k_actor(const __grid_constant__ Lstm L, const float* __restrict__ w,
            float* __restrict__ out, long long B, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float4* a_s = smem4 + L.s_total / 4;
  float c[lstm_groups_per_warp(WM)][4][2];
  float *hold, *hnew;
  lstm_reset<WM>(L, smem, hold, hnew, c);
  if (SMEM_A)
    for (int k = threadIdx.x; k < 8 * 32; k += blockDim.x)
      smem4[L.s_total / 4 + k] = __ldg(reinterpret_cast<const float4*>(w + L.w_gate) + k);
  for (int t = 0; t < T; ++t) {
    if (SMEM_A) {
      __syncthreads();
      lstm_encoder<WM>(L, w, smem);
      cell_smem_a<LANES, WM>(L, w, smem, a_s, hold, hnew, c);
      __syncthreads();
      lstm_head<LANES>(L, w, hnew, smem + L.s_m);
      __syncthreads();
      float* tmp = hold;
      hold = hnew;
      hnew = tmp;
    } else {
      lstm_forward<LANES, WM>(L, w, smem, hold, hnew, c);
    }
  }
  const long long b = (long long)blockIdx.x * LANES + threadIdx.x;
  if (threadIdx.x < LANES && b < B) out[b] = smem[L.s_m + threadIdx.x];
}

// The env phase alone: K22's lane and draw threads and its barriers, with
// the means left at zero and no actor.
template <int LANES, int WM, bool BACKLOG>
__global__ void __launch_bounds__(LANES * WM, lstm_min_blocks(LANES * WM))
    k_env(const __grid_constant__ ImParams p, const __grid_constant__ Lstm L,
          const float* __restrict__ w, const float* __restrict__ table,
          const int* __restrict__ user_d, const float* __restrict__ disc,
          float* __restrict__ out, unsigned seed, long long B, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = threadIdx.x, S = L.stride;
  const long long lane0 = (long long)blockIdx.x * LANES, b = lane0 + n;
  const bool lane = n < LANES, live = lane && b < B, drawer = !lane && n < 2 * LANES;
  for (int k = threadIdx.x; k < L.s_total; k += blockDim.x) smem[k] = 0.f;
  ImEpisode s;
  int ah[IM_MAX_LT * IM_MAX_M1];
  int act[IM_MAX_M1];
  float raw[IM_MAX_M1], total = 0.f;
  if (lane) im_reset(p, s);
  __syncthreads();
  if (drawer) draw_ahead<false, LANES>(p, L, table, user_d, seed, lane0, 0, smem);
  for (int t = 0; t < T; ++t) {
    if (lane) lane_obs(p, s, t, ah, smem + L.s_x0 + n, S);
    for (int i = 0; i < L.n_enc + 3; ++i) __syncthreads();
    if (lane) {
      const float* buf = smem + L.s_z + (t & 1) * (L.act + 1) * S + n;
      lane_act<false>(L, w, smem + L.s_m + n, buf, p.m1, raw, act);
      const float profit = lane_step<BACKLOG>(p, s, t, act, __float_as_int(buf[L.act * S]), ah);
      total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
    } else if (drawer && t + 1 < T) {
      draw_ahead<false, LANES>(p, L, table, user_d, seed, lane0, t + 1, smem);
    }
  }
  if (live) out[b] = total;
}

}  // namespace

extern "C" {

int sweep_returns(const ImParams* p, const Lstm* L, const float* w, const float* table,
                  const int* user_d, const float* disc, float* out, int* acts, int* dems,
                  unsigned seed, int backlog, long long B, int T, cudaStream_t stream) {
#define SWEEP_RETURNS(N, W)                                                              \
  if (L->lanes == N && L->warps_m == W)                                                  \
    return backlog ? launch_tile(k_im_lstm_returns<N, W, false, true>, *L, B, stream, *p, \
                                 *L, w, table, user_d, disc, out, acts, dems, seed, B, T)  \
                   : launch_tile(k_im_lstm_returns<N, W, false, false>, *L, B, stream,    \
                                 *p, *L, w, table, user_d, disc, out, acts, dems, seed, B, \
                                 T);
  SWEEP_TILES(SWEEP_RETURNS)
#undef SWEEP_RETURNS
  return (int)cudaErrorInvalidConfiguration;
}

int sweep_traj(const ImParams* p, const Lstm* L, const float* w, const float* table,
               const int* user_d, const float* disc, int* inv, int* acts, float* raw,
               float* rew, int* dem, unsigned seed, int backlog, long long B, int T,
               cudaStream_t stream) {
#define SWEEP_TRAJ(N, W)                                                                  \
  if (L->lanes == N && L->warps_m == W)                                                   \
    return backlog ? launch_tile(k_im_lstm_traj<N, W, true>, *L, B, stream, *p, *L, w,    \
                                 table, user_d, disc, inv, acts, raw, rew, dem, seed, B, T) \
                   : launch_tile(k_im_lstm_traj<N, W, false>, *L, B, stream, *p, *L, w,   \
                                 table, user_d, disc, inv, acts, raw, rew, dem, seed, B, T);
  SWEEP_TILES(SWEEP_TRAJ)
#undef SWEEP_TRAJ
  return (int)cudaErrorInvalidConfiguration;
}

// kind 0: the actor; 1: the actor, A fragments from shared memory; 2: the
// env phase. At the 64-lane tile only.
int sweep_variant(int kind, const ImParams* p, const Lstm* L, const float* w,
                  const float* table, const int* user_d, const float* disc, float* out,
                  unsigned seed, int backlog, long long B, int T, cudaStream_t stream) {
  if (L->lanes != 64 || L->warps_m != 4) return (int)cudaErrorInvalidConfiguration;
  if (kind == 0) return launch_tile(k_actor<64, 4, false>, *L, B, stream, *L, w, out, B, T);
  if (kind == 1) {
    Lstm sized = *L;  // the launch's shared memory: the layout and 8 x 32 fragments
    sized.s_total += 8 * 32 * 4;
    return launch_tile(k_actor<64, 4, true>, sized, B, stream, *L, w, out, B, T);
  }
  return backlog ? launch_tile(k_env<64, 4, true>, *L, B, stream, *p, *L, w, table, user_d,
                               disc, out, seed, B, T)
                 : launch_tile(k_env<64, 4, false>, *L, B, stream, *p, *L, w, table, user_d,
                               disc, out, seed, B, T);
}

}  // extern "C"
"""


def build_launcher():
    """Compile the launcher next to the port's libraries; returns (the
    library bound, ptxas's report)."""
    from or_gym_inventory_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "lstm_tile_sweep.cu"
    src.write_text(LAUNCHER)
    so = _build.BUILD_DIR / "liblstm_tile_sweep.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                          str(so), str(src)], check=True, capture_output=True, text=True,
                         timeout=900)
    lib = ctypes.CDLL(str(so))
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.sweep_returns.argtypes = [P, P, P, P, P, P, P, P, P, U, I, LL, I, P]
    lib.sweep_traj.argtypes = [P, P, P, P, P, P, P, P, P, P, P, U, I, LL, I, P]
    lib.sweep_variant.argtypes = [I, P, P, P, P, P, P, P, U, I, LL, I, P]
    for fn in (lib.sweep_returns, lib.sweep_traj, lib.sweep_variant):
        fn.restype = I
    lib.cuda_error_message.argtypes, lib.cuda_error_message.restype = [I], ctypes.c_char_p
    return lib, res.stdout + res.stderr


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lstm_tile_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import episode_kernels as ek

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    lib, ptxas = build_launcher()
    print("ptxas: " + chip_smoke.ptxas_entries(ptxas), flush=True)
    params = im.default_params()
    T, m1 = params.periods, params.m1
    actor, log_std = chip_smoke.seeded_lstm_actor(params, dev)
    obs_dim = im.observation_space(params).shape[0]
    dims, h = ek._lstm_dims(actor, obs_dim, m1)
    ref = ek.episode_returns_im_lstm(params, actor, SEED, LANES, dev)
    ref_traj = ek.rollout_traj_im_lstm(params, actor, log_std, SEED, TRAJ_LANES, device=dev)
    st, flat = ek._pack_lstm_actor(actor, None, obs_dim, m1, ek._half_c(params), dev)
    st_traj, flat_traj = ek._pack_lstm_actor(actor, ek.clipped_std(log_std), obs_dim, m1,
                                             ek._half_c(params), dev)
    plan = ek._im_plan(params, ek._plan_key(dev))
    env_args = [ctypes.addressof(plan["struct"])]
    tables = [plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr()]
    stream = ek._stream(dev)
    out = torch.empty(LANES, dtype=torch.float32, device=dev)
    traj = {k: torch.empty_like(v) for k, v in ref_traj.items()}

    def tiled(base, tile):
        st1 = type(base).from_buffer_copy(base)
        ek._set_lstm_tile(st1, ek._lstm_plan(dims, h, m1, tile))
        return st1

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what}: {lib.cuda_error_message(rc).decode()}")

    def timed(launch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def k22(tile):
        s1 = tiled(st, tile)
        check(lib.sweep_returns(*env_args, ctypes.addressof(s1), flat.data_ptr(), *tables,
                                out.data_ptr(), None, None, SEED, int(params.backlog), LANES,
                                T, stream), f"K22 at {tile}")

    def k24(tile):
        s1 = tiled(st_traj, tile)
        check(lib.sweep_traj(*env_args, ctypes.addressof(s1), flat_traj.data_ptr(), *tables,
                             *(traj[k].data_ptr() for k in ("inv", "actions", "raw", "reward",
                                                            "demand")),
                             SEED, int(params.backlog), TRAJ_LANES, T, stream), f"K24 at {tile}")

    def variant(kind):
        s1 = tiled(st, (64, 4))
        check(lib.sweep_variant(VARIANTS.index(kind), *env_args, ctypes.addressof(s1),
                                flat.data_ptr(), *tables, out.data_ptr(), SEED,
                                int(params.backlog), LANES, T, stream), kind)

    for tile in TILES:   # one untimed launch each
        k22(tile)
    torch.cuda.synchronize()
    runs = {t: [] for t in TILES}
    for tile in TILES + TILES[::-1] + TILES:
        out.zero_()
        runs[tile].append(timed(lambda: k22(tile)))
        if not torch.equal(out, ref):
            raise AssertionError(f"K22 at tile {tile} differs from episode_returns_im_lstm")
        print(f"K22 tile {tile}: {runs[tile][-1]:.4f} ms", flush=True)
    traj_ms = {}
    for tile in TILES:
        k24(tile)
        torch.cuda.synchronize()
        traj_ms[tile] = min(timed(lambda: k24(tile)) for _ in range(5))
        if not all(torch.equal(traj[k], ref_traj[k]) for k in ref_traj):
            raise AssertionError(f"K24 at tile {tile} differs from rollout_traj_im_lstm")
        print(f"K24 tile {tile}: {traj_ms[tile]:.4f} ms", flush=True)
    for kind in VARIANTS:
        variant(kind)
    torch.cuda.synchronize()
    var_ms = {k: [] for k in VARIANTS}
    for _ in range(3):
        for kind in ("full",) + VARIANTS:
            if kind == "full":
                runs[(64, 4)].append(timed(lambda: k22((64, 4))))
                print(f"K22 tile (64, 4): {runs[(64, 4)][-1]:.4f} ms", flush=True)
            else:
                var_ms[kind].append(timed(lambda: variant(kind)))
                print(f"variant {kind}: {var_ms[kind][-1]:.4f} ms", flush=True)
    rows = [{"lanes": t[0], "warps_m": t[1], "threads": t[0] * t[1],
             "k22_best_ms": min(runs[t]), "k22_runs_ms": runs[t], "k24_best_ms": traj_ms[t],
             "entry_point_tile": t in ek._LSTM_TILES} for t in TILES]
    print(json.dumps({"lstm_tile_sweep": rows,
                      "variants_best_ms": {k: min(v) for k, v in var_ms.items()},
                      "variants_runs_ms": var_ms, "card": smi.strip(),
                      "shape": [LANES, T], "k24_lanes": TRAJ_LANES}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
