"""Time K8 (the PyTorch port's InvManagement random-policy returns kernel)
on one CUDA card: its first design, whose state lives in a thread's local
frame, beside the state in shared memory and registers, in each form, at
several block sizes.

K8 (``k_im_returns_fused`` in or_gym_inventory_torch/csrc/im_episode.cu)
keeps the ring of fulfilled orders in the thread's column of shared memory
and, unrolling every stage loop of csrc/im_step.cuh, its per-stage arrays
in registers, with an instance for each m1 from 1 to IM_MAX_M1. This
script builds, into the ignored ``build/`` directory, one extra library
that includes im_episode.cu and adds:

- ``frame``: the first design (the parent's K8), the whole state in a
  local ImEpisode, 128 threads a block;
- ``shared_ring``: the ring in shared memory, the stage loops to the
  run-time m1 (the per-stage arrays in the local frame);
- ``shared_pred``: the ring in shared memory and the stage loops unrolled
  to the struct maxima under i < m1 predicates, one instance for every m1;
- ``shared_exact``: unrolled to exactly m1 = 3 (the entry points' instance
  for InvManagement's default three stocked stages).

Each runs at the random-policy main path's shape (inv_management's default
params, backlog: 4,194,304 lanes x 16 episodes x 30 periods) at the block
size the entry points' plan picks (``_im_fused_plan``); the entry points'
kernel is also timed through their C function at 64, 128 and 256 threads.
In turns: the first design and the entry point's kernel, then the reverse
(the parent's kernel and this one, in one call); the block sizes forward,
reversed and forward; each variant three times. Every run must equal the
entry point's returns bit for bit (int32 state, the same arithmetic). It
also times nvcc on im_episode.cu as it is (an instance for each m1) and on
a copy of it whose K8 has the predicated instance alone, the build cost of
the instances, and prints ptxas's registers and stack and the SASS's local
loads and stores (LDL/STL) per kernel, each time with the card's name and
power limit, and a JSON line of the best times.

    python3 tools/im_fused_sweep.py [--parent DIR]

With ``--parent DIR``, a checkout of another tree (the parent commit,
unpacked under an ignored directory), it also builds that tree's
im_episode.cu and times K9 (``im_sample_streams``, which shares the draws
of csrc/im_step.cuh) from both in turns at 65,536 x 30, the two dumps
equal bit for bit. Without a CUDA card it exits 1.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LANES, EPISODES, SEED = 4_194_304, 16, 2024
K9_LANES, K9_REPS = 65_536, 20   # K9 at chip_smoke.py's CHECK_LANES; launches a turn
THREADS = (64, 128, 256)
VARIANTS = ("frame", "shared_ring", "shared_pred", "shared_exact")

LAUNCHER = r"""
#include "im_episode.cu"

namespace {

// The first design of K8: the state in the thread's local ImEpisode.
template <bool BACKLOG>
__global__ void k_frame(const __grid_constant__ ImParams p, const float* __restrict__ table,
                        const int* __restrict__ user_d, const float* __restrict__ disc,
                        float* __restrict__ out, unsigned seed, long long B, int E, int T) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= B * E) return;
  const unsigned e = (unsigned)(idx / B);
  const unsigned lane = (unsigned)(idx - (long long)e * B);
  ImEpisode s;
  im_reset(p, s);
  int act[IM_MAX_M1], r_req[IM_MAX_M1];
  float total = 0.f;
  for (int t = 0; t < T; ++t) {
    WordStream ws(seed, 0u, lane, e, (unsigned)t);
    im_draw_actions(p, ws, act);
    const int d = im_demand(p, table, user_d, t, ws.next());
    const float profit = im_step<BACKLOG>(p, s, t, act, d, r_req);
    total = __fadd_rn(total, __fmul_rn(__ldg(disc + t), profit));
  }
  out[idx] = total;
}

}  // namespace

extern "C" {

// kind 0: the frame kernel at kThreads; 1, 2, 3: k_im_returns_fused with
// M1 = IM_LOOP, 0 or 3 on lay; backlog.
int sweep_fused(int kind, const ImParams* p, const ImSmem* lay, const float* table,
                const int* user_d, const float* disc, float* out, unsigned seed, long long B,
                int E, int T, cudaStream_t stream) {
  if (kind == 0) {
    k_frame<true><<<blocks_for(B * E), kThreads, 0, stream>>>(*p, table, user_d, disc, out, seed,
                                                              B, E, T);
    return (int)cudaGetLastError();
  }
  if (kind == 1)
    return launch_fused<true, IM_LOOP>(*p, *lay, table, user_d, disc, out, seed, B, E, T, stream);
  if (kind == 2)
    return launch_fused<true, 0>(*p, *lay, table, user_d, disc, out, seed, B, E, T, stream);
  if (kind == 3 && p->m1 == 3)
    return launch_fused<true, 3>(*p, *lay, table, user_d, disc, out, seed, B, E, T, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
"""


def build():
    """Compile the launcher; then im_episode.cu and its copy with the
    predicated instance alone, one after the other, timed. Returns (the launcher bound,
    ptxas's report, its path, {form: nvcc seconds})."""
    from or_gym_inventory_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "im_fused_sweep.cu"
    src.write_text(LAUNCHER)
    so = _build.BUILD_DIR / "libim_fused_sweep.so"
    nvcc = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC)]
    proc = subprocess.run(nvcc + ["-o", str(so), str(src)], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the launcher:\n{proc.stdout}{proc.stderr}")
    text = (_build.CSRC / "im_episode.cu").read_text()
    generic = text
    for backlog in ("true", "false"):
        call = f"launch_fused_m1<{backlog}>("
        if call not in generic:
            raise RuntimeError(f"im_episode.cu no longer dispatches through {call}")
        generic = generic.replace(call, f"launch_fused<{backlog}, 0>(")
    generic_src = _build.BUILD_DIR / "im_episode_generic_only.cu"
    generic_src.write_text(generic)
    seconds = {}
    for form, path in (("every_m1", _build.CSRC / "im_episode.cu"), ("generic_only", generic_src)):
        t0 = time.perf_counter()
        built = subprocess.run(nvcc + ["-o", str(_build.BUILD_DIR / f"im_{form}.so"), str(path)],
                               capture_output=True, text=True, timeout=900)
        if built.returncode != 0:
            raise RuntimeError(f"nvcc failed for im_episode.cu ({form}):\n{built.stdout}"
                               f"{built.stderr}")
        seconds[form] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.sweep_fused.argtypes = [I, P, P, P, P, P, P, U, LL, I, I, P]
    lib.sweep_fused.restype = I
    lib.cuda_error_message.argtypes, lib.cuda_error_message.restype = [I], ctypes.c_char_p
    return lib, proc.stdout + proc.stderr, str(so), seconds


def k9_library(csrc, name):
    """im_episode.cu of the tree whose sources are ``csrc``, built as
    ``name``, with im_sample_streams bound."""
    from or_gym_inventory_torch.ops import _build
    so = _build.BUILD_DIR / f"{name}.so"
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so),
                            str(csrc / "im_episode.cu")], capture_output=True, text=True,
                           timeout=900)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}/im_episode.cu:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I, LL, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.im_sample_streams.argtypes = [P, P, P, P, P, U, LL, I, I, P]
    lib.im_sample_streams.restype = I
    return lib


def k9_turns(parent_csrc, params, plan, stream, smi):
    """K9 from the parent's im_episode.cu and this tree's, in turns parent,
    change, change, parent, three times; each turn the mean ms of K9_REPS
    launches. Raises unless both dump the same streams."""
    import torch

    from or_gym_inventory_torch.ops import _build
    libs = {"parent": k9_library(parent_csrc, "im_episode_parent"),
            "change": k9_library(_build.CSRC, "im_episode_change")}
    T, m1 = params.periods, params.m1
    outs = {k: (torch.empty((T, 1, m1, K9_LANES), dtype=torch.int32, device="cuda"),
                torch.empty((T, 1, K9_LANES), dtype=torch.int32, device="cuda")) for k in libs}

    def launch(kind):
        acts, dems = outs[kind]
        rc = libs[kind].im_sample_streams(ctypes.addressof(plan["struct"]),
                                          plan["table"].data_ptr(), plan["user_d"].data_ptr(),
                                          acts.data_ptr(), dems.data_ptr(), SEED, K9_LANES, 1, T,
                                          stream)
        if rc:
            raise RuntimeError(f"K9 ({kind}) failed to launch: error {rc}")

    for kind in libs:
        launch(kind)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(outs["parent"], outs["change"])):
        raise AssertionError("K9: the parent's streams differ from this tree's")
    ms = {k: [] for k in libs}
    for _ in range(3):
        for kind in ("parent", "change", "change", "parent"):
            ms[kind].append(timed(lambda: [launch(kind) for _ in range(K9_REPS)]) / K9_REPS)
            print(f"K9 turn {kind}: {ms[kind][-1]:.4f} ms on {smi}", flush=True)
    return ms


def timed(launch):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="a checkout of another tree whose K9 is timed in turns with this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("im_fused_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from or_gym_inventory_torch.envs import inv_management as im
    from or_gym_inventory_torch.ops import _build
    from or_gym_inventory_torch.ops import episode_kernels as ek

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    lib, log, so, seconds = build()
    print("ptxas (im launcher): " + chip_smoke.ptxas_entries(log), flush=True)
    sass = chip_smoke.sass_counts(so)
    print("SASS LDL/STL (im launcher): " + ("cuobjdump not found" if sass is None else ", ".join(
        f"{k} {ld}/{st}" for k, (ld, st, _) in sorted(sass.items()))), flush=True)
    print("nvcc im_episode.cu: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()),
          flush=True)
    stream = ek._stream(dev)
    params = im.default_params(backlog=True)
    T = params.periods
    plan = ek._im_plan(params, ek._plan_key(dev))
    entry = ek.episode_returns_im_fused(params, SEED, LANES, EPISODES, device=dev)
    ref = entry.reshape(-1).clone()
    del entry
    out = torch.empty(LANES * EPISODES, dtype=torch.float32, device=dev)
    entry_lib = _build.library("im_episode")
    tables = (plan["table"].data_ptr(), plan["user_d"].data_ptr(), plan["disc"].data_ptr(),
              out.data_ptr(), SEED)
    lay = plan["fused"]
    kept = []

    def check(rc, what, where=lib):
        if rc:
            raise RuntimeError(f"{what}: {where.cuda_error_message(rc).decode()}")

    def entry_at(threads):
        st = ek._ImSmem(threads=threads, words=lay.words)
        kept.append(st)
        check(entry_lib.im_episode_returns_fused(ctypes.addressof(plan["struct"]),
                                                 ctypes.addressof(st), *tables, 1, LANES,
                                                 EPISODES, T, stream), f"entry {threads}",
              entry_lib)

    def variant(kind):
        check(lib.sweep_fused(VARIANTS.index(kind), ctypes.addressof(plan["struct"]),
                              ctypes.addressof(lay), *tables, LANES, EPISODES, T, stream), kind)

    for kind in VARIANTS:
        variant(kind)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{kind} differs from the entry point")
        print(f"{kind}: equal to the entry point bit for bit", flush=True)
    for threads in THREADS:
        entry_at(threads)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{threads} threads differ from the entry point")
    turns = {"frame": [], "entry": []}
    for kind in ("frame", "entry", "entry", "frame"):
        turns[kind].append(timed(lambda: variant("frame") if kind == "frame"
                                 else entry_at(lay.threads)))
        print(f"turn {kind}: {turns[kind][-1]:.4f} ms on {smi}", flush=True)
    runs = {t: [] for t in THREADS}
    for threads in THREADS + THREADS[::-1] + THREADS:
        runs[threads].append(timed(lambda: entry_at(threads)))
        print(f"threads {threads}: {runs[threads][-1]:.4f} ms on {smi}", flush=True)
    var_ms = {k: [] for k in VARIANTS}
    for _ in range(3):
        for kind in VARIANTS:
            var_ms[kind].append(timed(lambda: variant(kind)))
            print(f"variant {kind}: {var_ms[kind][-1]:.4f} ms on {smi}", flush=True)
    entry_ms = min(timed(lambda: ek.episode_returns_im_fused(params, SEED, LANES, EPISODES,
                                                             device=dev)) for _ in range(3))
    k9 = None
    if args.parent is not None:
        k9 = k9_turns(args.parent / "or_gym_inventory_torch" / "csrc", params, plan, stream, smi)
    result = {"card": smi, "shape": [LANES, EPISODES, T], "plan_threads": lay.threads,
              "ring_words": lay.words, "turns_ms": turns,
              "threads_best_ms": {str(k): min(v) for k, v in runs.items()},
              "variants_best_ms": {k: min(v) for k, v in var_ms.items()},
              "entry_point_ms": entry_ms, "nvcc_s": seconds, "k9_turns_ms": k9}
    print(json.dumps({"im_fused_sweep": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
