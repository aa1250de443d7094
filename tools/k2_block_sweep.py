"""Time K2 (NetInvMgmt's fused random-policy returns kernel of the PyTorch
port) at 64, 128 and 256 threads a block on one CUDA card.

K2 (``k_episode_returns_fused`` in or_gym_inventory_torch/csrc/net_episode.cu)
keeps each thread's state in shared memory laid out [word][thread] with the
block's own size as the stride, so it runs at any block size; its C entry
point launches it at ``kThreads`` (csrc/launch.cuh). This script builds, into
the ignored ``build/`` directory, one extra library whose only source
includes net_episode.cu and adds a launcher that takes the block size. It
then launches K2 at bench.py's operating point (the default graph, 4,194,304
lanes x 16 episodes x 30 periods) in turns, 64, 128, 256, 256, 128, 64, 64,
128, 256, and prints each size's best time. Every run must give the
returns of the port's own entry point (``episode_returns_fully_fused``) bit
for bit.

    python3 tools/k2_block_sweep.py

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

LANES, EPISODES, PERIODS, SEED = 4_194_304, 16, 30, 2024
ORDER = (64, 128, 256, 256, 128, 64, 64, 128, 256)

LAUNCHER = r"""
#include "net_episode.cu"

extern "C" int k2_at(const NetTopo* topo, const NetSmem* lay, const float* disc,
                     const float* tables, float* out, unsigned seed, float act_scale,
                     long long B, int E, int T, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)lay->words * threads * sizeof(float);
  cudaError_t err = allow_state(k_episode_returns_fused, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B * E + threads - 1) / threads);
  k_episode_returns_fused<<<blocks, threads, smem, stream>>>(
      *topo, *lay, disc, tables, out, seed, act_scale, B, E, T);
  return (int)cudaGetLastError();
}
"""


def build_launcher():
    """Compile the launcher next to the port's libraries; returns it bound."""
    from or_gym_inventory_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "k2_block_sweep.cu"
    src.write_text(LAUNCHER)
    so = _build.BUILD_DIR / "libk2_block_sweep.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(src)], check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k2_at.argtypes = [P, P, P, P, P, ctypes.c_uint32, ctypes.c_float, LL, I, I, I, P]
    lib.k2_at.restype = I
    lib.cuda_error_message.argtypes, lib.cuda_error_message.restype = [I], ctypes.c_char_p
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_block_sweep: no CUDA device", file=sys.stderr)
        return 1
    from or_gym_inventory_torch.envs import net_inv_management as net
    from or_gym_inventory_torch.ops import episode_kernels as ek
    from or_gym_inventory_torch.ops import net_step as ns

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    lib = build_launcher()
    params = net.default_params(num_periods=PERIODS)
    hi = float(params.topology.order_cap_heuristic * 2)
    want = ns.episode_returns_fully_fused(params, SEED, hi, LANES, PERIODS, EPISODES,
                                          device=dev)
    tp, disc, tab = ns._launch_plan(params, PERIODS, ek._plan_key(dev), True)
    plan, layout = ns._shared_layout(params.topology)
    out = torch.empty((EPISODES, LANES), dtype=torch.float32, device=dev)

    def run(threads):
        err = lib.k2_at(ctypes.addressof(tp), ctypes.addressof(layout), disc.data_ptr(),
                        tab.data_ptr(), out.data_ptr(), SEED, ns._act_scale(hi), LANES,
                        EPISODES, PERIODS, threads, ek._stream(dev))
        if err:
            raise RuntimeError(f"K2 at {threads} threads: "
                               f"{lib.cuda_error_message(err).decode()}")

    for threads in (64, 128, 256):   # one untimed launch each
        run(threads)
    torch.cuda.synchronize()
    best = {}
    for threads in ORDER:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out.zero_()
        start.record()
        run(threads)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        best[threads] = min(best.get(threads, ms), ms)
        if not torch.equal(out, want):
            raise AssertionError(f"K2 at {threads} threads a block differs from "
                                 "episode_returns_fully_fused")
        print(f"{threads} threads a block: {ms:.4f} ms", flush=True)
    print(f"K2 at {LANES} x {EPISODES} x {PERIODS}, {plan.words} words of state a thread; "
          "best ms: " + ", ".join(f"{k} threads {v:.4f}" for k, v in sorted(best.items()))
          + f"; the entry point launches {plan.threads}; every run equal to it bit for bit",
          flush=True)
    print(json.dumps({"card": smi.strip(), "best_ms": {str(k): v for k, v in best.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
