"""Timing and tracing on the card (port of
``or_gym_inventory_tpu/utils/profiling.py``).

PyTorch returns before the device finishes, so a host clock measures the
enqueue. ``cuda_time`` brackets the launches with CUDA events and
synchronises before reading them; ``measure_steps_per_second`` keeps the
JAX package's keys and synchronises the device before each clock read, as
JAX fetches the result to the host; ``trace`` writes a Chrome trace of
``torch.profiler`` (Perfetto, chrome://tracing).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict

import torch

from or_gym_inventory_torch.core.device import synchronize


def cuda_time(fn: Callable, *args, warmup: int = 1, iters: int = 5) -> Dict:
    """Milliseconds per call of ``fn(*args)`` on the current CUDA stream:
    the best and the mean of ``iters`` calls, each timed alone, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return {"best_ms": min(times), "mean_ms": sum(times) / len(times),
            "iters": iters}


def measure_steps_per_second(fn: Callable, *args, steps_per_call: int,
                             warmup: int = 1, iters: int = 5) -> Dict:
    """Time ``fn(*args)``: the first call (kernel builds and first launches
    included), the best and mean of ``iters`` calls after ``warmup`` calls
    in all, and steps/s at the best. Every clock read waits for the device
    work of the result (and, before the first, of the arguments)."""
    synchronize(args)
    t0 = time.perf_counter()
    synchronize(fn(*args))
    compile_and_first = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        synchronize(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        synchronize(fn(*args))
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {
        "compile_plus_first_s": compile_and_first,
        "best_exec_s": best,
        "mean_exec_s": sum(times) / len(times),
        "steps_per_s": steps_per_call / best,
    }


@contextlib.contextmanager
def trace(log_dir: str = None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write its Chrome trace into ``log_dir`` (default
    ``torch-trace`` under the temporary directory) as
    ``<pid>.<ns>.pt.trace.json``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))
