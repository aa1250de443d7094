"""Timing on the card (port of ``or_gym_inventory_tpu/utils/profiling.py``).

PyTorch returns before the device finishes, so a host clock measures the
enqueue. ``cuda_time`` brackets the launches with CUDA events and
synchronises before reading them.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


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
