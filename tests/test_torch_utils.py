"""The port's ``utils/profiling``, ``utils/compile_cache`` and
``core/struct.tree_batch_size`` on the CPU, against the JAX package's
contracts (tests/test_utils.py:46 for ``measure_steps_per_second``).

- ``measure_steps_per_second`` returns JAX's four keys, steps/s at the best
  time, and calls ``fn`` 1 + (warmup - 1) + iters times;
- ``trace`` writes a Chrome trace (JSON with ``traceEvents``) into the
  directory it is given;
- ``tree_batch_size`` is the leading size of the first array leaf, dict
  keys in sorted order as ``jax.tree_util.tree_leaves`` takes them, and
  equals JAX's on the same structure of NumPy arrays;
- ``enable_persistent_compile_cache``: ``OGT_COMPILE_CACHE=""`` disables it
  (returns "" and creates nothing), the variable overrides ``path``, and a
  second call returns the same directory.
"""

import dataclasses
import json
import os

import numpy as np
import torch

from or_gym_inventory_torch.core.struct import TimeStep, tree_batch_size, tree_leaves
from or_gym_inventory_torch.utils.compile_cache import enable_persistent_compile_cache
from or_gym_inventory_torch.utils.profiling import measure_steps_per_second, trace
from or_gym_inventory_tpu.core import struct as jstruct


def test_measure_steps_per_second():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    out = measure_steps_per_second(fn, torch.ones(64), steps_per_call=1000, warmup=2, iters=3)
    assert set(out) == {"compile_plus_first_s", "best_exec_s", "mean_exec_s", "steps_per_s"}
    assert len(calls) == 1 + 1 + 3
    assert 0 < out["best_exec_s"] <= out["mean_exec_s"]
    assert out["steps_per_s"] == 1000 / out["best_exec_s"]
    assert out["compile_plus_first_s"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as log_dir:
        assert log_dir == str(tmp_path)
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)


@dataclasses.dataclass
class _State:
    a: torch.Tensor
    b: np.ndarray


def test_tree_batch_size():
    ts = TimeStep(obs=torch.zeros(7, 3), reward=torch.zeros(7), terminated=None,
                  truncated=None)
    assert tree_batch_size(ts) == 7
    assert tree_batch_size(_State(torch.zeros(4, 2), np.zeros(9))) == 4
    assert tree_batch_size([None, (torch.zeros(5),)]) == 5
    assert tree_batch_size({}) == tree_batch_size(3.0) == 0
    tree = {"z": np.zeros((2, 1)), "a": [np.zeros((6,)), np.zeros((3,))]}
    assert tree_batch_size(tree) == jstruct.tree_batch_size(tree) == 6   # sorted keys
    assert [x.shape for x in tree_leaves(tree)] == [(6,), (3,), (2, 1)]


def test_compile_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("OGT_COMPILE_CACHE", "")
    assert enable_persistent_compile_cache(str(tmp_path / "off")) == ""
    assert not (tmp_path / "off").exists()
    monkeypatch.delenv("OGT_COMPILE_CACHE")
    path = str(tmp_path / "cache")
    assert enable_persistent_compile_cache(path) == path
    assert enable_persistent_compile_cache(path) == path       # idempotent
    assert os.path.isdir(path)
    monkeypatch.setenv("OGT_COMPILE_CACHE", str(tmp_path / "env"))
    assert enable_persistent_compile_cache(path) == str(tmp_path / "env")
    assert os.path.isdir(tmp_path / "env")
