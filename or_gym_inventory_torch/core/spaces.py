"""Space descriptions (port of ``or_gym_inventory_tpu/core/spaces.py``).

A ``Box`` holds its bounds as NumPy arrays and draws batches of samples from
an explicit ``torch.Generator`` on the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from or_gym_inventory_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Box:
    """An n-dimensional box of bounded values."""

    low: np.ndarray
    high: np.ndarray
    dtype: np.dtype

    def __init__(self, low, high, shape: Tuple[int, ...] = None, dtype=np.float32):
        dtype = np.dtype(dtype)
        low = np.broadcast_to(np.asarray(low, dtype=dtype), shape).copy() if shape \
            else np.asarray(low, dtype=dtype)
        high = np.broadcast_to(np.asarray(high, dtype=dtype), shape).copy() if shape \
            else np.asarray(high, dtype=dtype)
        assert low.shape == high.shape, (low.shape, high.shape)
        object.__setattr__(self, "low", low)
        object.__setattr__(self, "high", high)
        object.__setattr__(self, "dtype", dtype)
        # per-device tensor copies of the bounds: a host-to-device copy on
        # every sample would stall the stream once per step
        object.__setattr__(self, "_bounds", {})

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.low.shape

    def _on(self, device: torch.device):
        key = str(device)
        if key not in self._bounds:
            tdt = torch.int64 if np.issubdtype(self.dtype, np.integer) \
                else torch.float32
            self._bounds[key] = (torch.as_tensor(self.low, dtype=tdt, device=device),
                                 torch.as_tensor(self.high, dtype=tdt, device=device))
        return self._bounds[key]

    def sample(self, generator: torch.Generator = None,
               batch_shape: Tuple[int, ...] = (), device=None) -> torch.Tensor:
        """Uniform samples of shape ``batch_shape + self.shape``.

        Integer boxes sample the inclusive integer range (gymnasium's Box
        semantics for int dtypes); float boxes sample [low, high).
        ``generator`` must live on ``device``.
        """
        dev = resolve_device(device)
        shape = tuple(batch_shape) + self.shape
        low, high = self._on(dev)
        u = torch.rand(shape, generator=generator, device=dev)
        if np.issubdtype(self.dtype, np.integer):
            span = (high - low + 1).to(torch.float32)
            draw = low + torch.floor(u * span).to(torch.int64)
            # u * span may round up to span in f32 for wide ranges
            return torch.minimum(draw, high).to(torch.int32)
        return low + u * (high - low)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(x.shape == self.shape and np.all(x >= self.low) and np.all(x <= self.high))

    def clip(self, x: torch.Tensor) -> torch.Tensor:
        low, high = self._on(x.device)
        return torch.clamp(x, low.to(x.dtype), high.to(x.dtype))

    def to_gymnasium(self):
        import gymnasium
        return gymnasium.spaces.Box(low=self.low, high=self.high, dtype=self.dtype)

    def __repr__(self):
        return f"Box(shape={self.shape}, dtype={self.dtype})"
