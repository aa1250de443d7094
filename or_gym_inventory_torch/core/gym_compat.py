"""The Gymnasium names the host surfaces build on (``envs.adapters``,
``vector.gym_vector``): gymnasium's own where it is installed, else
minimal stand-ins.

A CUDA host may run the port without gymnasium. The stand-ins keep what
the reference's protocol reads: ``Env.reset(seed=...)`` installs the very
PCG64 Generator ``gymnasium.utils.seeding.np_random(seed)`` makes, so the
adapters' trajectories do not depend on which base they stand on; ``Box``
carries ``low``, ``high``, ``shape`` and ``dtype``, samples from its own
Generator and tests membership; ``VectorEnv``, ``AutoresetMode`` and
``batch_space`` carry what ``BatchedGymVectorEnv`` uses. The stand-ins are
defined in any case (``HostEnv``, ``HostBox``, ...), so that the tests hold
them against gymnasium's.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np

try:
    import gymnasium
except ImportError:
    gymnasium = None


def np_random(seed: Optional[int] = None) -> Tuple[np.random.Generator, int]:
    """``gymnasium.utils.seeding.np_random``: PCG64 on the seed's
    SeedSequence, and the sequence's entropy."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"seed must be a non-negative Python int, got {seed!r}")
    seq = np.random.SeedSequence(seed)
    return np.random.Generator(np.random.PCG64(seq)), seq.entropy


class HostEnv:
    """The part of ``gymnasium.Env`` the adapters use."""

    metadata = {"render_modes": []}
    _np_random = None
    _np_random_seed = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random, self._np_random_seed = np_random()
        return self._np_random

    @property
    def unwrapped(self):
        return self

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._np_random, self._np_random_seed = np_random(seed)

    def close(self):
        pass


class HostBox:
    """``gymnasium.spaces.Box`` on finite bounds: integer boxes sample the
    inclusive range, float boxes [low, high)."""

    def __init__(self, low, high, shape=None, dtype=np.float32, seed=None):
        self.dtype = np.dtype(dtype)
        shape = tuple(shape) if shape is not None else np.shape(low)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), shape).copy()
        self._np_random = (seed if isinstance(seed, np.random.Generator)
                           else None if seed is None else np_random(seed)[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.low.shape

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random()[0]
        return self._np_random

    def seed(self, seed: Optional[int] = None):
        self._np_random, entropy = np_random(seed)
        return [entropy]

    def sample(self) -> np.ndarray:
        if not (np.isfinite(self.low).all() and np.isfinite(self.high).all()):
            raise NotImplementedError("HostBox samples finite bounds only")
        if np.issubdtype(self.dtype, np.integer):
            draw = self.np_random.integers(self.low, self.high, endpoint=True)
        else:
            draw = self.np_random.uniform(self.low, self.high)
        return draw.astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(x.shape == self.shape and np.can_cast(x.dtype, self.dtype)
                    and np.all(x >= self.low) and np.all(x <= self.high))

    def __eq__(self, other) -> bool:
        return (isinstance(other, HostBox) and self.dtype == other.dtype
                and self.shape == other.shape and np.array_equal(self.low, other.low)
                and np.array_equal(self.high, other.high))

    def __repr__(self):
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"


class HostAutoresetMode(enum.Enum):
    """``gymnasium.vector.AutoresetMode``."""

    NEXT_STEP = "NextStep"
    SAME_STEP = "SameStep"
    DISABLED = "Disabled"


class HostVectorEnv:
    """The part of ``gymnasium.vector.VectorEnv`` the batched env uses."""

    metadata = {"autoreset_mode": HostAutoresetMode.NEXT_STEP}
    closed = False

    @property
    def unwrapped(self):
        return self

    def close(self, **kwargs):
        if self.closed:
            return
        self.close_extras(**kwargs)
        self.closed = True

    def close_extras(self, **kwargs):
        pass


def host_batch_space(space: HostBox, n: int) -> HostBox:
    """``gymnasium.vector.utils.batch_space`` of a Box: its bounds stacked n
    times along a new leading axis."""
    return HostBox(np.repeat(space.low[None], n, axis=0), np.repeat(space.high[None], n, axis=0),
                   dtype=space.dtype)


if gymnasium is not None:
    from gymnasium import Env
    from gymnasium.spaces import Box
    from gymnasium.vector import AutoresetMode, VectorEnv
    from gymnasium.vector.utils import batch_space
else:
    Env, Box, AutoresetMode, VectorEnv = HostEnv, HostBox, HostAutoresetMode, HostVectorEnv
    batch_space = host_batch_space
