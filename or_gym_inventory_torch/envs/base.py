"""The functional environment interface (port of
``or_gym_inventory_tpu/envs/base.py``).

    state, ts = env.reset(params, generator, batch, device)
    state, ts = env.step(params, state, action, generator)

``params`` is a frozen dataclass; ``state`` a dataclass of tensors with a
leading batch dimension. Randomness comes from an explicit
``torch.Generator``. ``step_with_demand`` is the deterministic kernel that
takes the demand injected (the NumPy-parity oracle's hook).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from or_gym_inventory_torch.core.spaces import Box
from or_gym_inventory_torch.core.struct import TimeStep


@dataclasses.dataclass(frozen=True)
class Environment:
    """A bundle of pure functions defining one environment family."""

    name: str
    default_params: Callable[..., Any]
    reset: Callable[..., Tuple[Any, TimeStep]]
    step: Callable[..., Tuple[Any, TimeStep]]
    step_with_demand: Callable[..., Tuple[Any, TimeStep]]
    observation_space: Callable[[Any], Box]
    action_space: Callable[[Any], Box]
    # seeded_draws(params, seeds) -> (reset, demands): the lane-seeded
    # episodes' draws (vector.vecenv.evaluate_episodes_seeded)
    seeded_draws: Optional[Callable[..., Tuple[Callable, list]]] = None

    def horizon(self, params) -> int:
        """Static episode length (all families truncate at a fixed horizon)."""
        return params.horizon
