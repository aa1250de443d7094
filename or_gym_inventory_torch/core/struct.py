"""The step result shared by the env families (port of
``or_gym_inventory_tpu/core/struct.py``).

Every field carries a leading batch dimension: the port batches natively
where the JAX package used ``vmap``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class TimeStep:
    obs: torch.Tensor         # (B, obs_dim)
    reward: torch.Tensor      # (B,)
    terminated: torch.Tensor  # (B,) bool; always False in all three families
    truncated: torch.Tensor   # (B,) bool; True at the static horizon
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> torch.Tensor:
        return torch.logical_or(self.terminated, self.truncated)
