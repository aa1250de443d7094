"""The step result shared by the env families (port of
``or_gym_inventory_tpu/core/struct.py``).

Every field carries a leading batch dimension: the port batches natively
where the JAX package used ``vmap``. ``tree_batch_size`` reads that
dimension off a nested structure of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
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


def tree_leaves(tree):
    """The array leaves of a nested dict (keys in sorted order, as JAX
    flattens one), list, tuple or dataclass, depth first."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        yield tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from tree_leaves(item)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tree_leaves(getattr(tree, f.name))


def tree_batch_size(tree) -> int:
    """Leading-axis size of a batched tree: that of its first array leaf, 0
    without one (JAX ``core/struct.py:33``)."""
    leaf = next(tree_leaves(tree), None)
    return leaf.shape[0] if leaf is not None else 0
