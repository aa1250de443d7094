"""Batched rollouts, the seeded evaluators and random-policy episode returns
(port of ``or_gym_inventory_tpu/vector``).

The names the JAX package's ``vector/__init__.py`` exports are exported here
too (``from or_gym_inventory_torch.vector import evaluate_episodes_seeded``),
each module imported at the first use of one of its names.
"""

import importlib

_EXPORTS = {
    "batch_reset": "vecenv", "batch_step": "vecenv", "auto_reset": "vecenv",
    "rollout": "vecenv", "evaluate_episodes": "vecenv",
    "evaluate_episodes_seeded": "vecenv", "evaluate_episodes_seeded_stateful": "vecenv",
    "Trajectory": "vecenv",
    "policy_episode_returns": "fast_episodes", "random_episode_returns": "fast_episodes",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
