"""Config-dict overrides of a frozen params dataclass.

A copy of ``or_gym_inventory_tpu/core/config.py`` (plain Python), kept so
that the port reads an ``env_config`` without importing the JAX package.
The reference applies a config by ``setattr`` for every entry
(inventory_management.py:15-17); here it is a checked
``dataclasses.replace``, so an unknown key raises instead of creating an
attribute.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional


def apply_env_config(params, env_config: Optional[Mapping[str, Any]],
                     aliases: Dict[str, str] = None):
    """Return ``params`` with the entries of ``env_config`` replaced.

    ``aliases`` maps reference kwarg names to params field names. Unknown
    keys raise KeyError.
    """
    if not env_config:
        return params
    aliases = aliases or {}
    fields = {f.name for f in dataclasses.fields(params)}
    updates = {}
    for key, value in env_config.items():
        key = aliases.get(key, key)
        if key not in fields:
            raise KeyError(
                f"Unknown env_config key {key!r} for {type(params).__name__}; "
                f"valid keys: {sorted(fields)}")
        updates[key] = value
    return dataclasses.replace(params, **updates)
