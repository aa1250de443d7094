"""Checkpoints of nested dicts of tensors and numbers (the port's stand-in
for the JAX package's flax ``serialization`` and the single-host part of
``utils/checkpoint.py``; ``OrbaxCheckpointer``'s multi-host saves wait for
the mesh, ROADMAP.md A14).

``save_pytree`` writes a tree of dicts, lists, tuples, tensors, numbers,
strings and None with ``torch.save``; ``load_pytree`` reads it back with
``torch.load(weights_only=True)``, which unpickles nothing else.
``to_tree`` turns live training objects into such a tree (an ``nn.Module``
into its state dict, a dataclass into a dict of its fields, a
``torch.Generator`` into its state) and ``restore`` puts a tree back into
objects shaped like a template, each tensor on its template's device and
each generator given its saved state. A run resumed from ``to_tree`` of its
train state and its generator continues exactly as the run that was not
stopped, mid-episode too (the env state is part of the train state).
"""

from __future__ import annotations

import dataclasses
import os

import torch
from torch import nn


def save_pytree(path: str, tree) -> str:
    """Write ``tree`` to ``path`` (its directory made if missing)."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    torch.save(tree, path)
    return path


def load_pytree(path: str, map_location=None):
    """The tree ``save_pytree`` wrote to ``path``; tensors on
    ``map_location`` (their saved device when None)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def to_tree(obj):
    """``obj`` as a tree that ``save_pytree`` writes: modules as state
    dicts, dataclasses as dicts of their fields, generators as their state,
    dicts, lists and tuples element by element; tensors detached."""
    if isinstance(obj, nn.Module):
        return {k: v.detach().clone() for k, v in obj.state_dict().items()}
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_tree(v) for v in obj)
    return obj


def restore(template, tree):
    """An object shaped like ``template`` holding ``tree``'s values (as
    ``to_tree(template)`` would lay them out): a module's parameters and
    buffers loaded in place, a generator's state set in place, tensors moved
    to the template's device and dtype, dataclasses rebuilt field by field."""
    if isinstance(template, nn.Module):
        template.load_state_dict(tree)
        return template
    if isinstance(template, torch.Generator):
        template.set_state(tree.cpu())
        return template
    if isinstance(template, torch.Tensor):
        return tree.to(device=template.device, dtype=template.dtype)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return type(template)(**{f.name: restore(getattr(template, f.name), tree[f.name])
                                 for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: restore(template[k], v) for k, v in tree.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(restore(t, v) for t, v in zip(template, tree))
    return tree
