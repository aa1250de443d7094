"""Checkpoints of nested dicts of tensors and numbers (the port of
``or_gym_inventory_tpu/utils/checkpoint.py``: the JAX package's flax
``serialization`` files and its ``OrbaxCheckpointer``).

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

``OrbaxCheckpointer`` keeps numbered steps of such trees in a directory with
``torch.distributed.checkpoint`` (asynchronous saves, ``max_to_keep``), in
one process or across the ranks of a process group. DCP keeps one copy of a
tensor that several ranks save under one key, as replicated state; a
rank's own state (its envs, buffer slice, carries, rank generator) is
marked ``PerRank`` and stored under keys that name the rank, so each rank
restores its own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional

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
    dicts, lists and tuples element by element, ``PerRank`` nodes kept;
    tensors detached."""
    if isinstance(obj, PerRank):
        return PerRank(to_tree(obj.tree))
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


# ------------------------------------------------- the multi-rank checkpointer

class PerRank:
    """Marks a subtree of ``OrbaxCheckpointer.save``'s tree (or of a
    ``restore`` template) as this rank's own: saved under keys that name
    the rank, restored from this rank's keys."""

    def __init__(self, tree):
        self.tree = tree


_TREE_KEY = "__tree__"        # the saved tree's structure, as UTF-8 JSON bytes
_RANK_MARK = "__per_rank__"   # a PerRank node in that structure


def _flatten(tree, path, rank, out):
    """(the structure of ``tree`` with None leaves, PerRank nodes as
    {_RANK_MARK: structure}); its leaves put into ``out`` under '/'-joined
    keys, a PerRank subtree's under ``rank<r>:`` keys."""
    if isinstance(tree, PerRank):
        return {_RANK_MARK: _flatten(tree.tree, (f"rank{rank}:",) + path, rank, out)}
    if isinstance(tree, dict):
        return {k: _flatten(v, path + (str(k),), rank, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, path + (str(i),), rank, out) for i, v in enumerate(tree))
    out["/".join(path)] = tree
    return None


def _encode(structure):
    """``_flatten``'s structure as JSON data: containers tagged, so tuples,
    lists and int dict keys come back as they were."""
    if isinstance(structure, dict):
        return {"d": [[k, _encode(v)] for k, v in structure.items()]}
    if isinstance(structure, (list, tuple)):
        return {"t" if isinstance(structure, tuple) else "l": [_encode(v) for v in structure]}
    return None


def _decode(data):
    if data is None:
        return None
    (tag, items), = data.items()
    if tag == "d":
        return {k: _decode(v) for k, v in items}
    return (tuple if tag == "t" else list)(_decode(v) for v in items)


def _structure_tensor(structure) -> torch.Tensor:
    return torch.frombuffer(bytearray(json.dumps(_encode(structure)).encode()),
                            dtype=torch.uint8).clone()


def _unflatten(structure, path, rank, leaf):
    """The tree of ``structure`` (``_flatten``'s) with each leaf
    ``leaf(key)``, a PerRank node's from this rank's keys, unmarked."""
    if isinstance(structure, dict) and set(structure) == {_RANK_MARK}:
        return _unflatten(structure[_RANK_MARK], (f"rank{rank}:",) + path, rank, leaf)
    if isinstance(structure, dict):
        return {k: _unflatten(v, path + (str(k),), rank, leaf) for k, v in structure.items()}
    if isinstance(structure, (list, tuple)):
        return type(structure)(_unflatten(v, path + (str(i),), rank, leaf)
                               for i, v in enumerate(structure))
    return leaf("/".join(path))


class OrbaxCheckpointer:
    """Numbered checkpoints in ``directory`` (``<directory>/<step>/``)
    through ``torch.distributed.checkpoint``, the counterpart of the JAX
    package's orbax manager: ``save(step, tree)`` starts an asynchronous
    save, ``wait()`` finishes it, ``restore(step=None, template=None)``
    reads the latest step (None when there is none) and only the newest
    ``max_to_keep`` steps stay on disk.

    A tree holds dicts, lists, tuples, tensors (on any device), numbers,
    strings and None, and ``PerRank`` nodes. With a process group every rank
    constructs the checkpointer and calls each method together; the
    checkpointer runs its collectives on a gloo group of its own, so an
    asynchronous save never interleaves with the caller's collectives.
    Restored tensors land on the template's tensors' devices, or on the CPU
    without a template."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        import torch.distributed as dist
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._group = dist.new_group(backend="gloo") \
            if dist.is_available() and dist.is_initialized() else None
        self.rank = dist.get_rank() if self._group is not None else 0
        self._pending = None
        os.makedirs(self.directory, exist_ok=True)

    def _dcp_kwargs(self) -> dict:
        return {"process_group": self._group} if self._group is not None \
            else {"no_dist": True}

    def _from_rank0(self, obj):
        """Rank 0's ``obj`` on every rank of the checkpointer's group."""
        if self._group is None:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self._group)
        return box[0]

    def all_steps(self) -> list:
        """The saved steps, oldest first (a step counts once its metadata
        is written)."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, ".metadata")))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree) -> None:
        """Start saving ``tree`` as ``step`` (the previous save finished
        first); the tensors are copied to the host before this returns, so
        the caller may change them while the save runs."""
        import torch.distributed.checkpoint as dcp
        self.wait()
        leaves = {}
        structure = _structure_tensor(_flatten(tree, (), self.rank, leaves))
        flat = {k: v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else v
                for k, v in leaves.items()}
        flat[_TREE_KEY] = structure
        self._pending = dcp.async_save(flat, checkpoint_id=os.path.join(self.directory,
                                                                         str(step)),
                                       **self._dcp_kwargs())

    def wait(self) -> None:
        """Finish the pending save and drop the steps beyond
        ``max_to_keep`` (rank 0 deletes)."""
        if self._pending is None:
            return
        self._pending.result()
        self._pending = None
        if self.rank == 0 and self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        if self._group is not None:
            import torch.distributed as dist
            dist.barrier(group=self._group)

    def restore(self, step: Optional[int] = None, template=None):
        """The tree saved as ``step`` (the latest when None), None when no
        step exists. A ``template`` (a tree shaped like the saved one, its
        leaves tensors to fill) gives each tensor its template's device and
        dtype; ``PerRank`` nodes come back as this rank's subtree, unmarked."""
        import torch.distributed.checkpoint as dcp
        self.wait()
        if step is None:
            step = self._from_rank0(self.latest_step())
        if step is None:
            return None
        path = os.path.join(self.directory, str(step))
        if template is not None:
            flat = {}
            structure = _flatten(template, (), self.rank, flat)
            want = {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                    for k, v in flat.items()}
        else:
            meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata

            def empty(key):
                m = meta[key]
                return torch.empty(tuple(m.size), dtype=m.properties.dtype) \
                    if hasattr(m, "size") else None

            box = {_TREE_KEY: empty(_TREE_KEY)}
            dcp.load(box, checkpoint_id=path, **self._dcp_kwargs())
            structure = _decode(json.loads(bytes(box[_TREE_KEY].tolist()).decode()))
            keys = []
            _unflatten(structure, (), self.rank, keys.append)
            want = {k: empty(k) for k in keys}
        dcp.load(want, checkpoint_id=path, **self._dcp_kwargs())
        return _unflatten(structure, (), self.rank, want.__getitem__)
