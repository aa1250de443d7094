"""Data parallelism over ranks with ``torch.distributed`` (port of
``or_gym_inventory_tpu/parallel/mesh.py``, A14 of the port's roadmap).

JAX's mesh is one program over many devices (``shard_map``, ``psum``,
``pmean``). ``torch.distributed`` runs one process a device instead: every
rank runs the same code on its own shard of the env batch, and the few
collectives are calls on a process group. ``Mesh`` holds the group, this
rank's device and the collectives the learners need:

- ``sum`` / ``mean`` of a list of float32 tensors in one flattened
  ``all_reduce`` (JAX's ``psum`` / ``pmean``; a mean is the sum over the
  world size, as ``pmean`` is);
- ``gather`` of equal blocks, rank-major, along one axis (the concatenation
  ``out_specs=P(axis)`` gave);
- ``rank_generator``: the rank's own stream. JAX folded the axis index into
  a replicated key; here one 31-bit seed is drawn from the replicated
  generator and the rank's seed is ``ops.rng.rank_seed(seed, rank)``
  (Philox under the key (seed, 3) at the counter (rank, 0, 0, 0)).

Backends: NCCL for CUDA tensors with one card a rank (``initialize_multihost``
asks for ``cpu:gloo,cuda:nccl`` on a CUDA host, so that object collectives
and the checkpointer's asynchronous saves have a CPU backend), gloo on the
CPU. Gloo also serves several ranks on one card, which NCCL refuses: its
collectives then run on host copies of the CUDA tensors. With a process
group the collectives run at any world size (at world 1 they return their
input's bits); in a process with no process group ``make_mesh`` is the
one-rank mesh of that process's device, whose collectives return their
input.

The sharded entry points take the GLOBAL ``num_envs`` (``num_envs %
world`` is asserted, as in JAX) and return what JAX's returned: the
gathered per-env outputs in rank-major order and the reduced scalar. The
fused kernels mask the batch tail, so JAX's block fix-up and its
``use_pallas`` switch have no counterpart.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from or_gym_inventory_torch.core.device import resolve_device
from or_gym_inventory_torch.envs.base import Environment
from or_gym_inventory_torch.ops import rng
from or_gym_inventory_torch.vector import fast_episodes, vecenv


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None,
                         timeout: Optional[float] = None) -> None:
    """Join the default process group. ``coordinator_address`` is
    ``host:port`` (a TCP rendezvous, rank ``process_id`` of
    ``num_processes``) or any ``init_method`` URL (``file://...``); without
    one, torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``) is read. ``backend`` defaults to
    ``cpu:gloo,cuda:nccl`` where CUDA is available, else ``gloo``; pass
    ``"gloo"`` for several ranks on one card. On a CUDA host each rank takes
    the card ``LOCAL_RANK`` (else its rank) modulo the card count.
    ``timeout`` (seconds) bounds every collective."""
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {"backend": backend}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if coordinator_address is not None:
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        kwargs.update(init_method=url, world_size=num_processes, rank=process_id)
    dist.init_process_group(**kwargs)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world(group=None):
    """(world size, rank) of ``group``; (1, 0) without a process group."""
    if _initialized():
        return dist.get_world_size(group), dist.get_rank(group)
    return 1, 0


class Mesh:
    """A 1-D mesh of the ranks of ``group`` (the default group when None;
    the one-rank mesh when no process group exists), each holding one
    ``device``."""

    def __init__(self, device, axis_name: str = "env", group=None):
        self.device = torch.device(device)
        self.axis_name = axis_name
        self.group = group
        self.size, self.rank = _world(group)
        self.distributed = _initialized()
        self.backend = str(dist.get_backend(group)) if self.distributed else None

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_name!r}: rank {self.rank} of {self.size}, "
                f"{self.device}, backend {self.backend})")

    def _on_host(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s collective runs on a host copy: a CUDA tensor on a
        group without NCCL (gloo ranks sharing a card)."""
        return t.is_cuda and "nccl" not in (self.backend or "")

    def sum(self, tensors: Sequence[torch.Tensor]) -> list:
        """The element-wise sum over the ranks of each float32 tensor, in
        one ``all_reduce`` of their concatenation; every rank receives the
        same bits."""
        tensors = list(tensors)
        if not self.distributed:
            return tensors
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        buf = flat.cpu() if self._on_host(flat) else flat
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        flat = buf.to(flat.device)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def mean(self, tensors: Sequence[torch.Tensor]) -> list:
        """``sum`` over the world size (JAX's ``pmean``)."""
        if not self.distributed:
            return list(tensors)
        return [t / self.size for t in self.sum(tensors)]

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        rank order, on every rank."""
        if not self.distributed:
            return t
        buf = t.detach()
        if buf.dtype == torch.bool:
            buf = buf.to(torch.uint8)
        if self._on_host(buf):
            buf = buf.cpu()
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.group)

    def rank_seed(self, generator: torch.Generator) -> int:
        """This rank's 31-bit seed off one draw of the replicated
        ``generator`` (``ops.rng.rank_seed``)."""
        return rng.rank_seed(fast_episodes.kernel_seed(generator), self.rank)

    def rank_generator(self, generator: torch.Generator) -> torch.Generator:
        """This rank's own generator, on ``generator``'s device, seeded
        with ``rank_seed(generator)``: the replicated generator advances by
        the same one draw on every rank and stays in lockstep."""
        return torch.Generator(device=generator.device).manual_seed(self.rank_seed(generator))


def make_mesh(devices=None, axis_name: str = "env") -> Mesh:
    """The mesh of the default process group. ``devices`` is this rank's
    device, or a sequence of one device a rank; None takes the current card
    (``resolve_device``)."""
    if devices is None or isinstance(devices, (str, torch.device)):
        device = devices
    else:
        devices = list(devices)
        size, rank = _world()
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for a world of {size} ranks")
        device = devices[rank]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dev, axis_name)


def _local_envs(num_envs: int, mesh: Mesh) -> int:
    assert num_envs % mesh.size == 0, (num_envs, mesh.size)
    return num_envs // mesh.size


def _shard(x, mesh: Mesh):
    if isinstance(x, torch.Tensor):
        n = _local_envs(x.shape[0], mesh)
        return x[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)
    if isinstance(x, dict):
        return {k: _shard(v, mesh) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_shard(v, mesh) for v in x)
    return x


def shard_batch(x, mesh: Mesh, axis_name: str = "env"):
    """This rank's block of the leading axis of every tensor in ``x`` (a
    tensor or a nested dict, list or tuple of them), on the mesh's device."""
    return _shard(x, mesh)


def _gather_traj(traj: vecenv.Trajectory, mesh: Mesh) -> vecenv.Trajectory:
    """A time-major trajectory's env axis (axis 1) gathered rank-major."""
    def g(x):
        return mesh.gather(x, dim=1) if isinstance(x, torch.Tensor) and x.dim() >= 2 else x
    return vecenv.Trajectory(obs=g(traj.obs), action=g(traj.action), reward=g(traj.reward),
                             done=g(traj.done), next_obs=g(traj.next_obs),
                             info={k: g(v) for k, v in traj.info.items()})


def sharded_rollout(env: Environment, params, policy_fn: Callable, policy_state,
                    generator: torch.Generator, num_envs: int, num_steps: int,
                    mesh: Optional[Mesh] = None, axis_name: str = "env"):
    """``vecenv.rollout`` over the mesh: ``num_envs`` is the GLOBAL batch;
    each rank runs ``num_envs / world`` envs on its rank generator. Returns
    (the time-major trajectory, its env axis gathered rank-major, and the
    summed reward over every rank), as JAX's ``psum`` gave."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    local = _local_envs(num_envs, mesh)
    _, traj = vecenv.rollout(env, params, policy_fn, policy_state,
                             mesh.rank_generator(generator), local, num_steps,
                             device=mesh.device)
    total, = mesh.sum([torch.sum(traj.reward)])
    return _gather_traj(traj, mesh), total


def sharded_evaluate(env: Environment, params, policy_fn: Callable, policy_state,
                     generator: torch.Generator, num_envs: int,
                     mesh: Optional[Mesh] = None, axis_name: str = "env"):
    """One fixed-horizon episode an env over the mesh: (the (num_envs,)
    totals gathered rank-major, the global mean reward)."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    local = _local_envs(num_envs, mesh)
    totals, _ = vecenv.evaluate_episodes(env, params, policy_fn, policy_state,
                                         mesh.rank_generator(generator), local,
                                         device=mesh.device)
    mean, = mesh.mean([torch.mean(totals)])
    return mesh.gather(totals), mean


def sharded_random_episode_returns(params, generator: torch.Generator, num_envs: int,
                                   mesh: Optional[Mesh] = None, axis_name: str = "env",
                                   episodes_per_lane: int = 1):
    """``vector.random_episode_returns`` over the mesh, the multi-card form
    of the fused-episode workload: ``num_envs`` GLOBAL lanes, each rank's
    ``num_envs / world`` through its family's fused kernel (K2, K8 or K16)
    on its rank seed. The ranks never communicate but for the gather and
    the mean. Returns (the (episodes_per_lane * num_envs,) returns, rank
    blocks in order, each episode-major; the global mean return)."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    local = _local_envs(num_envs, mesh)
    rets = fast_episodes.random_returns_on_seed(params, mesh.rank_seed(generator), local,
                                                episodes_per_lane, mesh.device)
    mean, = mesh.mean([torch.mean(rets)])
    return mesh.gather(rets), mean


def sharded_policy_episode_returns(params, actor, generator: torch.Generator,
                                   num_envs: int, mesh: Optional[Mesh] = None,
                                   axis_name: str = "env", episodes_per_lane: int = 1):
    """``vector.policy_episode_returns`` (deterministic) over the mesh: the
    folded ``actor`` replicated, each rank's ``num_envs / world`` lanes
    through its family's policy kernel (K5, K11 or K19) on its rank seed.
    Returns what ``sharded_random_episode_returns`` returns."""
    mesh = mesh or make_mesh(axis_name=axis_name)
    local = _local_envs(num_envs, mesh)
    rets = fast_episodes.policy_returns_on_seed(params, actor, mesh.rank_seed(generator),
                                                local, episodes_per_lane, device=mesh.device)
    mean, = mesh.mean([torch.mean(rets)])
    return mesh.gather(rets), mean
