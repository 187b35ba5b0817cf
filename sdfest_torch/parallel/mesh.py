"""Data-parallel helpers over a ``torch.distributed`` group (counterpart of
``sdfest_tpu/parallel/mesh.py``).

The parallelism of this model family: data-parallel training (the batch
split over a ``dp`` axis, parameters replicated) and hypothesis-parallel
estimation (independent refinement instances split with no communication
until their results are gathered).  A :class:`Mesh` is a small dataclass of
``(group, rank, world, device)``, one ``dp`` axis over the ranks of a
process group; ``torch.distributed.device_mesh`` is not used, since one axis
needs nothing beyond the group.

The JAX package's reductions are placed by hand (``psum``/``pmean`` inside
``shard_map``), and so are the port's: the trainers' ``step(..., group=)``
reduce their gradients, metrics and BatchNorm statistics with
``all_reduce`` as the JAX steps do.  DDP is not used: it averages gradients
(the VAE's losses are batch sums, so JAX sums them) and broadcasts rank 0's
buffers (JAX averages the BatchNorm statistics).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as tdist

from sdfest_torch.parallel import distributed as dist
from sdfest_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D ``dp`` mesh: this process's ``rank`` of ``world`` in ``group``
    (None: a single process without a group), and the device its tensors
    live on."""

    group: Optional[Any]
    rank: int
    world: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        """Whether collectives run (the mesh has a group)."""
        return self.group is not None


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The 1-D mesh over the ranks of the default group (one process,
    rank 0 of 1, without a group).

    ``n_devices``, where given, must equal the group's size: a mesh over a
    subset of the ranks is not supported.  ``device`` defaults to the
    group's (this process's card under NCCL, the CPU under gloo); without a
    group to ``"cuda"``.
    """
    world, rank = dist.process_count(), dist.process_index()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a group of "
                         f"{world} processes is not supported")
    if device is None:
        device = (dist.group_device() if tdist.is_initialized()
                  else resolve_device("cuda"))
    group = tdist.group.WORLD if tdist.is_initialized() else None
    return Mesh(group, rank, world, resolve_device(device))


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def local_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of the leading axis of ``x`` (as
    ``P("dp")`` splits it); the axis must divide by the mesh's size."""
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"leading axis {n} does not divide over "
                         f"{mesh.world} ranks")
    size = n // mesh.world
    return x[mesh.rank * size:(mesh.rank + 1) * size]


# A sharding is how a tensor is placed on the mesh, the counterpart of a
# NamedSharding given to ``jax.device_put``: a function from a tensor (the
# global value on every rank) to this rank's part of it on the mesh's
# device.


def batch_sharding(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """Split the leading (batch) axis over the mesh: this rank's contiguous
    block."""
    return lambda x: local_block(x, mesh).to(mesh.device)


def replicated_sharding(mesh: Mesh) -> Callable[[torch.Tensor],
                                                torch.Tensor]:
    """Replicate: rank 0's value on every rank, broadcast (a copy at world
    size 1 without a group)."""

    def place(x):
        x = x.detach().to(mesh.device).clone()
        if mesh.distributed:
            tdist.broadcast(x, src=0, group=mesh.group)
        return x

    return place


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's block of every tensor of a (nested dict/list/tuple)
    batch, on the mesh's device."""
    return _tree_map(batch_sharding(mesh), batch)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` on the mesh's device, equal on every rank:
    rank 0's values."""
    return _tree_map(replicated_sharding(mesh), tree)


def replicate_module(module: torch.nn.Module, mesh: Mesh) -> None:
    """Broadcast a module's parameters and buffers from rank 0 in place (a
    no-op without a group)."""
    if not mesh.distributed:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            tdist.broadcast(t.data, src=0, group=mesh.group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average tensors over the ranks in place (``all_reduce(SUM) /
    world``: JAX's ``pmean``), in one collective."""
    _all_reduce_(tensors, group, mean=True)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum tensors over the ranks in place (JAX's ``psum``), in one
    collective."""
    _all_reduce_(tensors, group, mean=False)


def _all_reduce_(tensors, group, mean: bool) -> None:
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=group)
    if mean:
        flat /= tdist.get_world_size(group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.detach().copy_(flat[offset:offset + n].view_as(t))
        offset += n


def fold_in(generator: Optional[torch.Generator], group,
            device) -> torch.Generator:
    """A generator on ``device`` for this rank's draws (JAX's ``fold_in(key,
    axis_index)``): one 63-bit draw from ``generator`` (the default
    generator when None), equal on every rank that holds the same state,
    mixed with the rank.  ``generator`` advances by that one draw."""
    src = generator.device if generator is not None else "cpu"
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=src))
    rank = tdist.get_rank(group)
    seed = (base * 0x9E3779B97F4A7C15 + rank) % 2 ** 63
    return torch.Generator(device=device).manual_seed(seed)


def shard_map_data_parallel_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """Wrap a group-aware step for per-rank local-batch execution.

    The first positional argument (the batch) and the tensors of the
    keyword arguments ``eps``, ``quats`` and ``pc_depth``, which follow the
    batch, are cut to this rank's contiguous block; ``step_fn`` is then
    called with ``group=`` the mesh's group and must reduce its gradients
    and metrics over it (``VAETrainer.step`` sums, ``InitTrainer.step``
    averages, as the JAX steps ``psum``/``pmean``), so the optimizer
    update computes identically on every rank.  Unlike the JAX wrapper the
    step is not compiled and nothing is donated: the trainers update their
    modules in place.
    """

    @functools.wraps(step_fn)
    def wrapped(batch, *args, **kwargs):
        for key in ("eps", "quats", "pc_depth"):
            if kwargs.get(key) is not None:
                kwargs[key] = shard_batch(kwargs[key], mesh)
        return step_fn(shard_batch(batch, mesh), *args, group=mesh.group,
                       **kwargs)

    return wrapped


# The JAX package's data_parallel_step is a GSPMD jit over the global batch
# with compiler-inserted reductions.  PyTorch has no such compiler, so the
# port's is the shard_map form: each rank steps on its block and the step
# reduces over the group, which gives the global batch's update, as there.
data_parallel_step = shard_map_data_parallel_step
