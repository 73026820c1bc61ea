"""Meshes of processes (port of ``cvd_tpu/parallel/mesh.py``).

cvd_tpu shards one single-controller program over a ``jax.sharding.Mesh``
and lets XLA insert the collectives. PyTorch has no such compiler, so the
port runs SPMD over the processes that ``torchrun`` starts, one per card
(NCCL on ``cuda:LOCAL_RANK``) or on the CPU (gloo). A ``Mesh`` here is this
process's view of the grid: the axis names and sizes, this rank's
coordinates, and one process group per axis (the ranks that share every
other coordinate). Rank ``d`` of an ("rows", "frames") mesh of shape
(R, Cf) sits at (d // Cf, d % Cf), as in ``np.reshape`` of the device list.

Tensors are held in BLOCKS: ``constrain(x, mesh, "rows", "frames")`` is this
rank's block of a global tensor (its leading dims split over the named
axes, the others whole), the counterpart of ``with_sharding_constraint``;
``gather`` is the all-gather back to the global tensor, which GSPMD does
silently where a sharded value meets a replicated one.

``init_distributed`` sets up (or reuses) the process group of a
``torchrun`` launch, for training's ``--multihost`` and sampling's
``--sharded`` alike; ``process_group`` also destroys it afterwards if it
made it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(requested: Optional[str], flag: str = "--multihost",
                     entry: str = "cvd_tpu_torch.cli.train") -> Tuple[int, int, torch.device]:
    """The process group of a ``torchrun`` launch (its ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``; ``MASTER_ADDR`` / ``MASTER_PORT``
    through ``env://``): NCCL on ``cuda:LOCAL_RANK``, or gloo where the
    caller asks for the CPU. A process that already holds the same group
    (backend, rank and world size) reuses it; any other group raises.
    -> (rank, world size, device). ``flag`` and ``entry`` name the option and
    the module in the error without torchrun's environment."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"{flag} needs the environment torchrun sets: {missing} not set "
                           f"(torchrun --nproc_per_node N -m {entry} ... {flag})")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if requested and torch.device(requested).type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        device, backend = torch.device("cuda", int(os.environ["LOCAL_RANK"])), "nccl"
        torch.cuda.set_device(device)
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_rank(), dist.get_world_size())
        if have != (backend, rank, world):
            raise RuntimeError(f"{flag}: this process already holds a {have[0]} process group "
                               f"as rank {have[1]} of {have[2]}, not the {backend} group of "
                               f"rank {rank} of {world} that torchrun's environment names")
        return rank, world, device
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return rank, world, device


@contextlib.contextmanager
def process_group(requested: Optional[str], flag: str,
                  entry: str) -> Iterator[Tuple[int, int, torch.device]]:
    """``init_distributed`` for the duration of a ``with`` block; the group
    is destroyed at its end if this block created it."""
    had = dist.is_initialized()
    out = init_distributed(requested, flag, entry)
    try:
        yield out
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a grid of ``world`` ranks: ``shape`` maps
    each axis name to its size (in order), ``coords`` to this rank's index
    on it, ``device`` is this rank's; ``groups`` maps each axis, and the
    tuple of all axes, to its process group (None: the default group).
    Collectives over an axis of size 1 are skipped, so a world of one runs
    no collective at all."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int
    device: torch.device
    groups: Dict[object, object] = dataclasses.field(repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, *axes: str):
        """The process group of ``axes`` (one axis, or all of them)."""
        return self.groups[axes[0] if len(axes) == 1 else tuple(axes)]

    def group_size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)


def _axis_groups(shape: Sequence[int], axis: int):
    """Every group of ranks along ``axis`` (the other coordinates fixed),
    each in its order along the axis; the same list on every rank."""
    grid = np.arange(math.prod(shape)).reshape(tuple(shape))
    ranks = np.moveaxis(grid, axis, -1).reshape(-1, shape[axis])
    return [[int(r) for r in row] for row in ranks]


def create_mesh(axis_shapes: Optional[Tuple[int, ...]] = None,
                axis_names: Tuple[str, ...] = ("data",)) -> Mesh:
    """A mesh over the initialized world (default: every rank on one
    ``data`` axis). Every rank makes every group, in the same order, as
    ``torch.distributed.new_group`` requires, and keeps those it is in."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialized process group "
                           "(init_distributed under torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if axis_shapes is None:
        axis_shapes = (world,)
    axis_shapes = tuple(int(s) for s in axis_shapes)
    if math.prod(axis_shapes) != world or len(axis_shapes) != len(axis_names):
        raise ValueError(f"mesh {dict(zip(axis_names, axis_shapes))} does not cover the "
                         f"world of {world} ranks")
    coords = [int(c) for c in np.unravel_index(rank, axis_shapes)]
    groups: Dict[object, object] = {tuple(axis_names): None}
    for axis, name in enumerate(axis_names):
        if len(axis_names) == 1:
            groups[name] = None
            continue
        for ranks in _axis_groups(axis_shapes, axis):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(tuple(axis_names), dict(zip(axis_names, axis_shapes)),
                dict(zip(axis_names, coords)), rank, device, groups)


def inference_shape(n_devices: int, rows: int = 4) -> Tuple[int, int]:
    """(rows, frames) of the sampling mesh over ``n_devices``: cvd_tpu's rule
    (mesh.py:64-81), rows = gcd(rows, n) and frames = n // rows."""
    rows = math.gcd(rows, n_devices)
    return rows, n_devices // rows


def inference_mesh(n_devices: Optional[int] = None, rows: int = 4) -> Mesh:
    """("rows", "frames") mesh for sharded sampling over the world: the
    UNet's batch rows (views x CFG) shard over "rows", the frame axis over
    "frames" (``inference_shape``)."""
    n = n_devices or dist.get_world_size()
    return create_mesh(inference_shape(n, rows), ("rows", "frames"))


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0 of the
    mesh, in place: the ranks' weights are then equal by construction, as
    ``jax.device_put(tree, NamedSharding(mesh, P()))`` makes them."""
    if mesh.size > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0, group=mesh.group(*mesh.axis_names))
    return module


def shard_params(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Parameters replicated (pure data parallelism), as in cvd_tpu."""
    return replicate(module, mesh)


def constrain(x: torch.Tensor, mesh: Optional[Mesh], *axis_names: Optional[str]) -> torch.Tensor:
    """This rank's block of the global tensor ``x``: leading dim i split
    over the mesh axis ``axis_names[i]`` (None: whole), the rest whole; a
    view. ``x`` unchanged without a mesh. Each split dim must divide."""
    if mesh is None:
        return x
    for dim, name in enumerate(axis_names):
        if name is None:
            continue
        n = mesh.shape[name]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over the "
                             f"{n} ranks of mesh axis {name!r} ({mesh.shape})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[name] * size, size)
    return x


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's block of every tensor of ``batch`` (a tensor, or a dict /
    list / tuple of them), the leading dim split over ``axis``."""
    if isinstance(batch, torch.Tensor):
        return constrain(batch, mesh, axis)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis) for v in batch)
    return batch


def all_gather(x: torch.Tensor, mesh: Mesh, *axes: str, dim: int = 0) -> torch.Tensor:
    """The blocks of the group of ``axes`` concatenated along ``dim`` in
    group-rank order (row-major over ``axes``); ``x`` itself where the group
    has one rank. ``all_gather_into_tensor`` stacks along dim 0, so another
    dim goes through a [group, ...] buffer and a permute."""
    n = mesh.group_size(*axes)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + x.shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.group(*axes))
    if dim == 0:
        return out
    out = out.reshape((n,) + x.shape).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= n
    return out.reshape(shape)


def gather(x_local: torch.Tensor, mesh: Optional[Mesh], *axis_names: Optional[str]) -> torch.Tensor:
    """The global tensor of which ``x_local`` is this rank's ``constrain``
    block: leading dim i all-gathered over ``axis_names[i]`` (None: whole).
    Every rank gets the same tensor."""
    if mesh is None:
        return x_local
    for dim, name in reversed(list(enumerate(axis_names))):
        if name is not None:
            x_local = all_gather(x_local, mesh, name, dim=dim)
    return x_local
