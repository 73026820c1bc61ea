"""Sharded attention over a ("rows", "frames") mesh (port of the inference
branches of ``cvd_tpu/parallel/shard_ops.py``).

Every rank holds a BLOCK of the UNet call: ``videos`` = B / R of the batch
rows (views x CFG) and ``frames`` = F / Cf of the frames, its (b f) token
rows b-major inside the block. Every rank runs the same kernel on its
block; the only cross-rank traffic is each attention's minimal collective:

* spatial attention: none (rows are independent);
* temporal attention: k/v all-gathered over ``frames`` (sequence
  parallelism: queries stay frame-local, every pixel sees all frames; the
  causal mask's rows are sliced to the local frames);
* epipolar cross-video attention, and spatial extended attention: k/v (or
  the tokens) all-gathered over ``rows``; a partner row shares its query's
  frame, so it lies in this rank's rows group, and the global route
  (``kv_index`` or the half swap) is remapped to positions in the gathered
  block (``gathered_rows``).

cvd_tpu's shard_map gives each device a contiguous chunk of the flattened
(b f) rows, which splits videos across the frames axis when B / R > 1 and
Cf > 1; there it gathers over both axes. The port's blocks keep every
frame of a video block on one frames coordinate, so the rows gather holds
every partner on every mesh.

The ``("data",)`` training branches are not ported: the port's
``--multihost`` gives every rank whole pairs (ROADMAP.md, "Not to port").
"""
from __future__ import annotations

from typing import Optional

import torch

from cvd_tpu_torch.ops.epi_flash import epi_flash_attention, flash_attention
from cvd_tpu_torch.ops.temporal_attn import temporal_flash_attention
from cvd_tpu_torch.parallel.mesh import Mesh, all_gather, constrain


def flat_batch_axes(mesh: Optional[Mesh]):
    """Mesh axis names a flattened (b f) batch-major token dim shards over,
    or None if this mesh layout is not one the wrappers understand."""
    if mesh is None:
        return None
    names = tuple(mesh.axis_names)
    return names if names in (("rows", "frames"), ("data",)) else None


def mesh_ok_for_kernels(mesh: Optional[Mesh], B: int, F: int) -> bool:
    """True when (videos B, frames F) split evenly on this mesh: the
    ("rows", "frames") mesh with B and F divisible, or the ("data",) mesh
    with whole videos per rank."""
    names = flat_batch_axes(mesh)
    if names is None:
        return False
    if names == ("data",):
        return B % mesh.shape["data"] == 0
    return B % mesh.shape["rows"] == 0 and F % mesh.shape["frames"] == 0


def temporal_mesh_ok(mesh: Optional[Mesh], B: int, F: int) -> bool:
    """Divisibility check for the sharded temporal attention on [B, N, F, C]."""
    return mesh_ok_for_kernels(mesh, B, F)


def check_divides(mesh: Mesh, videos: int, frames: int, what: str) -> None:
    """Raise unless ``videos`` batch rows and ``frames`` frames split evenly
    over the ("rows", "frames") mesh (cvd_tpu pads such a mesh under GSPMD;
    the port refuses it)."""
    if flat_batch_axes(mesh) != ("rows", "frames"):
        raise ValueError(f"{what}: sampling shards over a ('rows', 'frames') mesh, "
                         f"not {mesh.axis_names}")
    if not mesh_ok_for_kernels(mesh, videos, frames):
        raise ValueError(f"{what}: the mesh {mesh.shape} does not divide {videos} batch rows "
                         f"x {frames} frames (rows must divide the rows, frames the frames)")


def frame_offset(mesh: Optional[Mesh], frames: int) -> int:
    """The global index of this rank's first frame, its block ``frames``
    long."""
    return 0 if mesh is None else mesh.coords["frames"] * frames


def global_rows(mesh: Mesh, videos: int, frames: int, device) -> torch.Tensor:
    """The global (b f) row of each of this rank's block rows (``videos`` x
    ``frames`` of them, b-major), int64."""
    F = frames * mesh.shape["frames"]
    b = mesh.coords["rows"] * videos + torch.arange(videos, device=device)
    f = frame_offset(mesh, frames) + torch.arange(frames, device=device)
    return (b[:, None] * F + f[None, :]).reshape(-1)


def gathered_rows(index: torch.Tensor, mesh: Mesh, videos: int, frames: int) -> torch.Tensor:
    """Global (b f) rows -> their positions in this rank's rows-gathered
    block (the blocks of rows-coordinates 0..R-1 of this frames coordinate,
    concatenated). Each row must lie on this rank's frames: a partner shares
    its query's frame."""
    index = index.long()
    F = frames * mesh.shape["frames"]
    b, f = index // F, index % F - frame_offset(mesh, frames)
    return (b // videos) * (videos * frames) + (b % videos) * frames + f


def local_route(route: torch.Tensor, mesh: Mesh, videos: int, frames: int) -> torch.Tensor:
    """The global route [B * F] (query row -> partner row) for this rank's
    block rows, as positions in the rows-gathered block, int32."""
    rows = global_rows(mesh, videos, frames, route.device)
    return gathered_rows(route.long()[rows], mesh, videos, frames).to(torch.int32)


def sharded_spatial_flash(q, k, v, heads: int, mesh: Mesh):
    """Self-attention on this rank's [(b f), N, C] tokens: rows are
    independent, no collective (K2 on the local rows, whatever the mesh)."""
    return flash_attention(q, k, v, heads=heads)


def sharded_temporal_flash(q, k, v, mask, heads: int, mesh: Mesh, frame_offset: int,
                           attention=temporal_flash_attention):
    """Per-pixel temporal attention on this rank's [B, N, F_loc, C]: k/v
    all-gathered over ``frames`` along the frame axis, q frame-local, the
    global [F, F] ``mask``'s rows sliced to [frame_offset, + F_loc); then
    ``attention`` (K3, or its plain version) with F_loc query frames and F
    key frames."""
    F_loc = q.shape[2]
    kg = all_gather(k, mesh, "frames", dim=2)
    vg = all_gather(v, mesh, "frames", dim=2)
    mask_l = None if mask is None else mask[frame_offset:frame_offset + F_loc]
    return attention(q, kg, vg, mask_l, heads)


def sharded_epi_flash(q, k, v, norm_lines, coords, band, alpha, heads: int,
                      kv_index: torch.Tensor, video_length: int, mesh: Mesh):
    """Cross-video epipolar attention on this rank's [(b f), N, C] block
    rows (q/k/v, lines, band and alpha local): k/v all-gathered over
    ``rows`` (Bk = R x the local rows), the GLOBAL ``kv_index`` [B * F]
    remapped to positions in the gathered block, then K1."""
    frames = video_length // mesh.shape["frames"]
    videos = q.shape[0] // frames
    kg = all_gather(k, mesh, "rows")
    vg = all_gather(v, mesh, "rows")
    return epi_flash_attention(q, kg, vg, norm_lines, coords, band, alpha, heads=heads,
                               kv_index=local_route(kv_index, mesh, videos, frames))


def sharded_partner_tokens(hidden: torch.Tensor, kv_index: torch.Tensor, video_length: int,
                           mesh: Mesh) -> torch.Tensor:
    """The plain path's twin of ``models.epi.gather_partner_tokens`` on a
    mesh: this rank's block rows [(b f), N, C] all-gathered over ``rows``,
    then the partner of each local row by the GLOBAL route ``kv_index``."""
    frames = video_length // mesh.shape["frames"]
    videos = hidden.shape[0] // frames
    gathered = all_gather(hidden, mesh, "rows")
    return gathered[local_route(kv_index, mesh, videos, frames).long()]


def extended_context(h: torch.Tensor, mesh: Optional[Mesh], frames: int) -> torch.Tensor:
    """Spatial extended attention's keys (attention_processor.py:69-83):
    the tokens of both videos of each half-swap pair, first video first,
    [(b f), 2L, C]. On a mesh the partner rows come from the rows-gathered
    block."""
    B = h.shape[0]
    if mesh is None:
        half = B // 2
        pair = torch.cat([h[:half], h[half:]], dim=1)
        return torch.cat([pair, pair], dim=0)
    videos = B // frames
    rows = global_rows(mesh, videos, frames, h.device)
    n = B * mesh.size
    partner_rows = (rows + n // 2) % n
    partner = all_gather(h, mesh, "rows")[gathered_rows(partner_rows, mesh, videos, frames)]
    first = (rows < n // 2)[:, None, None]
    return torch.cat([torch.where(first, h, partner), torch.where(first, partner, h)], dim=1)


def local_rows(x: torch.Tensor, mesh: Optional[Mesh], video_length: int) -> torch.Tensor:
    """This rank's block rows of a global (b f)-flattened tensor [B * F, ...]."""
    if mesh is None:
        return x
    blocks = constrain(x.reshape((-1, video_length) + x.shape[1:]), mesh, "rows", "frames")
    return blocks.reshape((-1,) + x.shape[1:])
