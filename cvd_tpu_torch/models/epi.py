"""Epi (cross-video synchronization) module (port of
``cvd_tpu/models/epi.py``): per-frame spatial attention whose queries come
from one video and keys/values from its partner video, with the additive
soft epipolar bias of the fundamental matrix between the paired cameras.

On grids of 16x16 and up (the JAX package's kernel sites) q/k/v are
projected from the SOURCE rows and the partner's k/v are routed inside
kernel K1 through ``kv_index``, with the bias evaluated per tile from the
factored line geometry; on smaller grids the partner rows are gathered and
the bias materialized (plain attention).

Routing: without ``kv_index`` the partner of row b is row (b + B/2) mod B
(the 2-view half swap); the N-view sampler passes ``kv_index`` (a fresh
pairing of views at every UNet call), and a ``kv_index`` of m * B rows
gives every query row m partners whose tokens are concatenated
(multi-group; the plain path, as in the JAX package). Lines come from
fundamental matrices, from homographies (``H_mats``, the pose-free data
path) or, with neither, are pseudo lines through each pixel.
``fix_firstframe`` replaces the first frame's output by its values
averaged over the views.

The epi modules are what training updates: their weights may be f32
masters under bf16 activations, so every projection casts its weights at
use (``layers.linear``, and inside ``layer_norm_matmul``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from cvd_tpu_torch.geometry.epipolar_mask import (
    epipolar_attn_bias_from_lines, epipolar_lines, homography_lines, lines_and_band,
    pixel_grid_coords, pseudo_lines,
)
from cvd_tpu_torch.models.layers import (
    FeedForward, FusedGroupNorm, group_norm_per_frame, linear, merge_heads, pab_run,
    split_heads,
)
from cvd_tpu_torch.ops.attention import attention_with_bias
from cvd_tpu_torch.ops.epi_flash import epi_flash_attention
from cvd_tpu_torch.ops.ln_matmul import layer_norm_matmul
from cvd_tpu_torch.parallel.mesh import Mesh
from cvd_tpu_torch.parallel.shard_ops import (
    frame_offset, local_rows, sharded_epi_flash, sharded_partner_tokens,
)

# epi attentions on grids at least this wide take the fused kernel
EPI_KERNEL_MIN_FEAT = 16


@dataclasses.dataclass
class EpiConditioning:
    """Per-UNet-call epipolar conditioning carried to every epi attention.
    Batch-major over (video * cfg, frame), like the hidden states there."""

    F_mats: Optional[torch.Tensor] = None    # [m*B, 3, 3] or [B, 3, 3] f32
    H_mats: Optional[torch.Tensor] = None    # [B, 3, 3] f32
    kv_index: Optional[torch.Tensor] = None  # [m*B] int partner rows
    F_mat_size: int = 256
    video_length: int = 16
    rand_slope_ff: bool = True
    mono_direction: bool = False
    fix_firstframe: bool = False
    cfg_factor: int = 2
    # draws the pseudo-line slopes of every epi attention
    generator: Optional[torch.Generator] = None
    # or the slope(s), [1] or one per row, for every epi attention of the call,
    # drawn beforehand (training: a remat replay must see the lines the loss saw)
    slope: Optional[torch.Tensor] = None
    # a ("rows", "frames") mesh (``parallel/mesh.py``): the hidden states, the
    # F / H mats and the slopes are this rank's block rows; ``kv_index`` and
    # ``video_length`` stay global
    mesh: Optional[Mesh] = None
    _route: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)

    def route(self, batch: int, device) -> torch.Tensor:
        """The partner row of every query row, int32 [batch] on ``device``:
        ``kv_index`` or the half swap. Built at the first epi attention of a
        UNet call and kept for the others."""
        r = self._route
        if r is None or r.shape[0] != batch or r.device != torch.device(device):
            if self.kv_index is not None:
                r = self.kv_index.to(device=device, dtype=torch.int32)
            else:
                r = (torch.arange(batch, device=device, dtype=torch.int32)
                     + batch // 2) % batch
            self._route = r
        return r


def _uniform_slope(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Random slope in [0, pi) from the explicit generator (the reference
    draws torch.rand per call, epi_module.py:316)."""
    if generator is None:
        raise ValueError("pseudo-epipolar lines need a random slope: set "
                         "EpiConditioning.generator (or rand_slope_ff=False)")
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * math.pi).to(device)


def _slope(cond: EpiConditioning, shape, device) -> torch.Tensor:
    if cond.slope is not None:
        return cond.slope.to(device).expand(shape)
    return _uniform_slope(cond.generator, shape, device)


def _row_slopes(cond: EpiConditioning, rows: int, device) -> torch.Tensor:
    """One slope per row of this rank's ``rows``: on a mesh drawn at the
    global shape and sliced, so that every rank makes the same draws."""
    if cond.mesh is None:
        return _slope(cond, (rows,), device)
    every = _slope(cond, (rows * cond.mesh.size,), device)
    return local_rows(every, cond.mesh, cond.video_length)


def _epi_lines(cond: EpiConditioning, batch: int, feat_size: int, device) -> torch.Tensor:
    """Per-query epipolar (or pseudo) line coefficients [B or m*B, Q, 3], by
    the three paths of the reference's ``EpiEncoding.get_attn_map``
    (epi_module.py:301-320): homographies with a slope per row; fundamental
    matrices, every ``video_length``-th row replaced by first-frame pseudo
    lines with one shared slope (or horizontal lines without
    rand_slope_ff); neither: pseudo lines with a slope per row."""
    coords = pixel_grid_coords(feat_size, cond.F_mat_size, device)
    if cond.H_mats is not None:
        H_mats = cond.H_mats.to(device=device, dtype=torch.float32)
        return homography_lines(H_mats, coords, cond.F_mat_size,
                                _row_slopes(cond, H_mats.shape[0], device))
    if cond.F_mats is not None:
        F_mats = cond.F_mats.to(device=device, dtype=torch.float32)
        B = F_mats.shape[0]
        lines = epipolar_lines(F_mats, coords)
        slope = _slope(cond, (1,), device) if cond.rand_slope_ff else None
        ff_lines = pseudo_lines(coords[None], slope=slope)
        # the first frame's rows, by global frame index on a frames shard
        frames = cond.video_length // (1 if cond.mesh is None else cond.mesh.shape["frames"])
        frame = frame_offset(cond.mesh, frames) + torch.arange(B, device=device) % frames
        return torch.where((frame == 0)[:, None, None], ff_lines, lines)
    return pseudo_lines(coords[None].expand(batch, *coords.shape),
                        slope=_row_slopes(cond, batch, device))


def gather_partner_tokens(hidden: torch.Tensor,
                          kv_index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Key/value source rows: the 2-view half swap without ``kv_index``
    (attention_processor.py:575-576), else the rows it names; m * B of them
    are m groups whose tokens are concatenated: [B, m * N, C] (:577-583)."""
    B, N, C = hidden.shape
    if kv_index is None:
        half = B // 2
        return torch.cat([hidden[half:], hidden[:half]], dim=0)
    enc = hidden[kv_index.to(hidden.device).long()]
    if kv_index.shape[0] != B:
        m = kv_index.shape[0] // B
        enc = enc.reshape(m, B, N, C).permute(1, 2, 0, 3).reshape(B, N * m, C)
    return enc


def regroup_bias(bias: torch.Tensor, batch: int) -> torch.Tensor:
    """[m*B, N, N] bias -> [B, N, m*N], aligned with multi-group kv tokens
    (epi_module.py:398-402)."""
    mB, N, _ = bias.shape
    if mB == batch:
        return bias
    m = mB // batch
    return bias.reshape(m, batch, N, N).permute(1, 2, 3, 0).reshape(batch, N, N * m)


def _fix_first_frame(out: torch.Tensor, v_self: torch.Tensor,
                     cond: EpiConditioning) -> torch.Tensor:
    """The first frame's output becomes its own V averaged over the views,
    per CFG row (attention_processor.py:629-635). On a mesh the views of
    the rows group are summed over it (in f32; every rank calls the sum,
    those without the first frame add zeros) and only the rank that holds
    frame 0 replaces its rows."""
    B, N, C = out.shape
    mesh, t = cond.mesh, cond.cfg_factor
    if mesh is None or mesh.shape["rows"] == 1:
        f = cond.video_length // (1 if mesh is None else mesh.shape["frames"])
        if frame_offset(mesh, f):
            return out
        views = B // (t * f)
        ff = v_self.reshape(views, t, f, N, C)[:, :, :1].mean(0, keepdim=True)
        return torch.cat([ff.expand(views, t, 1, N, C),
                          out.reshape(views, t, f, N, C)[:, :, 1:]], dim=2).reshape(B, N, C)
    f = cond.video_length // mesh.shape["frames"]
    videos = B // f
    first = frame_offset(mesh, f) == 0
    total = torch.zeros((t, N, C), device=out.device, dtype=torch.float32)
    if first:
        # local video j is global video r * videos + j, of CFG row (that) % t
        cfg_row = (mesh.coords["rows"] * videos + torch.arange(videos, device=out.device)) % t
        total.index_add_(0, cfg_row, v_self.reshape(videos, f, N, C)[:, 0].float())
    dist.all_reduce(total, group=mesh.group("rows"))
    if not first:
        return out
    views = videos * mesh.shape["rows"] // t
    ff = (total / views).to(out.dtype)[cfg_row]                 # [videos, N, C]
    return torch.cat([ff[:, None], out.reshape(videos, f, N, C)[:, 1:]],
                     dim=1).reshape(B, N, C)


class EpiSelfAttention(nn.Module):
    """One cross-video attention with epipolar bias. Input [B, N, C],
    B = views * cfg * frames, N = H * W."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor, cond: EpiConditioning,
                pre_ln: nn.LayerNorm, maps: Optional[dict] = None) -> torch.Tensor:
        """``x`` is UNNORMALIZED: ``pre_ln`` folds into the projections
        (LayerNorm is per token, so it commutes with the partner gather).
        ``maps``: a dict that receives the attention's ``query`` [B, N, C] and
        ``key``, the partner rows' keys [B, N, C] (gathered by the route on
        the kernel path): the auxiliary q/k head's input. Without it nothing
        is gathered or kept."""
        B, N, C = x.shape
        feat_size = int(round(N ** 0.5))
        if feat_size * feat_size != N:
            raise ValueError("epi attention requires square grids")
        if cond.mono_direction:
            # the reference rejects this path too (attention_processor.py:622)
            raise NotImplementedError("mono_direction is not supported")
        mesh = cond.mesh
        # the batch rows of the whole call: on a mesh every rank holds a block
        rows = B if mesh is None else B * mesh.size
        lines = _epi_lines(cond, B, feat_size, x.device)
        weights = (self.to_q.weight, self.to_k.weight, self.to_v.weight)
        multi_group = cond.kv_index is not None and cond.kv_index.shape[0] != rows
        if mesh is not None and (multi_group or maps is not None):
            raise NotImplementedError("on a mesh the epi attention takes one partner per row "
                                      "and keeps no q/k maps")

        def project(tokens, ws):
            return layer_norm_matmul(tokens, pre_ln.weight, pre_ln.bias, list(ws),
                                     [None] * len(ws), eps=pre_ln.eps)

        if feat_size >= EPI_KERNEL_MIN_FEAT and not multi_group:
            q, k, v = project(x, weights)
            coords_xy = pixel_grid_coords(feat_size, cond.F_mat_size, x.device)[:, :2].T
            norm_lines, band, alpha = lines_and_band(lines, feat_size, cond.F_mat_size)
            route = cond.route(rows, x.device)
            if mesh is None:
                out = epi_flash_attention(q, k, v, norm_lines, coords_xy.contiguous(), band,
                                          alpha, heads=self.heads, kv_index=route)
            else:
                out = sharded_epi_flash(q, k, v, norm_lines, coords_xy.contiguous(), band,
                                        alpha, self.heads, route, cond.video_length, mesh)
            v_self = v
            if maps is not None:
                k = k[route.long()]
        else:
            (q,) = project(x, weights[:1])
            partners = (gather_partner_tokens(x, cond.kv_index) if mesh is None else
                        sharded_partner_tokens(x, cond.route(rows, x.device),
                                               cond.video_length, mesh))
            k, v = project(partners, weights[1:])
            coords = pixel_grid_coords(feat_size, cond.F_mat_size, x.device)
            bias = regroup_bias(epipolar_attn_bias_from_lines(
                lines, coords, feat_size, cond.F_mat_size), B)
            out = merge_heads(attention_with_bias(
                split_heads(q, self.heads), split_heads(k, self.heads),
                split_heads(v, self.heads), bias))
            v_self = None
        if cond.fix_firstframe:
            # the first frame's output becomes its own V averaged over the views,
            # per CFG row (attention_processor.py:629-635)
            if v_self is None:
                (v_self,) = project(x, weights[2:])
            out = _fix_first_frame(out, v_self, cond)
        if maps is not None:
            maps.update(query=q, key=k)
        return linear(self.to_out[0], out)


class EpiTransformerBlock(nn.Module):
    """num_attention_blocks x (LN -> EpiSelfAttention -> +res), then FF."""

    def __init__(self, dim: int, heads: int, num_attention_blocks: int = 2):
        super().__init__()
        self.attention_blocks = nn.ModuleList([
            EpiSelfAttention(dim, heads) for _ in range(num_attention_blocks)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-5)
                                    for _ in range(num_attention_blocks)])
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, cond: EpiConditioning, pab=None,
                qk: Optional[list] = None) -> torch.Tensor:
        """pab: the request's PAB cache, class "epi": a reused attention
        skips its lines, bias set-up and projections as well. ``qk``: a list
        that receives each attention's {"query", "key"} (zeros where PAB
        reused the attention, as in the JAX package)."""
        for norm, attn in zip(self.norms, self.attention_blocks):
            maps = None if qk is None else {}
            x = x + pab_run(pab, attn, "epi", lambda: attn(x, cond, pre_ln=norm, maps=maps))
            if qk is not None:
                qk.append(maps or {"query": torch.zeros_like(x), "key": torch.zeros_like(x)})
        return self.ff(x, pre_ln=self.ff_norm) + x


class EpiTransformer(nn.Module):
    """The epi module of one UNet layer: [B, F, H, W, C] in and out, with
    the outer residual."""

    def __init__(self, in_channels: int, heads: int = 8, num_transformer_blocks: int = 1,
                 num_attention_blocks: int = 2, norm_groups: int = 32):
        super().__init__()
        C = in_channels
        self.norm = FusedGroupNorm(C, norm_groups, 1e-6)
        self.proj_in = nn.Linear(C, C)
        self.transformer_blocks = nn.ModuleList([
            EpiTransformerBlock(C, heads, num_attention_blocks)
            for _ in range(num_transformer_blocks)])
        self.proj_out = nn.Linear(C, C)

    def forward(self, x: torch.Tensor, cond: EpiConditioning, pab=None,
                qk: Optional[list] = None) -> torch.Tensor:
        """``qk``: a list that receives every attention's q/k maps."""
        B, Fr, H, W, C = x.shape
        h = linear(self.proj_in, group_norm_per_frame(self.norm, x).reshape(B * Fr, H * W, C))
        for blk in self.transformer_blocks:
            h = blk(h, cond, pab, qk)
        return linear(self.proj_out, h).reshape(B, Fr, H, W, C) + x


class EpiModule(nn.Module):
    """The reference nests the transformer one level down (state-dict key
    ``epi_modules.{j}.epi_transformer...``)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.epi_transformer = EpiTransformer(*args, **kwargs)

    def forward(self, x: torch.Tensor, cond: EpiConditioning, pab=None,
                qk: Optional[list] = None) -> torch.Tensor:
        return self.epi_transformer(x, cond, pab, qk)
