"""Motion module: per-pixel temporal self-attention (AnimateDiff V3) with
CameraCtrl pose conditioning (port of ``cvd_tpu/models/motion.py``).

The first temporal attention of each block mixes the pose-encoder feature
into its qkv source through a zero-initialized merge layer,
``h' = qkv_merge(h + pose) * scale + h``. Tokens are pixel-major
[B, N, F, C] inside the module, so the attention over the frame axis reads
per-head [pixel, frame, dim] slices in place (kernel K3 on CUDA).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from cvd_tpu_torch.models.layers import (
    FeedForward, FusedGroupNorm, LoRADelta, fused_matmul, group_norm_per_frame, pab_run,
    temporal_positional_encoding,
)
from cvd_tpu_torch.ops.temporal_attn import temporal_attention_plain, temporal_flash_attention
from cvd_tpu_torch.parallel.mesh import Mesh
from cvd_tpu_torch.parallel.shard_ops import frame_offset, sharded_temporal_flash

# temporal attentions over at least this many pixels take the fused kernel
# on CUDA, as the JAX package does (motion.py:186-231)
TEMPORAL_KERNEL_MIN_PIXELS = 128


_MASKS: Dict[tuple, torch.Tensor] = {}


def device_temporal_mask(kind: str, length: int, device) -> torch.Tensor:
    """``causal_temporal_mask`` on ``device``, built once per (kind, length,
    device) and kept: a UNet call copies nothing from the host (a CUDA graph
    replaying the call reads the kept tensor)."""
    key = (kind, length, torch.device(device))
    if key not in _MASKS:
        _MASKS[key] = causal_temporal_mask(kind, length).to(device)
    return _MASKS[key]


def causal_temporal_mask(kind: str, length: int) -> torch.Tensor:
    """Temporal attention mask variants (causal / 2-seq / 0-prev / 0 /
    wo-self / circle) as an additive f32 [length, length] mask (0 allowed,
    -inf blocked)."""
    i = np.arange(length)
    if kind == "causal":
        m = np.tril(np.ones((length, length)))
    elif kind == "2-seq":
        m = np.zeros((length, length))
        m[: length // 2, : length // 2] = 1
        m[-(length // 2):, -(length // 2):] = 1
    elif kind == "0-prev":
        prev = np.maximum(i - 1, 0)
        m = np.zeros((length, length))
        m[:, 0] = 1
        m[i, prev] = 1
    elif kind == "0":
        m = np.zeros((length, length))
        m[:, 0] = 1
    elif kind == "wo-self":
        m = np.ones((length, length))
        m[i, i] = 0
    elif kind == "circle":
        prev = np.maximum(i - 1, 0)
        m = np.eye(length)
        m[i, prev] = 1
        m[0, -1] = 1
    else:
        raise ValueError(kind)
    return torch.from_numpy(np.where(m == 0, -np.inf, 0.0).astype(np.float32))


class _PoseProcessor(nn.Module):
    """Holds ``qkv_merge`` where the reference keeps it: on the attention
    processor (state-dict key ``...attention_blocks.0.processor.qkv_merge``),
    and beside it the sync-LoRA (``processor.to_{q,k,v,out}_lora_sync``;
    "sync" puts them in the trainable set, train/state.py)."""

    def __init__(self, dim: int, sync_lora_rank: int = 0):
        super().__init__()
        self.qkv_merge = nn.Linear(dim, dim)
        if sync_lora_rank > 0:
            for name in ("to_q", "to_k", "to_v", "to_out"):
                setattr(self, f"{name}_lora_sync",
                        LoRADelta(dim, dim, sync_lora_rank, down_std=1.0 / sync_lora_rank))
        self.sync = sync_lora_rank > 0


class TemporalSelfAttention(nn.Module):
    """One temporal attention over the frame axis: sinusoidal PE + optional
    pose conditioning. Input [B, N, F, C], already layer-normed.

    sync-LoRA (attention_processor.py:262-270, 341-344), on the
    pose-conditioned attention only, with ``sync_lora_rank > 0`` and
    ``sync_lora_scale != 0``: rank-r deltas on q/k/v from the (post-merge)
    qkv source, and on the output from the POST-projection output (the
    reference's order, kept): ``o = to_out(h); o += s * up(down(o))``."""

    def __init__(self, dim: int, heads: int, pe_max_len: int = 32,
                 pose_conditioned: bool = False, pose_scale: float = 1.0,
                 causal_mask_type: str = "", sync_lora_rank: int = 0,
                 sync_lora_scale: float = 0.0):
        super().__init__()
        self.heads = heads
        self.pe_max_len = pe_max_len
        self.pose_scale = pose_scale
        self.causal_mask_type = causal_mask_type
        self.sync_lora_scale = sync_lora_scale
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        sync = sync_lora_rank if sync_lora_scale != 0.0 else 0
        self.processor = _PoseProcessor(dim, sync) if pose_conditioned else None

    def forward(self, x: torch.Tensor, pose_feature: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        """``mesh``: a ("rows", "frames") mesh of which ``x`` holds this
        rank's frames: the positional encoding and the mask's rows are those
        of the global frames, k/v are gathered over the frames."""
        B, N, Fr, C = x.shape
        off = frame_offset(mesh, Fr)
        pe = temporal_positional_encoding(self.pe_max_len, C, x.device)[:, off:off + Fr]
        x = x + pe.to(x.dtype)
        proc = self.processor
        if proc is not None and pose_feature is not None:
            x = proc.qkv_merge(x + pose_feature.to(x.dtype)) * self.pose_scale + x
        q, k, v = fused_matmul(x, (self.to_q.weight, self.to_k.weight, self.to_v.weight))
        sync = proc is not None and proc.sync
        if sync:
            s = self.sync_lora_scale
            q = q + s * proc.to_q_lora_sync(x)
            k = k + s * proc.to_k_lora_sync(x)
            v = v + s * proc.to_v_lora_sync(x)
        frames = Fr if mesh is None else Fr * mesh.shape["frames"]
        mask = (device_temporal_mask(self.causal_mask_type, frames, x.device)
                if self.causal_mask_type else None)
        attention = (temporal_flash_attention if N >= TEMPORAL_KERNEL_MIN_PIXELS
                     else temporal_attention_plain)
        if mesh is None:
            out = attention(q, k, v, mask, self.heads)
        else:
            out = sharded_temporal_flash(q, k, v, mask, self.heads, mesh, off, attention)
        o = self.to_out[0](out)
        if sync:
            o = o + self.sync_lora_scale * proc.to_out_lora_sync(o)
        return o


class TemporalTransformerBlock(nn.Module):
    """N temporal attentions + feed-forward, pre-LN residual style. Tokens
    [B, N, F, C]."""

    def __init__(self, dim: int, heads: int, num_attention_blocks: int = 2,
                 pe_max_len: int = 32, pose_cond_indices: Sequence[int] = (0,),
                 pose_scale: float = 1.0, causal_mask_type: str = "",
                 sync_lora_rank: int = 0, sync_lora_scale: float = 0.0):
        super().__init__()
        self.attention_blocks = nn.ModuleList([
            TemporalSelfAttention(dim, heads, pe_max_len,
                                  pose_conditioned=i in pose_cond_indices,
                                  pose_scale=pose_scale,
                                  causal_mask_type=causal_mask_type,
                                  sync_lora_rank=sync_lora_rank,
                                  sync_lora_scale=sync_lora_scale)
            for i in range(num_attention_blocks)
        ])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-5)
                                    for _ in range(num_attention_blocks)])
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, pose_feature: Optional[torch.Tensor] = None,
                pab=None, mesh: Optional[Mesh] = None) -> torch.Tensor:
        """pab: the request's PAB cache, class "temporal": a reused attention
        skips its LayerNorm, PE add and ``qkv_merge`` as well."""
        for norm, attn in zip(self.norms, self.attention_blocks):
            x = pab_run(pab, attn, "temporal", lambda: attn(norm(x), pose_feature, mesh)) + x
        return self.ff(x, pre_ln=self.ff_norm) + x


class TemporalTransformer(nn.Module):
    """The motion module of one UNet layer. Input/output [B, F, H, W, C]
    with the outer residual connection."""

    def __init__(self, in_channels: int, heads: int = 8, num_transformer_blocks: int = 1,
                 num_attention_blocks: int = 2, pe_max_len: int = 32,
                 pose_cond_indices: Sequence[int] = (0,), pose_scale: float = 1.0,
                 norm_groups: int = 32, causal_mask_type: str = "",
                 sync_lora_rank: int = 0, sync_lora_scale: float = 0.0):
        super().__init__()
        C = in_channels
        self.norm = FusedGroupNorm(C, norm_groups, 1e-6)
        self.proj_in = nn.Linear(C, C)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(C, heads, num_attention_blocks, pe_max_len,
                                     pose_cond_indices, pose_scale, causal_mask_type,
                                     sync_lora_rank, sync_lora_scale)
            for _ in range(num_transformer_blocks)
        ])
        self.proj_out = nn.Linear(C, C)

    def forward(self, x: torch.Tensor, pose_feature: Optional[torch.Tensor] = None,
                pab=None, mesh: Optional[Mesh] = None) -> torch.Tensor:
        B, Fr, H, W, C = x.shape
        # per-frame GroupNorm, then pixel-major for the temporal blocks
        h = group_norm_per_frame(self.norm, x).reshape(B, Fr, H * W, C)
        h = self.proj_in(h.transpose(1, 2))
        if pose_feature is not None:
            pose_feature = pose_feature.reshape(B, Fr, H * W, -1).transpose(1, 2)
        for blk in self.transformer_blocks:
            h = blk(h, pose_feature, pab, mesh)
        h = self.proj_out(h).transpose(1, 2)
        return h.reshape(B, Fr, H, W, C) + x


class MotionModule(nn.Module):
    """VanillaTemporalModule: the reference nests the transformer one level
    down (state-dict key ``motion_modules.{j}.temporal_transformer...``)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.temporal_transformer = TemporalTransformer(*args, **kwargs)

    def forward(self, x: torch.Tensor, pose_feature: Optional[torch.Tensor] = None,
                pab=None, mesh: Optional[Mesh] = None) -> torch.Tensor:
        """``mesh``: a ("rows", "frames") mesh of which ``x`` is this rank's
        block (``parallel/shard_ops.py``)."""
        return self.temporal_transformer(x, pose_feature, pab, mesh)
