"""Per-pixel temporal attention — port of ``cvd_tpu/ops/temporal_attn.py``.

The motion module attends over the FRAME axis independently for every
pixel, in the pixel-major [B, N, F, C] layout. On CUDA tensors
``temporal_flash_attention`` launches ``csrc/temporal_attn_fwd.cu``
(kernel K3); on CPU tensors it runs the plain PyTorch version
``temporal_attention_plain``.
Forward only: the backward kernel comes with training.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from cvd_tpu_torch.ops import _build
from cvd_tpu_torch.ops.epi_flash import _check_rows

_SIGNATURE = {"temporal_attn_fwd": [
    _build.I, _build.P, _build.P, _build.P,
    _build.L, _build.L, _build.L, _build.L, _build.L, _build.L,
    _build.L, _build.L, _build.L,
    _build.P, _build.P, _build.L, _build.L, _build.L,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.F, _build.P,
]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def temporal_attention_plain(q, k, v, mask=None, heads=8):
    """Plain PyTorch per-pixel temporal attention (the CPU path and the
    kernel's reference): q [B, N, F, C], k/v [B, N, G, C], mask [F, G]."""
    B, N, F, C = q.shape
    G = k.shape[2]
    D = C // heads
    qh = q.reshape(B, N, F, heads, D).permute(0, 1, 3, 2, 4)
    kh = k.reshape(B, N, G, heads, D).permute(0, 1, 3, 2, 4)
    vh = v.reshape(B, N, G, heads, D).permute(0, 1, 3, 2, 4)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).float() * (1.0 / math.sqrt(D))
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, vh)                     # [B, N, H, F, D]
    return out.permute(0, 1, 3, 2, 4).reshape(B, N, F, C)


def _launch(q, k, v, mask, heads):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"temporal kernel takes f32 or bf16, got {q.dtype}")
    B, N, F, C = q.shape
    G = k.shape[2]
    if (C % heads or k.shape != (B, N, G, C) or v.shape != k.shape
            or F > 32 or G > 32):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    D = C // heads
    if D % (16 // q.element_size()):
        raise ValueError(f"head_dim {D} is not a multiple of 16 bytes")
    q, k, v = (_check_rows(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v")))
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
        if mask.shape != (F, G):
            raise ValueError(f"mask {tuple(mask.shape)} is not [{F}, {G}]")
    out = torch.empty((B, N, F, C), device=q.device, dtype=q.dtype)
    lib = _build.library("temporal_attn_fwd", _SIGNATURE)
    err = lib.temporal_attn_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), *out.stride()[:3],
        B, N, F, G, heads, D, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "temporal_attn_fwd")
    return out


def temporal_flash_attention(
    q: torch.Tensor,                    # [B, N, F, C] (pixel-major)
    k: torch.Tensor,                    # [B, N, G, C]
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # additive [F, G]
    heads: int = 8,
) -> torch.Tensor:
    """Per-pixel attention over the frame axis in pixel-major layout."""
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, mask, heads)
    if q.device.type != "cuda":
        raise ValueError(f"temporal_flash_attention: no kernel for {q.device}")
    out = _launch(q, k, v, mask, heads)
    temporal_flash_attention.launches += 1
    return out


temporal_flash_attention.launches = 0
