"""Per-pixel temporal attention — port of ``cvd_tpu/ops/temporal_attn.py``.

The motion module attends over the FRAME axis independently for every
pixel, in the pixel-major [B, N, F, C] layout. On CUDA tensors
``temporal_flash_attention`` launches ``csrc/temporal_attn_fwd.cu``
(kernel K3); on CPU tensors it runs the plain PyTorch version
``temporal_attention_plain``. It is differentiable in q/k/v: on CUDA
through an ``autograd.Function`` whose backward launches
``csrc/temporal_attn_bwd.cu`` (kernel K7, the TPU ``_bwd_kernel``), on
the CPU through autograd of the plain version. The mask gets no gradient.

Each source holds two device kernels, and ``kernel_route`` picks one from
(F, G, head_dim, dtype) alone. ``"mma"``: bf16 with F, G <= 16 and a
head_dim of ``MMA_HEAD_DIMS`` (every temporal attention of the SD1.5 UNet
and of the pose encoder): whole rows of q/k/v (and dO) copied to shared
memory as bf16 by a ring of ``cp.async`` stages, every product on the
tensor cores (``mma.sync.m16n8k16``) with the logits and probabilities
held in register fragments, results stored as whole rows; it reads q/k/v
through their strides, so the three ``split`` views of a fused projection
cost no copy. ``"fma"``: the full-f32 shared-memory kernels, for f32 (the
card-vs-CPU checks need full-f32 products) and for what the other does not
take (F or G of 17 to 32, other head_dims). A CUDA tensor launches one of
the two or raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from cvd_tpu_torch.ops import PLAIN_DEVICES, _build
from cvd_tpu_torch.ops.epi_flash import _check_rows, _needs_grad

_P, _L, _I = _build.P, _build.L, _build.I
_SIGNATURE = {
    # dtype, q k v, their (batch, pixel, frame) strides, mask, out and its
    # strides, B N F G heads head_dim, scale, stream
    "temporal_attn_fwd": [_I, *[_P] * 3, *[_L] * 9, _P, _P, *[_L] * 3, *[_I] * 6,
                          _build.F, _P],
    # the same without the dtype, and the heads a block takes after head_dim
    "temporal_attn_fwd_mma": [*[_P] * 3, *[_L] * 9, _P, _P, *[_L] * 3, *[_I] * 7,
                              _build.F, _P],
}
_BWD_SIGNATURE = {
    # dtype, q k v dO, their strides, mask, dq dk dv, the strides of dq and
    # of dk / dv, B N F G heads head_dim, scale, stream
    "temporal_attn_bwd": [_I, *[_P] * 4, *[_L] * 12, *[_P] * 4, *[_L] * 6, *[_I] * 6,
                          _build.F, _P],
    "temporal_attn_bwd_mma": [*[_P] * 4, *[_L] * 12, *[_P] * 4, *[_L] * 6, *[_I] * 7,
                              _build.F, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what the bf16 tensor-core kernels are instantiated for: the M of their
# mma tile, and the head_dims (SD1.5 and the pose encoder: 40, 80, 160; the
# smoke widths: 8, 16)
MMA_MAX_FRAMES = 16
MMA_HEAD_DIMS = (8, 16, 32, 40, 64, 80, 128, 160)
MAX_FRAMES = 32        # of the f32 shared-memory kernels
_MMA_MAX_WARPS = 8     # heads a block takes at most, one warp each
_MMA_ROW_BYTES = 640   # a unit's row piece in shared memory at most


def kernel_route(F: int, G: int, D: int, dtype: str) -> str:
    """Which device kernel K3 / K7 launch for F query frames, G key frames
    and head_dim D in ``dtype`` ("float32" or "bfloat16"): ``"mma"`` (bf16
    tensor-core kernel) or ``"fma"`` (f32 shared-memory kernel). Raises on
    what neither takes. Plain arithmetic on the shapes, nothing else."""
    if dtype not in ("float32", "bfloat16"):
        raise TypeError(f"temporal kernel takes f32 or bf16, got {dtype}")
    if not (1 <= F <= MAX_FRAMES and 1 <= G <= MAX_FRAMES):
        raise ValueError(f"temporal kernel takes 1 to {MAX_FRAMES} frames, got F {F} G {G}")
    per_16_bytes = 4 if dtype == "float32" else 8
    if D < per_16_bytes or D % per_16_bytes:
        raise ValueError(f"head_dim {D} is not a multiple of 16 bytes")
    if (dtype == "bfloat16" and F <= MMA_MAX_FRAMES and G <= MMA_MAX_FRAMES
            and D in MMA_HEAD_DIMS):
        return "mma"
    return "fma"


def head_group(heads: int, D: int) -> int:
    """Heads one block of the bf16 tensor-core kernels takes (one warp each):
    the largest divisor of ``heads``, at most 8, whose channels are at most
    640 bytes of a row, so that a block's two stages leave room for three
    (forward) or two (backward) blocks on an SM."""
    fits = [g for g in range(1, min(heads, _MMA_MAX_WARPS) + 1)
            if heads % g == 0 and g * D * 2 <= _MMA_ROW_BYTES]
    return max(fits, default=1)


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
        logits = logits + mask.detach().float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, vh)                     # [B, N, H, F, D]
    return out.permute(0, 1, 3, 2, 4).reshape(B, N, F, C)


def _prepare(q, k, v, mask, heads):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"temporal kernel takes f32 or bf16, got {q.dtype}")
    B, N, F, C = q.shape
    G = k.shape[2]
    if C % heads or k.shape != (B, N, G, C) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    kernel_route(F, G, C // heads, str(q.dtype)[6:])  # raises on what no kernel takes
    q, k, v = (_check_rows(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v")))
    if mask is not None:
        mask = mask.detach().to(device=q.device, dtype=torch.float32).contiguous()
        if mask.shape != (F, G):
            raise ValueError(f"mask {tuple(mask.shape)} is not [{F}, {G}]")
    return q, k, v, mask


def _launch(q, k, v, mask, heads):
    B, N, F, C = q.shape
    G = k.shape[2]
    D = C // heads
    out = torch.empty((B, N, F, C), device=q.device, dtype=q.dtype)
    lib = _build.library("temporal_attn_fwd", _SIGNATURE)
    tensors = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), *out.stride()[:3],
        B, N, F, G, heads, D)
    tail = (1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    if kernel_route(F, G, D, str(q.dtype)[6:]) == "mma":
        err = lib.temporal_attn_fwd_mma(*tensors, head_group(heads, D), *tail)
    else:
        err = lib.temporal_attn_fwd(_DTYPES[q.dtype], *tensors, *tail)
    _build.check(err, "temporal_attn_fwd")
    return out


def _launch_bwd(q, k, v, mask, heads, g):
    B, N, F, C = q.shape
    G = k.shape[2]
    D = C // heads
    g = _check_rows(g.to(q.dtype), "grad")
    dq = torch.empty((B, N, F, C), device=q.device, dtype=q.dtype)
    dk = torch.empty((B, N, G, C), device=q.device, dtype=q.dtype)
    dv = torch.empty_like(dk)
    lib = _build.library("temporal_attn_bwd", _BWD_SIGNATURE)
    tensors = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *g.stride()[:3],
        None if mask is None else mask.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dq.stride()[:3], *dk.stride()[:3],
        B, N, F, G, heads, D)
    tail = (1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    if kernel_route(F, G, D, str(q.dtype)[6:]) == "mma":
        err = lib.temporal_attn_bwd_mma(*tensors, head_group(heads, D), *tail)
    else:
        err = lib.temporal_attn_bwd(_DTYPES[q.dtype], *tensors, *tail)
    _build.check(err, "temporal_attn_bwd")
    return dq, dk, dv


class _TemporalFn(torch.autograd.Function):
    """K3 forward, K7 backward (recomputes P; saves only the inputs)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, heads):
        q, k, v, mask = _prepare(q, k, v, mask, heads)
        ctx.save_for_backward(q, k, v, mask)
        ctx.heads = heads
        return _launch(q, k, v, mask, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = temporal_flash_attention_bwd(q, k, v, mask, ctx.heads, g)
        return dq, dk, dv, None, None


def temporal_flash_attention(
    q: torch.Tensor,                    # [B, N, F, C] (pixel-major)
    k: torch.Tensor,                    # [B, N, G, C]
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # additive [F, G]
    heads: int = 8,
) -> torch.Tensor:
    """Per-pixel attention over the frame axis in pixel-major layout."""
    if q.device.type in PLAIN_DEVICES:
        return temporal_attention_plain(q, k, v, mask, heads)
    if q.device.type != "cuda":
        raise ValueError(f"temporal_flash_attention: no kernel for {q.device}")
    if _needs_grad(q, k, v):
        out = _TemporalFn.apply(q, k, v, mask, heads)
    else:
        out = _launch(*_prepare(q, k, v, mask, heads), heads)
    temporal_flash_attention.launches += 1
    return out


def temporal_flash_attention_bwd(q, k, v, mask, heads, g):
    """(dq, dk, dv) of ``temporal_flash_attention`` for the output
    gradient ``g`` (kernel K7 on CUDA; autograd of the plain version on the
    CPU)."""
    if q.device.type in PLAIN_DEVICES:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = temporal_attention_plain(*leaves, mask, heads)
            return torch.autograd.grad(out, leaves, g)
    grads = _launch_bwd(*_prepare(q, k, v, mask, heads), heads, g)
    temporal_flash_attention_bwd.launches += 1
    return grads


temporal_flash_attention.launches = 0
temporal_flash_attention_bwd.launches = 0
