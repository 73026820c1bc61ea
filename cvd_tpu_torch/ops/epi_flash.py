"""Fused (epipolar) flash attention — port of ``cvd_tpu/ops/epi_flash.py``.

``epi_flash_attention`` (kernel K1) is the cross-video attention of the epi
modules: query row b reads the k/v of row ``kv_index[b]`` and adds the
epipolar bias ``-relu(|a_q x_k + b_q y_k + c_q| - band_b) * alpha_b``.
``flash_attention`` (kernel K2) is the same kernel without bias, for the
big spatial self-attentions. Both take q/k/v in the projections' native
[B, L, C] layout (C = heads * head_dim).

On CUDA tensors both launch ``csrc/epi_flash_fwd.cu``; on CPU tensors they
run the plain PyTorch version below (``_plain``), which is also what the
kernel is checked against on the card. They are differentiable in q/k/v:
on CUDA through an ``autograd.Function`` whose backward launches
``csrc/epi_flash_bwd.cu`` (kernel K6, the TPU ``_bwd_kernel``), on the CPU
through autograd of ``_plain``. The geometry and ``kv_index`` get no
gradient (the reference detaches the mask too).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from cvd_tpu_torch.ops import PLAIN_DEVICES, _build
from cvd_tpu_torch.ops.attention import attention_with_bias

_SIGNATURE = {"epi_flash_fwd": [
    _build.I, _build.I, _build.P, _build.P, _build.P,
    _build.L, _build.L, _build.L, _build.L, _build.L, _build.L,
    _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.P, _build.L, _build.L, _build.P,
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.F, _build.P,
]}
_BWD_SIGNATURE = {
    "epi_flash_bwd": [
        _build.I, _build.I, _build.P, _build.P, _build.P, _build.P,
        _build.L, _build.L, _build.L, _build.L, _build.L, _build.L, _build.L, _build.L,
        _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P,
        _build.P, _build.P, _build.P,
        _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.F, _build.P,
    ],
    "epi_flash_bwd_delta": [
        _build.I, _build.P, _build.P, _build.L, _build.L, _build.L, _build.L, _build.P,
        _build.I, _build.I, _build.I, _build.I, _build.P,
    ],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# widest head_dim, padded to a multiple of 16, whose f32 backward tiles
# (S, dP and the dK / dV sums in f32) fit the 227 KB of shared memory
_BWD_MAX_DP = {torch.float32: 96}
# head_dims the bf16 kernels are instantiated for (SD1.5: 40, 80, 160)
_FWD_BF16_HEAD_DIMS = (8, 16, 32, 40, 48, 64, 80, 96, 128, 160)
_BWD_BF16_HEAD_DIMS = _FWD_BF16_HEAD_DIMS


def bias_from_geometry(norm_lines: torch.Tensor, coords: torch.Tensor,
                       band: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """[B, Lq, Lk] epipolar bias from ab-normalized query lines [B, Lq, 3],
    key pixel coords [2, Lk] (x row, y row) and per-row band/alpha [B] —
    the math of the TPU kernel's ``_bias_tile``."""
    a, b, c = norm_lines.float().unbind(-1)
    cfc = torch.abs(a[..., None] * coords[0] + b[..., None] * coords[1] + c[..., None])
    return -torch.clamp(cfc - band[:, None, None], min=0.0) * alpha[:, None, None]


def _plain(q, k, v, geom, kv_index, heads):
    B, Lq, C = q.shape
    if kv_index is not None:
        k, v = k[kv_index.long()], v[kv_index.long()]
    D = C // heads

    def split(x):
        return x.reshape(x.shape[0], x.shape[1], heads, D).transpose(1, 2)

    bias = None if geom is None else bias_from_geometry(*(t.detach() for t in geom))
    out = attention_with_bias(split(q), split(k), split(v), bias)
    return out.transpose(1, 2).reshape(B, Lq, C)


def _check_rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """The kernel reads rows with 16-byte vector loads through strides."""
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            (s * x.element_size()) % 16 for s in x.stride()[:-1]):
        x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: storage is not 16-byte aligned")
    return x


def _prepare(q, k, v, geom, kv_index, heads):
    """Check the kernel's constraints; -> (q, k, v, geom, kv_index) as the
    kernels read them (16-byte rows, f32 contiguous geometry, int32 index)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"epi flash kernel takes f32 or bf16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, Lq, C = q.shape
    Lk = k.shape[1]
    if C % heads or k.shape[2] != C or v.shape[1:] != k.shape[1:]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} heads {heads}")
    D = C // heads
    if D % (16 // q.element_size()) or D > 160:
        raise ValueError(f"head_dim {D}: the kernel takes a multiple of "
                         f"{16 // q.element_size()} up to 160")
    if q.dtype == torch.bfloat16 and D not in _FWD_BF16_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the bf16 kernel takes one of {_FWD_BF16_HEAD_DIMS}")
    q, k, v = (_check_rows(x, n) for x, n in ((q, "q"), (k, "k"), (v, "v")))
    if kv_index is not None:
        kv_index = kv_index.to(device=q.device, dtype=torch.int32).contiguous()
    if geom is not None:
        geom = tuple(t.detach().to(device=q.device, dtype=torch.float32).contiguous()
                     for t in geom)
        norm_lines, coords, band, alpha = geom
        if (norm_lines.shape != (B, Lq, 3) or coords.shape != (2, Lk)
                or band.numel() != B or alpha.numel() != B):
            raise ValueError("bad epipolar geometry shapes")
    return q, k, v, geom, kv_index


def _geom_ptrs(geom):
    return [None] * 4 if geom is None else [t.data_ptr() for t in geom]


def _launch(q, k, v, geom, kv_index, heads) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1/K2 on prepared inputs -> (out [B, Lq, C], lse [B, H, Lq] f32)."""
    B, Lq, C = q.shape
    Lk = k.shape[1]
    D = C // heads
    out = torch.empty((B, Lq, C), device=q.device, dtype=q.dtype)
    lse = torch.empty((B, heads, Lq), device=q.device, dtype=torch.float32)
    lib = _build.library("epi_flash_fwd", _SIGNATURE)
    err = lib.epi_flash_fwd(
        _DTYPES[q.dtype], int(geom is not None), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        None if kv_index is None else kv_index.data_ptr(), *_geom_ptrs(geom),
        out.data_ptr(), out.stride(0), out.stride(1), lse.data_ptr(),
        B, heads, Lq, Lk, D, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "epi_flash_fwd")
    return out, lse


def _check_bwd(dtype: torch.dtype, D: int) -> None:
    """Raise on a head_dim the backward kernels are not built for."""
    if dtype == torch.bfloat16:
        if D not in _BWD_BF16_HEAD_DIMS:
            raise ValueError(f"head_dim {D}: the bf16 backward kernel takes one of "
                             f"{_BWD_BF16_HEAD_DIMS}")
    elif (D + 15) // 16 * 16 > _BWD_MAX_DP[dtype]:
        raise ValueError(f"head_dim {D}: the {dtype} backward kernel holds its tiles in "
                         f"shared memory up to a padded head_dim of {_BWD_MAX_DP[dtype]}")


def _bwd_buffers(q, k, heads):
    """-> (delta [B, H, Lq] f32, dq, dk, dv), uninitialised, as K6 writes them:
    in the input type, dk/dv per SOURCE row of k/v."""
    B, Lq, C = q.shape
    delta = torch.empty((B, heads, Lq), device=q.device, dtype=torch.float32)
    dq = torch.empty((B, Lq, C), device=q.device, dtype=q.dtype)
    dk = torch.empty((k.shape[0], k.shape[1], C), device=q.device, dtype=q.dtype)
    return delta, dq, dk, torch.empty_like(dk)


def _launch_bwd_kernels(q, k, v, geom, kv_index, heads, out, lse, g, delta, dq, dk, dv):
    """The device kernels of K6 on prepared inputs and buffers: delta =
    rowsum(dO * O) per head (epi_flash.py:296-301), then dkdv and dq."""
    B, Lq, C = q.shape
    Lk = k.shape[1]
    D = C // heads
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = _build.library("epi_flash_bwd", _BWD_SIGNATURE)
    err = lib.epi_flash_bwd_delta(
        _DTYPES[q.dtype], g.data_ptr(), out.data_ptr(), g.stride(0), g.stride(1),
        out.stride(0), out.stride(1), delta.data_ptr(), B, heads, Lq, D, stream)
    _build.check(err, "epi_flash_bwd_delta")
    err = lib.epi_flash_bwd(
        _DTYPES[q.dtype], int(geom is not None), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        g.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), g.stride(0), g.stride(1),
        None if kv_index is None else kv_index.data_ptr(), *_geom_ptrs(geom),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, k.shape[0], heads, Lq, Lk, D, 1.0 / math.sqrt(D), stream)
    _build.check(err, "epi_flash_bwd")


def _launch_bwd(q, k, v, geom, kv_index, heads, out, lse, g):
    """K6 on prepared inputs -> (dq, dk, dv) in the input dtype, dk/dv of the
    source rows of k/v (a row may be routed to more than once, or never)."""
    _check_bwd(q.dtype, q.shape[2] // heads)
    g = _check_rows(g.to(q.dtype), "grad")
    out = _check_rows(out, "out")
    delta, dq, dk, dv = _bwd_buffers(q, k, heads)
    _launch_bwd_kernels(q, k, v, geom, kv_index, heads, out, lse, g, delta, dq, dk, dv)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """K1/K2 forward, K6 backward; saves q, k, v, out and the row LSE."""

    @staticmethod
    def forward(ctx, q, k, v, norm_lines, coords, band, alpha, kv_index, heads, bwd_wrapper):
        geom = None if norm_lines is None else (norm_lines, coords, band, alpha)
        q, k, v, geom, kv_index = _prepare(q, k, v, geom, kv_index, heads)
        out, lse = _launch(q, k, v, geom, kv_index, heads)
        ctx.save_for_backward(q, k, v, out, lse, kv_index, *(geom or ()))
        ctx.heads = heads
        ctx.bwd_wrapper = bwd_wrapper
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, kv_index, *geom = ctx.saved_tensors
        dq, dk, dv = ctx.bwd_wrapper(q, k, v, tuple(geom) or None, kv_index, ctx.heads,
                                     out, lse, g)
        return dq, dk, dv, None, None, None, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def epi_flash_attention(
    q: torch.Tensor,            # [B, N, C]
    k: torch.Tensor,            # [Bk, Lk, C] SOURCE rows (pre-routing)
    v: torch.Tensor,            # [Bk, Lk, C]
    norm_lines: torch.Tensor,   # [B, N, 3] ab-normalized epipolar lines
    coords: torch.Tensor,       # [2, Lk] key pixel coords (x row, y row)
    band: torch.Tensor,         # [B]
    alpha: torch.Tensor,        # [B]
    heads: int = 8,
    kv_index: Optional[torch.Tensor] = None,  # [B] partner row per query row
) -> torch.Tensor:
    """Epipolar cross-video attention in the native [B, N, C] layout."""
    geom = (norm_lines, coords, band, alpha)
    if q.device.type in PLAIN_DEVICES:
        return _plain(q, k, v, geom, kv_index, heads)
    if q.device.type != "cuda":
        raise ValueError(f"epi_flash_attention: no kernel for {q.device}")
    if _needs_grad(q, k, v):
        out = _FlashFn.apply(q, k, v, *geom, kv_index, heads, epi_flash_attention_bwd)
    else:
        out = _launch(*_prepare(q, k, v, geom, kv_index, heads), heads)[0]
    epi_flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int = 8) -> torch.Tensor:
    """Plain multi-head attention, q/k/v [B, L, C]; no [L, L] tensor in
    device memory and no head-split transposes."""
    if q.device.type in PLAIN_DEVICES:
        return _plain(q, k, v, None, None, heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if _needs_grad(q, k, v):
        out = _FlashFn.apply(q, k, v, None, None, None, None, None, heads,
                             flash_attention_bwd)
    else:
        out = _launch(*_prepare(q, k, v, None, None, heads), heads)[0]
    flash_attention.launches += 1
    return out


def _plain_bwd(q, k, v, geom, kv_index, heads, g):
    """Autograd of ``_plain``: the backward kernel's plain version."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = _plain(*leaves, geom, kv_index, heads)
        return torch.autograd.grad(out, leaves, g)


def epi_flash_attention_bwd(q, k, v, geom, kv_index, heads, out, lse, g):
    """(dq, dk, dv) of ``epi_flash_attention`` from the forward's saved out
    and lse [B, H, Lq] (kernel K6 on CUDA; autograd of ``_plain`` on the
    CPU, which needs neither)."""
    if q.device.type in PLAIN_DEVICES:
        return _plain_bwd(q, k, v, geom, kv_index, heads, g)
    grads = _launch_bwd(q, k, v, geom, kv_index, heads, out, lse, g)
    epi_flash_attention_bwd.launches += 1
    return grads


def flash_attention_bwd(q, k, v, geom, kv_index, heads, out, lse, g):
    """(dq, dk, dv) of ``flash_attention`` (kernel K6 without bias)."""
    if q.device.type in PLAIN_DEVICES:
        return _plain_bwd(q, k, v, None, None, heads, g)
    grads = _launch_bwd(q, k, v, None, None, heads, out, lse, g)
    flash_attention_bwd.launches += 1
    return grads


epi_flash_attention.launches = 0
flash_attention.launches = 0
epi_flash_attention_bwd.launches = 0
flash_attention_bwd.launches = 0
