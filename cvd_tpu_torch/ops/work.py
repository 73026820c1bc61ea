"""The work of each kernel, from its shapes: floating-point operations, the
bytes it must move, and the least time an H100 could take for them.

Counted as a roofline counts them: every input byte read once and every
output byte written once, whatever a kernel reads again, and the products
the algorithm needs, not the ones a split into two kernels recomputes. The
peaks are NVIDIA's published rates of the H100 SXM (dense, at the full 700 W
power limit): 989 TFLOP/s in bf16 / fp16 on the tensor cores, 67 TFLOP/s in
f32 outside them, 3.35 TB/s of device memory.

Plain arithmetic: nothing here imports torch, so the CPU tests cover it and
``chip_smoke.py`` prints its bounds beside the measured times.
"""
from __future__ import annotations

from typing import Optional, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

Work = Tuple[int, int]  # (flops, bytes)


def _geometry_bytes(B: int, Lq: int, Lk: int, has_bias: bool, routed: bool) -> int:
    """f32 query lines [B, Lq, 3], key coords [2, Lk], band / alpha [B], and
    the int32 partner row of each query row."""
    return (has_bias * (B * Lq * 3 + 2 * Lk + 2 * B) + routed * B) * 4


def attention_fwd(B: int, heads: int, Lq: int, Lk: int, D: int, itemsize: int,
                  has_bias: bool = False, routed: bool = False) -> Work:
    """K1 / K2: Q K^T and P V are 2 * Lq * Lk * D each per (row, head); q and
    out are [B, Lq, heads * D], k and v [B, Lk, heads * D], lse [B, heads, Lq]
    in f32."""
    C = heads * D
    flops = 4 * B * heads * Lq * Lk * D
    moved = (2 * B * Lq * C + 2 * B * Lk * C) * itemsize + B * heads * Lq * 4
    return flops, moved + _geometry_bytes(B, Lq, Lk, has_bias, routed)


def attention_bwd(B: int, heads: int, Lq: int, Lk: int, D: int, itemsize: int,
                  has_bias: bool = False, routed: bool = False) -> Work:
    """K6: five products (S = Q K^T again, dP = dO V^T, dV = P^T dO,
    dQ = dS K, dK = dS^T Q); reads q, k, v, out, dO and lse, writes dq, dk,
    dv in the input type."""
    C = heads * D
    flops = 10 * B * heads * Lq * Lk * D
    moved = (4 * B * Lq * C + 4 * B * Lk * C) * itemsize + B * heads * Lq * 4
    return flops, moved + _geometry_bytes(B, Lq, Lk, has_bias, routed)


def temporal_fwd(B: int, N: int, F: int, C: int, itemsize: int, has_mask: bool = False,
                 G: Optional[int] = None) -> Work:
    """K3: attention of F query frames over G key frames (default F) for each
    of B * N pixels; q and out are [B, N, F, C], k and v [B, N, G, C], the
    mask [F, G] f32. 4 * F * G * D flops per (pixel, head) = 4 * F * G * C a
    pixel."""
    G = F if G is None else G
    return (4 * B * N * F * G * C,
            2 * B * N * (F + G) * C * itemsize + has_mask * F * G * 4)


def temporal_bwd(B: int, N: int, F: int, C: int, itemsize: int, has_mask: bool = False) -> Work:
    """K7: five products; reads q, k, v, dO, writes dq, dk, dv."""
    return 10 * B * N * F * F * C, 7 * B * N * F * C * itemsize + has_mask * F * F * 4


def group_norm(R: int, S: int, C: int, itemsize: int, act: bool = True) -> Work:
    """K4: x [R, S, C] read once and written once, gamma / beta in f32. Per
    element: sum, centred square sum (2 + 3), normalize and affine (4), and 4
    more for the SiLU."""
    return (9 + 4 * act) * R * S * C, 2 * R * S * C * itemsize + 2 * C * 4


def ln_matmul(T: int, C: int, K: int, itemsize: int) -> Work:
    """K5: the product 2 * T * C * K (the statistics are ~5 * T * C more, left
    out as the bound is stated for the product); x [T, C], W' [K, C] and out
    [T, K] in the input type, b' [K] in f32."""
    return 2 * T * C * K, (T * C + K * C + T * K) * itemsize + K * 4


def bound_ms(flops: float, moved: float, dtype: str) -> Tuple[float, str]:
    """-> (the least milliseconds an H100 SXM could take, "operations" or
    "bytes": which of the two limits it is). ``dtype`` names the type the
    operations run in: "bfloat16" on the tensor cores, "float32" outside."""
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = moved / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
