"""The yardstick's arithmetic: the H100's published peaks and the operations
and bytes of the kernel families, from the shapes the reference records.

A roofline counts every input byte read once and every output byte written
once, and the products the algorithm needs. Peaks: NVIDIA's H100 SXM data
sheet, dense, at the full 700 W power limit.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}

Work = Tuple[float, float]  # (flops, bytes)


def _geometry_bytes(B: int, Lq: int, Lk: int, has_bias: bool, routed: bool) -> int:
    """f32 query lines [B, Lq, 3], key coords [2, Lk], band / alpha [B], and
    the int32 partner row of each query row."""
    return (has_bias * (B * Lq * 3 + 2 * Lk + 2 * B) + routed * B) * 4


def attention_fwd(B, heads, Lq, Lk, D, itemsize, has_bias=False, routed=False) -> Work:
    """Q K^T and P V, 2 Lq Lk D each per (row, head); q, out [B, Lq, C], k, v
    [B, Lk, C], the log-sum-exp [B, heads, Lq] in f32."""
    C = heads * D
    flops = 4 * B * heads * Lq * Lk * D
    moved = (2 * B * Lq * C + 2 * B * Lk * C) * itemsize + B * heads * Lq * 4
    return flops, moved + _geometry_bytes(B, Lq, Lk, has_bias, routed)


def attention_bwd(B, heads, Lq, Lk, D, itemsize, has_bias=False, routed=False) -> Work:
    """Five products (S again, dP, dV, dQ, dK); reads q, k, v, out, dO and the
    log-sum-exp, writes dq, dk, dv."""
    C = heads * D
    flops = 10 * B * heads * Lq * Lk * D
    moved = (4 * B * Lq * C + 4 * B * Lk * C) * itemsize + B * heads * Lq * 4
    return flops, moved + _geometry_bytes(B, Lq, Lk, has_bias, routed)


def ln_linear(T, C, K, itemsize) -> Work:
    """LayerNorm then a product of T tokens of C channels into K outputs:
    2 T C K; x [T, C], W [K, C], out [T, K] in the input type, a bias [K] in
    f32."""
    return 2 * T * C * K, (T * C + K * C + T * K) * itemsize + K * 4


def least_seconds(flops: float, moved: float, dtype: str) -> float:
    """The least time an H100 SXM could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], moved / PEAK_BYTES_PER_S)


OPS = {"ln_linear": lambda r, it: ln_linear(r["T"], r["C"], r["K"], it),
       "attention": lambda r, it: attention_fwd(r["B"], r["heads"], r["Lq"], r["Lk"], r["D"],
                                                it, r["bias"], r["routed"]),
       "attention_bwd": lambda r, it: attention_bwd(r["B"], r["heads"], r["Lq"], r["Lk"],
                                                    r["D"], it, r["bias"], r["routed"])}


def selects(family: dict, record: dict) -> bool:
    """Whether a recorded reference op is part of a kernel family's work:
    the family's ``op``, and every field of its ``where`` (a list: one of
    its values; ``min_<field>``: at least that)."""
    op = record["op"] + ("_bwd" if family["op"].endswith("_bwd") else "")
    if op != family["op"] or (family["op"].endswith("_bwd") and not record.get("grad")):
        return False
    for key, want in family.get("where", {}).items():
        if key.startswith("min_"):
            if record[key[4:]] < want:
                return False
        elif record[key] not in want:
            return False
    return True


def family_least_seconds(family: dict, records: Iterable[dict], dtype: str) -> float:
    """The least seconds of the family's ops among ``records`` (each with a
    ``count``), every op bound on its own."""
    it = ITEMSIZE[dtype]
    total = 0.0
    for r in records:
        if selects(family, r):
            flops, moved = OPS[family["op"]](r, it)
            total += r["count"] * least_seconds(flops, moved, dtype)
    return total


def tally(records: Iterable[dict]) -> list:
    """Identical records merged, with a ``count``, in a fixed order."""
    counts: Dict[tuple, int] = {}
    for r in records:
        key = tuple(sorted(r.items()))
        counts[key] = counts.get(key, 0) + 1
    return [dict(k, count=n) for k, n in sorted(counts.items(), key=lambda kv: repr(kv[0]))]
