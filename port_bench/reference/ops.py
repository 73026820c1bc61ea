"""The reference's arithmetic primitives: every product, convolution,
normalization and attention of the reference model goes through here.

Two switches, each a context variable so that nothing global is mutated:

* ``precision("fp8")``: the control. Both inputs of every product and
  convolution are rounded through float8 e4m3 (per-tensor scale, amax ->
  448) before the float32 arithmetic; the step below the bfloat16 that the
  configurations state.
* ``recording()``: a list that receives one record per LayerNorm + Linear
  pair and per attention, at the shapes they run at (on the ``meta``
  device: the counts of the yardstick).

Plain PyTorch only: nothing here imports the program.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F

_PRECISION: contextvars.ContextVar = contextvars.ContextVar("precision", default="f32")
_RECORD: contextvars.ContextVar = contextvars.ContextVar("record", default=None)
_SCOPE: contextvars.ContextVar = contextvars.ContextVar("scope", default="")

FP8_MAX = 448.0


@contextlib.contextmanager
def precision(name: str) -> Iterator[None]:
    """``"f32"`` (the reference) or ``"fp8"`` (the control)."""
    if name not in ("f32", "fp8"):
        raise ValueError(f"precision {name!r}: expected 'f32' or 'fp8'")
    token = _PRECISION.set(name)
    try:
        yield
    finally:
        _PRECISION.reset(token)


@contextlib.contextmanager
def recording() -> Iterator[List[dict]]:
    """Collect one dict per LayerNorm + Linear pair and per attention."""
    out: List[dict] = []
    token = _RECORD.set(out)
    try:
        yield out
    finally:
        _RECORD.reset(token)


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    """The model the records that follow belong to (``unet``, ``clip``...)."""
    token = _SCOPE.set(name)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def _record(**fields) -> None:
    out = _RECORD.get()
    if out is not None:
        out.append(dict(scope=_SCOPE.get(), **fields))


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in x's type;
    the gradient passes straight through the rounding."""
    if x.device.type == "meta":
        return x
    with torch.no_grad():
        scale = x.abs().amax().float().clamp(min=1e-12) / FP8_MAX
        q = ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return q if not x.requires_grad else x + (q - x).detach()


def _q(*xs: Optional[torch.Tensor]):
    if _PRECISION.get() != "fp8":
        return xs
    return tuple(None if x is None else fake_fp8(x) for x in xs)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    x, weight = _q(x, weight)
    return F.linear(x, weight, bias)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Channels-last [N, H, W, C] in and out."""
    x, weight = _q(x, weight)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding)
    return y.permute(0, 2, 3, 1)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _q(a, b)
    return torch.matmul(a, b)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm over every non-leading axis of a channels-last [N, ..., C]."""
    N, C = x.shape[0], x.shape[-1]
    xg = x.reshape(N, -1, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * weight + bias
    return F.silu(y) if silu else y


def layer_norm(x: torch.Tensor, norm: torch.nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), norm.weight, norm.bias, norm.eps)


def ln_linear(x: torch.Tensor, norm: torch.nn.LayerNorm,
              layers: Sequence[torch.nn.Linear]) -> List[torch.Tensor]:
    """LayerNorm, then each Linear of ``layers`` on the normed tokens: one
    LayerNorm + Linear pair of T tokens of C channels into K outputs in all."""
    T = x.numel() // x.shape[-1]
    _record(op="ln_linear", T=T, C=x.shape[-1], K=sum(m.out_features for m in layers))
    h = layer_norm(x, norm)
    return [linear(h, m.weight, m.bias) for m in layers]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              bias: Optional[torch.Tensor] = None, kind: str = "self",
              routed: bool = False) -> torch.Tensor:
    """Multi-head attention of token-major q [B, Lq, C], k / v [B, Lk, C]
    with an optional additive bias [B, Lq, Lk]; softmax in float32."""
    B, Lq, C = q.shape
    Lk = k.shape[1]
    D = C // heads
    _record(op="attention", kind=kind, B=B, heads=heads, Lq=Lq, Lk=Lk, D=D,
            bias=bias is not None, routed=routed,
            grad=torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)))

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, D).transpose(1, 2)

    logits = matmul(split(q), split(k).transpose(-1, -2)) * (1.0 / math.sqrt(D))
    if bias is not None:
        logits = logits + bias[:, None]
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return matmul(probs, split(v)).transpose(1, 2).reshape(B, Lq, C)


def temporal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int) -> torch.Tensor:
    """Attention over the frame axis of pixel-major [B, N, F, C] tokens."""
    B, N, Fr, C = q.shape
    _record(op="attention", kind="temporal", B=B * N, heads=heads, Lq=Fr, Lk=Fr,
            D=C // heads, bias=False, routed=False,
            grad=torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)))
    flat = [t.reshape(B * N, Fr, C) for t in (q, k, v)]
    D = C // heads

    def split(t):
        return t.reshape(B * N, Fr, heads, D).transpose(1, 2)

    logits = matmul(split(flat[0]), split(flat[1]).transpose(-1, -2)) * (1.0 / math.sqrt(D))
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    out = matmul(probs, split(flat[2])).transpose(1, 2)
    return out.reshape(B, N, Fr, C)
