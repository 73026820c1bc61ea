"""LayerNorm -> matmul — port of ``cvd_tpu/ops/ln_matmul.py``.

Every transformer block runs LayerNorm straight into one or more
projections of the same normalized tokens (fused q/k/v, the cross-attention
q, the GEGLU input). The LayerNorm affine folds into the weights:

    LN(x) @ W^T = x_hat @ (W * gamma)^T + W @ beta      (+ W's bias)

so the kernel only standardizes (mean/var over C, f32 stats) and multiplies
the folded weight. On CUDA tensors ``layer_norm_matmul`` launches
``csrc/ln_matmul_fwd.cu`` (kernel K5); on CPU tensors it runs the plain
LayerNorm-then-matmul version ``_reference``. The backward is autograd of
``_reference`` on both devices, so the folding stays inside the CUDA
forward and the gradients reach the unfolded gamma, beta, W_i and b_i.

The fold is cached per layer (``folded``): it is redone only when one of
gamma, beta, the W_i or the b_i has been written (an optimizer step, a
``load_state_dict``) or replaced, so a sampler folds each layer once.

Weights are in torch ``nn.Linear`` layout, [K_i, C].
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from cvd_tpu_torch.ops import PLAIN_DEVICES, _build
from cvd_tpu_torch.ops.norms import _vjp_of

_SIGNATURE = {"ln_matmul_fwd": [
    _build.I, _build.P, _build.L, _build.P, _build.P, _build.P, _build.P, _build.L,
    _build.I, _build.I, _build.I, _build.F, _build.P,
]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C_BF16 = 1280  # the widest token the bf16 kernels take
_PANEL_MAX_C = 320  # the widest token of the 128-row panel kernel


def kernel_route(T: int, C: int, K: int, dtype: str) -> str:
    """Which device kernel K5 launches for T tokens of C channels into K
    outputs in ``dtype`` ("float32" or "bfloat16"): ``"panel"``
    (``ln_matmul_bf16_kernel<PANEL, TNW>``: a block's tokens held whole in
    shared memory, up to C 320), ``"wide"`` (``ln_matmul_bf16_kernel_wide_stats``
    then ``ln_matmul_bf16_kernel_wide``: 128-token tiles with x and W'
    streamed, C 328 to 1280, any T) or ``"f32"`` (``ln_stats_kernel`` +
    ``ln_matmul_f32_kernel``). Raises where the wrapper raises. Plain
    arithmetic on the shapes, nothing else."""
    if dtype not in ("float32", "bfloat16"):
        raise TypeError(f"ln_matmul kernel takes f32 or bf16, got {dtype}")
    if T < 0 or C < 1 or K < 1:
        raise ValueError(f"ln_matmul kernel: no route for T={T} C={C} K={K}")
    if C % (4 if dtype == "float32" else 8):
        raise ValueError(f"C={C} is not a multiple of 16 bytes")
    if dtype == "float32":
        return "f32"
    if C > _MAX_C_BF16 or K % 8:
        raise ValueError(f"the bf16 ln_matmul kernel takes C <= {_MAX_C_BF16} and K a "
                         f"multiple of 8, got C={C} K={K}")
    return "wide" if C > _PANEL_MAX_C else "panel"


def fold_weights(gamma: torch.Tensor, beta: torch.Tensor,
                 weights: Sequence[torch.Tensor],
                 biases: Sequence[Optional[torch.Tensor]],
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (W' [K, C] in ``dtype``, b' [K] f32) with W' = W * gamma and
    b' = W @ beta + b, computed in f32 (ln_matmul.py:183-195)."""
    w_all = torch.cat([w.float() for w in weights], dim=0)
    w_folded = w_all * gamma.float()[None, :]
    b_extra = torch.cat([
        b.float() if b is not None
        else torch.zeros(w.shape[0], device=w.device, dtype=torch.float32)
        for w, b in zip(weights, biases)
    ])
    b_folded = w_all @ beta.float() + b_extra
    return w_folded.to(dtype).contiguous(), b_folded.contiguous()


def _stamp(t: Optional[torch.Tensor]):
    """What a cached fold depends on: the tensor's storage, and the counter
    that every in-place write bumps."""
    if t is None:
        return None
    version = 0 if t.is_inference() else t._version  # inference tensors keep no counter
    return (t.data_ptr(), version)


_FOLDS: Dict[tuple, tuple] = {}


def folded(gamma: torch.Tensor, beta: torch.Tensor,
           weights: Sequence[torch.Tensor],
           biases: Sequence[Optional[torch.Tensor]],
           dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_weights`` through a cache keyed by the identity of the source
    tensors: the same (W', b') objects come back until one of the sources
    has been written in place (its ``_version`` moved), moved or replaced.
    An entry goes when one of its tensors is collected."""
    tensors = (gamma, beta, *weights, *biases)
    key = (*(id(t) for t in tensors), dtype)
    stamps = tuple(_stamp(t) for t in tensors)
    hit = _FOLDS.get(key)
    if hit is not None and hit[0] == stamps and all(r() is t for r, t in zip(hit[1], tensors)
                                                    if t is not None):
        return hit[2]
    with torch.no_grad():
        value = fold_weights(gamma, beta, weights, biases, dtype)

    def drop(_, key=key):
        _FOLDS.pop(key, None)

    refs = tuple(None if t is None else weakref.ref(t, drop) for t in tensors)
    _FOLDS[key] = (stamps, refs, value)
    return value


def _reference(x, gamma, beta, weights, biases, eps):
    """LayerNorm (f32 stats) then one matmul over the concatenated weights."""
    dtype = x.dtype
    y = F.layer_norm(x.float(), (x.shape[-1],), gamma.float(), beta.float(), eps).to(dtype)
    w_all = torch.cat([w.to(dtype) for w in weights], dim=0)
    b_all = torch.cat([
        b.to(dtype) if b is not None
        else torch.zeros(w.shape[0], device=x.device, dtype=dtype)
        for w, b in zip(weights, biases)
    ])
    return F.linear(y, w_all, b_all)


def _launch(x2, w_folded, b_folded, eps):
    if x2.dtype not in _DTYPES or w_folded.dtype != x2.dtype:
        raise TypeError(f"ln_matmul kernel takes f32 or bf16, got {x2.dtype}")
    T, C = x2.shape
    K = w_folded.shape[0]
    route = kernel_route(T, C, K, str(x2.dtype)[6:])  # raises on what no kernel takes
    if x2.stride(-1) != 1 or (x2.stride(0) * x2.element_size()) % 16 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    out = torch.empty((T, K), device=x2.device, dtype=x2.dtype)
    # per-token mean / rstd scratch: the f32 and wide paths (the panel keeps them on chip)
    stats = None if route == "panel" else torch.empty((T, 2), device=x2.device,
                                                      dtype=torch.float32)
    lib = _build.library("ln_matmul_fwd", _SIGNATURE)
    err = lib.ln_matmul_fwd(
        _DTYPES[x2.dtype], x2.data_ptr(), x2.stride(0), w_folded.data_ptr(),
        b_folded.data_ptr(), None if stats is None else stats.data_ptr(), out.data_ptr(),
        out.stride(0), T, C, K, eps, torch.cuda.current_stream(x2.device).cuda_stream,
    )
    _build.check(err, "ln_matmul_fwd")
    return out


def _fused(x, gamma, beta, weights, biases, eps):
    """Fold (cached), then K5 over [T, C] tokens -> [..., sum K_i]."""
    C = x.shape[-1]
    w_folded, b_folded = folded(gamma, beta, weights, biases, x.dtype)
    out = _launch(x.reshape(-1, C), w_folded, b_folded, eps)
    return out.reshape(*x.shape[:-1], w_folded.shape[0])


class _LnMatmulFn(torch.autograd.Function):
    """Folding + K5 forward; backward = autograd of the plain LayerNorm then
    matmul (ln_matmul.py:117-120), so the gradients reach the unfolded
    gamma, beta, W_i and b_i. Inputs: x, gamma, beta, W_1..W_n, b_1..b_n."""

    @staticmethod
    def forward(ctx, n, eps, x, gamma, beta, *wb):
        ctx.save_for_backward(x, gamma, beta, *wb)
        ctx.n, ctx.eps = n, eps
        return _fused(x, gamma, beta, wb[:n], wb[n:], eps)

    @staticmethod
    def backward(ctx, g):
        n, eps = ctx.n, ctx.eps

        def plain(x, gamma, beta, *wb):
            return _reference(x, gamma, beta, wb[:n], wb[n:], eps)

        grads = _vjp_of(plain, ctx.saved_tensors, ctx.needs_input_grad[2:], g)
        return (None, None, *grads)


def layer_norm_matmul(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[Optional[torch.Tensor]],
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, ...]:
    """(LayerNorm(x) @ W_i^T + b_i for each W_i), x [..., C], W_i [K_i, C];
    one fused kernel over the concatenated weights on CUDA."""
    sizes = [w.shape[0] for w in weights]
    if x.device.type in PLAIN_DEVICES:
        out = _reference(x, gamma, beta, weights, biases, eps)
    elif x.device.type == "cuda":
        inputs = (x, gamma, beta, *weights, *biases)
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
            out = _LnMatmulFn.apply(len(weights), float(eps), *inputs)
        else:
            out = _fused(x, gamma, beta, weights, biases, float(eps))
        layer_norm_matmul.launches += 1
        route = kernel_route(x.numel() // x.shape[-1], x.shape[-1], out.shape[-1],
                             str(x.dtype)[6:])
        layer_norm_matmul.routes[route] += 1
    else:
        raise ValueError(f"layer_norm_matmul: no kernel for {x.device}")
    return tuple(torch.split(out, sizes, dim=-1))


layer_norm_matmul.launches = 0
layer_norm_matmul.routes = {"panel": 0, "wide": 0, "f32": 0}  # launches by kernel_route
