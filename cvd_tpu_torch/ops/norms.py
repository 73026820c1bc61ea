"""GroupNorm (+ optional fused SiLU) — port of ``cvd_tpu/ops/norms.py``.

``group_norm`` normalizes x [R, ..., C] (channels last) over all non-leading
dims per group of channels, with f32 statistics, a per-channel affine and
an optional SiLU. On CPU tensors it runs the plain PyTorch version
``_reference``; on CUDA tensors it launches the Triton kernel K4 below.
Its backward is autograd of ``_reference`` on both devices: the JAX package
has no GroupNorm backward kernel either.

Kernel K4 replaces cvd_tpu/ops/norms.py:_gn_kernel (the Pallas TPU kernel
behind group_norm). What bounds it on the H100 is memory bandwidth: ~10
flops per element against one read for the statistics and one read and
write for the normalization. A TPU block holds a whole [S, C] row in VMEM;
here a VAE row (S*C ~ 8.4 M elements) is far larger than a Triton block,
so the reduction is split across blocks:

  1. ``_gn_partial``: grid (row x group, split); each program sums one
     slice of the group's [S, C/G] elements into a scratch buffer;
  2. ``_gn_finalize``: grid (row x group); merges the partial sums into
     mean and 1/std per (row, group);
  3. ``_gn_apply``: grid (row, pixel tile); normalizes, applies the affine
     and the SiLU, and stores in the input type.

Statistics stay in f32. For a steadier variance than E[x^2] - E[x]^2 (the
TPU kernel's form, norms.py:64-66) the partial sums are taken of
x - x0, with x0 the group's first element, which removes the cancellation
when |mean| is large against the spread. ``triton`` is imported inside the
launcher: a machine without it can import this module.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


def _reference(x3: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int, eps: float, act: Optional[str]) -> torch.Tensor:
    """Plain GroupNorm (+ optional SiLU) over [R, S, C], stats in f32."""
    R, S, C = x3.shape
    xf = x3.float().reshape(R, S, groups, C // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(R, S, C) * gamma.float() + beta.float()
    if act == "silu":
        y = F.silu(y)
    return y.to(x3.dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Compile-on-first-use Triton kernels (imported here, not at module
    import, so CPU-only machines can import the module)."""
    import triton
    import triton.language as tl

    @triton.jit
    def _gn_partial(x_ptr, part_ptr, S, C, cg, G, NSPLIT, s_per_split,
                    BLOCK_S: tl.constexpr, BLOCK_CG: tl.constexpr):
        rg = tl.program_id(0)
        sp = tl.program_id(1)
        r = rg // G
        g = rg % G
        base = x_ptr + r.to(tl.int64) * S * C + g * cg
        shift = tl.load(base).to(tl.float32)
        offs_c = tl.arange(0, BLOCK_CG)
        cmask = offs_c < cg
        s0 = sp * s_per_split
        s_end = tl.minimum(s0 + s_per_split, S)
        acc1 = tl.zeros([BLOCK_S, BLOCK_CG], tl.float32)
        acc2 = tl.zeros([BLOCK_S, BLOCK_CG], tl.float32)
        for s in range(s0, s_end, BLOCK_S):
            offs_s = s + tl.arange(0, BLOCK_S)
            m = (offs_s[:, None] < s_end) & cmask[None, :]
            ptrs = base + offs_s[:, None].to(tl.int64) * C + offs_c[None, :]
            xv = tl.load(ptrs, mask=m, other=0.0).to(tl.float32)
            d = tl.where(m, xv - shift, 0.0)
            acc1 += d
            acc2 += d * d
        s1 = tl.sum(tl.sum(acc1, axis=1), axis=0)
        s2 = tl.sum(tl.sum(acc2, axis=1), axis=0)
        out = part_ptr + (rg * NSPLIT + sp) * 2
        tl.store(out, s1)
        tl.store(out + 1, s2)

    @triton.jit
    def _gn_finalize(x_ptr, part_ptr, stats_ptr, S, C, cg, G, NSPLIT, inv_n, eps,
                     BLOCK_SPLIT: tl.constexpr):
        rg = tl.program_id(0)
        r = rg // G
        g = rg % G
        shift = tl.load(x_ptr + r.to(tl.int64) * S * C + g * cg).to(tl.float32)
        offs = tl.arange(0, BLOCK_SPLIT)
        m = offs < NSPLIT
        s1 = tl.sum(tl.load(part_ptr + (rg * NSPLIT + offs) * 2, mask=m, other=0.0), axis=0)
        s2 = tl.sum(tl.load(part_ptr + (rg * NSPLIT + offs) * 2 + 1, mask=m, other=0.0), axis=0)
        mean_d = s1 * inv_n
        var = tl.maximum(s2 * inv_n - mean_d * mean_d, 0.0)
        tl.store(stats_ptr + rg * 2, shift + mean_d)
        tl.store(stats_ptr + rg * 2 + 1, 1.0 / tl.sqrt(var + eps))

    @triton.jit
    def _gn_apply(x_ptr, y_ptr, stats_ptr, gamma_ptr, beta_ptr, S, C, cg, G,
                  SILU: tl.constexpr, BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        r = tl.program_id(0)
        s0 = tl.program_id(1) * BLOCK_S
        offs_c = tl.arange(0, BLOCK_C)
        cmask = offs_c < C
        grp = r * G + offs_c // cg
        mean = tl.load(stats_ptr + grp * 2, mask=cmask, other=0.0)
        rstd = tl.load(stats_ptr + grp * 2 + 1, mask=cmask, other=0.0)
        gamma = tl.load(gamma_ptr + offs_c, mask=cmask, other=0.0).to(tl.float32)
        beta = tl.load(beta_ptr + offs_c, mask=cmask, other=0.0).to(tl.float32)
        scale = gamma * rstd
        shift = beta - mean * scale
        offs_s = s0 + tl.arange(0, BLOCK_S)
        m = (offs_s[:, None] < S) & cmask[None, :]
        offs = r.to(tl.int64) * S * C + offs_s[:, None].to(tl.int64) * C + offs_c[None, :]
        xv = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        y = xv * scale[None, :] + shift[None, :]
        if SILU:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    return triton, _gn_partial, _gn_finalize, _gn_apply


def _next_pow2(n: int, floor: int = 2) -> int:
    return max(floor, 1 << max(n - 1, 0).bit_length())


def _launch(x3, gamma, beta, groups, eps, act):
    triton, partial, finalize, apply = _kernels()
    R, S, C = x3.shape
    cg = C // groups
    x3 = x3.contiguous()
    gamma = gamma.contiguous()
    beta = beta.contiguous()
    block_cg = _next_pow2(cg)
    block_s = max(16, 4096 // block_cg)
    # enough programs to fill the card: about 8 per SM in the stats pass
    sms = torch.cuda.get_device_properties(x3.device).multi_processor_count
    nsplit = max(1, min(triton.cdiv(S, block_s), (8 * sms) // (R * groups) or 1))
    s_per_split = triton.cdiv(triton.cdiv(S, nsplit), block_s) * block_s
    nsplit = triton.cdiv(S, s_per_split)
    part = torch.empty((R * groups, nsplit, 2), device=x3.device, dtype=torch.float32)
    stats = torch.empty((R * groups, 2), device=x3.device, dtype=torch.float32)
    y = torch.empty_like(x3)
    partial[(R * groups, nsplit)](x3, part, S, C, cg, groups, nsplit, s_per_split,
                                  BLOCK_S=block_s, BLOCK_CG=block_cg, num_warps=4)
    finalize[(R * groups,)](x3, part, stats, S, C, cg, groups, nsplit, 1.0 / (S * cg), eps,
                            BLOCK_SPLIT=_next_pow2(nsplit), num_warps=1)
    block_c = _next_pow2(C)
    block_s2 = max(1, 8192 // block_c)
    apply[(R, triton.cdiv(S, block_s2))](x3, y, stats, gamma, beta, S, C, cg, groups,
                                         SILU=act == "silu", BLOCK_S=block_s2,
                                         BLOCK_C=block_c, num_warps=8)
    return y


def _vjp_of(fn, inputs, needs, g):
    """Gradients of ``fn(*inputs)`` for the inputs flagged in ``needs``
    (None elsewhere): a backward that is autograd of the plain version, as
    the JAX package's custom_vjps take ``jax.vjp`` of their reference."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if t is not None else None
                  for t, n in zip(inputs, needs)]
        wanted = [t for t, n in zip(leaves, needs) if n and t is not None]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, g) if wanted else ())
        return tuple(next(grads) if n and t is not None else None
                     for t, n in zip(leaves, needs))


class _GroupNormFn(torch.autograd.Function):
    """K4 forward; backward = autograd of ``_reference`` (norms.py:166-172:
    the JAX package has no GroupNorm backward kernel either)."""

    @staticmethod
    def forward(ctx, x3, gamma, beta, groups, eps, act):
        ctx.save_for_backward(x3, gamma, beta)
        ctx.args = (groups, eps, act)
        return _launch(x3, gamma, beta, groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        grads = _vjp_of(lambda x_, g_, b_: _reference(x_, g_, b_, *ctx.args),
                        ctx.saved_tensors, ctx.needs_input_grad[:3], g)
        return (*grads, None, None, None)


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm over all non-leading dims of ``x`` [R, ..., C] (+ SiLU)."""
    R, C = x.shape[0], x.shape[-1]
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    if act not in (None, "silu"):
        raise ValueError(f"act={act!r}")
    x3 = x.reshape(R, -1, C)
    if x.device.type == "cpu":
        return _reference(x3, gamma, beta, num_groups, float(eps), act).reshape(x.shape)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm kernel takes f32 or bf16, got {x.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x3, gamma, beta)):
        y = _GroupNormFn.apply(x3, gamma, beta, num_groups, float(eps), act)
    else:
        y = _launch(x3, gamma, beta, num_groups, float(eps), act)
    group_norm.launches += 1
    return y.reshape(x.shape)


group_norm.launches = 0
