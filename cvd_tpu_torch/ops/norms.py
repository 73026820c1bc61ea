"""GroupNorm (+ optional fused SiLU) — port of ``cvd_tpu/ops/norms.py``.

``group_norm`` normalizes x [R, ..., C] (channels last) over all non-leading
dims per group of channels, with f32 statistics, a per-channel affine and
an optional SiLU. On CPU tensors it runs the plain PyTorch version
``_reference``; on CUDA tensors it launches the Triton kernel K4 below.
Its backward is autograd of ``_reference`` on both devices: the JAX package
has no GroupNorm backward kernel either.

Kernel K4 replaces cvd_tpu/ops/norms.py:_gn_kernel (the Pallas TPU kernel
behind group_norm). What bounds it on the H100 is memory bandwidth: ~10
flops per element against, at best, one read and one write of x. A TPU
block holds a whole [S, C] row in VMEM and reads x once; here the unit that
fits a block is the slab of one (row, group), [S, C/G], and two paths
follow, chosen by ``plan`` from the shape alone:

  * one pass, for slabs that fit a block (every GroupNorm of the SD1.5 UNet
    at 256 px: 20 to 60 KB in bf16). ``_gn_one_pass``: one launch, grid
    (row x bundle of neighbouring groups). A program loads its
    [S, bundle x C/G] slab once and holds it in registers (up to 32 K
    elements over 16 warps), takes the sums per group, normalizes, applies
    the affine and the SiLU from the values it holds and stores in the
    input type: x is read once and written once. Groups are bundled while
    a pixel's contiguous piece is under 128 bytes, the slab still fits and
    the grid still has a program for every SM; programs of neighbouring
    bundles run side by side, so the sectors they share are fetched from
    device memory once.
  * split, for rows no block can hold (the VAE: S x C ~ 8.4 M elements a
    row), three launches and two reads of x: ``_gn_partial``, grid (row x
    group, split), sums one slice of the group's elements into a scratch
    buffer; ``_gn_finalize``, grid (row x group), merges the partial sums
    into mean and 1/std; ``_gn_apply``, grid (row, pixel tile), normalizes,
    applies the affine and the SiLU.

Statistics stay in f32. For a steadier variance than E[x^2] - E[x]^2 (the
TPU kernel's form, norms.py:64-66) the sums are taken of x - x0, with x0
the group's first element, which removes the cancellation when |mean| is
large against the spread. ``triton`` is imported inside the launcher: a
machine without it can import this module, and ``plan`` is plain arithmetic.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cvd_tpu_torch.ops import PLAIN_DEVICES


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

    @triton.jit
    def _gn_one_pass(x_ptr, y_ptr, gamma_ptr, beta_ptr, S, C, cg, G, inv_n, eps,
                     BUNDLE: tl.constexpr, SILU: tl.constexpr,
                     BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        bundles = G // BUNDLE
        r = pid // bundles
        c0 = (pid % bundles) * BUNDLE * cg
        offs_s = tl.arange(0, BLOCK_S)
        offs_c = tl.arange(0, BLOCK_C)
        cmask = offs_c < BUNDLE * cg
        grp = offs_c // cg  # the column's group within the bundle
        base = r.to(tl.int64) * S * C + c0
        m = (offs_s[:, None] < S) & cmask[None, :]
        offs = offs_s[:, None] * C + offs_c[None, :]
        xv = tl.load(x_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
        shift = tl.load(x_ptr + base + grp * cg, mask=cmask, other=0.0).to(tl.float32)
        d = tl.where(m, xv - shift[None, :], 0.0)
        col1 = tl.sum(d, axis=0)
        col2 = tl.sum(d * d, axis=0)
        mean_d = tl.zeros([BLOCK_C], tl.float32)
        rstd = tl.zeros([BLOCK_C], tl.float32)
        for gi in tl.static_range(BUNDLE):
            gm = cmask & (grp == gi)
            m1 = tl.sum(tl.where(gm, col1, 0.0), axis=0) * inv_n
            var = tl.maximum(tl.sum(tl.where(gm, col2, 0.0), axis=0) * inv_n - m1 * m1, 0.0)
            mean_d = tl.where(gm, m1, mean_d)
            rstd = tl.where(gm, 1.0 / tl.sqrt(var + eps), rstd)
        gamma = tl.load(gamma_ptr + c0 + offs_c, mask=cmask, other=0.0).to(tl.float32)
        beta = tl.load(beta_ptr + c0 + offs_c, mask=cmask, other=0.0).to(tl.float32)
        y = (d - mean_d[None, :]) * (gamma * rstd)[None, :] + beta[None, :]
        if SILU:
            y = y * tl.sigmoid(y)
        tl.store(y_ptr + base + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    return _gn_partial, _gn_finalize, _gn_apply, _gn_one_pass


def _next_pow2(n: int, floor: int = 2) -> int:
    return max(floor, 1 << max(n - 1, 0).bit_length())


# the most elements (padded to powers of two) a one-pass block holds in
# registers: 64 f32 values a thread over 16 warps
ONE_PASS_MAX_BLOCK = 32768
# a pixel's contiguous piece of a bundle is grown towards this many bytes (a
# cache line)
PIECE_BYTES = 128


class Plan(NamedTuple):
    """How K4 runs a shape. ``one_pass``: grid R * groups / bundle, a block of
    [block_s, block_c] over ``num_warps`` warps holds the slab. Split path:
    ``_gn_partial`` over [block_s, block_c] tiles of a group's channels,
    ``nsplit`` programs of ``s_per_split`` pixels a (row, group); ``_gn_apply``
    over [apply_block_s, apply_block_c] tiles of whole rows of pixels."""
    one_pass: bool
    bundle: int
    block_s: int
    block_c: int
    num_warps: int = 0
    nsplit: int = 0
    s_per_split: int = 0
    apply_block_s: int = 0
    apply_block_c: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(R: int, S: int, C: int, groups: int, itemsize: int, sm_count: int) -> Plan:
    """The path and block sizes of K4 for x [R, S, C] in ``groups`` groups,
    from the shape alone (``itemsize`` bytes an element, ``sm_count`` SMs)."""
    cg = C // groups
    block_s = _next_pow2(S)

    def fits(bundle):
        return block_s * _next_pow2(bundle * cg) <= ONE_PASS_MAX_BLOCK

    if fits(1):
        bundle = 1
        while (bundle * cg * itemsize < PIECE_BYTES and groups % (2 * bundle) == 0
               and fits(2 * bundle) and R * groups // (2 * bundle) >= sm_count):
            bundle *= 2
        block_c = _next_pow2(bundle * cg)
        # 64 values a thread; small slabs take fewer warps
        return Plan(True, bundle, block_s, block_c, max(1, min(16, block_s * block_c // 2048)))
    block_cg = _next_pow2(cg)
    block_s = max(16, 4096 // block_cg)
    # enough programs to fill the card: about 8 per SM in the stats pass
    nsplit = max(1, min(_cdiv(S, block_s), (8 * sm_count) // (R * groups) or 1))
    s_per_split = _cdiv(_cdiv(S, nsplit), block_s) * block_s
    block_c = _next_pow2(C)
    return Plan(False, 1, block_s, block_cg, 0, _cdiv(S, s_per_split), s_per_split,
                max(1, 8192 // block_c), block_c)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_one_pass(x3, y, gamma, beta, groups, eps, act, p: Plan):
    """The one-pass kernel on contiguous inputs -> Triton's compiled kernel."""
    R, S, C = x3.shape
    cg = C // groups
    *_, one_pass = _kernels()
    return one_pass[(R * groups // p.bundle,)](
        x3, y, gamma, beta, S, C, cg, groups, 1.0 / (S * cg), eps, BUNDLE=p.bundle,
        SILU=act == "silu", BLOCK_S=p.block_s, BLOCK_C=p.block_c, num_warps=p.num_warps)


def _launch(x3, gamma, beta, groups, eps, act):
    partial, finalize, apply, _ = _kernels()
    R, S, C = x3.shape
    cg = C // groups
    x3 = x3.contiguous()
    gamma = gamma.contiguous()
    beta = beta.contiguous()
    p = plan(R, S, C, groups, x3.element_size(), _sm_count(x3.device))
    y = torch.empty_like(x3)
    if p.one_pass:
        _launch_one_pass(x3, y, gamma, beta, groups, eps, act, p)
        return y
    part = torch.empty((R * groups, p.nsplit, 2), device=x3.device, dtype=torch.float32)
    stats = torch.empty((R * groups, 2), device=x3.device, dtype=torch.float32)
    partial[(R * groups, p.nsplit)](x3, part, S, C, cg, groups, p.nsplit, p.s_per_split,
                                    BLOCK_S=p.block_s, BLOCK_CG=p.block_c, num_warps=4)
    finalize[(R * groups,)](x3, part, stats, S, C, cg, groups, p.nsplit, 1.0 / (S * cg), eps,
                            BLOCK_SPLIT=_next_pow2(p.nsplit), num_warps=1)
    apply[(R, _cdiv(S, p.apply_block_s))](x3, y, stats, gamma, beta, S, C, cg, groups,
                                          SILU=act == "silu", BLOCK_S=p.apply_block_s,
                                          BLOCK_C=p.apply_block_c, num_warps=8)
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
    if x.device.type in PLAIN_DEVICES:
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
