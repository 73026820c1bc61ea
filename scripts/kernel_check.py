#!/usr/bin/env python3
"""Short check of the redesigned bf16 kernels (K1/K2 ``epi_flash_fwd``, K5
``ln_matmul_fwd``, K6 ``epi_flash_bwd``, K4 ``group_norm``, K3
``temporal_attn_fwd``, K7 ``temporal_attn_bwd``) on one NVIDIA GPU: the
first thing to run after editing a source, before the longer
``chip_smoke.py``.

    python3 scripts/kernel_check.py [epi_flash_fwd] [ln_matmul_fwd]
        [epi_flash_bwd] [group_norm] [temporal_attn_fwd] [temporal_attn_bwd]
        [--phases] [--root DIR]

For each named kernel (default: all) it
1. compiles a CUDA source with ``-Xptxas -v`` and prints, per bf16 kernel,
   registers and spills, and any ptxas remark (C7514 / C7517 / C7518 say
   that wgmma was serialized); the full output goes to
   ``chiprun_out/ptxas_<name>.txt``. For K4 (Triton) it prints the registers
   and spills that Triton reports for the one-pass kernel;
2. holds the kernel against its plain version at the edges (64 tokens,
   head_dim 8 to 160, ragged lengths, strided q/k/v views, a row routed to
   twice and a row never routed to, C 32 to 1280; for K4 every slab of the
   SD1.5 UNet, C/G not a power of two, S off the block; for K3 / K7 frames
   below and above the 16-row tile, head_dim 8 to 160, masks, q/k/v as
   ``split`` views of one fused projection, a strided dO, and the f32
   kernels) with the limit of ``chip_smoke.py`` (2e-2 x max(1, max|plain|),
   1e-4 in f32), and K1/K2's lse against f32 logits;
3. times it (CUDA events, after warm-up, twice) at the main paths' shapes
   beside one PyTorch library call for the same function (K3 / K7: on
   contiguous q/k/v and on the split views the motion module hands over,
   the kernel from a replayed CUDA graph of 20 launches, because the host's
   cost of a launch exceeds their time; then the same kernel with 2, 4 or 8
   heads a block, which is what chose ``head_group``'s cap of 640 bytes).
``--phases`` also builds K5 with ``-DLNMM_PROF`` and prints the clock cycles a
block spends per phase (panel copy, standardization, product loop; inside
the loop: epilogue, waits for copies, waits for wgmma), as warpgroup 0's
thread 0 sees them. ``--root DIR`` only times the wrappers of K5, K6, K4, K3
and K7 (those named, default all five), at the same shapes, as another checkout
of the repository has them (the parent commit unpacked into a git-ignored
directory), so that two versions are compared inside one call on one card.
Exits non-zero if anything disagrees.
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import (  # noqa: E402  (imports no torch itself)
    TEMPORAL_EDGES, _layout, _random_geometry, _temporal_inputs, _temporal_mask,
    _time_captured_ms,
)

TOL = 2e-2
CUDA_SOURCES = ("epi_flash_fwd", "ln_matmul_fwd", "epi_flash_bwd", "temporal_attn_fwd",
                "temporal_attn_bwd")


def _time_ms(torch, fn, iters=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def ptxas_report(_build, names):
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    scratch = os.path.join(HERE, "build", "kernels")
    os.makedirs(scratch, exist_ok=True)
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(scratch, f"ptxas_{n}.so"), str(_build.CSRC / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n in names}
    for n, p in procs.items():
        text, _ = p.communicate()
        with open(os.path.join(out_dir, f"ptxas_{n}.txt"), "w") as f:
            f.write(text)
        print(f"== {n}: nvcc rc {p.returncode}, {time.time() - t0:.1f} s")
        if p.returncode:
            print(text[-6000:])
            raise SystemExit(1)
        lines = text.splitlines()
        for i, line in enumerate(lines):
            if "(C75" in line:
                print("  " + line[:160])
            if "Compiling entry function" in line and ("bf16" in line or "_mma_" in line):
                # the mangled name holds the template arguments: ...kernelILb1ELi5EE...
                name = re.search(r"((?:epi_flash_fwd|epi_flash_bwd_dq|epi_flash_bwd_dkdv|ln_matmul|"
                                 r"temporal_attn_fwd|temporal_attn_bwd)"
                                 r"_(?:bf16|mma)_kernel(?:_wide(?:_stats)?)?(?:I(?:L[bi]\d+E)+)?)",
                                 line)
                print("  " + (name.group(1) if name else line), "|", lines[i + 2].strip(), "|",
                      lines[i + 3].strip())


def check_epi_flash(torch, g):
    import torch.nn.functional as F

    from cvd_tpu_torch.geometry.epipolar_mask import (
        epipolar_lines, lines_and_band, pixel_grid_coords,
    )
    from cvd_tpu_torch.ops import epi_flash

    dev = "cuda"

    def randn(*s):
        return torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)

    def geometry(B, feat):
        Fm = torch.randn(B, 3, 3, generator=g, device=dev) * 1e-3
        coords = pixel_grid_coords(feat, 256, dev)
        lines, band, alpha = lines_and_band(epipolar_lines(Fm, coords), feat, 256)
        return lines, coords[:, :2].T.contiguous(), band, alpha

    bad = 0
    # (B, Lq, Lk, C, heads, bias, routed, q/k/v as views of one fused projection)
    for B, Lq, Lk, C, h, bias, routed, strided in [
            (8, 1024, 1024, 320, 8, True, True, True), (8, 1024, 1024, 320, 8, False, False, True),
            (4, 64, 64, 1280, 8, True, True, False), (4, 64, 64, 1280, 8, False, False, True),
            (4, 200, 150, 320, 8, False, False, False), (4, 256, 256, 640, 8, True, True, True),
            (2, 256, 256, 64, 4, False, False, False), (2, 256, 256, 32, 4, True, False, False),
            (2, 130, 130, 384, 8, False, False, False)]:
        if strided:
            q, k, v = randn(B, Lq, 3 * C).split(C, -1)
        else:
            q, k, v = randn(B, Lq, C), randn(B, Lk, C), randn(B, Lk, C)
        geom = geometry(B, int(round(math.sqrt(Lq)))) if bias else None
        route = (torch.cat([torch.arange(B // 2, B), torch.arange(0, B // 2)])
                 .to(dev, torch.int32) if routed else None)
        out, lse = epi_flash._launch(*epi_flash._prepare(q, k, v, geom, route, h), h)
        torch.cuda.synchronize()
        want = epi_flash._plain(q.float(), k.float(), v.float(), geom, route, h)
        err = float((out.float() - want).abs().max())
        ref = max(1.0, float(want.abs().max()))
        D = C // h
        kk = k if route is None else k[route.long()]
        logits = torch.einsum("bnhd,bmhd->bhnm", q.float().reshape(B, Lq, h, D),
                              kk.float().reshape(B, Lk, h, D)) / math.sqrt(D)
        if geom is not None:
            logits = logits + epi_flash.bias_from_geometry(*geom)[:, None]
        lse_err = float((torch.logsumexp(logits, -1) - lse).abs().max())
        ok = math.isfinite(err) and err <= TOL * ref and lse_err < TOL
        bad += not ok
        print(f"K1/K2 B{B} Lq{Lq} Lk{Lk} C{C} h{h} bias={bias} routed={routed} "
              f"strided={strided}: err {err:.3e} lse err {lse_err:.3e} "
              f"{'ok' if ok else 'FAILED'}")
    B, N, C, h = 64, 1024, 320, 8
    q, k, v = randn(B, N, 3 * C).split(C, -1)
    route = torch.cat([torch.arange(32, 64), torch.arange(0, 32)]).to(dev, torch.int32)
    p1 = epi_flash._prepare(q, k, v, geometry(B, 32), route, h)
    p2 = epi_flash._prepare(q, k, v, None, None, h)
    qh, kh, vh = (t.reshape(B, N, h, C // h).transpose(1, 2) for t in (q, k, v))
    for _ in range(2):
        print(f"time B{B} N{N} C{C} h{h}: K1 {_time_ms(torch, lambda: epi_flash._launch(*p1, h)):.3f}"
              f" ms  K2 {_time_ms(torch, lambda: epi_flash._launch(*p2, h)):.3f} ms  "
              f"scaled_dot_product_attention (no bias) "
              f"{_time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh)):.3f} ms")
    return bad


def check_ln_matmul(torch, g, _build, phases):
    import torch.nn.functional as F

    from cvd_tpu_torch.ops import ln_matmul

    dev = "cuda"

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(torch.bfloat16)

    def inputs(T, C, K):
        x, gam, bet = randn(T, C), randn(C, scale=0.5) + 1, randn(C, scale=0.1)
        w, b = randn(K, C, scale=1 / math.sqrt(C)), randn(K, scale=0.1)
        return x, gam, bet, w, b, ln_matmul.fold_weights(gam, bet, [w], [b], torch.bfloat16)

    bad = 0
    for T, C, K in [(4096, 320, 960), (1000, 320, 2560), (4096, 640, 5120), (4096, 1280, 3840),
                    (300, 1280, 1280), (512, 32, 96), (777, 64, 256), (65536, 320, 2560),
                    *K5_WIDE_EDGES]:
        x, gam, bet, w, b, (wf, bf) = inputs(T, C, K)
        got = ln_matmul._launch(x, wf, bf, 1e-5)
        torch.cuda.synchronize()
        want = ln_matmul._reference(x.float(), gam.float(), bet.float(), [w.float()],
                                    [b.float()], 1e-5)
        err = float((got.float() - want).abs().max())
        ref = max(1.0, float(want.abs().max()))
        ok = math.isfinite(err) and err <= TOL * ref
        bad += not ok
        print(f"K5 T{T} C{C} K{K} [{ln_matmul.kernel_route(T, C, K, 'bfloat16')}]: err {err:.3e} "
              f"(limit {TOL * ref:.3e}) {'ok' if ok else 'FAILED'}")
    for T, C, K in ((2048, 320, 960), (1000, 1280, 3840)):
        x, gam, bet, w, b, (wf, bf) = inputs(T, C, K)
        xs = torch.cat([x, x], -1)[:, :C]          # a row stride of 2C elements
        same = torch.equal(ln_matmul._launch(xs, wf, bf, 1e-5), ln_matmul._launch(x, wf, bf, 1e-5))
        bad += not same
        print(f"K5 T{T} C{C} K{K} strided x equals contiguous x: {same}")
    if phases:
        so = os.path.join(HERE, "build", "kernels", "ln_matmul_prof.so")
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DLNMM_PROF", "-o", so,
                        str(_build.CSRC / "ln_matmul_fwd.cu")], check=True)
        lib = ctypes.CDLL(so)
        lib.ln_matmul_fwd.argtypes = ln_matmul._SIGNATURE["ln_matmul_fwd"]
        lib.ln_matmul_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for T, C, K in [(65536, 320, 2560), (65536, 320, 960), *K5_TIMED]:
        x, gam, bet, w, b, (wf, bf) = inputs(T, C, K)
        for _ in range(2):
            print(f"time K5 T{T} C{C} K{K}: {_time_ms(torch, lambda: ln_matmul._launch(x, wf, bf, 1e-5)):.3f} ms"
                  f"  layer_norm + linear "
                  f"{_time_ms(torch, lambda: F.linear(F.layer_norm(x, (C,), gam, bet, 1e-5), w, b)):.3f}"
                  f" ms  linear alone {_time_ms(torch, lambda: F.linear(x, w, b)):.3f} ms")
        if phases and ln_matmul.kernel_route(T, C, K, "bfloat16") == "panel":
            out = torch.empty(T, K, device=dev, dtype=torch.bfloat16)
            lib.ln_matmul_prof(None, 1)
            err = lib.ln_matmul_fwd(1, x.data_ptr(), C, wf.data_ptr(), bf.data_ptr(), None,
                                    out.data_ptr(), K, T, C, K, 1e-5,
                                    torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            lib.ln_matmul_prof(buf, 0)
            v = list(buf)
            n = max(v[0], 1)
            print(f"  phases (launch error {err}), {v[0]} blocks, cycles per block: panel copy "
                  f"{v[1] / n:.0f}, standardize {v[2] / n:.0f}, product loop {v[3] / n:.0f} "
                  f"(of it: epilogue {v[4] / n:.0f}, waits for copies {v[5] / n:.0f}, waits for "
                  f"wgmma {v[6] / n:.0f})")
    return bad


def _routes(torch, B, kind):
    """kv_index of B query rows: None, the sampler's swap of the two halves,
    or pairs of rows sharing one source row (odd source rows get no query)."""
    if kind == "swap":
        idx = torch.cat([torch.arange(B // 2, B), torch.arange(0, B // 2)])
    elif kind == "shared":
        idx = torch.arange(B) // 2 * 2
    else:
        return None
    return idx.to("cuda", torch.int32)


def _bwd_inputs(torch, g, B, Lq, Lk, C, h, bias, route, strided, dtype=None):
    from cvd_tpu_torch.ops import epi_flash

    def randn(*s):
        return torch.randn(*s, generator=g, device="cuda").to(dtype or torch.bfloat16)

    if strided:
        q, k, v = randn(B, Lq, 3 * C).split(C, -1)
    else:
        q, k, v = randn(B, Lq, C), randn(B, Lk, C), randn(B, Lk, C)
    geom = _random_geometry(torch, g, B, Lq, Lk) if bias else None
    prep = epi_flash._prepare(q, k, v, geom, _routes(torch, B, route), h)
    out, lse = epi_flash._launch(*prep, h)
    return prep, out, lse, randn(B, Lq, C)


K6_TIMED = [(32, 1024, 320), (32, 256, 640), (32, 64, 1280)]  # (B, N, C): res 32, 16, 8
# (T, C, K): SDXL at 512 px (res 16: attn2's q, q|k|v, the GEGLU input; res
# 32: the GEGLU input, q|k|v), then SD1.5 at 256 px (res 8 and 16), each
# beside LayerNorm + cuBLAS; with --root DIR the wrappers of that checkout
K5_TIMED = [(16384, 1280, 1280), (16384, 1280, 3840), (16384, 1280, 10240), (65536, 640, 5120),
            (65536, 640, 1920), (4096, 1280, 10240), (16384, 640, 5120), (16384, 640, 1920)]
# the wide route at its edges: T off the 128-row tile, K off the 256-column
# tile, one tile of rows, few tokens, C 1000 and 328 (the last 64-channel
# piece ragged: zeros from the copy), SDXL's shapes at res 16
K5_WIDE_EDGES = [(4104, 1280, 3840), (4096, 1280, 1288), (64, 1280, 3840), (1024, 1280, 10240),
                 (1000, 1000, 1288), (777, 328, 968), (4104, 640, 1288), (64, 640, 1920),
                 (16384, 1280, 1280),
                 (16384, 1280, 3840), (16384, 1280, 10240), (65536, 640, 1920)]
# (B, N, C) at 16 frames, 8 heads, res 32 and 16: the sampler's 4 CFG rows, one folded pair
K3_TIMED = [(4, 1024, 320), (4, 256, 640)]
K7_TIMED = [(2, 1024, 320), (2, 256, 640)]
# (R, S, C): the UNet at res 32 and 16, the VAE, and few rows (one clip of 2 frames)
K4_TIMED = [(64, 1024, 320), (64, 256, 1920), (32, 65536, 128), (2, 1024, 320)]


def time_wrappers(torch, g, names):
    """The whole wrappers of the named kernels (K5, K6, K4, K3, K7) at the
    training / sampling shapes."""
    import torch.nn.functional as F

    from cvd_tpu_torch.ops import epi_flash, ln_matmul, norms, temporal_attn

    for T, C, K in K5_TIMED if "ln_matmul_fwd" in names else ():
        x = torch.randn(T, C, generator=g, device="cuda").to(torch.bfloat16)
        gam = (torch.randn(C, generator=g, device="cuda") * 0.5 + 1).to(torch.bfloat16)
        bet = (torch.randn(C, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        w = (torch.randn(K, C, generator=g, device="cuda") / math.sqrt(C)).to(torch.bfloat16)
        b = (torch.randn(K, generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        ms = [_time_ms(torch, lambda: ln_matmul.layer_norm_matmul(x, gam, bet, [w], [b]))
              for _ in range(2)]
        lib = _time_ms(torch, lambda: F.linear(F.layer_norm(x, (C,), gam, bet, 1e-5), w, b))
        print(f"time K5 wrapper T{T} C{C} K{K}: {ms[0]:.3f} {ms[1]:.3f} ms  "
              f"layer_norm + linear {lib:.3f} ms")

    for B, N, C in K3_TIMED if "temporal_attn_fwd" in names else ():
        for split in (False, True):
            q, k, v = _temporal_inputs(_randn(torch, g, torch.bfloat16), B, N, 16, 16, C, split)
            ms = [_time_ms(torch, lambda: temporal_attn.temporal_flash_attention(q, k, v, None, 8))
                  for _ in range(2)]
            print(f"time K3 wrapper B{B} N{N} F16 C{C} h8 {_layout(split)}: "
                  f"{ms[0]:.3f} {ms[1]:.3f} ms")
    for B, N, C in K7_TIMED if "temporal_attn_bwd" in names else ():
        for split in (False, True):
            q, k, v, do = _temporal_inputs(_randn(torch, g, torch.bfloat16), B, N, 16, 16, C,
                                           split, grad=True)
            for mask in (None, _temporal_mask(torch, g, "causal", 16, 16)):
                ms = [_time_ms(torch, lambda: temporal_attn.temporal_flash_attention_bwd(
                    q, k, v, mask, 8, do)) for _ in range(2)]
                print(f"time K7 wrapper B{B} N{N} F16 C{C} h8 {_layout(split)}"
                      f"{'' if mask is None else ' causal'}: {ms[0]:.3f} {ms[1]:.3f} ms")
    for B, N, C in K6_TIMED if "epi_flash_bwd" in names else ():
        for bias in (True, False):
            prep, out, lse, do = _bwd_inputs(torch, g, B, N, N, C, 8, bias,
                                             "swap" if bias else None, False)
            ms = [_time_ms(torch, lambda: epi_flash._launch_bwd(*prep, 8, out, lse, do))
                  for _ in range(2)]
            print(f"time K6 wrapper B{B} N{N} C{C} h8 bias={bias}: {ms[0]:.3f} {ms[1]:.3f} ms")
    for R, S, C in K4_TIMED if "group_norm" in names else ():
        x = (torch.randn(R, S, C, generator=g, device="cuda") * 2 + 3).to(torch.bfloat16)
        gam = torch.ones(C, device="cuda", dtype=torch.bfloat16)
        bet = torch.zeros(C, device="cuda", dtype=torch.bfloat16)
        ms = [_time_ms(torch, lambda: norms.group_norm(x, gam, bet, 32, 1e-6, act="silu"))
              for _ in range(2)]
        print(f"time K4 wrapper R{R} S{S} C{C} silu: {ms[0]:.3f} {ms[1]:.3f} ms")


def check_epi_flash_bwd(torch, g):
    import torch.nn.functional as F

    from cvd_tpu_torch.ops import epi_flash

    bad = 0
    # (B, Lq, Lk, C, heads, bias, routing, q/k/v as views of one fused projection)
    for B, Lq, Lk, C, h, bias, route, strided, *dtype in [
            (8, 1024, 1024, 320, 8, True, "swap", True), (8, 1024, 1024, 320, 8, False, None, True),
            (4, 256, 256, 640, 8, True, "swap", True), (4, 256, 256, 640, 8, False, None, False),
            (4, 64, 64, 1280, 8, True, "swap", False), (4, 64, 64, 1280, 8, False, None, True),
            (4, 200, 150, 320, 8, True, "shared", False), (4, 200, 150, 320, 8, False, None, False),
            (6, 256, 256, 320, 8, True, "shared", True), (2, 256, 256, 64, 4, False, None, False),
            (2, 256, 256, 32, 4, True, None, False), (2, 130, 130, 384, 8, False, "swap", False),
            (2, 130, 70, 768, 8, True, "shared", False), (2, 64, 300, 1024, 8, False, None, False),
            # the f32 kernels (TF32 off in the plain version), limit 1e-4
            (4, 256, 256, 640, 8, True, "swap", True, torch.float32),
            (2, 130, 70, 320, 8, False, None, False, torch.float32),
            (4, 200, 150, 320, 8, True, "shared", False, torch.float32)]:
        prep, out, lse, do = _bwd_inputs(torch, g, B, Lq, Lk, C, h, bias, route, strided, *dtype)
        got = epi_flash._launch_bwd(*prep, h, out, lse, do)
        torch.cuda.synchronize()
        q, k, v, geom, idx = prep
        want = epi_flash._plain_bwd(q.float(), k.float(), v.float(), geom, idx, h, do.float())
        tol = 1e-4 if dtype else TOL
        errs, ok = [], True
        for gi, wi in zip(got, want):
            err = float((gi.float() - wi).abs().max())
            errs.append(err)
            ok = ok and gi.dtype == q.dtype and gi.shape == wi.shape and math.isfinite(err) \
                and err <= tol * max(1.0, float(wi.abs().max()))
        bad += not ok
        print(f"K6 {str(q.dtype)[6:]} B{B} Lq{Lq} Lk{Lk} C{C} h{h} bias={bias} route={route} "
              f"strided={strided}: "
              f"dq/dk/dv err {errs[0]:.3e} {errs[1]:.3e} {errs[2]:.3e} {'ok' if ok else 'FAILED'}")
    again = epi_flash._launch_bwd(*prep, h, out, lse, do)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    bad += not same
    print(f"K6 twice on the same inputs, bit-identical: {same}")
    for B, N, C in K6_TIMED:
        for bias in (True, False):
            prep, out, lse, do = _bwd_inputs(torch, g, B, N, N, C, 8, bias,
                                             "swap" if bias else None, False)
            q, k, v, geom, idx = prep
            bufs = epi_flash._bwd_buffers(q, k, 8)
            heads = [t.reshape(B, N, 8, C // 8).transpose(1, 2).detach().requires_grad_()
                     for t in (q, k if idx is None else k[idx.long()],
                               v if idx is None else v[idx.long()])]
            mask = None if geom is None else \
                epi_flash.bias_from_geometry(*geom)[:, None].to(q.dtype)
            sdpa_out = F.scaled_dot_product_attention(*heads, attn_mask=mask)
            dh = do.reshape(B, N, 8, C // 8).transpose(1, 2)
            for _ in range(2):
                t_k = _time_ms(torch, lambda: epi_flash._launch_bwd_kernels(
                    *prep, 8, out, lse, do, *bufs))
                t_w = _time_ms(torch, lambda: epi_flash._launch_bwd(*prep, 8, out, lse, do))
                t_l = _time_ms(torch, lambda: torch.autograd.grad(sdpa_out, heads, dh,
                                                                  retain_graph=True))
                print(f"time K6 B{B} N{N} C{C} h8 bias={bias}: kernels {t_k:.3f} ms  wrapper "
                      f"{t_w:.3f} ms  backward of scaled_dot_product_attention {t_l:.3f} ms")
    return bad


def check_group_norm(torch, g):
    import torch.nn.functional as F

    from cvd_tpu_torch.ops import norms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bad = 0
    shapes = [(64, 1024, 320), (64, 1024, 640), (64, 1024, 960), (64, 256, 640), (64, 256, 1280),
              (64, 256, 1920), (64, 64, 1280), (64, 64, 2560), (64, 16, 1280), (64, 16, 2560),
              (3, 1000, 96), (5, 200, 1344), (2, 64, 64), (8, 16384, 256), (32, 65536, 128)]
    for R, S, C in shapes:
        for dtype, act in ((torch.bfloat16, "silu"), (torch.bfloat16, None),
                           (torch.float32, "silu")):
            x = (torch.randn(R, S, C, generator=g, device="cuda") * 2 + 3).to(dtype)
            gam = (torch.randn(C, generator=g, device="cuda") * 0.5 + 1).to(dtype)
            bet = (torch.randn(C, generator=g, device="cuda") * 0.1).to(dtype)
            got = norms.group_norm(x, gam, bet, 32, 1e-6, act=act)
            torch.cuda.synchronize()
            want = norms._reference(x.float(), gam.float(), bet.float(), 32, 1e-6, act)
            err = float((got.float() - want).abs().max())
            limit = (TOL if dtype == torch.bfloat16 else 1e-4) * max(1.0, float(want.abs().max()))
            ok = math.isfinite(err) and err <= limit
            bad += not ok
            p = norms.plan(R, S, C, 32, x.element_size(), sms)
            path = (f"one pass, bundle {p.bundle}, block {p.block_s}x{p.block_c}, "
                    f"{p.num_warps} warps" if p.one_pass else f"split x{p.nsplit}")
            print(f"K4 R{R} S{S} C{C} {str(dtype)[6:]} act={act} [{path}]: err {err:.3e} "
                  f"(limit {limit:.3e}) {'ok' if ok else 'FAILED'}")
    for R, S, C in K4_TIMED:
        x = (torch.randn(R, S, C, generator=g, device="cuda") * 2 + 3).to(torch.bfloat16)
        gam = torch.ones(C, device="cuda", dtype=torch.bfloat16)
        bet = torch.zeros(C, device="cuda", dtype=torch.bfloat16)
        p = norms.plan(R, S, C, 32, 2, sms)
        if p.one_pass:
            h = norms._launch_one_pass(x, torch.empty_like(x), gam, bet, 32, 1e-6, "silu", p)
            print(f"K4 one-pass kernel R{R} S{S} C{C}: registers "
                  f"{getattr(h, 'n_regs', 'not reported')}, spills "
                  f"{getattr(h, 'n_spills', 'not reported')}")
        xc = x.transpose(1, 2).contiguous()
        for _ in range(2):
            print(f"time K4 R{R} S{S} C{C} silu: "
                  f"{_time_ms(torch, lambda: norms.group_norm(x, gam, bet, 32, 1e-6, act='silu')):.3f}"
                  f" ms  F.group_norm + F.silu on [R, C, S] "
                  f"{_time_ms(torch, lambda: F.silu(F.group_norm(xc, 32, gam, bet, 1e-6))):.3f} ms")
    return bad


def _randn(torch, g, dtype):
    return lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)


def check_temporal(torch, g, backward):
    """K3 (or, with ``backward``, K7) against the plain version in f32 on the
    same inputs, then its time beside scaled_dot_product_attention on
    [B*N, h, F, D]."""
    import torch.nn.functional as F

    from cvd_tpu_torch.ops import temporal_attn as ta

    tag = "K7" if backward else "K3"
    bad = 0
    main_path = ((4, 1024, 16, 16, 320, 8, None, True), (4, 1024, 16, 16, 320, 8, None, False),
                 (2, 256, 16, 16, 640, 8, "causal", True))
    for dt, (B, N, Fr, G, C, h, kind, split) in [
            (dt, c) for dt in (torch.bfloat16, torch.float32)
            for c in (*main_path, *TEMPORAL_EDGES)]:
        q, k, v, do = _temporal_inputs(_randn(torch, g, dt), B, N, Fr, G, C, split, grad=True)
        mask = _temporal_mask(torch, g, kind, Fr, G)
        route = ta.kernel_route(Fr, G, C // h, str(dt)[6:])
        if backward:
            got = ta.temporal_flash_attention_bwd(q, k, v, mask, h, do)
            leaves = [x.float().requires_grad_() for x in (q, k, v)]
            want = torch.autograd.grad(ta.temporal_attention_plain(*leaves, mask, h), leaves,
                                       do.float())
        else:
            got = (ta.temporal_flash_attention(q, k, v, mask, h),)
            want = (ta.temporal_attention_plain(q.float(), k.float(), v.float(), mask, h),)
        torch.cuda.synchronize()
        tol = 1e-4 if dt == torch.float32 else TOL
        errs, ok = [], True
        for gi, wi in zip(got, want):
            err = float((gi.float() - wi).abs().max())
            errs.append(err)
            ok = ok and gi.dtype == dt and gi.shape == wi.shape and math.isfinite(err) \
                and err <= tol * max(1.0, float(wi.abs().max()))
        bad += not ok
        print(f"{tag} {str(dt)[6:]} B{B} N{N} F{Fr} G{G} C{C} h{h} mask={kind} "
              f"{_layout(split)} [{route}]: err {' '.join(f'{e:.3e}' for e in errs)} "
              f"{'ok' if ok else 'FAILED'}")
    for B, N, C in K7_TIMED if backward else K3_TIMED:
        for split in (False, True):
            q, k, v, do = _temporal_inputs(_randn(torch, g, torch.bfloat16), B, N, 16, 16, C,
                                           split, grad=True)
            heads = [t.reshape(B * N, 16, 8, C // 8).transpose(1, 2) for t in (q, k, v, do)]
            for mask in (None, _temporal_mask(torch, g, "causal", 16, 16)) if backward else (None,):
                prep = ta._prepare(q, k, v, mask, 8)
                if backward:
                    hs = [t.detach().requires_grad_() for t in heads[:3]]
                    sdpa_out = F.scaled_dot_product_attention(*hs, attn_mask=mask)
                    kernel = lambda: ta._launch_bwd(*prep, 8, do)  # noqa: E731
                    library = lambda: torch.autograd.grad(  # noqa: E731
                        sdpa_out, hs, heads[3], retain_graph=True)
                else:
                    kernel = lambda: ta._launch(*prep, 8)  # noqa: E731
                    library = lambda: F.scaled_dot_product_attention(*heads[:3])  # noqa: E731
                for _ in range(2):  # the kernel from a replayed CUDA graph: device time
                    print(f"time {tag} B{B} N{N} F16 C{C} h8 {_layout(split)}"
                          f"{'' if mask is None else ' causal'}: kernel "
                          f"{_time_captured_ms(torch, kernel):.4f} ms  "
                          f"{'backward of ' if backward else ''}scaled_dot_product_attention "
                          f"on [B*N, h, F, D] {_time_ms(torch, library):.3f} ms")
    # what chose head_group's cap of 640 bytes a row: the kernel under other caps
    cap = ta._MMA_ROW_BYTES
    try:
        for B, N, C in K7_TIMED if backward else K3_TIMED:
            q, k, v, do = _temporal_inputs(_randn(torch, g, torch.bfloat16), B, N, 16, 16, C,
                                           True, grad=True)
            prep = ta._prepare(q, k, v, None, 8)
            for ta._MMA_ROW_BYTES in (160, 320, 640, 1280):
                kernel = (lambda: ta._launch_bwd(*prep, 8, do)) if backward else (
                    lambda: ta._launch(*prep, 8))
                ms = [_time_captured_ms(torch, kernel) for _ in range(2)]
                print(f"time {tag} B{B} N{N} F16 C{C} h8, rows of at most {ta._MMA_ROW_BYTES} "
                      f"bytes ({ta.head_group(8, C // 8)} heads a block): kernel {ms[0]:.4f} "
                      f"{ms[1]:.4f} ms")
    finally:
        ta._MMA_ROW_BYTES = cap
    return bad


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_check: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    root = args.pop(args.index("--root") + 1) if "--root" in args else None
    if root is not None:  # the package of that checkout, under the same module names
        sys.path.insert(0, os.path.abspath(root))
    names = [a for a in args if not a.startswith("--")] or [*CUDA_SOURCES, "group_norm"]
    unknown = [n for n in names if n not in (*CUDA_SOURCES, "group_norm")]
    if unknown:
        print(f"kernel_check: no kernel named {unknown}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if root is not None:
        print(f"the wrappers of the checkout at {root}")
        time_wrappers(torch, g, names)
        return 0
    from cvd_tpu_torch.ops import _build

    sources = [n for n in names if n in CUDA_SOURCES]
    ptxas_report(_build, sources)
    _build.build(sources)
    bad = 0
    if "epi_flash_fwd" in names:
        bad += check_epi_flash(torch, g)
    if "ln_matmul_fwd" in names:
        bad += check_ln_matmul(torch, g, _build, "--phases" in args)
    if "epi_flash_bwd" in names:
        bad += check_epi_flash_bwd(torch, g)
    if "group_norm" in names:
        bad += check_group_norm(torch, g)
    if "temporal_attn_fwd" in names:
        bad += check_temporal(torch, g, backward=False)
    if "temporal_attn_bwd" in names:
        bad += check_temporal(torch, g, backward=True)
    time_wrappers(torch, g, names)
    print("FAILED" if bad else "ALL OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
