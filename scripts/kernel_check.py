#!/usr/bin/env python3
"""Short check of the redesigned bf16 kernels (K1/K2 ``epi_flash_fwd``, K5
``ln_matmul_fwd``) on one NVIDIA GPU: the first thing to run after editing
either source, before the longer ``chip_smoke.py``.

    python3 scripts/kernel_check.py [epi_flash_fwd] [ln_matmul_fwd] [--phases]

For each named source (default: both) it
1. compiles it with ``-Xptxas -v`` and prints, per bf16 kernel, registers
   and spills, and any ptxas remark (C7517 / C7518 say that wgmma was
   serialized); the full output goes to ``chiprun_out/ptxas_<name>.txt``;
2. holds the kernel against its plain version at the edges (64 tokens,
   head_dim 8 to 160, ragged lengths, strided q/k/v views, C 32 to 1280) with
   the limit of ``chip_smoke.py`` (2e-2 x max(1, max|plain|)), and K1/K2's
   lse against f32 logits;
3. times it (CUDA events, after warm-up, twice) at the sampler's shapes
   beside one PyTorch library call for the same function.
``--phases`` also builds K5 with ``-DLNMM_PROF`` and prints the clock cycles a
block spends per phase (panel copy, standardization, product loop; inside
the loop: epilogue, waits for copies, waits for wgmma), as warpgroup 0's
thread 0 sees them. Exits non-zero if anything disagrees.
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
TOL = 2e-2


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
            if "Compiling entry function" in line and "bf16" in line:
                # the mangled name holds the template arguments: ...kernelILb1ELi5EE...
                name = re.search(r"((?:epi_flash_fwd|ln_matmul)_bf16_kernelI(?:L[bi]\d+E)+)", line)
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
                    (300, 1280, 1280), (512, 32, 96), (777, 64, 256), (65536, 320, 2560)]:
        x, gam, bet, w, b, (wf, bf) = inputs(T, C, K)
        got = ln_matmul._launch(x, wf, bf, 1e-5)
        torch.cuda.synchronize()
        want = ln_matmul._reference(x.float(), gam.float(), bet.float(), [w.float()],
                                    [b.float()], 1e-5)
        err = float((got.float() - want).abs().max())
        ref = max(1.0, float(want.abs().max()))
        ok = math.isfinite(err) and err <= TOL * ref
        bad += not ok
        print(f"K5 T{T} C{C} K{K}: err {err:.3e} (limit {TOL * ref:.3e}) "
              f"{'ok' if ok else 'FAILED'}")
    x, gam, bet, w, b, (wf, bf) = inputs(2048, 320, 960)
    xs = torch.cat([x, x], -1)[:, :320]          # a row stride of 640 elements
    same = torch.equal(ln_matmul._launch(xs, wf, bf, 1e-5), ln_matmul._launch(x, wf, bf, 1e-5))
    bad += not same
    print(f"K5 strided x equals contiguous x: {same}")
    if phases:
        so = os.path.join(HERE, "build", "kernels", "ln_matmul_prof.so")
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DLNMM_PROF", "-o", so,
                        str(_build.CSRC / "ln_matmul_fwd.cu")], check=True)
        lib = ctypes.CDLL(so)
        lib.ln_matmul_fwd.argtypes = ln_matmul._SIGNATURE["ln_matmul_fwd"]
        lib.ln_matmul_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for T, C, K in [(65536, 320, 2560), (65536, 320, 960), (16384, 640, 5120),
                    (4096, 1280, 10240), (4096, 1280, 3840)]:
        x, gam, bet, w, b, (wf, bf) = inputs(T, C, K)
        for _ in range(2):
            print(f"time K5 T{T} C{C} K{K}: {_time_ms(torch, lambda: ln_matmul._launch(x, wf, bf, 1e-5)):.3f} ms"
                  f"  layer_norm + linear "
                  f"{_time_ms(torch, lambda: F.linear(F.layer_norm(x, (C,), gam, bet, 1e-5), w, b)):.3f}"
                  f" ms  linear alone {_time_ms(torch, lambda: F.linear(x, w, b)):.3f} ms")
        if phases:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_check: no CUDA device", file=sys.stderr)
        return 1
    from cvd_tpu_torch.ops import _build

    args = sys.argv[1:]
    names = [a for a in args if not a.startswith("--")] or ["epi_flash_fwd", "ln_matmul_fwd"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    ptxas_report(_build, names)
    _build.build(names)
    g = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    if "epi_flash_fwd" in names:
        bad += check_epi_flash(torch, g)
    if "ln_matmul_fwd" in names:
        bad += check_ln_matmul(torch, g, _build, "--phases" in args)
    print("FAILED" if bad else "ALL OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
