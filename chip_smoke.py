#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cvd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions. No CUDA device -> exit 1, no result.
2. build: compiles every hand-written kernel from cvd_tpu_torch/csrc (nvcc,
   sm_90a) and the Triton GroupNorm, and prints the seconds taken.
3. kernels: each kernel against its plain PyTorch version at the main-path
   shapes, in f32 (TF32 off) and in bf16; max |error| against the stated
   tolerance, and kernel ms beside plain ms (CUDA events, after warm-up).
4. reference: a narrow UNet (the smoke widths) at 256 px runs the sampler
   on the card, through the kernels, and on the CPU, through the plain
   versions, from the same weights and latents; final latents must agree
   at >= 60 dB SNR.
5. slice: ``cvd_tpu_torch.cli.inference`` at SD1.5 width (random weights,
   bf16, 256 px, 16 frames, 2 views, 3 DDIM steps) answers the two prompts
   of assets/example_prompts.json. Launch counts are reset just before
   and read just after: every kernel must have run.

The second-to-last line is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOL_F32 = 1e-4   # f32 in, f32 products: summation order only
TOL_BF16 = 2e-2  # bf16 in: rounding points differ (P, outputs), ~2^-7 per rounding
KERNELS = {
    # name: (route, source, TPU kernel body replaced: _fwd_kernel, _gn_kernel,
    # _ln_mm_kernel; K1 and K2 are its has_bias=True / False variants)
    "epi_flash_attention": ("cuda", "cvd_tpu_torch/csrc/epi_flash_fwd.cu",
                            "cvd_tpu/ops/epi_flash.py:75"),
    "flash_attention": ("cuda", "cvd_tpu_torch/csrc/epi_flash_fwd.cu",
                        "cvd_tpu/ops/epi_flash.py:75"),
    "temporal_flash_attention": ("cuda", "cvd_tpu_torch/csrc/temporal_attn_fwd.cu",
                                 "cvd_tpu/ops/temporal_attn.py:42"),
    "group_norm": ("triton", "cvd_tpu_torch/ops/norms.py",
                   "cvd_tpu/ops/norms.py:44"),
    "layer_norm_matmul": ("cuda", "cvd_tpu_torch/csrc/ln_matmul_fwd.cu",
                          "cvd_tpu/ops/ln_matmul.py:48"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi[0]


def phase_build(torch):
    from cvd_tpu_torch.ops import _build
    from cvd_tpu_torch.ops.norms import group_norm

    t0 = time.perf_counter()
    _build.build(["epi_flash_fwd", "temporal_attn_fwd", "ln_matmul_fwd"])
    t_nvcc = time.perf_counter() - t0
    # Triton compiles at first launch: one small GroupNorm per dtype/act
    for dtype in (torch.float32, torch.bfloat16):
        for act in (None, "silu"):
            x = torch.randn(2, 64, 64, device="cuda", dtype=dtype)
            group_norm(x, torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"),
                       32, act=act)
    torch.cuda.synchronize()
    log(f"[build] nvcc {t_nvcc:.1f} s, total {time.perf_counter() - t0:.1f} s")


def _time_ms(torch, fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _cases(torch, dtype, g):
    """(kernel name, shape label, kernel fn, plain fn, timed?) at the
    main-path shapes (256 px, 16 frames, 2 views = 4 CFG rows)."""
    from cvd_tpu_torch.geometry.epipolar_mask import (
        epipolar_lines, lines_and_band, pixel_grid_coords,
    )
    from cvd_tpu_torch.ops import epi_flash, ln_matmul, norms, temporal_attn

    dev = "cuda"

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale + shift).to(dtype)

    cases = []
    for feat, C in ((32, 320), (16, 640)):
        N, B = feat * feat, 64
        q, k, v = randn(B, N, C), randn(B, N, C), randn(B, N, C)
        F_mats = torch.randn(B, 3, 3, generator=g, device=dev) * 1e-3
        coords = pixel_grid_coords(feat, 256, dev)
        lines, band, alpha = lines_and_band(epipolar_lines(F_mats, coords), feat, 256)
        xy = coords[:, :2].T.contiguous()
        route = torch.cat([torch.arange(32, 64), torch.arange(0, 32)]).to(dev, torch.int32)
        geom = (lines, xy, band, alpha)
        cases.append(("epi_flash_attention", f"B{B} N{N} C{C} h8 routed",
                      lambda q=q, k=k, v=v, geom=geom, route=route:
                      epi_flash.epi_flash_attention(q, k, v, *geom, heads=8, kv_index=route),
                      lambda q=q, k=k, v=v, geom=geom, route=route:
                      epi_flash._plain(q, k, v, geom, route, 8), feat == 32))
        cases.append(("flash_attention", f"B{B} N{N} C{C} h8",
                      lambda q=q, k=k, v=v: epi_flash.flash_attention(q, k, v, heads=8),
                      lambda q=q, k=k, v=v: epi_flash._plain(q, k, v, None, None, 8),
                      feat == 32))
        qt, kt, vt = randn(4, N, 16, C), randn(4, N, 16, C), randn(4, N, 16, C)
        cases.append(("temporal_flash_attention", f"B4 N{N} F16 C{C} h8",
                      lambda q=qt, k=kt, v=vt:
                      temporal_attn.temporal_flash_attention(q, k, v, None, heads=8),
                      lambda q=qt, k=kt, v=vt:
                      temporal_attn.temporal_attention_plain(q, k, v, None, 8), feat == 32))
    for R, S, C, eps, timed in ((64, 1024, 320, 1e-6, True), (64, 256, 1920, 1e-6, False),
                                (32, 65536, 128, 1e-6, True)):
        x = randn(R, S, C, scale=2.0, shift=3.0)
        gam, bet = randn(C, scale=0.5, shift=1.0), randn(C, scale=0.1)
        cases.append(("group_norm", f"R{R} S{S} C{C} silu",
                      lambda x=x, gam=gam, bet=bet, eps=eps:
                      norms.group_norm(x, gam, bet, 32, eps, act="silu"),
                      lambda x=x, gam=gam, bet=bet, eps=eps:
                      norms._reference(x, gam, bet, 32, eps, "silu"), timed))
    for T, C, Ks in ((65536, 320, (320, 320, 320)), (65536, 320, (2560,)),
                     (16384, 640, (5120,)), (4096, 1280, (1280, 1280, 1280))):
        x = randn(T, C)
        gam, bet = randn(C, scale=0.5, shift=1.0), randn(C, scale=0.1)
        ws = [randn(K, C, scale=1.0 / math.sqrt(C)) for K in Ks]
        bs = [None] * len(Ks) if len(Ks) > 1 else [randn(Ks[0], scale=0.1)]
        cases.append(("layer_norm_matmul", f"T{T} C{C} K{sum(Ks)}",
                      lambda x=x, gam=gam, bet=bet, ws=ws, bs=bs:
                      torch.cat(ln_matmul.layer_norm_matmul(x, gam, bet, ws, bs), -1),
                      lambda x=x, gam=gam, bet=bet, ws=ws, bs=bs:
                      ln_matmul._reference(x, gam, bet, ws, bs, 1e-5), T == 65536 and C == 320
                      and len(Ks) == 1))
    return cases


def phase_kernels(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {name: {"max_abs_err": 0.0, "max_abs_err_f32": 0.0} for name in KERNELS}
    failures = []
    for dtype, tol, key in ((torch.float32, TOL_F32, "max_abs_err_f32"),
                            (torch.bfloat16, TOL_BF16, "max_abs_err")):
        g = torch.Generator(device="cuda").manual_seed(0)
        for name, label, kernel, plain, timed in _cases(torch, dtype, g):
            with torch.no_grad():
                got, want = kernel().float(), plain().float()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ref = max(1.0, float(want.abs().max()))
            ok = math.isfinite(err) and err <= tol * ref
            report[name][key] = max(report[name][key], err)
            line = (f"[kernel] {name:26s} {str(dtype)[6:]:8s} {label:26s} "
                    f"max_abs_err {err:.3e} (limit {tol * ref:.3e})")
            if timed and dtype == torch.bfloat16:
                with torch.no_grad():
                    k_ms = _time_ms(torch, kernel)
                    p_ms = _time_ms(torch, plain)
                if "ms" not in report[name]:  # the record keeps the first timed shape
                    report[name].update(ms=k_ms, plain_ms=p_ms, timed_shape=label)
                line += f"  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms"
            log(line + ("" if ok else "  FAILED"))
            if not ok:
                failures.append(f"{name} {label} {dtype}")
            del got, want
        torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return report


def phase_reference(torch):
    """Narrow UNet at 256 px: card (kernels) vs CPU (plain versions)."""
    import numpy as np

    from cvd_tpu_torch.cli.build import SMOKE_CLIP, SMOKE_UNET, SMOKE_VAE
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.pipelines.simple import SimplePipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    gpu = PipelineModules.create(SMOKE_UNET, SMOKE_VAE, SMOKE_CLIP, device="cuda")
    for name in ("unet", "vae", "clip", "pose_encoder"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    rng = np.random.default_rng(0)
    Fr, S = 2, 256
    inputs = dict(
        prompt_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        negative_ids=torch.from_numpy(rng.integers(0, 49408, (1, 77))),
        plucker=torch.from_numpy(rng.standard_normal((2, Fr, S, S, 6)).astype(np.float32)),
        F_mats=torch.from_numpy((rng.standard_normal((2, Fr, 3, 3)) * 1e-3).astype(np.float32)),
        latents=torch.from_numpy(rng.standard_normal((2, Fr, S // 8, S // 8, 4)).astype(np.float32)),
    )
    wrappers = _wrappers()
    before = {n: fn.launches for n, fn in wrappers.items()}
    want = SimplePipeline(cpu, rand_slope_ff=False)(**inputs, num_inference_steps=2,
                                                    decode=False).numpy()
    got = SimplePipeline(gpu, rand_slope_ff=False)(**inputs, num_inference_steps=2,
                                                   decode=False).cpu().numpy()
    used = sorted(n for n, fn in wrappers.items() if fn.launches > before[n])
    snr = 10 * np.log10(np.mean(want ** 2) / max(np.mean((got - want) ** 2), 1e-30))
    log(f"[reference] narrow UNet 256 px f32: card vs CPU final-latent SNR {snr:.1f} dB "
        f"(kernels used: {', '.join(used)})")
    if not snr >= 60.0:
        raise RuntimeError(f"card vs CPU SNR {snr:.1f} dB < 60 dB")


def _wrappers():
    """The op wrappers that launch each kernel; each carries its count."""
    from cvd_tpu_torch.ops import epi_flash, ln_matmul, norms, temporal_attn

    return {"epi_flash_attention": epi_flash.epi_flash_attention,
            "flash_attention": epi_flash.flash_attention,
            "temporal_flash_attention": temporal_attn.temporal_flash_attention,
            "group_norm": norms.group_norm,
            "layer_norm_matmul": ln_matmul.layer_norm_matmul}


def phase_slice(torch):
    import numpy as np

    from cvd_tpu_torch.cli import inference

    assets = os.path.join(HERE, "assets")
    args = inference.build_parser().parse_args([
        "--random-weights-full", "--bf16", "--image_height", "256", "--image_width", "256",
        "--video_length", "16", "--num_inference_steps", "3",
        "--caption_file", os.path.join(assets, "example_prompts.json"),
        "--use_negative_prompt",
        "--pose_file_0", os.path.join(assets, "pose_files", "example_dolly.txt"),
        "--pose_file_1", os.path.join(assets, "pose_files", "example_arc.txt"),
        "--out_root", os.path.join(HERE, "build", "chip_smoke_out"),
    ])
    wrappers = _wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    records = inference.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, rec in enumerate(records):
        v = rec["videos"]
        if v.shape != (2, 16, 256, 256, 3) or not np.isfinite(v).all():
            raise RuntimeError(f"request {i}: videos {v.shape}, finite={np.isfinite(v).all()}")
        steps = ", ".join(f"{ms:.1f}" for ms in rec["unet_step_ms"])
        log(f"[slice] request {i}: {rec['seconds']:.2f} s end to end, UNet steps [{steps}] ms, "
            f"video std {float(v.std()):.4f}")
    log(f"[slice] 2 requests in {seconds:.2f} s (module build included), "
        f"peak allocated {peak / 2**30:.2f} GiB, launches {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if len(records) != 2 or missing:
        raise RuntimeError(f"kernels not launched on the main path: {missing}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "cvd_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    smi = phase_device(torch)
    phase_build(torch)
    report = phase_kernels(torch)
    phase_reference(torch)
    launches = phase_slice(torch)
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = report[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "max_abs_err_f32": r["max_abs_err_f32"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "timed_shape": r["timed_shape"]})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
