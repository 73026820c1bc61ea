"""Per-frame PSNR / SSIM parity between two generated videos (port of
``cvd_tpu/cli/eval_parity.py``; numpy, and imageio where a file needs it).

    python -m cvd_tpu_torch.cli.eval_parity --ref results_torch/0/imgs/0 \
        --test results_port/0/imgs/0
    python -m cvd_tpu_torch.cli.eval_parity --ref ref.mp4 --test ours.npy --json

A video is a directory of per-frame pngs / jpgs (``save_video_as_images``'
layout), an ``.mp4`` / ``.gif`` (read with imageio) or a ``.npy`` array
([F, H, W, 3] or [H, W, 3], uint8 or in [0, 1]). PARITY.md's gate is per-frame
PSNR >= 35 dB against the reference's output for the same checkpoint, seed
and prompt: the exit code is 1 when a frame falls below ``--threshold_db``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_video(path: str) -> np.ndarray:
    """-> [F, H, W, 3] float64 in [0, 1]."""
    if os.path.isdir(path):
        import imageio.v2 as imageio

        frames = sorted(f for f in os.listdir(path)
                        if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if not frames:
            raise FileNotFoundError(f"no image frames in {path}")
        arr = np.stack([imageio.imread(os.path.join(path, f)) for f in frames])
    elif path.endswith(".npy"):
        arr = np.load(path)
    else:
        import imageio.v2 as imageio

        arr = np.stack(list(imageio.get_reader(path)))
    arr = np.asarray(arr)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float64) / 255.0
    return np.clip(arr.astype(np.float64), 0.0, 1.0)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(1.0 / mse)


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """Global (non-windowed) SSIM of one frame: a coarse companion to PSNR
    (a windowed SSIM would need scipy)."""
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                 / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ref", required=True, help="reference video (dir/mp4/gif/npy)")
    p.add_argument("--test", required=True, help="video under test")
    p.add_argument("--threshold_db", type=float, default=35.0)
    p.add_argument("--json", action="store_true", help="one JSON line to stdout")
    args = p.parse_args(argv)

    ref, test = _load_video(args.ref), _load_video(args.test)
    if ref.shape != test.shape:
        raise SystemExit(f"shape mismatch: ref {ref.shape} vs test {test.shape}")
    per_frame = [psnr(r, t) for r, t in zip(ref, test)]
    per_frame_ssim = [ssim(r, t) for r, t in zip(ref, test)]
    result = {
        "frames": len(per_frame),
        "psnr_mean_db": round(float(np.mean(per_frame)), 3),
        "psnr_min_db": round(float(np.min(per_frame)), 3),
        "psnr_per_frame_db": [round(v, 2) for v in per_frame],
        "ssim_mean": round(float(np.mean(per_frame_ssim)), 4),
        "pass": bool(np.min(per_frame) >= args.threshold_db),
        "threshold_db": args.threshold_db,
    }
    if args.json:
        print(json.dumps(result))
    else:
        print(f"frames          : {result['frames']}")
        print(f"PSNR mean / min : {result['psnr_mean_db']} / {result['psnr_min_db']} dB")
        print(f"SSIM mean       : {result['ssim_mean']}")
        print(f"pass (>= {args.threshold_db} dB per frame): {result['pass']}")
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
