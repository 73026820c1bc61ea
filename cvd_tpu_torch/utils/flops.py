"""The floating-point operations of one UNet call, for MFU (port of
``cvd_tpu/utils/flops.py``).

    python -m cvd_tpu_torch.utils.flops --batch 4 --frames 16 --latent 32 [--f32]

prints one JSON line ``{"flops": N}``: the FLOPs of ONE UNet apply at SD1.5
widths on those shapes, counted by ``torch.utils.flop_counter.FlopCounterMode``
over the model run on the ``meta`` device (the ops take their plain paths
there, ``ops.PLAIN_DEVICES``), so no weight or activation is allocated and
no card is needed. The inputs are the JAX package's: 77 text tokens, the
four pose-feature levels and ``EpiConditioning(F_mats=[B*F, 3, 3],
rand_slope_ff=False)``.

What is counted: matrix products and convolutions, 2 per multiply-add, at
their nominal size (every tap of a padded convolution; the card multiplies
the padding too). The JAX package reads XLA's cost analysis instead, which
counts a padded convolution's taps inside the input only and every
elementwise operation, so the two differ (PERF.md section 6, "FLOP count").
Divide by the card's peak (``ops.work.PEAK_FLOPS``) for a utilization.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import torch


def _unet_call(batch: int, frames: int, latent: int, bf16: bool):
    """(the SD1.5-width UNet on ``meta``, its call's positional inputs)."""
    from cvd_tpu_torch.models.epi import EpiConditioning
    from cvd_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig

    act = torch.bfloat16 if bf16 else torch.float32
    with torch.device("meta"):
        unet = UNet3DConditionModel(UNetConfig()).to(act)
        ch = unet.config.block_out_channels
        inputs = (
            torch.empty(batch, frames, latent, latent, 4),
            torch.empty((), dtype=torch.long),
            torch.empty(batch, 77, unet.config.cross_attention_dim),
            [torch.empty(batch, frames, latent // 2 ** i, latent // 2 ** i, ch[i], dtype=act)
             for i in range(4)],
            EpiConditioning(F_mats=torch.empty(batch * frames, 3, 3), video_length=frames,
                            rand_slope_ff=False),
        )
    return unet, inputs


def unet_flop_counts(batch: int, frames: int, latent: int,
                     bf16: bool = True) -> Dict[str, Dict[str, int]]:
    """``FlopCounterMode.get_flop_counts()`` of one UNet call: {module path
    ("Global" for the whole): {aten op: FLOPs}}."""
    from torch.utils.flop_counter import FlopCounterMode

    unet, inputs = _unet_call(batch, frames, latent, bf16)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        unet(*inputs)
    return {module: {str(op): n for op, n in ops.items()}
            for module, ops in counter.get_flop_counts().items()}


def unet_apply_flops(batch: int, frames: int, latent: int, bf16: bool = True) -> float:
    """FLOPs of one UNet apply at SD1.5 widths: ``batch`` rows of ``frames``
    frames of ``latent`` x ``latent`` latents."""
    return float(sum(unet_flop_counts(batch, frames, latent, bf16)["Global"].values()))


def cached_unet_flops(batch: int, frames: int, latent: int, bf16: bool = True,
                      cache_dir: Optional[str] = None) -> float:
    """``unet_apply_flops``, kept on disk per shape (the count depends on the
    shapes only) under ``cache_dir``, default ``$XDG_CACHE_HOME`` or
    ``~/.cache``, then ``cvd_tpu_torch``."""
    cache_dir = cache_dir or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache"), "cvd_tpu_torch")
    path = os.path.join(cache_dir, f"flops_b{batch}_f{frames}_l{latent}_{int(bf16)}.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)["flops"]
    flops = unet_apply_flops(batch, frames, latent, bf16)
    os.makedirs(cache_dir, exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump({"flops": flops}, f)
    os.replace(path + ".tmp", path)
    return flops


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--latent", type=int, default=32)
    p.add_argument("--f32", action="store_true")
    args = p.parse_args(argv)
    print(json.dumps({"flops": unet_apply_flops(args.batch, args.frames, args.latent,
                                                bf16=not args.f32)}))


if __name__ == "__main__":
    main()
