"""Pipeline assembly for the CLIs (port of ``cvd_tpu/cli/build.py``, the
random-weights branch) of the 2-view and the N-view sampler. ``--random-weights``
builds the tiny model from the default initialization (epi modules start as
the identity), ``--random-weights-full`` the SD1.5 widths with every tensor
drawn. Checkpoint import is not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

import torch

from cvd_tpu_torch.io.tokenizer import HashTokenizer
from cvd_tpu_torch.models.clip_text import CLIPTextConfig
from cvd_tpu_torch.models.unet import UNetConfig
from cvd_tpu_torch.models.vae import VAEConfig
from cvd_tpu_torch.pipelines.common import PipelineModules

SMOKE_UNET = UNetConfig(
    block_out_channels=(32, 64, 64, 64),
    attention_heads=4,
    cross_attention_dim=24,
    norm_num_groups=8,
)
SMOKE_VAE = VAEConfig(block_out_channels=(32, 32, 64, 64), norm_num_groups=8)
SMOKE_CLIP = CLIPTextConfig(hidden_size=24, num_layers=2, num_heads=4, intermediate_size=48)


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--random-weights", action="store_true", dest="random_weights",
                   help="tiny random-weight smoke mode (no checkpoints needed)")
    p.add_argument("--random-weights-full", action="store_true",
                   dest="random_weights_full",
                   help="FULL-SIZE random weights (SD1.5 widths, drawn on the "
                        "device from a fixed seed): real deployment shapes "
                        "without checkpoints, garbage pixels")
    p.add_argument("--pose_adaptor_scale", type=float, default=1.0)
    p.add_argument("--bf16", action="store_true", help="bfloat16 weights and activations")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; a machine without a CUDA "
                        "device must ask for --device cpu)")


def resolve_device(requested: Optional[str]) -> torch.device:
    """The device an entry point runs on: the one asked for, else the card.
    Without a card nothing falls back to the CPU silently: a run there has
    to be asked for (``--device cpu`` / ``device: cpu``)."""
    if requested:
        return torch.device(requested)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found: cvd_tpu_torch runs on the GPU by default; "
                           "pass --device cpu (config key `device: cpu`) to run on the CPU")
    return torch.device("cuda")


def build_modules(args, device: torch.device) -> Tuple[PipelineModules, HashTokenizer]:
    """-> (modules, tokenizer) with random weights."""
    if not (args.random_weights or args.random_weights_full):
        raise NotImplementedError(
            "checkpoint import is not ported yet: pass --random-weights or "
            "--random-weights-full")
    full = args.random_weights_full
    generator = torch.Generator(device=device).manual_seed(0)
    modules = PipelineModules.create(
        unet_config=dataclasses.replace(UNetConfig() if full else SMOKE_UNET,
                                        pose_scale=args.pose_adaptor_scale),
        vae_config=VAEConfig() if full else SMOKE_VAE,
        clip_config=CLIPTextConfig() if full else SMOKE_CLIP,
        device=device,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        generator=generator,
        random_full=full,
    )
    return modules, HashTokenizer()
