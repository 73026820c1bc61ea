"""LoRA weight fusion as state-dict transforms on torch tensors (port of
``cvd_tpu/io/lora.py``).

Covers two of the reference's LoRA paths:
* ``tools/merge_lora2unet.py``: offline fuse of the AnimateDiffV3 image
  ("webvid") adapter into SD1.5 UNet attention weights — W += up @ down * scale
  for to_q/to_k/to_v/to_out.0 (merge_lora2unet.py:36-49).
* AnimateDiff motion-LoRA fusion into the motion-module state
  (animatediff/utils/convert_lora_safetensor_to_diffusers.py:28-49).

Both run before the state is loaded, so the import itself is unchanged.
Products are taken in f32 and the result is in the target's dtype. Not
ported yet: kohya / civitai LoRA fusion into a full pipeline state
(ROADMAP.md, queue 1, item 5).
"""
from __future__ import annotations

from typing import Dict

import torch

_ATTN_KEYS = ("to_q", "to_k", "to_v", "to_out.0")


def _fused(weight: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           scale: float) -> torch.Tensor:
    """W + scale * up @ down in f32, back in W's dtype."""
    return (weight.float() + scale * (up.float() @ down.float())).to(weight.dtype)


def fuse_lora_into_unet_state(
    unet_state: Dict[str, torch.Tensor],
    lora_state: Dict[str, torch.Tensor],
    scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """merge_lora2unet semantics: for every attention projection with a LoRA
    pair, W += up @ down * scale. LoRA keys follow the attn-processor naming
    '<attn_path>.processor.<proj>_lora.{down,up}.weight' with proj in
    to_q/to_k/to_v/to_out (merge_lora2unet.py:40-46)."""
    out = dict(unet_state)
    fused = 0
    for key, weight in unet_state.items():
        for proj in _ATTN_KEYS:
            suffix = f".{proj}.weight"
            if not key.endswith(suffix):
                continue
            proj_flat = proj.replace(".0", "")  # to_out.0 -> to_out
            base = key[: -len(suffix)]
            down_key = f"{base}.processor.{proj_flat}_lora.down.weight"
            up_key = f"{base}.processor.{proj_flat}_lora.up.weight"
            if down_key in lora_state and up_key in lora_state:
                out[key] = _fused(weight, lora_state[up_key], lora_state[down_key], scale)
                fused += 1
    if fused == 0 and lora_state:
        raise KeyError("no LoRA pairs matched the UNet state dict")
    return out


def fuse_motion_lora_into_state(
    target_state: Dict[str, torch.Tensor],
    lora_state: Dict[str, torch.Tensor],
    scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """AnimateDiff motion-LoRA fusion (pan/zoom effect checkpoints) —
    ``convert_motion_lora_ckpt_to_diffusers`` semantics: every ``.down.`` key
    pairs with its ``.up.`` twin and fuses directly into the
    temporal-attention projection it names:

        model_key = key without 'processor.', '_lora', 'down.', 'up.'
                    (+ 'to_out.' -> 'to_out.0.')
        W[model_key] += scale * up @ down

    Runs on the motion-module state dict BEFORE import, so inference carries
    zero LoRA compute; the fusion-time ``scale`` replaces the reference's
    runtime ``motion_lora_scale`` threading (unet_blocks.py:274-279) — same
    math, applied once at load."""
    out = dict(target_state)
    fused = 0
    for key in lora_state:
        if "up." in key:
            continue
        up_key = key.replace(".down.", ".up.")
        model_key = (key.replace("processor.", "").replace("_lora", "")
                     .replace("down.", "").replace("up.", "")
                     .replace("to_out.", "to_out.0."))
        if model_key not in out:
            raise KeyError(
                f"motion-LoRA key {key} resolves to {model_key}, absent "
                "from the motion-module state dict"
            )
        out[model_key] = _fused(out[model_key], lora_state[up_key], lora_state[key], scale)
        fused += 1
    if fused == 0 and lora_state:
        raise KeyError("no motion-LoRA pairs matched the state dict")
    return out
