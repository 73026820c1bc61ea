"""LoRA weight fusion as state-dict transforms on torch tensors (port of
``cvd_tpu/io/lora.py``).

Covers the reference's three LoRA paths:
* ``tools/merge_lora2unet.py``: offline fuse of the AnimateDiffV3 image
  ("webvid") adapter into SD1.5 UNet attention weights — W += up @ down * scale
  for to_q/to_k/to_v/to_out.0 (merge_lora2unet.py:36-49).
* AnimateDiff motion-LoRA fusion into the motion-module state
  (animatediff/utils/convert_lora_safetensor_to_diffusers.py:28-49).
* kohya / civitai LoRA fusion into the UNet and text-encoder states
  (convert_lora, same file :52-154; ``io/ldm_convert.apply_civitai_lora``).

Each runs before the state is loaded, so the import itself is unchanged.
Products are taken in f32 on the weight's device and the result is in the
weight's dtype.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

_ATTN_KEYS = ("to_q", "to_k", "to_v", "to_out.0")


def _fused(weight: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           scale: float) -> torch.Tensor:
    """W + scale * up @ down in f32 on W's device, back in W's dtype."""
    up, down = up.to(weight.device).float(), down.to(weight.device).float()
    return (weight.float() + scale * (up @ down)).to(weight.dtype)


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


def fuse_kohya_lora_into_pipeline(
    unet_state: Dict[str, torch.Tensor],
    text_encoder_state: Optional[Dict[str, torch.Tensor]],
    lora_state: Dict[str, torch.Tensor],
    alpha: float = 0.6,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """civitai / kohya LoRA fusion (convert_lora, reference :52-154): keys
    ``lora_unet_<path>.lora_{down,up}.weight`` and ``lora_te_<path>...``
    (``_`` for every separator, ``<path>.alpha`` optional), W += alpha *
    (a / rank) * up @ down with a = the pair's ``.alpha`` (a / rank = 1
    without it). A conv LoRA ([r, i, 1, 1] / [o, r, 1, 1], ``proj_in`` /
    ``proj_out``) is flattened to its matrices and the product reshaped to
    W's. Returns {"unet": ..., "text_encoder": ...}: the states with the
    fused tensors replaced (the others are the inputs' own). A pair whose
    path names no tensor, or more than one, raises ``KeyError``."""
    targets = {"unet": dict(unet_state), "text_encoder": dict(text_encoder_state or {})}
    resolvers = {name: _kohya_resolver(state) for name, state in targets.items()}
    for key, down in lora_state.items():
        if ".alpha" in key or "lora_down" not in key:
            continue
        name, prefix = (("text_encoder", "lora_te_") if key.startswith("lora_te_")
                        else ("unet", "lora_unet_"))
        stem = key.split(".")[0]
        target = resolvers[name](stem[len(prefix):])
        if target is None:
            raise KeyError(f"cannot map kohya LoRA key {key}")
        up = lora_state[key.replace("lora_down", "lora_up")]
        rank = down.shape[0]
        a = float(lora_state[stem + ".alpha"]) / rank if stem + ".alpha" in lora_state else 1.0
        weight = targets[name][target]
        fused = _fused(weight.reshape(weight.shape[0], -1), up.reshape(up.shape[0], -1),
                       down.reshape(rank, -1), alpha * a)
        targets[name][target] = fused.reshape(weight.shape)
    return targets


def _kohya_resolver(state: Dict[str, torch.Tensor]):
    """-> a function from a kohya module path ('_'-joined) to the one
    ``<path>.weight`` key of ``state`` it names, or None. Where the path with every
    '_' a '.' is no key, both sides are compared with their separators
    stripped, and only a unique match counts (so ``time_embedding_linear_1``
    finds ``time_embedding.linear_1`` and ``time_embedding.linear.1`` alike)."""
    stripped: Dict[str, list] = {}
    for k in state:
        stripped.setdefault(k.replace(".", "").replace("_", ""), []).append(k)

    def resolve(flat: str) -> Optional[str]:
        dotted = flat.replace("_", ".") + ".weight"
        if dotted in state:
            return dotted
        matches = stripped.get(flat.replace("_", "") + "weight", [])
        return matches[0] if len(matches) == 1 else None

    return resolve


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
