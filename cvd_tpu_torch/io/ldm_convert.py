"""LDM / CompVis (civitai) single-file checkpoints -> the diffusers-layout
state dicts the port's modules are named by (port of
``cvd_tpu/io/ldm_convert.py``).

The standard SD conversion the reference uses
(animatediff/utils/convert_from_ckpt.py: convert_ldm_unet_checkpoint :328,
convert_ldm_vae_checkpoint :559, convert_ldm_clip_checkpoint :716) as pure
key renames over dicts of tensors, feeding ``io/checkpoints.merge_torch_state``.
Covers SD1.x single-file ``.ckpt`` / ``.safetensors`` models (the reference's
``civitai_base_model``, inference_epi.py:49-69) and the kohya LoRA fused over
them (``civitai_lora_ckpt``, inference_epi.py:138-139). A ``.safetensors``
file needs the ``safetensors`` package; a ``torch.save`` file (``.ckpt``,
the state at the top level or under ``state_dict``) needs nothing more.
"""
from __future__ import annotations

from typing import Dict

import torch

from cvd_tpu_torch.io.checkpoints import (
    clip_hf_name, clip_rename, merge_torch_state, vae_legacy_rename,
)
from cvd_tpu_torch.io.torch_io import load_torch_state

State = Dict[str, torch.Tensor]

_RES_MAP = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}


def _rename_resnet(rest: str) -> str:
    for old, new in _RES_MAP.items():
        if rest.startswith(old):
            return new + rest[len(old):]
    raise KeyError(rest)


def _strip(state: State, prefix: str) -> State:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def convert_ldm_unet_state(state: State) -> State:
    """'model.diffusion_model.*' -> diffusers UNet2DConditionModel keys."""
    out: State = {}
    for k, v in _strip(state, "model.diffusion_model.").items():
        leaf = k.split(".")[-1]
        if k.startswith("time_embed.0."):
            out["time_embedding.linear_1." + leaf] = v
        elif k.startswith("time_embed.2."):
            out["time_embedding.linear_2." + leaf] = v
        elif k.startswith("input_blocks.0.0."):
            out["conv_in." + leaf] = v
        elif k.startswith("out.0."):
            out["conv_norm_out." + leaf] = v
        elif k.startswith("out.2."):
            out["conv_out." + leaf] = v
        elif k.startswith("input_blocks."):
            parts = k.split(".")
            i, sub = int(parts[1]), int(parts[2])
            rest = ".".join(parts[3:])
            block, j = (i - 1) // 3, (i - 1) % 3
            if j == 2:  # downsample at input_blocks 3, 6, 9
                if not rest.startswith("op."):
                    raise KeyError(f"unhandled LDM unet key {k}")
                out[f"down_blocks.{block}.downsamplers.0.conv." + rest[len("op."):]] = v
            elif sub == 0:
                out[f"down_blocks.{block}.resnets.{j}." + _rename_resnet(rest)] = v
            else:
                out[f"down_blocks.{block}.attentions.{j}." + rest] = v
        elif k.startswith("middle_block."):
            parts = k.split(".")
            sub, rest = int(parts[1]), ".".join(parts[2:])
            if sub == 0:
                out["mid_block.resnets.0." + _rename_resnet(rest)] = v
            elif sub == 1:
                out["mid_block.attentions.0." + rest] = v
            else:
                out["mid_block.resnets.1." + _rename_resnet(rest)] = v
        elif k.startswith("output_blocks."):
            parts = k.split(".")
            i, sub = int(parts[1]), int(parts[2])
            rest = ".".join(parts[3:])
            block, j = i // 3, i % 3
            if sub == 0:
                out[f"up_blocks.{block}.resnets.{j}." + _rename_resnet(rest)] = v
            elif rest.startswith("conv."):  # upsampler (last layer of blocks 0, 1, 2)
                out[f"up_blocks.{block}.upsamplers.0." + rest] = v
            else:
                out[f"up_blocks.{block}.attentions.{j}." + rest] = v
        else:
            raise KeyError(f"unhandled LDM unet key {k}")
    return out


def convert_ldm_vae_state(state: State) -> State:
    """'first_stage_model.*' -> diffusers AutoencoderKL keys (the mid
    attention keeps its SD-era q / k / v / norm names, which
    ``vae_legacy_rename`` maps at the merge)."""
    src = _strip(state, "first_stage_model.")
    # the decoder's up levels, for the index reversal
    n_up = 1 + max((int(k.split(".")[2]) for k in src if k.startswith("decoder.up.")),
                   default=-1)
    out: State = {}
    for k, v in src.items():
        parts = k.split(".")
        if k.startswith(("quant_conv.", "post_quant_conv.")) or parts[1] in ("conv_in",
                                                                              "conv_out"):
            out[k] = v
        elif parts[1] == "norm_out":
            out[f"{parts[0]}.conv_norm_out.{parts[-1]}"] = v
        elif parts[1] == "mid":
            rest = ".".join(parts[3:]).replace("nin_shortcut", "conv_shortcut")
            if parts[2] == "block_1":
                out[f"{parts[0]}.mid_block.resnets.0.{rest}"] = v
            elif parts[2] == "block_2":
                out[f"{parts[0]}.mid_block.resnets.1.{rest}"] = v
            else:  # attn_1: CompVis's 'proj_out' is diffusers-legacy 'proj_attn'
                if rest.startswith("proj_out."):   # (convert_from_ckpt.py:142-143)
                    rest = "proj_attn." + rest[len("proj_out."):]
                out[f"{parts[0]}.mid_block.attentions.0.{rest}"] = v
        elif parts[1] == "down":
            i = int(parts[2])
            if parts[3] == "block":
                rest = ".".join(parts[5:]).replace("nin_shortcut", "conv_shortcut")
                out[f"encoder.down_blocks.{i}.resnets.{parts[4]}.{rest}"] = v
            else:  # downsample.conv
                out[f"encoder.down_blocks.{i}.downsamplers.0.conv.{parts[-1]}"] = v
        elif parts[1] == "up":
            i = n_up - 1 - int(parts[2])  # LDM numbers the decoder's levels the other way
            if parts[3] == "block":
                rest = ".".join(parts[5:]).replace("nin_shortcut", "conv_shortcut")
                out[f"decoder.up_blocks.{i}.resnets.{parts[4]}.{rest}"] = v
            else:  # upsample.conv
                out[f"decoder.up_blocks.{i}.upsamplers.0.conv.{parts[-1]}"] = v
        else:
            raise KeyError(f"unhandled LDM vae key {k}")
    return out


def convert_ldm_clip_state(state: State) -> State:
    """'cond_stage_model.transformer.*' -> transformers CLIPTextModel keys."""
    return _strip(state, "cond_stage_model.transformer.")


def load_civitai_base_model(modules, path: str) -> Dict[str, int]:
    """Swap the SD base (the UNet's spatial weights, the VAE and CLIP) for a
    civitai single-file model's, in place, like the reference's
    load_civitai_base_model (inference_epi.py:49-69). Every converted key
    lands or the load raises; the text encoder's ``text_projection`` is
    dropped, and keys outside the three prefixes (``model_ema.*``,
    ``alphas_cumprod``, ...) are not read. A decode-only VAE (the samplers')
    takes no ``encoder.`` / ``quant_conv.`` key. Returns the keys loaded
    per module."""
    state = load_torch_state(path)
    unet = convert_ldm_unet_state(state)
    vae = convert_ldm_vae_state(state)
    if not hasattr(modules.vae, "encoder"):
        vae = {k: v for k, v in vae.items() if not k.startswith(("encoder.", "quant_conv."))}
    clip = {k: v for k, v in convert_ldm_clip_state(state).items()
            if "text_projection" not in k}
    # merge_torch_state raises on any key that lands nowhere
    report = {"unet": len(merge_torch_state(modules.unet, unet)),
              "vae": len(merge_torch_state(modules.vae, vae, rename=vae_legacy_rename))}
    if clip:
        report["text_encoder"] = len(merge_torch_state(modules.clip, clip, rename=clip_rename))
    return report


def apply_civitai_lora(modules, path: str, alpha: float = 0.6) -> int:
    """Fuse a kohya-format LoRA into the UNet's weights, in place (the
    reference's pipe.load_lora_weights, inference_epi.py:138-139). As in the
    JAX package (cvd_tpu/io/ldm_convert.py:195-196), the text encoder's
    fusion is computed and dropped: only the UNet's is merged. Returns the
    number of UNet tensors fused."""
    from cvd_tpu_torch.io.lora import fuse_kohya_lora_into_pipeline

    lora = load_torch_state(path)
    unet_state = modules.unet.state_dict()
    te_state = {clip_hf_name(k): v for k, v in modules.clip.state_dict().items()}
    fused = fuse_kohya_lora_into_pipeline(unet_state, te_state, lora, alpha)["unet"]
    changed = {k: v for k, v in fused.items() if v is not unet_state[k]}
    merge_torch_state(modules.unet, changed)
    return len(changed)
