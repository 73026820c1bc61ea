"""High-level weight import: the reference's four artifact kinds -> the
port's modules (port of ``cvd_tpu/io/checkpoints.py`` and of the import side
of ``cvd_tpu/io/key_mapping.py``).

Mirrors get_pipeline's load order and strictness (inference_epi.py:72-145):
  1. SD1.5 diffusers folder: unet (2D weights into the inflated 3D model,
     non-strict like from_pretrained_2d), vae, text_encoder
  2. AnimateDiff motion-module ckpt -> motion_modules params (an optional
     motion LoRA fused into it first)
  3. CVD epi ckpt ('unet_trainable_dict') -> epi_modules params
  4. CameraCtrl pose-adaptor ckpt -> pose encoder + qkv_merge processors
  5. the runtime image LoRA (CameraCtrl's RealEstate10K LoRA) -> the
     ``processor.to_*_lora`` deltas of the spatial attentions
  6. AnimateDiff's SparseCtrl ckpt -> ``SparseControlNetModel``
     (``load_sparse_controlnet_weights``; no reference entry point loads it)
The sync-LoRA of a sync-trained epi ckpt rides in its ``unet_trainable_dict``
and lands through 3 when the UNet is built with it, as do the auxiliary q/k
head's ``conv_auxiliary_{query,key}`` of a checkpoint that training with the
head wrote (a UNet without the head refuses them, as any unknown key). The port's modules carry the checkpoints' own names and torch's layouts, so
nothing is transposed and a key lands on the parameter of the same name.
Every loader holds the coverage contract of the reference's load-time
asserts (inference_epi.py:97-122): each checkpoint key it accepts lands on
a parameter of equal shape or is a named skipped buffer, else ``KeyError``.
Each returns the keys it consumed. Civitai single-file models and their
kohya LoRAs are imported by ``io/ldm_convert.py``.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from cvd_tpu_torch.io.torch_io import (
    _torch_load, load_diffusers_folder_weights, load_torch_state,
)

# buffers the released files carry and the modules compute themselves
SKIP_SUBSTRINGS = (
    "pos_encoder.pe",
    "pos_encoder.coords",  # EpiEncoding pixel-grid buffer (epi_module.py:288)
    "position_ids",
    "num_batches_tracked",
)

# VAE checkpoints from the SD era use legacy attention names.
_VAE_LEGACY_ATTN = {
    "q": "to_q", "k": "to_k", "v": "to_v", "proj_attn": "to_out_0",
    "query": "to_q", "key": "to_k", "value": "to_v",
}


def vae_legacy_rename(key: str) -> str:
    """Rename SD-era VAE attention keys to the modern diffusers layout."""
    if "attentions" not in key and "mid.attn" not in key:
        return key
    parts = key.split(".")
    parts = [
        _VAE_LEGACY_ATTN.get(p, p) if i >= len(parts) - 2 else p
        for i, p in enumerate(parts)
    ]
    key = ".".join(parts)
    return key.replace(".norm.", ".group_norm.").replace("to_out_0", "to_out.0")


def clip_rename(key: str) -> str:
    """transformers CLIPTextModel keys -> ``CLIPTextEncoder``'s."""
    key = key.replace("text_model.", "")
    key = key.replace("embeddings.token_embedding", "token_embedding")
    key = key.replace("encoder.layers", "layers")
    if key == "embeddings.position_embedding.weight":
        return "position_embedding"  # a direct parameter, no .weight leaf
    return key


def clip_hf_name(key: str) -> str:
    """``CLIPTextEncoder`` key -> transformers' (the inverse of
    ``clip_rename``): the released file's name, and what a kohya
    ``lora_te_*`` key names."""
    if key == "position_embedding":
        return "text_model.embeddings.position_embedding.weight"
    if key.startswith("token_embedding"):
        return "text_model.embeddings." + key
    if key.startswith("layers."):
        return "text_model.encoder." + key
    return "text_model." + key


@torch.no_grad()
def merge_torch_state(
    module: nn.Module,
    state: Dict[str, torch.Tensor],
    rename: Optional[Callable[[str], str]] = None,
) -> List[str]:
    """Copy a checkpoint's tensors into ``module``'s parameters, in place
    (each keeps its device, dtype, memory format and storage; the one cast is
    this copy). Parameters the checkpoint does not name stay as they are.

      rename: checkpoint-key rewrite applied first (VAE legacy attention
        names, HF CLIP names).

    A key containing one of ``SKIP_SUBSTRINGS`` is a buffer and counts as
    consumed. A legacy [o, i, 1, 1] conv stored where the model has a linear
    [o, i] is reshaped (LDM VAE attention q/k/v/proj_out; the reference's
    converter reshapes these too, convert_from_ckpt.py:196-210). Any other
    key that names no parameter, or one of another shape, raises ``KeyError``
    listing the first ten. On a ``meta``-device module only the routing and
    the shapes are checked. Returns the consumed checkpoint keys.
    """
    params = dict(module.named_parameters())
    consumed: List[str] = []
    errors: List[str] = []
    for tkey, value in state.items():
        key = rename(tkey) if rename is not None else tkey
        if any(s in key for s in SKIP_SUBSTRINGS):
            consumed.append(tkey)
            continue
        p = params.get(key)
        if p is None:
            errors.append(f"{tkey}: no parameter named {key}")
            continue
        if p.shape != value.shape:
            if (value.ndim == 4 and value.shape[2:] == (1, 1) and p.ndim == 2
                    and value.shape[:2] == p.shape):
                value = value.reshape(p.shape)
            else:
                errors.append(f"{tkey}: shape {tuple(value.shape)} vs parameter {key} "
                              f"{tuple(p.shape)}")
                continue
        if not p.is_meta:
            # moved in the file's dtype, cast on the parameter's device
            p.copy_(value.to(p.device))
        consumed.append(tkey)
    if errors:
        raise KeyError(
            f"{len(errors)} checkpoint keys failed to map; first 10:\n"
            + "\n".join(errors[:10])
        )
    return consumed


def load_sd_unet_weights(unet: nn.Module, folder: str, subfolder: str = "unet") -> List[str]:
    """SD1.5 2D UNet weights into the 3D UNet (motion/epi params untouched)."""
    return merge_torch_state(unet, load_diffusers_folder_weights(os.path.join(folder, subfolder)))


def load_vae_weights(vae: nn.Module, folder: str, subfolder: str = "vae") -> List[str]:
    """The VAE of the SD folder. A decode-only ``AutoencoderKL`` (the
    samplers') takes no ``encoder.`` / ``quant_conv.`` key."""
    state = load_diffusers_folder_weights(os.path.join(folder, subfolder))
    if not hasattr(vae, "encoder"):
        state = {k: v for k, v in state.items()
                 if not k.startswith(("encoder.", "quant_conv."))}
    return merge_torch_state(vae, state, rename=vae_legacy_rename)


def load_clip_weights(clip: nn.Module, folder: str, subfolder: str = "text_encoder") -> List[str]:
    state = load_diffusers_folder_weights(os.path.join(folder, subfolder))
    # drop projection heads if present (full CLIP checkpoints), unless the
    # encoder has one (SDXL's text_encoder_2: the pooled embedding)
    if getattr(clip, "text_projection", None) is None:
        state = {k: v for k, v in state.items() if "text_projection" not in k}
    return merge_torch_state(clip, state, rename=clip_rename)


def motion_module_state(
    path: str,
    motion_lora_ckpt: Optional[str] = None,
    motion_lora_scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """The motion-module keys of an AnimateDiff ckpt, with an optional
    motion LoRA (pan/zoom) fused into the state before import
    (convert_lora_safetensor_to_diffusers.py:28-49)."""
    state = load_torch_state(path)
    state = {k: v for k, v in state.items() if "motion_modules" in k or "pos_encoder" in k}
    if motion_lora_ckpt:
        from cvd_tpu_torch.io.lora import fuse_motion_lora_into_state

        lora_raw = load_torch_state(motion_lora_ckpt)
        # AnimateDiff motion-LoRA ckpts wrap the pairs in a 'state_dict' key
        if not any(".down." in k or ".up." in k for k in lora_raw):
            lora_raw = load_torch_state(motion_lora_ckpt, sub_dict="state_dict")
        state = fuse_motion_lora_into_state(state, lora_raw, motion_lora_scale)
    return state


def load_motion_module_weights(
    unet: nn.Module, path: str,
    motion_lora_ckpt: Optional[str] = None,
    motion_lora_scale: float = 1.0,
) -> List[str]:
    """AnimateDiff motion-module ckpt (inference_epi.py:100-105)."""
    return merge_torch_state(unet, motion_module_state(path, motion_lora_ckpt, motion_lora_scale))


def load_epi_module_weights(unet: nn.Module, path: str) -> List[str]:
    """CVD epi ckpt: dict with 'unet_trainable_dict' (inference_epi.py:107-113)."""
    return merge_torch_state(unet, load_torch_state(path, sub_dict="unet_trainable_dict"))


def sparse_controlnet_state(path: str) -> Dict[str, torch.Tensor]:
    """A SparseCtrl file's state: the top-level dict, or its ``state_dict``."""
    state = load_torch_state(path)
    if not any(k.startswith(("conv_in", "down_blocks")) for k in state):
        state = load_torch_state(path, sub_dict="state_dict")
    return state


def load_sparse_controlnet_weights(model: nn.Module, path: str) -> List[str]:
    """AnimateDiff SparseCtrl ckpt (``v3_sd15_sparsectrl_{rgb,scribble}.ckpt``,
    the state at the top level or under ``state_dict``) into a
    ``SparseControlNetModel`` of the file's layout, in place and strictly:
    every key of the file lands (or is a skipped buffer) and every parameter
    of the model is written, else ``KeyError``. The port's module names are
    the file's, so no rename is needed (the JAX package's
    ``sparsectrl_rename`` maps them onto its flat layer names)."""
    consumed = merge_torch_state(model, sparse_controlnet_state(path))
    written = {k for k in consumed if not any(s in k for s in SKIP_SUBSTRINGS)}
    missing = sorted(set(dict(model.named_parameters())) - written)
    if missing:
        raise KeyError(f"{len(missing)} SparseCtrl parameters not in {path}; first 10:\n"
                       + "\n".join(missing[:10]))
    return consumed


def load_pose_adaptor_weights(unet: nn.Module, pose_encoder: nn.Module, path: str) -> List[str]:
    """CameraCtrl ckpt: pose encoder + qkv_merge attention processors
    (inference_epi.py:115-123)."""
    consumed = merge_torch_state(
        pose_encoder, load_torch_state(path, sub_dict="pose_encoder_state_dict"))
    return consumed + merge_torch_state(
        unet, load_torch_state(path, sub_dict="attention_processor_state_dict"))


def image_lora_state(path: str) -> Dict[str, torch.Tensor]:
    """The image-LoRA file's pairs: the top-level dict, or its
    ``lora_state_dict`` where it has one (inference_epi.py:91-98)."""
    if not path.endswith(".safetensors"):
        raw = _torch_load(path)
        if isinstance(raw, dict) and "lora_state_dict" in raw:
            return {k: v.detach() for k, v in raw["lora_state_dict"].items()
                    if isinstance(v, torch.Tensor)}
    return load_torch_state(path)


def load_image_lora_weights(unet: nn.Module, path: str) -> List[str]:
    """The runtime image LoRA, strictly: every key of the file lands on a
    ``processor.to_*_lora`` parameter of the UNet (built with
    ``spatial_lora_rank``), in place."""
    state = image_lora_state(path)
    consumed = merge_torch_state(unet, state)
    if len(consumed) != len(state):
        raise KeyError(f"{len(state) - len(consumed)} image-LoRA keys unconsumed")
    return consumed


def load_sd_pipeline_weights(
    unet: nn.Module,
    vae: nn.Module,
    clip: nn.Module,
    sd_folder: str,
    unet_subfolder: str = "unet",
    motion_module_ckpt: Optional[str] = None,
    epi_module_ckpt: Optional[str] = None,
    pose_adaptor_ckpt: Optional[str] = None,
    pose_encoder: Optional[nn.Module] = None,
    motion_lora_ckpt: Optional[str] = None,
    motion_lora_scale: float = 1.0,
    image_lora_ckpt: Optional[str] = None,
    clip_2: Optional[nn.Module] = None,
) -> Dict[str, dict]:
    """The full reference load sequence, into the modules in place, one
    artifact at a time (each file's tensors are let go before the next is
    read); ``clip_2`` (SDXL) from the folder's ``text_encoder_2/``. Returns
    {artifact: {"keys": consumed count, "seconds": taken}}."""
    report: Dict[str, dict] = {}

    def load(name, fn, *args, **kw):
        t0 = time.perf_counter()
        consumed = fn(*args, **kw)
        report[name] = {"keys": len(consumed), "seconds": time.perf_counter() - t0}

    load("unet", load_sd_unet_weights, unet, sd_folder, unet_subfolder)
    load("vae", load_vae_weights, vae, sd_folder)
    load("text_encoder", load_clip_weights, clip, sd_folder)
    if clip_2 is not None:
        load("text_encoder_2", load_clip_weights, clip_2, sd_folder, "text_encoder_2")
    if motion_module_ckpt:
        load("motion_module", load_motion_module_weights, unet, motion_module_ckpt,
             motion_lora_ckpt=motion_lora_ckpt, motion_lora_scale=motion_lora_scale)
    if epi_module_ckpt:
        load("epi_module", load_epi_module_weights, unet, epi_module_ckpt)
    if pose_adaptor_ckpt:
        if pose_encoder is None:
            raise ValueError("pose_adaptor_ckpt needs the pose encoder to load into")
        load("pose_adaptor", load_pose_adaptor_weights, unet, pose_encoder, pose_adaptor_ckpt)
    if image_lora_ckpt:
        load("image_lora", load_image_lora_weights, unet, image_lora_ckpt)
    return report
