"""Reading PyTorch artifacts (.ckpt / .pt / .bin via torch, .safetensors)
as state dicts of host tensors (port of ``cvd_tpu/io/torch_io.py``).

The reference consumes four artifact kinds (inference_epi.py:72-145): an
SD1.5 diffusers folder, the AnimateDiff motion-module .ckpt, the CVD epi
.ckpt (dict with 'unet_trainable_dict'), and the CameraCtrl pose-adaptor
.ckpt (dicts 'pose_encoder_state_dict' + 'attention_processor_state_dict').
Tensors come back in the file's dtype: the one cast happens when a loader
copies them into the parameters.
"""
from __future__ import annotations

import os
import pickle
import warnings
from typing import Dict, Optional

import torch


def _torch_load(path: str):
    """``torch.load`` onto the host, memory-mapped where the file allows it
    (a zip archive written by ``torch.save``), so a checkpoint's bytes are
    paged in as they are copied and not all at once. The released files are
    dicts of tensors and ints, which ``weights_only`` takes; an older pickle
    that it refuses is read the full way, which runs the file's pickle: a
    warning says so."""
    try:
        try:
            return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        except (RuntimeError, ValueError):   # a legacy (non-zip) file cannot be mapped
            return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        warnings.warn(f"{path}: not a plain dict of tensors ({str(e).splitlines()[0]}); "
                      "reading it with weights_only=False, which executes the file's pickle",
                      stacklevel=3)
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_state(path: str, sub_dict: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Load a torch checkpoint or safetensors file as {key: host tensor}.

    sub_dict: pull a nested state dict (e.g. 'unet_trainable_dict',
    'pose_encoder_state_dict', 'lora_state_dict', 'state_dict'). Without it
    a file whose first entry is no tensor and that has a 'state_dict' entry
    is unwrapped. Entries that are not tensors ('epoch', 'global_step') are
    dropped.
    """
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path, device="cpu")

    obj = _torch_load(path)
    if sub_dict is not None:
        obj = obj[sub_dict]
    elif isinstance(obj, dict) and "state_dict" in obj and not any(
            isinstance(v, torch.Tensor) for v in list(obj.values())[:1]):
        obj = obj["state_dict"]
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_diffusers_folder_weights(folder: str) -> Dict[str, torch.Tensor]:
    """Load a diffusers model subfolder (prefers .safetensors, else .bin)."""
    for name in (
        "diffusion_pytorch_model.safetensors",
        "model.safetensors",
        "diffusion_pytorch_model.bin",
        "pytorch_model.bin",
    ):
        p = os.path.join(folder, name)
        if os.path.exists(p):
            return load_torch_state(p)
    raise FileNotFoundError(f"no weight file found under {folder}")
