"""Flax param tree -> the port's state dict.

``state_dict_from_flax`` takes a nested dict of numpy arrays (a Flax param
tree after ``np.asarray``, with or without the ``{"params": ...}`` wrapper)
and returns the state dict that the port's modules load with
``load_state_dict(strict=True)``. It applies the key rules of
``cvd_tpu/io/key_mapping.py:198-229`` (``flax_path_to_torch_key``), except
that ``time_embedding.linear_1`` / ``linear_2`` keep the names the SD1.5
checkpoint gives them and the image LoRA's ``to_*_lora`` sit under
``processor``, as in CameraCtrl's LoRA file, and its kernel transposes (``:240-241``): a 4-D conv kernel [kh, kw, in, out] goes
to [out, in, kh, kw], a 2-D dense kernel [in, out] to [out, in]. It flattens
the tree itself and imports no flax.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_INV_SPECIAL = {
    "net_0_proj": "net.0.proj",
    "net_2": "net.2",
    "mlp_fc1": "mlp.fc1",
    "mlp_fc2": "mlp.fc2",
}
_TRAILING_IDX = re.compile(r"^(.*?)((?:_\d+)+)$")
# module names whose trailing index is part of the checkpoint's name, not a
# list position: diffusers' TimestepEmbedding has ``linear_1`` / ``linear_2``
_KEEP_INDEX = {("time_embedding", "linear_1"), ("time_embedding", "linear_2")}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """Module path of the JAX package -> reference state-dict key."""
    out = []
    for i, el in enumerate(path):
        if el == "Conv_0":
            continue
        if i == len(path) - 1 and el in ("kernel", "scale", "embedding"):
            out.append("weight")
            continue
        if el == "qkv_merge" or el.endswith(("_lora_sync", "_lora")):
            # these live on the attention *processor* in the reference: the
            # pose merge, the sync-LoRA and the image LoRA (to_q_lora/down ->
            # processor.to_q_lora.down)
            out.append("processor")
        if el in _INV_SPECIAL:
            out.append(_INV_SPECIAL[el])
            continue
        m = _TRAILING_IDX.match(el)
        if m and (path[i - 1] if i else "", el) not in _KEEP_INDEX:
            el = m.group(1) + m.group(2).replace("_", ".")
        out.append(el)
        if re.fullmatch(r"motion_modules\.\d+", out[-1]):
            out.append("temporal_transformer")
        elif re.fullmatch(r"epi_modules\.\d+", out[-1]):
            out.append("epi_transformer")
    return ".".join(out)


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> {reference key: torch tensor}."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        v = np.asarray(value)
        if path[-1] == "kernel":
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
        out[flax_path_to_torch_key(path)] = torch.from_numpy(np.array(v, copy=True))
    return out
