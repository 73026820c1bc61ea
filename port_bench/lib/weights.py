"""Seeded weights: every tensor of the models' state dicts drawn on the
device from ``--seed``, one large draw per model and type, in the type it
is served in. The same call gives the program and the reference the same
values (the reference takes them in float32).

The draws are uniform: a matrix or kernel in +-1/sqrt(fan in) (PyTorch's
default bound; embeddings included), a 1-D scale (a norm's weight) in
1 +- 0.1, a bias or shift in +-0.05. Zero-initialized projections (the epi
modules' ``proj_out``, the pose merges) are drawn like any other, so that
every path of the model does work.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import torch

Shapes = Dict[str, Dict[str, Tuple[int, ...]]]


def shapes(mods) -> Shapes:
    """{model: {state-dict key: shape}} of the architecture's ``reference``
    bundle."""
    return {name: {k: tuple(t.shape) for k, t in mod.state_dict().items()}
            for name, mod in mods.items()}


def _bounds(key: str, shape) -> Tuple[float, float]:
    """(scale, shift) of a tensor's uniform draw u in [0, 1): u * scale + shift."""
    if len(shape) >= 2:
        a = 1.0 / math.sqrt(math.prod(shape[1:]))
        return 2 * a, -a
    if key.endswith("weight"):
        return 0.2, 0.9
    return 0.1, -0.05


def draw(table: Shapes, seed: int, device, dtype_of: Callable[[str, str], torch.dtype]
         ) -> Iterable[Tuple[str, Dict[str, torch.Tensor]]]:
    """Yield (model, {key: tensor}) per model, in the table's order. Within a
    model the keys of each type (``dtype_of(model, key)``) come from one flat
    draw of a ``torch.Generator`` on ``device`` seeded ``seed``, in the state
    dict's order, float32 keys first. The tensors are views of that draw."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for model, keys in table.items():
        out: Dict[str, torch.Tensor] = {}
        groups: Dict[torch.dtype, list] = {}
        for key in keys:
            groups.setdefault(dtype_of(model, key), []).append(key)
        for dtype in sorted(groups, key=lambda d: d != torch.float32):
            names = groups[dtype]
            total = sum(math.prod(keys[k]) for k in names)
            flat = torch.rand(total, generator=gen, device=device, dtype=dtype)
            off = 0
            for k in names:
                n = math.prod(keys[k])
                scale, shift = _bounds(k, keys[k])
                out[k] = flat[off:off + n].mul_(scale).add_(shift).view(keys[k])
                off += n
        yield model, out
        del out, groups
