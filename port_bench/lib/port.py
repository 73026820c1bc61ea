"""The system under test, as the benchmark builds it: the program's modules
at a configuration's widths, built by the configuration's architecture
(``architectures/<name>.py``) and filled with the run's seeded weights
through ``load_state_dict`` (as a build from the released files fills
them); and the reference's models holding the same weights."""
from __future__ import annotations

import torch

from . import names, weights
from .names import derive


def dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def weight_dtype(config: dict):
    """(model, key) -> the type a weight is drawn and served in: the
    configuration's, float32 for the trainable keys of the UNet."""
    served = dtype(config["dtype"])
    trainable = tuple(config.get("trainable", ()))

    def of(model: str, key: str) -> torch.dtype:
        if model == "unet" and trainable and any(s in key for s in trainable):
            return torch.float32
        return served
    return of


def weight_table(config: dict, vae_encoder: bool) -> weights.Shapes:
    """What the weights are drawn from: the shapes of the architecture's
    ``reference`` models."""
    return weights.shapes(names.architecture(config["architecture"]).reference(
        config, "meta", vae_encoder))


def build_modules(config: dict, seed: int, device, vae_encoder: bool = False,
                  unet_dtype=None):
    """The program's modules at ``config``'s widths on ``device``, as its
    architecture's ``program`` builds them, weights drawn from ``seed``;
    ``unet_dtype`` where the UNet is held in another type than the rest."""
    modules = names.architecture(config["architecture"]).program(config, device, vae_encoder,
                                                                 unet_dtype)
    for name, state in weights.draw(weight_table(config, vae_encoder), derive(seed, "weights"),
                                    device, weight_dtype(config)):
        getattr(modules, name).load_state_dict(state, strict=True)
    return modules


def reference_modules(config: dict, seed: int, device, vae_encoder: bool = False):
    """The architecture's ``reference`` models on ``device`` in float32,
    holding the same weights as ``build_modules`` gives the program."""
    mods = names.architecture(config["architecture"]).reference(config, device, vae_encoder)
    for name, state in weights.draw(weights.shapes(mods), derive(seed, "weights"), device,
                                    weight_dtype(config)):
        mods[name].load_state_dict(state, strict=True)
    return mods.float()
