"""The system under test, as the benchmark builds it: the program's modules
at a configuration's widths, filled with the run's seeded weights through
``load_state_dict`` (as a build from the released files fills them)."""
from __future__ import annotations

import torch

from . import weights
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
    from ..reference import model as ref_model

    return weights.shapes(ref_model.build(config, "meta", vae_encoder))


def build_modules(config: dict, seed: int, device, vae_encoder: bool = False,
                  unet_dtype=None):
    """The program's ``PipelineModules`` at ``config``'s widths on ``device``,
    weights drawn from ``seed``; ``unet_dtype`` where the UNet is held in
    another type than the rest (training: float32 until the train state
    casts its frozen part)."""
    from cvd_tpu_torch.models.clip_text import CLIPTextConfig
    from cvd_tpu_torch.models.unet import UNetConfig
    from cvd_tpu_torch.models.vae import VAEConfig
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.schedulers.ddim import DDIMScheduler

    def tuples(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    pe = config["pose_encoder"]
    modules = PipelineModules.create(
        unet_config=UNetConfig(**tuples(config["unet"])),
        vae_config=VAEConfig(**tuples(config["vae"])),
        clip_config=CLIPTextConfig(**config["clip"]),
        pose_encoder_kwargs=dict(downscale_factor=pe["downscale_factor"], nums_rb=pe["nums_rb"],
                                 cin=pe["cin"],
                                 temporal_attention_nhead=pe["temporal_attention_nhead"],
                                 temporal_pe_max_len=pe["temporal_position_encoding_max_len"]),
        scheduler=DDIMScheduler(**config["scheduler"]), device=device,
        dtype=dtype(config["dtype"]), unet_dtype=unet_dtype, vae_encoder=vae_encoder)
    table = weight_table(config, vae_encoder)
    for name, state in weights.draw(table, derive(seed, "weights"), device,
                                    weight_dtype(config)):
        getattr(modules, name).load_state_dict(state, strict=True)
    return modules


def reference_modules(config: dict, seed: int, device, vae_encoder: bool = False):
    """The reference's models on ``device`` in float32, holding the same
    weights as ``build_modules`` gives the program."""
    from ..reference import model as ref_model

    mods = ref_model.build(config, device, vae_encoder)
    for name, state in weights.draw(weights.shapes(mods), derive(seed, "weights"), device,
                                    weight_dtype(config)):
        mods[name].load_state_dict(state, strict=True)
    return mods.float()
