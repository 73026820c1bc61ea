"""Architecture ``cvd_sd15``: CVD on SD1.5 (arXiv:2405.17414), the SD1.5 UNet
with AnimateDiff motion modules, CameraCtrl's pose encoder and the epi
modules, one CLIP-L text encoder and the SD VAE. A configuration names it
under ``"architecture"``; its ``unet``, ``vae``, ``clip``, ``pose_encoder`` and
``scheduler`` groups give the widths.

What the harness asks of an architecture, here for this model:

- ``reference(config, device, vae_encoder)``: the float32 reference's models
  as a ``ModuleDict`` (``reference/model.py``), parameters uninitialized; its
  state dicts are the table the seeded weights are drawn from;
- ``program(config, device, vae_encoder, unet_dtype)``: the program's
  modules, not yet filled, with an attribute for each model of that table;
- ``request_parts`` / ``train_step_parts``: the counted parts of a unit
  (``lib/count.py``);
- ``reference_request`` / ``reference_steps``: what the entries' checks run.
"""
from __future__ import annotations

import torch

from port_bench.lib import count, names, port
from port_bench.reference import model, sampling, training


def reference(config: dict, device, vae_encoder: bool = False) -> torch.nn.ModuleDict:
    """The four models (``unet``, ``vae``, ``clip``, ``pose_encoder``) on
    ``device``, parameters uninitialized; ``vae_encoder`` adds the VAE's
    encoder (training)."""
    return model.build(config, device, vae_encoder)


def program(config: dict, device, vae_encoder: bool = False, unet_dtype=None):
    """The program's ``PipelineModules`` at ``config``'s widths on ``device``,
    built as its CLI builds them and not yet filled, every key of the
    configuration's groups passed on; ``unet_dtype`` where the UNet is held
    in another type than the rest (training: float32 until the train state
    casts its frozen part)."""
    from cvd_tpu_torch.models.clip_text import CLIPTextConfig
    from cvd_tpu_torch.models.pose_encoder import CameraPoseEncoder
    from cvd_tpu_torch.models.unet import UNetConfig
    from cvd_tpu_torch.models.vae import VAEConfig
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.schedulers.ddim import DDIMScheduler

    def tuples(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    served = port.dtype(config["dtype"])
    unet = UNetConfig(**tuples(config["unet"]))
    pose = {("temporal_pe_max_len" if k == "temporal_position_encoding_max_len" else k): v
            for k, v in tuples(config["pose_encoder"]).items()}
    channels = pose.pop("channels")
    modules = PipelineModules.create(
        unet_config=unet, vae_config=VAEConfig(**tuples(config["vae"])),
        clip_config=CLIPTextConfig(**config["clip"]), pose_encoder_kwargs=pose,
        scheduler=DDIMScheduler(**config["scheduler"]), device=device, dtype=served,
        unet_dtype=unet_dtype, vae_encoder=vae_encoder)
    if channels != unet.block_out_channels:
        # ``create`` gives the pose encoder the UNet's widths: made again at
        # the configured ones, as ``create`` makes it
        with torch.device("meta"):
            pe = CameraPoseEncoder(channels=channels, **pose)
        pe = pe.to_empty(device=device).to(dtype=served).eval().requires_grad_(False)
        if torch.device(device).type == "cuda":
            pe = pe.to(memory_format=torch.channels_last)
        modules.pose_encoder = pe
    return modules


def _reference_on_meta(config: dict, vae_encoder: bool = False) -> torch.nn.ModuleDict:
    """The configuration's own architecture's reference on ``meta``: an
    architecture that changes the models alone takes these parts as they
    are."""
    return names.architecture(config["architecture"]).reference(config, "meta", vae_encoder)


def request_parts(config: dict, frames: int, size: int, steps: int) -> list:
    """The parts of one 2-view request: the prompt and the negative prompt
    through CLIP, the pose pair through the pose encoder, ``steps`` UNet
    calls on the 4 CFG rows, the decode of both views' frames."""
    mods = _reference_on_meta(config)
    meta = count.meta
    lat = size // 8
    pose = [meta(4, frames, *p.shape[2:]) for p in
            mods["pose_encoder"](meta(2, frames, size, size, 6))]
    cond = model.EpiCond(meta(4 * frames, 3, 3), frames, config["epi_F_mat_size"],
                         slope=meta(1))
    with torch.no_grad():
        return [
            count.part("clip", 2, lambda: mods["clip"](meta(1, 77, dtype=torch.long))),
            count.part("pose_encoder", 1,
                       lambda: mods["pose_encoder"](meta(2, frames, size, size, 6))),
            count.part("unet", steps, lambda: mods["unet"](
                meta(4, frames, lat, lat, 4), meta(4, dtype=torch.long),
                meta(4, 77, config["unet"]["cross_attention_dim"]), pose, cond)),
            count.part("vae", 1, lambda: mods["vae"].decode(meta(2 * frames, lat, lat, 4))),
        ]


def train_step_parts(config: dict, frames: int, size: int) -> list:
    """The parts of one training step on a folded pair: the VAE encode of
    both videos' frames (8 a call), CLIP on the two rows, the pose encoder,
    and the UNet's forward on the 2 rows with its backward into the
    trainable keys."""
    mods = _reference_on_meta(config, vae_encoder=True)
    meta = count.meta
    lat = size // 8
    for k, p in mods["unet"].named_parameters():
        p.requires_grad_(any(s in k for s in config["trainable"]))
    pose = [meta(2, frames, *p.shape[2:]) for p in
            mods["pose_encoder"](meta(2, frames, size, size, 6))]
    cond = model.EpiCond(meta(2 * frames, 3, 3), frames, config["epi_F_mat_size"],
                         slope=meta(1))

    def unet():
        pred = mods["unet"](meta(2, frames, lat, lat, 4), meta(2, dtype=torch.long),
                            meta(2, 77, config["unet"]["cross_attention_dim"]), pose, cond)
        pred.float().pow(2).mean().backward()

    with torch.no_grad():
        parts = [
            count.part("vae", 2 * frames // 8,
                       lambda: mods["vae"].moments(meta(8, size, size, 3))),
            count.part("clip", 1, lambda: mods["clip"](meta(2, 77, dtype=torch.long))),
            count.part("pose_encoder", 1,
                       lambda: mods["pose_encoder"](meta(2, frames, size, size, 6))),
        ]
    return parts + [count.part("unet", 1, unet)]


# a whole 2-view request: (mods, config, prompt_ids, negative_ids, plucker,
# F_mats, latents, generator, steps, guidance) -> videos [2, F, H, W, 3]
reference_request = sampling.request


def reference_steps(mods, config: dict, batches: list, generator, draw_dtype) -> dict:
    """The reference's training steps over ``batches``, one each (on the
    models' device): {"loss": [per step], "grad": {key: the first step's
    clipped gradient}, "start": {key: the trained weight before the first
    step}, "end": {key: the same after the last}}."""
    start = {k: p.detach().clone() for k, p in training.trainable(mods).items()}
    out = training.steps(mods, config, batches, generator, draw_dtype)
    return dict(out, start=start,
                end={k: p.detach() for k, p in training.trainable(mods).items()})
