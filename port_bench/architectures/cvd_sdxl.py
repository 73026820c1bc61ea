"""Architecture ``cvd_sdxl``: CVD's 2-view sampler on the SDXL backbone: the
SDXL base UNet (three levels, transformer depth per level, heads 64 wide,
Linear projections, the ``text_time`` added embedding) with AnimateDiff-
SDXL's motion modules, CameraCtrl's pose encoder and CVD's epi modules at
its widths, CLIP-L and OpenCLIP bigG joined along the width, and the SD VAE
at SDXL's latent scale. A configuration names it under ``"architecture"``;
its ``unet``, ``vae``, ``clip``, ``clip_2``, ``pose_encoder`` and
``scheduler`` groups give the widths. Sampling only: the training functions
raise, and no cell trains this architecture.

The functions the harness asks of an architecture are ``cvd_sd15.py``'s.
"""
from __future__ import annotations

import torch

from port_bench.lib import count, names, port
from port_bench.reference import model, model_sdxl, sampling


def reference(config: dict, device, vae_encoder: bool = False) -> torch.nn.ModuleDict:
    """The five models (``unet``, ``vae``, ``clip``, ``clip_2``,
    ``pose_encoder``) on ``device``, parameters uninitialized."""
    return model_sdxl.build(config, device, vae_encoder)


def program(config: dict, device, vae_encoder: bool = False, unet_dtype=None):
    """The program's ``PipelineModules`` at ``config``'s widths on ``device``,
    with the second text encoder, not yet filled."""
    from cvd_tpu_torch.models.clip_text import CLIPTextConfig
    from cvd_tpu_torch.models.unet import UNetConfig
    from cvd_tpu_torch.models.vae import VAEConfig
    from cvd_tpu_torch.pipelines.common import PipelineModules
    from cvd_tpu_torch.schedulers.ddim import DDIMScheduler

    def tuples(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    unet = UNetConfig(**tuples(config["unet"]))
    pose = {("temporal_pe_max_len" if k == "temporal_position_encoding_max_len" else k): v
            for k, v in tuples(config["pose_encoder"]).items()}
    if pose.pop("channels") != unet.block_out_channels:
        raise ValueError("the program's pose encoder takes the UNet's widths")
    return PipelineModules.create(
        unet_config=unet, vae_config=VAEConfig(**tuples(config["vae"])),
        clip_config=CLIPTextConfig(**config["clip"]),
        clip_2_config=CLIPTextConfig(**config["clip_2"]), pose_encoder_kwargs=pose,
        scheduler=DDIMScheduler(**config["scheduler"]), device=device,
        dtype=port.dtype(config["dtype"]), unet_dtype=unet_dtype, vae_encoder=vae_encoder)


def request_parts(config: dict, frames: int, size: int, steps: int) -> list:
    """The parts of one 2-view request: the prompt and the negative prompt
    through each text encoder, the pose pair through the pose encoder,
    ``steps`` UNet calls on the 4 CFG rows, the decode of both views'
    frames."""
    mods = names.architecture(config["architecture"]).reference(config, "meta")
    meta = count.meta
    lat = size // 8
    pose = [meta(4, frames, *p.shape[2:]) for p in
            mods["pose_encoder"](meta(2, frames, size, size, 6))]
    cond = model.EpiCond(meta(4 * frames, 3, 3), frames, config["epi_F_mat_size"],
                         slope=meta(1))
    ids = meta(1, 77, dtype=torch.long)
    with torch.no_grad():
        return [
            count.part("clip", 2, lambda: mods["clip"].encode(ids)),
            count.part("clip_2", 2, lambda: mods["clip_2"].encode(ids)),
            count.part("pose_encoder", 1,
                       lambda: mods["pose_encoder"](meta(2, frames, size, size, 6))),
            count.part("unet", steps, lambda: mods["unet"](
                meta(4, frames, lat, lat, 4), meta(4, dtype=torch.long),
                meta(4, 77, config["unet"]["cross_attention_dim"]), pose, cond,
                meta(4, config["clip_2"]["projection_dim"]), meta(4, 6))),
            count.part("vae", 1, lambda: mods["vae"].decode(meta(2 * frames, lat, lat, 4))),
        ]


def train_step_parts(config: dict, frames: int, size: int) -> list:
    raise NotImplementedError("cvd_sdxl is sampled, not trained, in this benchmark")


@torch.no_grad()
def reference_request(mods, config: dict, prompt_ids, negative_ids, plucker, F_mats, latents,
                      generator: torch.Generator, steps: int, guidance: float,
                      decode_frames: int = 8) -> torch.Tensor:
    """A whole 2-view request (``sampling.request``'s DDIM, guidance and
    epipolar pairing) with SDXL's conditioning: the joined text states, the
    pooled text and the time ids of every CFG row; the latents decoded at
    the VAE's ``scaling_factor``. -> videos [2, F, H, W, 3] float32 in
    [0, 1]."""
    device = latents.device
    (uncond, pool_u), (cond, pool_c) = (model_sdxl.encode_text(mods, ids)
                                        for ids in (negative_ids, prompt_ids))
    text = torch.cat([uncond, cond, uncond, cond])
    pooled = torch.cat([pool_u, pool_c, pool_u, pool_c])
    ids6 = model_sdxl.time_ids(plucker.shape[2], 4, device)
    pose = [sampling.cfg4(p) for p in mods["pose_encoder"](plucker.float())]
    Fr = plucker.shape[1]
    F4 = sampling.cfg4(F_mats.float()).reshape(4 * Fr, 3, 3)
    sched = config["scheduler"]
    acp = sampling.alphas_cumprod(sched).to(device)
    ratio = sched["num_train_timesteps"] // steps
    x = latents.float()
    for t in sampling.ddim_timesteps(sched, steps).tolist():
        tt = torch.full((4,), t, dtype=torch.long, device=device)
        eps = mods["unet"](sampling.cfg4(x), tt, text, pose,
                           model.EpiCond(F4, Fr, config["epi_F_mat_size"], generator=generator),
                           pooled, ids6)
        e = eps[[0, 2]] + guidance * (eps[[1, 3]] - eps[[0, 2]])
        a_t = acp[t]
        a_prev = acp[t - ratio] if t - ratio >= 0 else torch.ones((), device=device)
        x0 = (x - (1 - a_t) ** 0.5 * e) / a_t ** 0.5
        x = a_prev ** 0.5 * x0 + (1 - a_prev) ** 0.5 * e
    V = x.shape[0]
    z = x.reshape((V * Fr,) + x.shape[2:]) / config["vae"]["scaling_factor"]
    imgs = torch.cat([mods["vae"].decode(z[i:i + decode_frames])
                      for i in range(0, z.shape[0], decode_frames)])
    imgs = torch.clamp(imgs / 2 + 0.5, 0.0, 1.0)
    return imgs.reshape((V, Fr) + imgs.shape[1:])


def reference_steps(mods, config: dict, batches: list, generator, draw_dtype) -> dict:
    raise NotImplementedError("cvd_sdxl is sampled, not trained, in this benchmark")
