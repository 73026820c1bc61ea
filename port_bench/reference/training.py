"""The released epi fine-tuning step (``train_epi.yaml``): the VAE encode of
the folded pair (posterior sampled, 8 frames a call), noise and one
timestep per video, ``add_noise``, CLIP and the pose encoder, the UNet
with the epipolar conditioning (the first frames' pseudo lines of one
slope per step), the float32 MSE against the noise, the backward into the
epi modules alone, clipping by the global norm, AdamW. float32.

Each step draws, from the step generator and in this order: the posterior
noise of each 8-frame chunk (in ``draw_dtype``, the VAE's type), the noise,
the timesteps and the slope; a run that makes the same calls on a generator
of the same seed and device draws the same numbers."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from .model import EpiCond
from .sampling import VAE_SCALE, alphas_cumprod


def trainable(mods, substrings=("epi_modules",)) -> Dict[str, torch.nn.Parameter]:
    return {k: p for k, p in mods["unet"].named_parameters()
            if any(s in k for s in substrings)}


def encode(mods, pixels: torch.Tensor, generator, draw_dtype, chunk: int = 8) -> torch.Tensor:
    """[N, H, W, 3] in [-1, 1] -> sampled, scaled latents [N, h, w, 4]."""
    out = []
    for i in range(0, pixels.shape[0], chunk):
        mean, logvar = mods["vae"].moments(pixels[i:i + chunk])
        eps = torch.randn(mean.shape, generator=generator, dtype=draw_dtype,
                          device=generator.device).to(mean.device, torch.float32)
        out.append(mean + torch.exp(0.5 * logvar) * eps)
    return torch.cat(out) * VAE_SCALE


def loss(mods, config: dict, batch: dict, generator, draw_dtype) -> torch.Tensor:
    """One step's loss, its graph kept for the backward. ``batch``:
    pixel_values [B, F, H, W, 3], plucker [B, F, H, W, 6], F_mats [B, F, 3, 3],
    text_ids [B, 77], on the models' device."""
    px = batch["pixel_values"].float()
    B, Fr = px.shape[:2]
    device = px.device
    with torch.no_grad():
        latents = encode(mods, px.reshape((B * Fr,) + px.shape[2:]), generator, draw_dtype)
        latents = latents.reshape((B, Fr) + latents.shape[1:])
        noise = torch.randn(latents.shape, generator=generator, device=generator.device
                            ).to(device)
        t = torch.randint(0, config["scheduler"]["num_train_timesteps"], (B,),
                          generator=generator, device=generator.device).to(device)
        acp = alphas_cumprod(config["scheduler"]).to(device)[t].reshape(B, 1, 1, 1, 1)
        noisy = acp ** 0.5 * latents + (1 - acp) ** 0.5 * noise
        text = mods["clip"](batch["text_ids"])
        pose = mods["pose_encoder"](batch["plucker"].float())
    slope = torch.rand((1,), generator=generator, device=generator.device).to(device) * math.pi
    cond = EpiCond(batch["F_mats"].float().reshape(B * Fr, 3, 3), Fr, config["epi_F_mat_size"],
                   slope=slope)
    pred = mods["unet"](noisy, t, text, pose, cond)
    return torch.mean((pred.float() - noise) ** 2)


def steps(mods, config: dict, batches: List[dict], generator, draw_dtype) -> dict:
    """Train the epi modules over ``batches``, one step each: {"loss": [per
    step], "grad": {key: the first step's clipped gradient}}; the weights
    are left where the last step put them."""
    opt_cfg = config["optimizer"]
    params = trainable(mods)
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.AdamW(list(params.values()), lr=opt_cfg["learning_rate"],
                            betas=(opt_cfg["adam_beta1"], opt_cfg["adam_beta2"]),
                            eps=opt_cfg["adam_epsilon"],
                            weight_decay=opt_cfg["adam_weight_decay"])
    out = {"loss": [], "grad": {}}
    for i, batch in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        value = loss(mods, config, batch, generator, draw_dtype)
        value.backward()
        torch.nn.utils.clip_grad_norm_(list(params.values()), opt_cfg["max_grad_norm"])
        if i == 0:
            out["grad"] = {k: p.grad.detach().clone() for k, p in params.items()}
        opt.step()
        out["loss"].append(float(value.detach()))
    return out
