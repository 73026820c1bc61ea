"""One training step of the epi modules (port of
``cvd_tpu/train/train_step.py``), on one device, for a posed
(RealEstate10K) batch.

encode (VAE, frozen, frame chunks of 8) -> noise + per-video timesteps ->
``add_noise`` -> frozen CLIP and pose encoder -> UNet with the epipolar
conditioning (one first-frame slope per step) -> f32 MSE against the noise,
plus ``epi_loss_weight`` times the epipolar distance loss of the auxiliary
q/k head where the UNet has one (``additional_channel > 0``) -> backward
into the trainable set -> clip, AdamW, LR schedule. The image
LoRA, where the UNet has one, runs at scale 1: these are posed batches
(the JAX package sets it to 0 only for unposed ones, train_step.py:84-91).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from cvd_tpu_torch.models.epi import EpiConditioning
from cvd_tpu_torch.pipelines.common import VAE_SCALE, PipelineModules, encode_images
from cvd_tpu_torch.train.losses import epi_distance_loss, masked_mse_loss
from cvd_tpu_torch.train.state import TrainState


def _draw(fn, shape, generator, device, **kw):
    dev = generator.device if generator is not None else device
    return fn(*shape, generator=generator, device=dev, **kw).to(device)


def loss_and_grads(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    modules: PipelineModules,
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    timesteps: Optional[torch.Tensor] = None,
    F_mat_size: int = 256,
    rand_slope_ff: bool = True,
    num_train_timesteps: int = 1000,
    remat: bool = True,
    epi_loss_weight: float = 0.002,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the step's loss, its epipolar distance loss), after the backward has
    left the gradients in the trainable parameters' ``.grad``. The loss is
    the MSE plus ``epi_loss_weight`` times the epipolar loss; without the
    auxiliary head the epipolar loss is 0 and weighs nothing (as in the JAX
    package, train_step.py:139-147).

    batch (leading dim = 2 * folded pairs, video-major as the reference's
    ``torch.cat(x.chunk(2, dim=1))``, train_epi_control.py:516):
      latents [B, F, h, w, 4] (pre-encoded), or latent_mean/latent_logvar
        (posterior moments), or pixel_values [B, F, H, W, 3] in [-1, 1]
      text_ids [B, 77], plucker [B, F, H, W, 6], F_mats [B, F, 3, 3]
    ``noise`` / ``timesteps`` pin the draws (tests); otherwise they come
    from ``generator``.
    """
    if "H_mats" in batch or "warped_masks" in batch:
        raise NotImplementedError(
            "unposed (H_mats / warped_masks) batches need homography_lines, which is "
            "not ported yet (ROADMAP queue 1, training: WebVid data with H-mats)")
    m = modules
    unet = state.model
    device = unet.conv_in.weight.device
    with torch.no_grad():
        if "latents" in batch:
            latents = batch["latents"].to(device=device, dtype=torch.float32)
        elif "latent_mean" in batch:
            mean = batch["latent_mean"].to(device=device, dtype=torch.float32)
            std = torch.exp(0.5 * batch["latent_logvar"].to(device=device, dtype=torch.float32))
            latents = (mean + std * _draw(torch.randn, mean.shape, generator, device)) * VAE_SCALE
        else:
            px = batch["pixel_values"].to(device)
            B, F = px.shape[:2]
            z = encode_images(m, px.reshape((B * F,) + px.shape[2:]), generator)
            latents = z.reshape((B, F) + z.shape[1:])
        B, F = latents.shape[:2]
        if noise is None:
            noise = _draw(torch.randn, latents.shape, generator, device)
        if timesteps is None:
            timesteps = torch.randint(0, num_train_timesteps, (B,), generator=generator,
                                      device=generator.device if generator is not None
                                      else device).to(device)
        noise = noise.to(device=device, dtype=torch.float32)
        timesteps = timesteps.to(device)
        noisy = m.scheduler.add_noise(m.scheduler.set_timesteps(50), latents, noise, timesteps)
        text = m.clip(batch["text_ids"].to(device))
        pose_dtype = m.pose_encoder.encoder_conv_in.weight.dtype
        pose_feats = m.pose_encoder(batch["plucker"].to(device=device, dtype=pose_dtype))

    # one first-frame slope per step, drawn here: a remat replay of a block
    # must rebuild the lines the loss saw (JAX fixes slope_key per step)
    slope = (_draw(torch.rand, (1,), generator, device) * math.pi if rand_slope_ff else None)
    F_mats = batch["F_mats"].to(device=device, dtype=torch.float32).reshape(B * F, 3, 3)
    epi_cond = EpiConditioning(F_mats=F_mats, F_mat_size=F_mat_size, video_length=F,
                               rand_slope_ff=rand_slope_ff, slope=slope)
    epi_loss = torch.zeros((), device=device)
    if unet.config.additional_channel > 0:
        pred, extras = unet(noisy, timesteps, text, pose_feats, epi_cond, remat=remat,
                            lora_scale=1.0, return_extras=True)
        loss = masked_mse_loss(pred.float(), noise)
        if extras["auxiliary"] is not None:
            epi_loss = epi_distance_loss(extras["auxiliary"], F_mats, F_mat_size)
            loss = loss + epi_loss_weight * epi_loss
    else:
        pred = unet(noisy, timesteps, text, pose_feats, epi_cond, remat=remat, lora_scale=1.0)
        loss = masked_mse_loss(pred.float(), noise)
    loss.backward()
    return loss.detach(), epi_loss.detach()


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], modules: PipelineModules,
               generator: Optional[torch.Generator] = None, **kwargs) -> Dict[str, float]:
    """One optimization step (``loss_and_grads`` + clip + AdamW); updates
    ``state`` in place. Returns {"loss", "epi_loss", "grad_norm"}."""
    loss, epi_loss = loss_and_grads(state, batch, modules, generator, **kwargs)
    grad_norm = state.apply_gradients()
    return {"loss": float(loss), "epi_loss": float(epi_loss), "grad_norm": float(grad_norm)}
