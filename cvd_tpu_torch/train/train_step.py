"""One training step of the epi modules (port of
``cvd_tpu/train/train_step.py``), on one device, for a posed
(RealEstate10K) or an unposed (WebVid) batch.

encode (VAE, frozen, frame chunks of 8) -> noise + per-video timesteps ->
``add_noise`` -> frozen CLIP and pose encoder -> UNet with the epipolar
conditioning -> f32 MSE against the noise, plus ``epi_loss_weight`` times
the epipolar distance loss of the auxiliary q/k head where the UNet has one
(``additional_channel > 0``) and the batch has F mats -> backward into the
trainable set -> clip, AdamW, LR schedule. A posed batch runs with its pose
features, lines from its F mats (first-frame pseudo lines with one slope
per step) and the image LoRA, where the UNet has one, at scale 1. An
unposed batch (``H_mats`` and ``warped_masks``, train_step.py:84-105) runs
with no pose features, the image LoRA at scale 0, pseudo-epipolar lines
from its homographies with one slope per row, and the MSE masked by the
warped masks.
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
    slope: Optional[torch.Tensor] = None,
    F_mat_size: int = 256,
    rand_slope_ff: bool = True,
    num_train_timesteps: int = 1000,
    remat: bool = True,
    epi_loss_weight: float = 0.002,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the step's loss, its epipolar distance loss), after the backward has
    left the gradients in the trainable parameters' ``.grad``. The loss is
    the MSE plus ``epi_loss_weight`` times the epipolar loss; without the
    auxiliary head, or on an unposed batch, the epipolar loss is 0 and weighs
    nothing (as in the JAX package, train_step.py:139-147).

    batch (leading dim = 2 * folded pairs, video-major as the reference's
    ``torch.cat(x.chunk(2, dim=1))``, train_epi_control.py:516):
      latents [B, F, h, w, 4] (pre-encoded), or latent_mean/latent_logvar
        (posterior moments), or pixel_values [B, F, H, W, 3] in [-1, 1]
      text_ids [B, 77]
      posed: plucker [B, F, H, W, 6], F_mats [B, F, 3, 3]
      unposed: H_mats [B, F, 3, 3], warped_masks [B, F, h, w, 1]
    ``noise`` / ``timesteps`` / ``slope`` pin the draws (tests); otherwise
    they come from ``generator``. The slopes are drawn once per step, [1]
    (posed: the first frames' pseudo lines) or [B * F] (unposed: one per
    row), so that a remat replay rebuilds the lines the loss saw (JAX fixes
    its slope key per step; it draws per attention, the port per step).
    """
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
        posed = "plucker" in batch
        pose_feats = None
        if posed:
            pose_dtype = m.pose_encoder.encoder_conv_in.weight.dtype
            pose_feats = m.pose_encoder(batch["plucker"].to(device=device, dtype=pose_dtype))

    def rows(key):
        return batch[key].to(device=device, dtype=torch.float32).reshape(B * F, 3, 3)

    if posed:
        F_mats = rows("F_mats")
        if slope is None and rand_slope_ff:
            slope = _draw(torch.rand, (1,), generator, device) * math.pi
        epi_cond = EpiConditioning(F_mats=F_mats, F_mat_size=F_mat_size, video_length=F,
                                   rand_slope_ff=rand_slope_ff, slope=slope)
        mask = None
    else:
        # unposed (WebVid) batch: no camera conditioning, and the image LoRA
        # off for it (train_epi_control.py:580-581)
        if slope is None:
            slope = _draw(torch.rand, (B * F,), generator, device) * math.pi
        epi_cond = EpiConditioning(H_mats=rows("H_mats"), F_mat_size=F_mat_size,
                                   video_length=F, rand_slope_ff=rand_slope_ff, slope=slope)
        mask = batch["warped_masks"].to(device=device, dtype=torch.float32)
    lora_scale = 1.0 if posed else 0.0
    epi_loss = torch.zeros((), device=device)
    if unet.config.additional_channel > 0:
        pred, extras = unet(noisy, timesteps, text, pose_feats, epi_cond, remat=remat,
                            lora_scale=lora_scale, return_extras=True)
        loss = masked_mse_loss(pred.float(), noise, mask)
        if extras["auxiliary"] is not None and posed:
            epi_loss = epi_distance_loss(extras["auxiliary"], F_mats, F_mat_size)
            loss = loss + epi_loss_weight * epi_loss
    else:
        pred = unet(noisy, timesteps, text, pose_feats, epi_cond, remat=remat,
                    lora_scale=lora_scale)
        loss = masked_mse_loss(pred.float(), noise, mask)
    loss.backward()
    # a trainable tensor this step did not use (the auxiliary head on an
    # unposed batch) gets a zero gradient, as in JAX: AdamW still decays it
    for p in state.trainable_params():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return loss.detach(), epi_loss.detach()


def all_reduce_gradients(state: TrainState) -> None:
    """Average the trainable gradients over the default process group (one
    all-reduce of their concatenation), so that clipping and AdamW see the
    global mean gradient, as the JAX package's data-parallel step does."""
    import torch.distributed as dist

    grads = [p.grad for p in state.trainable_params()]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], modules: PipelineModules,
               generator: Optional[torch.Generator] = None, **kwargs) -> Dict[str, float]:
    """One optimization step (``loss_and_grads``, the gradients' average over
    the default process group where one is initialized, then clip + AdamW);
    updates ``state`` in place. Returns {"loss", "epi_loss", "grad_norm"}
    (this process's losses)."""
    loss, epi_loss = loss_and_grads(state, batch, modules, generator, **kwargs)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        all_reduce_gradients(state)
    grad_norm = state.apply_gradients()
    return {"loss": float(loss), "epi_loss": float(epi_loss), "grad_norm": float(grad_norm)}
