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

The step is a body and a caller (``StepBody``): the body reads only a dict
of the step's tensors and a generator, writes the loss, the epipolar loss
and the gradient norm into 0-dim tensors of its own, and reads nothing back
to the host, so ``train/program.py`` can capture it into a CUDA graph and
replay it; ``train_step`` runs the same body eagerly and then reads them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from cvd_tpu_torch.models.epi import EpiConditioning
from cvd_tpu_torch.pipelines.common import PipelineModules, encode_images
from cvd_tpu_torch.schedulers.ddim import DDIMState
from cvd_tpu_torch.train.losses import epi_distance_loss, masked_mse_loss
from cvd_tpu_torch.train.state import TrainState
from cvd_tpu_torch.utils.tracing import IntervalTimer

# the step's phases, as ``StepBody.phases`` names them: encode (the
# gradients' zeroing, the VAE encode or the posterior draw, the noise and
# timesteps, add_noise, CLIP, the pose encoder), forward (the UNet and the
# loss), backward (loss.backward(), zero gradients for unused tensors, the
# all-reduce under a process group), optimizer (clip, AdamW, the results)
PHASES = ("train.encode", "train.forward", "train.backward", "train.optimizer")


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
    body = StepBody(state, modules, F_mat_size=F_mat_size, rand_slope_ff=rand_slope_ff,
                    num_train_timesteps=num_train_timesteps, remat=remat,
                    epi_loss_weight=epi_loss_weight)
    return body.loss_and_grads(_pinned(batch, noise, timesteps, slope), generator)


def _pinned(batch, noise, timesteps, slope) -> Dict[str, torch.Tensor]:
    """The batch with the draws that pin it, as the body reads them."""
    pins = {k: v for k, v in (("noise", noise), ("timesteps", timesteps), ("slope", slope))
            if v is not None}
    return {**batch, **pins}


class StepBody:
    """One training step of ``state`` as a function of a dict of tensors (the
    batch, and ``noise`` / ``timesteps`` / ``slope`` where they are pinned)
    and a generator: forward, backward, the gradients' average over the
    default process group where one is initialized, clip and AdamW. The
    learning-rate schedule and the step count advance outside it
    (``TrainState.advance``). Its results land in ``out`` ("loss",
    "epi_loss", "grad_norm": 0-dim f32 tensors made with the body, outside
    any capture). ``phases`` marks the boundaries of ``PHASES`` in every run
    of the body, replays of a graph captured from it included."""

    def __init__(self, state: TrainState, modules: PipelineModules, *, F_mat_size: int = 256,
                 rand_slope_ff: bool = True, num_train_timesteps: int = 1000,
                 remat: bool = True, epi_loss_weight: float = 0.002):
        self.state, self.modules = state, modules
        self.F_mat_size, self.rand_slope_ff = F_mat_size, rand_slope_ff
        self.num_train_timesteps, self.remat = num_train_timesteps, remat
        self.epi_loss_weight = epi_loss_weight
        self.device = state.model.conv_in.weight.device
        # add_noise's table, on the step's device once: the body copies
        # nothing from the host
        self.noise_state: DDIMState = modules.scheduler.set_timesteps(50).to(self.device)
        self.out = {k: torch.zeros((), device=self.device)
                    for k in ("loss", "epi_loss", "grad_norm")}
        self.phases = IntervalTimer(self.device)

    def __call__(self, bufs: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> None:
        state = self.state
        self.phases.start()
        self.phases.mark(PHASES[0])
        state.zero_grad()
        loss, epi_loss = self.loss_and_grads(bufs, generator)
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            all_reduce_gradients(state)
        self.phases.mark(PHASES[3])
        norm = state.update()
        self.out["loss"].copy_(loss)
        self.out["epi_loss"].copy_(epi_loss)
        self.out["grad_norm"].copy_(norm)
        self.phases.mark()

    def results(self) -> Dict[str, float]:
        """The last step's {"loss", "epi_loss", "grad_norm"}, read to the host
        (one wait for the device)."""
        return dict(zip(self.out, torch.stack(list(self.out.values())).tolist()))

    def loss_and_grads(self, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``loss_and_grads``' forward and backward."""
        m, state, device = self.modules, self.state, self.device
        unet = state.model
        noise, timesteps, slope = (batch.get(k) for k in ("noise", "timesteps", "slope"))
        with torch.no_grad():
            if "latents" in batch:
                latents = batch["latents"].to(device=device, dtype=torch.float32)
            elif "latent_mean" in batch:
                mean = batch["latent_mean"].to(device=device, dtype=torch.float32)
                std = torch.exp(0.5 * batch["latent_logvar"].to(device=device,
                                                                 dtype=torch.float32))
                latents = (mean + std * _draw(torch.randn, mean.shape, generator, device)
                           ) * m.vae.config.scaling_factor
            else:
                px = batch["pixel_values"].to(device)
                B, F = px.shape[:2]
                z = encode_images(m, px.reshape((B * F,) + px.shape[2:]), generator)
                latents = z.reshape((B, F) + z.shape[1:])
            B, F = latents.shape[:2]
            if noise is None:
                noise = _draw(torch.randn, latents.shape, generator, device)
            if timesteps is None:
                timesteps = torch.randint(0, self.num_train_timesteps, (B,),
                                          generator=generator,
                                          device=generator.device if generator is not None
                                          else device).to(device)
            noise = noise.to(device=device, dtype=torch.float32)
            timesteps = timesteps.to(device)
            noisy = m.scheduler.add_noise(self.noise_state, latents, noise, timesteps)
            text = m.clip(batch["text_ids"].to(device))
            posed = "plucker" in batch
            pose_feats = None
            if posed:
                pose_dtype = m.pose_encoder.encoder_conv_in.weight.dtype
                pose_feats = m.pose_encoder(batch["plucker"].to(device=device, dtype=pose_dtype))

        def rows(key):
            return batch[key].to(device=device, dtype=torch.float32).reshape(B * F, 3, 3)

        F_mat_size, rand_slope_ff = self.F_mat_size, self.rand_slope_ff
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
        self.phases.mark(PHASES[1])
        if unet.config.additional_channel > 0:
            pred, extras = unet(noisy, timesteps, text, pose_feats, epi_cond, remat=self.remat,
                                lora_scale=lora_scale, return_extras=True)
            loss = masked_mse_loss(pred.float(), noise, mask)
            if extras["auxiliary"] is not None and posed:
                epi_loss = epi_distance_loss(extras["auxiliary"], F_mats, F_mat_size)
                loss = loss + self.epi_loss_weight * epi_loss
        else:
            pred = unet(noisy, timesteps, text, pose_feats, epi_cond, remat=self.remat,
                        lora_scale=lora_scale)
            loss = masked_mse_loss(pred.float(), noise, mask)
        self.phases.mark(PHASES[2])
        loss.backward()
        # a trainable tensor this step did not use (the auxiliary head on an
        # unposed batch) gets a zero gradient, as in JAX: AdamW still decays
        # it (the state's gradients exist already, unless a caller freed them)
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
               generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None, timesteps: Optional[torch.Tensor] = None,
               slope: Optional[torch.Tensor] = None, **kwargs) -> Dict[str, float]:
    """One optimization step, eagerly (``StepBody``: ``loss_and_grads``, the
    gradients' average over the default process group where one is
    initialized, then clip + AdamW; then the schedule); updates ``state`` in
    place. Returns {"loss", "epi_loss", "grad_norm"} (this process's
    losses)."""
    body = StepBody(state, modules, **kwargs)
    body(_pinned(batch, noise, timesteps, slope), generator)
    state.advance()
    return body.results()
