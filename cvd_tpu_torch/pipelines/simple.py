"""Simple 2-view pipeline (port of ``cvd_tpu/pipelines/simple.py``):

* 4-row CFG batch [uncond-src, cond-src, uncond-tgt, cond-tgt]
  (simple.py:131-149, 178-202);
* pose features computed once, outside the loop;
* a Python DDIM loop, one UNet call per step;
* multidiff sliding windows: a video longer than the model's window is
  denoised as ``multidiff_total_steps`` overlapping windows per step, their
  noise predictions averaged where they overlap (simple.py:151-217);
* Pyramid Attention Broadcast (``pipelines/pab.py``), not with multidiff;
* a whole-video VAE decode;
* sharded sampling over a ("rows", "frames") mesh (``parallel/mesh.py``,
  SPMD over ``torchrun``'s processes): every rank encodes the text and the
  poses, draws the latents and takes the DDIM steps alike; each UNet call
  runs on this rank's block of the 4 CFG rows and the window's frames, and
  its noise prediction is all-gathered before the guidance.

More than two views: ``pipelines/advanced.py``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from cvd_tpu_torch.models.epi import EpiConditioning
from cvd_tpu_torch.pipelines.common import (
    PipelineModules, SpanTimer, decode_latents, encode_prompt,
)
from cvd_tpu_torch.parallel.mesh import constrain, gather
from cvd_tpu_torch.parallel.shard_ops import check_divides, local_rows
from cvd_tpu_torch.pipelines.pab import PABCache


def _cfg4(x: torch.Tensor) -> torch.Tensor:
    """[2, ...] (src, tgt) -> [4, ...] chunk-ordered [src, src, tgt, tgt]."""
    return torch.cat([x[:1], x[:1], x[1:], x[1:]], dim=0)


class SimplePipeline:
    """2-view, fixed-pair generation with epipolar sync."""

    def __init__(self, modules: PipelineModules, F_mat_size: int = 256,
                 rand_slope_ff: bool = True, mesh=None):
        """``mesh``: a ("rows", "frames") ``parallel.Mesh`` to shard each UNet
        call over; the rows must divide 4 and the frames the window. Only
        rank 0 decodes: the other ranks return None."""
        self.m = modules
        self.F_mat_size = F_mat_size
        self.rand_slope_ff = rand_slope_ff
        self.mesh = mesh
        # wall time of each UNet call of the last run, in ms (CUDA events on
        # the card, the host clock on the CPU)
        self.unet_step_ms: List[float] = []

    @torch.no_grad()
    def __call__(
        self,
        prompt_ids: torch.Tensor,    # [1, 77] int
        negative_ids: torch.Tensor,  # [1, 77] int
        plucker: torch.Tensor,       # [2, F, H, W, 6]
        F_mats: torch.Tensor,        # [2, F, 3, 3] folded pair mats (video-major)
        num_inference_steps: int = 25,
        guidance_scale: float = 8.5,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        decode: bool = True,
        multidiff_total_steps: int = 1,
        multidiff_overlaps: int = 12,
        pab_config=None,
    ) -> torch.Tensor:
        """Returns images [2, F, H, W, 3] in [0, 1] (or the final latents
        [2, F, H/8, W/8, 4] with ``decode=False``), f32.

        With ``multidiff_total_steps`` > 1 the F frames are denoised as that
        many windows, each overlapping the next by ``multidiff_overlaps``
        frames: F = steps * (window - overlap) + overlap. The pose encoder
        sees all F frames, so F is bounded by its temporal positional
        encoding, as in the JAX package. ``pab_config``: a ``PABConfig``
        (not with multidiff)."""
        m = self.m
        device = m.unet.conv_in.weight.device
        dtype = m.unet.conv_in.weight.dtype
        V, Fr, H, W, _ = plucker.shape
        if V != 2:
            raise ValueError("SimplePipeline is the fixed 2-view sampler")
        windows = multidiff_total_steps
        Fw = Fr if windows == 1 else (Fr - multidiff_overlaps) // windows + multidiff_overlaps
        stride = Fw - multidiff_overlaps
        if windows != 1 and (stride <= 0 or (windows - 1) * stride + Fw != Fr):
            raise ValueError(f"{Fr} frames are not {windows} windows of {Fw} frames "
                             f"overlapping by {multidiff_overlaps}: frames must equal "
                             "steps * (window - overlap) + overlap")
        max_frames = m.pose_encoder.temporal_pe_max_len
        if Fr > max_frames:
            raise ValueError(f"{Fr} frames: the pose encoder runs on every frame of the video "
                             f"and its temporal positional encoding holds {max_frames}")
        if pab_config is not None and windows != 1:
            raise ValueError("PAB + multidiff windows is unsupported")
        mesh = self.mesh
        if mesh is not None:
            if pab_config is not None:
                raise ValueError("--pab + --sharded is not validated; pick one")
            check_divides(mesh, 4, Fw, "SimplePipeline")
        state = m.scheduler.set_timesteps(num_inference_steps)

        uncond, cond = encode_prompt(m, prompt_ids.to(device), negative_ids.to(device))
        text = torch.cat([uncond, cond, uncond, cond], dim=0).to(dtype)
        # the pose encoder in its own dtype: a training bundle's (validation)
        # differs from the UNet's bf16 frozen weights
        pose_dtype = m.pose_encoder.encoder_conv_in.weight.dtype
        pose_feats = [_cfg4(p.to(dtype)) for p in
                      m.pose_encoder(plucker.to(device=device, dtype=pose_dtype))]
        F4 = _cfg4(F_mats.to(device=device, dtype=torch.float32))     # [4, F, 3, 3]

        def window_cond(start: int):
            """The pose features and epipolar conditioning of the window of
            frames [start, start + Fw)."""
            return [constrain(p[:, start:start + Fw], mesh, "rows", "frames")
                    for p in pose_feats], EpiConditioning(
                F_mats=local_rows(F4[:, start:start + Fw].reshape(4 * Fw, 3, 3), mesh, Fw),
                video_length=Fw, F_mat_size=self.F_mat_size, rand_slope_ff=self.rand_slope_ff,
                generator=generator, mesh=mesh)

        starts = [w * stride for w in range(windows)]
        conds = [window_cond(s) for s in starts]
        # the overlap-average weights: 1 / the number of windows over each frame
        counts = torch.zeros(Fr, device=device)
        for s in starts:
            counts[s:s + Fw] += 1.0
        inv_counts = (1.0 / counts)[None, :, None, None, None]
        if latents is None:
            latents = torch.randn((2, Fr, H // 8, W // 8, 4), generator=generator,
                                  device=generator.device if generator is not None else device)
        latents = latents.to(device=device, dtype=torch.float32) * m.scheduler.init_noise_sigma
        pab = None if pab_config is None else PABCache(pab_config, len(state.timesteps))

        timer = SpanTimer(device)
        for i, t in enumerate(state.timesteps):
            if pab is not None:
                pab.at_step(i)
            eps_full = torch.zeros_like(latents)
            for s, (pf, epi_cond) in zip(starts, conds):
                with timer:
                    lat_in = constrain(_cfg4(latents[:, s:s + Fw]), mesh, "rows", "frames")
                    eps = m.unet(lat_in, int(t), constrain(text, mesh, "rows"), pf, epi_cond,
                                 pab=pab, mesh=mesh)
                    eps = gather(eps, mesh, "rows", "frames").float()
                # chunk(4): uncond rows (0, 2), cond rows (1, 3)
                eps_u = torch.stack([eps[0], eps[2]])
                eps_t = torch.stack([eps[1], eps[3]])
                eps_full[:, s:s + Fw] += eps_u + guidance_scale * (eps_t - eps_u)
            latents = m.scheduler.step(state, eps_full * inv_counts, int(t), latents)
        self.unet_step_ms = timer.elapsed_ms()
        if not decode:
            return latents
        return decode_latents(m, latents, mesh)
