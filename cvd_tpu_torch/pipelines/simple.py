"""Simple 2-view pipeline (port of ``cvd_tpu/pipelines/simple.py``):

* 4-row CFG batch [uncond-src, cond-src, uncond-tgt, cond-tgt]
  (simple.py:131-149, 178-202);
* pose features computed once, outside the loop;
* a Python DDIM loop, one UNet call per step;
* a whole-video VAE decode.

More than two views: ``pipelines/advanced.py``. Not ported yet: multidiff
sliding windows (``multidiff_total_steps > 1``), Pyramid Attention
Broadcast and meshes (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from cvd_tpu_torch.models.epi import EpiConditioning
from cvd_tpu_torch.pipelines.common import (
    PipelineModules, SpanTimer, decode_latents, encode_prompt,
)


def _cfg4(x: torch.Tensor) -> torch.Tensor:
    """[2, ...] (src, tgt) -> [4, ...] chunk-ordered [src, src, tgt, tgt]."""
    return torch.cat([x[:1], x[:1], x[1:], x[1:]], dim=0)


class SimplePipeline:
    """2-view, fixed-pair generation with epipolar sync."""

    def __init__(self, modules: PipelineModules, F_mat_size: int = 256,
                 rand_slope_ff: bool = True):
        self.m = modules
        self.F_mat_size = F_mat_size
        self.rand_slope_ff = rand_slope_ff
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
    ) -> torch.Tensor:
        """Returns images [2, F, H, W, 3] in [0, 1] (or the final latents
        [2, F, H/8, W/8, 4] with ``decode=False``), f32."""
        if multidiff_total_steps != 1:
            raise NotImplementedError("multidiff sliding windows are not ported yet")
        m = self.m
        device = m.unet.conv_in.weight.device
        dtype = m.unet.conv_in.weight.dtype
        V, Fr, H, W, _ = plucker.shape
        if V != 2:
            raise ValueError("SimplePipeline is the fixed 2-view sampler")
        state = m.scheduler.set_timesteps(num_inference_steps)

        uncond, cond = encode_prompt(m, prompt_ids.to(device), negative_ids.to(device))
        text = torch.cat([uncond, cond, uncond, cond], dim=0).to(dtype)
        pose_feats = [_cfg4(p.to(dtype)) for p in
                      m.pose_encoder(plucker.to(device=device, dtype=dtype))]
        F4 = _cfg4(F_mats.to(device=device, dtype=torch.float32)).reshape(4 * Fr, 3, 3)
        epi_cond = EpiConditioning(
            F_mats=F4, video_length=Fr, F_mat_size=self.F_mat_size,
            rand_slope_ff=self.rand_slope_ff, generator=generator,
        )
        if latents is None:
            latents = torch.randn((2, Fr, H // 8, W // 8, 4), generator=generator,
                                  device=generator.device if generator is not None else device)
        latents = latents.to(device=device, dtype=torch.float32) * m.scheduler.init_noise_sigma

        timer = SpanTimer(device)
        for t in state.timesteps:
            with timer:
                eps = m.unet(_cfg4(latents), int(t), text, pose_feats, epi_cond).float()
            # chunk(4): uncond rows (0, 2), cond rows (1, 3)
            eps_u = torch.stack([eps[0], eps[2]])
            eps_t = torch.stack([eps[1], eps[3]])
            latents = m.scheduler.step(state, eps_u + guidance_scale * (eps_t - eps_u),
                                       int(t), latents)
        self.unet_step_ms = timer.elapsed_ms()
        if not decode:
            return latents
        return decode_latents(m, latents)
