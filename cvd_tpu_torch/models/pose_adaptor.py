"""PoseAdaptor — pose encoder + UNet as one callable (port of
``cvd_tpu/models/pose_adaptor.py``; the reference's nn.Module wrapper,
pose_adaptor.py:81-104)."""
from __future__ import annotations

from typing import Optional

import torch

from cvd_tpu_torch.models.epi import EpiConditioning
from cvd_tpu_torch.pipelines.common import PipelineModules


class PoseAdaptor:
    def __init__(self, modules: PipelineModules, F_mat_size: int = 256,
                 rand_slope_ff: bool = True):
        self.m = modules
        self.F_mat_size = F_mat_size
        self.rand_slope_ff = rand_slope_ff

    def __call__(
        self,
        noisy_latents: torch.Tensor,          # [B, F, h, w, 4]
        timesteps: torch.Tensor,              # [B]
        encoder_hidden_states: torch.Tensor,  # [B, L, C]
        pose_embedding: Optional[torch.Tensor] = None,  # [B, F, H, W, 6]
        F_mats: Optional[torch.Tensor] = None,          # [B, F, 3, 3]
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        B, Fr = noisy_latents.shape[:2]
        pose_features = (None if pose_embedding is None
                         else self.m.pose_encoder(pose_embedding))
        cond = EpiConditioning(
            F_mats=None if F_mats is None else F_mats.reshape(B * Fr, 3, 3),
            video_length=Fr, F_mat_size=self.F_mat_size,
            rand_slope_ff=self.rand_slope_ff, generator=generator,
        )
        return self.m.unet(noisy_latents, timesteps, encoder_hidden_states,
                           pose_features, cond)
