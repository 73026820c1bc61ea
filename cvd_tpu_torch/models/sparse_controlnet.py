"""Sparse-frame ControlNet for the video UNet (port of
``cvd_tpu/models/sparse_controlnet.py``; AnimateDiff's SparseCtrl,
``animatediff/models/sparse_controlnet.py:85-589``).

A copy of the UNet's encoder with its own motion modules (one temporal
self-attention a layer, no pose conditioning) that takes per-frame
conditioning images with a mask channel and returns zero-initialized
residuals for every state of the down path and for the mid block, scaled by
``conditioning_scale``: the UNet's ``down_block_additional_residuals`` /
``mid_block_additional_residual``. Two layouts of the released files: the
pyramid (``SparseConditioningEmbedding``, 3 pixel channels + the mask at 8x
the latent resolution; the scribble checkpoint) and the simplified one (one
zero-initialized 3x3 convolution over 4 latent channels + the mask; the v3
RGB checkpoint). The modules keep the file's own names
(``down_blocks.{i}.resnets.{j}``, ``controlnet_down_blocks.{k}``, ...), so a
released file loads with no rename (``io/checkpoints.load_sparse_controlnet_weights``).
Its spatial transformers run kernels K2 and K5, its motion modules K3, its
GroupNorms K4.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvd_tpu_torch.models.layers import Conv2d, TimestepEmbedding, sinusoidal_time_embedding
from cvd_tpu_torch.models.unet import (
    CrossAttnDownBlock, MidBlock, UNetConfig, _fold, _unfold,
)

# the pyramid's widths (sparse_controlnet.py:49-83)
PYRAMID_CHANNELS = (16, 32, 96, 256)


class SparseConditioningEmbedding(nn.Module):
    """conv_in -> SiLU -> 3 x (3x3 conv, SiLU, stride-2 3x3 conv, SiLU) ->
    zero-initialized conv_out: [B, F, H, W, c] -> [B, F, H/8, W/8, out]."""

    def __init__(self, conditioning_channels: int, out_channels: int,
                 block_out_channels=PYRAMID_CHANNELS):
        super().__init__()
        ch = block_out_channels
        self.conv_in = Conv2d(conditioning_channels, ch[0], 3, 1, 1)
        blocks = []
        for i in range(len(ch) - 1):
            blocks += [Conv2d(ch[i], ch[i], 3, 1, 1), Conv2d(ch[i], ch[i + 1], 3, 2, 1)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = Conv2d(ch[-1], out_channels, 3, 1, 1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.conv_in(_fold(cond)))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return _unfold(self.conv_out(x), cond.shape[0])


class SparseControlNetModel(nn.Module):
    """The encoder copy emitting ControlNet residuals.

    forward(sample [B, F, h, w, 4], timesteps, encoder_hidden_states
    [B, L, C], conditioning [B, F, H, W, c], conditioning_mask [B, F, H, W, 1],
    conditioning_scale) -> (down residuals, one per state of the UNet's down
    path, mid residual). ``config``'s widths and motion settings are the
    UNet's; epi modules, pose conditioning and LoRAs are not part of it."""

    def __init__(self, config: UNetConfig = UNetConfig(), conditioning_channels: int = 3,
                 concat_conditioning_mask: bool = True,
                 set_noisy_sample_input_to_zero: bool = False,
                 motion_attention_blocks: int = 1,
                 use_simplified_condition_embedding: bool = False):
        super().__init__()
        # the encoder copy's own blocks: every layer has a motion module of
        # ``motion_attention_blocks`` temporal attentions (the released files:
        # one, sparse_controlnet.py:127-134), none of them pose-conditioned
        cfg = self.config = dataclasses.replace(
            config, motion_num_attention_blocks=motion_attention_blocks,
            pose_cond_attn_indices=(), use_epi_module=False, spatial_lora_rank=0,
            sync_lora_rank=0, spatial_extended_attention=False)
        self.concat_conditioning_mask = concat_conditioning_mask
        self.set_noisy_sample_input_to_zero = set_noisy_sample_input_to_zero
        ch = cfg.block_out_channels
        temb_dim = ch[0] * 4
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, 1, 1)
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        cond_in = conditioning_channels + int(concat_conditioning_mask)
        if use_simplified_condition_embedding:
            self.controlnet_cond_embedding = Conv2d(cond_in, ch[0], 3, 1, 1)
        else:
            self.controlnet_cond_embedding = SparseConditioningEmbedding(cond_in, ch[0])
        res_channels: List[int] = [ch[0]]
        down = []
        for i, c in enumerate(ch):
            is_final = i == len(ch) - 1
            down.append(CrossAttnDownBlock(
                cfg, ch[max(i - 1, 0)], c, temb_dim, cfg.depth(i), cfg.heads(i),
                use_motion=True, use_epi=False, add_downsample=not is_final))
            res_channels += [c] * (cfg.layers_per_block + (0 if is_final else 1))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlock(cfg, ch[-1], temb_dim, use_motion=False, use_epi=False)
        self.controlnet_down_blocks = nn.ModuleList([Conv2d(c, c, 1, 1, 0)
                                                     for c in res_channels])
        self.controlnet_mid_block = Conv2d(ch[-1], ch[-1], 1, 1, 0)

    def zero_initialized(self) -> List[str]:
        """The parameters a fresh model starts at zero: the zero convolutions
        and the conditioning embedding's last convolution."""
        zero = ("controlnet_down_blocks.", "controlnet_mid_block.",
                "controlnet_cond_embedding.conv_out.")
        names = [n for n, _ in self.named_parameters() if n.startswith(zero)]
        if isinstance(self.controlnet_cond_embedding, Conv2d):
            names += ["controlnet_cond_embedding.weight", "controlnet_cond_embedding.bias"]
        return names

    def forward(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                conditioning: torch.Tensor, conditioning_mask: Optional[torch.Tensor] = None,
                conditioning_scale: float = 1.0
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        B, Fr = sample.shape[:2]
        dtype = self.conv_in.weight.dtype
        if self.set_noisy_sample_input_to_zero:
            sample = torch.zeros_like(sample)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        t_emb = sinusoidal_time_embedding(timesteps, self.config.block_out_channels[0])
        temb_f = self.time_embedding(t_emb.to(dtype)).repeat_interleave(Fr, dim=0)
        context_f = encoder_hidden_states.to(dtype).repeat_interleave(Fr, dim=0)
        if self.concat_conditioning_mask:
            if conditioning_mask is None:
                raise ValueError("concat_conditioning_mask: pass conditioning_mask")
            conditioning = torch.cat([conditioning, conditioning_mask], dim=-1)
        conditioning = conditioning.to(dtype)
        embed = self.controlnet_cond_embedding
        cond = (_unfold(embed(_fold(conditioning)), B) if isinstance(embed, Conv2d)
                else embed(conditioning))
        x = _unfold(self.conv_in(_fold(sample.to(dtype))), B) + cond
        states = [x]
        for block in self.down_blocks:
            x, res, _ = block(x, temb_f, context_f, None, None)
            states += res
        mid, _ = self.mid_block(x, temb_f, context_f, None, None)
        down = tuple(_unfold(zero(_fold(r)), B) * conditioning_scale
                     for zero, r in zip(self.controlnet_down_blocks, states))
        return down, _unfold(self.controlnet_mid_block(_fold(mid)), B) * conditioning_scale
