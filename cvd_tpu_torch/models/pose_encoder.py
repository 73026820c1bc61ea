"""CameraCtrl pose encoder: Plücker video -> multi-scale features (port of
``cvd_tpu/models/pose_encoder.py``): pixel-unshuffle x8, conv_in, then 4
stages of 2x (ResnetBlock + temporal attention) at the UNet's widths, with
avg-pool downsampling between stages. The temporal attentions go through
the same op as the motion modules (kernel K3 on CUDA)."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvd_tpu_torch.models.layers import Conv2d
from cvd_tpu_torch.models.motion import TemporalTransformerBlock


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[N, H, W, C] -> [N, H/f, W/f, C*f*f] with torch.nn.PixelUnshuffle's
    (c, fh, fw) channel order."""
    N, H, W, C = x.shape
    x = x.reshape(N, H // factor, factor, W // factor, factor, C)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(N, H // factor, W // factor, C * factor * factor)


class PoseResnetBlock(nn.Module):
    """optional avg-pool down -> (1x1 in_conv on a width change) -> 3x3 conv
    -> relu -> 1x1 conv -> + skip."""

    def __init__(self, in_channels: int, out_channels: int, down: bool):
        super().__init__()
        self.down = down
        self.in_conv = (Conv2d(in_channels, out_channels, 1, 1, 0)
                        if in_channels != out_channels else None)
        self.block1 = Conv2d(out_channels, out_channels, 3, 1, 1)
        self.block2 = Conv2d(out_channels, out_channels, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        if self.in_conv is not None:
            x = self.in_conv(x)
        return self.block2(F.relu(self.block1(x))) + x


class CameraPoseEncoder(nn.Module):
    def __init__(self, downscale_factor: int = 8,
                 channels: Sequence[int] = (320, 640, 1280, 1280), nums_rb: int = 2,
                 cin: int = 384, temporal_attention_nhead: int = 8,
                 temporal_pe_max_len: int = 16):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.temporal_pe_max_len = temporal_pe_max_len
        self.encoder_conv_in = Conv2d(cin, channels[0], 3, 1, 1)
        convs, attns = [], []
        in_ch = channels[0]
        for i, ch in enumerate(channels):
            convs.append(nn.ModuleList([
                PoseResnetBlock(in_ch if j == 0 else ch, ch, down=j == 0 and i != 0)
                for j in range(nums_rb)]))
            attns.append(nn.ModuleList([
                TemporalTransformerBlock(ch, temporal_attention_nhead,
                                         num_attention_blocks=1,
                                         pe_max_len=temporal_pe_max_len,
                                         pose_cond_indices=())
                for _ in range(nums_rb)]))
            in_ch = ch
        self.encoder_down_conv_blocks = nn.ModuleList(convs)
        self.encoder_down_attention_blocks = nn.ModuleList(attns)

    def forward(self, plucker: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """plucker [B, F, H, W, 6] -> 4 features [B, F, h, w, c]."""
        B, Fr, H, W, C = plucker.shape
        x = pixel_unshuffle(plucker.reshape(B * Fr, H, W, C), self.downscale_factor)
        x = self.encoder_conv_in(x)
        features = []
        for convs, attns in zip(self.encoder_down_conv_blocks,
                                self.encoder_down_attention_blocks):
            for conv, attn in zip(convs, attns):
                x = conv(x)
                n, h, w, c = x.shape
                # temporal attention over frames at each pixel (pixel-major)
                tokens = attn(x.reshape(B, Fr, h * w, c).transpose(1, 2))
                x = tokens.transpose(1, 2).reshape(n, h, w, c)
            features.append(x.reshape(B, Fr, h, w, c))
        return tuple(features)
