"""AutoencoderKL (SD1.5 VAE) — port of ``cvd_tpu/models/vae.py``.
Channels-last [N, H, W, C]. The encoder and ``quant_conv`` are built only
with ``with_encoder=True`` (training encodes its clips; the 2-view sampler
only decodes, and keeps the memory and random weights it had without
them)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvd_tpu_torch.models.layers import Conv2d, FusedGroupNorm, ResnetBlock2D, Upsample2D


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = FusedGroupNorm(channels, groups, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, H, W, C = x.shape
        h = self.group_norm(x).reshape(N, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(C)
        probs = torch.softmax(logits.float(), dim=-1).to(h.dtype)
        h = self.to_out[0](torch.matmul(probs, v))
        return h.reshape(N, H, W, C) + x


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, groups=groups, use_time_emb=False)
            for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _UpBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, layers: int, add_upsample: bool,
                 groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else channels, channels, groups=groups,
                          use_time_emb=False)
            for j in range(layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(channels)]) if add_upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class _VAEDownsample(nn.Module):
    """diffusers VAE downsample: pad (0, 1, 0, 1), then a stride-2 VALID conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, 2, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, layers: int, add_downsample: bool,
                 groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else channels, channels, groups=groups,
                          use_time_emb=False)
            for j in range(layers)])
        self.downsamplers = (nn.ModuleList([_VAEDownsample(channels)])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, 1, 1)
        self.down_blocks = nn.ModuleList([
            _DownBlock(ch[max(i - 1, 0)], c, cfg.layers_per_block, i < len(ch) - 1, g)
            for i, c in enumerate(ch)])
        self.mid_block = _MidBlock(ch[-1], g)
        self.conv_norm_out = FusedGroupNorm(ch[-1], g, 1e-6, act="silu")
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for down in self.down_blocks:
            x = down(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, ch[0], 3, 1, 1)
        self.mid_block = _MidBlock(ch[0], g)
        self.up_blocks = nn.ModuleList([
            _UpBlock(ch[max(i - 1, 0)], c, cfg.layers_per_block + 1, i < len(ch) - 1, g)
            for i, c in enumerate(ch)])
        self.conv_norm_out = FusedGroupNorm(ch[-1], g, 1e-6, act="silu")
        self.conv_out = Conv2d(ch[-1], cfg.out_channels, 3, 1, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for up in self.up_blocks:
            x = up(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """Decode latents [N, h, w, 4] -> images [N, H, W, 3]; with the encoder,
    encode images -> posterior moments."""

    def __init__(self, config: VAEConfig = VAEConfig(), with_encoder: bool = False):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = Conv2d(config.latent_channels, config.latent_channels, 1, 1, 0)
        if with_encoder:  # after the decoder: a seeded init of it is unchanged
            self.encoder = Encoder(config)
            lc = 2 * config.latent_channels
            self.quant_conv = Conv2d(lc, lc, 1, 1, 0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [N, H, W, 3] in [-1, 1] -> (mean, logvar) [N, h, w, 4]."""
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def sample_posterior(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        mean, logvar = self.encode(x)
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=generator.device if generator is not None else mean.device)
        return mean + torch.exp(0.5 * logvar) * eps.to(mean.device)
