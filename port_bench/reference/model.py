"""The plain reference of CVD's model, in float32: the SD1.5 UNet inflated
to video with AnimateDiff motion modules, CameraCtrl's pose conditioning
and CVD's epipolar cross-video (epi) modules, the CameraCtrl pose encoder,
the CLIP-L text encoder and the SD VAE.

Written from the released architecture, one PyTorch operation at a time,
with no kernel, cache, capture or batching trick. Module and parameter
names are the released checkpoints' state-dict keys, so one state dict
loads into this model and into the program alike. Activations are
channels-last: video [B, F, H, W, C], images [N, H, W, C], tokens [B, L, C].
Every product, convolution and attention goes through ``ops`` (float32, or
the float8 control). Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import ops
from .geometry import epipolar_bias


# ---- building blocks ----------------------------------------------------

class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int, eps: float, silu: bool = False):
        super().__init__()
        self.groups, self.eps, self.silu = groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return ops.group_norm(x, self.weight, self.bias, self.groups, self.eps, self.silu)


def per_frame(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A GroupNorm of [B, F, H, W, C] with statistics per frame."""
    return norm(x.reshape((-1,) + x.shape[2:])).reshape(x.shape)


class Conv(nn.Conv2d):
    def forward(self, x):
        return ops.conv2d(x, self.weight, self.bias, self.stride[0], self.padding[0])


def lin(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return ops.linear(x, m.weight, m.bias)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoids, cos first, max period 1e4, no shift: [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    emb = freqs[None] * t.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], -1)


def positional_encoding(length: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(length, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """LayerNorm -> GEGLU (x * gelu(gate)) -> Linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x, norm: nn.LayerNorm):
        (h,) = ops.ln_linear(x, norm, [self.net[0].proj])
        h, gate = h.chunk(2, dim=-1)
        return lin(self.net[2], h * F.gelu(gate))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], groups: int, eps: float = 1e-6):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, eps, silu=True)
        self.conv1 = Conv(cin, cout, 3, 1, 1)
        self.time_emb_proj = nn.Linear(temb, cout) if temb else None
        self.norm2 = GroupNorm(cout, groups, eps, silu=True)
        self.conv2 = Conv(cout, cout, 3, 1, 1)
        self.conv_shortcut = Conv(cin, cout, 1, 1, 0) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None:
            h = h + lin(self.time_emb_proj, F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Sampler(nn.Module):
    """Stride-2 3x3 convolution (down) or nearest x2 then 3x3 (up)."""

    def __init__(self, channels: int, up: bool, vae_pad: bool = False):
        super().__init__()
        self.up, self.vae_pad = up, vae_pad
        self.conv = Conv(channels, channels, 3, 1 if up else 2, 0 if vae_pad else 1)

    def forward(self, x):
        if self.up:
            x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0,
                              mode="nearest").permute(0, 2, 3, 1)
        elif self.vae_pad:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return self.conv(x)


# ---- UNet ---------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, ctx: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx or dim, dim, bias=False)
        self.to_v = nn.Linear(ctx or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ctx: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, ctx)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        a = self.attn1
        q, k, v = ops.ln_linear(x, self.norm1, [a.to_q, a.to_k, a.to_v])
        x = x + lin(a.to_out[0], ops.attention(q, k, v, a.heads, kind="self"))
        a = self.attn2
        (q,) = ops.ln_linear(x, self.norm2, [a.to_q])
        k, v = lin(a.to_k, context), lin(a.to_v, context)
        x = x + lin(a.to_out[0], ops.attention(q, k, v, a.heads, kind="cross"))
        return x + self.ff(x, self.norm3)


class Transformer2D(nn.Module):
    def __init__(self, channels: int, heads: int, ctx: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(channels, groups, 1e-6)
        self.proj_in = Conv(channels, channels, 1, 1, 0)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(channels, heads, ctx)])
        self.proj_out = Conv(channels, channels, 1, 1, 0)

    def forward(self, x, context):
        N, H, W, C = x.shape
        h = self.proj_in(self.norm(x)).reshape(N, H * W, C)
        h = self.transformer_blocks[0](h, context)
        return self.proj_out(h.reshape(N, H, W, C)) + x


class PoseProcessor(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv_merge = nn.Linear(dim, dim)


class TemporalAttention(nn.Module):
    """Attention over frames at each pixel, after a sinusoidal positional
    encoding; the pose-conditioned one first mixes the pose feature in:
    h' = qkv_merge(h + pose) * scale + h."""

    def __init__(self, dim: int, heads: int, pe_len: int, posed: bool, pose_scale: float):
        super().__init__()
        self.heads, self.pe_len, self.pose_scale = heads, pe_len, pose_scale
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.processor = PoseProcessor(dim) if posed else None

    def forward(self, x, pose):
        B, N, Fr, C = x.shape
        x = x + positional_encoding(self.pe_len, C, x.device)[:Fr]
        if self.processor is not None and pose is not None:
            x = lin(self.processor.qkv_merge, x + pose) * self.pose_scale + x
        q, k, v = lin(self.to_q, x), lin(self.to_k, x), lin(self.to_v, x)
        return lin(self.to_out[0], ops.temporal_attention(q, k, v, self.heads))


class TemporalBlock(nn.Module):
    def __init__(self, dim: int, heads: int, n_attn: int, pe_len: int,
                 posed: Sequence[int] = (), pose_scale: float = 1.0):
        super().__init__()
        self.attention_blocks = nn.ModuleList([
            TemporalAttention(dim, heads, pe_len, i in posed, pose_scale) for i in range(n_attn)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-5) for _ in range(n_attn)])
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, pose=None):
        for norm, attn in zip(self.norms, self.attention_blocks):
            x = attn(ops.layer_norm(x, norm), pose) + x
        return self.ff(x, self.ff_norm) + x


class TemporalTransformer(nn.Module):
    def __init__(self, c: int, heads: int, pe_len: int, groups: int, posed, pose_scale):
        super().__init__()
        self.norm = GroupNorm(c, groups, 1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList([TemporalBlock(c, heads, 2, pe_len, posed,
                                                               pose_scale)])
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, pose):
        B, Fr, H, W, C = x.shape
        h = per_frame(self.norm, x).reshape(B, Fr, H * W, C).transpose(1, 2)
        h = lin(self.proj_in, h)
        if pose is not None:
            pose = pose.reshape(B, Fr, H * W, -1).transpose(1, 2)
        h = self.transformer_blocks[0](h, pose)
        return lin(self.proj_out, h).transpose(1, 2).reshape(x.shape) + x


class MotionModule(nn.Module):
    def __init__(self, *args):
        super().__init__()
        self.temporal_transformer = TemporalTransformer(*args)

    def forward(self, x, pose):
        return self.temporal_transformer(x, pose)


@dataclasses.dataclass
class EpiCond:
    """One UNet call's epipolar conditioning: F mats [B*F, 3, 3] of the
    rows (videos x CFG x frames, partner of row b: (b + B/2) mod B), and the
    first frames' random slope: ``slope`` given, or drawn from ``generator``
    at each epi attention (one uniform in [0, pi) per attention)."""

    F_mats: torch.Tensor
    video_length: int
    F_size: int
    slope: Optional[torch.Tensor] = None
    generator: Optional[torch.Generator] = None

    def draw_slope(self) -> torch.Tensor:
        if self.slope is not None:
            return self.slope
        g = self.generator
        return torch.rand((1,), generator=g, device=g.device).to(self.F_mats.device) * math.pi


class EpiAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, norm, cond: EpiCond):
        B, N, C = x.shape
        feat = int(round(N ** 0.5))
        bias = epipolar_bias(cond.F_mats, feat, cond.F_size, cond.video_length,
                             cond.draw_slope())
        q, k, v = ops.ln_linear(x, norm, [self.to_q, self.to_k, self.to_v])
        half = B // 2
        k, v = (torch.cat([t[half:], t[:half]]) for t in (k, v))
        out = ops.attention(q, k, v, self.heads, bias=bias, kind="epi", routed=True)
        return lin(self.to_out[0], out)


class EpiBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.attention_blocks = nn.ModuleList([EpiAttention(dim, heads) for _ in range(2)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-5) for _ in range(2)])
        self.ff = FeedForward(dim)
        self.ff_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, cond):
        for norm, attn in zip(self.norms, self.attention_blocks):
            x = x + attn(x, norm, cond)
        return self.ff(x, self.ff_norm) + x


class EpiTransformer(nn.Module):
    def __init__(self, c: int, heads: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(c, groups, 1e-6)
        self.proj_in = nn.Linear(c, c)
        self.transformer_blocks = nn.ModuleList([EpiBlock(c, heads)])
        self.proj_out = nn.Linear(c, c)

    def forward(self, x, cond):
        B, Fr, H, W, C = x.shape
        h = lin(self.proj_in, per_frame(self.norm, x).reshape(B * Fr, H * W, C))
        h = self.transformer_blocks[0](h, cond)
        return lin(self.proj_out, h).reshape(x.shape) + x


class EpiModule(nn.Module):
    def __init__(self, *args):
        super().__init__()
        self.epi_transformer = EpiTransformer(*args)

    def forward(self, x, cond):
        return self.epi_transformer(x, cond)


class Block(nn.Module):
    """A down, mid or up block: per layer resnet -> spatial transformer? ->
    motion module? -> epi module?, then a down / up sampler."""

    def __init__(self, cfg: dict, cins: Sequence[int], c: int, temb: int, attn: bool,
                 motion: bool, epi: bool, sampler: Optional[str]):
        super().__init__()
        heads, groups = cfg["attention_heads"], cfg["norm_num_groups"]
        n = len(cins)
        self.resnets = nn.ModuleList([ResnetBlock(ci, c, temb, groups) for ci in cins])
        self.attentions = nn.ModuleList([
            Transformer2D(c, heads, cfg["cross_attention_dim"], groups) for _ in range(n)]
        ) if attn else None
        self.motion_modules = nn.ModuleList([
            MotionModule(c, heads, cfg["motion_pe_max_len"], cfg["motion_norm_groups"],
                         tuple(cfg["pose_cond_attn_indices"]), cfg["pose_scale"])
            for _ in range(n)]) if motion else None
        self.epi_modules = nn.ModuleList([
            EpiModule(c, heads, cfg["epi_norm_groups"]) for _ in range(n)]) if epi else None
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Sampler(c, up=False)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Sampler(c, up=True)])

    def layer(self, j, x, temb_f, ctx_f, pose, cond):
        B = x.shape[0]
        h = self.resnets[j](x.reshape((-1,) + x.shape[2:]), temb_f)
        if self.attentions is not None:
            h = self.attentions[j](h, ctx_f)
        x = h.reshape((B, -1) + h.shape[1:])
        if self.motion_modules is not None:
            x = self.motion_modules[j](x, pose)
        if self.epi_modules is not None:
            x = self.epi_modules[j](x, cond)
        return x

    def resample(self, x, which):
        B = x.shape[0]
        h = getattr(self, which)[0](x.reshape((-1,) + x.shape[2:]))
        return h.reshape((B, -1) + h.shape[1:])


class UNet3DConditionModel(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg["block_out_channels"])
        L = cfg["layers_per_block"]
        temb = ch[0] * 4
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(ch[0], temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)
        self.conv_in = Conv(cfg["in_channels"], ch[0], 3, 1, 1)

        def has(kind, res):
            return cfg[f"use_{kind}_module"] and res in cfg[f"{kind}_module_resolutions"]

        skips = [ch[0]]
        down = []
        for i, c in enumerate(ch):
            last = i == len(ch) - 1
            down.append(Block(cfg, [ch[max(i - 1, 0)]] + [c] * (L - 1), c, temb, not last,
                              has("motion", 2 ** i), has("epi", 2 ** i),
                              None if last else "down"))
            skips += [c] * (L + (0 if last else 1))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Block(cfg, [ch[-1]], ch[-1], temb, True,
                               cfg["use_motion_module"] and cfg["motion_module_mid_block"],
                               cfg["use_epi_module"] and cfg["epi_module_mid_block"], None)
        self.mid_block.resnets.append(ResnetBlock(ch[-1], ch[-1], temb, cfg["norm_num_groups"]))
        up, cur = [], ch[-1]
        for i, c in enumerate(reversed(ch)):
            mine, skips = skips[-(L + 1):][::-1], skips[:-(L + 1)]
            cins = [(cur if j == 0 else c) + s for j, s in enumerate(mine)]
            up.append(Block(cfg, cins, c, temb, i != 0, has("motion", 2 ** (3 - i)),
                            has("epi", 2 ** (3 - i)), "up" if i != len(ch) - 1 else None))
            cur = c
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(ch[0], cfg["norm_num_groups"], 1e-5, silu=True)
        self.conv_out = Conv(ch[0], cfg["out_channels"], 3, 1, 1)

    def forward(self, sample, timesteps, text, pose_features, cond: EpiCond):
        """sample [B, F, h, w, 4], timesteps [B] (or []), text [B, 77, 768],
        four pose features [B, F, h_i, w_i, c_i] -> noise prediction. Under
        autograd each layer's activations are recomputed in the backward
        (the same arithmetic, so that a full-size step fits the card)."""
        B, Fr = sample.shape[:2]
        t = timesteps.reshape(-1).expand(B) if timesteps.numel() == 1 else timesteps
        te = self.time_embedding
        temb = lin(te.linear_2, F.silu(lin(te.linear_1, timestep_embedding(
            t, self.cfg["block_out_channels"][0]))))
        temb_f = temb.repeat_interleave(Fr, 0)
        ctx_f = text.repeat_interleave(Fr, 0)
        x = self.conv_in(sample.reshape((-1,) + sample.shape[2:]))
        x = x.reshape((B, Fr) + x.shape[1:])

        def layer(blk, j, x, pose):
            if torch.is_grad_enabled() and x.device.type != "meta":
                return checkpoint(blk.layer, j, x, temb_f, ctx_f, pose, cond,
                                  use_reentrant=False)
            return blk.layer(j, x, temb_f, ctx_f, pose, cond)

        stack = [x]
        for i, blk in enumerate(self.down_blocks):
            for j in range(len(blk.resnets)):
                x = layer(blk, j, x, pose_features[i])
                stack.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.resample(x, "downsamplers")
                stack.append(x)
        x = layer(self.mid_block, 0, x, pose_features[-1])
        h = self.mid_block.resnets[1](x.reshape((-1,) + x.shape[2:]), temb_f)
        x = h.reshape((B, Fr) + h.shape[1:])
        for i, blk in enumerate(self.up_blocks):
            for j in range(len(blk.resnets)):
                x = layer(blk, j, torch.cat([x, stack.pop()], -1), pose_features[-(i + 1)])
            if hasattr(blk, "upsamplers"):
                x = blk.resample(x, "upsamplers")
        out = self.conv_out(self.conv_norm_out(x.reshape((-1,) + x.shape[2:])))
        return out.reshape((B, Fr) + out.shape[1:])


# ---- pose encoder -------------------------------------------------------

class PoseResnet(nn.Module):
    def __init__(self, cin: int, cout: int, down: bool):
        super().__init__()
        self.down = down
        self.in_conv = Conv(cin, cout, 1, 1, 0) if cin != cout else None
        self.block1 = Conv(cout, cout, 3, 1, 1)
        self.block2 = Conv(cout, cout, 1, 1, 0)

    def forward(self, x):
        if self.down:
            x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        if self.in_conv is not None:
            x = self.in_conv(x)
        return self.block2(F.relu(self.block1(x))) + x


class CameraPoseEncoder(nn.Module):
    """Plucker video [B, F, H, W, 6] -> pixel-unshuffle by 8 -> conv, then per
    stage two (resnet, temporal attention) pairs -> four features."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch, self.factor = list(cfg["channels"]), cfg["downscale_factor"]
        self.encoder_conv_in = Conv(cfg["cin"], ch[0], 3, 1, 1)
        convs, attns, cin = [], [], ch[0]
        for i, c in enumerate(ch):
            convs.append(nn.ModuleList([PoseResnet(cin if j == 0 else c, c, j == 0 and i != 0)
                                        for j in range(cfg["nums_rb"])]))
            attns.append(nn.ModuleList([
                TemporalBlock(c, cfg["temporal_attention_nhead"], 1,
                              cfg["temporal_position_encoding_max_len"])
                for _ in range(cfg["nums_rb"])]))
            cin = c
        self.encoder_down_conv_blocks = nn.ModuleList(convs)
        self.encoder_down_attention_blocks = nn.ModuleList(attns)

    def forward(self, plucker):
        B, Fr, H, W, C = plucker.shape
        f = self.factor
        x = plucker.reshape(B * Fr, H // f, f, W // f, f, C).permute(0, 1, 3, 5, 2, 4)
        x = self.encoder_conv_in(x.reshape(B * Fr, H // f, W // f, C * f * f))
        feats = []
        for convs, attns in zip(self.encoder_down_conv_blocks,
                                self.encoder_down_attention_blocks):
            for conv, attn in zip(convs, attns):
                x = conv(x)
                n, h, w, c = x.shape
                x = attn(x.reshape(B, Fr, h * w, c).transpose(1, 2)).transpose(1, 2)
                x = x.reshape(n, h, w, c)
            feats.append(x.reshape(B, Fr, *x.shape[1:]))
        return feats


# ---- CLIP text encoder --------------------------------------------------

class CLIPAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)


class CLIPMLP(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, inner), nn.Linear(inner, d)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])
        self.self_attn = CLIPAttention(d, cfg["num_heads"])
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])
        self.mlp = CLIPMLP(d, cfg["intermediate_size"])

    def forward(self, x, causal):
        a = self.self_attn
        q, k, v = ops.ln_linear(x, self.layer_norm1, [a.q_proj, a.k_proj, a.v_proj])
        x = x + lin(a.out_proj, ops.attention(q, k, v, a.heads, bias=causal, kind="clip"))
        (h,) = ops.ln_linear(x, self.layer_norm2, [self.mlp.fc1])
        return x + lin(self.mlp.fc2, h * torch.sigmoid(1.702 * h))


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["hidden_size"]
        self.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        self.position_embedding = nn.Parameter(torch.zeros(cfg["max_position_embeddings"], d))
        self.layers = nn.ModuleList([CLIPLayer(cfg) for _ in range(cfg["num_layers"])])
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg["layer_norm_eps"])

    def forward(self, ids):
        B, L = ids.shape
        x = F.embedding(ids.long(), self.token_embedding.weight) + self.position_embedding[:L]
        causal = torch.triu(torch.full((L, L), float("-inf"), device=x.device), 1)
        causal = causal[None].expand(B, L, L)
        for layer in self.layers:
            x = layer(x, causal)
        return ops.layer_norm(x, self.final_layer_norm)


# ---- VAE ----------------------------------------------------------------

class VAEAttention(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(c, groups, 1e-6)
        self.to_q, self.to_k, self.to_v = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        N, H, W, C = x.shape
        h = self.group_norm(x).reshape(N, H * W, C)
        h = ops.attention(lin(self.to_q, h), lin(self.to_k, h), lin(self.to_v, h), 1,
                          kind="vae")
        return lin(self.to_out[0], h).reshape(x.shape) + x


class VAEMid(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(c, c, None, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(c, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class VAEBlock(nn.Module):
    def __init__(self, cin: int, c: int, n: int, groups: int, sampler: Optional[str]):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cin if j == 0 else c, c, None, groups)
                                      for j in range(n)])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Sampler(c, up=False, vae_pad=True)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Sampler(c, up=True)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for name in ("downsamplers", "upsamplers"):
            if hasattr(self, name):
                x = getattr(self, name)[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, g, L = list(cfg["block_out_channels"]), cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = Conv(cfg["in_channels"], ch[0], 3, 1, 1)
        self.down_blocks = nn.ModuleList([
            VAEBlock(ch[max(i - 1, 0)], c, L, g, "down" if i < len(ch) - 1 else None)
            for i, c in enumerate(ch)])
        self.mid_block = VAEMid(ch[-1], g)
        self.conv_norm_out = GroupNorm(ch[-1], g, 1e-6, silu=True)
        self.conv_out = Conv(ch[-1], 2 * cfg["latent_channels"], 3, 1, 1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        return self.conv_out(self.conv_norm_out(self.mid_block(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch = list(reversed(cfg["block_out_channels"]))
        g, L = cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = Conv(cfg["latent_channels"], ch[0], 3, 1, 1)
        self.mid_block = VAEMid(ch[0], g)
        self.up_blocks = nn.ModuleList([
            VAEBlock(ch[max(i - 1, 0)], c, L + 1, g, "up" if i < len(ch) - 1 else None)
            for i, c in enumerate(ch)])
        self.conv_norm_out = GroupNorm(ch[-1], g, 1e-6, silu=True)
        self.conv_out = Conv(ch[-1], cfg["out_channels"], 3, 1, 1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: dict, encoder: bool):
        super().__init__()
        lc = cfg["latent_channels"]
        self.decoder = Decoder(cfg)
        self.post_quant_conv = Conv(lc, lc, 1, 1, 0)
        if encoder:
            self.encoder = Encoder(cfg)
            self.quant_conv = Conv(2 * lc, 2 * lc, 1, 1, 0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def moments(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


# ---- the bundle ---------------------------------------------------------

MODULES = ("unet", "vae", "clip", "pose_encoder")


def build(config: dict, device, vae_encoder: bool = False) -> nn.ModuleDict:
    """The four models of ``config`` (its ``unet``, ``vae``, ``clip`` and
    ``pose_encoder`` groups) on ``device``, parameters uninitialized (a state
    dict fills them; on ``meta`` they are shapes alone)."""
    with torch.device("meta"):
        mods = nn.ModuleDict({
            "unet": UNet3DConditionModel(config["unet"]),
            "vae": AutoencoderKL(config["vae"], vae_encoder),
            "clip": CLIPTextEncoder(config["clip"]),
            "pose_encoder": CameraPoseEncoder(config["pose_encoder"]),
        })
    if torch.device(device).type != "meta":
        mods = mods.to_empty(device=device)
    return mods.requires_grad_(False)
