"""The plain reference of CVD on the SDXL backbone, in float32: the SDXL base
UNet (arXiv:2307.01952; the base model's ``unet/config.json``) inflated to
video with AnimateDiff-SDXL's motion modules (arXiv:2307.04725), CameraCtrl's
pose conditioning and CVD's epi modules, SDXL's two text encoders (CLIP-L
and OpenCLIP ViT-bigG's text tower), the SD VAE and SDXL's added
``text_time`` conditioning.

Written as ``model.py`` is, and from its blocks where the arithmetic is the
same (resnets, samplers, the spatial block, the motion, epi and pose
paths, CLIP's layers, the VAE); what SDXL adds is here: the spatial
transformer's depth per level (none at the first), its Linear ``proj_in`` /
``proj_out``, heads 64 wide in the spatial attentions (the configuration's
``spatial_heads``, diffusers' ``attention_head_dim``), the mid block's deep
stack, ``add_embedding`` over the pooled text and the sinusoids of the six
time ids, CLIP's GELU, penultimate states and pooled projection. Nothing
here imports the program.

Departures from the published description:

* The motion modules are AnimateDiff's temporal transformer as in
  ``model.py`` (GroupNorm, two temporal self-attentions with a sinusoidal
  position encoding of 32, a GEGLU feed-forward), 8 heads, at every level
  and not in the mid block: the settings of AnimateDiff-SDXL's beta as its
  repository states them. The epi modules and the pose encoder are CVD's
  and CameraCtrl's at SDXL's three widths; no checkpoint of this
  composition is released.
* Both text encoders take the same token ids (the benchmark's word hash);
  SDXL's two tokenizers differ in their padding token. The pooled embedding
  is bigG's final-LayerNormed state at the first position of the largest
  id, the EOS token, as transformers picks it for bigG's configuration.
* The negative prompt is always encoded: SDXL zeroes the negative
  conditioning only where no negative prompt is given.
* On a device (not ``meta``) the epi attention runs over blocks of rows,
  the same arithmetic: at 512 px its first level's logits are 34 GB a call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import model, ops
from .model import Block, Conv, EpiCond, GroupNorm, ResnetBlock, lin, timestep_embedding

# the most bytes of float32 logits one block of an epi attention's rows holds
EPI_BLOCK_BYTES = 2 ** 31


class Transformer2DLinear(nn.Module):
    """GroupNorm, a Linear ``proj_in``, ``depth`` transformer blocks, a
    Linear ``proj_out`` and the residual (``use_linear_projection``)."""

    def __init__(self, channels: int, heads: int, ctx: int, groups: int, depth: int):
        super().__init__()
        self.norm = GroupNorm(channels, groups, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            model.BasicTransformerBlock(channels, heads, ctx) for _ in range(depth)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context):
        N, H, W, C = x.shape
        h = lin(self.proj_in, self.norm(x).reshape(N, H * W, C))
        for blk in self.transformer_blocks:
            h = blk(h, context)
        return lin(self.proj_out, h).reshape(N, H, W, C) + x


class BlockedEpiAttention(model.EpiAttention):
    """``model.EpiAttention`` with its attention taken over blocks of rows on
    a device; one bias (and one slope draw) a call, as there."""

    def forward(self, x, norm, cond: EpiCond):
        B, N, C = x.shape
        rows = max(1, EPI_BLOCK_BYTES // (self.heads * N * N * 4))
        if x.device.type == "meta" or rows >= B:
            return super().forward(x, norm, cond)
        feat = int(round(N ** 0.5))
        bias = model.epipolar_bias(cond.F_mats, feat, cond.F_size, cond.video_length,
                                   cond.draw_slope())
        q, k, v = ops.ln_linear(x, norm, [self.to_q, self.to_k, self.to_v])
        half = B // 2
        k, v = (torch.cat([t[half:], t[:half]]) for t in (k, v))
        out = torch.cat([ops.attention(q[i:i + rows], k[i:i + rows], v[i:i + rows], self.heads,
                                       bias=bias[i:i + rows], kind="epi", routed=True)
                         for i in range(0, B, rows)])
        return lin(self.to_out[0], out)


def _attend(block: Block, cfg: dict, channels: int, level_heads: int, depth: int, n: int):
    """Give ``block`` its ``n`` spatial transformers of ``depth`` blocks
    (none at depth 0), and blocked epi attentions."""
    if depth:
        block.attentions = nn.ModuleList([
            Transformer2DLinear(channels, level_heads, cfg["cross_attention_dim"],
                                cfg["norm_num_groups"], depth) for _ in range(n)])
    for m in block.modules():
        if type(m) is model.EpiAttention:
            m.__class__ = BlockedEpiAttention
    return block


class SDXLUNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = list(cfg["block_out_channels"])
        n, L = len(ch), cfg["layers_per_block"]
        depth, heads = cfg["transformer_layers_per_block"], cfg["spatial_heads"]
        temb = ch[0] * 4
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(ch[0], temb)
        self.time_embedding.linear_2 = nn.Linear(temb, temb)
        self.add_embedding = nn.Module()
        self.add_embedding.linear_1 = nn.Linear(cfg["projection_class_embeddings_input_dim"],
                                                temb)
        self.add_embedding.linear_2 = nn.Linear(temb, temb)
        self.conv_in = Conv(cfg["in_channels"], ch[0], 3, 1, 1)

        def has(kind, level):
            return cfg[f"use_{kind}_module"] and 2 ** level in cfg[f"{kind}_module_resolutions"]

        skips, down = [ch[0]], []
        for i, c in enumerate(ch):
            last = i == n - 1
            blk = Block(cfg, [ch[max(i - 1, 0)]] + [c] * (L - 1), c, temb, False,
                        has("motion", i), has("epi", i), None if last else "down")
            down.append(_attend(blk, cfg, c, heads[i], depth[i], L))
            skips += [c] * (L + (0 if last else 1))
        self.down_blocks = nn.ModuleList(down)
        mid = Block(cfg, [ch[-1]], ch[-1], temb, False,
                    cfg["use_motion_module"] and cfg["motion_module_mid_block"],
                    cfg["use_epi_module"] and cfg["epi_module_mid_block"], None)
        mid.resnets.append(ResnetBlock(ch[-1], ch[-1], temb, cfg["norm_num_groups"]))
        self.mid_block = _attend(mid, cfg, ch[-1], heads[-1], cfg["mid_transformer_layers"], 1)
        up, cur = [], ch[-1]
        for i, c in enumerate(reversed(ch)):
            level = n - 1 - i
            mine, skips = skips[-(L + 1):][::-1], skips[:-(L + 1)]
            cins = [(cur if j == 0 else c) + s for j, s in enumerate(mine)]
            blk = Block(cfg, cins, c, temb, False, has("motion", level), has("epi", level),
                        "up" if level else None)
            up.append(_attend(blk, cfg, c, heads[level], depth[level], L + 1))
            cur = c
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(ch[0], cfg["norm_num_groups"], 1e-5, silu=True)
        self.conv_out = Conv(ch[0], cfg["out_channels"], 3, 1, 1)

    def forward(self, sample, timesteps, text, pose_features, cond: EpiCond, text_embeds,
                time_ids):
        """sample [B, F, h, w, 4], timesteps [B], text [B, 77, 2048], a pose
        feature per level [B, F, h_i, w_i, c_i], pooled text [B, 1280] and
        time ids [B, 6] -> noise prediction."""
        B, Fr = sample.shape[:2]
        c0 = self.cfg["block_out_channels"][0]
        te, ae = self.time_embedding, self.add_embedding
        temb = lin(te.linear_2, F.silu(lin(te.linear_1, timestep_embedding(timesteps, c0))))
        times = timestep_embedding(time_ids.reshape(-1), self.cfg["addition_time_embed_dim"])
        added = torch.cat([text_embeds, times.reshape(B, -1)], -1)
        temb = temb + lin(ae.linear_2, F.silu(lin(ae.linear_1, added)))
        temb_f = temb.repeat_interleave(Fr, 0)
        ctx_f = text.repeat_interleave(Fr, 0)
        x = self.conv_in(sample.reshape((-1,) + sample.shape[2:]))
        x = x.reshape((B, Fr) + x.shape[1:])
        stack = [x]
        for i, blk in enumerate(self.down_blocks):
            for j in range(len(blk.resnets)):
                x = blk.layer(j, x, temb_f, ctx_f, pose_features[i], cond)
                stack.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.resample(x, "downsamplers")
                stack.append(x)
        x = self.mid_block.layer(0, x, temb_f, ctx_f, pose_features[-1], cond)
        h = self.mid_block.resnets[1](x.reshape((-1,) + x.shape[2:]), temb_f)
        x = h.reshape((B, Fr) + h.shape[1:])
        for i, blk in enumerate(self.up_blocks):
            for j in range(len(blk.resnets)):
                x = blk.layer(j, torch.cat([x, stack.pop()], -1), temb_f, ctx_f,
                              pose_features[-(i + 1)], cond)
            if hasattr(blk, "upsamplers"):
                x = blk.resample(x, "upsamplers")
        out = self.conv_out(self.conv_norm_out(x.reshape((-1,) + x.shape[2:])))
        return out.reshape((B, Fr) + out.shape[1:])


class GeluCLIPLayer(model.CLIPLayer):
    """A CLIP layer with the exact (erf) GELU: bigG's ``hidden_act`` "gelu"."""

    def forward(self, x, causal):
        a = self.self_attn
        q, k, v = ops.ln_linear(x, self.layer_norm1, [a.q_proj, a.k_proj, a.v_proj])
        x = x + lin(a.out_proj, ops.attention(q, k, v, a.heads, bias=causal, kind="clip"))
        (h,) = ops.ln_linear(x, self.layer_norm2, [self.mlp.fc1])
        return x + lin(self.mlp.fc2, F.gelu(h))


class CLIPText(model.CLIPTextEncoder):
    """``model.CLIPTextEncoder`` with the configuration's ``hidden_act`` and,
    with ``projection_dim``, a ``text_projection`` (no bias)."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        if cfg["hidden_act"] == "gelu":
            for layer in self.layers:
                layer.__class__ = GeluCLIPLayer
        elif cfg["hidden_act"] != "quick_gelu":
            raise ValueError(f"hidden_act {cfg['hidden_act']!r}")
        if cfg["projection_dim"]:
            self.text_projection = nn.Linear(cfg["hidden_size"], cfg["projection_dim"],
                                             bias=False)

    def encode(self, ids):
        """-> (the penultimate layer's states [B, L, d], the pooled
        projection [B, p] or None)."""
        B, L = ids.shape
        x = F.embedding(ids.long(), self.token_embedding.weight) + self.position_embedding[:L]
        causal = torch.triu(torch.full((L, L), float("-inf"), device=x.device), 1)
        causal = causal[None].expand(B, L, L)
        for layer in self.layers[:-1]:
            x = layer(x, causal)
        if not hasattr(self, "text_projection"):
            return x, None
        last = ops.layer_norm(self.layers[-1](x, causal), self.final_layer_norm)
        pooled = last[torch.arange(B, device=x.device), ids.argmax(dim=-1)]
        return x, lin(self.text_projection, pooled)


def build(config: dict, device, vae_encoder: bool = False) -> nn.ModuleDict:
    """The five models of ``config`` (``unet``, ``vae``, ``clip``, ``clip_2``,
    ``pose_encoder``) on ``device``, parameters uninitialized."""
    with torch.device("meta"):
        mods = nn.ModuleDict({
            "unet": SDXLUNet(config["unet"]),
            "vae": model.AutoencoderKL(config["vae"], vae_encoder),
            "clip": CLIPText(config["clip"]),
            "clip_2": CLIPText(config["clip_2"]),
            "pose_encoder": model.CameraPoseEncoder(config["pose_encoder"]),
        })
    if torch.device(device).type != "meta":
        mods = mods.to_empty(device=device)
    return mods.requires_grad_(False)


def encode_text(mods, ids):
    """-> (both encoders' penultimate states joined [B, L, 2048], bigG's
    pooled projection [B, 1280])."""
    first, _ = mods["clip"].encode(ids)
    second, pooled = mods["clip_2"].encode(ids)
    return torch.cat([first, second], -1), pooled


def time_ids(size: int, rows: int, device) -> torch.Tensor:
    """SDXL's six time ids of ``rows`` rows at a square ``size``: the
    original size, no crop, the target size."""
    return torch.tensor([[size, size, 0, 0, size, size]] * rows, dtype=torch.float32,
                        device=device)
