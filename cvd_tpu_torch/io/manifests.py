"""Complete key manifests (name -> shape) of every checkpoint artifact kind
the reference loads, for import validation without the real files.

Artifact kinds and their reference load sites (inference_epi.py:72-145):

* SD1.5 diffusers folder: unet / vae / text_encoder   (:76-80)
* SDXL base diffusers folder: unet, text_encoder_2 (the SDXL backbone;
  ``sdxl_unet_manifest``, ``sdxl_clip_2_manifest``; its text_encoder and
  vae are SD1.5's layouts)
* AnimateDiff v3 motion module .ckpt                  (:100-105)
* CameraCtrl pose adaptor .ckpt
  (pose_encoder_state_dict + attention_processor_state_dict, :115-123)
* CVD epi .ckpt (unet_trainable_dict, :107-113)
* civitai single-file LDM .safetensors/.ckpt          (:49-69)

The diffusers-layout enumerations follow the architecture the reference's
own vendored converter emits (animatediff/utils/convert_from_ckpt.py); the
LDM-layout enumerations follow the CompVis naming the converter consumes —
two independent naming paths that tests cross-check against each other and
against the port's ``state_dict()`` shapes.

``cvd_tpu_torch.cli.build.validate_ckpts`` drives the real importer in
shape-only mode: every manifest key must land on a parameter of the port's
modules with the same shape (or be an explicitly skipped buffer). This is
the "zero unmapped keys" contract the reference enforces with strict-load
asserts. The port's own copy of ``cvd_tpu/io/manifests.py`` (it imports
nothing of that package), plus ``random_state``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Shape = Tuple[int, ...]
Manifest = Dict[str, Shape]

CH = (320, 640, 1280, 1280)       # SD1.5 UNet block channels
RCH = (1280, 1280, 640, 320)      # reversed (up path)
TEMB = 1280
CROSS = 768


def _linear(m: Manifest, name: str, out_f: int, in_f: int, bias: bool = True):
    m[f"{name}.weight"] = (out_f, in_f)
    if bias:
        m[f"{name}.bias"] = (out_f,)


def _conv(m: Manifest, name: str, out_c: int, in_c: int, k: int):
    m[f"{name}.weight"] = (out_c, in_c, k, k)
    m[f"{name}.bias"] = (out_c,)


def _norm(m: Manifest, name: str, c: int):
    m[f"{name}.weight"] = (c,)
    m[f"{name}.bias"] = (c,)


def _resnet(m: Manifest, p: str, cin: int, cout: int, temb: int = TEMB):
    _norm(m, f"{p}.norm1", cin)
    _conv(m, f"{p}.conv1", cout, cin, 3)
    if temb:
        _linear(m, f"{p}.time_emb_proj", cout, temb)
    _norm(m, f"{p}.norm2", cout)
    _conv(m, f"{p}.conv2", cout, cout, 3)
    if cin != cout:
        _conv(m, f"{p}.conv_shortcut", cout, cin, 1)


def _spatial_transformer(m: Manifest, p: str, c: int, cross: int = CROSS, depth: int = 1,
                         linear: bool = False):
    _norm(m, f"{p}.norm", c)
    proj = (lambda name: _linear(m, name, c, c)) if linear else (
        lambda name: _conv(m, name, c, c, 1))
    proj(f"{p}.proj_in")
    for d in range(depth):
        tb = f"{p}.transformer_blocks.{d}"
        for a, kdim in (("attn1", c), ("attn2", cross)):
            m[f"{tb}.{a}.to_q.weight"] = (c, c)
            m[f"{tb}.{a}.to_k.weight"] = (c, kdim)
            m[f"{tb}.{a}.to_v.weight"] = (c, kdim)
            _linear(m, f"{tb}.{a}.to_out.0", c, c)
        for n in ("norm1", "norm2", "norm3"):
            _norm(m, f"{tb}.{n}", c)
        _linear(m, f"{tb}.ff.net.0.proj", 8 * c, c)
        _linear(m, f"{tb}.ff.net.2", c, 4 * c)
    proj(f"{p}.proj_out")


def _up_resnet_channels(i: int) -> List[Tuple[int, int]]:
    """(cin, cout) per up-block resnet, diffusers skip-concat rule."""
    prev = RCH[i - 1] if i > 0 else CH[-1]
    out = RCH[i]
    skip_in = RCH[min(i + 1, 3)]
    res = []
    for j in range(3):
        skip = skip_in if j == 2 else out
        cin = (prev if j == 0 else out) + skip
        res.append((cin, out))
    return res


def sd15_unet_manifest() -> Manifest:
    """diffusers UNet2DConditionModel (SD1.5) state-dict keys + shapes."""
    m: Manifest = {}
    _conv(m, "conv_in", CH[0], 4, 3)
    _linear(m, "time_embedding.linear_1", TEMB, CH[0])
    _linear(m, "time_embedding.linear_2", TEMB, TEMB)
    for i in range(4):
        for j in range(2):
            cin = (CH[i - 1] if i > 0 else CH[0]) if j == 0 else CH[i]
            _resnet(m, f"down_blocks.{i}.resnets.{j}", cin, CH[i])
            if i < 3:
                _spatial_transformer(m, f"down_blocks.{i}.attentions.{j}", CH[i])
        if i < 3:
            _conv(m, f"down_blocks.{i}.downsamplers.0.conv", CH[i], CH[i], 3)
    _resnet(m, "mid_block.resnets.0", CH[-1], CH[-1])
    _spatial_transformer(m, "mid_block.attentions.0", CH[-1])
    _resnet(m, "mid_block.resnets.1", CH[-1], CH[-1])
    for i in range(4):
        for j, (cin, cout) in enumerate(_up_resnet_channels(i)):
            _resnet(m, f"up_blocks.{i}.resnets.{j}", cin, cout)
            if i > 0:
                _spatial_transformer(m, f"up_blocks.{i}.attentions.{j}", cout)
        if i < 3:
            _conv(m, f"up_blocks.{i}.upsamplers.0.conv", RCH[i], RCH[i], 3)
    _norm(m, "conv_norm_out", CH[0])
    _conv(m, "conv_out", 4, CH[0], 3)
    return m


SDXL_CH = (320, 640, 1280)
# transformer blocks per level (the first level's DownBlock2D / UpBlock2D
# has none) and in the mid block; cross-attention width: CLIP-L + bigG
SDXL_DEPTH = (0, 2, 10)
SDXL_MID_DEPTH = 10
SDXL_CROSS = 2048
SDXL_ADD_IN = 2816                 # pooled bigG 1280 + 6 time ids x 256


def sdxl_unet_manifest() -> Manifest:
    """diffusers UNet2DConditionModel (SDXL base) state-dict keys + shapes:
    three levels, Linear projections, the ``text_time`` add_embedding."""
    m: Manifest = {}
    ch, n = SDXL_CH, len(SDXL_CH)
    _conv(m, "conv_in", ch[0], 4, 3)
    _linear(m, "time_embedding.linear_1", TEMB, ch[0])
    _linear(m, "time_embedding.linear_2", TEMB, TEMB)
    _linear(m, "add_embedding.linear_1", TEMB, SDXL_ADD_IN)
    _linear(m, "add_embedding.linear_2", TEMB, TEMB)
    skips = [ch[0]]
    for i, c in enumerate(ch):
        for j in range(2):
            _resnet(m, f"down_blocks.{i}.resnets.{j}", ch[max(i - 1, 0)] if j == 0 else c, c)
            if SDXL_DEPTH[i]:
                _spatial_transformer(m, f"down_blocks.{i}.attentions.{j}", c, SDXL_CROSS,
                                     SDXL_DEPTH[i], linear=True)
        skips += [c] * (2 if i == n - 1 else 3)
        if i < n - 1:
            _conv(m, f"down_blocks.{i}.downsamplers.0.conv", c, c, 3)
    _resnet(m, "mid_block.resnets.0", ch[-1], ch[-1])
    _spatial_transformer(m, "mid_block.attentions.0", ch[-1], SDXL_CROSS, SDXL_MID_DEPTH,
                         linear=True)
    _resnet(m, "mid_block.resnets.1", ch[-1], ch[-1])
    cur = ch[-1]
    for i, c in enumerate(reversed(ch)):
        level = n - 1 - i
        for j in range(3):
            _resnet(m, f"up_blocks.{i}.resnets.{j}", (cur if j == 0 else c) + skips.pop(), c)
            if SDXL_DEPTH[level]:
                _spatial_transformer(m, f"up_blocks.{i}.attentions.{j}", c, SDXL_CROSS,
                                     SDXL_DEPTH[level], linear=True)
        if level:
            _conv(m, f"up_blocks.{i}.upsamplers.0.conv", c, c, 3)
        cur = c
    _norm(m, "conv_norm_out", ch[0])
    _conv(m, "conv_out", 4, ch[0], 3)
    return m


VAE_CH = (128, 256, 512, 512)
VAE_RCH = (512, 512, 256, 128)


def _vae_attn(m: Manifest, p: str):
    _norm(m, f"{p}.group_norm", 512)
    for a in ("to_q", "to_k", "to_v", "to_out.0"):
        _linear(m, f"{p}.{a}", 512, 512)


def sd15_vae_manifest() -> Manifest:
    """diffusers AutoencoderKL (SD1.5) state-dict keys + shapes."""
    m: Manifest = {}
    _conv(m, "encoder.conv_in", VAE_CH[0], 3, 3)
    for i in range(4):
        for j in range(2):
            cin = (VAE_CH[i - 1] if i > 0 else VAE_CH[0]) if j == 0 else VAE_CH[i]
            _resnet(m, f"encoder.down_blocks.{i}.resnets.{j}", cin, VAE_CH[i],
                    temb=0)
        if i < 3:
            _conv(m, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                  VAE_CH[i], VAE_CH[i], 3)
    _resnet(m, "encoder.mid_block.resnets.0", 512, 512, temb=0)
    _vae_attn(m, "encoder.mid_block.attentions.0")
    _resnet(m, "encoder.mid_block.resnets.1", 512, 512, temb=0)
    _norm(m, "encoder.conv_norm_out", 512)
    _conv(m, "encoder.conv_out", 8, 512, 3)
    _conv(m, "decoder.conv_in", 512, 4, 3)
    _resnet(m, "decoder.mid_block.resnets.0", 512, 512, temb=0)
    _vae_attn(m, "decoder.mid_block.attentions.0")
    _resnet(m, "decoder.mid_block.resnets.1", 512, 512, temb=0)
    for i in range(4):
        for j in range(3):
            cin = (VAE_RCH[i - 1] if i > 0 else 512) if j == 0 else VAE_RCH[i]
            _resnet(m, f"decoder.up_blocks.{i}.resnets.{j}", cin, VAE_RCH[i],
                    temb=0)
        if i < 3:
            _conv(m, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                  VAE_RCH[i], VAE_RCH[i], 3)
    _norm(m, "decoder.conv_norm_out", VAE_RCH[-1])
    _conv(m, "decoder.conv_out", 3, VAE_RCH[-1], 3)
    m["quant_conv.weight"] = (8, 8, 1, 1)
    m["quant_conv.bias"] = (8,)
    m["post_quant_conv.weight"] = (4, 4, 1, 1)
    m["post_quant_conv.bias"] = (4,)
    return m


def sd15_clip_manifest(include_position_ids: bool = True) -> Manifest:
    """transformers CLIPTextModel (openai/clip-vit-large-patch14) keys."""
    return _clip_text(768, 3072, 12, include_position_ids)


def sdxl_clip_2_manifest(include_position_ids: bool = True) -> Manifest:
    """transformers CLIPTextModelWithProjection (SDXL's ``text_encoder_2``,
    OpenCLIP ViT-bigG/14's text tower) keys: 32 layers of width 1280 and the
    pooled ``text_projection`` (no bias)."""
    m = _clip_text(1280, 5120, 32, include_position_ids)
    m["text_projection.weight"] = (1280, 1280)
    return m


def _clip_text(D: int, FF: int, L: int, include_position_ids: bool) -> Manifest:
    m: Manifest = {}
    m["text_model.embeddings.token_embedding.weight"] = (49408, D)
    m["text_model.embeddings.position_embedding.weight"] = (77, D)
    if include_position_ids:  # present in .bin-era exports; skipped on import
        m["text_model.embeddings.position_ids"] = (1, 77)
    for i in range(L):
        p = f"text_model.encoder.layers.{i}"
        for a in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(m, f"{p}.self_attn.{a}", D, D)
        _norm(m, f"{p}.layer_norm1", D)
        _norm(m, f"{p}.layer_norm2", D)
        _linear(m, f"{p}.mlp.fc1", FF, D)
        _linear(m, f"{p}.mlp.fc2", D, FF)
    _norm(m, "text_model.final_layer_norm", D)
    return m


def _temporal_block(m: Manifest, p: str, c: int, n_attn: int = 2,
                    pe_max_len: int = 32, include_pe: bool = True):
    """TemporalTransformerBlock keys (motion_module.py:397-460)."""
    for a in range(n_attn):
        ab = f"{p}.attention_blocks.{a}"
        for proj in ("to_q", "to_k", "to_v"):
            m[f"{ab}.{proj}.weight"] = (c, c)
        _linear(m, f"{ab}.to_out.0", c, c)
        if include_pe:
            m[f"{ab}.pos_encoder.pe"] = (1, pe_max_len, c)
        _norm(m, f"{p}.norms.{a}", c)
    _linear(m, f"{p}.ff.net.0.proj", 8 * c, c)
    _linear(m, f"{p}.ff.net.2", c, 4 * c)
    _norm(m, f"{p}.ff_norm", c)


def _mm_sites() -> List[Tuple[str, int]]:
    """(key prefix, channels) of every motion/epi module site: down x2,
    up x3, no mid (configs/inference_config.yaml: *_mid_block false)."""
    sites = []
    for i in range(4):
        for j in range(2):
            sites.append((f"down_blocks.{i}", j, CH[i]))
    for i in range(4):
        for j in range(3):
            sites.append((f"up_blocks.{i}", j, RCH[i]))
    return sites


def animatediff_v3_mm_manifest() -> Manifest:
    """AnimateDiff v3 motion-module .ckpt keys (VanillaTemporalModule at
    every down/up layer; 2x Temporal_Self, PE max_len 32)."""
    m: Manifest = {}
    for blk, j, c in _mm_sites():
        p = f"{blk}.motion_modules.{j}.temporal_transformer"
        _norm(m, f"{p}.norm", c)
        _linear(m, f"{p}.proj_in", c, c)
        _temporal_block(m, f"{p}.transformer_blocks.0", c)
        _linear(m, f"{p}.proj_out", c, c)
    return m


def cvd_epi_ckpt_manifest() -> Manifest:
    """CVD epi .ckpt ``unet_trainable_dict`` keys: every parameter matching
    epi_modules (train_epi_control.py:251-259; params only, no buffers)."""
    m: Manifest = {}
    for blk, j, c in _mm_sites():
        p = f"{blk}.epi_modules.{j}.epi_transformer"
        _norm(m, f"{p}.norm", c)
        _linear(m, f"{p}.proj_in", c, c)
        _temporal_block(m, f"{p}.transformer_blocks.0", c, include_pe=False)
        _linear(m, f"{p}.proj_out", c, c)
    return m


def cvd_sync_lora_manifest(sync_lora_rank: int = 4,
                           image_lora_rank: int = 4) -> Manifest:
    """Sync-LoRA keys a sync-enabled CVD fine-tune adds to the epi .ckpt's
    ``unet_trainable_dict`` ("sync" matches the trainable-substring filter,
    train_epi_control.py:254): to_{q,k,v,out}_lora_sync.{down,up} on the
    pose-conditioned temporal attention '0' of every motion module
    (attention_processor.py:262-270). Effective per-layer rank follows the
    reference rule (unet.py:1092): absolute when >16, else
    channels // image_lora_rank (the IMAGE-LoRA rank — reference quirk)."""
    m: Manifest = {}
    for blk, j, c in _mm_sites():
        r = sync_lora_rank if sync_lora_rank > 16 else c // image_lora_rank
        p = (f"{blk}.motion_modules.{j}.temporal_transformer."
             f"transformer_blocks.0.attention_blocks.0.processor")
        for proj in ("to_q", "to_k", "to_v", "to_out"):
            m[f"{p}.{proj}_lora_sync.down.weight"] = (r, c)
            m[f"{p}.{proj}_lora_sync.up.weight"] = (c, r)
    return m


def _spatial_sites() -> List[Tuple[str, int]]:
    """(key prefix, channels) of every spatial transformer of the SD1.5 UNet."""
    sites = [(f"down_blocks.{i}.attentions.{j}", CH[i]) for i in range(3) for j in range(2)]
    sites.append(("mid_block.attentions.0", CH[-1]))
    sites += [(f"up_blocks.{i}.attentions.{j}", RCH[i]) for i in range(1, 4) for j in range(3)]
    return sites


def cameractrl_image_lora_manifest(image_lora_rank: int = 2) -> Manifest:
    """The runtime image LoRA of CameraCtrl (loaded at inference_epi.py:91-98,
    optionally under ``lora_state_dict``): to_{q,k,v,out}_lora.{down,up} on
    the processor of attn1 and attn2 of every spatial transformer. Per-layer
    rank by the reference rule (unet.py:1028): ``image_lora_rank`` when > 16,
    else channels // image_lora_rank."""
    m: Manifest = {}
    for p, c in _spatial_sites():
        r = image_lora_rank if image_lora_rank > 16 else c // image_lora_rank
        for a, kdim in (("attn1", c), ("attn2", CROSS)):
            proc = f"{p}.transformer_blocks.0.{a}.processor"
            for proj, in_f in (("to_q", c), ("to_k", kdim), ("to_v", kdim), ("to_out", c)):
                m[f"{proc}.{proj}_lora.down.weight"] = (r, in_f)
                m[f"{proc}.{proj}_lora.up.weight"] = (c, r)
    return m


def animatediff_sparsectrl_manifest(simplified: bool = False,
                                    conditioning_channels: int = None) -> Manifest:
    """AnimateDiff SparseCtrl ckpt keys (models/sparse_controlnet.py:85-313):
    SD encoder copy + per-layer motion modules (ONE Temporal_Self attention,
    :127-134) + conditioning embedding (pyramid, or a single zero conv when
    ``simplified`` — the v3 RGB ckpt layout, :181-184) + zero convs. The
    conditioning input gains a mask channel (concate_conditioning_mask,
    :176-178)."""
    m: Manifest = {}
    _conv(m, "conv_in", CH[0], 4, 3)
    _linear(m, "time_embedding.linear_1", TEMB, CH[0])
    _linear(m, "time_embedding.linear_2", TEMB, TEMB)
    if conditioning_channels is None:
        # simplified (RGB) conditions on VAE latents (4ch), pyramid on RGB
        conditioning_channels = (4 if simplified else 3) + 1  # + mask
    if simplified:
        _conv(m, "controlnet_cond_embedding", CH[0], conditioning_channels, 3)
    else:
        cond_ch = (16, 32, 96, 256)
        _conv(m, "controlnet_cond_embedding.conv_in", cond_ch[0],
              conditioning_channels, 3)
        for i in range(3):
            _conv(m, f"controlnet_cond_embedding.blocks.{2 * i}",
                  cond_ch[i], cond_ch[i], 3)
            _conv(m, f"controlnet_cond_embedding.blocks.{2 * i + 1}",
                  cond_ch[i + 1], cond_ch[i], 3)
        _conv(m, "controlnet_cond_embedding.conv_out", CH[0], cond_ch[-1], 3)
    for i in range(4):
        for j in range(2):
            cin = (CH[i - 1] if i > 0 else CH[0]) if j == 0 else CH[i]
            _resnet(m, f"down_blocks.{i}.resnets.{j}", cin, CH[i])
            if i < 3:
                _spatial_transformer(m, f"down_blocks.{i}.attentions.{j}", CH[i])
            p = f"down_blocks.{i}.motion_modules.{j}.temporal_transformer"
            _norm(m, f"{p}.norm", CH[i])
            _linear(m, f"{p}.proj_in", CH[i], CH[i])
            _temporal_block(m, f"{p}.transformer_blocks.0", CH[i], n_attn=1)
            _linear(m, f"{p}.proj_out", CH[i], CH[i])
        if i < 3:
            _conv(m, f"down_blocks.{i}.downsamplers.0.conv", CH[i], CH[i], 3)
    _resnet(m, "mid_block.resnets.0", CH[-1], CH[-1])
    _spatial_transformer(m, "mid_block.attentions.0", CH[-1])
    _resnet(m, "mid_block.resnets.1", CH[-1], CH[-1])
    res_ch: List[int] = [CH[0]]
    for i in range(4):
        res_ch += [CH[i]] * 2
        if i < 3:
            res_ch.append(CH[i])
    for idx, c in enumerate(res_ch):
        _conv(m, f"controlnet_down_blocks.{idx}", c, c, 1)
    _conv(m, "controlnet_mid_block", CH[-1], CH[-1], 1)
    return m


def cameractrl_pose_encoder_manifest() -> Manifest:
    """CameraCtrl ``pose_encoder_state_dict`` keys (CameraPoseEncoder with
    the released config: downscale 8, channels CH, nums_rb 2, cin 384,
    ksize 1, temporal PE max_len 16)."""
    m: Manifest = {}
    _conv(m, "encoder_conv_in", CH[0], 384, 3)
    for i in range(4):
        for j in range(2):
            cin = CH[i - 1] if (j == 0 and i != 0) else (
                CH[0] if (j == 0 and i == 0) else CH[i])
            cout = CH[i]
            p = f"encoder_down_conv_blocks.{i}.{j}"
            if cin != cout:
                _conv(m, f"{p}.in_conv", cout, cin, 1)
            _conv(m, f"{p}.block1", cout, cout, 3)
            m[f"{p}.block2.weight"] = (cout, cout, 1, 1)
            m[f"{p}.block2.bias"] = (cout,)
            _temporal_block(
                m, f"encoder_down_attention_blocks.{i}.{j}", cout,
                n_attn=1, pe_max_len=16,
            )
    return m


def cameractrl_attention_processor_manifest() -> Manifest:
    """CameraCtrl ``attention_processor_state_dict``: a zero-init qkv_merge
    on the temporal attention named '0' of every motion module
    (unet.py:1067-1102; decoder included by default)."""
    m: Manifest = {}
    for blk, j, c in _mm_sites():
        p = (f"{blk}.motion_modules.{j}.temporal_transformer."
             f"transformer_blocks.0.attention_blocks.0.processor.qkv_merge")
        _linear(m, p, c, c)
    return m


# ------------------------------------------------------------- LDM layout

def _ldm_resnet(m: Manifest, p: str, cin: int, cout: int, temb: int = TEMB):
    _norm(m, f"{p}.in_layers.0", cin)
    _conv(m, f"{p}.in_layers.2", cout, cin, 3)
    _linear(m, f"{p}.emb_layers.1", cout, temb)
    _norm(m, f"{p}.out_layers.0", cout)
    _conv(m, f"{p}.out_layers.3", cout, cout, 3)
    if cin != cout:
        _conv(m, f"{p}.skip_connection", cout, cin, 1)


def ldm_sd15_unet_manifest() -> Manifest:
    """CompVis 'model.diffusion_model.*' keys for the same SD1.5 UNet."""
    m: Manifest = {}
    _linear(m, "time_embed.0", TEMB, CH[0])
    _linear(m, "time_embed.2", TEMB, TEMB)
    _conv(m, "input_blocks.0.0", CH[0], 4, 3)
    for i in range(1, 12):
        block, j = (i - 1) // 3, (i - 1) % 3
        if j == 2:
            _conv(m, f"input_blocks.{i}.0.op", CH[block], CH[block], 3)
            continue
        cin = (CH[block - 1] if block > 0 else CH[0]) if j == 0 else CH[block]
        _ldm_resnet(m, f"input_blocks.{i}.0", cin, CH[block])
        if block < 3:
            _spatial_transformer(m, f"input_blocks.{i}.1", CH[block])
    _ldm_resnet(m, "middle_block.0", CH[-1], CH[-1])
    _spatial_transformer(m, "middle_block.1", CH[-1])
    _ldm_resnet(m, "middle_block.2", CH[-1], CH[-1])
    for i in range(12):
        block, j = i // 3, i % 3
        cin, cout = _up_resnet_channels(block)[j]
        _ldm_resnet(m, f"output_blocks.{i}.0", cin, cout)
        if block > 0:
            _spatial_transformer(m, f"output_blocks.{i}.1", cout)
        if j == 2 and block < 3:
            sub = 1 if block == 0 else 2  # upsample index after optional attn
            _conv(m, f"output_blocks.{i}.{sub}.conv", cout, cout, 3)
    _norm(m, "out.0", CH[0])
    _conv(m, "out.2", 4, CH[0], 3)
    return {f"model.diffusion_model.{k}": v for k, v in m.items()}


def _ldm_vae_resnet(m: Manifest, p: str, cin: int, cout: int):
    _norm(m, f"{p}.norm1", cin)
    _conv(m, f"{p}.conv1", cout, cin, 3)
    _norm(m, f"{p}.norm2", cout)
    _conv(m, f"{p}.conv2", cout, cout, 3)
    if cin != cout:
        _conv(m, f"{p}.nin_shortcut", cout, cin, 1)


def ldm_sd15_vae_manifest() -> Manifest:
    """CompVis 'first_stage_model.*' keys. The mid attention q/k/v/proj_out
    are 1x1 CONVS in this layout (the importer squeezes them to linear)."""
    m: Manifest = {}
    _conv(m, "encoder.conv_in", VAE_CH[0], 3, 3)
    for i in range(4):
        for j in range(2):
            cin = (VAE_CH[i - 1] if i > 0 else VAE_CH[0]) if j == 0 else VAE_CH[i]
            _ldm_vae_resnet(m, f"encoder.down.{i}.block.{j}", cin, VAE_CH[i])
        if i < 3:
            _conv(m, f"encoder.down.{i}.downsample.conv", VAE_CH[i], VAE_CH[i], 3)
    for enc in ("encoder", "decoder"):
        _ldm_vae_resnet(m, f"{enc}.mid.block_1", 512, 512)
        for a in ("q", "k", "v", "proj_out"):
            _conv(m, f"{enc}.mid.attn_1.{a}", 512, 512, 1)
        _norm(m, f"{enc}.mid.attn_1.norm", 512)
        _ldm_vae_resnet(m, f"{enc}.mid.block_2", 512, 512)
    _norm(m, "encoder.norm_out", 512)
    _conv(m, "encoder.conv_out", 8, 512, 3)
    _conv(m, "decoder.conv_in", 512, 4, 3)
    # LDM decoder.up is indexed coarse-to-fine REVERSED vs diffusers
    for ldm_i in range(4):
        diff_i = 3 - ldm_i
        cout = VAE_RCH[diff_i]
        for j in range(3):
            cin = (VAE_RCH[diff_i - 1] if diff_i > 0 else 512) if j == 0 else cout
            _ldm_vae_resnet(m, f"decoder.up.{ldm_i}.block.{j}", cin, cout)
        if diff_i < 3:
            _conv(m, f"decoder.up.{ldm_i}.upsample.conv", cout, cout, 3)
    _norm(m, "decoder.norm_out", VAE_RCH[-1])
    _conv(m, "decoder.conv_out", 3, VAE_RCH[-1], 3)
    m["quant_conv.weight"] = (8, 8, 1, 1)
    m["quant_conv.bias"] = (8,)
    m["post_quant_conv.weight"] = (4, 4, 1, 1)
    m["post_quant_conv.bias"] = (4,)
    return {f"first_stage_model.{k}": v for k, v in m.items()}


def ldm_sd15_clip_manifest() -> Manifest:
    return {
        f"cond_stage_model.transformer.{k}": v
        for k, v in sd15_clip_manifest().items()
    }


def zeros_state(manifest: Manifest) -> Dict[str, np.ndarray]:
    """Materialize a manifest as broadcast-zero arrays (no real memory)."""
    z = np.zeros((1,), np.float32)
    return {k: np.broadcast_to(z, shape) for k, shape in manifest.items()}


@torch.no_grad()
def random_state(manifest: Manifest, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Materialize a manifest as seeded tensors in ``dtype`` on the host,
    drawn on the generator's device: a stand-in for the released file with
    its exact keys and shapes. Weights of two or more axes are uniform with
    variance 1 / fan_in (fan_in = every axis but the first), so activations
    stay O(1) through a deep forward; 1-D ``.weight`` entries (norm scales)
    lie within 0.1 of 1 and biases within 0.1 of 0. The buffers the released
    files carry are written as well: ``pos_encoder.pe`` [1, L, C] (the
    motion module's sinusoid) and ``position_ids`` (arange, int64)."""
    device = generator.device
    out: Dict[str, torch.Tensor] = {}
    for key, shape in manifest.items():
        if key.endswith("position_ids"):
            out[key] = torch.arange(shape[-1]).reshape(shape)
            continue
        if key.endswith("pos_encoder.pe"):
            _, length, c = shape
            position = torch.arange(length, dtype=torch.float32)[:, None]
            div = torch.exp(torch.arange(0, c, 2, dtype=torch.float32) * (-math.log(10000.0) / c))
            pe = torch.zeros(shape, dtype=torch.float32)
            pe[0, :, 0::2] = torch.sin(position * div)
            pe[0, :, 1::2] = torch.cos(position * div)
            out[key] = pe.to(dtype)
            continue
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32) * 2 - 1
        if len(shape) >= 2:
            u *= math.sqrt(3.0 / math.prod(shape[1:]))
        elif key.endswith(".weight"):
            u = 1.0 + 0.1 * u
        else:
            u *= 0.1
        out[key] = u.to(dtype).cpu()
    return out
