"""Shared pipeline machinery: the module bundle, text encoding, VAE encode
and decode (port of ``cvd_tpu/pipelines/common.py``). A bundle with a
second text encoder (``clip_2``: SDXL's OpenCLIP bigG) conditions as SDXL's
pipeline does: both encoders' penultimate states joined along the width,
and the second's pooled embedding. The latents' scale is the VAE's
``scaling_factor`` (SD's 0.18215, SDXL's 0.13025)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn

from cvd_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from cvd_tpu_torch.models.layers import FusedGroupNorm
from cvd_tpu_torch.models.pose_encoder import CameraPoseEncoder
from cvd_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from cvd_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cvd_tpu_torch.schedulers import DDIMScheduler
from cvd_tpu_torch.utils import tracing


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter with fan-in-scaled uniforms from ``generator``,
    on the parameters' own device (the JAX package's fast init: scale
    sqrt(3 / fan_in), so activations stay O(1) at depth). For weights-free
    runs: timing and memory do not depend on the values."""
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.Linear, nn.Conv2d)) and name == "weight":
                fan = p.shape[1]
            elif p.ndim >= 2:
                fan = p.shape[-2]
            else:
                fan = p.shape[-1]
            scale = math.sqrt(3.0 / max(fan, 1))
            u = torch.rand(p.shape, generator=generator, device=generator.device,
                           dtype=torch.float32)
            p.copy_((u * (2 * scale) - scale).to(p.device, p.dtype))
    return module


@torch.no_grad()
def default_init_(module: nn.Module, generator: torch.Generator,
                  zero: Sequence[str] = ()) -> nn.Module:
    """The initialization a fresh model starts from, drawn from ``generator``:
    Linear and Conv2d weights uniform in +-1/sqrt(fan_in) (what torch's
    ``reset_parameters`` gives them), embeddings unit normal, every bias 0,
    every norm scale 1, and the parameters named in ``zero`` 0: which tensors
    start at zero, at one or free is what the JAX package's Flax init has
    (``UNet3DConditionModel.zero_initialized``); the free draws are not Flax's,
    except that a Linear with an ``init_std`` (the sync-LoRA's ``down``) draws
    N(0, init_std), as the JAX package's does."""
    zero = set(zero)
    for prefix, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            if f"{prefix}.{name}" in zero or name == "bias":
                p.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, FusedGroupNorm)):
                p.fill_(1.0)
            elif getattr(mod, "init_std", None) is not None:
                p.copy_((torch.randn(p.shape, generator=generator, device=generator.device,
                                     dtype=torch.float32) * mod.init_std).to(p.device, p.dtype))
            elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                bound = 1.0 / math.sqrt(p[0].numel())  # fan_in = in_features * kernel area
                u = torch.rand(p.shape, generator=generator, device=generator.device,
                               dtype=torch.float32)
                p.copy_((u * (2 * bound) - bound).to(p.device, p.dtype))
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=generator.device,
                                    dtype=torch.float32).to(p.device, p.dtype))
    return module


@dataclasses.dataclass
class PipelineModules:
    """The model bundle of one assembled pipeline."""

    unet: UNet3DConditionModel
    vae: AutoencoderKL
    clip: CLIPTextEncoder
    pose_encoder: CameraPoseEncoder
    scheduler: DDIMScheduler
    # an optional SparseCtrl model (``models/sparse_controlnet.py``), set by
    # ``cli/build.py --controlnet_ckpt``; its residuals go into the UNet's
    # down / mid additional-residual inputs. No pipeline consumes it, as in
    # the JAX package (common.py:38-41)
    controlnet: Optional[nn.Module] = None
    # SDXL's second text encoder (``encode_prompt``); None: CLIP alone
    clip_2: Optional[CLIPTextEncoder] = None

    @classmethod
    def create(
        cls,
        unet_config: Optional[UNetConfig] = None,
        vae_config: Optional[VAEConfig] = None,
        clip_config: Optional[CLIPTextConfig] = None,
        device="cpu",
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        vae_encoder: bool = False,
        random_full: bool = False,
        pose_encoder_kwargs: Optional[dict] = None,
        scheduler: Optional[DDIMScheduler] = None,
        unet_dtype: Optional[torch.dtype] = None,
        clip_2_config: Optional[CLIPTextConfig] = None,
    ) -> "PipelineModules":
        """Build the bundle on ``device``. With ``generator`` the weights are
        initialized from it, on the generator's device: ``default_init_``
        (an untrained epi module is the identity), or with ``random_full``
        the fan-in uniforms of ``random_init_`` over EVERY parameter (runs
        without weights that must exercise every layer). Without a
        generator the parameters are UNINITIALIZED memory, for a
        ``load_state_dict`` that covers every one of them; a build from
        checkpoint files, which may cover a part, starts from
        ``default_init_``. Modules
        are built on the meta device and materialized in place, so a
        full-size bundle never exists on the host. ``vae_encoder`` adds the
        VAE's encoder (training); ``pose_encoder_kwargs`` and ``scheduler``
        are a model config's (``io/model_config.py``); ``unet_dtype`` is the
        UNet's where it differs from ``dtype`` (training holds it in f32
        until ``create_train_state`` casts its frozen part); ``clip_2_config``
        adds the second text encoder (SDXL)."""
        if random_full and generator is None:
            raise ValueError("random_full needs a generator")
        unet_config = unet_config or UNetConfig()
        with torch.device("meta"):
            mods = [
                UNet3DConditionModel(unet_config),
                AutoencoderKL(vae_config or VAEConfig(), with_encoder=vae_encoder),
                CLIPTextEncoder(clip_config or CLIPTextConfig()),
                CameraPoseEncoder(channels=unet_config.block_out_channels,
                                  **(pose_encoder_kwargs or {})),
            ]
            if clip_2_config is not None:
                mods.append(CLIPTextEncoder(clip_2_config))
        out = []
        for m in mods:
            m = m.to_empty(device=device)
            is_unet = isinstance(m, UNet3DConditionModel)
            if random_full:
                random_init_(m, generator)
            elif generator is not None:
                zero = m.zero_initialized() if is_unet else ()
                default_init_(m, generator, zero)
            m = m.to(dtype=(unet_dtype or dtype) if is_unet else dtype)
            m = m.eval().requires_grad_(False)
            if torch.device(device).type == "cuda":
                m = m.to(memory_format=torch.channels_last)
            out.append(m)
        return cls(*out[:4], scheduler or DDIMScheduler(),
                   clip_2=out[4] if len(out) > 4 else None)


def encode_prompt(modules: PipelineModules, prompt_ids: torch.Tensor,
                  negative_ids: torch.Tensor) -> tuple:
    """-> (uncond, cond) embeddings, each [B, 77, hidden], and (uncond,
    cond) pooled embeddings, None without ``clip_2``. With ``clip_2`` the
    embeddings are both encoders' penultimate states joined along the width
    (SDXL), the pooled ones the second's; both encoders take the same ids."""
    if modules.clip_2 is None:
        return modules.clip(negative_ids), modules.clip(prompt_ids), None, None
    states, pools = [], []
    for ids in (negative_ids, prompt_ids):
        first, _ = modules.clip.encode(ids)
        with tracing.span("sample.text_encoder_2"):
            second, pool = modules.clip_2.encode(ids)
        states.append(torch.cat([first, second.to(first.dtype)], dim=-1))
        pools.append(pool)
    return (*states, *pools)


def decode_latents(modules: PipelineModules, latents: torch.Tensor,
                   mesh=None) -> Optional[torch.Tensor]:
    """[B, F, h, w, 4] latents -> [B, F, H, W, 3] images in [0, 1] (f32),
    the whole video in one decode. On a ``mesh`` (every rank holding the
    same latents) rank 0 alone decodes; the others return None."""
    if mesh is not None and mesh.rank != 0:
        return None
    B, Fr, h, w, c = latents.shape
    dtype = modules.vae.post_quant_conv.weight.dtype
    with tracing.device_span("sample.decode", latents.device):
        z = (latents.reshape(B * Fr, h, w, c) / modules.vae.config.scaling_factor).to(dtype)
        imgs = modules.vae.decode(z).float()
        imgs = torch.clamp(imgs / 2 + 0.5, 0.0, 1.0)
    return imgs.reshape(B, Fr, *imgs.shape[1:])


def encode_images(modules: PipelineModules, images: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  frame_chunk: int = 8) -> torch.Tensor:
    """[N, H, W, 3] in [-1, 1] -> sampled, scaled latents [N, H/8, W/8, 4]
    (f32). Frames encode ``frame_chunk`` at a time, which bounds the
    encoder's activation memory (common.py:363-390)."""
    dtype = modules.vae.quant_conv.weight.dtype
    z = [modules.vae.sample_posterior(images[i:i + frame_chunk].to(dtype), generator).float()
         for i in range(0, images.shape[0], frame_chunk)]
    return torch.cat(z) * modules.vae.config.scaling_factor
