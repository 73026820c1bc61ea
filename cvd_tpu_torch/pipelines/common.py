"""Shared pipeline machinery: the module bundle, text encoding, VAE encode
and decode (port of ``cvd_tpu/pipelines/common.py``), and the request path
of both samplers (``Sampler``). A bundle with a
second text encoder (``clip_2``: SDXL's OpenCLIP bigG) conditions as SDXL's
pipeline does: both encoders' penultimate states joined along the width,
and the second's pooled embedding. The latents' scale is the VAE's
``scaling_factor`` (SD's 0.18215, SDXL's 0.13025)."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from cvd_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from cvd_tpu_torch.models.layers import FusedGroupNorm
from cvd_tpu_torch.models.pose_encoder import CameraPoseEncoder
from cvd_tpu_torch.models.unet import UNet3DConditionModel, UNetConfig
from cvd_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cvd_tpu_torch.pipelines.pab import PABCache
from cvd_tpu_torch.pipelines.program import Chunk, SamplingProgram
from cvd_tpu_torch.schedulers import DDIMScheduler
from cvd_tpu_torch.utils import tracing
from cvd_tpu_torch.utils.tracing import IntervalTimer, SpanTimer


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
        are a model config's (``io/model_config.py``; the pose encoder's
        ``channels`` are the UNet's widths unless they give them); ``unet_dtype`` is the
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
                CameraPoseEncoder(**{"channels": unet_config.block_out_channels,
                                     **(pose_encoder_kwargs or {})}),
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


def interleave_cfg(x: torch.Tensor) -> torch.Tensor:
    """[V, ...] -> [2V, ...], each row twice in place (uncond, cond)."""
    return x.repeat_interleave(2, dim=0)


class Sampler:
    """What the 2-view and N-view samplers share: the sampling program, one
    request's path (``_request``) and the preparation of the rows they both
    have (``_prepare_rows``). A sampler brings its argument checks, its
    rows' geometry, its plan of chunks, its settings and its
    ``_timestep_body(bufs, ts, start, repeats, generator, timer, settings,
    pab)``."""

    def __init__(self, modules: PipelineModules, F_mat_size: int = 256,
                 rand_slope_ff: bool = True, mesh=None, capture: bool = True):
        """``mesh``: a ("rows", "frames") ``parallel.Mesh`` to shard each UNet
        call over; only rank 0 decodes, the other ranks return None.
        ``capture``: on a CUDA device, replay the timesteps as CUDA graphs
        (without PAB and without a mesh); False runs them eagerly."""
        self.m = modules
        self.F_mat_size = F_mat_size
        self.rand_slope_ff = rand_slope_ff
        self.mesh = mesh
        self.program = SamplingProgram(modules.unet.conv_in.weight.device, capture,
                                       watch=(modules.unet,))
        # wall time of each UNet call of the last run, in ms (CUDA events on
        # the card, the host clock on the CPU; a replay's time over its calls)
        self.unet_step_ms: List[float] = []
        # the last UNet call's sublayers by kind, where the timestep body
        # passes this timer to the UNet (the 2-view sampler's does)
        self.sublayers = IntervalTimer(self.program.device)

    def draw_noise(self, generator: Optional[torch.Generator], shape) -> torch.Tensor:
        """Unit normals of ``shape`` from ``generator``, on its device: the
        initial latents, and the N-view sampler's re-noise. Apart so that a
        test can replay another program's noise."""
        return torch.randn(shape, generator=generator,
                           device=generator.device if generator is not None
                           else self.program.device)

    def _request(self, name: str, settings, plan: Sequence[Chunk], prepare: Callable,
                 generator: Optional[torch.Generator], pab_config, decode: bool):
        """One request: ``prepare(scheduler state)`` -> the tensors the
        timestep body reads, then ``plan``'s chunks through the body, as
        the replayed graphs of key (``name``, ``settings``) or eagerly; then
        the decode (rank 0 alone on a mesh) or the final latents. One unit."""
        m, program = self.m, self.program
        eager = program.eager_for(pab_config, self.mesh)
        state = m.scheduler.set_timesteps(settings.steps)
        with tracing.device_span("sample.prepare", program.device):
            inputs = prepare(state)
        pab = None if pab_config is None else PABCache(pab_config, len(state.timesteps))

        def body(bufs, ts, start, repeats, gen, timer):
            return self._timestep_body(bufs, ts, start, repeats, gen, timer, settings, pab)

        timer = SpanTimer(program.device)
        with tracing.span("sample.denoise"):
            timesteps = torch.from_numpy(state.timesteps).to(program.device)
            latents = program.run((name, settings), inputs, timesteps, plan, body, generator,
                                  timer, eager=eager)
        self.unet_step_ms = timer.elapsed_ms()
        out = decode_latents(m, latents, self.mesh) if decode else latents
        self.sublayers.record()
        tracing.next_unit()
        return out

    def _prepare_rows(self, prompt_ids, negative_ids, plucker, state, generator, latents,
                      groups: int = 1) -> dict:
        """What both samplers prepare, over the CFG rows [v0-uncond, v0-cond,
        v1-uncond, ...] of the V views, ``groups`` times: the text, SDXL's
        added conditioning where the UNet takes it, the pose features (the
        pose encoder in its own dtype: a training bundle's, in validation,
        differs from the UNet's bf16 frozen weights), the scheduler's table
        and the initial latents [V, F, H/8, W/8, 4] (``latents``, else
        ``draw_noise``'s) times ``init_noise_sigma``."""
        m = self.m
        device, dtype = self.program.device, m.unet.conv_in.weight.dtype
        V, Fr, H, W, _ = plucker.shape
        pairs = V * groups             # (uncond, cond) pairs of rows
        with tracing.span("sample.text_encoder"):
            uncond, cond, uncond_pool, cond_pool = encode_prompt(
                m, prompt_ids.to(device), negative_ids.to(device))
        inputs = {"text": torch.cat([uncond, cond]).repeat(pairs, 1, 1).to(dtype)}
        if m.unet.config.addition_embed_type:
            inputs["add_text"] = torch.cat([uncond_pool, cond_pool]).repeat(pairs, 1).to(dtype)
            # (original H, W, crop top, left, target H, W), as SDXL's pipeline
            inputs["add_time"] = torch.tensor([[H, W, 0, 0, H, W]] * (2 * pairs),
                                              dtype=torch.float32, device=device)
        pose_dtype = m.pose_encoder.encoder_conv_in.weight.dtype
        with tracing.span("sample.pose_encoder"):
            feats = m.pose_encoder(plucker.to(device=device, dtype=pose_dtype))
        for i, p in enumerate(feats):
            inputs[f"pose{i}"] = interleave_cfg(p.to(dtype)).repeat(groups, 1, 1, 1, 1)
        inputs["acp"] = state.alphas_cumprod.to(device)
        if latents is None:
            latents = self.draw_noise(generator, (V, Fr, H // 8, W // 8, 4))
        inputs["latents"] = (latents.to(device=device, dtype=torch.float32)
                             * m.scheduler.init_noise_sigma)
        return inputs
