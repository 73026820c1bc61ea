"""UNet3DConditionModel — SD1.5 UNet inflated to video, with AnimateDiff
motion modules and CVD epi (cross-video sync) modules (port of
``cvd_tpu/models/unet.py``). Per UNet layer the op order is

    resnet (per frame) -> spatial transformer (per frame, text cross-attn)
    -> motion module (temporal attn, pose-conditioned) -> epi module

Layout is channels-last video [B, F, H, W, C]; per-frame 2D ops fold frames
into the batch. Module names reproduce the reference state-dict keys
(``down_blocks.{i}.resnets.{j}...``). ``remat=True`` recomputes activations
in the backward (``torch.utils.checkpoint``) per ``remat_unit`` (each UNet
block, or each sublayer: resnet, spatial transformer, motion module, epi
module) under ``remat_policy`` (what a unit saves: nothing, or the outputs
of the matrix products and convolutions, as the JAX package's
``jax.checkpoint_policies``). The runtime image LoRA
(``spatial_lora_rank``, scaled per call by ``lora_scale``), the sync-LoRA
and spatial extended attention are the JAX package's options of the same
names; ``pab`` is a request's Pyramid Attention Broadcast cache
(``pipelines/pab.py``). Not ported: the layer scan
(``scan_identical_layers``, an XLA compile lever).

The SD1.5 widths are the defaults. SDXL's UNet (arXiv:2307.01952, the base
model's ``unet/config.json``) sets ``transformer_layers_per_block`` (the
spatial transformer's depth at each level, 0 for none: its first level has
no attention), ``mid_transformer_layers``, ``spatial_heads`` (its
``attention_head_dim``, which diffusers reads as the head count: heads 64
wide, while the motion and epi modules keep ``attention_heads``),
``use_linear_projection`` and the ``text_time`` added embedding: the pooled
text and the six time ids (``added_cond``) through ``add_embedding`` into
the time embedding. A UNet of n levels takes n pose features.

``fuse_first_frame`` adds the first-frame fusion blocks (``down_fusers.0``
after ``conv_in``, ``mid_fuser`` after the mid block); a SparseCtrl model's
residuals come in as ``down_block_additional_residuals`` /
``mid_block_additional_residual``; ``additional_channel > 0`` adds the
auxiliary q/k head (``conv_auxiliary_{query,key}``, 1x1 convolutions over
the last epi attention's query and gathered key maps), which training's
epipolar loss reads through ``return_extras=True``.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from cvd_tpu_torch.models.epi import EpiConditioning, EpiModule
from cvd_tpu_torch.models.layers import (
    Conv2d, Downsample2D, FusedGroupNorm, FusionBlock2D, ResnetBlock2D, TimestepEmbedding,
    Transformer2DModel, Upsample2D, sinusoidal_time_embedding,
)
from cvd_tpu_torch.models.motion import MotionModule
from cvd_tpu_torch.parallel.mesh import Mesh, all_gather


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    use_motion_module: bool = True
    motion_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    motion_module_mid_block: bool = False
    motion_num_transformer_blocks: int = 1
    motion_num_attention_blocks: int = 2
    motion_pe_max_len: int = 32
    # the motion/epi GroupNorm group count comes from the module kwargs
    # (default 32), NOT from norm_num_groups (docs/PARITY.md:105-108)
    motion_norm_groups: int = 32
    epi_norm_groups: int = 32
    # which output projections a fresh model starts at zero (an untrained
    # module is then the identity): ``zero_initialized`` below
    motion_zero_initialize: bool = False
    epi_zero_initialize: bool = True
    pose_cond_attn_indices: Tuple[int, ...] = (0,)
    pose_scale: float = 1.0
    use_epi_module: bool = True
    epi_module_resolutions: Tuple[int, ...] = (1, 2, 4, 8)
    epi_module_mid_block: bool = False
    epi_num_transformer_blocks: int = 1
    epi_num_attention_blocks: int = 2
    # the self-attention's keys and values see both videos of the pair
    # (attention_processor.py:69-83)
    spatial_extended_attention: bool = False
    # the runtime image LoRA on every spatial attention: > 0 a fixed rank,
    # < 0 a rank of channels // |value| per layer (unet.py:1028), 0 none
    spatial_lora_rank: int = 0
    # sync-LoRA on the pose-conditioned temporal attentions; rank 0 or scale
    # 0 is off. A rank > 16 is absolute, 1..16 resolves per layer to
    # channels // (|spatial_lora_rank| or 4): the reference divides by the
    # IMAGE-LoRA rank (unet.py:1092), 4 being its training default
    sync_lora_rank: int = 0
    sync_lora_scale: float = 1.0
    # first-frame feature fusion (reference unet.py:107,141-153; no released
    # config sets it)
    fuse_first_frame: bool = False
    # output channels of the auxiliary q/k head for the epipolar training
    # loss (reference unet.py:1429-1443); 0: no head
    additional_channel: int = 0
    # what ``remat=True`` checkpoints: whole UNet blocks, or each sublayer
    remat_unit: str = "block"
    # what a checkpointed unit keeps for the backward (REMAT_POLICIES)
    remat_policy: str = ""
    # the spatial transformer's depth per level, 0 for none; () is SD1.5's
    # one block at every level but the last
    transformer_layers_per_block: Tuple[int, ...] = ()
    mid_transformer_layers: int = 1
    # the spatial attentions' heads per level; (): ``attention_heads``
    spatial_heads: Tuple[int, ...] = ()
    # Linear proj_in / proj_out in the spatial transformers (SDXL)
    use_linear_projection: bool = False
    # "text_time" (SDXL): add_embedding(cat(pooled text, the sinusoids of
    # the six time ids)) is added to the time embedding; "": none
    addition_embed_type: str = ""
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    def depth(self, level: int) -> int:
        """The spatial transformer's depth at ``level`` (0: none)."""
        if self.transformer_layers_per_block:
            return self.transformer_layers_per_block[level]
        return int(level != len(self.block_out_channels) - 1)

    def heads(self, level: int) -> int:
        """The spatial attentions' heads at ``level``."""
        return self.spatial_heads[level] if self.spatial_heads else self.attention_heads

    def __post_init__(self):
        # a typo would silently change the memory / recompute trade-off
        if self.remat_unit not in REMAT_UNITS:
            raise ValueError(f"remat_unit={self.remat_unit!r}: expected one of {REMAT_UNITS}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy={self.remat_policy!r}: expected one of "
                             f"{REMAT_POLICIES}")
        n = len(self.block_out_channels)
        for name in ("transformer_layers_per_block", "spatial_heads"):
            if getattr(self, name) and len(getattr(self, name)) != n:
                raise ValueError(f"{name}={getattr(self, name)}: one per level ({n})")
        if self.addition_embed_type not in ("", "text_time"):
            raise ValueError(f"addition_embed_type={self.addition_embed_type!r}: expected "
                             "'' or 'text_time'")


REMAT_UNITS = ("block", "layer")
# "" saves nothing (every op of a unit runs again in the backward); "dots"
# saves the outputs of the matrix products and convolutions
# (jax.checkpoint_policies.dots_saveable), "dots_no_batch" those of the 2-D
# products only (dots_with_no_batch_dims_saveable), "dots_small" those of
# "dots" of at most CVD_TPU_REMAT_SAVE_MAX_BYTES bytes (default 96 MiB). The
# hand-written kernels' autograd Functions are no aten product: every policy
# runs them again.
REMAT_POLICIES = ("", "dots", "dots_no_batch", "dots_small")
_aten = torch.ops.aten
_PRODUCTS_2D = (_aten.mm.default, _aten.addmm.default)
_PRODUCTS = _PRODUCTS_2D + (_aten.bmm.default, _aten.baddbmm.default,
                            _aten.convolution.default)


def _product_bytes(op, args) -> int:
    """The bytes of a product's output, from its inputs' shapes."""
    if op == _aten.convolution.default:
        x, w, _, stride, padding, dilation, transposed, output_padding, groups = args[:9]
        spatial = [
            (n - 1) * s - 2 * p + d * (k - 1) + o + 1 if transposed
            else (n + 2 * p - d * (k - 1) - 1) // s + 1
            for n, k, s, p, d, o in zip(x.shape[2:], w.shape[2:], stride, padding, dilation,
                                        output_padding)]
        shape = [x.shape[0], w.shape[1] * groups if transposed else w.shape[0], *spatial]
    else:
        a, b = args[-2:]                          # mm, bmm; addmm, baddbmm add an input first
        shape = [*a.shape[:-1], b.shape[-1]]
    n = 1
    for d in shape:
        n *= d
    return n * args[0].element_size()


def _save_policy(name: str) -> Callable:
    """The selective-checkpoint policy of ``REMAT_POLICIES[name]``."""
    saved = _PRODUCTS_2D if name == "dots_no_batch" else _PRODUCTS
    limit = (int(os.environ.get("CVD_TPU_REMAT_SAVE_MAX_BYTES", 96 * 1024 * 1024))
             if name == "dots_small" else None)

    def policy(ctx, op, *args, **kwargs):
        keep = op in saved and (limit is None or _product_bytes(op, args) <= limit)
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _call(fn, *args, kind=None):
    return fn(*args)


def _remat_unit(policy: str) -> Callable:
    """-> unit(fn, *args): fn(*args), its activations recomputed in the
    backward, keeping what ``policy`` saves."""
    kw = {}
    if policy:
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_policy(policy))

    def unit(fn, *args, kind=None):
        # nothing inside a unit draws (the train step draws its slopes
        # before the UNet), so no RNG state is stashed for the recompute:
        # that stash reads the CUDA generator, which a graph capture refuses
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return unit


def _timed(unit: Callable, timer) -> Callable:
    """``unit`` with each sublayer of a kind between two marks of ``timer``
    (an ``IntervalTimer``, ``utils/tracing.py``), named by the kind."""
    def timed(fn, *args, kind=None):
        if kind is None:
            return unit(fn, *args)
        with timer.span(kind):
            return unit(fn, *args)

    return timed


def _with_qk(epi: nn.Module) -> Callable:
    """The epi module as a function that returns its attentions' q/k maps
    beside its output, so that they come out of a checkpointed unit."""
    def run(x, cond, pab):
        maps: list = []
        return epi(x, cond, pab, maps), maps

    return run


def _lora_rank(cfg: UNetConfig, channels: int) -> int:
    if cfg.spatial_lora_rank > 0:
        return cfg.spatial_lora_rank
    if cfg.spatial_lora_rank < 0:
        return channels // (-cfg.spatial_lora_rank)
    return 0


def _sync_lora_rank(cfg: UNetConfig, channels: int) -> int:
    """The sync-LoRA's rank at a layer of ``channels`` (0: none)."""
    if cfg.sync_lora_rank == 0 or cfg.sync_lora_scale == 0.0:
        return 0
    if cfg.sync_lora_rank > 16:
        return cfg.sync_lora_rank
    return channels // (abs(cfg.spatial_lora_rank) or 4)


def _fold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _unfold(x: torch.Tensor, B: int) -> torch.Tensor:
    return x.reshape((B, -1) + x.shape[1:])


def _motion(cfg: UNetConfig, channels: int) -> MotionModule:
    return MotionModule(channels, cfg.attention_heads, cfg.motion_num_transformer_blocks,
                        cfg.motion_num_attention_blocks, cfg.motion_pe_max_len,
                        cfg.pose_cond_attn_indices, cfg.pose_scale, cfg.motion_norm_groups,
                        sync_lora_rank=_sync_lora_rank(cfg, channels),
                        sync_lora_scale=cfg.sync_lora_scale)


def _epi(cfg: UNetConfig, channels: int) -> EpiModule:
    return EpiModule(channels, cfg.attention_heads, cfg.epi_num_transformer_blocks,
                     cfg.epi_num_attention_blocks, cfg.epi_norm_groups)


class _Block(nn.Module):
    """A down, mid or up block: per layer resnet -> attention? -> motion? ->
    epi?, then an optional down/upsampler."""

    def __init__(self, cfg: UNetConfig, in_channels: Sequence[int], channels: int,
                 temb_dim: int, depth: int, heads: int, use_motion: bool, use_epi: bool):
        """``depth``: the spatial transformers' blocks (0: none), ``heads``
        their heads."""
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(c_in, channels, temb_dim, cfg.norm_num_groups)
            for c_in in in_channels])
        n = len(in_channels)
        self.attentions = nn.ModuleList([
            Transformer2DModel(channels, heads, channels // heads, depth=depth,
                               cross_attention_dim=cfg.cross_attention_dim,
                               groups=cfg.norm_num_groups,
                               extended_attention=cfg.spatial_extended_attention,
                               lora_rank=_lora_rank(cfg, channels),
                               linear_projection=cfg.use_linear_projection)
            for _ in range(n)]) if depth else None
        self.motion_modules = nn.ModuleList(
            [_motion(cfg, channels) for _ in range(n)]) if use_motion else None
        self.epi_modules = nn.ModuleList(
            [_epi(cfg, channels) for _ in range(n)]) if use_epi else None

    def layer(self, j: int, x: torch.Tensor, temb_f: torch.Tensor,
              context_f: Optional[torch.Tensor], pose_feature: Optional[torch.Tensor],
              epi_cond: Optional[EpiConditioning], lora_scale: float = 1.0,
              pab=None, qk: Optional[list] = None, unit: Callable = _call,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
        """``qk``: a list that receives the epi attentions' q/k maps.
        ``unit``: runs each sublayer (``remat_unit="layer"``: checkpointed),
        told the kind of the timed ones. ``mesh``: the ("rows", "frames")
        mesh of which ``x`` is this rank's block."""
        B, Fr = x.shape[:2]
        h = unit(self.resnets[j], _fold(x), temb_f)
        if self.attentions is not None:
            h = unit(self.attentions[j], h, context_f, lora_scale, pab, mesh, Fr,
                     kind="unet.spatial")
        x = _unfold(h, B)
        if self.motion_modules is not None:
            x = unit(self.motion_modules[j], x, pose_feature, pab, mesh, kind="unet.motion")
        if self.epi_modules is not None:
            if qk is None:
                x = unit(self.epi_modules[j], x, epi_cond, pab, kind="unet.epi")
            else:
                x, maps = unit(_with_qk(self.epi_modules[j]), x, epi_cond, pab, kind="unet.epi")
                qk.extend(maps)
        return x

    def last_qk(self, want_qk: bool, j: int) -> Optional[list]:
        """The list for layer ``j``'s q/k maps: the block's last layer's,
        where they are wanted (the auxiliary head reads the last epi
        attention of the UNet)."""
        return [] if want_qk and j == len(self.resnets) - 1 else None


class CrossAttnDownBlock(_Block):
    def __init__(self, cfg, in_channels, channels, temb_dim, depth, heads, use_motion,
                 use_epi, add_downsample):
        super().__init__(cfg, [in_channels] + [channels] * (cfg.layers_per_block - 1),
                         channels, temb_dim, depth, heads, use_motion, use_epi)
        self.downsamplers = (nn.ModuleList([Downsample2D(channels)])
                             if add_downsample else None)

    def forward(self, x, temb_f, context_f, pose_feature, epi_cond, lora_scale=1.0, pab=None,
                want_qk=False, unit=_call, mesh=None):
        """-> (x, the states the up path takes, the last layer's q/k maps
        where ``want_qk``, else None)."""
        res_states, qk = [], None
        for j in range(len(self.resnets)):
            qk = self.last_qk(want_qk, j)
            x = self.layer(j, x, temb_f, context_f, pose_feature, epi_cond, lora_scale, pab, qk,
                           unit, mesh)
            res_states.append(x)
        if self.downsamplers is not None:
            x = _unfold(self.downsamplers[0](_fold(x)), x.shape[0])
            res_states.append(x)
        return x, res_states, qk


class MidBlock(_Block):
    def __init__(self, cfg, channels, temb_dim, use_motion, use_epi):
        super().__init__(cfg, [channels], channels, temb_dim, cfg.mid_transformer_layers,
                         cfg.heads(len(cfg.block_out_channels) - 1), use_motion, use_epi)
        self.resnets.append(ResnetBlock2D(channels, channels, temb_dim, cfg.norm_num_groups))

    def forward(self, x, temb_f, context_f, pose_feature, epi_cond, lora_scale=1.0, pab=None,
                want_qk=False, unit=_call, mesh=None):
        qk = [] if want_qk else None
        x = self.layer(0, x, temb_f, context_f, pose_feature, epi_cond, lora_scale, pab, qk,
                       unit, mesh)
        return _unfold(unit(self.resnets[1], _fold(x), temb_f), x.shape[0]), qk


class CrossAttnUpBlock(_Block):
    def __init__(self, cfg, in_channels, channels, temb_dim, depth, heads, use_motion,
                 use_epi, add_upsample):
        super().__init__(cfg, in_channels, channels, temb_dim, depth, heads, use_motion,
                         use_epi)
        self.upsamplers = nn.ModuleList([Upsample2D(channels)]) if add_upsample else None

    def forward(self, x, res_states, temb_f, context_f, pose_feature, epi_cond,
                lora_scale=1.0, pab=None, want_qk=False, unit=_call, mesh=None):
        qk = None
        for j in range(len(self.resnets)):
            qk = self.last_qk(want_qk, j)
            x = torch.cat([x, res_states[-1 - j]], dim=-1)
            x = self.layer(j, x, temb_f, context_f, pose_feature, epi_cond, lora_scale, pab, qk,
                           unit, mesh)
        if self.upsamplers is not None:
            x = _unfold(self.upsamplers[0](_fold(x)), x.shape[0])
        return x, qk


class UNet3DConditionModel(nn.Module):
    """Pose- and epipolar-conditioned video UNet."""

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        temb_dim = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        if cfg.addition_embed_type:
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                   temb_dim)
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, 1, 1)

        if cfg.fuse_first_frame:
            self.down_fusers = nn.ModuleList([FusionBlock2D(ch[0], temb_dim)])

        res_channels: List[int] = [ch[0]]
        down = []
        for i, c in enumerate(ch):
            is_final = i == len(ch) - 1
            down.append(CrossAttnDownBlock(
                cfg, ch[max(i - 1, 0)], c, temb_dim, cfg.depth(i), cfg.heads(i),
                use_motion=cfg.use_motion_module and 2 ** i in cfg.motion_module_resolutions,
                use_epi=cfg.use_epi_module and 2 ** i in cfg.epi_module_resolutions,
                add_downsample=not is_final))
            res_channels += [c] * (cfg.layers_per_block + (0 if is_final else 1))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlock(cfg, ch[-1], temb_dim,
                                  cfg.use_motion_module and cfg.motion_module_mid_block,
                                  cfg.use_epi_module and cfg.epi_module_mid_block)
        if cfg.fuse_first_frame:
            self.mid_fuser = FusionBlock2D(ch[-1], temb_dim)
        rev = list(reversed(ch))
        up, cur = [], rev[0]
        for i, c in enumerate(rev):
            level = len(ch) - 1 - i
            n_layers = cfg.layers_per_block + 1
            skips = res_channels[-n_layers:][::-1]
            res_channels = res_channels[:-n_layers]
            in_chs = [(cur if j == 0 else c) + s for j, s in enumerate(skips)]
            up.append(CrossAttnUpBlock(
                cfg, in_chs, c, temb_dim, cfg.depth(level), cfg.heads(level),
                use_motion=cfg.use_motion_module and 2 ** level in cfg.motion_module_resolutions,
                use_epi=cfg.use_epi_module and 2 ** level in cfg.epi_module_resolutions,
                add_upsample=i != len(ch) - 1))
            cur = c
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = FusedGroupNorm(ch[0], cfg.norm_num_groups, 1e-5, act="silu")
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, 1, 1)
        # the position, in the order of the call (down blocks, mid, up
        # blocks), of the block that runs the last epi module
        blocks = [*self.down_blocks, self.mid_block, *self.up_blocks]
        with_epi = [i for i, b in enumerate(blocks) if b.epi_modules is not None]
        self._last_epi_block = with_epi[-1] if with_epi else -1
        if cfg.additional_channel > 0 and with_epi:
            c = blocks[with_epi[-1]].resnets[0].conv1.out_channels
            self.conv_auxiliary_query = Conv2d(c, cfg.additional_channel, 1, 1, 0)
            self.conv_auxiliary_key = Conv2d(c, cfg.additional_channel, 1, 1, 0)

    def zero_initialized(self) -> List[str]:
        """Names of the parameters a fresh model starts at zero: the pose
        merge layers (``qkv_merge``; biases start at zero anyway), the ``up``
        of every LoRA delta (image and sync), the first-frame fusion blocks'
        ``conv_out``, the epi modules' ``proj_out`` with ``epi_zero_initialize``
        and the motion modules' with ``motion_zero_initialize``."""
        ends = ["qkv_merge.weight", "_lora.up.weight", "_lora_sync.up.weight",
                "down_fusers.0.conv_out.weight", "mid_fuser.conv_out.weight"]
        if self.config.epi_zero_initialize:
            ends.append("epi_transformer.proj_out.weight")
        if self.config.motion_zero_initialize:
            ends.append("temporal_transformer.proj_out.weight")
        return [n for n, _ in self.named_parameters() if n.endswith(tuple(ends))]

    def forward(
        self,
        sample: torch.Tensor,                    # [B, F, H, W, C_in]
        timesteps,                               # int, [] or [B]
        encoder_hidden_states: torch.Tensor,     # [B, L, cross_dim]
        pose_features: Optional[Sequence[torch.Tensor]] = None,  # a level each: [B, F, h, w, c]
        epi_cond: Optional[EpiConditioning] = None,
        remat: bool = False,
        lora_scale: float = 1.0,
        pab=None,
        down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
        mid_block_additional_residual: Optional[torch.Tensor] = None,
        return_extras: bool = False,
        mesh: Optional[Mesh] = None,
        added_cond: Optional[dict] = None,
        timer=None,
    ):
        """``remat``: recompute activations in the backward instead of
        keeping them, per the config's ``remat_unit`` and ``remat_policy``
        (only while autograd records).
        ``lora_scale``: the image LoRA's scale for this call. ``pab``: the
        request's PAB cache, its reuse flags set for this call. The two
        residual inputs (a SparseCtrl model's outputs, [B, F, h, w, c] each)
        are added to the down path's states after the down blocks and to the
        mid block's output after its fuser. ``return_extras``: return
        (out, {"auxiliary", "epi_qk"}) instead of out: the auxiliary head's
        [B, F, s, s, 2 * additional_channel] (query channels, then key; None
        without the head) and the q/k maps of the last epi module's
        attentions (the JAX package lists every epi attention's; its head
        reads the last). ``mesh``: a ("rows", "frames") mesh
        (``parallel/mesh.py``) of which ``sample``, ``encoder_hidden_states``,
        the pose features and ``epi_cond`` (whose ``mesh`` it must be) hold
        this rank's block of batch rows and frames; the output is this
        rank's block too. ``added_cond``: with ``addition_embed_type``
        "text_time", {"text_embeds": [B, P] pooled text, "time_ids": [B, 6]
        (original size, crop corner, target size)}. ``timer``: an
        ``IntervalTimer`` (``utils/tracing.py``) that this call starts and
        marks around each spatial transformer, motion module and epi module,
        named ``unet.spatial``, ``unet.motion``, ``unet.epi``."""
        cfg = self.config
        B, Fr = sample.shape[:2]
        if mesh is not None and (epi_cond is None or epi_cond.mesh is not mesh):
            raise ValueError("a UNet call on a mesh takes the epipolar conditioning of that mesh")
        if mesh is not None and return_extras:
            raise NotImplementedError("return_extras is not taken on a mesh")
        unit = (_remat_unit(cfg.remat_policy) if remat and torch.is_grad_enabled()
                else _call)
        # the unit wraps whole blocks, or each sublayer inside them
        run, sub = (unit, _call) if cfg.remat_unit == "block" else (_call, unit)
        if timer is not None:
            timer.start()
            sub = _timed(sub, timer)

        dtype = self.conv_in.weight.dtype
        # a [] / [B] tensor on the device passes as it comes (the samplers' timestep
        # buffer, which a CUDA graph replays); an int is copied from the host here
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        t_emb = sinusoidal_time_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding(t_emb.to(dtype))
        if cfg.addition_embed_type:
            if added_cond is None:
                raise ValueError("addition_embed_type 'text_time' takes added_cond: "
                                 "{'text_embeds', 'time_ids'}")
            time_ids = added_cond["time_ids"]
            time_embeds = sinusoidal_time_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim).reshape(time_ids.shape[0], -1)
            add = torch.cat([added_cond["text_embeds"].to(dtype), time_embeds.to(dtype)], -1)
            temb = temb + self.add_embedding(add)
        temb_f = temb.repeat_interleave(Fr, dim=0)
        context_f = encoder_hidden_states.to(dtype).repeat_interleave(Fr, dim=0)
        if pose_features is None:
            pose_features = [None] * len(cfg.block_out_channels)

        def fuse(fuser, x):
            if mesh is None:
                return torch.cat([x[:, :1], fuser(x[:, :1], x[:, 1:], temb)], dim=1)
            # the first frame, from the rank of this frames group that holds it
            first = all_gather(x[:, :1], mesh, "frames", dim=1)[:, :1]
            if mesh.coords["frames"]:
                return fuser(first, x, temb)
            return torch.cat([first, fuser(first, x[:, 1:], temb)], dim=1)

        def want(position):
            return return_extras and position == self._last_epi_block

        qk = None
        x = _unfold(self.conv_in(_fold(sample.to(dtype))), B)
        if cfg.fuse_first_frame:
            x = fuse(self.down_fusers[0], x)
        res_stack = [x]
        for i, block in enumerate(self.down_blocks):
            x, res, maps = run(block, x, temb_f, context_f, pose_features[i], epi_cond,
                               lora_scale, pab, want(i), sub, mesh)
            res_stack += res
            qk = maps or qk
        if down_block_additional_residuals is not None:
            res_stack = [r + extra.to(r.dtype)
                         for r, extra in zip(res_stack, down_block_additional_residuals)]
        x, maps = run(self.mid_block, x, temb_f, context_f, pose_features[-1], epi_cond,
                      lora_scale, pab, want(len(self.down_blocks)), sub, mesh)
        qk = maps or qk
        if cfg.fuse_first_frame:
            x = fuse(self.mid_fuser, x)
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual.to(x.dtype)
        for i, block in enumerate(self.up_blocks):
            n = len(block.resnets)
            res, res_stack = res_stack[-n:], res_stack[:-n]
            x, maps = run(block, x, res, temb_f, context_f, pose_features[-(i + 1)], epi_cond,
                          lora_scale, pab, want(len(self.down_blocks) + 1 + i), sub, mesh)
            qk = maps or qk
        h = self.conv_norm_out(_fold(x))
        out = _unfold(self.conv_out(h), B)
        if not return_extras:
            return out
        auxiliary = None
        if cfg.additional_channel > 0 and qk:
            # 1x1 convolutions over the token maps, weights cast at use (f32
            # masters in training)
            q, k = qk[-1]["query"], qk[-1]["key"]
            s = int(round(q.shape[1] ** 0.5))
            heads = [F.linear(t, conv.weight.reshape(conv.out_channels, -1).to(t.dtype),
                              conv.bias.to(t.dtype)).reshape(B, Fr, s, s, -1)
                     for t, conv in ((q, self.conv_auxiliary_query),
                                     (k, self.conv_auxiliary_key))]
            auxiliary = torch.cat(heads, dim=-1)
        return out, {"auxiliary": auxiliary, "epi_qk": qk}
