"""Shared building blocks for the SD1.5-family UNet, pose encoder and VAE
(port of ``cvd_tpu/models/layers.py``).

Activations keep the JAX package's layouts: spatial tensors channels-last
``[..., H, W, C]``, video ``[B, F, H, W, C]``, tokens ``[B, L, C]``.
Convolutions run as ``nn.Conv2d`` on the channels-last tensor permuted to
NCHW (a zero-copy view in ``torch.channels_last`` format). Module and
parameter names reproduce the released checkpoints' state-dict keys
(``cvd_tpu_torch.io.manifests``), so ``load_state_dict`` takes a checkpoint's
tensors, or a converted JAX param tree (``cvd_tpu_torch.io.from_flax``), as
they are.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvd_tpu_torch.ops.attention import attention_with_bias
from cvd_tpu_torch.ops.epi_flash import flash_attention
from cvd_tpu_torch.ops.ln_matmul import layer_norm_matmul
from cvd_tpu_torch.ops.norms import group_norm
from cvd_tpu_torch.parallel.shard_ops import extended_context

# self-attentions at least this long take the fused kernel (K2) on CUDA,
# as the JAX package does at its big spatial attentions (layers.py:382-403);
# one whose keys are not its queries (extended attention: the pair's tokens)
# also needs both lengths a multiple of 128, as the JAX package's
# ``flash_supported`` decides
FLASH_MIN_TOKENS = 256
FLASH_KEY_MULTIPLE = 128


def pab_run(pab, site: nn.Module, kind: str, fn):
    """``fn()``, the output of the attention ``site`` of class ``kind``, under
    Pyramid Attention Broadcast (``pipelines/pab.py``): with a cache ``pab``
    that marks ``kind`` reused for this call, the cached output instead, and
    ``fn`` (its norm, projections and attention) does not run."""
    return fn() if pab is None else pab.run(site, kind, fn)


def sinusoidal_time_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` as the SD1.5 UNet configures it
    (flip_sin_to_cos, no frequency shift, max period 10^4): timesteps [B]
    -> [B, dim] f32."""
    half_dim = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device) / half_dim
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    out = torch.cat([torch.cos(emb), torch.sin(emb)], -1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def temporal_positional_encoding(length: int, d_model: int,
                                 device=None) -> torch.Tensor:
    """AnimateDiff motion-module sinusoid: [1, length, d_model] f32."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model))
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe[None]


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2 (diffusers TimestepEmbedding)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class FusedGroupNorm(nn.Module):
    """GroupNorm over the channel (last) axis through ``ops.group_norm``
    (kernel K4 on CUDA); ``act='silu'`` fuses the following SiLU."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps,
                          act=self.act)


def group_norm_per_frame(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a GroupNorm to [B, F, H, W, C] with statistics per frame."""
    B, Fr = x.shape[:2]
    return norm(x.reshape((B * Fr,) + x.shape[2:])).reshape(x.shape)


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``mod(x)`` with the weights cast to the activations' dtype at use, so
    f32 master weights (the trainable epi modules) run in bf16 activations
    and their gradients land on the f32 masters (Flax ``param_dtype=f32``,
    ``dtype=bf16``). A no-op cast when the dtypes already agree."""
    bias = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.linear(x, mod.weight.to(x.dtype), bias)


def fused_matmul(x: torch.Tensor, weights: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """x @ concat(weights)^T split back per weight (one read of x)."""
    out = F.linear(x, torch.cat(list(weights), dim=0))
    return tuple(torch.split(out, [w.shape[0] for w in weights], dim=-1))


class Conv2d(nn.Conv2d):
    """nn.Conv2d on channels-last [N, H, W, C] inputs and outputs."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """diffusers FeedForward with GEGLU: proj(dim -> 2*4dim) -> x*gelu(g) -> out."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor, pre_ln: Optional[nn.LayerNorm] = None) -> torch.Tensor:
        """pre_ln: the preceding LayerNorm; ``x`` is then UNNORMALIZED and
        the norm fuses into the GEGLU projection (kernel K5 on CUDA)."""
        proj = self.net[0].proj
        if pre_ln is not None:
            (h,) = layer_norm_matmul(x, pre_ln.weight, pre_ln.bias, [proj.weight],
                                     [proj.bias], eps=pre_ln.eps)
        else:
            h = proj(x)
        h, gate = h.chunk(2, dim=-1)
        return linear(self.net[2], h * F.gelu(gate))


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    B, L, C = x.shape
    return x.reshape(B, L, heads, C // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, L, D = x.shape
    return x.transpose(1, 2).reshape(B, L, H * D)


class LoRADelta(nn.Module):
    """down -> up low-rank delta (diffusers ``LoRALinearLayer``): no biases,
    ``up`` starts at zero (``UNet3DConditionModel.zero_initialized``), so a
    fresh delta is 0. ``down_std``: ``down`` starts as N(0, down_std) (the
    sync-LoRA's 1 / rank) instead of the default uniform."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 down_std: Optional[float] = None):
        super().__init__()
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, out_features, bias=False)
        self.down.init_std = down_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self.up, linear(self.down, x))


class LoRAProcessor(nn.Module):
    """The image LoRA of one attention, where the reference keeps it: on the
    attention processor (state-dict keys ``...attn1.processor.to_q_lora.down.
    weight``), a delta for each of q, k, v (from the normed tokens, k and v
    from the context) and the output (from the attention's output, before
    ``to_out``)."""

    def __init__(self, query_dim: int, context_dim: int, inner: int, rank: int):
        super().__init__()
        self.to_q_lora = LoRADelta(query_dim, inner, rank)
        self.to_k_lora = LoRADelta(context_dim, inner, rank)
        self.to_v_lora = LoRADelta(context_dim, inner, rank)
        self.to_out_lora = LoRADelta(inner, query_dim, rank)


class Attention(nn.Module):
    """diffusers ``Attention``: to_q/to_k/to_v without bias, to_out.0 with
    bias. Token-major [B, L, C]; context [B, Lk, C_ctx] for cross attention.
    With ``lora_rank > 0`` each projection gains a LoRA delta scaled at call
    time by ``lora_scale`` (the reference's CustomizedLoRAAttnProcessor)."""

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None, lora_rank: int = 0):
        super().__init__()
        inner = heads * dim_head
        ctx = cross_attention_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])
        self.processor = (LoRAProcessor(query_dim, ctx, inner, lora_rank)
                          if lora_rank > 0 else None)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                pre_ln: Optional[nn.LayerNorm] = None,
                lora_scale: float = 1.0) -> torch.Tensor:
        """pre_ln: the preceding LayerNorm of the queries; ``x`` is then
        UNNORMALIZED and the norm fuses into the projection (kernel K5).
        Context tokens are never normalized by it. The LoRA deltas need the
        normed tokens, so they take no ``pre_ln``."""
        wq, wk, wv = self.to_q.weight, self.to_k.weight, self.to_v.weight
        lora = self.processor
        if pre_ln is not None:
            if lora is not None:
                raise ValueError("the LoRA deltas need the normed tokens: no pre_ln")
            if context is None:
                q, k, v = layer_norm_matmul(x, pre_ln.weight, pre_ln.bias,
                                            [wq, wk, wv], [None] * 3, eps=pre_ln.eps)
            else:
                (q,) = layer_norm_matmul(x, pre_ln.weight, pre_ln.bias, [wq], [None],
                                         eps=pre_ln.eps)
                k, v = fused_matmul(context, (wk, wv))
        elif context is None:
            q, k, v = fused_matmul(x, (wq, wk, wv))
        else:
            (q,) = fused_matmul(x, (wq,))
            k, v = fused_matmul(context, (wk, wv))
        if lora is not None:
            ctx = x if context is None else context
            q = q + lora_scale * lora.to_q_lora(x)
            k = k + lora_scale * lora.to_k_lora(ctx)
            v = v + lora_scale * lora.to_v_lora(ctx)
        Lq, Lk = q.shape[1], k.shape[1]
        if bias is None and Lq >= FLASH_MIN_TOKENS and (
                context is None
                or (Lq % FLASH_KEY_MULTIPLE == 0 and Lk % FLASH_KEY_MULTIPLE == 0)):
            h = flash_attention(q, k, v, heads=self.heads)
        else:
            h = merge_heads(attention_with_bias(
                split_heads(q, self.heads), split_heads(k, self.heads),
                split_heads(v, self.heads), bias))
        out = self.to_out[0](h)
        if lora is not None:
            out = out + lora_scale * lora.to_out_lora(h)
        return out


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D: norm1 -> silu -> conv1 (+ time_emb_proj(silu
    (temb))) -> norm2 -> silu -> conv2 -> + shortcut (1x1 conv on a width
    change). Input [N, H, W, C]."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int = 1280,
                 groups: int = 32, eps: float = 1e-6, use_time_emb: bool = True):
        super().__init__()
        self.norm1 = FusedGroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = Conv2d(in_channels, out_channels, 3, 1, 1)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels) if use_time_emb else None
        self.norm2 = FusedGroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = Conv2d(out_channels, out_channels, 3, 1, 1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1, 1, 0)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class Downsample2D(nn.Module):
    """stride-2 3x3 conv (diffusers Downsample2D with use_conv=True)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """nearest x2 + 3x3 conv (diffusers Upsample2D)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
        return self.conv(x.permute(0, 2, 3, 1))


class FusionBlock2D(nn.Module):
    """First-frame feature fusion (``fuse_first_frame``): concat(first frame,
    frame t) -> a 1x1 resnet over 2C -> 3C channels (GroupNorm + SiLU on
    kernel K4, eps 1e-6) -> a zero-initialized ``conv_out`` emitting
    (scale_1, scale_2, shift), and

        out_t = scale_1 * first + (1 + scale_2) * frame_t + shift

    for the frames after the first. A fresh block is the identity (its
    ``conv_out`` starts at zero: ``UNet3DConditionModel.zero_initialized``).
    first [B, 1, H, W, C], post [B, F-1, H, W, C], temb [B, Ct] -> the fused
    post frames."""

    def __init__(self, channels: int, temb_channels: int = 1280, groups: int = 32,
                 eps: float = 1e-6):
        super().__init__()
        C = channels
        self.norm1 = FusedGroupNorm(2 * C, groups, eps, act="silu")
        self.conv1 = Conv2d(2 * C, 3 * C, 1, 1, 0)
        self.time_emb_proj = nn.Linear(temb_channels, 3 * C)
        self.norm2 = FusedGroupNorm(3 * C, groups, eps, act="silu")
        self.conv2 = Conv2d(3 * C, 3 * C, 1, 1, 0)
        self.conv_shortcut = Conv2d(2 * C, 3 * C, 1, 1, 0)
        self.conv_out = Conv2d(3 * C, 3 * C, 1, 1, 0)

    def forward(self, first: torch.Tensor, post: torch.Tensor,
                temb: torch.Tensor) -> torch.Tensor:
        B, Fm1 = post.shape[:2]
        rep_first = first.expand_as(post)
        inp = torch.cat([rep_first, post], dim=-1).reshape((B * Fm1,) + post.shape[2:-1]
                                                           + (2 * post.shape[-1],))
        h = self.conv1(self.norm1(inp))
        h = h + self.time_emb_proj(F.silu(temb.repeat_interleave(Fm1, dim=0)))[:, None, None, :]
        h = self.conv_out(self.conv_shortcut(inp) + self.conv2(self.norm2(h)))
        scale_1, scale_2, shift = h.reshape(post.shape[:-1] + (-1,)).chunk(3, dim=-1)
        return scale_1 * rep_first + (1.0 + scale_2) * post + shift


class BasicTransformerBlock(nn.Module):
    """diffusers BasicTransformerBlock (spatial): self attn, cross attn, ff.
    Each LayerNorm folds into the following projection (kernel K5), unless
    the normed tokens are needed on their own: by the LoRA deltas, and by
    ``extended_attention``, where the self-attention's keys and values are
    the normed tokens of both videos of the pair (the reference's
    spatial_extended_attention, attention_processor.py:69-83). The batch is
    then the two videos' rows, first video first."""

    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 768,
                 extended_attention: bool = False, lora_rank: int = 0):
        super().__init__()
        self.extended_attention = extended_attention
        self.fused = lora_rank == 0 and not extended_attention
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, dim_head, lora_rank=lora_rank)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_attention_dim,
                               lora_rank=lora_rank)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def _self_attention(self, x: torch.Tensor, lora_scale: float, mesh, frames: int
                        ) -> torch.Tensor:
        h = self.norm1(x)
        context = extended_context(h, mesh, frames) if self.extended_attention else None
        return self.attn1(h, context, lora_scale=lora_scale)

    def forward(self, x: torch.Tensor, context: torch.Tensor, lora_scale: float = 1.0,
                pab=None, mesh=None, frames: int = 1) -> torch.Tensor:
        """pab: the request's PAB cache (``pipelines/pab.py``): classes
        "spatial" (attn1) and "cross" (attn2). ``mesh``: a ("rows", "frames")
        mesh of which the rows are this rank's block of videos x ``frames``
        frames (extended attention gathers the pair's other video)."""
        if self.fused:
            x = x + pab_run(pab, self.attn1, "spatial",
                            lambda: self.attn1(x, pre_ln=self.norm1))
            x = x + pab_run(pab, self.attn2, "cross",
                            lambda: self.attn2(x, context, pre_ln=self.norm2))
            return x + self.ff(x, pre_ln=self.norm3)
        x = x + pab_run(pab, self.attn1, "spatial",
                        lambda: self._self_attention(x, lora_scale, mesh, frames))
        x = x + pab_run(pab, self.attn2, "cross",
                        lambda: self.attn2(self.norm2(x), context, lora_scale=lora_scale))
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """Spatial transformer of ``depth`` blocks with 1x1-conv projections
    (SD1.5), or with ``linear_projection`` Linear ones (SDXL's
    ``use_linear_projection``: state-dict shapes [C, C], not [C, C, 1, 1]).
    Input [N, H, W, C]; context [N, L, C_ctx]."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, depth: int = 1,
                 cross_attention_dim: int = 768, groups: int = 32,
                 extended_attention: bool = False, lora_rank: int = 0,
                 linear_projection: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.norm = FusedGroupNorm(in_channels, groups, 1e-6)
        def proj(cin, cout):
            return nn.Linear(cin, cout) if linear_projection else Conv2d(cin, cout, 1, 1, 0)

        self.proj_in = proj(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim,
                                  extended_attention, lora_rank)
            for _ in range(depth)
        ])
        self.proj_out = proj(inner, in_channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor, lora_scale: float = 1.0,
                pab=None, mesh=None, frames: int = 1) -> torch.Tensor:
        N, H, W, C = x.shape
        h = self.proj_in(self.norm(x))
        h = h.reshape(N, H * W, h.shape[-1])
        for blk in self.transformer_blocks:
            h = blk(h, context, lora_scale, pab, mesh, frames)
        h = self.proj_out(h.reshape(N, H, W, h.shape[-1]))
        return h + x
