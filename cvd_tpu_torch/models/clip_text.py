"""CLIP text encoder (openai/clip-vit-large-patch14 text model), port of
``cvd_tpu/models/clip_text.py``: input_ids [B, 77] -> last_hidden_state
[B, 77, hidden].

``encode`` gives what SDXL's pipeline takes from each of its two text
encoders (CLIP-L and OpenCLIP ViT-bigG's text tower, transformers'
``CLIPTextModel`` / ``CLIPTextModelWithProjection``): the penultimate
layer's states, with no final LayerNorm, and, where the encoder has a
``text_projection`` (``projection_dim`` > 0), the pooled embedding: the
final-LayerNormed state at the first position of the largest id (the EOS
token, as transformers picks it for a config whose ``eos_token_id`` is 2,
bigG's) times ``text_projection``. ``hidden_act`` is CLIP-L's "quick_gelu"
or bigG's "gelu" (exact erf)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # the pooled embedding's width (``text_projection``, no bias); 0: none
    projection_dim: int = 0

    def __post_init__(self):
        if self.hidden_act not in ACTIVATIONS:
            raise ValueError(f"hidden_act={self.hidden_act!r}: expected one of "
                             f"{tuple(ACTIVATIONS)}")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"quick_gelu": quick_gelu, "gelu": F.gelu}


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        hd = C // self.heads

        def split(t):
            return t.reshape(B, L, self.heads, hd).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd) + causal_mask
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, C)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = ACTIVATIONS[cfg.hidden_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEncoder(nn.Module):
    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        c = config
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(c.max_position_embeddings, c.hidden_size))
        self.layers = nn.ModuleList([CLIPEncoderLayer(c) for _ in range(c.num_layers)])
        self.final_layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.text_projection = (nn.Linear(c.hidden_size, c.projection_dim, bias=False)
                                if c.projection_dim else None)

    def _layers(self, input_ids: torch.Tensor, stop: Optional[int] = None):
        """The states after the first ``stop`` layers (all without)."""
        B, L = input_ids.shape
        x = self.token_embedding(input_ids.long()) + self.position_embedding[:L]
        causal = torch.triu(torch.full((L, L), float("-inf"), device=x.device), diagonal=1)
        for layer in self.layers[:stop]:
            x = layer(x, causal.to(x.dtype))
        return x, causal

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.final_layer_norm(self._layers(input_ids)[0])

    def encode(self, input_ids: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (the penultimate layer's states [B, L, hidden], the pooled
        embedding [B, projection_dim] or None without a projection). The
        last layer runs only for the pooled embedding."""
        x, causal = self._layers(input_ids, -1)
        if self.text_projection is None:
            return x, None
        last = self.final_layer_norm(self.layers[-1](x, causal.to(x.dtype)))
        eos = input_ids.argmax(dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos]
        return x, self.text_projection(pooled)
