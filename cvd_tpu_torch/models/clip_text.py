"""CLIP text encoder (openai/clip-vit-large-patch14 text model), port of
``cvd_tpu/models/clip_text.py``: input_ids [B, 77] -> last_hidden_state
[B, 77, hidden]."""
from __future__ import annotations

import dataclasses
import math

import torch
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


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


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

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        B, L = input_ids.shape
        x = self.token_embedding(input_ids.long()) + self.position_embedding[:L]
        causal = torch.triu(torch.full((L, L), float("-inf"), device=x.device), diagonal=1)
        for layer in self.layers:
            x = layer(x, causal.to(x.dtype))
        return self.final_layer_norm(x)
