"""Plain attention with a materialized additive bias (port of
``cvd_tpu/ops/attention.py``). Matmul and softmax written out, softmax in
f32 — the reference math for the epipolar attention and the path for the
attentions the JAX package leaves to XLA."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_with_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: [B, heads, L, D]; bias: [B, Lq, Lk] or [B, heads, Lq, Lk]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if bias is not None:
        if bias.ndim == 3:
            bias = bias[:, None]
        logits = logits + bias.float()
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)
