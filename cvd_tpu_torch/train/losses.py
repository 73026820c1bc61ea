"""Training losses (port of ``cvd_tpu/train/losses.py``).

* ``masked_mse_loss`` — the epsilon-prediction loss with warped-region
  masks (train_epi_control.py:605).
* ``epi_distance_loss`` — the JAX package's re-derivation of the missing
  reference loss: soft-argmax correspondences from the auxiliary query/key
  maps must land on the epipolar lines of F. The train step takes it only
  where the UNet has the auxiliary q/k head (``additional_channel > 0``)
  and the batch has F mats (a posed batch).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from cvd_tpu_torch.geometry.epipolar_mask import epipolar_lines, pixel_grid_coords


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean((pred*mask - target*mask)^2); mask broadcastable or None."""
    if mask is None:
        return torch.mean((pred - target) ** 2)
    return torch.mean((pred * mask - target * mask) ** 2)


def epi_distance_loss(
    auxiliary: torch.Tensor,   # [B, F, h, w, 2*C]: query channels, then key
    F_mats: torch.Tensor,      # [B*F, 3, 3] (or [B, F, 3, 3])
    F_mat_size: int = 256,
) -> torch.Tensor:
    """Mean normalized distance of each query pixel's expected match in the
    partner view from its epipolar line, divided by ``F_mat_size``."""
    B, F, h, w, C2 = auxiliary.shape
    if h != w:
        raise ValueError("epi loss assumes square feature grids")
    C = C2 // 2
    q_map = auxiliary[..., :C].reshape(B * F, h * w, C)
    k_map = auxiliary[..., C:].reshape(B * F, h * w, C)
    F_mats = F_mats.reshape(B * F, 3, 3)

    coords = pixel_grid_coords(h, F_mat_size, auxiliary.device)   # [hw, 3]
    logits = torch.einsum("bqc,bkc->bqk", q_map, k_map) / math.sqrt(C)
    attn = torch.softmax(logits.float(), dim=-1)
    expected = torch.einsum("bqk,kj->bqj", attn, coords[:, :2])   # [BF, hw, 2]
    expected_h = torch.cat([expected, torch.ones_like(expected[..., :1])], dim=-1)

    lines = epipolar_lines(F_mats.float(), coords)                # [BF, hw, 3]
    ab_norm = torch.sqrt(torch.sum(lines[..., :2] ** 2, dim=-1)) + 1e-6
    dist = torch.abs(torch.einsum("bqi,bqi->bq", lines, expected_h)) / ab_norm
    return torch.mean(dist) / F_mat_size
