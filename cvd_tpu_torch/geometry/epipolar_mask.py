"""Soft epipolar attention bias, on the device (torch).

Port of ``cvd_tpu/geometry/epipolar_mask.py``. The bias factors into
per-query lines ``l_q = F @ x_q`` ([B, Q, 3]), a per-row band from the
corner maximum of the point-line distance field (exact: ``|a x + b y + c|``
is the absolute value of an affine function of the key pixel, so its
maximum over the key grid sits at a corner), and the per-pair evaluation
``bias[q, k] = -relu(|l'_q . x_k| - band) * alpha`` that the epipolar
attention kernel (ops/epi_flash.py) computes inside each tile. The
materialized [B, Q, K] form serves the plain attention path and the tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_EPS = 1e-6


def pixel_grid_coords(feat_size: int, F_mat_size: int, device=None,
                      dtype=torch.float32) -> torch.Tensor:
    """Homogeneous pixel-centre coords of the feature grid, rescaled to the
    resolution the F matrix is defined at; row-major ``q = y*f + x``.
    Returns [feat_size**2, 3]."""
    r = torch.arange(feat_size, device=device, dtype=dtype)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    coords = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    scale = F_mat_size / feat_size
    coords = scale * coords + (scale - 1.0) / 2.0
    coords[:, 2] = 1.0
    return coords


def epipolar_lines(F_mats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """l_q = F @ x_q for every query pixel. [B,3,3] x [Q,3] -> [B,Q,3]."""
    return torch.einsum("bij,qj->bqi", F_mats, coords)


def pseudo_lines(coords: torch.Tensor,
                 slope: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lines through each pixel's own coordinate.

    With ``slope`` (radians, broadcastable to the leading batch dims):
    ``(cos s, sin s, -(cos s * x + sin s * y))``; without: horizontal lines
    ``(0, -1, y)``. coords [..., Q, 3] -> [..., Q, 3].
    """
    x = coords[..., 0]
    y = coords[..., 1]
    if slope is None:
        a = torch.zeros_like(x)
        b = -torch.ones_like(x)
        c = y
    else:
        # a number is filled on the device: no copy from the host (a CUDA
        # graph may be capturing)
        slope = (slope.to(dtype=x.dtype, device=x.device) if torch.is_tensor(slope)
                 else torch.full((), float(slope), dtype=x.dtype, device=x.device))
        a = torch.cos(slope)[..., None].expand(x.shape)
        b = torch.sin(slope)[..., None].expand(x.shape)
        c = -(a * x + b * y)
    return torch.stack([a, b, c], dim=-1)


def homography_lines(H_mats: torch.Tensor, coords: torch.Tensor, F_mat_size: int,
                     slope: torch.Tensor) -> torch.Tensor:
    """Pseudo-epipolar lines through a homography (the pose-free data path):
    centre the pixel coords, apply H, dehomogenise, un-centre, then draw a
    line of the given slope through the mapped point.
    H_mats [B, 3, 3], coords [Q, 3], slope [B] radians -> [B, Q, 3]."""
    half = (F_mat_size - 1) / 2.0
    centred = coords.clone()
    centred[:, :2] -= half
    mapped = torch.einsum("bij,qj->bqi", H_mats, centred)
    mapped = mapped / (mapped[..., 2:] + _EPS)
    mapped = torch.cat([mapped[..., :2] + half, mapped[..., 2:]], dim=-1)
    return pseudo_lines(mapped, slope=slope)


def _corner_coords(feat_size: int, F_mat_size: int, device,
                   dtype) -> torch.Tensor:
    """The 4 corner pixel coords of the rescaled grid, [4, 3]: (lo, lo),
    (lo, hi), (hi, lo), (hi, hi), built on the device (no copy from the
    host, which a CUDA graph's capture refuses)."""
    scale = F_mat_size / feat_size
    lo = 0.0 * scale + (scale - 1.0) / 2.0
    hi = (feat_size - 1.0) * scale + (scale - 1.0) / 2.0
    i = torch.arange(4, device=device)
    full = torch.full((4,), lo, device=device, dtype=dtype)
    x = torch.where(i >= 2, hi, full)
    y = torch.where(i % 2 == 1, hi, full)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def lines_and_band(
    lines: torch.Tensor,
    feat_size: int,
    F_mat_size: int,
    pixel_band: float = 3.0,
    decay_alpha: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (norm_lines [B,Q,3], band [B], alpha [B]) for per-tile bias eval.

    Lines are scaled by 1/(||(a, b)|| + eps); band = pixel_band/(S//2) times
    the corner max of |l'.x|; alpha = decay_alpha / (band + eps).
    """
    ab_norm = torch.sqrt(torch.sum(lines[..., :2] ** 2, dim=-1, keepdim=True))
    norm_lines = lines / (ab_norm + _EPS)
    corners = _corner_coords(feat_size, F_mat_size, lines.device, lines.dtype)
    corner_vals = torch.abs(torch.einsum("bqi,ki->bqk", norm_lines, corners))
    max_cfc = torch.amax(corner_vals, dim=(-1, -2))
    band = pixel_band / (F_mat_size // 2) * max_cfc
    alpha = decay_alpha / (band + _EPS)
    return norm_lines, band, alpha


def epipolar_attn_bias_from_lines(
    lines: torch.Tensor,
    coords: torch.Tensor,
    feat_size: int,
    F_mat_size: int,
    pixel_band: float = 3.0,
    decay_alpha: float = 3.0,
) -> torch.Tensor:
    """Materialized [B, Q, K] bias (<= 0) from precomputed lines."""
    norm_lines, band, alpha = lines_and_band(
        lines, feat_size, F_mat_size, pixel_band, decay_alpha
    )
    cfc = torch.abs(torch.einsum("bqi,ki->bqk", norm_lines, coords))
    bias = -torch.clamp(cfc - band[:, None, None], min=0.0) * alpha[:, None, None]
    bias = torch.nan_to_num(bias, nan=0.0, posinf=0.0, neginf=0.0)
    return bias.detach()
