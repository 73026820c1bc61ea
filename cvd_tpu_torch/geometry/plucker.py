"""Plücker ray embeddings for camera conditioning (host-side numpy).

Port of ``cvd_tpu/geometry/plucker.py::ray_condition``: per-pixel ray
origin/direction from intrinsics + c2w pose, packed as ``[o x d, d]``.
"""
from __future__ import annotations

import numpy as np

from cvd_tpu_torch.utils import tracing


def ray_condition(K: np.ndarray, c2w: np.ndarray, H: int, W: int) -> np.ndarray:
    """K [B, V, 4] (fx, fy, cx, cy) pixels; c2w [B, V, 4, 4]
    -> [B, V, H, W, 6] ``concat(o x d, d)`` with unit-norm d. The span
    ``geometry.ray_condition`` (``utils/tracing.py``)."""
    with tracing.span("geometry.ray_condition"):
        dtype = c2w.dtype
        B, V = K.shape[:2]
        j = np.arange(H, dtype=dtype) + 0.5
        i = np.arange(W, dtype=dtype) + 0.5
        jj, ii = np.meshgrid(j, i, indexing="ij")
        ii = ii.reshape(1, 1, H * W)
        jj = jj.reshape(1, 1, H * W)
        ii = np.broadcast_to(ii, (B, V, H * W))
        jj = np.broadcast_to(jj, (B, V, H * W))

        fx, fy, cx, cy = [K[..., k:k + 1] for k in range(4)]
        zs = np.ones_like(ii)
        xs = (ii - cx) / fx
        ys = (jj - cy) / fy
        directions = np.stack([xs, ys, zs], axis=-1)
        directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)

        rays_d = np.einsum("bvnk,bvjk->bvnj", directions, c2w[..., :3, :3])
        rays_o = np.broadcast_to(c2w[..., None, :3, 3], rays_d.shape)
        rays_dxo = np.cross(rays_o, rays_d)
        plucker = np.concatenate([rays_dxo, rays_d], axis=-1)
        return plucker.reshape(B, V, H, W, 6)
