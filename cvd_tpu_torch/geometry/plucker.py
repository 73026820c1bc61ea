"""Plücker ray embeddings for camera conditioning (host-side numpy).

Port of ``cvd_tpu/geometry/plucker.py::ray_condition``: per-pixel ray
origin/direction from intrinsics + c2w pose, packed as ``[o x d, d]``.

Per frame the embedding is linear in the unit camera direction
``d̂ = [x, y, 1] / |[x, y, 1]|``, ``x = (u + ½ - cx) / fx``,
``y = (v + ½ - cy) / fy``: with ``d = R d̂``, ``[o x d, d] = M d̂`` for the
6x3 matrix ``M = [[o]ₓ R ; R]``. So channel c of a frame is
``(M[c, 0] x + M[c, 1] y + M[c, 2]) / |[x, y, 1]|``: a row term plus a
column term, times one [H, W] inverse norm. The product is written out
channel by channel with elementwise NumPy, not ``matmul``: a 3-deep BLAS
product gains nothing, and waking BLAS's threads for each frame cost
more than the arithmetic.
"""
from __future__ import annotations

import numpy as np

from cvd_tpu_torch.utils import tracing


def ray_condition(K: np.ndarray, c2w: np.ndarray, H: int, W: int) -> np.ndarray:
    """K [B, V, 4] (fx, fy, cx, cy) pixels; c2w [B, V, 4, 4]
    -> [B, V, H, W, 6] ``concat(o x d, d)`` with unit-norm d, C-contiguous.
    The span ``geometry.ray_condition`` (``utils/tracing.py``)."""
    with tracing.span("geometry.ray_condition"):
        dtype = np.result_type(K, c2w)
        B, V = K.shape[:2]
        K = K.reshape(B * V, 4).astype(dtype, copy=False)
        c2w = c2w.reshape(B * V, 4, 4).astype(dtype, copy=False)
        # Mᵀ per frame [3, 6]: row k is (o x R[:, k], R[:, k])
        Rt = np.swapaxes(c2w[:, :3, :3], 1, 2)
        Mt = np.concatenate([np.cross(c2w[:, None, :3, 3], Rt), Rt], axis=-1)

        cols = np.arange(W, dtype=dtype) + 0.5
        rows = np.arange(H, dtype=dtype) + 0.5
        out = np.empty((B * V, H, W, 6), dtype)
        planes = np.empty((6, H, W), dtype)
        for f, (fx, fy, cx, cy) in enumerate(K):
            x = (cols - cx) / fx
            y = (rows - cy) / fy
            inv_norm = 1 / np.sqrt(x * x + (y * y)[:, None] + 1)
            m = Mt[f]
            np.add((m[0, :, None] * x + m[2, :, None])[:, None, :],
                   (m[1, :, None] * y)[:, :, None], out=planes)
            planes *= inv_norm
            np.copyto(out[f], planes.transpose(1, 2, 0))
        return out.reshape(B, V, H, W, 6)
