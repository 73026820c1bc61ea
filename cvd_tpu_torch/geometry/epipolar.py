"""Two-view epipolar geometry as batch-first functions: numpy on the host,
and ``fundamental_between_views_torch`` on device tensors.

Port of ``cvd_tpu/geometry/epipolar.py`` without its jnp/numpy dispatch.
The 2-view sampler computes its fundamental matrices once per request on
the host (numpy); the N-view sampler draws a fresh pairing of views at
every UNet call and computes their matrices where the poses live, on the
device, with no host round trip (torch).

Conventions
-----------
* ``T`` (4x4) maps camera-1 coordinates to camera-2 coordinates:
  ``x2 = T @ x1``.
* ``c2w`` are camera-to-world matrices.
* All functions accept arbitrary leading batch dims.
"""
from __future__ import annotations

import numpy as np
import torch


def rigid_inverse(T: np.ndarray) -> np.ndarray:
    """Analytic inverse of a rigid [..., 4, 4] transform: [R^T, -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = np.swapaxes(R, -1, -2)
    top = np.concatenate(
        [Rt, -np.einsum("...ij,...j->...i", Rt, t)[..., None]], axis=-1
    )
    bottom = np.broadcast_to(
        np.asarray([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), T.shape[:-2] + (1, 4)
    )
    return np.concatenate([top, bottom], axis=-2)


def calibration_inverse(K: np.ndarray) -> np.ndarray:
    """Closed-form inverse of K = [[fx, s, cx], [0, fy, cy], [0, 0, 1]]."""
    fx, s, cx = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2]
    fy, cy = K[..., 1, 1], K[..., 1, 2]
    zero = np.zeros_like(fx)
    one = np.ones_like(fx)
    row0 = np.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1)
    row1 = np.stack([zero, 1.0 / fy, -cy / fy], -1)
    row2 = np.stack([zero, zero, one], -1)
    return np.stack([row0, row1, row2], axis=-2)


def cross_product_matrix(vec: np.ndarray) -> np.ndarray:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix so that [v]x @ w = v x w."""
    zero = np.zeros_like(vec[..., 0])
    row0 = np.stack([zero, -vec[..., 2], vec[..., 1]], axis=-1)
    row1 = np.stack([vec[..., 2], zero, -vec[..., 0]], axis=-1)
    row2 = np.stack([-vec[..., 1], vec[..., 0], zero], axis=-1)
    return np.stack([row0, row1, row2], axis=-2)


def essential_from_transform(T: np.ndarray) -> np.ndarray:
    """E = R @ [t_ess]x with t_ess = -R^T t; satisfies x2^T E x1 = 0."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    t_ess = -np.einsum("...ji,...j->...i", R, t)
    return np.einsum("...ij,...jk->...ik", R, cross_product_matrix(t_ess))


def fundamental_from_transform(T, K1, K2) -> np.ndarray:
    """F = K2^-T E K1^-1, so that p2^T F p1 = 0 for corresponding pixels."""
    E = essential_from_transform(T)
    K1_inv = calibration_inverse(K1)
    K2_invT = np.swapaxes(calibration_inverse(K2), -1, -2)
    return np.einsum("...ij,...jk,...kl->...il", K2_invT, E, K1_inv)


def relative_transform(src_c2w, dst_c2w) -> np.ndarray:
    """T = inv(dst_c2w) @ src_c2w: src-camera coords -> dst-camera coords."""
    return np.einsum("...ij,...jk->...ik", rigid_inverse(dst_c2w), src_c2w)


def fundamental_between_views(src_c2w, dst_c2w, K_src, K_dst) -> np.ndarray:
    """F mapping src-view pixels to epipolar lines in the dst view, batched."""
    T = relative_transform(src_c2w, dst_c2w)
    return fundamental_from_transform(T, K_src, K_dst)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., i, j] @ [..., j, k] as a broadcast product and a sum: exact f32
    on every device (no library product, so TF32 never applies to the 3x3
    and 4x4 matrices the epipolar band of a few pixels hangs on)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def fundamental_between_views_torch(src_c2w: torch.Tensor, dst_c2w: torch.Tensor,
                                    K_src: torch.Tensor, K_dst: torch.Tensor) -> torch.Tensor:
    """``fundamental_between_views`` on tensors, on their device, in f32:
    [..., 4, 4] poses and [..., 3, 3] intrinsics -> [..., 3, 3]."""
    src_c2w, dst_c2w, K_src, K_dst = (x.float() for x in (src_c2w, dst_c2w, K_src, K_dst))
    # T = inv(dst_c2w) @ src_c2w with the rigid inverse [R^T, -R^T t]
    Rd_t = dst_c2w[..., :3, :3].transpose(-1, -2)
    R = _matmul_f32(Rd_t, src_c2w[..., :3, :3])
    t = _matmul_f32(Rd_t, (src_c2w[..., :3, 3] - dst_c2w[..., :3, 3])[..., None])[..., 0]
    # E = R [t_ess]x with t_ess = -R^T t
    e = -_matmul_f32(R.transpose(-1, -2), t[..., None])[..., 0]
    zero = torch.zeros_like(e[..., 0])
    cross = torch.stack([torch.stack([zero, -e[..., 2], e[..., 1]], -1),
                         torch.stack([e[..., 2], zero, -e[..., 0]], -1),
                         torch.stack([-e[..., 1], e[..., 0], zero], -1)], -2)
    E = _matmul_f32(R, cross)

    def k_inv(K):
        fx, s, cx = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2]
        fy, cy = K[..., 1, 1], K[..., 1, 2]
        one = torch.ones_like(fx)
        return torch.stack([
            torch.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1),
            torch.stack([zero, 1.0 / fy, -cy / fy], -1),
            torch.stack([zero, zero, one], -1)], -2)

    return _matmul_f32(_matmul_f32(k_inv(K_dst).transpose(-1, -2), E), k_inv(K_src))
