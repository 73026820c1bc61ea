"""Cameras, Plucker rays, fundamental matrices and the soft epipolar bias,
as the released CVD code defines them (RealEstate10K pose files, CameraCtrl
rays, the folded-pair trick, ``EpiEncoding.get_attn_map``). NumPy on the
host for the per-request conditioning, torch for the bias."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

EPS = 1e-6
# the source resolution the released validation loader assumes
SOURCE_H, SOURCE_W = 1280, 720


# ---- RealEstate10K pose files -------------------------------------------

def parse_pose_lines(lines: Sequence[str]) -> List[np.ndarray]:
    """Per-frame rows ``timestamp fx fy cx cy _ _ <12 w2c floats>`` ->
    [fx, fy, cx, cy, c2w (4x4)] entries (header line already removed)."""
    out = []
    for line in lines:
        vals = [float(x) for x in line.split()]
        if not vals:
            continue
        w2c = np.eye(4)
        w2c[:3, :] = np.asarray(vals[7:], np.float64).reshape(3, 4)
        out.append((vals[0], vals[1:5], np.linalg.inv(w2c)))
    return out


def parse_pose_file(path: str):
    with open(path) as f:
        return parse_pose_lines(f.readlines()[1:])


def intrinsics_for_crop(fxfycxcy, orig_h: int, orig_w: int, size: int):
    """Pixel K after a centre crop to a square and a resize to ``size``."""
    fx, fy, cx, cy = fxfycxcy
    crop = min(orig_h, orig_w)
    r = size / crop
    dH, dW = (orig_h - crop) / 2.0, (orig_w - crop) / 2.0
    K = np.array([[orig_w * r * fx, 0.0, (orig_w * cx - dW) * r],
                  [0.0, orig_h * r * fy, (orig_h * cy - dH) * r],
                  [0.0, 0.0, 1.0]])
    return K, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]


def relative_poses(c2w: np.ndarray, tar_idx: int) -> np.ndarray:
    return (np.linalg.inv(c2w[tar_idx])[None] @ c2w).astype(np.float32)


def first_relative_poses(c2w: np.ndarray) -> np.ndarray:
    """Every pose relative to the first (CameraCtrl, zero first-frame scale)."""
    c2w = np.asarray(c2w, np.float64)
    abs2rel = np.linalg.inv(c2w[0])
    return np.concatenate([np.eye(4)[None], abs2rel[None] @ c2w[1:]], 0).astype(np.float32)


def ray_condition(intr: np.ndarray, c2w: np.ndarray, H: int, W: int) -> np.ndarray:
    """intr [V, 4] (fx, fy, cx, cy), c2w [V, 4, 4] -> [V, H, W, 6] = (o x d, d)."""
    dtype = c2w.dtype
    j = np.arange(H, dtype=dtype) + 0.5
    i = np.arange(W, dtype=dtype) + 0.5
    jj, ii = np.meshgrid(j, i, indexing="ij")
    ii, jj = ii.reshape(1, H * W), jj.reshape(1, H * W)
    fx, fy, cx, cy = [intr[:, k:k + 1] for k in range(4)]
    d = np.stack([(ii - cx) / fx, (jj - cy) / fy, np.ones_like(ii - cx)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rays_d = np.einsum("vnk,vjk->vnj", d, c2w[:, :3, :3])
    rays_o = np.broadcast_to(c2w[:, None, :3, 3], rays_d.shape)
    return np.concatenate([np.cross(rays_o, rays_d), rays_d], -1).reshape(-1, H, W, 6)


def fold_indices(n: int) -> np.ndarray:
    i = np.arange(n)
    return np.concatenate([n - 1 - i, n - 1 + i])


def _k_inverse(K: np.ndarray) -> np.ndarray:
    fx, s, cx, fy, cy = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2], K[..., 1, 1], K[..., 1, 2]
    z, one = np.zeros_like(fx), np.ones_like(fx)
    return np.stack([np.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1),
                     np.stack([z, 1.0 / fy, -cy / fy], -1),
                     np.stack([z, z, one], -1)], -2)


def _fundamental(src_c2w, dst_c2w, K_src, K_dst) -> np.ndarray:
    """F with p_dst^T F p_src = 0: K_dst^-T R [t_e]x K_src^-1, where (R, t)
    maps source-camera to destination-camera coordinates and t_e = -R^T t."""
    Rd, td = dst_c2w[..., :3, :3], dst_c2w[..., :3, 3]
    Rdt = np.swapaxes(Rd, -1, -2)
    top = np.concatenate([Rdt, -np.einsum("...ij,...j->...i", Rdt, td)[..., None]], -1)
    bottom = np.broadcast_to(np.asarray([0.0, 0.0, 0.0, 1.0], dst_c2w.dtype),
                             dst_c2w.shape[:-2] + (1, 4))
    T = np.einsum("...ij,...jk->...ik", np.concatenate([top, bottom], -2), src_c2w)
    R, t = T[..., :3, :3], T[..., :3, 3]
    e = -np.einsum("...ji,...j->...i", R, t)
    z = np.zeros_like(e[..., 0])
    cross = np.stack([np.stack([z, -e[..., 2], e[..., 1]], -1),
                      np.stack([e[..., 2], z, -e[..., 0]], -1),
                      np.stack([-e[..., 1], e[..., 0], z], -1)], -2)
    E = np.einsum("...ij,...jk->...ik", R, cross)
    return np.einsum("...ij,...jk,...kl->...il", np.swapaxes(_k_inverse(K_dst), -1, -2), E,
                     _k_inverse(K_src))


def folded_pair_F_mats(c2w: np.ndarray, K: np.ndarray, n: int) -> np.ndarray:
    """[2n-1] clip poses -> [2n, 3, 3]: view 1 frame (n-1-i) to view 2 frame
    (n-1+i), then the transposes for the way back."""
    s, t = n - 1 - np.arange(n), n - 1 + np.arange(n)
    F = np.asarray(_fundamental(c2w[s], c2w[t], K[s], K[t])).astype(np.float32)
    return np.concatenate([F, np.transpose(F, (0, 2, 1))], 0)


def pair_conditioning(pose_file_0: str, pose_file_1: str, n: int, size: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Two trajectories -> (Plucker [2, n, size, size, 6], F mats [2, n, 3, 3]):
    the second reversed, each relative to its own first pose, spliced at a
    shared start and folded (the released validation loader)."""
    def load(path):
        cams = parse_pose_file(path)[:n]
        if len(cams) < n:
            raise ValueError(f"{path}: {len(cams)} poses, need {n}")
        return cams

    cams0, cams1 = load(pose_file_0), list(reversed(load(pose_file_1)))

    def unpack(cams):
        Ks, intr = zip(*(intrinsics_for_crop(c[1], SOURCE_H, SOURCE_W, size) for c in cams))
        return np.array([c[2] for c in cams]), np.array(Ks), np.array(intr)

    c2w0, K0, i0 = unpack(cams0)
    c2w1, _, i1 = unpack(cams1)
    c2w0, c2w1 = first_relative_poses(c2w0), first_relative_poses(c2w1)
    c2w = np.concatenate([c2w0[1:][::-1], c2w1], 0)
    K = np.concatenate([K0[1:][::-1], K0], 0)
    intr = np.concatenate([i0[1:][::-1], i1], 0).astype(np.float32)
    plucker = ray_condition(intr, c2w.astype(np.float32), size, size)[fold_indices(n)]
    return plucker.reshape(2, n, size, size, 6), folded_pair_F_mats(c2w, K, n).reshape(2, n, 3, 3)


# ---- the soft epipolar bias ---------------------------------------------

def pixel_grid_coords(feat: int, F_size: int, device) -> torch.Tensor:
    """Homogeneous pixel-centre coords [feat^2, 3] at the F matrices' scale."""
    r = torch.arange(feat, device=device, dtype=torch.float32)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    scale = F_size / feat
    xy = torch.stack([xs, ys], -1).reshape(-1, 2) * scale + (scale - 1.0) / 2.0
    return torch.cat([xy, torch.ones_like(xy[:, :1])], -1)


def pseudo_lines(coords: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """Lines of angle ``slope`` through each coordinate: (cos, sin, -(cos x + sin y))."""
    x, y = coords[..., 0], coords[..., 1]
    a = torch.cos(slope)[..., None].expand(x.shape)
    b = torch.sin(slope)[..., None].expand(x.shape)
    return torch.stack([a, b, -(a * x + b * y)], -1)


def epipolar_bias(F_mats: torch.Tensor, feat: int, F_size: int, video_length: int,
                  slope: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, Q, Q] additive bias (<= 0) of the epi attention on a feat x feat
    grid: lines l_q = F x_q; each video's first frame takes pseudo lines of
    one shared random slope (horizontal lines without one); a distance band
    of 3 / (F_size // 2) times the largest |l' . x| over the grid's corners,
    and a decay of 3 / band beyond it."""
    device = F_mats.device
    coords = pixel_grid_coords(feat, F_size, device)
    B = F_mats.shape[0]
    lines = torch.einsum("bij,qj->bqi", F_mats.float(), coords)
    if slope is None:
        ff = torch.stack([torch.zeros_like(coords[:, 0]), -torch.ones_like(coords[:, 0]),
                          coords[:, 1]], -1)[None]
    else:
        ff = pseudo_lines(coords[None], slope.reshape(1).float())
    first = (torch.arange(B, device=device) % video_length == 0)[:, None, None]
    lines = torch.where(first, ff, lines)
    norm = lines / (torch.sqrt((lines[..., :2] ** 2).sum(-1, keepdim=True)) + EPS)
    lo = (F_size / feat - 1.0) / 2.0
    hi = (feat - 1.0) * F_size / feat + lo
    corners = torch.tensor([[lo, lo, 1.0], [lo, hi, 1.0], [hi, lo, 1.0], [hi, hi, 1.0]],
                           device=device)
    band = 3.0 / (F_size // 2) * torch.abs(norm @ corners.T).amax(dim=(-1, -2))
    alpha = 3.0 / (band + EPS)
    dist = torch.abs(norm @ coords.T)
    bias = -torch.clamp(dist - band[:, None, None], min=0.0) * alpha[:, None, None]
    return torch.nan_to_num(bias, nan=0.0, posinf=0.0, neginf=0.0)
