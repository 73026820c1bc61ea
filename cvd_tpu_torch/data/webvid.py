"""Pose-free (WebVid-style) training data and the hybrid mixer (port of
``cvd_tpu/data/webvid.py``).

The reference's ``dataset_webvid10m_remote`` / ``dataset_hybrid_remote`` are
absent from its release; only their call-site contract survives
(train_epi_control.py:79-89, 532-545): pose-free batches carry ``H_mats``
[2F, 3, 3] (pseudo-epipolar homographies) and ``warped_masks`` that mask the
MSE to valid warped pixels, and disable the image LoRA. The second "view"
of an unposed clip is a random-homography warp of the first: H relates the
two pixel grids, so the epi module gets homography-consistent pseudo
epipolar lines, and the mask marks the pixels that stayed inside the frame.

``homography_pair`` makes the pair from frames already in memory (numpy
only); ``WebVidFolded`` reads the frames from PNG / JPEG files (PIL) and
hands them to it.
"""
from __future__ import annotations

import glob
import json
import os
import random
from typing import Optional

import numpy as np


def random_homography(rng: random.Random, size: int, max_rot: float = 0.05,
                      max_trans: float = 0.08, max_persp: float = 2e-4) -> np.ndarray:
    """A small random homography in centred pixel coordinates (f64 [3, 3])."""
    ang = rng.uniform(-max_rot, max_rot)
    tx = rng.uniform(-max_trans, max_trans) * size
    ty = rng.uniform(-max_trans, max_trans) * size
    p1 = rng.uniform(-max_persp, max_persp)
    p2 = rng.uniform(-max_persp, max_persp)
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, -s, tx], [s, c, ty], [p1, p2, 1.0]], np.float64)


def warp_homography(img: np.ndarray, H: np.ndarray) -> tuple:
    """Inverse-warp img [Hh, Ww, C] by H (centred coordinates), nearest
    sampling. -> (warped, valid mask f32 [Hh, Ww])."""
    Hh, Ww = img.shape[:2]
    half = (Ww - 1) / 2.0
    ys, xs = np.mgrid[0:Hh, 0:Ww].astype(np.float64)
    pts = np.stack([xs - half, ys - half, np.ones_like(xs)], -1)   # destination
    src = pts @ np.linalg.inv(H).T
    src = src[..., :2] / (src[..., 2:] + 1e-8) + half
    x0 = np.round(src[..., 0]).astype(int)
    y0 = np.round(src[..., 1]).astype(int)
    valid = (x0 >= 0) & (x0 < Ww) & (y0 >= 0) & (y0 < Hh)
    out = img[np.clip(y0, 0, Hh - 1), np.clip(x0, 0, Ww - 1)]
    out[~valid] = 0.0
    return out, valid.astype(np.float32)


def min_pool_mask(mask: np.ndarray, factor: int = 8) -> np.ndarray:
    """[F, H, W] -> [F, H/f, W/f]: a latent pixel is valid only where every
    image pixel it covers is (train_epi_control.py:540-542)."""
    F, H, W = mask.shape
    return mask.reshape(F, H // factor, factor, W // factor, factor).min(axis=(2, 4))


def homography_pair(frames: np.ndarray, rng: random.Random) -> dict:
    """frames [F, S, S, 3] in [-1, 1] -> the folded pseudo-pair: one
    homography H drawn from ``rng``, ``pixel_values`` [2F, S, S, 3] (the
    frames, then their warps), ``H_mats`` [2F, 3, 3] f32 (H for the first F
    rows, H^-1 for the rest: view-2 pixels map back) and ``warped_masks``
    [2F, S/8, S/8, 1] f32 (all ones for the first view)."""
    n, size = frames.shape[0], frames.shape[1]
    H = random_homography(rng, size)
    warped, masks = zip(*(warp_homography(f, H) for f in frames))
    masks = np.stack(masks)
    H_mats = np.tile(H[None].astype(np.float32), (2 * n, 1, 1))
    H_mats[n:] = np.linalg.inv(H).astype(np.float32)
    full_mask = np.concatenate([np.ones_like(masks), masks], axis=0)
    return {"pixel_values": np.concatenate([frames, np.stack(warped)], axis=0),
            "H_mats": H_mats,
            "warped_masks": min_pool_mask(full_mask, 8)[..., None].astype(np.float32)}


class WebVidFolded:
    """Unposed clips -> folded pseudo-pairs through homography warps.

    Root layout: ``<root>/videos/<clip>/<frame>.png`` (or .jpg) and
    ``<root>/captions.json`` ({clip: caption}; a clip without one is
    captioned by its name)."""

    def __init__(self, root_path: str, sample_n_frames: int = 16, sample_size: int = 256,
                 seed: Optional[int] = None):
        self.root = root_path
        self.n = sample_n_frames
        self.size = sample_size
        self.rng = random.Random(seed)
        cap_path = os.path.join(root_path, "captions.json")
        captions = {}
        if os.path.exists(cap_path):
            with open(cap_path) as f:
                captions = json.load(f)
        self.clips = [{"path": d, "caption": captions.get(os.path.basename(d),
                                                           os.path.basename(d))}
                      for d in sorted(glob.glob(os.path.join(root_path, "videos", "*")))]

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, idx: int) -> dict:
        from PIL import Image

        from cvd_tpu_torch.data.realestate10k import _transform_frame

        entry = self.clips[idx]
        frames = sorted(glob.glob(os.path.join(entry["path"], "*.png"))
                        + glob.glob(os.path.join(entry["path"], "*.jpg")))
        if len(frames) < self.n:
            raise ValueError(f"{entry['path']}: {len(frames)} frames, a pair needs {self.n}")
        start = self.rng.randint(0, len(frames) - self.n)
        imgs = []
        for path in frames[start:start + self.n]:
            with Image.open(path) as im:
                imgs.append(_transform_frame(im, self.size))
        return {**homography_pair(np.stack(imgs), self.rng), "text": entry["caption"]}


class HybridDataset:
    """Posed RealEstate10K pairs mixed with unposed WebVid pseudo-pairs (the
    reference's missing dataset_hybrid_remote, train_epi_control.py:85-89):
    each item comes from ``dataset_a`` with probability ``ratio_a`` (drawn
    from its own ``random.Random(seed)``) and keeps that dataset's
    conditioning keys. The training CLI keeps its steps kind-homogeneous
    instead (one source drawn per step); this mixer is for code that wants
    mixed items."""

    def __init__(self, dataset_a, dataset_b, ratio_a: float = 0.5,
                 seed: Optional[int] = None, length: Optional[int] = None):
        self.a, self.b = dataset_a, dataset_b
        self.ratio_a = ratio_a
        self.rng = random.Random(seed)
        self.length = length or (len(dataset_a) + len(dataset_b))

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> dict:
        if self.rng.random() < self.ratio_a:
            return self.a[idx % len(self.a)]
        return self.b[idx % len(self.b)]
