"""Epipolar sanity overlay (port of ``check_fundamental`` in
``cvd_tpu/utils/visualize.py``; numpy only). The training loop's first-step
sanity dump draws it from the training batch."""
from __future__ import annotations

import random
from typing import Optional

import numpy as np


def check_fundamental(image_1: np.ndarray, image_2: np.ndarray, F_mat: np.ndarray,
                      n_points: int = 10, rng: Optional[random.Random] = None) -> np.ndarray:
    """Random points in view 1 and their epipolar lines in view 2.

    images: [H, W, 3] float in [0, 1] or [-1, 1]; returns the side-by-side
    uint8 image (lines rasterized directly, no cv2)."""
    rng = rng or random.Random(0)

    def to_u8(img):
        img = np.asarray(img, np.float32)
        if img.min() < -0.01:
            img = (img + 1) / 2
        return (np.clip(img, 0, 1) * 255).astype(np.uint8).copy()

    img1, img2 = to_u8(image_1), to_u8(image_2)
    H, W, _ = img1.shape
    yy, xx = np.ogrid[:H, :W]
    for _ in range(n_points):
        color = [rng.randrange(256) for _ in range(3)]
        x, y = rng.randrange(W), rng.randrange(H)
        a, b, c = np.asarray(F_mat, np.float64) @ np.array([x, y, 1.0])
        img1[(yy - y) ** 2 + (xx - x) ** 2 <= 25] = color
        if np.abs(F_mat).max() >= 1e-3 and (abs(a) + abs(b)) > 1e-8:
            dist = np.abs(a * xx + b * yy + c) / np.hypot(a, b)
            img2[dist < 1.5] = color
    return np.concatenate([img1, img2], axis=1)
