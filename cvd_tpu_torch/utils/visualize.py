"""Camera trajectory plots and the epipolar sanity overlay (port of
``save_trajectory_plot`` and ``check_fundamental`` in
``cvd_tpu/utils/visualize.py``). ``check_fundamental`` is numpy only: the
training loop's first-step sanity dump and its validation draw it.
``save_trajectory_plot`` needs matplotlib, imported inside it
(``have_matplotlib`` says whether it can run)."""
from __future__ import annotations

import importlib.util
import os
import random
from typing import Optional

import numpy as np

OPENCV_TO_PLOT = np.asarray(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float64)


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def save_trajectory_plot(c2ws: np.ndarray, out_dir: str, frames_per_video: int,
                         hw_ratio: float = 1.0, base_xval: float = 0.035,
                         zval: float = 0.04) -> None:
    """Per video, a 3D plot of the camera frustums coloured by frame index
    (``pose_img_{v}.png``) and the poses (``ret_c2w_{v}.npy``)
    (tools/visualize_trajectory.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    os.makedirs(out_dir, exist_ok=True)
    c2ws = np.asarray(c2ws).reshape(-1, frames_per_video, 4, 4)
    corners = np.array([[0, 0, 0, 1], [base_xval, -base_xval * hw_ratio, zval, 1],
                        [base_xval, base_xval * hw_ratio, zval, 1],
                        [-base_xval, base_xval * hw_ratio, zval, 1],
                        [-base_xval, -base_xval * hw_ratio, zval, 1]])
    for vid, traj in enumerate(c2ws):
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        for fi, c2w in enumerate(traj):
            pts = ((c2w @ OPENCV_TO_PLOT) @ corners.T).T[:, :3]
            faces = [[pts[0], pts[1], pts[2]], [pts[0], pts[2], pts[3]],
                     [pts[0], pts[3], pts[4]], [pts[0], pts[4], pts[1]],
                     [pts[1], pts[2], pts[3], pts[4]]]
            color = cm.rainbow(fi / max(len(traj) - 1, 1))
            ax.add_collection3d(Poly3DCollection(faces, facecolors=color, alpha=0.3,
                                                 linewidths=0.3))
        ax.set_xlim(-1, 1), ax.set_ylim(-1, 1), ax.set_zlim(-1, 1)
        fig.savefig(os.path.join(out_dir, f"pose_img_{vid}.png"), dpi=120)
        plt.close(fig)
        np.save(os.path.join(out_dir, f"ret_c2w_{vid}.npy"), traj)


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
