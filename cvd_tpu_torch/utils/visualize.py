"""Camera trajectory plots, the epipolar sanity overlay and the learned
correspondences (port of ``cvd_tpu/utils/visualize.py``).
``check_fundamental`` and ``visualize_correspondence`` are numpy only: the
training loop's first-step sanity dump and its validation draw the first.
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


def visualize_correspondence(
    videos: np.ndarray,      # [2, F, H, W, 3] in [0, 1]
    aux: dict,               # one epi layer's {"query": [B*F, N, C], "key": [B*F, N, C]}
    F_mats: np.ndarray,      # [F, 3, 3] view 1 -> view 2 per frame
    frame: Optional[int] = None,
    n_points: int = 6,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """Debug image of the LEARNED cross-video correspondences (the
    reference's missing ``tools/visualize_correspondence``, called at
    train_epi_control.py:469 with (sample, aux, F_mats)): for a few query
    pixels of view 1, the argmax q.k match in view 2 from an epi attention's
    q / k maps (``UNet3DConditionModel(..., return_extras=True)``'s
    ``epi_qk`` entries, as numpy), drawn over the true epipolar line, on
    which a learned match should fall. Returns the side-by-side uint8 image
    of ``frame`` (default the middle one)."""
    rng = rng or random.Random(0)
    videos = np.asarray(videos, np.float32)
    _, F_len, H, W, _ = videos.shape
    f = F_len // 2 if frame is None else frame
    q = np.asarray(aux["query"], np.float32)
    k = np.asarray(aux["key"], np.float32)
    # rows are (video-major, frame): view 1's query row f attends to view 2's keys
    qf, kf = q[f], k[f]                        # [N, C] each
    N = qf.shape[0]
    feat = int(round(N ** 0.5))
    best = (qf @ kf.T).argmax(axis=1)          # each query's best key

    img1 = (np.clip(videos[0, f], 0, 1) * 255).astype(np.uint8).copy()
    img2 = (np.clip(videos[1, f], 0, 1) * 255).astype(np.uint8).copy()
    s = H / feat
    yy, xx = np.ogrid[:H, :W]
    Fm = np.asarray(F_mats, np.float64)[f]
    for _ in range(n_points):
        color = [rng.randrange(256) for _ in range(3)]
        qi = rng.randrange(N)
        qx, qy = (qi % feat + 0.5) * s, (qi // feat + 0.5) * s
        mx, my = (best[qi] % feat + 0.5) * s, (best[qi] // feat + 0.5) * s
        img1[(yy - qy) ** 2 + (xx - qx) ** 2 <= 25] = color
        img2[(yy - my) ** 2 + (xx - mx) ** 2 <= 25] = color
        a, b, c = Fm @ np.array([qx, qy, 1.0])
        if (abs(a) + abs(b)) > 1e-8:
            dist = np.abs(a * xx + b * yy + c) / np.hypot(a, b)
            img2[dist < 1.2] = color
    return np.concatenate([img1, img2], axis=1)
