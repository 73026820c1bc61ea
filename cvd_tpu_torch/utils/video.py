"""Video export (port of ``cvd_tpu/utils/video.py``). Videos are always
written as a uint8 ``.npy``; mp4 / gif and png files are written only where
``imageio`` is installed (an mp4 becomes a gif without an ffmpeg plugin)."""
from __future__ import annotations

import importlib.util
import os
from typing import List

import numpy as np


def to_uint8(video: np.ndarray) -> np.ndarray:
    """[..., H, W, 3] float in [0, 1] -> uint8."""
    return (np.clip(np.asarray(video), 0.0, 1.0) * 255).astype(np.uint8)


def have_imageio() -> bool:
    return importlib.util.find_spec("imageio") is not None


def save_npy(videos: np.ndarray, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.save(path, to_uint8(videos))
    return path


def save_video(video: np.ndarray, path: str, fps: int = 8) -> None:
    """video [F, H, W, 3] in [0, 1] -> .mp4 (or .gif without ffmpeg)."""
    import imageio

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames = [to_uint8(f) for f in video]
    if path.endswith(".gif"):
        imageio.mimsave(path, frames, duration=1000 / fps, loop=0)
        return
    try:
        imageio.mimsave(path, frames, fps=fps)
    except (ValueError, RuntimeError, ImportError):
        # no ffmpeg backend: write a gif instead
        gif_path = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(gif_path, frames, duration=1000 / fps, loop=0)


def save_videos_grid(videos: np.ndarray, path: str, fps: int = 8, n_rows: int = 1) -> None:
    """videos [B, F, H, W, 3] in [0, 1] -> one tiled video file."""
    B, F, H, W, C = videos.shape
    cols = (B + n_rows - 1) // n_rows
    grid = np.zeros((F, H * n_rows, W * cols, C), videos.dtype)
    for b in range(B):
        r, c = divmod(b, cols)
        grid[:, r * H:(r + 1) * H, c * W:(c + 1) * W] = videos[b]
    save_video(grid, path, fps)


def save_video_as_images(video: np.ndarray, out_dir: str) -> List[str]:
    """video [F, H, W, 3] -> out_dir/%04d.png, returning paths."""
    import imageio

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, frame in enumerate(video):
        p = os.path.join(out_dir, f"{i:04d}.png")
        imageio.imwrite(p, to_uint8(frame))
        paths.append(p)
    return paths
