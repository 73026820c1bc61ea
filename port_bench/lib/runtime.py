"""Device helpers shared by the entry kinds."""
from __future__ import annotations

import contextlib
import gc
import resource

import numpy as np


def sync(device) -> None:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev.index or 0)


def peak_bytes(device) -> int:
    """The device's peak allocated bytes since the process started (on the
    CPU: the process's peak resident size)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.max_memory_allocated(dev.index or 0))
    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024


def free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def exact_float32():
    """float32 products and convolutions without TF32, for the reference."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_uint8(videos: np.ndarray) -> np.ndarray:
    """[..., 3] float in [0, 1] -> uint8, as the 2-view CLI writes a video."""
    return (np.clip(np.asarray(videos), 0.0, 1.0) * 255).astype(np.uint8)


def frame_rmse_max(a: np.ndarray, b: np.ndarray) -> float:
    """The largest per-frame root-mean-square difference of two uint8
    videos [V, F, H, W, 3], in 8-bit levels."""
    d = a.astype(np.float64) - b.astype(np.float64)
    return float(np.sqrt((d ** 2).reshape(d.shape[0] * d.shape[1], -1).mean(1)).max())
