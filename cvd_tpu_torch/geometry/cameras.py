"""RealEstate10K camera parsing and intrinsics handling (host-side numpy).

Pose text format (reference ``Camera``,
``animatediff/data/dataset_train_realestate10k.py:145-157``): first line is
the clip URL; each following line is
``timestamp fx fy cx cy _ _ <12 row-major w2c floats>``
with fx/fy/cx/cy normalized by image size. Despite the name, the stored
3x4 matrices behave as c2w in practice only after inversion — the loader
keeps both, matching the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Camera:
    cid: float
    fx: float
    fy: float
    cx: float
    cy: float
    w2c: np.ndarray  # [4, 4]
    c2w: np.ndarray  # [4, 4]

    @classmethod
    def from_entry(cls, entry: Sequence[float]) -> "Camera":
        cid = entry[0]
        fx, fy, cx, cy = entry[1:5]
        w2c = np.eye(4)
        w2c[:3, :] = np.asarray(entry[7:], dtype=np.float64).reshape(3, 4)
        return cls(cid, fx, fy, cx, cy, w2c, np.linalg.inv(w2c))


def parse_pose_lines(lines: Sequence[str]) -> List[Camera]:
    """Parse the per-frame lines of a RealEstate10K pose file (header removed)."""
    cams = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        cams.append(Camera.from_entry([float(x) for x in line.split(" ")]))
    return cams


def parse_pose_file(path: str) -> List[Camera]:
    """Parse a pose .txt file; the first line (URL header) is skipped."""
    with open(path, "r") as f:
        lines = f.readlines()
    return parse_pose_lines(lines[1:])


def intrinsics_for_crop(
    cam: Camera, orig_h: int, orig_w: int, sample_size: int
) -> Tuple[np.ndarray, List[float]]:
    """Pixel-space K after centre-crop-to-square + resize to sample_size.

    Matches dataset_train_realestate10k.py:420-424: normalized (fx, fy,
    cx, cy) are scaled by the original image size, shifted by the crop
    offset, then rescaled to the sample resolution.
    Returns (K [3,3], [fx, fy, cx, cy]).
    """
    crop = min(orig_h, orig_w)
    rescale = sample_size / crop
    dH, dW = (orig_h - crop) / 2.0, (orig_w - crop) / 2.0
    K = np.array(
        [
            [orig_w * rescale * cam.fx, 0.0, (orig_w * cam.cx - dW) * rescale],
            [0.0, orig_h * rescale * cam.fy, (orig_h * cam.cy - dH) * rescale],
            [0.0, 0.0, 1.0],
        ]
    )
    return K, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]


def relative_poses(c2w_list: np.ndarray, tar_idx: int = 0) -> np.ndarray:
    """Re-express c2w poses relative to the pose at ``tar_idx``
    (dataset_train_realestate10k.py:289-292)."""
    c2w_list = np.asarray(c2w_list)
    abs2rel = np.linalg.inv(c2w_list[tar_idx])
    return (abs2rel[None] @ c2w_list).astype(np.float32)


def get_relative_pose(c2w_list: np.ndarray, zero_first_frame_scale: bool) -> np.ndarray:
    """CameraCtrl-style relative normalization (inference_epi_advanced.py:55-72).

    The first camera is re-based to a canonical pose sitting
    ``cam_to_origin`` below the origin along -y, where ``cam_to_origin`` is
    the first camera's distance from the world origin — or 0 when
    ``zero_first_frame_scale`` is set, which collapses to the plain
    identity-first normalization. The released launch scripts always pass
    the flag (run_inference_simple.sh:25).
    """
    c2w_list = np.asarray(c2w_list, np.float64)
    w2c_list = np.linalg.inv(c2w_list)
    source_c2w = c2w_list[0]
    cam_to_origin = 0.0 if zero_first_frame_scale else float(
        np.linalg.norm(source_c2w[:3, 3])
    )
    target_cam_c2w = np.array([
        [1, 0, 0, 0],
        [0, 1, 0, -cam_to_origin],
        [0, 0, 1, 0],
        [0, 0, 0, 1],
    ], np.float64)
    abs2rel = target_cam_c2w @ w2c_list[0]
    ret = np.concatenate(
        [target_cam_c2w[None], abs2rel[None] @ c2w_list[1:]], axis=0
    )
    return ret.astype(np.float32)
