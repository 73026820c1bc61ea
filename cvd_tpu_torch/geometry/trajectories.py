"""Procedural camera trajectories of the N-view sampler (host-side numpy;
port of ``cvd_tpu/geometry/trajectories.py``): the ``circle``,
``upper_hemi`` and ``interpolate`` camera patterns
(``inference_epi_advanced.py:110-128, 296-345``) and the dataset's pose
interpolation (``dataset_train_realestate10k.py:365-384``). Rotations are
interpolated with scipy's ``Slerp``. The optional perturbation of a
trajectory's end point is drawn from the ``np.random.Generator`` the caller
passes: there is no global RNG.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


def _look_at_pose(cam_at: np.ndarray, look_at: np.ndarray) -> np.ndarray:
    """c2w with +z toward look_at, x re-orthogonalized from world +x.

    Matches inference_epi_advanced.py:312-319 (columns = [x, y, z]).
    """
    cam_z = look_at - cam_at
    cam_x = np.array([1.0, 0.0, 0.0])
    cam_y = np.cross(cam_z, cam_x)
    cam_y = cam_y / (np.linalg.norm(cam_y) + 1e-6)
    cam_x = np.cross(cam_y, cam_z)
    cam_x = cam_x / (np.linalg.norm(cam_x) + 1e-6)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([cam_x, cam_y, cam_z], axis=1)
    pose[:3, 3] = cam_at
    return pose


def interpolate_pose(
    src_pose: np.ndarray,
    tgt_pose: np.ndarray,
    split_num: int,
    perturb_traj_norm: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Lerp translation / slerp rotation between two poses -> [split_num,4,4].

    Matches inference_epi_advanced.py:110-128 incl. the optional gaussian
    perturbation of the target translation.
    """
    ret = np.repeat(src_pose[None], split_num, axis=0)
    perturb_t = 0.0
    if perturb_traj_norm:
        if rng is None:
            raise ValueError("a perturbed trajectory needs an np.random.Generator")
        perturb_t = perturb_traj_norm * rng.standard_normal(3)
    alphas = np.arange(split_num) / (split_num - 1)
    ret[:, :3, 3] = (
        src_pose[:3, 3][None] * (1 - alphas[:, None])
        + (tgt_pose[:3, 3] + perturb_t)[None] * alphas[:, None]
    )
    sl = Slerp(
        [0, 1],
        Rotation.concatenate(
            [Rotation.from_matrix(src_pose[:3, :3]), Rotation.from_matrix(tgt_pose[:3, :3])]
        ),
    )
    ret[:, :3, :3] = sl(np.linspace(0, 1, split_num)).as_matrix()
    return ret


def interpolate_pose_batch(
    src_poses: np.ndarray, tgt_poses: np.ndarray, split_num: int
) -> np.ndarray:
    """Per-frame pose interpolation across split_num synthetic trajectories.

    Matches RealEstate10KPoseFolded.interpolate_poses
    (dataset_train_realestate10k.py:365-384): output [split_num*F, 4, 4]
    where block i blends src->tgt at alpha = i/(split_num-1).
    """
    frame_num = len(src_poses)
    ret = np.tile(src_poses, (split_num, 1, 1))
    for i in range(split_num):
        alpha = i / (split_num - 1)
        ret[i * frame_num : (i + 1) * frame_num, :3, 3] = (
            src_poses[:, :3, 3] * (1 - alpha) + tgt_poses[:, :3, 3] * alpha
        )
    for fid in range(frame_num):
        sl = Slerp(
            [0, 1],
            Rotation.concatenate(
                [
                    Rotation.from_matrix(src_poses[fid, :3, :3]),
                    Rotation.from_matrix(tgt_poses[fid, :3, :3]),
                ]
            ),
        )
        ret[fid::frame_num, :3, :3] = sl(np.linspace(0, 1, split_num)).as_matrix()
    return ret


def _pattern_trajectories(
    view_num: int,
    video_length: int,
    camera_dist: float,
    angles: np.ndarray,
    perturb_traj: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    planar: bool = True,
) -> np.ndarray:
    c2ws = []
    look_at = np.array([0.0, 0.0, 1.0])
    for angle in angles:
        if planar:
            cam_at = np.array([math.cos(angle), math.sin(angle), 0.0]) * camera_dist
        else:
            cam_at = (
                np.array(
                    [math.cos(angle), math.cos(angle + 0.5) * 0.3, -math.sin(angle) * 0.2]
                )
                * camera_dist
            )
        tgt = _look_at_pose(cam_at, look_at)
        c2ws.append(interpolate_pose(np.eye(4), tgt, video_length, perturb_traj, rng))
    return np.concatenate(c2ws, axis=0)  # [view_num * video_length, 4, 4]


def circle_trajectory(
    view_num: int, video_length: int, camera_dist: float = 1.0, perturb_traj: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """`circle` pattern (inference_epi_advanced.py:329-343)."""
    angles = 2 * math.pi / view_num * np.arange(view_num)
    return _pattern_trajectories(view_num, video_length, camera_dist, angles, perturb_traj, rng)


def upper_hemi_trajectory(
    view_num: int, video_length: int, camera_dist: float = 1.0, perturb_traj: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """`upper_hemi` pattern (inference_epi_advanced.py:327-343)."""
    angles = math.pi / (view_num - 1) * np.arange(view_num) + math.pi
    return _pattern_trajectories(view_num, video_length, camera_dist, angles, perturb_traj, rng)


def interpolate_trajectories(
    view_num: int, video_length: int, camera_dist: float = 1.0, perturb_traj: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """`interpolate` pattern (inference_epi_advanced.py:302-321)."""
    angles = math.pi / (view_num - 1) * np.arange(view_num)
    return _pattern_trajectories(
        view_num, video_length, camera_dist, angles, perturb_traj, rng, planar=False
    )


def default_intrinsics(
    view_num: int, video_length: int, image_height: int, image_width: int
) -> np.ndarray:
    """Fixed pinhole K used by the advanced entry point, scaled to resolution.

    Matches inference_epi_advanced.py:297-300.
    Returns [view_num*video_length, 3, 3].
    """
    K = np.array([[223.578, 0, 128], [0, 223.578, 128], [0, 0, 1]], dtype=np.float64)
    K = np.repeat(K[None], view_num * video_length, axis=0)
    K[:, 0] *= image_width / 256
    K[:, 1] *= image_height / 256
    return K
