"""Pose-only validation dataset: two RealEstate10K pose files -> one folded
2-view conditioning bundle per prompt.

Re-derivation of ``animatediff/data/dataset_validation.py:146-299``: load
both trajectories, reverse the second, re-express each relative to its own
first pose, splice into a 2N-1 pose list sharing the start frame, then fold
into two N-frame trajectories with per-frame fundamental matrices. Pure
numpy + the geometry core; ``__getitem__`` is the span
``data.pose_conditioning`` (``utils/tracing.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from cvd_tpu_torch.geometry.cameras import (
    get_relative_pose, intrinsics_for_crop, parse_pose_file,
)
from cvd_tpu_torch.geometry.folding import fold_indices, folded_pair_F_mats
from cvd_tpu_torch.geometry.plucker import ray_condition
from cvd_tpu_torch.utils import tracing

# RealEstate10K source video resolution assumed by the reference (:202)
SOURCE_H, SOURCE_W = 1280, 720


def load_pair_cameras(
    pose_file_0: str, pose_file_1: str, sample_size: int,
    n_frames: Optional[int] = None, zero_first_frame_scale: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (c2w [2N-1,4,4], K [2N-1,3,3], intrinsics [2N-1,4]); second file is
    reversed, both normalized to a shared identity start (:180-240).

    Each file is truncated to ``n_frames`` first — the reference implicitly
    requires file length == sample_n_frames so the shared start (index N-1
    after splicing) is the identity pose.
    """
    cams_0 = parse_pose_file(pose_file_0)
    cams_1 = parse_pose_file(pose_file_1)
    if n_frames is not None:
        if len(cams_0) < n_frames or len(cams_1) < n_frames:
            raise ValueError(f"pose files need >= {n_frames} frames, got "
                             f"{len(cams_0)} and {len(cams_1)}")
        cams_0, cams_1 = cams_0[:n_frames], cams_1[:n_frames]
    cams_1 = list(reversed(cams_1))

    def unpack(cams):
        c2ws, Ks, intr = [], [], []
        for cam in cams:
            K, ii = intrinsics_for_crop(cam, SOURCE_H, SOURCE_W, sample_size)
            c2ws.append(cam.c2w)
            Ks.append(K)
            intr.append(ii)
        return np.array(c2ws), np.array(Ks), np.array(intr)

    c2w_0, K_0, intr_0 = unpack(cams_0)
    c2w_1, K_1, intr_1 = unpack(cams_1)
    # zero_first_frame_scale=True collapses to identity-first relative
    # normalization; False keeps the first camera's distance from the world
    # origin (CameraCtrl semantics, inference_epi_advanced.py:55-72)
    c2w_0 = get_relative_pose(c2w_0, zero_first_frame_scale)
    c2w_1 = get_relative_pose(c2w_1, zero_first_frame_scale)
    c2w = np.concatenate([c2w_0[1:][::-1], c2w_1], axis=0)
    # reference forces both K tracks to file-0's (dataset_validation.py:239-241)
    K = np.concatenate([K_0[1:][::-1], K_0], axis=0)
    intr = np.concatenate([intr_0[1:][::-1], intr_1], axis=0)
    return c2w, K, intr


@dataclasses.dataclass
class ValRealEstate10KPoseFolded:
    validation_prompts: Sequence[str]
    pose_file_0: str
    pose_file_1: str
    validation_negative_prompts: Optional[Sequence[str]] = None
    sample_n_frames: int = 16
    sample_size: int = 256
    zero_first_frame_scale: bool = True  # launch scripts pass the flag

    def __len__(self) -> int:
        return len(self.validation_prompts)

    def __getitem__(self, idx: int) -> dict:
        with tracing.span("data.pose_conditioning"):
            n = self.sample_n_frames
            c2w, K, intr = load_pair_cameras(
                self.pose_file_0, self.pose_file_1, self.sample_size, n_frames=n,
                zero_first_frame_scale=self.zero_first_frame_scale,
            )

            F_mats = folded_pair_F_mats(c2w, K, n)  # [2n, 3, 3]
            fold = fold_indices(n)
            # rays are per frame, so the cameras are folded, not the rays
            plucker = ray_condition(intr[fold][None].astype(np.float32),
                                    c2w[fold][None].astype(np.float32),
                                    self.sample_size, self.sample_size)[0]
            sample = {
                "validation_prompt": self.validation_prompts[idx],
                "plucker_embedding": plucker,  # [2n, H, W, 6]
                "F_mats": F_mats,
                "ret_c2w": c2w[fold].astype(np.float32),
                "ret_K_mats": K[fold].astype(np.float32),
            }
            if self.validation_negative_prompts is not None:
                sample["validation_negative_prompt"] = self.validation_negative_prompts[idx]
            return sample
