"""The "folded video" trick: one real clip -> two synthetic co-starting videos.

The reference samples 2N-1 frames of a clip, treats frame N-1 as a shared
start, and folds indices [N-1-i] and [N-1+i] into two N-frame videos that
diverge from the common first frame (dataset_train_realestate10k.py:399-464).
"""
from __future__ import annotations

import numpy as np


def fold_indices(n_frames: int) -> np.ndarray:
    """Indices into a (2*n_frames - 1)-frame clip producing the folded pair.

    Returns [2*n_frames]: first half walks backwards from the centre frame,
    second half walks forwards (both start at index n_frames-1).
    """
    i = np.arange(n_frames)
    return np.concatenate([n_frames - 1 - i, n_frames - 1 + i])


def fold_fundamental_mats(F_mats: np.ndarray) -> np.ndarray:
    """Stack per-frame F with its transpose for the reverse direction.

    Matches dataset_train_realestate10k.py:458: the first video's frames map
    into the second via F; the second maps back via F^T.
    F_mats: [n_frames, 3, 3] -> [2*n_frames, 3, 3].
    """
    return np.concatenate([F_mats, np.transpose(F_mats, (0, 2, 1))], axis=0)


def folded_pair_F_mats(c2w: np.ndarray, K: np.ndarray, n_frames: int) -> np.ndarray:
    """Per-frame fundamental matrices between the two folded videos.

    For fold step i, view-1 frame is clip index (n-1-i) and view-2 frame is
    clip index (n-1+i); F maps view-1 pixels to view-2 epipolar lines
    (dataset_train_realestate10k.py:447-455), then folded with transposes.

    Args:
      c2w: [2n-1, 4, 4] clip poses; K: [2n-1, 3, 3].
    Returns [2n, 3, 3] float32.
    """
    from cvd_tpu_torch.geometry.epipolar import fundamental_between_views

    sids = n_frames - 1 - np.arange(n_frames)
    tids = n_frames - 1 + np.arange(n_frames)
    F = np.asarray(
        fundamental_between_views(c2w[sids], c2w[tids], K[sids], K[tids])
    ).astype(np.float32)
    return fold_fundamental_mats(F)
