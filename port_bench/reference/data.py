"""The released RealEstate10K training reader, for the reference's steps:
which clip and frames a seeded epoch draws, and the folded pair made of
them (2n-1 frames at a stride, the centre frame shared, resized and centre
cropped, Plucker rays and per-frame fundamental matrices)."""
from __future__ import annotations

import glob
import json
import os
import random
from typing import List

import numpy as np

from .geometry import (fold_indices, folded_pair_F_mats, intrinsics_for_crop, parse_pose_file,
                       ray_condition, relative_poses)


def clips(root: str) -> List[dict]:
    caps = {}
    for name in ("train_captions.json", "test_captions.json"):
        p = os.path.join(root, "annotation_json", name)
        if os.path.exists(p):
            with open(p) as f:
                caps.update(json.load(f))
    out = []
    for pose_file in sorted(glob.glob(os.path.join(root, "RealEstate10K", "train", "*.txt"))):
        clip = os.path.basename(pose_file)[:-4]
        if clip + ".mp4" in caps:
            out.append({"frames": os.path.join(root, "dataset", "train", clip),
                        "pose_file": pose_file, "caption": caps[clip + ".mp4"][0]})
    return out


def first_draws(root: str, seed: int, n_frames: int, stride: int, count: int) -> List[dict]:
    """The first ``count`` samples of epoch 0 of a loader and reader seeded
    ``seed`` (batch 1): the clip order is the seeded permutation of the
    clips, and each sample's first frame a uniform draw of the reader's
    ``random.Random(seed)``, in sample order."""
    table = clips(root)
    order = np.random.default_rng(seed).permutation(len(table))
    rng = random.Random(seed)
    out = []
    for idx in order[:count]:
        entry = table[int(idx)]
        cams = parse_pose_file(entry["pose_file"])
        length = 2 * n_frames - 1
        s = max(min(len(cams) // length, stride), 1)
        span = min(len(cams), (length - 1) * s + 1)
        start = rng.randint(0, len(cams) - span)
        ids = np.linspace(start, start + span - 1, length).astype(int)
        out.append(dict(entry, frame_ids=ids))
    return out


def _frame(path: str, size: int):
    from PIL import Image

    with Image.open(path) as im:
        W0, H0 = im.size
        img = im.convert("RGB")
        scale = size / min(W0, H0)
        img = img.resize((round(W0 * scale), round(H0 * scale)), Image.BILINEAR)
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
        return np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0, H0, W0


def folded_pair(draw: dict, n_frames: int, size: int) -> dict:
    """-> pixel_values [2, n, H, W, 3] in [-1, 1], plucker [2, n, H, W, 6],
    F_mats [2, n, 3, 3], caption."""
    cams = parse_pose_file(draw["pose_file"])
    imgs, c2ws, Ks, intr = [], [], [], []
    for fid in draw["frame_ids"]:
        stamp, fxfycxcy, c2w = cams[fid]
        img, H0, W0 = _frame(os.path.join(draw["frames"], "%d.png" % int(stamp)), size)
        K, ii = intrinsics_for_crop(fxfycxcy, H0, W0, size)
        imgs.append(img)
        c2ws.append(c2w)
        Ks.append(K)
        intr.append(ii)
    c2w = relative_poses(np.array(c2ws), n_frames - 1)
    K = np.array(Ks)
    plucker = ray_condition(np.array(intr, np.float32), c2w.astype(np.float32), size, size)
    fold = fold_indices(n_frames)

    def pair(x):
        return np.stack([x[:n_frames], x[n_frames:]])

    return {"pixel_values": pair(np.stack(imgs)[fold]), "plucker": pair(plucker[fold]),
            "F_mats": pair(folded_pair_F_mats(c2w, K, n_frames)), "caption": draw["caption"]}
