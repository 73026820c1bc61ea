"""RealEstate10K training dataset with the folded-video trick (port of
``cvd_tpu/data/realestate10k.py``).

Sample 2N-1 frames of one clip, treat the centre frame as the shared start,
fold into two N-frame videos diverging from it, and emit pixel values,
Plücker embeddings and per-frame fundamental matrices. Channels-last numpy
arrays: pixel_values [2N, H, W, 3] in [-1, 1], plucker [2N, H, W, 6].
Frames come from pre-extracted PNGs (PIL) or the clip's mp4 (OpenCV);
both are imported at use. Not ported: ``validation_video_split`` (needs
``geometry/trajectories.py``).
"""
from __future__ import annotations

import glob
import json
import os
import random
from typing import List, Optional

import numpy as np

from cvd_tpu_torch.geometry.cameras import intrinsics_for_crop, parse_pose_file, relative_poses
from cvd_tpu_torch.geometry.folding import fold_indices, folded_pair_F_mats
from cvd_tpu_torch.geometry.plucker import ray_condition


def _transform_frame(img, sample_size: int) -> np.ndarray:
    """Resize the short side, centre crop, scale to [-1, 1]. img: PIL
    Image or uint8 RGB array."""
    from PIL import Image

    if not isinstance(img, Image.Image):
        img = Image.fromarray(img)
    img = img.convert("RGB")
    w, h = img.size
    scale = sample_size / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
    w, h = img.size
    left, top = (w - sample_size) // 2, (h - sample_size) // 2
    img = img.crop((left, top, left + sample_size, top + sample_size))
    return np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0


def read_video_frames(path: str, indices) -> tuple:
    """Decode the given ORDINAL frames of a video with OpenCV -> (RGB uint8
    frames in the order of ``indices``, (H, W))."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    want = sorted({int(i) for i in indices})
    out, pos = {}, 0
    try:
        while want:
            if not cap.grab():
                break
            if pos == want[0]:
                ok, frame = cap.retrieve()
                if not ok:
                    break
                out[pos] = frame[..., ::-1].copy()  # BGR -> RGB
                want.pop(0)
            pos += 1
    finally:
        cap.release()
    if want:
        raise IOError(f"{path}: frames {want} past end of video ({pos} read)")
    first = out[next(iter(out))]
    return [out[int(i)] for i in indices], first.shape[:2]


class RealEstate10KPoseFolded:
    """root layout (the reference's, dataset_train_realestate10k.py:242-256):
      <root>/RealEstate10K/train/<clip>.txt        pose files
      <root>/dataset/train/<clip>/<cid>.png        extracted frames (or <clip>.mp4)
      <root>/annotation_json/{train,test}_captions.json
    """

    def __init__(self, root_path: str, sample_stride: int = 2, sample_n_frames: int = 16,
                 sample_size: int = 256, seed: Optional[int] = None):
        self.sample_stride = sample_stride
        self.sample_n_frames = sample_n_frames
        self.sample_size = sample_size
        self.rng = random.Random(seed)

        txt_dir = os.path.join(root_path, "RealEstate10K", "train")
        video_dir = os.path.join(root_path, "dataset", "train")
        captions = {}
        for name in ("train_captions.json", "test_captions.json"):
            p = os.path.join(root_path, "annotation_json", name)
            if os.path.exists(p):
                with open(p) as f:
                    captions.update(json.load(f))
        self.dataset: List[dict] = []
        for pose_file in sorted(glob.glob(os.path.join(txt_dir, "*.txt"))):
            clip = os.path.basename(pose_file)[: -len(".txt")]
            if clip + ".mp4" in captions:
                self.dataset.append({"clip_name": clip,
                                     "clip_path": os.path.join(video_dir, clip),
                                     "pose_file": pose_file,
                                     "caption": captions[clip + ".mp4"][0]})

    def __len__(self) -> int:
        return len(self.dataset)

    def _get_clip(self, idx: int) -> dict:
        entry = self.dataset[idx]
        cams = parse_pose_file(entry["pose_file"])
        n = self.sample_n_frames
        sample_length = 2 * n - 1
        total = len(cams)
        if total < sample_length:
            raise ValueError(f"{entry['pose_file']}: {total} cameras, a folded pair of "
                             f"{n} frames needs {sample_length}")
        stride = max(min(total // sample_length, self.sample_stride), 1)
        clip_length = min(total, (sample_length - 1) * stride + 1)
        start = self.rng.randint(0, total - clip_length)
        frame_ids = np.linspace(start, start + clip_length - 1, sample_length).astype(int)

        mp4_path = entry["clip_path"] + ".mp4"
        use_mp4 = not os.path.isdir(entry["clip_path"]) and os.path.exists(mp4_path)
        if use_mp4:
            raw_frames, (H0, W0) = read_video_frames(mp4_path, frame_ids)
        imgs, c2ws, Ks, intr = [], [], [], []
        for j, fid in enumerate(frame_ids):
            cam = cams[fid]
            if use_mp4:
                img = _transform_frame(raw_frames[j], self.sample_size)
            else:
                from PIL import Image

                with Image.open(os.path.join(entry["clip_path"], "%d.png" % int(cam.cid))) as im:
                    W0, H0 = im.size
                    img = _transform_frame(im, self.sample_size)
            K, ii = intrinsics_for_crop(cam, H0, W0, self.sample_size)
            imgs.append(img)
            c2ws.append(cam.c2w)
            Ks.append(K)
            intr.append(ii)

        c2w = relative_poses(np.array(c2ws), tar_idx=n - 1)
        K = np.array(Ks)
        intr = np.array(intr, np.float32)
        fold = fold_indices(n)
        plucker = ray_condition(intr[fold][None], c2w[fold][None].astype(np.float32),
                                self.sample_size, self.sample_size)[0]
        return {
            "pixel_values": np.stack(imgs)[fold],        # [2n, H, W, 3]
            "text": entry["caption"],
            "plucker_embedding": plucker,                # [2n, H, W, 6]
            "F_mats": folded_pair_F_mats(c2w, K, n),     # [2n, 3, 3]
            "ret_c2w": c2w[fold].astype(np.float32),
            "ret_K_mats": K[fold].astype(np.float32),
        }

    def __getitem__(self, idx: int) -> dict:
        # retry with a resampled clip (reference :488-499)
        for attempt in range(31):
            try:
                return self._get_clip(idx)
            except Exception:
                if attempt == 30:
                    raise
                idx = self.rng.randrange(len(self.dataset))
        raise RuntimeError("unreachable")
