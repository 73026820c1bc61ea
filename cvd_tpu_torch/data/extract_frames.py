"""Extract RealEstate10K mp4 clips to the per-frame png layout (port of
``cvd_tpu/data/extract_frames.py``).

    python -m cvd_tpu_torch.data.extract_frames --root <root> [--split train]

Input layout (what RealEstate10K downloads produce):
    <root>/RealEstate10K/<split>/<clip>.txt     pose files
    <root>/dataset/<split>/<clip>.mp4           videos

Output (the layout the reference's png path and ``data/realestate10k.py``
read):
    <root>/dataset/<split>/<clip>/<cid>.png     one png per pose line,
                                                named by the pose timestamp

Frame ordinal i of the mp4 is pose line i (the reference's decord reader
indexes by ordinal, dataset_train_realestate10k.py:386-460). Decoding needs
OpenCV and writing Pillow. ``RealEstate10KPoseFolded`` reads ``<clip>.mp4``
itself, so extracting is optional: it pays the decode once, and serves
tools that expect pngs.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def extract_clip(pose_file: str, mp4_path: str, out_dir: str,
                 overwrite: bool = False) -> int:
    """Write one png per pose line of ``pose_file`` under ``out_dir`` (those
    already there are kept unless ``overwrite``). Returns the pngs written."""
    from PIL import Image

    from cvd_tpu_torch.data.realestate10k import read_video_frames
    from cvd_tpu_torch.geometry.cameras import parse_pose_file

    targets = [(i, os.path.join(out_dir, "%d.png" % int(cam.cid)))
               for i, cam in enumerate(parse_pose_file(pose_file))]
    if not overwrite:
        targets = [(i, p) for i, p in targets if not os.path.exists(p)]
    if not targets:
        return 0
    os.makedirs(out_dir, exist_ok=True)
    frames, _ = read_video_frames(mp4_path, [i for i, _ in targets])
    for (_, path), frame in zip(targets, frames):
        Image.fromarray(np.asarray(frame)).save(path)
    return len(targets)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)

    txt_dir = os.path.join(args.root, "RealEstate10K", args.split)
    video_dir = os.path.join(args.root, "dataset", args.split)
    pose_files = sorted(glob.glob(os.path.join(txt_dir, "*.txt")))
    if not pose_files:
        raise SystemExit(f"no pose files under {txt_dir}")
    done = skipped = 0
    for pose_file in pose_files:
        clip = os.path.basename(pose_file)[: -len(".txt")]
        mp4 = os.path.join(video_dir, clip + ".mp4")
        if not os.path.exists(mp4):
            skipped += 1
            continue
        n = extract_clip(pose_file, mp4, os.path.join(video_dir, clip), overwrite=args.overwrite)
        done += 1
        print(f"[extract_frames] {clip}: {n} frames")
    print(f"[extract_frames] {done} clips extracted, {skipped} without mp4")


if __name__ == "__main__":
    main()
