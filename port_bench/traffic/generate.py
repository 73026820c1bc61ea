"""The one generator of the benchmark's traffic: it reads a mix's parameters
(``traffic/<mix>.json``) and makes the inputs of a run from ``--seed``.

* 2-view requests: a caption from the mix's list, the negative prompt, a
  pair of camera trajectories written as RealEstate10K pose files (seeded
  arcs and dollies: every seed draws the same sizes), and the seeds of the
  initial latents and of the request's generator.
* A synthetic RealEstate10K root for training, in the released reader's
  layout: PNG frames, pose files, caption JSON; made once per checkout
  from the mix's fixed data seed and reused.
* Token ids: a CRC-32 word hash, the same in every process (the models'
  weights are random, so a real vocabulary would add nothing).
"""
from __future__ import annotations

import json
import math
import os
import random
import shutil
import zlib
from typing import List, Sequence

import numpy as np

from port_bench.lib.names import BENCH_DIR

HERE = os.path.dirname(os.path.abspath(__file__))
MAX_LENGTH, BOS, EOS, VOCAB = 77, 49406, 49407, 49408


def tokenize(texts: Sequence[str]) -> np.ndarray:
    """[len(texts), 77] int32: BOS, one id per word, EOS padding."""
    out = np.full((len(texts), MAX_LENGTH), EOS, np.int32)
    for i, t in enumerate(texts):
        ids = [BOS] + [zlib.crc32(w.encode()) % (VOCAB - 3) + 1
                       for w in t.lower().split()][:MAX_LENGTH - 2] + [EOS]
        out[i, :len(ids)] = ids
    return out


def captions(mix: dict) -> List[str]:
    with open(os.path.join(HERE, mix["captions"])) as f:
        return [line.strip() for line in f if line.strip()]


def _yaw(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def trajectory(kind: str, n: int, rng: random.Random, scale: float = 1.0) -> List[np.ndarray]:
    """n camera-to-world 4x4 poses (camera looking along +z, y down):
    ``arc`` orbits a point 1.5-3 units ahead through 15-45 degrees,
    ``dolly`` moves 0.3-1 unit along the view with a sideways drift."""
    out = []
    if kind == "arc":
        sweep = math.radians(rng.uniform(15, 45)) * rng.choice((-1, 1)) * scale
        r = rng.uniform(1.5, 3.0)
        target = np.array([0.0, 0.0, r])
        for k in range(n):
            R = _yaw(sweep * k / (n - 1))
            c2w = np.eye(4)
            c2w[:3, :3] = R
            c2w[:3, 3] = target - R @ np.array([0.0, 0.0, r])
            out.append(c2w)
    elif kind == "dolly":
        dist = rng.uniform(0.3, 1.0) * rng.choice((-1, 1)) * scale
        drift = rng.uniform(-0.3, 0.3) * scale
        for k in range(n):
            c2w = np.eye(4)
            c2w[:3, 3] = [drift * k / (n - 1), 0.0, dist * k / (n - 1)]
            out.append(c2w)
    else:
        raise ValueError(f"trajectory kind {kind!r}: expected arc or dolly")
    return out


def pose_file_text(poses: Sequence[np.ndarray], fx: float, fy: float,
                   stamp: int = 33333) -> str:
    """RealEstate10K format: a URL line, then per frame ``timestamp fx fy cx
    cy 0 0`` and the 3x4 world-to-camera matrix, row-major."""
    lines = ["https://example.com/synthetic"]
    for k, c2w in enumerate(poses):
        w2c = np.linalg.inv(c2w)[:3].reshape(-1)
        lines.append(" ".join([str(k * stamp), f"{fx:.6f}", f"{fy:.6f}", "0.5", "0.5", "0",
                               "0"] + [f"{v:.9f}" for v in w2c]))
    return "\n".join(lines) + "\n"


def request(mix: dict, seed: int, caps: List[str]) -> dict:
    """One 2-view request of the mix from its own ``seed``: {"prompt",
    "negative", "poses": two pose-file texts, "latents_seed", "generator_seed"}."""
    rng = random.Random(seed)
    fx = rng.uniform(0.45, 0.55)
    n = mix["frames"]
    poses = [pose_file_text(trajectory(rng.choice(mix["trajectories"]), n, rng), fx,
                            fx * 1.778) for _ in range(2)]
    return {"prompt": rng.choice(caps), "negative": mix["negative_prompt"], "poses": poses,
            "latents_seed": rng.getrandbits(62), "generator_seed": rng.getrandbits(62)}


# ---- the synthetic RealEstate10K root -----------------------------------

def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth colour field: a few low-frequency sinusoids per channel."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        for _ in range(6):
            fy, fx = rng.uniform(0.002, 0.03, size=2)
            img[..., c] += rng.uniform(0.2, 1.0) * np.sin(fx * x + fy * y + rng.uniform(0, 6.3))
    img -= img.min()
    return (img / img.max() * 255).astype(np.uint8)


def re10k_root(mix: dict) -> str:
    """The mix's RealEstate10K root under ``port_bench/.data/``, made once
    (a ``complete`` file marks it done): ``RealEstate10K/train/<clip>.txt``,
    ``dataset/train/<clip>/<timestamp>.png``, ``annotation_json/
    train_captions.json``; written under another name and renamed into
    place when complete. The clips' frames come from ``frame_sets`` sets of
    PNGs (each clip's frame directory a link to one), so that the disk holds
    a few hundred MB while an epoch has ``clips`` steps."""
    from PIL import Image

    name = "re10k-{data_seed}-{clips}c{frame_sets}s{frames_per_clip}f-{width}x{height}".format(
        **mix)
    root = os.path.join(BENCH_DIR, ".data", name)
    if os.path.exists(os.path.join(root, "complete")):
        return root
    final, root = root, f"{root}.part{os.getpid()}"
    rng = random.Random(mix["data_seed"])
    nrng = np.random.default_rng(mix["data_seed"])
    caps = captions(mix)
    W, H, n = mix["width"], mix["height"], mix["frames_per_clip"]
    pad = n * 4
    for s in range(mix["frame_sets"]):
        frames = os.path.join(root, "frames", f"set{s:03d}")
        os.makedirs(frames, exist_ok=True)
        tex = _texture(nrng, H + pad, W + 2 * pad)
        for k in range(n):
            dx, dy = pad + int(round(4 * k * math.cos(s))), int(round(2 * k))
            Image.fromarray(tex[dy:dy + H, dx:dx + W]).save(
                os.path.join(frames, f"{k * 33333}.png"), compress_level=1)
    table = {}
    for d in ("RealEstate10K/train", "dataset/train", "annotation_json"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for c in range(mix["clips"]):
        clip = f"clip{c:04d}"
        poses = trajectory(rng.choice(("arc", "dolly")), n, rng, scale=2.0)
        fx = rng.uniform(0.45, 0.55)
        with open(os.path.join(root, "RealEstate10K", "train", clip + ".txt"), "w") as f:
            f.write(pose_file_text(poses, fx, fx * W / H))
        link = os.path.join(root, "dataset", "train", clip)
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(os.path.join("..", "..", "frames", f"set{c % mix['frame_sets']:03d}"), link)
        table[clip + ".mp4"] = [rng.choice(caps)]
    with open(os.path.join(root, "annotation_json", "train_captions.json"), "w") as f:
        json.dump(table, f)
    with open(os.path.join(root, "complete"), "w") as f:
        f.write("ok\n")
    try:
        os.rename(root, final)      # whole or not at all, should two runs make it at once
    except OSError:
        shutil.rmtree(root)
    return final
