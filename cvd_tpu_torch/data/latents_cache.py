"""Pre-encoded latents cache (port of ``cvd_tpu/data/latents_cache.py``):
encode each training clip through the VAE once, on the card, and train from
the stored posterior.

The reference encodes every frame inside every training step
(train_epi_control.py:514-523), so a clip seen again is encoded again. The
one-time pass writes each item's posterior moments (mean, logvar); the
training step draws a fresh posterior sample from them every time
(``train/train_step.py``, ``latent_mean`` / ``latent_logvar``), so the
stochastic encode is kept and the encoder's convolutions and GroupNorms
(kernel K4's split path) leave the step.

The file format is the JAX package's, so a cache written by either package
is read by the other: ``item-NNNNNN.npz`` with ``latent_mean`` /
``latent_logvar`` (float16 [2F, h, w, 4]), ``text``, ``F_mats``, ``ret_c2w``,
``ret_K_mats`` and ``intrinsics`` (fx, fy, cx, cy), plus ``manifest.json``
(item count, frames, sample and latent size). The Plücker maps are not
stored: ``CachedLatentsDataset`` derives them again from the cached cameras
(``geometry.plucker.ray_condition``, per frame, so folding commutes).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


def _intrinsics_vec(K_mats: np.ndarray) -> np.ndarray:
    """[N, 3, 3] -> [N, 4] (fx, fy, cx, cy)."""
    return np.stack([K_mats[:, 0, 0], K_mats[:, 1, 1], K_mats[:, 0, 2], K_mats[:, 1, 2]],
                    axis=-1).astype(np.float32)


def make_encode_fn(modules, frame_chunk: int = 8) -> Callable:
    """-> encode(images [N, H, W, 3] in [-1, 1], numpy or tensor) -> (mean,
    logvar) f32 [N, H/8, W/8, 4] on the VAE's device (unscaled: the VAE's
    ``scaling_factor`` applies after sampling). ``frame_chunk`` frames at a time, no grad."""
    vae = modules.vae
    weight = vae.quant_conv.weight

    @torch.no_grad()
    def encode(images):
        x = torch.as_tensor(images).to(device=weight.device, dtype=weight.dtype)
        moments = [vae.encode(x[i:i + frame_chunk]) for i in range(0, x.shape[0], frame_chunk)]
        return (torch.cat([m for m, _ in moments]).float(),
                torch.cat([v for _, v in moments]).float())

    return encode


def build_latents_cache(dataset, modules, cache_dir: str, num_items: Optional[int] = None,
                        frame_chunk: int = 8, log=print) -> dict:
    """The one-time encode pass over ``dataset``'s items (the first
    ``num_items``) -> ``cache_dir``/item-NNNNNN.npz and manifest.json. An
    item already on disk is not encoded again. -> {"items": written,
    "seconds": the pass's wall time, "item_seconds": each written item's}."""
    os.makedirs(cache_dir, exist_ok=True)
    n_items = len(dataset) if num_items is None else min(num_items, len(dataset))
    encode = make_encode_fn(modules, frame_chunk)
    t0 = time.perf_counter()
    meta, item_seconds = None, []
    for i in range(n_items):
        out = os.path.join(cache_dir, f"item-{i:06d}.npz")
        if os.path.exists(out):
            continue
        t_item = time.perf_counter()
        item = dataset[i]
        px = item["pixel_values"]                    # [2n, H, W, 3] in [-1, 1]
        mean, logvar = (t.cpu().numpy() for t in encode(np.asarray(px, np.float32)))
        np.savez(out,
                 latent_mean=mean.astype(np.float16),
                 latent_logvar=logvar.astype(np.float16),
                 text=np.asarray(item["text"]),
                 F_mats=np.asarray(item["F_mats"], np.float32),
                 ret_c2w=np.asarray(item["ret_c2w"], np.float32),
                 ret_K_mats=np.asarray(item["ret_K_mats"], np.float32),
                 intrinsics=_intrinsics_vec(np.asarray(item["ret_K_mats"])))
        item_seconds.append(time.perf_counter() - t_item)
        if meta is None:
            meta = {"num_items": n_items, "frames": int(px.shape[0]),
                    "sample_size": int(px.shape[1]), "latent_size": int(mean.shape[1])}
        if (i + 1) % 50 == 0 or i + 1 == n_items:
            log(f"[latents-cache] {i + 1}/{n_items} "
                f"({(time.perf_counter() - t0) / (i + 1):.2f}s/item)")
    if meta is not None:
        with open(os.path.join(cache_dir, "manifest.json"), "w") as f:
            json.dump(meta, f)
    return {"items": len(item_seconds), "seconds": time.perf_counter() - t0,
            "item_seconds": item_seconds}


class CachedLatentsDataset:
    """Reads ``build_latents_cache``'s items: the ``latent_mean`` /
    ``latent_logvar`` the train step samples from, and the Plücker maps
    derived again from the cached cameras (as the source dataset made them)."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        self.files = sorted(f for f in os.listdir(cache_dir)
                            if f.startswith("item-") and f.endswith(".npz"))
        if not self.files:
            raise FileNotFoundError(f"no cached items under {cache_dir}")
        mpath = os.path.join(cache_dir, "manifest.json")
        self.meta = {}
        if os.path.exists(mpath):
            with open(mpath) as f:
                self.meta = json.load(f)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        from cvd_tpu_torch.geometry.plucker import ray_condition

        with np.load(os.path.join(self.cache_dir, self.files[idx]), allow_pickle=False) as z:
            item = {k: z[k] for k in z.files}
        c2w = item["ret_c2w"]
        size = self.meta.get("sample_size", int(item["latent_mean"].shape[1]) * 8)
        plucker = np.asarray(ray_condition(item["intrinsics"][None],
                                           c2w[None].astype(np.float32), size, size)[0])
        return {"latent_mean": item["latent_mean"].astype(np.float32),
                "latent_logvar": item["latent_logvar"].astype(np.float32),
                "text": str(item["text"]), "plucker_embedding": plucker,
                "F_mats": item["F_mats"], "ret_c2w": c2w, "ret_K_mats": item["ret_K_mats"]}
