"""Pyramid Attention Broadcast (PAB, arXiv:2408.12588) for the sampling
loops (the port's own copy of ``cvd_tpu/pipelines/pab.py``, plus the cache).

Attention outputs drift slowly across adjacent diffusion timesteps. PAB
computes each attention class every Nth step inside a middle window of the
schedule and reuses (broadcasts) its cached output in between; the early
steps, where the latent changes fastest, and the last ones, which set fine
detail, always compute.

The reuse decisions are fixed numpy masks per class (``reuse_masks``). A
sampler makes one ``PABCache`` per request, sets its ``flags`` before each
UNet call, and hands it to the UNet; every attention site stores its output
in it on a computing step and returns the stored one on a reuse step,
without running its norm, projections or attention. The cache lives only
as long as the request: no module holds it.

Default ranges are conservative: the epipolar attention, the cross-video
sync, recomputes every step unless asked otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

CLASSES = ("spatial", "cross", "temporal", "epi")


@dataclasses.dataclass(frozen=True)
class PABConfig:
    """Broadcast range per attention class: compute every Nth step inside
    the [start_frac, end_frac) window, reuse otherwise. A range <= 1 always
    recomputes (PAB off for that class)."""

    spatial: int = 2
    cross: int = 3
    temporal: int = 2
    epi: int = 1
    start_frac: float = 0.2
    end_frac: float = 0.9

    @classmethod
    def from_string(cls, s: str) -> "PABConfig":
        """Parse 'spatial=2,cross=3,temporal=2,epi=1' (missing keys keep
        their defaults)."""
        kw = {}
        for part in filter(None, (p.strip() for p in s.split(","))):
            k, _, v = part.partition("=")
            if k not in CLASSES + ("start_frac", "end_frac"):
                raise ValueError(f"unknown PAB class {k!r} in {s!r}")
            kw[k] = float(v) if k.endswith("_frac") else int(v)
        return cls(**kw)


def reuse_masks(num_steps: int, cfg: PABConfig) -> Dict[str, np.ndarray]:
    """Per-class boolean masks [num_steps]: True = reuse the cached attention
    output at that step. Step 0 (and every window boundary) always computes,
    so nothing is reused before it was computed."""
    lo = int(round(num_steps * cfg.start_frac))
    hi = int(round(num_steps * cfg.end_frac))
    masks = {}
    for name in CLASSES:
        r = int(getattr(cfg, name))
        m = np.zeros(num_steps, dtype=bool)
        if r > 1:
            for i in range(lo, min(hi, num_steps)):
                if (i - lo) % r != 0:
                    m[i] = True
        masks[name] = m
    return masks


class PABCache:
    """One request's attention outputs, keyed by attention site, and the
    reuse flag of each class for the UNet call about to run."""

    def __init__(self, config: PABConfig, num_steps: int):
        self.masks = reuse_masks(num_steps, config)
        self.flags: Dict[str, bool] = {c: False for c in CLASSES}
        self.outputs: Dict[object, object] = {}

    def at_step(self, index: int) -> "PABCache":
        """Set the flags of timestep ``index`` (every UNet call of a timestep,
        repeats and pairings included, shares them)."""
        self.flags = {c: bool(self.masks[c][index]) for c in CLASSES}
        return self

    def run(self, site, kind: str, fn: Callable):
        if self.flags[kind]:
            return self.outputs[site]
        out = fn()
        self.outputs[site] = out
        return out
