"""The reference's count of the work in one unit of a cell (a request, a
training step): floating-point operations by ``FlopCounterMode`` (2 per
multiply-add, products and convolutions at their nominal size, the
backward included) over the reference run on the ``meta`` device, and the
LayerNorm + Linear pairs and attentions it records, tallied by shape. The
configuration files store the result under ``work``; a test holds them to
this count.

    python3 -m port_bench.lib.count <config> <unit> <frames> <size>
"""
from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref_model
from ..reference import ops
from .work import tally


def _run(name: str, times: int, fn) -> dict:
    counter = FlopCounterMode(display=False)
    with ops.recording() as rec, counter, ops.scope(name):
        fn()
    return {"name": name, "times": times, "flops": int(counter.get_total_flops()),
            "ops": tally(rec)}


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def request(config: dict, frames: int, size: int, steps: int) -> list:
    """The parts of one 2-view request: the prompt and the negative prompt
    through CLIP, the pose pair through the pose encoder, ``steps`` UNet
    calls on the 4 CFG rows, the decode of both views' frames."""
    mods = ref_model.build(config, "meta")
    lat = size // 8
    pose = [_meta(4, frames, *p.shape[2:]) for p in
             mods["pose_encoder"](_meta(2, frames, size, size, 6))]
    cond = ref_model.EpiCond(_meta(4 * frames, 3, 3), frames, config["epi_F_mat_size"],
                             slope=_meta(1))
    with torch.no_grad():
        return [
            _run("clip", 2, lambda: mods["clip"](_meta(1, 77, dtype=torch.long))),
            _run("pose_encoder", 1,
                 lambda: mods["pose_encoder"](_meta(2, frames, size, size, 6))),
            _run("unet", steps, lambda: mods["unet"](
                _meta(4, frames, lat, lat, 4), _meta(4, dtype=torch.long),
                _meta(4, 77, config["unet"]["cross_attention_dim"]), pose, cond)),
            _run("vae", 1, lambda: mods["vae"].decode(_meta(2 * frames, lat, lat, 4))),
        ]


def train_step(config: dict, frames: int, size: int) -> list:
    """The parts of one training step on a folded pair: the VAE encode of
    both videos' frames (8 a call), CLIP on the two rows, the pose encoder,
    and the UNet's forward on the 2 rows with its backward into the
    trainable keys."""
    mods = ref_model.build(config, "meta", vae_encoder=True)
    lat = size // 8
    for k, p in mods["unet"].named_parameters():
        p.requires_grad_(any(s in k for s in config["trainable"]))
    pose = [_meta(2, frames, *p.shape[2:]) for p in
            mods["pose_encoder"](_meta(2, frames, size, size, 6))]
    cond = ref_model.EpiCond(_meta(2 * frames, 3, 3), frames, config["epi_F_mat_size"],
                             slope=_meta(1))

    def unet():
        pred = mods["unet"](_meta(2, frames, lat, lat, 4), _meta(2, dtype=torch.long),
                            _meta(2, 77, config["unet"]["cross_attention_dim"]), pose, cond)
        pred.float().pow(2).mean().backward()

    with torch.no_grad():
        parts = [
            _run("vae", 2 * frames // 8, lambda: mods["vae"].moments(_meta(8, size, size, 3))),
            _run("clip", 1, lambda: mods["clip"](_meta(2, 77, dtype=torch.long))),
            _run("pose_encoder", 1,
                 lambda: mods["pose_encoder"](_meta(2, frames, size, size, 6))),
        ]
    return parts + [_run("unet", 1, unet)]


def totals(parts: list) -> dict:
    """{"flops": of the unit, "ops": every part's records with their counts
    times the part's}."""
    ops_ = []
    for p in parts:
        for r in p["ops"]:
            ops_.append(dict(r, count=r["count"] * p["times"]))
    return {"flops": sum(p["flops"] * p["times"] for p in parts), "ops": ops_}


def main(argv=None) -> None:
    from .names import config as load_config

    name, unit, frames, size, *rest = argv or sys.argv[1:]
    cfg = load_config(name)
    out = (request(cfg, int(frames), int(size), int(rest[0])) if unit == "request"
           else train_step(cfg, int(frames), int(size)))
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
