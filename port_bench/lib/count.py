"""The reference's count of the work in one unit of a cell (a request, a
training step): floating-point operations by ``FlopCounterMode`` (2 per
multiply-add, products and convolutions at their nominal size, the
backward included) over the reference run on the ``meta`` device, and the
LayerNorm + Linear pairs and attentions it records, tallied by shape. The
configuration's architecture says what the parts of a unit are
(``request_parts``, ``train_step_parts``), each counted by ``part``; the
files ``work/<config>.<traffic>.json`` store the result, and a test holds
them to this count.

    python3 -m port_bench.lib.count <config> request <frames> <size> <steps>
    python3 -m port_bench.lib.count <config> step <frames> <size>
"""
from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import ops
from . import names
from .work import tally


def part(name: str, times: int, fn) -> dict:
    """One part of a unit: ``fn`` counted, to be done ``times`` a unit."""
    counter = FlopCounterMode(display=False)
    with ops.recording() as rec, counter, ops.scope(name):
        fn()
    return {"name": name, "times": times, "flops": int(counter.get_total_flops()),
            "ops": tally(rec)}


def meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def totals(parts: list) -> dict:
    """{"flops": of the unit, "ops": every part's records with their counts
    times the part's}."""
    ops_ = []
    for p in parts:
        for r in p["ops"]:
            ops_.append(dict(r, count=r["count"] * p["times"]))
    return {"flops": sum(p["flops"] * p["times"] for p in parts), "ops": ops_}


def unit_parts(config: dict, unit: str, frames: int, size: int, steps: int = 0) -> list:
    """The counted parts of a ``request`` (of ``steps`` UNet calls) or a
    training ``step`` of ``config``, by its architecture."""
    arch = names.architecture(config["architecture"])
    if unit == "request":
        return arch.request_parts(config, frames, size, steps)
    if unit == "step":
        return arch.train_step_parts(config, frames, size)
    raise ValueError(f"unit {unit!r}: request or step")


def main(argv=None) -> None:
    name, unit, frames, size, *rest = argv or sys.argv[1:]
    out = unit_parts(names.config(name), unit, int(frames), int(size), *map(int, rest))
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
