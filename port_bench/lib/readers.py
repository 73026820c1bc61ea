"""What the per-layer readers share: the traced window's device share, the
model's share of the bf16 peak, and a kernel family's share of its
roofline, each from the trace and the reference's stored count of the work
(``work/<config>.<traffic>.json``). A reader with nothing to read (no trace,
no device operation, no kernel of the family) returns None."""
from __future__ import annotations

import os
from typing import Optional

from . import names, work
from .count import totals
from .trace import family_seconds


def unit_work(ctx) -> dict:
    path = os.path.join(names.BENCH_DIR, "work",
                        f"{ctx.cell['config']}.{ctx.cell['traffic']}.json")
    return totals(names.read_json(path)["parts"])


def idle_pct(rec) -> Optional[float]:
    t = rec.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(rec, ctx) -> Optional[float]:
    """The reference's operations for the units completed in the traced
    window over the window's wall time at the configuration's peak."""
    t = rec.trace
    if not t or t["busy_s"] <= 0 or rec.traced_units <= 0:
        return None
    flops = unit_work(ctx)["flops"] * rec.traced_units
    return 100.0 * flops / (t["window_s"] * work.PEAK_FLOPS[ctx.config["dtype"]])


def roofline(rec, ctx, family_name: str) -> Optional[float]:
    """The least time of the family's reference ops in the traced units over
    the device time of the family's kernels there."""
    t = rec.trace
    if not t or rec.traced_units <= 0:
        return None
    fam = names.kernel_family(family_name)
    seconds = family_seconds(t, fam["patterns"])
    least = work.family_least_seconds(fam, unit_work(ctx)["ops"], ctx.config["dtype"])
    if seconds <= 0 or least <= 0:
        return None
    return 100.0 * least * rec.traced_units / seconds
