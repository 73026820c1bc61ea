"""Profiling helpers (port of ``cvd_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a region, and the per-kernel summary of a trace
that ``chip_smoke.py`` prints. The program's own spans are
``utils/tracing.py``'s.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Sequence


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[object]]:
    """``torch.profiler`` over the block, CPU and (where there is one) CUDA
    activity, written as a Chrome trace ``<log_dir>/trace.json`` when the
    block ends; yields the profiler. A no-op yielding None for a None
    ``log_dir``."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def kernel_summary(prof, wall_s: float, steps: int, what: str,
                   families: Sequence[str] = ()) -> dict:
    """Device time of a profiled window of ``steps`` steps that took
    ``wall_s`` seconds: {"table": the ``key_averages`` table by device time,
    "lines": one line of totals and one per kernel (the 20 longest, then
    each of ``families`` summed over its instantiations), per step,
    "device_ms": kernel time per step, "idle_share": the share of the wall
    time no kernel ran}. Device time is that of kernels, memory copies and
    memory sets: user and profiler ranges on the device's timeline
    (``gpu_user_annotation``, e.g. ``Optimizer.step``) span kernels and are
    not counted."""
    events = prof.key_averages()
    kernels = [e for e in events
               if str(e.device_type).endswith("CUDA") and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    host_ms = sum(e.self_cpu_time_total for e in events) / 1e3
    idle = 1 - device_ms / (wall_s * 1e3) if wall_s > 0 else float("nan")
    lines = [f"{what}, per step: wall {wall_s * 1e3 / steps:.1f} ms, kernel time "
             f"{device_ms / steps:.1f} ms (idle share {idle:.1%}), host self time "
             f"{host_ms / steps:.1f} ms"]
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        lines.append(f"{e.self_device_time_total / 1e3 / steps:9.2f} ms  "
                     f"x{e.count / steps:<7.1f} {e.key[:90]}")
    for family in families:
        own = [e for e in kernels if family in e.key]
        if own:
            lines.append(f"{sum(e.self_device_time_total for e in own) / 1e3 / steps:9.2f} ms  "
                         f"x{sum(e.count for e in own) / steps:<7.1f} every {family}*")
    return {"table": events.table(sort_by="self_device_time_total", row_limit=60),
            "lines": lines, "device_ms": device_ms / steps, "idle_share": idle}
