"""The traced part of a run: ``torch.profiler`` over a bounded steady part
of the window, reduced to what the per-layer metrics read.

* device time: every kernel, memory copy and memory set on the device
  timeline (no user or profiler range), by name, and the union of their
  intervals (busy seconds), within the traced window;
* idle gaps: the spans of the device timeline where nothing ran, each
  named by the harness span (``record_function``) the host was in at the
  gap's middle.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """Profiles the steps between ``start()`` and ``stop()`` (a no-op when
    not ``enabled``); ``summary`` is filled at ``stop``."""

    def __init__(self, enabled: bool, work_dir: str, device):
        self.enabled, self.work_dir, self.device = enabled, work_dir, device
        self.prof = None
        self.summary: Optional[dict] = None
        self._t0 = 0.0

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(torch.device(self.device).index or 0)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.prof is None or self.summary is not None:
            return
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(torch.device(self.device).index or 0)
        window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        os.makedirs(self.work_dir, exist_ok=True)
        path = os.path.join(self.work_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        events = events["traceEvents"] if isinstance(events, dict) else events
        self.summary = reduce(events, window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(events: List[dict], window_s: float) -> dict:
    """Chrome-trace events (microseconds) -> {"window_s", "busy_s", "ops":
    {name: device seconds}, "gaps": [(span, seconds)] longest first}; the
    device events counted are those that start between the first harness
    span's start and the last one's end."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench:")]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    if spans:
        lo = min(float(e["ts"]) for e in spans)
        hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in spans)
        dev = [e for e in dev if float(e["ts"]) >= lo and float(e["ts"]) <= hi]
    ops: Dict[str, float] = {}
    intervals = []
    for e in dev:
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        ops[e["name"]] = ops.get(e["name"], 0.0) + dur * 1e-6
        intervals.append((ts, ts + dur))
    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    for (a0, a1), (b0, _) in zip(busy, busy[1:]):
        mid = (a1 + b0) / 2
        inside = [s for s in spans if float(s["ts"]) <= mid <= float(s["ts"]) + float(s["dur"])]
        # the innermost span the host was in
        name = min(inside, key=lambda s: float(s["dur"]))["name"][6:] if inside else "none"
        gaps.append((name, (b0 - a1) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": window_s, "busy_s": busy_s, "ops": ops, "gaps": gaps}


def breakdown(summary: dict, n: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time, and the longest idle gaps by what the host was doing."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[name, s] for name, s in summary["gaps"][:n]]}


def family_seconds(summary: dict, patterns: List[str]) -> float:
    """Device seconds of the operations whose name contains any pattern."""
    return sum(s for name, s in summary["ops"].items() if any(p in name for p in patterns))


@contextlib.contextmanager
def span(name: str):
    """A harness span: a ``record_function`` range named ``bench:<name>``."""
    import torch

    with torch.profiler.record_function("bench:" + name):
        yield
