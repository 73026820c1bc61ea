"""What an entry kind is handed for one run, and what it hands back."""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Dict, List, Optional

from .names import derive


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (Linux: from
    /proc; elsewhere: now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


@dataclasses.dataclass
class Context:
    cell_name: str
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    # the run's scratch files (pose files, the trace), in a directory of its own
    work_dir: str = dataclasses.field(
        default_factory=lambda: tempfile.mkdtemp(prefix="port_bench-"))

    def stream(self, *labels) -> int:
        return derive(self.seed, self.cell_name, *labels)


@dataclasses.dataclass
class Record:
    """An entry's run: units (requests or steps) attempted and failed in
    the window, the end-to-end numbers it measured, the raw readings the
    per-layer readers take, the trace's summary and the checks."""

    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    readings: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[dict] = None
    traced_units: int = 0
    peak_bytes: int = 0
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)


def check(value: float, limit: float) -> dict:
    """A number compared with its limit: ok when at most the limit."""
    return {"value": float(value), "limit": float(limit), "ok": bool(value <= limit)}


def mean(xs: List[float]) -> float:
    return statistics.fmean(xs) if xs else float("nan")
