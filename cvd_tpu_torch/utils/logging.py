"""Logging for training runs (port of ``cvd_tpu/utils/logging.py``): stdout
on process 0 and a per-process log file, a JSONL metrics stream, and
``format_time`` for ETAs."""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def setup_logger(output_dir: Optional[str] = None, name: str = "cvd_tpu_torch",
                 process_index: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter(f"[%(asctime)s p{process_index} %(levelname)s] %(message)s",
                            "%H:%M:%S")
    if process_index == 0:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, f"log_p{process_index}.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricsLogger:
    """Append-only JSONL metrics stream (replaces
    train_epi_control.py:663-671)."""

    def __init__(self, output_dir: Optional[str], enabled: bool = True):
        self.path = os.path.join(output_dir, "metrics.jsonl") if output_dir else None
        self.enabled = enabled and self.path is not None
        if self.enabled:
            os.makedirs(output_dir, exist_ok=True)
        self.t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time() - self.t0}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def format_time(seconds: float) -> str:
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h}h {m}m {s}s" if h else (f"{m}m {s}s" if m else f"{s}s")
