"""The run's last line: one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, optionally ``breakdown``, and last
``checks`` (each number compared, beside its limit), which also end
standard error."""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cvd_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``cvd_tpu_torch`` is not ``cvd_tpu``."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in list(mods) if m.split(".")[0] in FORBIDDEN)


def device_info(device, chips: int, peak_bytes: int, trace: Optional[dict]) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(peak_bytes)
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def check_line(checks: Dict[str, dict]) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r}, "
            f"{'ok' if c['ok'] else 'FAILED'})" for name, c in checks.items()]


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict], device: dict,
         checks: Dict[str, dict], breakdown: Optional[dict] = None) -> None:
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": c["value"], "limit": c["limit"]}
                      for name, c in checks.items()}
    for text in check_line(checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
