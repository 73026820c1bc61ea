"""The program's own spans in the traced window (``cvd_tpu_torch.utils.
tracing``): the program records them while a profiler records, which the
harness runs over the traced units alone. They are drained once a run, at
the first reader, and kept for the others. A program without the module, a
run that recorded none, or one whose program counted other units than the
traced ones, gives nothing."""
from __future__ import annotations

from typing import Optional

_DRAINED = {}   # id(record) -> (record, the drained spans or None)


def program(rec) -> Optional[dict]:
    """The run's drained spans ({"spans", "device", "counters"}), or None."""
    if id(rec) not in _DRAINED:
        try:
            from cvd_tpu_torch.utils import tracing
        except ImportError:
            got = None
        else:
            got = tracing.drain()
        _DRAINED[id(rec)] = (rec, got)
    return _DRAINED[id(rec)][1]


def per_unit_ms(rec, name: str, device: bool = False) -> Optional[float]:
    """The time of the spans named ``name`` over the traced units, in ms:
    host spans, or (``device``) the device's time of device spans."""
    got = program(rec)
    if (not got or rec.trace is None or rec.traced_units <= 0
            or got["counters"].get("units") != rec.traced_units):
        return None
    if device:
        ms = [d["ms"] for d in got["device"] if d["name"] == name]
    else:
        ms = [1e3 * (s["end"] - s["start"]) for s in got["spans"] if s["name"] == name]
    if not ms:
        return None
    return sum(ms) / rec.traced_units
