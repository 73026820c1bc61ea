"""Program tracing: named spans at the port's layer boundaries, on the
profiler's clock, the named intervals of a captured body, and the
samplers' per-UNet-call span timer.

**Off by default.** Tracing is on while ``enable(True)`` holds and while a
``torch.profiler`` records, so that a profiled run carries the program's
spans with nothing else to switch. Off, ``span`` and ``device_span`` return
one shared null context: nothing is allocated, recorded or entered. A
process forked from this one (the loader's process workers) never traces.

**On**, every span

* opens a ``torch.profiler.record_function`` range named ``cvd/<name>``:
  the device trace shares the profiler's clock, so an idle gap of the
  device can be put down to the span the host was in;
* records in memory its name, its parent span (the innermost one open on
  the same thread), its unit and its host start and end
  (``time.perf_counter``). A unit is a request or a training step: the
  samplers and the train program call ``next_unit`` at the end of each, so
  the work a unit's caller does before it (a request's pose conditioning)
  belongs to that unit.

A device span (``device_span``) also records a pair of CUDA timing events on
the current stream, read only at ``drain``; on the CPU its device time is its
host time. ``record`` adds a device time measured elsewhere: the named
intervals of an ``IntervalTimer``, timed inside a CUDA graph.

``drain()`` returns {"spans", "device", "counters"} and clears them. The
spans and what reads each are listed in PERF.md, section 3.

``SpanTimer`` is always on: CUDA events around each UNet call or replay,
read by the samplers' ``unet_step_ms``. ``IntervalTimer`` times named
intervals with marks that a captured graph keeps: the train step's phases,
and the sublayers of a UNet call by kind (``unet.spatial``,
``unet.motion``, ``unet.epi``), where the caller passes the UNet a timer
(the 2-view sampler's timestep body).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import torch

_NULL = contextlib.nullcontext()


class _State:
    def __init__(self):
        self.on = False         # enable(True)
        self.child = False      # a forked child of the process that imported this
        self.unit = 0           # the current unit's index
        self.units = 0          # units ended while tracing was on
        self.spans: List[dict] = []
        self.device: List[dict] = []
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_STATE = _State()


def _forked() -> None:
    _STATE.child = True


os.register_at_fork(after_in_child=_forked)


def enable(on: bool = True) -> None:
    """Turn tracing on or off (besides the profiler's own switch)."""
    _STATE.on = bool(on)


def active() -> bool:
    """Whether spans record: ``enable(True)``, or a profiler recording."""
    s = _STATE
    return not s.child and (s.on or torch._C._autograd._profiler_enabled())


def _mark(device: torch.device, now: Optional[float] = None, event=None):
    """A timing mark on ``device``: on the card a CUDA event (``event``, else
    a new one) recorded on the current stream, no sync; elsewhere the host
    clock (``now``, else read here)."""
    if device.type != "cuda":
        return time.perf_counter() if now is None else now
    if event is None:
        event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _ms(a, b) -> float:
    """The time between two marks of ``_mark``, in ms; a CUDA event pair
    must be complete."""
    if isinstance(a, float):
        return 1e3 * (b - a)
    return a.elapsed_time(b)


class _Span:
    __slots__ = ("name", "device", "range", "parent", "unit", "start", "begin")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _STATE.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.unit = _STATE.unit
        self.range = torch.profiler.record_function("cvd/" + self.name)
        self.range.__enter__()
        self.start = time.perf_counter()
        # on the CPU a device span is its host span
        self.begin = None if self.device is None else _mark(self.device, self.start)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        s = _STATE
        if self.device is not None:
            s.device.append({"name": self.name, "parent": self.parent, "unit": self.unit,
                             "marks": (self.begin, _mark(self.device, end))})
        self.range.__exit__(*exc)
        s.stack().pop()
        s.spans.append({"name": self.name, "parent": self.parent, "unit": self.unit,
                        "start": self.start, "end": end})


def span(name: str):
    """A host span named ``name`` (a context manager)."""
    return _Span(name, None) if active() else _NULL


def device_span(name: str, device):
    """A span that also times the device work enqueued inside it on
    ``device``'s current stream (the host clock on the CPU)."""
    return _Span(name, torch.device(device)) if active() else _NULL


def record(name: str, ms: float) -> None:
    """A device time of ``ms`` measured elsewhere, as a device span of the
    current unit (inside the innermost open span)."""
    stack = _STATE.stack()
    _STATE.device.append({"name": name, "parent": stack[-1] if stack else None,
                          "unit": _STATE.unit, "ms": float(ms)})


def next_unit() -> None:
    """End the current unit (a request or a training step)."""
    s = _STATE
    if active():
        s.units += 1
    s.unit += 1


def drain() -> dict:
    """What was recorded since the last drain, cleared: {"spans": host spans
    ({"name", "parent", "unit", "start", "end"}, seconds), "device": device
    spans ({"name", "parent", "unit", "ms"}), "counters": {"units": units
    ended while tracing was on}}. Waits for each device span's end event."""
    s = _STATE
    spans, device, units = s.spans, s.device, s.units
    s.spans, s.device, s.units = [], [], 0
    out = []
    for d in device:
        d = dict(d)
        marks = d.pop("marks", None)
        if marks is not None:
            if not isinstance(marks[1], float):
                marks[1].synchronize()
            d["ms"] = _ms(*marks)
        out.append(d)
    return {"spans": spans, "device": out, "counters": {"units": units}}


class SpanTimer:
    """Times each ``with timer:`` span on ``device``: CUDA events on the card
    (no sync until ``elapsed_ms``), the host clock on the CPU. A span of
    several UNet calls, ``with timer.span(n):`` (a CUDA graph's replay of
    n calls), counts as n entries of its time / n: ``elapsed_ms`` holds
    one entry per UNet call either way."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.marks = []
        self.calls = []
        self._next = 1

    def span(self, calls: int) -> "SpanTimer":
        self._next = calls
        return self

    def __enter__(self):
        self.calls.append(self._next)
        self._next = 1
        self.marks.append(_mark(self.device))

    def __exit__(self, *exc):
        self.marks.append(_mark(self.device))

    def elapsed_ms(self) -> List[float]:
        """The wall time of every UNet call so far, in ms."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        spans = [_ms(a, b) for a, b in zip(self.marks[::2], self.marks[1::2])]
        return [ms / n for ms, n in zip(spans, self.calls) for _ in range(n)]


class IntervalTimer:
    """Named intervals of a body's runs on ``device``, between marks made so
    that a CUDA graph captured from the body keeps them: CUDA events created
    ``external`` on first use, which a capture records as event nodes of the
    graph, so every replay records them and an eager run of the body records
    the same events. On the CPU the marks are the host clock.

    ``start()`` begins a run; each ``mark(name)`` takes the run's next mark,
    which ends the interval before it and begins ``name`` (None: begins
    none); ``span(name)`` brackets a piece between two marks."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.marks: list = []                     # in the order a run takes them
        self.names: List[Optional[str]] = []      # the interval each mark begins
        self.used = 0

    def start(self) -> None:
        self.used = 0

    def mark(self, name: Optional[str] = None) -> None:
        i = self.used
        if i == len(self.marks):
            self.marks.append(torch.cuda.Event(enable_timing=True, external=True)
                              if self.device.type == "cuda" else None)
            self.names.append(None)
        self.names[i] = name
        self.marks[i] = _mark(self.device, event=self.marks[i])
        self.used += 1

    @contextlib.contextmanager
    def span(self, name: str):
        self.mark(name)
        yield
        self.mark()

    def elapsed_ms(self) -> Dict[str, float]:
        """Each name's time in the last run, summed, in ms (waits for the
        run's last mark)."""
        n = self.used
        if self.device.type == "cuda" and n:
            self.marks[n - 1].synchronize()
        out: Dict[str, float] = {}
        for name, a, b in zip(self.names[:n], self.marks[:n], self.marks[1:n]):
            if name is not None:
                out[name] = out.get(name, 0.0) + _ms(a, b)
        return out

    def record(self) -> None:
        """The last run's intervals as device spans, where tracing is on."""
        if active():
            for name, ms in self.elapsed_ms().items():
                record(name, ms)
