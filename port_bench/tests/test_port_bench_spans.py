"""The readers of the program's spans (``lib/program_spans.py`` and the nine
``metrics/*_ms.py`` that use it): the tiny cells report them through the
command; a program without the tracing module, or a run whose program
counted other units, gives none; and the program's ``cvd/`` ranges in a
trace move nothing that the trace's reduction gives the other readers."""
import copy
import dataclasses
import sys

import pytest

from port_bench.lib import program_spans, readers
from port_bench.lib.context import Record
from port_bench.lib.trace import breakdown, reduce
from port_bench.tests.helpers import run_cell

REQUEST = {"pose_cond_ms", "prepare_ms", "decode_ms"}
PHASES = {"train_encode_ms", "train_forward_ms", "train_backward_ms", "train_optimizer_ms"}


def test_tiny_pair_reports_the_request_path():
    rc, line, err = run_cell("tiny-pair", seed=2 ** 33 + 5, seconds=1, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    got = line["metrics"]
    assert REQUEST <= set(got)
    assert all(got[m]["value"] > 0 and got[m]["unit"] == "ms" for m in REQUEST)


def test_tiny_train_held_reports_the_step_phases():
    rc, line, err = run_cell("tiny-train-held", seed=987654321987, seconds=2, trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    got = line["metrics"]
    assert PHASES <= set(got)
    assert all(got[m]["value"] > 0 for m in PHASES)
    # on the CPU the step runs eagerly: no static buffers to fill, no stamp
    assert not {"train_fill_ms", "train_stamp_ms"} & set(got)


def _record(units=2):
    return Record(trace={"window_s": 1.0, "busy_s": 0.5, "ops": {}, "gaps": []},
                  traced_units=units)


def test_a_program_without_tracing_gives_nothing(monkeypatch):
    import cvd_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "cvd_tpu_torch.utils.tracing", None)   # import fails
    # also where an earlier test in this process imported it: ``from`` finds
    # the package's attribute before it looks in ``sys.modules``
    monkeypatch.delattr(cvd_tpu_torch.utils, "tracing", raising=False)
    rec = _record()
    assert program_spans.program(rec) is None
    assert program_spans.per_unit_ms(rec, "sample.decode", device=True) is None


def test_spans_over_units_and_a_unit_mismatch(monkeypatch):
    from cvd_tpu_torch.utils import tracing

    drained = {"spans": [{"name": "train.fill", "parent": None, "unit": u, "start": 1.0,
                          "end": 1.004} for u in (7, 8)],
               "device": [{"name": "train.encode", "parent": None, "unit": u, "ms": 30.0}
                          for u in (7, 8)],
               "counters": {"units": 2}}
    monkeypatch.setattr(tracing, "drain", lambda: copy.deepcopy(drained))
    rec = _record()
    assert program_spans.per_unit_ms(rec, "train.fill") == pytest.approx(4.0)
    assert program_spans.per_unit_ms(rec, "train.encode", device=True) == 30.0
    assert program_spans.per_unit_ms(rec, "train.stamp") is None       # none recorded
    assert program_spans.per_unit_ms(dataclasses.replace(rec, traced_units=3),
                                     "train.fill") is None             # other units


def _x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


HARNESS = [
    _x("bench:request", "user_annotation", 0, 1000),
    _x("bench:prep", "user_annotation", 0, 400),
    _x("bench:pipeline", "user_annotation", 400, 600),
    _x("ln_mm_kernel", "kernel", 10, 50),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 70, 20),
    _x("flash_fwd_kernel", "kernel", 450, 300),
    _x("Memset (Device)", "gpu_memset", 760, 5),
    _x("Optimizer.step#AdamW.step", "gpu_user_annotation", 440, 330),
]
PROGRAM = [
    _x("cvd/data.pose_conditioning", "user_annotation", 5, 390),
    _x("cvd/geometry.ray_condition", "user_annotation", 100, 250),
    _x("cvd/sample.prepare", "user_annotation", 400, 40),
    _x("cvd/sample.denoise", "user_annotation", 440, 330),
    _x("cvd/sample.denoise", "gpu_user_annotation", 450, 310),
]


@pytest.mark.parametrize("order", ["after", "before"])
def test_program_ranges_move_nothing_in_the_reduction(order):
    events = HARNESS + PROGRAM if order == "after" else PROGRAM + HARNESS
    plain, traced = reduce(HARNESS, 0.002), reduce(events, 0.002)
    assert traced == plain
    assert plain["busy_s"] == pytest.approx(375e-6)
    assert [g[0] for g in plain["gaps"]] == ["prep", "prep", "pipeline"]
    assert breakdown(traced) == breakdown(plain)
    rec = dataclasses.replace(_record(1), trace=traced)
    assert readers.idle_pct(rec) == readers.idle_pct(dataclasses.replace(rec, trace=plain))
