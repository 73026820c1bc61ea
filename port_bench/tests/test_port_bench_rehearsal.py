"""The command end to end on the CPU: the tiny cells' last lines have
exactly the contract's keys and names the CPU; a cell that asks for a card
is refused (no result) where there is none."""
import pytest

from port_bench.tests.helpers import run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_tiny_pair_line():
    rc, line, err = run_cell("tiny-pair", seed=2 ** 31 + 17, seconds=1)
    assert rc == 0, err[-3000:]
    assert list(line) == KEYS
    assert line["correct"] is True, err[-3000:]
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"request_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert "check frame_rmse_max" in err.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-train-held"])
def test_tiny_train_traced_line(cell):
    rc, line, err = run_cell(cell, seed=987654321987, seconds=2, trace=1)
    assert rc == 0, err[-3000:]
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert line["correct"] is True, err[-3000:]
    assert {"data_wait_ms", "build_s", "capture_s"} <= set(line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_card_cell_refused_without_card():
    from port_bench.tests.helpers import ROOT
    import os

    rc, line, err = run_cell("pair-25step", seconds=1,
                             bench=os.path.join(ROOT, "BENCHMARK.json"))
    assert rc != 0 and line is None
    assert "not measured" in err
