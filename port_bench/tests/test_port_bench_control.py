"""The control, the reference computed in float8 in the program's place,
comes out not correct: on the CPU at the tiny configuration, and on the
H100 at each cell's own size on three seeds (``card``: decided inside the
test, skipped without a card). The card test also holds the program's own
readings on those seeds to the limits."""
import json
import os
import subprocess
import sys

import pytest

from port_bench.lib import names
from port_bench.lib.context import Context
from port_bench.tests.helpers import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _ctx(cell_name, seed, device="cpu"):
    cell = names.cell(cell_name)
    return Context(cell_name, cell, names.config(cell["config"]), names.traffic(cell["traffic"]),
                   seed, 1.0, False, device, 0.0)


def _fails(readings: dict, limits: dict, prefix: str) -> bool:
    return any(readings[f"{prefix}.{k}"] > v for k, v in limits.items()
               if f"{prefix}.{k}" in readings)


@pytest.mark.parametrize("cell", ["tiny-pair", "tiny-train"])
def test_control_fails_tiny(cell):
    ctx = _ctx(cell, 4_000_000_123)
    got = names.entry(ctx.cell["entry"]).calibrate(ctx)
    limits = ctx.cell["limits"]
    assert all(got[k] <= v for k, v in limits.items()), got
    assert _fails(got, limits, "control"), got


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the H100: the control runs at the cell's own size")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "port_bench", "run.py"),
                        "--workload", cell, "--seed", "5000000001", "--seconds", "1",
                        "--calibrate", "3"], capture_output=True, text=True, timeout=3000,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    limits = names.cell(cell)["limits"]
    for line in p.stdout.strip().splitlines()[-3:]:
        got = json.loads(line)
        assert all(got[k] <= v for k, v in limits.items()), got
        assert _fails(got, limits, "control"), got
