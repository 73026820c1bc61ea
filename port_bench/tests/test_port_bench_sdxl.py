"""The ``cvd_sdxl`` architecture (CVD on the SDXL backbone) in the harness:
the program's and the reference's models have the same keys and shapes at
the tiny and the full configuration; the tiny CPU cell ``tiny-sdxl-pair``
runs through the command with its reference check and reports the UNet's
sublayer spans; its stored work is the reference's count; the float8
control fails its limit. The full configuration's stored work is held by
``test_port_bench_counts`` through ``BENCHMARK.json``."""
import json
import os

import pytest

from port_bench.lib import names, weights
from port_bench.lib.context import Context
from port_bench.tests import test_port_bench_counts
from port_bench.tests.helpers import TINY_BENCH, run_cell

CELL = "tiny-sdxl-pair"
SUBLAYERS = ("unet_spatial_ms", "unet_motion_ms", "unet_epi_ms")


@pytest.mark.parametrize("config", ["tiny-sdxl-cpu", "cvd-sdxl-512-sample"])
def test_same_keys_and_shapes(config):
    cfg = names.config(config)
    arch = names.architecture(cfg["architecture"])
    program = arch.program(cfg, "meta")
    table = weights.shapes(arch.reference(cfg, "meta"))
    assert list(table) == ["unet", "vae", "clip", "clip_2", "pose_encoder"]
    for name, shapes in table.items():
        got = getattr(program, name).state_dict()
        assert {k: tuple(t.shape) for k, t in got.items()} == shapes


def _bench(tmp_path) -> str:
    """The tiny benchmark with the cell, which reports what ``tiny-pair``
    does and the three sublayer metrics."""
    bench = json.load(open(TINY_BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="tiny-sdxl-cpu",
                                 file="port_bench/configs/tiny-sdxl-cpu.json"))
    bench["workloads"].append({"name": CELL, "config": "tiny-sdxl-cpu", "traffic": "tiny-pair",
                               "chips": 1, "why": "CPU rehearsal of sdxl-pair-25step"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-pair" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    for name in SUBLAYERS:
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "program_span", "layer": "whole model step",
                                   "moves": "request_s", "workloads": ["tiny-pair", CELL]})
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    return str(path)


@pytest.mark.parametrize("cell", [CELL, "tiny-pair"])
def test_cell_traced(tmp_path, cell):
    rc, line, err = run_cell(cell, seed=4_100_000_003, trace=1, bench=_bench(tmp_path))
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, err[-3000:]
    got = line["metrics"]
    assert {"unet_call_ms", "prepare_ms", "decode_ms", *SUBLAYERS} <= set(got)
    # parts of the last UNet call against the mean call (on the CPU the host clock)
    assert sum(got[m]["value"] for m in SUBLAYERS) <= got["unet_call_ms"]["value"] * 1.5


def test_cell_untraced(tmp_path):
    rc, line, err = run_cell(CELL, seed=4_100_000_005, trace=0, bench=_bench(tmp_path))
    assert rc == 0, err[-3000:]
    assert line["correct"] is True and "request_s" in line["metrics"], err[-3000:]


def test_stored_work_is_the_reference_count():
    c = names.cell(CELL)
    stored = names.read_json(os.path.join(names.BENCH_DIR, "work",
                                          f"{c['config']}.{c['traffic']}.json"))
    assert [p["name"] for p in stored["parts"]] == ["clip", "clip_2", "pose_encoder", "unet",
                                                    "vae"]
    test_port_bench_counts.test_stored_work_is_the_reference_count(CELL)


def test_control_fails_tiny():
    cell = names.cell(CELL)
    ctx = Context(CELL, cell, names.config(cell["config"]), names.traffic(cell["traffic"]),
                  4_000_000_127, 1.0, False, "cpu", 0.0)
    got = names.entry(cell["entry"]).calibrate(ctx)
    limit = cell["limits"]["frame_rmse_max"]
    assert got["frame_rmse_max"] <= limit < got["control.frame_rmse_max"], got
