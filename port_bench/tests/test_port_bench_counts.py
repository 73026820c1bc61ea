"""The work stored for each cell (``work/<config>.<traffic>.json``) is the
reference's count on the meta device, by the parts its configuration's
architecture gives, and a UNet call's FLOPs agree with the program's own
count within 0.1%."""
import json
import os

import pytest

from port_bench.lib import count, names

BENCH = json.load(open(os.path.join(names.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_stored_work_is_the_reference_count(cell):
    c = names.cell(cell)
    cfg, mix = names.config(c["config"]), names.traffic(c["traffic"])
    stored = names.read_json(os.path.join(names.BENCH_DIR, "work",
                                          f"{c['config']}.{c['traffic']}.json"))
    parts = count.unit_parts(cfg, stored["unit"], mix["frames"], mix["size"],
                             mix.get("steps", 0))
    assert json.loads(json.dumps(parts)) == stored["parts"]


def test_unet_call_flops_near_the_programs_count():
    stored = names.read_json(os.path.join(names.BENCH_DIR, "work",
                                          "cvd-sd15-256-sample.pair25.json"))
    unet = next(p for p in stored["parts"] if p["name"] == "unet")
    # the program's utils/flops.py count of one call at 4 rows x 16 frames x 32^2
    assert abs(unet["flops"] / 22_346_246_574_080 - 1) < 1e-3
