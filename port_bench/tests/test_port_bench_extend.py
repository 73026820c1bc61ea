"""A later change adds a configuration, a cell, a per-layer metric and a
kernel family by adding files and BENCHMARK.json entries alone: in a copy
of the tree with one of each added, the command finds and runs them, and
no file that was there changes."""
import hashlib
import json
import os
import shutil

from port_bench.lib import count, names
from port_bench.tests.helpers import run_cell

EXTRA_METRIC = '''"""extra_ops: how many of the reference's ops a request of the cell holds
that the kernel family kernels/extra_family.json takes in."""
from port_bench.lib import names, work
from port_bench.lib.readers import unit_work


def read(rec, ctx):
    fam = names.kernel_family("extra_family")
    return float(sum(r["count"] for r in unit_work(ctx)["ops"] if work.selects(fam, r)))
'''


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d and not d.split(os.sep)[-1].startswith("."):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_add_by_files(tmp_path):
    src = names.BENCH_DIR
    dst = tmp_path / "port_bench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(".cache", ".data",
                                                            "__pycache__"))
    before = _digests(dst)
    cfg = names.config("tiny-cpu")
    cfg["name"] = "tiny-extra"
    cfg["clip"] = dict(cfg["clip"], num_layers=1)
    (dst / "configs" / "tiny-extra.json").write_text(json.dumps(cfg))
    cell = dict(names.cell("tiny-pair"), config="tiny-extra")
    (dst / "workloads" / "tiny-extra-pair.json").write_text(json.dumps(cell))
    (dst / "metrics" / "extra_ops.py").write_text(EXTRA_METRIC)
    (dst / "kernels" / "extra_family.json").write_text(json.dumps(
        {"patterns": ["nothing_on_the_cpu"], "op": "attention",
         "where": {"scope": ["unet"], "kind": ["epi"]}}))
    mix = names.traffic("tiny-pair")
    parts = count.request(cfg, mix["frames"], mix["size"], mix["steps"])
    (dst / "work" / "tiny-extra.tiny-pair.json").write_text(json.dumps(
        {"config": "tiny-extra", "traffic": "tiny-pair", "unit": "request", "parts": parts}))
    bench = json.load(open(os.path.join(src, "tests", "data", "tiny_benchmark.json")))
    bench["configs"].append(dict(bench["configs"][0], name="tiny-extra",
                                 file="port_bench/configs/tiny-extra.json"))
    bench["workloads"].append({"name": "tiny-extra-pair", "config": "tiny-extra",
                               "traffic": "tiny-pair", "chips": 1, "why": "added by files"})
    bench["per_layer"].append({"name": "extra_ops", "unit": "ops", "better": "lower",
                               "source": "device_trace", "layer": "kernels",
                               "moves": "request_s", "workloads": ["tiny-extra-pair"]})
    bench["end_to_end"][0]["workloads"].append("tiny-extra-pair")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, line, err = run_cell("tiny-extra-pair", seconds=1, trace=1,
                             bench=str(tmp_path / "BENCHMARK.json"), root=str(tmp_path))
    assert rc == 0, err[-3000:]
    # two epi attentions in each of the UNet's 20 epi modules, 2 calls a request
    assert line["metrics"]["extra_ops"]["value"] == 2 * 20 * 2
    assert {"build_s", "capture_s"} <= set(line["metrics"])
    after = _digests(dst)
    assert {k: after[k] for k in before} == before
