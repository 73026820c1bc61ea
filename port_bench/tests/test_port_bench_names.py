"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and texts, and a file for every configuration, cell, traffic mix, entry
kind, per-layer metric and kernel family it names."""
import json
import os
import re

import pytest

from port_bench.lib import names

ROOT = names.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and os.path.isdir(os.path.join(ROOT, p))


def _all_names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            yield section, entry


@pytest.mark.parametrize("section,entry", list(_all_names()),
                         ids=[f"{s}:{e['name']}" for s, e in _all_names()])
def test_entry(section, entry):
    assert NAME.match(entry["name"])
    if section == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(entry["source"]) and TEXT.match(entry["why"])
        assert entry["file"].startswith("port_bench/") and os.path.exists(
            os.path.join(ROOT, entry["file"]))
        assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
        cfg = names.config(entry["name"])
        assert cfg["name"] == entry["name"]
        assert os.path.exists(os.path.join(names.BENCH_DIR, "architectures",
                                           names.check_name(cfg["architecture"]) + ".py"))
    elif section == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert entry["chips"] in (1, 4) and TEXT.match(entry["why"])
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        cell = names.cell(entry["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            entry["config"], entry["traffic"], entry["chips"])
        names.traffic(cell["traffic"])
        assert os.path.exists(os.path.join(names.BENCH_DIR, "entries", cell["entry"] + ".py"))
    else:
        extra = {"bound"} if section == "end_to_end" else {"layer", "moves"}
        assert METRIC_KEYS | extra <= set(entry) <= METRIC_KEYS | extra | {"workloads"}
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert entry["source"] in ("host_clock", "device_trace")
            assert 0 < entry["bound"] <= 0.25 and entry["bound"] >= 0.01
        else:
            assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                       "host_clock")
            assert TEXT.match(entry["layer"])
            assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
            assert os.path.exists(os.path.join(names.BENCH_DIR, "metrics",
                                               entry["name"] + ".py"))
            if entry["name"].endswith("_roofline_pct") or "_roofline_pct." in entry["name"]:
                assert entry["unit"] == "%"
        cells = {w["name"] for w in BENCH["workloads"]}
        assert set(entry.get("workloads", cells)) <= cells


def test_unique_and_used():
    for section in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[section]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in names.metrics_of(BENCH, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert names.metrics_of(BENCH, "per_layer", w["name"])


def test_kernel_families_and_work_files():
    for fam in os.listdir(os.path.join(names.BENCH_DIR, "kernels")):
        f = names.kernel_family(fam[:-5])
        assert f["patterns"] and f["op"] in ("ln_linear", "attention", "attention_bwd")
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(names.BENCH_DIR, "work",
                                           f"{w['config']}.{w['traffic']}.json"))


def test_files_are_named_from_names():
    for d, _, files in os.walk(names.BENCH_DIR):
        if any(part.startswith(".") for part in os.path.relpath(d, names.BENCH_DIR).split(os.sep)
               if part != "."):
            continue
        for f in files:
            if f.endswith(".pyc"):
                continue
            assert re.match(r"^[A-Za-z0-9_.-]+$", f), f


def test_a_configuration_names_its_architecture(tmp_path, monkeypatch):
    (tmp_path / "configs").mkdir()
    cfg = names.config("tiny-cpu")
    del cfg["architecture"]
    (tmp_path / "configs" / "no-arch.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(names, "BENCH_DIR", str(tmp_path))
    with pytest.raises(KeyError, match="no-arch.json"):
        names.config("no-arch")
