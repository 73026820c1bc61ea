"""Names to files: a cell, a configuration, a traffic mix, an entry kind, a
model architecture, a per-layer metric and a kernel family are each a file
found by its name, so a later change adds one by adding files and
``BENCHMARK.json`` entries."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a name (letters, digits, _ . -, at most 64)")
    return name


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    return read_json(os.path.join(BENCH_DIR, "workloads", check_name(name) + ".json"))


def config(name: str) -> dict:
    """A configuration; it names its architecture (``architectures/<name>.py``)
    under ``"architecture"``, which has no default."""
    path = os.path.join(BENCH_DIR, "configs", check_name(name) + ".json")
    got = read_json(path)
    if "architecture" not in got:
        raise KeyError(f"{path}: no \"architecture\" key (the name of a file in "
                       "port_bench/architectures/)")
    return got


def traffic(name: str) -> dict:
    return read_json(os.path.join(BENCH_DIR, "traffic", check_name(name) + ".json"))


def kernel_family(name: str) -> dict:
    return read_json(os.path.join(BENCH_DIR, "kernels", check_name(name) + ".json"))


def load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(kind: str) -> ModuleType:
    return load_module(os.path.join(BENCH_DIR, "entries", check_name(kind) + ".py"),
                       f"port_bench_entry_{kind}")


def architecture(name: str) -> ModuleType:
    """The module that builds a configuration's models: ``reference``,
    ``program``, ``request_parts``, ``train_step_parts``,
    ``reference_request`` and ``reference_steps``."""
    return load_module(os.path.join(BENCH_DIR, "architectures", check_name(name) + ".py"),
                       "port_bench_architecture_" + name.replace(".", "_").replace("-", "_"))


def metric_reader(name: str) -> ModuleType:
    return load_module(os.path.join(BENCH_DIR, "metrics", check_name(name) + ".py"),
                       "port_bench_metric_" + name.replace(".", "_").replace("-", "_"))


def metrics_of(bench: dict, section: str, cell_name: str) -> List[dict]:
    """The metrics of ``BENCHMARK.json``'s ``section`` that ``cell_name``
    reports: those that list it, and those without a list whose ``moves``
    (per layer) the cell reports or (end to end) that list no cells."""
    e2e = {m["name"] for m in bench.get("end_to_end", [])
           if m.get("workloads") is None or cell_name in m["workloads"]}
    out = []
    for m in bench.get(section, []):
        cells: Optional[list] = m.get("workloads")
        if cells is not None:
            if cell_name in cells:
                out.append(m)
        elif section == "end_to_end" or m.get("moves") in e2e:
            out.append(m)
    return out


def derive(seed: int, *labels) -> int:
    """A 63-bit seed for one stream of a run, from ``--seed`` and a label:
    the same seed gives the same streams, any whole number is taken."""
    text = ":".join([str(int(seed))] + [str(x) for x in labels])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1
