"""What the benchmark loads: no module whose top-level name is jax, jaxlib,
flax, optax or cvd_tpu (compared whole: cvd_tpu_torch is the program), and
the reference loads nothing of the program either."""
import ast
import os
import subprocess
import sys

import pytest

from port_bench.lib import names
from port_bench.lib.result import FORBIDDEN, forbidden_modules

BENCH = names.BENCH_DIR


def _py_files(sub):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_name_comparison():
    assert forbidden_modules({"cvd_tpu_torch": 1, "cvd_tpu_torch.ops": 1, "jaxtyping": 1}) == []
    assert forbidden_modules({"cvd_tpu.ops": 1, "jax": 1, "flax.linen": 1}) == [
        "cvd_tpu.ops", "flax.linen", "jax"]


@pytest.mark.parametrize("sub", ["reference", "lib", "entries", "architectures", "metrics",
                                 "traffic"])
def test_sources_name_no_forbidden_module(sub):
    for path in _py_files(sub):
        for mod in _imported(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
            if sub == "reference":
                assert mod.split(".")[0] != "cvd_tpu_torch", (path, mod)


def test_loaded_modules():
    code = (
        "import sys, glob, os\n"
        "sys.path.insert(0, %r)\n"
        "import port_bench.reference.model, port_bench.reference.sampling, "
        "port_bench.reference.training, port_bench.reference.data\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == 'cvd_tpu_torch')\n"
        "from port_bench.lib import names, port, count, readers, trace, result\n"
        "for kind in ('sample_pair', 'train'): names.entry(kind)\n"
        "for f in glob.glob(os.path.join(names.BENCH_DIR, 'architectures', '*.py')):\n"
        "    names.architecture(os.path.basename(f)[:-3])\n"
        "for f in glob.glob(os.path.join(names.BENCH_DIR, 'metrics', '*.py')):\n"
        "    names.metric_reader(os.path.basename(f)[:-3])\n"
        "import cvd_tpu_torch.pipelines.simple, cvd_tpu_torch.train.program\n"
        "import cvd_tpu_torch.data.loader, cvd_tpu_torch.data.realestate10k\n"
        "import cvd_tpu_torch.data.validation, cvd_tpu_torch.train.state\n"
        "print(ref, result.forbidden_modules())\n" % names.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=names.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


STUB_READER = '''"""stub_reader: loads a module named cvd_tpu, as a reader's helper might."""


def read(rec, ctx):
    import cvd_tpu  # noqa: F401 - the stub beside the copied tree

    return 1.0
'''


def test_reader_that_loads_forbidden_module_gives_no_result(tmp_path):
    """A per-layer reader loads after the window; the run still refuses to
    print a result (exit 4) once a module named cvd_tpu has come in."""
    import json
    import shutil

    from port_bench.tests.helpers import TINY_BENCH, run_cell

    dst = tmp_path / "port_bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(".cache", ".data", "__pycache__"))
    (tmp_path / "cvd_tpu").mkdir()
    (tmp_path / "cvd_tpu" / "__init__.py").write_text('"""A stand-in for the JAX package."""\n')
    (dst / "metrics" / "stub_reader.py").write_text(STUB_READER)
    bench = json.load(open(TINY_BENCH))
    bench["per_layer"].append({"name": "stub_reader", "unit": "ops", "better": "lower",
                               "source": "program_counter", "layer": "sampler",
                               "moves": "request_s", "workloads": ["tiny-pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, err = run_cell("tiny-pair", seconds=1, trace=1,
                             bench=str(tmp_path / "BENCHMARK.json"), root=str(tmp_path))
    assert rc == 4 and line is None, err[-3000:]
    assert "['cvd_tpu']" in err
