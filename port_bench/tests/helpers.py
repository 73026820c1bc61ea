"""Running the benchmark's command in a subprocess, and its last line."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY_BENCH = os.path.join(ROOT, "port_bench", "tests", "data", "tiny_benchmark.json")


def run_cell(workload, seed=20251017, seconds=1, trace=0, bench=TINY_BENCH, root=ROOT,
             extra=(), timeout=1500):
    """-> (exit code, the last stdout line as JSON or None, stderr)."""
    cmd = [sys.executable, os.path.join(root, "port_bench", "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
           "--benchmark", bench, *extra]
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env, cwd=root)
    lines = [x for x in p.stdout.splitlines() if x.strip()]
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr
