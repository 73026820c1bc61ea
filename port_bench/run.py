"""Run one cell of the benchmark of cvd_tpu_torch once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about the cell is data found by name: ``workloads/<cell>.json``
(configuration, traffic mix, entry kind, chips, the check's limits),
``configs/<config>.json``, the architecture it names
(``architectures/<name>.py``: the models of the reference and of the
program), ``traffic/<mix>.json``, ``entries/<kind>.py``, and for ``--trace 1`` one reader per per-layer metric (``metrics/<name>.py``)
that ``BENCHMARK.json`` gives the cell. The last line of standard output is
the result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-
end ones, or with ``--trace 1`` the per-layer ones), ``device``,
``breakdown`` (traced runs) and ``checks``.

It refuses to measure (exit 3, no result) where the configuration asks for
a card and ``torch.cuda`` has fewer than the cell's chips; only a
configuration that names the CPU (the tests' tiny one) runs without one.
Exit 4 (no result): a module of JAX or of the JAX package was loaded.

``--calibrate N``: the check's readings on N seeds from ``--seed`` on, in
one process and with no window (the program's against the reference's; on
the first three also the float8 control's and, for training, the half-batch
fault's), one JSON line each; for setting the limits.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

T_IMPORT = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every kernel cache of the program inside the checkout, at a fixed path
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, ".cache", "triton")
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--benchmark", default=os.path.join(ROOT, "BENCHMARK.json"),
                   help="the benchmark file naming the cell's metrics")
    p.add_argument("--calibrate", type=int, default=0, metavar="N")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from port_bench.lib import names
    from port_bench.lib.context import Context, process_start

    t_start = min(process_start(), T_IMPORT)
    bench = names.read_json(args.benchmark)
    cell = names.cell(args.workload)
    config = names.config(cell["config"])
    mix = names.traffic(cell["traffic"])

    import torch

    t_torch = time.perf_counter()
    chips = int(cell.get("chips", 1))
    if config["device"] == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"port_bench: {args.workload} needs {chips} CUDA device(s), found {count}: "
                  "not measured", file=sys.stderr)
            return 3
        device = "cuda:0"
    elif config["device"] == "cpu":
        device = "cpu"
    else:
        raise ValueError(f"configuration {cell['config']}: device {config['device']!r}")
    with tempfile.TemporaryDirectory(prefix="port_bench-") as work:
        ctx = Context(args.workload, cell, config, mix, args.seed, args.seconds,
                      bool(args.trace), device, t_start, work)
        return _run(args, bench, ctx, chips, t_torch)


def _run(args, bench, ctx, chips, t_torch) -> int:
    from port_bench.lib import names, result

    entry = names.entry(ctx.cell["entry"])
    if args.calibrate:
        import dataclasses
        import json

        for k in range(args.calibrate):   # the control (and faults) on the first three
            got = entry.calibrate(dataclasses.replace(ctx, seed=args.seed + k), control=k < 3)
            print(json.dumps(got), flush=True)
        return 0

    rec = entry.run(ctx)
    r = rec.readings
    print(f"port_bench: setup_s {rec.e2e['setup_s']:.3f}: to run.py {T_IMPORT - ctx.t_start:.3f}, "
          f"imports {t_torch - T_IMPORT:.3f}, build {r['build_s']:.3f}, "
          f"capture {r['capture_s']:.3f}", file=sys.stderr)
    metrics = {}
    if args.trace:
        for m in names.metrics_of(bench, "per_layer", args.workload):
            value = names.metric_reader(m["name"]).read(rec, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in names.metrics_of(bench, "end_to_end", args.workload):
            metrics[m["name"]] = {"value": rec.e2e[m["name"]], "unit": m["unit"]}
    correct = (rec.attempted > 0 and rec.failed == 0 and bool(rec.checks)
               and all(c["ok"] for c in rec.checks.values()))
    breakdown = None
    if rec.trace is not None:
        from port_bench.lib.trace import breakdown as make_breakdown

        breakdown = make_breakdown(rec.trace)
    # last before the result: the readers and the breakdown have loaded too
    bad = result.forbidden_modules()
    if bad:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    result.emit(correct, rec.attempted, rec.failed, metrics,
                result.device_info(ctx.device, chips, rec.peak_bytes, rec.trace), rec.checks,
                breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
