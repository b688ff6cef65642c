"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU for each
chip the cell asks for. With `--trace 0` the result carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics and the
device's busy and window seconds from a profiler window. The last line
of standard output is the result, as one JSON object; the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error and the result's last key.

Two options serve the measurements behind the benchmark's settings, one
process a run, and are never part of a cell's command: `--rate <writes/s>`
offers the mix at another rate (the knee sweep), and `--control` runs the
control, the program's own fsync-off path, which acks before the WAL is
durable and has to come out not correct.

The system under test is `etcd_tpu_torch`. The run exits non-zero and
prints no result where there is no card (or fewer than the cell asks
for), where the run fails, and where the process holds JAX, Flax or the
JAX package once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()

# Top-level module names the process may not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "etcd_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock (from the kernel's
    record of it; the module's import time where that is not readable)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_IMPORT


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="offer the mix at this many writes/s")
    ap.add_argument("--control", action="store_true",
                    help="run the control: the program with fsync off")
    return ap.parse_args(argv)


def result_line(man, cell, res, trace: bool, kind: str, count: int) -> dict:
    from benchmark import reference
    metrics = man.read_metrics(cell, trace, res.obs)
    checks = {k: {"value": res.checks[k], "limit": 0}
              for k in reference.CHECKS}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu", "kind": kind, "count": count, **res.device}
    out = {"correct": correct, "attempted": res.attempted,
           "failed": res.failed, "metrics": metrics, "device": device}
    if trace and res.breakdown is not None:
        out["breakdown"] = res.breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    t_process = process_start()
    args = parse(argv)
    from benchmark import driver, manifest
    man = manifest.Manifest(Path(__file__).resolve().parents[1])
    cell = man.cell(args.workload)
    import etcd_tpu_torch  # noqa: F401 — the system under test must be here
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    config, mix = man.config(cell), man.traffic(cell)
    if args.control:
        config["fsync"] = False
    if args.rate is not None:
        mix["rate_per_s"] = args.rate
    res = driver.run_cell(config, mix, args.seed, args.seconds,
                          bool(args.trace), "cuda:0", t_process)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad}", file=sys.stderr)
        return 3
    out = result_line(man, cell, res, bool(args.trace),
                      torch.cuda.get_device_name(0), cell.chips)
    import numpy as np
    lat = res.obs["latencies_ms"]
    tail = {f"ack_p{q}_ms": float(np.percentile(lat, q)) if len(lat)
            else None for q in (90, 95, 99)}
    print(json.dumps({"generator": res.generator,
                      "ack_quantiles": tail}), flush=True)
    print("generator: " + ", ".join(f"{k} {v}" for k, v in
                                     res.generator.items()), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
