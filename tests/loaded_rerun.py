"""Rerun pytest node ids under load, to catch what fails only on a busy box.

Each round starts COPIES pytest processes at once on the same node ids
(each with a base temp dir of its own), beside BUSY processes that spin
`while True: pass` for the whole loop, and waits for all of them. One
JSON line per run (round, copy, exit code, each node id's outcome and,
for a failure, pytest's one-line reason), then a summary line: per node id, how many runs passed, failed or errored.

    python tests/loaded_rerun.py --rounds 10 \\
        tests/test_torch_client.py::test_sdk_stream_equals_the_jax_packages

`--root DIR` runs the tests of another tree (a copy of the parent made
with `git archive`) from DIR. Exit code 1 if any run failed."""
import argparse
import collections
import json
import os
import re
import signal
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600.0                     # one copy's pytest, then it is killed
OUTCOME = re.compile(r"^(PASSED|FAILED|ERROR) (\S+)(?: - (.*))?")


def _outcomes(log):
    """({node id: outcome}, {node id: reason}) from a pytest `-rA` short
    summary; a reason for each failure or error."""
    out, why = {}, {}
    for line in log.splitlines():
        m = OUTCOME.match(line)
        if m:
            out[m.group(2)] = m.group(1)
            if m.group(1) != "PASSED":
                why[m.group(2)] = m.group(3) or ""
    return out, why


def run(nodeids, root=ROOT, rounds=10, copies=6, busy=6, emit=print):
    """The loop; returns {"runs", "runs_failed", "by_test"}."""
    # Wide, so that pytest does not cut a failure's reason off its line.
    env = dict(os.environ, JAX_PLATFORMS="cpu", COLUMNS="4000")
    spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(busy)]
    procs = []
    by_test = collections.defaultdict(collections.Counter)
    runs = runs_failed = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for r in range(rounds):
                procs = [subprocess.Popen(
                    [sys.executable, "-m", "pytest", *nodeids, "-q", "-rA",
                     "-p", "no:cacheprovider", "-p", "no:randomly",
                     f"--basetemp={tmp}/r{r}c{c}"],
                    cwd=root, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
                    for c in range(copies)]
                for c, p in enumerate(procs):
                    try:
                        log, _ = p.communicate(timeout=TIMEOUT_S)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        log, _ = p.communicate()
                    got, why = _outcomes(log)
                    for node, outcome in got.items():
                        by_test[node][outcome] += 1
                    runs += 1
                    runs_failed += p.returncode != 0
                    line = {"round": r, "copy": c, "rc": p.returncode,
                            "tests": got}
                    if why:
                        line["why"] = why
                    emit(json.dumps(line))
    finally:
        for p in spin + procs:
            p.kill()
            p.wait()
    return {"runs": runs, "runs_failed": runs_failed,
            "by_test": {k: dict(v) for k, v in sorted(by_test.items())}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nodeids", nargs="+")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--copies", type=int, default=6)
    ap.add_argument("--busy", type=int, default=6)
    a = ap.parse_args(argv)
    # SIGTERM unwinds through run()'s cleanup, as Ctrl-C does.
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    summary = run(a.nodeids, root=a.root, rounds=a.rounds, copies=a.copies,
                  busy=a.busy)
    print(json.dumps(summary), flush=True)
    return 1 if summary["runs_failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
