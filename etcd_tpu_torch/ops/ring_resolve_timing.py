"""Timing of the `ring_resolve` kernel on one NVIDIA GPU, and an A/B of
two checkouts' kernels taken in turns on one card:

    python3 -m etcd_tpu_torch.ops.ring_resolve_timing OLD_TREE

OLD_TREE is an earlier commit's checkout, unpacked with `git archive`;
"new" is the checkout holding this file. Each turn is a fresh process
that imports `etcd_tpu_torch` from its tree alone (that tree's wrapper,
kernel and build), makes the same inputs from the same seed at the
round's two main-path shapes, idx (100000, 5, 5) and (100000, 5, 4),
checks the kernel equal to the tree's plain version, and prints one JSON
line of times. The turns go old, new, new, old; the last line holds
each tree's mean over its two turns.
Needs a CUDA device; exits nonzero without one.

The helpers (inputs, CUDA-event and CUDA-graph loops, host µs per call)
are `chip_smoke.py`'s too. The loops take a callable; `rotating` makes
one that walks `COPIES` copies of the inputs, so that every call finds
its working set cold in the card's 50 MB L2, as the round's calls do.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

G, P, W, E = 100_000, 5, 16, 4
SEED = 1234
COPIES = 8      # at TE=5 about 22 MB streamed + 18 MB of ring rows each
TURNS = ("old", "new", "new", "old")


def resolve_inputs(rng, trailing, groups=G, w=W, peers=P):
    """Random ring/idx/last of `groups` × `peers` rows with indices < 1,
    negative, below the window and above last, all present."""
    ring = rng.randint(1, 9, (groups, peers, w)).astype(np.int32)
    last = rng.randint(0, 3 * w, (groups, peers)).astype(np.int32)
    idx = rng.randint(-2 * w, 3 * w + 2,
                      (groups, peers) + trailing).astype(np.int32)
    return ring, idx, last


def rotating(fn, args, copies: int = COPIES):
    """A callable that calls fn on `copies` clones of the tensors `args`
    in turn."""
    sets = itertools.cycle([tuple(a.clone() for a in args)
                            for _ in range(copies)])
    return lambda: fn(*next(sets))


def cuda_ms(fn, iters: int = 50) -> float:
    """Mean time per call of fn() over `iters` calls after a warm-up, on
    CUDA events: the device's time and the host's launch path."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Mean device time per call of fn() replayed from one CUDA graph of
    `iters` calls: the kernel without the host's launch path."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    return cuda_ms(g.replay, iters=5) / iters


def host_us(fn, calls: int = 1000) -> tuple:
    """(host µs per call over `calls` calls with no synchronise, µs per
    call once one synchronise has followed them)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    total = time.perf_counter() - t
    return host / calls * 1e6, total / calls * 1e6


def _turn(name: str) -> int:
    """One tree's times at both main-path shapes, as one JSON line."""
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve, ring_resolve_ref
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(SEED)
    out = {"tree": name}
    for label, trailing in (("send_assembly", (P,)), ("conflict_scan", (E,))):
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in resolve_inputs(rng, trailing))
        if not torch.equal(ring_resolve(*args), ring_resolve_ref(*args)):
            raise AssertionError(f"{name}: ring_resolve != plain at {label}")
        fn = rotating(ring_resolve, args)
        out[label] = {"ms": cuda_ms(fn), "graph_ms": graph_ms(fn),
                      "host_us_per_call": host_us(fn)[0]}
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    import argparse
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--turn"]:
        return _turn(argv[1])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", help="an earlier commit's checkout, unpacked")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ring_resolve_timing: no CUDA device", file=sys.stderr)
        return 2
    trees = {"old": Path(args.old).resolve(),
             "new": Path(__file__).resolve().parents[2]}
    lines = []
    for name in TURNS:
        # -P: the tree on PYTHONPATH is the only etcd_tpu_torch in reach.
        res = subprocess.run(
            [sys.executable, "-P", str(Path(__file__).resolve()), "--turn",
             name], cwd=trees[name], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(trees[name])), timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        lines.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(lines[-1]), flush=True)
    means = {label: {f"{name}_{k}": float(np.mean(
        [ln[label][k] for ln in lines if ln["tree"] == name]))
        for name in trees for k in lines[0][label]}
        for label in ("send_assembly", "conflict_scan")}
    print(json.dumps({"ab_order": TURNS, "means": means}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
