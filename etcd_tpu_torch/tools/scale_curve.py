"""Multi-core aggregate scale curve: acked writes/s vs pool shards, with
the in-process compartments (applier_shards x wal_shards) inside every
shard process.

Shape: M independent engine PROCESSES, each owning groups/M tenants —
tools/pool_serve.py's sharding convention — but driven bench-style
in-process (the deep-queue offered-load loop: every group's pending
queue topped to --depth before each round) instead of through the HTTP
router: the curve measures what the engine pool sustains, not what one
Python router can proxy. Each worker reports its own acked/s over its
own window; the aggregate is the sum. Every worker's engine runs on
--device ("cuda", the card, unless the caller asks for "cpu"); M
workers may share one card.

Workers run concurrently and start measuring on a GO barrier AFTER all
elections converge, so M processes share the machine exactly like a
real pool deployment. Where the machine has fewer cores than M the curve
goes flat (time-slicing conserves throughput); the output carries
cores_visible so a reader can tell which regime a point was measured in.

Usage:
    python -m etcd_tpu_torch.tools.scale_curve --groups 2048 \
        --pool-shards 1,2,4 --applier-shards 2 --wal-shards 2 \
        --seconds 20 [--device cpu]
Prints one JSON object: {"curve": [...], "cores_visible": N, ...}.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from etcd_tpu_torch.tools.launch import child_env


def worker(args) -> int:
    """One pool shard: boot G/M groups, wait for leaders, signal READY,
    block for GO, then drive the deep-queue loop for --seconds."""
    import numpy as np

    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from etcd_tpu_torch.server.request import Request

    G = args.groups
    with tempfile.TemporaryDirectory(prefix="scale-") as tmp:
        eng = MultiEngine(EngineConfig(
            groups=G, peers=args.peers, data_dir=tmp, window=16,
            max_ents=4, heartbeat_tick=3, fsync=True, stagger=True,
            applier_shards=args.applier_shards,
            wal_shards=args.wal_shards,
            checkpoint_rounds=1 << 30, device=args.device))

        def all_led():
            return bool((np.where(eng.h_mask, eng.h_state, 0) == 2)
                        .any(axis=1).all())

        for _ in range(12):
            eng.run_round()
            if all_led():
                break
        assert all_led(), "elections did not converge"

        payload = Request(method="PUT", path="/bench/k", val="x" * 64)
        pool = []
        for _ in range(4096):
            rid = eng.reqid.next()
            rq = Request(**{**payload.__dict__, "id": rid})
            pool.append((rid, b"\x00" + rq.encode(), rq))
        pool_i = 0

        def offer(depth):
            nonlocal pool_i
            with eng._lock:
                for g in range(G):
                    dq = eng._pending[g]
                    while len(dq) < depth:
                        dq.append(pool[pool_i & 4095])
                        pool_i += 1
                    eng._dirty.add(g)

        for _ in range(5):   # warm the serving loop
            offer(4)
            eng.run_round()

        print("READY", flush=True)
        assert sys.stdin.readline().strip() == "GO"

        a0 = eng.acked_requests
        t0 = time.time()
        end = t0 + args.seconds
        r = 0
        while time.time() < end or r < 5:
            offer(args.depth)
            eng.run_round()
            r += 1
            if r >= 100000:
                break
        elapsed = time.time() - t0
        acked = eng.acked_requests - a0
        for _ in range(200):   # settle before stats/teardown
            eng.run_round()
            with eng._lock:
                if not any(eng._pending[g] for g in range(G)):
                    break
        eng._drain_applies()
        wal_stats = eng.wal.stats()
        eng.stop()
    print(json.dumps({"acked": acked, "elapsed": round(elapsed, 3),
                      "rounds": r,
                      "acked_per_sec": round(acked / elapsed, 1),
                      **wal_stats}), flush=True)
    return 0


def run_point(M, args):
    per = args.groups // M
    procs = []
    for _ in range(M):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "etcd_tpu_torch.tools.scale_curve",
             "--worker", "--device", args.device,
             "--groups", str(per), "--peers", str(args.peers),
             "--applier-shards", str(args.applier_shards),
             "--wal-shards", str(args.wal_shards),
             "--seconds", str(args.seconds),
             "--depth", str(args.depth)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=child_env()))
    try:
        for p in procs:
            assert p.stdout.readline().strip() == "READY", "worker died"
        for p in procs:    # barrier: all measure concurrently
            p.stdin.write("GO\n")
            p.stdin.flush()
        shards = [json.loads(p.stdout.readline()) for p in procs]
        for p in procs:
            assert p.wait(timeout=120) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    agg = round(sum(s["acked_per_sec"] for s in shards), 1)
    return {"pool_shards": M, "groups_per_shard": per,
            "applier_shards": args.applier_shards,
            "wal_shards": args.wal_shards,
            "aggregate_acked_writes_per_sec": agg,
            "depth": args.depth, "fsync": True,
            "per_shard": shards}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=2048,
                    help="TOTAL tenant groups, split across pool shards")
    ap.add_argument("--peers", type=int, default=5)
    ap.add_argument("--pool-shards", default="1,2,4",
                    help="comma list of M values (engine process counts)")
    ap.add_argument("--applier-shards", type=int, default=2)
    ap.add_argument("--wal-shards", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="measurement window per worker per point")
    ap.add_argument("--depth", type=int, default=64,
                    help="offered queue depth per tenant (deep-queue)")
    ap.add_argument("--device", default="cuda",
                    help="where every worker's engine runs: cuda (the "
                         "card) or cpu")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)

    points = []
    for M in [int(x) for x in args.pool_shards.split(",") if x]:
        if args.groups % M:
            print(f"skipping M={M}: does not divide {args.groups}",
                  file=sys.stderr)
            continue
        t0 = time.time()
        pt = run_point(M, args)
        print(f"M={M}: {pt['aggregate_acked_writes_per_sec']:,.0f} "
              f"acked writes/s aggregate ({time.time() - t0:.0f}s)",
              file=sys.stderr, flush=True)
        points.append(pt)
    out = {"curve": points, "groups_total": args.groups,
           "cores_visible": os.cpu_count(),
           "note": ("aggregate acked writes/s vs pool shards; flat "
                    "above cores_visible = time-sliced, not scaled")}
    print(json.dumps(out, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
