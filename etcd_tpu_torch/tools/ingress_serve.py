"""Ingress-tier launcher: N coalescing ingress processes in front of
one upstream (a single engine front or a tools/pool_serve.py router).

The ingress tier (etcd_tpu_torch/server/ingress.py) is stateless — it
holds no WAL, no store, nothing durable — so scaling it is purely
horizontal: run one process per core, point them all at the same
upstream, and spread shallow clients across them (round-robin DNS, an
L4 balancer, or explicit striping). Each process coalesces its own
clients' writes into /tenants/{t}/batch flushes; the upstream engine
sees N deep submitters instead of tens of thousands of shallow ones.

Two upstream modes:
  --upstream URL        front an already-running engine or router
  --data-dir DIR        spawn a fresh single engine here first
                        (`python -m etcd_tpu_torch` on --engine-device,
                        "cuda" unless the caller asks for "cpu";
                        --groups/--peers/--applier-shards/--wal-shards
                        forwarded to it), then front it

Usage:
    python -m etcd_tpu_torch.tools.ingress_serve --data-dir /tmp/ing \
        --ingress 2 [--engine-device cpu]
    python -m etcd_tpu_torch.tools.ingress_serve \
        --upstream http://127.0.0.1:4001

Prints one JSON line {"ingress": [ports], "upstream": url,
"pids": [...]} then serves until SIGTERM, tearing down every child.
"""
import argparse
import json
import signal
import subprocess
import sys
import threading
import time
import urllib.request

from etcd_tpu_torch.tools.launch import child_env, free_ports


def _wait_ready(url: str, deadline: float) -> bool:
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url + "/engine/status",
                                        timeout=2) as r:
                st = json.loads(r.read())
            if st.get("groups_with_leader") == st.get("groups"):
                return True
        except Exception:  # noqa: BLE001 — still booting
            pass
        time.sleep(0.5)
    return False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--upstream", default=None,
                    help="existing engine/router base URL; omit to "
                         "spawn an engine (--data-dir required)")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--ingress", type=int, default=1,
                    help="number of ingress processes")
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--peers", type=int, default=3)
    ap.add_argument("--applier-shards", type=int, default=1)
    ap.add_argument("--wal-shards", type=int, default=1)
    ap.add_argument("--flush-max-requests", type=int, default=1024)
    ap.add_argument("--flush-max-bytes", type=int, default=1 << 20)
    ap.add_argument("--read-lease-ms", type=int, default=0)
    ap.add_argument("--engine-device", default="cuda",
                    help="where a spawned engine runs: cuda (the card) "
                         "or cpu")
    args = ap.parse_args()

    env = child_env()

    procs = []
    upstream = args.upstream
    if upstream is None:
        if not args.data_dir:
            ap.error("--data-dir is required without --upstream")
        (eport,) = free_ports(1)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "etcd_tpu_torch",
             "--engine-groups", str(args.groups),
             "--engine-peers", str(args.peers),
             "--engine-applier-shards", str(args.applier_shards),
             "--engine-wal-shards", str(args.wal_shards),
             "--engine-device", args.engine_device,
             "--data-dir", args.data_dir,
             "--listen-client-urls", f"http://127.0.0.1:{eport}"],
            env=env))
        upstream = f"http://127.0.0.1:{eport}"
        if not _wait_ready(upstream, time.time() + 180):
            for p in procs:
                p.kill()
            print(json.dumps({"error": "engine never became ready"}))
            return 1

    ing_ports = free_ports(args.ingress)
    ing_procs = []
    for port in ing_ports:
        p = subprocess.Popen(
            [sys.executable, "-m", "etcd_tpu_torch.server.ingress",
             "--upstream", upstream, "--port", str(port),
             "--flush-max-requests", str(args.flush_max_requests),
             "--flush-max-bytes", str(args.flush_max_bytes),
             "--read-lease-ms", str(args.read_lease_ms)],
            env=env, stdout=subprocess.PIPE)
        p.stdout.readline()          # its {"port": ...} ready line
        ing_procs.append(p)
    procs.extend(ing_procs)

    print(json.dumps({"ingress": ing_ports, "upstream": upstream,
                      "pids": [p.pid for p in procs]}), flush=True)

    done = threading.Event()
    # Same indirection as pool_serve.py: never block in the handler.
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    try:
        done.wait()
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
