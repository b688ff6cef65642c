"""Pool-sharded serving: K engine processes on one machine, each owning
G/K tenant groups, behind one thin HTTP router.

The single-host MultiEngine's round loop is one Python process; its
documented multi-core deployment path is POOL SHARDING — global tenant
t lives in shard s = t // (G/K) as that shard's local tenant t % (G/K).
This launcher makes the path concrete: clients keep using global
/tenants/{t}/... URLs against ONE port; the router rewrites the tenant
id and proxies to the owning shard (watch long-polls are piped through
unbuffered, with no read timeout). A shard process dying takes down
only its own tenants (503 with a Retry-After; the others keep serving)
— the pool is K independent failure domains, exactly like running K
separate etcd clusters behind a front. The coalesced write surface
POST /tenants/{t}/batch (etcdhttp/tenants.py) rides the same generic
per-tenant rewrite as every other /tenants/{t}/... path, so an ingress
tier (server/ingress.py, tools/ingress_serve.py) pointed at the router
flushes through it: each flush lands whole on the shard owning its
tenant — a batch never spans shards because a lane never spans tenants.
The router refuses the ingress's upgraded batchframe channel (501), so
such an ingress flushes JSON batches. Scope:
PER-TENANT paths and /health only; pool-level surfaces (tenant
lifecycle, pool listing) are refused with 501 and run against shard
ports directly — one shard answering for the pool would misreport it.

Every shard is `python -m etcd_tpu_torch` on `--engine-device` ("cuda",
the card, unless the caller asks for "cpu"); K shards may share one
card. Process sharding and the in-process compartments compose:
--applier-shards K gives EVERY shard process its own K-worker applier
pool (engine.EngineConfig.applier_shards) and --wal-shards S gives each
its own S-stream WAL-writer pool (EngineConfig.wal_shards).

Usage:
    python -m etcd_tpu_torch.tools.pool_serve --groups 16 --shards 2 \
        --port 0 --data-dir /tmp/pool [--peers 3] [--window 32] \
        [--applier-shards 4] [--wal-shards 4] [--engine-device cpu]
Prints one JSON line {"router": port, "shards": [ports], "pids": [...],
"groups": G, "per_shard": G/K, "boot_s": [seconds from the spawn to
every group led, per shard]} then serves until SIGTERM.
"""
import argparse
import http.client
import http.server
import json
import os
import signal
import socketserver
import subprocess
import sys
import threading
import time
import urllib.request

from etcd_tpu_torch.server.obs import pool_router_requests
from etcd_tpu_torch.tools.launch import child_env, free_ports
from etcd_tpu_torch.utils.metrics import REGISTRY, fd_usage


def make_router(groups: int, per_shard: int, shard_ports):
    class Router(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _route(self):
            """Per-tenant paths route by global id; /health probes shard
            0. Anything else — POOL-level surfaces like tenant lifecycle
            (POST /tenants) or the pool listing — is explicitly refused
            with 501: answering from one shard would silently misreport
            the pool (a local id would read as global, and shards >= 1
            would be invisible). Lifecycle runs against shard ports
            directly; the pool map is static (--groups/--shards). So are
            PUT and DELETE on the bare /tenants/{t} path (create, remove):
            the shard would answer with its local id."""
            path, sep, query = self.path.partition("?")
            parts = path.split("/", 3)
            if len(parts) >= 3 and parts[1] == "tenants" and parts[2]:
                try:
                    t = int(parts[2])
                except ValueError:
                    return None, None
                if not 0 <= t < groups:
                    return None, None
                rest = parts[3] if len(parts) > 3 else ""
                if rest == "" and self.command in ("PUT", "DELETE"):
                    return -1, self.path
                s = t // per_shard
                local = t % per_shard
                return s, f"/tenants/{local}/{rest}{sep}{query}"
            if parts[1:2] == ["health"]:
                return 0, self.path
            return -1, self.path

        def _metrics(self):
            used, limit = fd_usage()
            body = (REGISTRY.expose()
                    + "# HELP process_open_fds Number of open file "
                      "descriptors.\n"
                      "# TYPE process_open_fds gauge\n"
                      f"process_open_fds {float(used)}\n"
                      "# HELP process_max_fds Maximum number of open "
                      "file descriptors.\n"
                      "# TYPE process_max_fds gauge\n"
                      f"process_max_fds {float(limit)}\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _proxy(self):
            if self.path == "/metrics" and self.command == "GET":
                self._metrics()
                return
            s, path = self._route()
            if path is None:
                pool_router_requests.labels("none").inc()
                self.send_error(404, "unknown tenant")
                return
            if s == -1:
                pool_router_requests.labels("none").inc()
                self.send_error(
                    501, "pool router serves per-tenant paths only")
                return
            if self.headers.get("Upgrade"):
                # An upgraded channel (the ingress's batchframe) is not
                # relayed: the router proxies request/response exchanges
                # only. A non-101 answer makes an ingress in auto mode
                # flush through POST /tenants/{t}/batch instead, which
                # the router proxies like any per-tenant path.
                pool_router_requests.labels("none").inc()
                self.send_error(
                    501, "pool router does not relay upgraded channels")
                return
            pool_router_requests.labels(str(s)).inc()
            body = None
            ln = self.headers.get("Content-Length")
            if ln:
                body = self.rfile.read(int(ln))
            # Watch long-polls (?wait=true) can legitimately idle for
            # minutes and stream=true never ends: no read timeout for
            # them, and the body is PIPED chunk-by-chunk (with
            # Connection: close framing) instead of buffered — a dead
            # shard still surfaces as 503 because the failure we map
            # there is the CONNECT/request step, handled before any
            # bytes are relayed.
            is_watch = "wait=true" in self.path
            try:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", shard_ports[s],
                    timeout=None if is_watch else 30)
                conn.request(self.command, path, body=body,
                             headers={k: v for k, v in self.headers.items()
                                      if k.lower() != "host"})
                resp = conn.getresponse()
            except OSError:
                # The owning shard is down: its tenants are unavailable,
                # everyone else's keep serving — per-shard failure domain.
                self.send_response(503)
                self.send_header("Retry-After", "5")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            try:
                self.send_response(resp.status)
                hdrs = {k.lower(): v for k, v in resp.getheaders()}
                for k, v in resp.getheaders():
                    if k.lower() in ("transfer-encoding", "connection",
                                     "content-length"):
                        continue
                    self.send_header(k, v)
                if is_watch or "content-length" not in hdrs:
                    self.send_header("Connection", "close")
                    self.close_connection = True
                    self.end_headers()
                    while True:
                        chunk = resp.read(4096)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                        self.wfile.flush()
                else:
                    data = resp.read()
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
            except OSError:
                self.close_connection = True   # client or shard went away
            finally:
                conn.close()

        do_GET = do_PUT = do_POST = do_DELETE = _proxy

        def log_message(self, fmt, *args):  # quiet
            pass

    return Router


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--peers", type=int, default=3,
                    help="peer slots per group (engine --engine-peers)")
    ap.add_argument("--window", type=int, default=32,
                    help="log ring length per slot (engine "
                         "--engine-window)")
    ap.add_argument("--engine-device", default="cuda",
                    help="where every shard's engine runs: cuda (the "
                         "card) or cpu")
    ap.add_argument("--applier-shards", type=int, default=1,
                    help="applier pool size INSIDE each shard process "
                         "(engine --engine-applier-shards)")
    ap.add_argument("--wal-shards", type=int, default=1,
                    help="WAL-writer pool size INSIDE each shard process: "
                         "per-tenant-range segment streams with parallel "
                         "group-commit fsyncs (engine --engine-wal-shards)")
    args = ap.parse_args()
    G, K = args.groups, args.shards
    if G % K:
        ap.error("--groups must divide evenly by --shards")
    per = G // K
    shard_ports = free_ports(K)

    procs = []
    t_spawn = time.time()
    for k in range(K):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "etcd_tpu_torch",
             "--engine-groups", str(per), "--engine-peers", str(args.peers),
             "--engine-window", str(args.window),
             "--engine-applier-shards", str(args.applier_shards),
             "--engine-wal-shards", str(args.wal_shards),
             "--engine-device", args.engine_device,
             "--data-dir", os.path.join(args.data_dir, f"shard{k}"),
             "--listen-client-urls",
             f"http://127.0.0.1:{shard_ports[k]}"],
            env=child_env()))

    # Wait for every shard to lead all its groups; large shards sharing
    # one card take tens of seconds.
    deadline = time.time() + 600
    ready = [False] * K
    boot_s = [None] * K
    while time.time() < deadline and not all(ready):
        for k in range(K):
            if ready[k]:
                continue
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{shard_ports[k]}/engine/status",
                        timeout=2) as r:
                    st = json.loads(r.read())
                ready[k] = st.get("groups_with_leader") == st.get("groups")
                if ready[k]:
                    boot_s[k] = time.time() - t_spawn
            except Exception:  # noqa: BLE001 — still booting
                pass
        time.sleep(0.5)
    if not all(ready):
        for p in procs:
            p.kill()
        print(json.dumps({"error": "shards never became ready"}))
        return 1

    class Srv(socketserver.ThreadingMixIn, http.server.HTTPServer):
        daemon_threads = True
        # Every ingress lane and every client opens its own connection:
        # socketserver's backlog of 5 overflows, and an overflowed
        # accept queue delays connects by SYN retries or resets them.
        request_queue_size = 4096

    srv = Srv(("127.0.0.1", args.port),
              make_router(G, per, shard_ports))
    print(json.dumps({"router": srv.server_address[1],
                      "shards": shard_ports,
                      "pids": [p.pid for p in procs],
                      "groups": G, "per_shard": per,
                      "boot_s": boot_s}), flush=True)

    def on_term(signum, frame):
        # shutdown() BLOCKS until serve_forever exits; a signal handler
        # runs ON the serve_forever thread, so calling it synchronously
        # deadlocks — the router then never reaches the finally that
        # terminates the shard processes, and a supervisor killing the
        # stuck router leaks them (exactly how a shard orphan escaped a
        # test teardown). Shut down from a helper thread instead.
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    try:
        srv.serve_forever(poll_interval=0.2)
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
