"""Pool-sharded serving through the port's launcher
(etcd_tpu_torch/tools/pool_serve.py, `--engine-device cpu`): K=2 engine
processes (`python -m etcd_tpu_torch`) each own G/K tenants behind one
router port. A mirror of tests/test_pool_serve.py: the global tenant-id
mapping and cross-shard isolation, the batch surface through the
router, the router's 404 and 501 refusals, a watch piped through it,
and the per-shard failure domain (one shard dying 503s only its own
tenants). Beyond the mirror: the router answers the ingress's
batchframe upgrade with 501, and an ingress (`ingress_serve`) in front
of the router serves writes on both shards."""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, K = 8, 2


def _put(port, t, key, val, timeout=25):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/tenants/{t}/v2/keys{key}",
        data=f"value={val}".encode(), method="PUT")
    req.add_header("Content-Type", "application/x-www-form-urlencoded")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status


def _get(port, t, key, timeout=25):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/tenants/{t}/v2/keys{key}",
            timeout=timeout) as r:
        return json.loads(r.read())


def test_pool_sharded_serving(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch.tools.pool_serve",
         "--groups", str(G), "--shards", str(K),
         "--data-dir", str(tmp_path), "--engine-device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    info = {}
    try:
        line = p.stdout.readline()
        info = json.loads(line)
        assert "error" not in info, info
        port = info["router"]
        pids = info["pids"]
        assert info["per_shard"] == G // K
        assert len(info["boot_s"]) == K and all(
            s > 0 for s in info["boot_s"])
        # Every shard is the port's CLI on the CPU.
        for pid in pids:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            assert argv[1:3] == [b"-m", b"etcd_tpu_torch"], argv
            assert argv[argv.index(b"--engine-device") + 1] == b"cpu"

        # Every GLOBAL tenant id writable through the one router port;
        # same key, different tenants — isolation across the shard cut.
        for t in range(G):
            assert _put(port, t, "/k", f"v{t}") == 201
        for t in range(G):
            assert _get(port, t, "/k")["node"]["value"] == f"v{t}"

        # The coalesced write surface rides the same tenant rewrite:
        # one batch per tenant, each landing whole on the owning shard
        # (t=1 -> shard 0, t=G-1 -> shard 1), slot statuses intact.
        for t in (1, G - 1):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/tenants/{t}/batch",
                data=json.dumps({"reqs": [
                    {"method": "PUT", "path": "/b", "value": f"b{t}"},
                    {"method": "PUT", "path": "/b", "value": "nope",
                     "prevValue": "wrong"},
                ]}).encode(), method="POST")
            req.add_header("Content-Type", "application/json")
            with urllib.request.urlopen(req, timeout=25) as r:
                rs = json.loads(r.read())["results"]
            assert [x["status"] for x in rs] == [201, 412], (t, rs)
        for t in (1, G - 1):
            assert _get(port, t, "/b")["node"]["value"] == f"b{t}"

        # Out-of-pool tenant id: the router rejects it, not a shard.
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, G + 3, "/k")
        assert ei.value.code == 404

        # Pool-level surfaces are explicitly refused (one shard must not
        # answer for the whole pool).
        with pytest.raises(urllib.error.HTTPError) as ei:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/tenants", timeout=10):
                pass
        assert ei.value.code == 501

        # The router relays no upgraded channel: a batchframe handshake
        # gets a plain 501, so an ingress in auto mode flushes JSON
        # batches through it (the shard's own front would answer 101).
        import socket
        from etcd_tpu_torch.server import batchframe
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(batchframe.handshake_request(1, f"127.0.0.1:{port}"))
            status = batchframe.read_handshake_status(s.makefile("rb"))
        assert status == 501
        ing = subprocess.Popen(
            [sys.executable, "-m", "etcd_tpu_torch.tools.ingress_serve",
             "--upstream", f"http://127.0.0.1:{port}", "--ingress", "1"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        try:
            (ing_port,) = json.loads(ing.stdout.readline())["ingress"]
            for t in (0, G - 1):      # one tenant on each shard
                assert _put(ing_port, t, "/via-ingress", f"i{t}") == 201
                assert _get(port, t, "/via-ingress")["node"]["value"] == \
                    f"i{t}"
        finally:
            ing.send_signal(signal.SIGTERM)
            assert ing.wait(timeout=30) == 0

        # Watch long-poll THROUGH the router: piped, not buffered — the
        # event must arrive while the connection stays open.
        import threading
        got = {}

        def watcher():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/tenants/5/v2/keys/wk"
                        f"?wait=true", timeout=30) as r:
                    got["event"] = json.loads(r.read())
            except Exception as e:  # noqa: BLE001 — asserted below
                got["error"] = e

        th = threading.Thread(target=watcher, daemon=True)
        th.start()
        time.sleep(1.5)   # let the long-poll register on the shard
        assert _put(port, 5, "/wk", "woke") == 201
        th.join(timeout=30)
        assert got.get("event", {}).get("node", {}).get("value") == \
            "woke", got

        # Kill shard 1: its tenants answer 503 (Retry-After), shard 0's
        # tenants keep serving — per-shard failure domains.
        os.kill(pids[1], signal.SIGKILL)
        time.sleep(1.0)
        deadline = time.time() + 30
        saw_503 = False
        while time.time() < deadline and not saw_503:
            try:
                _get(port, G - 1, "/k", timeout=5)
                time.sleep(0.5)
            except urllib.error.HTTPError as e:
                saw_503 = e.code == 503
            except OSError:
                time.sleep(0.5)
        assert saw_503, "dead shard's tenants never surfaced 503"
        assert _get(port, 0, "/k")["node"]["value"] == "v0"
        assert _put(port, 1, "/k2", "still-on") == 201
    finally:
        p.send_signal(signal.SIGTERM)
        router_reaped = True
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            router_reaped = False
        # Belt-and-braces ONLY when the router died without running its
        # own finally (kill above): reap the shards directly — a leaked
        # engine takes cores from every test after this module.
        # Identity-checked so a recycled PID can't get an innocent
        # process killed.
        if not router_reaped:
            for pid in info.get("pids", []):
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        if b"etcd_tpu_torch" not in f.read():
                            continue
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass


# -- the router's lifecycle refusal and query split, against a stub shard --

@pytest.fixture
def router():
    """make_router's handler at G=8 over two stub shards of 4 tenants
    each: yields (router port, [(shard, method, path) seen by the
    shards])."""
    import http.server
    import threading
    from etcd_tpu_torch.tools.pool_serve import make_router
    seen = []

    def stub(idx):
        class Shard(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _any(self):
                seen.append((idx, self.command, self.path))
                ln = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(ln)
                body = b"{}"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            do_GET = do_PUT = do_POST = do_DELETE = _any

            def log_message(self, *a):
                pass
        return http.server.ThreadingHTTPServer(("127.0.0.1", 0), Shard)

    servers = [stub(0), stub(1)]
    servers.append(http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), make_router(
            8, 4, [srv.server_address[1] for srv in servers])))
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield servers[-1].server_address[1], seen
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def _status(port, method, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=b"" if method == "PUT" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_router_refuses_tenant_lifecycle_on_the_bare_path(router):
    """PUT and DELETE on the bare /tenants/{t} path (a shard's create and
    remove, which would answer with the shard's local id) get 501 from
    the router and never reach a shard; GET of it and the per-tenant
    paths below it still route."""
    port, seen = router
    for method, path in (("PUT", "/tenants/3"), ("DELETE", "/tenants/5"),
                         ("PUT", "/tenants/6/"), ("DELETE", "/tenants/1?x=1")):
        assert _status(port, method, path) == 501, (method, path)
    assert seen == []
    assert _status(port, "GET", "/tenants/5") == 200
    assert _status(port, "PUT", "/tenants/5/v2/keys/a") == 200
    assert _status(port, "DELETE", "/tenants/6/v2/keys/a") == 200
    assert seen == [(1, "GET", "/tenants/1/"),
                    (1, "PUT", "/tenants/1/v2/keys/a"),
                    (1, "DELETE", "/tenants/2/v2/keys/a")]


def test_router_splits_the_query_off_the_tenant_id(router):
    """/tenants/3?x=1 routes to tenant 3 (shard 0, local 3) with its
    query kept; a query after the tenant's path rides along too."""
    port, seen = router
    assert _status(port, "GET", "/tenants/3?x=1") == 200
    assert _status(port, "GET", "/tenants/6?recursive=true&x=1") == 200
    assert _status(port, "GET", "/tenants/7/v2/keys/k?wait=false") == 200
    assert _status(port, "GET", "/tenants/8?x=1") == 404
    assert seen == [(0, "GET", "/tenants/3/?x=1"),
                    (1, "GET", "/tenants/2/?recursive=true&x=1"),
                    (1, "GET", "/tenants/3/v2/keys/k?wait=false")]
