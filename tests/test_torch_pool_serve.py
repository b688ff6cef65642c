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
