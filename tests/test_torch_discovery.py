"""The port's discovery bootstrap (etcd_tpu_torch/discovery) and its
fallback to the proxy mode.

1. tests/test_discovery.py's cases, compiled against the port
   (tests/port_tests.py): a port member doubles as the discovery
   service; join, full cluster, duplicate id, missing size key, DNS SRV
   with a fake resolver.
2. A mirror of test_discovery.py::test_discovery_hosted_on_a_tenant_
   keyspace on a `device="cpu"` engine (the source builds its engine
   without a device, the port's default being the card, and spawns the
   JAX package's members): three `python -m etcd_tpu_torch --discovery`
   member processes bootstrap from a registry in a tenant's keyspace,
   and a fourth process on the same token finds the cluster full and
   falls back to proxy mode (`--discovery-fallback proxy`, the default).
   Writes through the proxy read back from every member, a long-poll
   watch through the proxy fires, and none of the four processes loads
   torch.

Tolerance: exact (values read back equal the values written)."""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

from port_tests import loads_torch, on_the_port

_disc = on_the_port("test_discovery")
disco = _disc.disco
globals().update({name: obj for name, obj in vars(_disc).items()
                  if name.startswith("test_")
                  and name != "test_discovery_hosted_on_a_tenant_keyspace"})

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_discovery_cases_build_the_ports_modules():
    assert _disc.join_cluster.__module__ == \
        "etcd_tpu_torch.discovery.discovery"
    assert _disc.Etcd.__module__ == "etcd_tpu_torch.embed"


def _req(method, url, body=None, timeout=20):
    r = urllib.request.Request(
        url, body, {"Content-Type": "application/x-www-form-urlencoded"},
        method=method)
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _until(cond, what, deadline_s=150.0):
    t_end = time.time() + deadline_s
    while True:
        try:
            got = cond()
        except OSError:
            got = None
        if got:
            return got
        assert time.time() < t_end, f"timed out on {what}"
        time.sleep(0.25)


def test_discovery_hosted_on_a_tenant_keyspace(tmp_path):
    """Mirror of tests/test_discovery.py's test of this name (marked slow
    there; it passes on this box), plus the fourth process that falls
    back to proxy mode."""
    from etcd_tpu_torch.etcdhttp.tenants import EngineHttp
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from test_http import free_ports

    (ep,) = free_ports(1)
    eng = MultiEngine(EngineConfig(
        groups=2, peers=3, data_dir=str(tmp_path / "eng"), window=16,
        max_ents=4, heartbeat_tick=3, fsync=False, request_timeout=15.0,
        round_interval=0.0005, device="cpu"))
    http = EngineHttp(eng, port=ep)
    eng.start()
    http.start()
    procs = []
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    logf = open(tmp_path / "procs.log", "ab")

    def spawn(i, pp, cp):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "etcd_tpu_torch", "--name", f"m{i}",
             "--data-dir", str(tmp_path / f"m{i}"),
             "--listen-peer-urls", f"http://127.0.0.1:{pp}",
             "--initial-advertise-peer-urls", f"http://127.0.0.1:{pp}",
             "--listen-client-urls", f"http://127.0.0.1:{cp}",
             "--advertise-client-urls", f"http://127.0.0.1:{cp}",
             "--discovery", disc,
             "--heartbeat-interval", "20", "--election-timeout", "200"],
            cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT))

    try:
        _until(lambda: all(eng.leader_slot(g) >= 0 for g in range(2)),
               "tenant leaders", 120)
        disc = f"{http.url}/tenants/1/v2/keys/_etcd/registry/tok1"
        assert _req("PUT", f"{disc}/_config/size", b"value=3")[0] in (200,
                                                                     201)
        ports = [free_ports(2) for _ in range(4)]
        for i, (pp, cp) in enumerate(ports[:3]):
            spawn(i, pp, cp)
        clients = [f"http://127.0.0.1:{cp}" for _, cp in ports]

        def members():
            st, body = _req("GET", clients[0] + "/v2/members", timeout=3)
            ms = body["members"] if st == 200 else []
            return len(ms) == 3 and all(m["clientURLs"] for m in ms)

        _until(members, "three members with client URLs")
        # The registry in the tenant recorded all three members.
        st, reg = _req("GET", f"{disc}?recursive=true")
        slots = [nd for nd in reg["node"].get("nodes", [])
                 if not nd["key"].endswith("_config")]
        assert st == 200 and len(slots) == 3, reg

        # A fourth process on the same token: the cluster is full.
        spawn(3, *ports[3])
        proxy = clients[3]
        _until(lambda: _req("GET", proxy + "/v2/keys/", timeout=3)[0]
               == 200, "the fallback proxy to serve")
        assert os.path.isdir(tmp_path / "m3" / "proxy")
        assert not os.path.exists(tmp_path / "m3" / "member")

        got = {}

        def watch():
            got["resp"] = _req("GET", proxy + "/v2/keys/pw?wait=true",
                               timeout=30)

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        time.sleep(0.5)
        for i in range(20):
            # 301 during an election window: retry like a real client.
            _until(lambda: _req("PUT", f"{proxy}/v2/keys/p{i}",
                                f"value=v{i}".encode())[0] in (200, 201),
                   f"PUT p{i} through the proxy", 30)
        assert _req("PUT", proxy + "/v2/keys/pw", b"value=fired")[0] \
            in (200, 201)
        t.join(15)
        assert not t.is_alive(), "the watch through the proxy never fired"
        assert got["resp"][0] == 200
        assert got["resp"][1]["node"]["value"] == "fired"
        for base in clients[:3]:
            for i in range(20):
                # A member may still be applying: a 404 until it has.
                _until(lambda: (_req("GET", f"{base}/v2/keys/p{i}")[1]
                                .get("node", {}).get("value")) == f"v{i}",
                       f"p{i} at {base}", 30)
        assert [loads_torch(p.pid) for p in procs] == [False] * 4
        for p in procs:
            p.send_signal(signal.SIGTERM)
        assert [p.wait(timeout=30) for p in procs] == [0] * 4
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        logf.close()
        http.stop()
        eng.stop()
