"""The port's client tools: the SDK (etcd_tpu_torch/client) and etcdctl
(etcd_tpu_torch/etcdctl) against the port's members and against the
port's engine.

1. tests/test_client_sdk.py's and tests/test_etcdctl.py's cases,
   compiled against the port (tests/port_tests.py), so their fixtures
   build the port's members and drive them with the port's SDK and
   etcdctl.
2. A mirror of test_client_sdk.py::test_sdk_and_etcdctl_against_tenant_
   endpoint: the SDK (its long-poll watcher too) and `python -m
   etcd_tpu_torch.etcdctl.main` against a `device="cpu"` engine's
   /tenants/{g} base URL. The source builds its engine without a device
   (the port's default is the card) and spawns the JAX package's etcdctl.
3. The JAX package's SDK against a JAX member and the port's SDK against
   a port member, one request stream each: the responses are equal.

Tolerance: exact (values read back equal the values written)."""
import os
import subprocess
import sys
import threading
import time

import pytest

from port_tests import on_the_port

_sdk = on_the_port("test_client_sdk")
_ctl = on_the_port("test_etcdctl")
cluster, kapi = _sdk.cluster, _sdk.kapi
member, ctl = _ctl.member, _ctl.ctl
globals().update({name: obj for mod in (_sdk, _ctl)
                  for name, obj in vars(mod).items()
                  if name.startswith("test_")
                  and name != "test_sdk_and_etcdctl_against_tenant_endpoint"})

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_client_cases_build_the_ports_modules():
    assert _sdk.KeysAPI.__module__ == "etcd_tpu_torch.client.keys"
    assert _sdk.Etcd.__module__ == "etcd_tpu_torch.embed"
    assert _ctl.main.__module__ == "etcd_tpu_torch.etcdctl.main"


def _ctl_env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_sdk_and_etcdctl_against_tenant_endpoint(tmp_path):
    """Mirror of tests/test_client_sdk.py's test of this name on a
    `device="cpu"` engine: the SDK and etcdctl work unmodified against a
    tenant keyspace, and the etcdctl process loads neither torch nor
    jax."""
    from etcd_tpu_torch.client import Client, KeysAPI, KeysError
    from etcd_tpu_torch.etcdhttp.tenants import EngineHttp
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from test_http import free_ports

    (cp,) = free_ports(1)
    eng = MultiEngine(EngineConfig(
        groups=2, peers=3, data_dir=str(tmp_path), window=16, max_ents=4,
        heartbeat_tick=3, fsync=False, request_timeout=15.0,
        round_interval=0.0005, device="cpu"))
    http = EngineHttp(eng, port=cp)
    eng.start()
    http.start()
    try:
        deadline = time.time() + 120
        while time.time() < deadline and not all(
                eng.leader_slot(g) >= 0 for g in range(2)):
            time.sleep(0.05)
        kapi = KeysAPI(Client([f"{http.url}/tenants/1"]))
        r = kapi.set("/sdkkey", "hello")
        assert r.action == "set"
        g = kapi.get("/sdkkey")
        assert g.node.value == "hello"
        w = kapi.watcher("/sdkkey", after_index=g.node.modified_index)
        res = {}
        t = threading.Thread(target=lambda: res.update(ev=w.next(10)),
                             daemon=True)
        t.start()
        time.sleep(0.3)
        kapi.set("/sdkkey", "v2")
        t.join(12)
        assert res.get("ev") is not None and res["ev"].node.value == "v2"
        k0 = KeysAPI(Client([f"{http.url}/tenants/0"]))
        with pytest.raises(KeysError) as ei:
            k0.get("/sdkkey")
        assert ei.value.code == 100

        peers = f"{http.url}/tenants/0"

        def ctl(*args):
            return subprocess.run(
                [sys.executable, "-c",
                 "import runpy, sys\n"
                 "sys.argv[0] = 'etcdctl'\n"
                 "try:\n"
                 "    runpy.run_module('etcd_tpu_torch.etcdctl.main',\n"
                 "                     run_name='__main__')\n"
                 "finally:\n"
                 "    print('LOADED', 'torch' in sys.modules,\n"
                 "          'jax' in sys.modules, file=sys.stderr)\n",
                 "--peers", peers, *args],
                cwd=ROOT, env=_ctl_env(), capture_output=True, text=True,
                timeout=60)

        out = ctl("set", "ck", "cv")
        assert out.returncode == 0, out.stderr
        assert "LOADED False False" in out.stderr
        out = ctl("get", "ck")
        assert out.returncode == 0 and out.stdout.strip() == "cv"
        out = ctl("ls", "/")
        assert out.returncode == 0 and "/ck" in out.stdout
    finally:
        http.stop()
        eng.stop()


def test_etcdctl_module_runs_as_a_process(tmp_path):
    """`python -m etcd_tpu_torch.etcdctl.main` against a port member:
    set, get, mk twice (the second fails), update, ls, rm, mkdir,
    rmdir."""
    from etcd_tpu_torch.embed import Etcd, EtcdConfig
    from test_http import free_ports

    pport, cport = free_ports(2)
    m = Etcd(EtcdConfig(
        name="c0", data_dir=str(tmp_path / "c0"),
        initial_cluster={"c0": [f"http://127.0.0.1:{pport}"]},
        listen_client_urls=[f"http://127.0.0.1:{cport}"], tick_ms=10))
    m.start()
    try:
        assert m.wait_leader(10)

        def ctl(*args):
            p = subprocess.run(
                [sys.executable, "-m", "etcd_tpu_torch.etcdctl.main",
                 "--peers", m.client_urls[0], *args], cwd=ROOT,
                env=_ctl_env(), capture_output=True, text=True, timeout=60)
            return p.returncode, p.stdout

        assert ctl("set", "/p/a", "1") == (0, "1\n")
        assert ctl("get", "/p/a") == (0, "1\n")
        assert ctl("mk", "/p/b", "2") == (0, "2\n")
        assert ctl("mk", "/p/b", "3")[0] != 0
        assert ctl("update", "/p/b", "4") == (0, "4\n")
        rc, out = ctl("ls", "/p")
        assert rc == 0 and sorted(out.split()) == ["/p/a", "/p/b"]
        assert ctl("rm", "/p/a")[0] == 0
        assert ctl("get", "/p/a")[0] != 0
        assert ctl("mkdir", "/p/d")[0] == 0
        assert ctl("rmdir", "/p/d")[0] == 0
        assert ctl("ls", "/p")[1].split() == ["/p/b"]
    finally:
        m.stop()


def _sdk_stream(pkg, tmp_path):
    """One request stream through `pkg`'s SDK against one `pkg` member;
    each response as a comparable tuple. The expiration of the TTL dir is
    a wall-clock time, so only its presence is compared (its ttl is
    compared exactly)."""
    import importlib

    from test_http import free_ports
    embed = importlib.import_module(f"{pkg}.embed")
    client = importlib.import_module(f"{pkg}.client")

    def node(n):
        return None if n is None else (
            n.key, n.value, n.dir, n.created_index, n.modified_index,
            n.expiration is not None, n.ttl,
            tuple(node(c) for c in n.nodes))

    def resp(r):
        return (r.action, node(r.node), node(r.prev_node), r.index,
                r.raft_index, r.raft_term)

    pport, cport = free_ports(2)
    m = embed.Etcd(embed.EtcdConfig(
        name="s0", data_dir=str(tmp_path / pkg),
        initial_cluster={"s0": [f"http://127.0.0.1:{pport}"]},
        listen_client_urls=[f"http://127.0.0.1:{cport}"],
        advertise_client_urls=[f"http://127.0.0.1:{cport}"],
        cluster_token="sdk-stream", tick_ms=10))
    m.start()
    try:
        assert m.wait_leader(10)
        c = client.Client(list(m.client_urls))
        # Boot's own entries (the member's published attributes, the
        # cluster version) are in before the stream starts.
        deadline = time.time() + 30
        while True:
            body = c.do("GET", "/version").json()
            ms = client.MembersAPI(c).list()
            if body["etcdcluster"] != "not_decided" and ms[0].client_urls:
                break
            assert time.time() < deadline, body
            time.sleep(0.05)
        k = client.KeysAPI(c)
        out = [resp(k.set("/s/a", "1")),
               resp(k.set("/s/a", "2", prev_value="1"))]
        out += [resp(k.set("/s/a", "3", prev_index=out[-1][1][4])),
               resp(k.create_in_order("/s/q", "one")),
               resp(k.create_in_order("/s/q", "two")),
               resp(k.get("/s/q", recursive=True, sorted=True)),
               resp(k.delete("/s/a")),
               resp(k.get("/s", recursive=True, sorted=True,
                          quorum=True))]
        with pytest.raises(client.KeysError) as ei:
            k.set("/s/q", "x", prev_value="nope")
        out.append((ei.value.code, ei.value.status, ei.value.cause))
        out.append(resp(k.set("/s/ttldir", dir=True, ttl=100)))
        return out
    finally:
        m.stop()


def test_sdk_stream_equals_the_jax_packages(tmp_path):
    """The JAX package's SDK against a one-member JAX cluster and the
    port's SDK against a one-member port cluster, the same stream (set,
    CAS by value and by index, in-order creates, a sorted recursive get,
    delete, a quorum get, a failed CAS, a dir with a TTL): every
    response equal, action, nodes, previous nodes, X-Etcd-Index,
    X-Raft-Index and X-Raft-Term included."""
    jax_out = _sdk_stream("etcd_tpu", tmp_path)
    port_out = _sdk_stream("etcd_tpu_torch", tmp_path)
    assert port_out == jax_out
    assert jax_out[1][0] == "compareAndSwap"
    assert jax_out[-1][1][5:7] == (True, 100)
