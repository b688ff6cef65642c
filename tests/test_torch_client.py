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
   a port member, one request stream each, with SYNC off and one frozen
   clock: the responses are equal. Two tests show, on both packages,
   what SYNC and a late apply do to X-Raft-Index and a TTL's ttl.

Tolerance: exact (values read back equal the values written)."""
import contextlib
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


# The member's clock in the differential: frozen, the same on both sides.
FROZEN = 1_700_000_000.0


def _member(pkg, data_dir):
    """One `pkg` member on localhost (10 ms ticks), not started, and the
    package's client module."""
    import importlib

    from etcd_tpu_torch.tools.multihost_supervisor import listen_ports
    embed = importlib.import_module(f"{pkg}.embed")
    # Below the ephemeral range, where no outbound connection can take a
    # port between its choice and the member's bind.
    pport, cport = listen_ports(2)
    return embed.Etcd(embed.EtcdConfig(
        name="s0", data_dir=str(data_dir),
        initial_cluster={"s0": [f"http://127.0.0.1:{pport}"]},
        listen_client_urls=[f"http://127.0.0.1:{cport}"],
        advertise_client_urls=[f"http://127.0.0.1:{cport}"],
        cluster_token="sdk-stream", tick_ms=10)), \
        importlib.import_module(f"{pkg}.client")


@contextlib.contextmanager
def _one_member(pkg, data_dir, client_timeout=5.0):
    """`_member`, started and booted: its published attributes and the
    cluster version are applied before it is yielded, as (member, the
    package's client module, a Client on it). /version cannot tell that
    the cluster version is in
    (test_version_answers_before_the_cluster_version_commits), so the
    wait reads the member's store."""
    m, client = _member(pkg, data_dir)
    m.start()
    try:
        assert m.wait_leader(10)
        c = client.Client(list(m.client_urls), timeout=client_timeout)
        deadline = time.time() + 30
        while True:
            ms = client.MembersAPI(c).list()
            if m.server.cluster.version() is not None and ms[0].client_urls:
                break
            assert time.time() < deadline, ms
            time.sleep(0.05)
        yield m, client, c
    finally:
        m.stop()


def _pin(m, clock):
    """No SYNC from `m` (sync_ticks out of reach), and `clock` as its
    clock: the handler's (a TTL's expiration) and the store's (the ttl
    left at the apply)."""
    m.server.cfg.sync_ticks = 1 << 30
    m.server.clock = m.server.store.clock = clock


def _sdk_stream(pkg, tmp_path):
    """One request stream through `pkg`'s SDK against one `pkg` member;
    each response as a comparable tuple. The member proposes no SYNC and
    its clock is frozen at FROZEN (`_pin`), so every field is compared
    exactly, the TTL dir's expiration and ttl too: with SYNC on, a SYNC
    committed between an apply and its response's header raises
    X-Raft-Index alone
    (test_a_sync_before_the_header_moves_x_raft_index_alone), and an
    apply a second or more after the handler read the clock answers a
    ttl of 99 (test_an_apply_a_second_late_answers_ttl_99)."""
    def node(n):
        return None if n is None else (
            n.key, n.value, n.dir, n.created_index, n.modified_index,
            n.expiration, n.ttl, tuple(node(c) for c in n.nodes))

    def resp(r):
        return (r.action, node(r.node), node(r.prev_node), r.index,
                r.raft_index, r.raft_term)

    with _one_member(pkg, tmp_path / pkg) as (m, client, c):
        _pin(m, lambda: FROZEN)
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
    assert jax_out[-1][1][5] is not None
    assert jax_out[-1][1][6] == 100


HOLD_S = 3.0


@pytest.mark.parametrize("sync", ["on", "off"])
@pytest.mark.parametrize("pkg", ["etcd_tpu", "etcd_tpu_torch"])
def test_a_sync_before_the_header_moves_x_raft_index_alone(pkg, sync,
                                                           tmp_path):
    """Why the differential pins SYNC off. X-Raft-Index is the member's
    commit index when the header is written, in both packages as in
    etcd. Once a key has a TTL the leader proposes a SYNC every
    `sync_ticks` ticks (5 by default); here the header of a TTL set is
    held, up to HOLD_S, until the commit index has passed the set's
    entry. With SYNC on, a SYNC commits meanwhile: X-Raft-Index exceeds
    the entry's index and X-Etcd-Index is still the set's. With SYNC
    off nothing commits: X-Raft-Index is the entry's index."""
    import importlib
    request = importlib.import_module(f"{pkg}.server.request")

    with _one_member(pkg, tmp_path, client_timeout=30.0) as (m, client, c):
        s = m.server
        assert s.cfg.sync_ticks == 5
        if sync == "off":
            s.cfg.sync_ticks = 1 << 30
        # No key has a TTL yet, so nothing else is proposed: the set's
        # entry comes next.
        entry = s.commit_index + 1
        headers = m.client_api._headers

        def held(etcd_index=None):
            if etcd_index is not None:
                deadline = time.monotonic() + HOLD_S
                while (s.commit_index <= entry
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
            return headers(etcd_index)

        m.client_api._headers = held
        r = client.KeysAPI(c).set("/ttl", "v", ttl=100)
        (e,) = s.raft_storage.entries(entry, entry + 1)
        assert request.Request.decode(e.data).path.endswith("/ttl")
        assert r.index == r.node.modified_index == s.store.current_index
        if sync == "on":
            assert r.raft_index > entry
        else:
            assert r.raft_index == entry == s.commit_index


@pytest.mark.parametrize("pkg", ["etcd_tpu", "etcd_tpu_torch"])
def test_an_apply_a_second_late_answers_ttl_99(pkg, tmp_path):
    """Why the differential pins the clock. A TTL's expiration is taken
    in the HTTP handler (the handler's clock plus the ttl) and the ttl a
    response carries at the apply (the expiration less the store's
    clock, rounded up): a set with ttl=100 answers 100 when it applies
    less than a second after its handler, and 99 when the member's clock
    has moved 1.5 s in between, in both packages."""
    with _one_member(pkg, tmp_path) as (m, client, c):
        now = [FROZEN]
        _pin(m, lambda: now[0])
        do = m.server.do

        def late(r):
            if r.expiration is not None and r.path.endswith("/late"):
                now[0] += 1.5
            return do(r)

        m.server.do = late
        k = client.KeysAPI(c)
        assert k.set("/on-time", "v", ttl=100).node.ttl == 100
        assert k.set("/late", "v", ttl=100).node.ttl == 99
        assert now[0] == FROZEN + 1.5


@pytest.mark.parametrize("pkg", ["etcd_tpu", "etcd_tpu_torch"])
def test_version_answers_before_the_cluster_version_commits(pkg, tmp_path):
    """Why `_one_member` waits on the store. The leader proposes the
    cluster version from its version monitor's thread once it leads, so
    the entry can commit after the member's attributes. Until it is
    applied, /version answers the minimum cluster version, never
    "not_decided": here the monitor is held, /version answers 2.0.0
    while the store has no cluster version, then the version the entry
    stored."""
    import importlib
    minimum = importlib.import_module(f"{pkg}.version").MIN_CLUSTER_VERSION
    m, client = _member(pkg, tmp_path)
    decide, gate = m.server._decide_cluster_version, threading.Event()

    def held():
        gate.wait(30)
        return decide()

    m.server._decide_cluster_version = held
    m.start()
    try:
        assert m.wait_leader(10)
        c = client.Client(list(m.client_urls))
        deadline = time.time() + 30
        while not client.MembersAPI(c).list()[0].client_urls:
            assert time.time() < deadline
            time.sleep(0.05)
        assert c.do("GET", "/version").json()["etcdcluster"] == minimum
        assert m.server.cluster.version() is None
        gate.set()
        while m.server.cluster.version() is None:
            assert time.time() < deadline
            time.sleep(0.05)
        assert c.do("GET", "/version").json()["etcdcluster"] == \
            m.server.cluster.version() != minimum
    finally:
        gate.set()
        m.stop()
