"""The port's CLI (etcd_tpu_torch.etcdmain): mirrors of the engine-mode
and member-mode tests of tests/test_etcdmain.py, the member mode in
process through `start_etcd`, the engine on a device mesh
(`--engine-mesh-peers-axis`), the port's own refusal (no card without
`--engine-device cpu`), the proxy mode (`--proxy on` as a process, and
test_etcdmain.py's proxy cases compiled against the port through
tests/port_tests.py), discovery (`--discovery` as a process,
`--discovery-srv` through a fake resolver), `python -m etcd_tpu_torch`
as a process, and data dirs carried between the JAX package's CLI and
the port's. Every engine here runs on the CPU.
Tolerance: exact (values read back equal the values written)."""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from etcd_tpu.etcdmain import parse_args as jax_parse_args
from etcd_tpu.etcdmain.etcd import EngineServer as JaxEngineServer
from etcd_tpu_torch.etcdmain import ConfigError, parse_args
from etcd_tpu_torch.etcdmain.config import MainConfig
from etcd_tpu_torch.etcdmain.etcd import (DIR_EMPTY, DIR_ENGINE, DIR_MEMBER,
                                          DIR_PROXY, EngineServer,
                                          ProxyServer, identify_data_dir,
                                          main, start_etcd)
from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
from port_tests import loads_torch, on_the_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORM = {"Content-Type": "application/x-www-form-urlencoded"}


def _put(base, g, key, val):
    r = urllib.request.Request(
        f"{base}/tenants/{g}/v2/keys/{key}", data=f"value={val}".encode(),
        method="PUT", headers=FORM)
    with urllib.request.urlopen(r, timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def _get(base, g, key):
    with urllib.request.urlopen(f"{base}/tenants/{g}/v2/keys/{key}",
                                timeout=30) as resp:
        return json.loads(resp.read())["node"]["value"]


def _engine_cfg(data_dir, groups=4, peers=3):
    cfg = MainConfig()
    cfg.data_dir = str(data_dir)
    cfg.engine_groups, cfg.engine_peers = groups, peers
    cfg.engine_interval_ms = 1
    cfg.engine_device = "cpu"
    cfg.listen_client_urls = ("http://127.0.0.1:0",)
    return cfg


def test_engine_flags_validation():
    with pytest.raises(ConfigError):
        parse_args(["--engine-groups", "4", "--proxy", "on"])
    with pytest.raises(ConfigError):
        parse_args(["--engine-groups", "4", "--discovery", "http://x"])
    cfg = parse_args(["--engine-groups", "8", "--engine-peers", "3",
                      "--listen-client-urls", "http://127.0.0.1:0",
                      "--engine-device", "cpu"])
    assert cfg.is_engine and cfg.engine_groups == 8 and cfg.engine_peers == 3
    assert cfg.engine_device == "cpu"


@pytest.mark.parametrize("bad", [
    ["--engine-groups", "-1"],
    ["--engine-groups", "4", "--engine-peers", "0"],
    ["--engine-groups", "4", "--engine-window", "2"],
    ["--engine-groups", "4", "--engine-interval-ms", "-1"],
    ["--engine-groups", "4", "--engine-mesh-peers-axis", "-1"],
    ["--engine-groups", "4", "--engine-applier-shards", "0"],
    ["--engine-groups", "4", "--engine-wal-shards", "0"],
], ids=["groups", "peers", "window", "interval", "mesh", "appliers",
        "wal-shards"])
def test_engine_flag_ranges(bad):
    with pytest.raises(ConfigError):
        parse_args(bad)


def test_engine_mode_serves_and_restarts(tmp_path):
    """The CLI engine mode end-to-end in process: tenants served over
    HTTP, data dir identified as engine/, restart keeps data."""
    cfg = _engine_cfg(tmp_path / "eng")
    s = EngineServer(cfg)
    s.start()
    try:
        assert s.engine.device.type == "cpu"
        assert s.engine.wait_leaders(60.0)
        st, b = _put(s.client_urls[0], 2, "cli", "fromflags")
        assert st == 201 and b["node"]["value"] == "fromflags"
    finally:
        s.stop()
    assert identify_data_dir(cfg.data_dir) == DIR_ENGINE

    s2 = EngineServer(cfg)
    s2.start()
    try:
        assert _get(s2.client_urls[0], 2, "cli") == "fromflags"
    finally:
        s2.stop()


def test_engine_mode_refuses_member_dir(tmp_path):
    d = tmp_path / "was-member"
    (d / "member").mkdir(parents=True)
    assert main(["--engine-groups", "2", "--engine-device", "cpu",
                 "--data-dir", str(d)]) == 1
    assert sorted(os.listdir(d)) == ["member"]


def test_engine_geometry_mismatch_refused(tmp_path):
    d = str(tmp_path / "geo")

    def open_(groups, peers):
        MultiEngine(EngineConfig(groups=groups, peers=peers, window=16,
                                 data_dir=d, fsync=False,
                                 device="cpu")).stop()

    open_(4, 3)
    # Peer/window changes and pool SHRINKS refuse; growth is allowed.
    with pytest.raises(ValueError, match="geometry"):
        open_(4, 5)
    with pytest.raises(ValueError, match="geometry"):
        open_(2, 3)
    open_(4, 3)
    open_(8, 3)
    # Through the CLI: a clean exit code, no traceback.
    cli = tmp_path / "cli"
    s = EngineServer(_engine_cfg(cli))
    s.start()
    s.stop()
    assert main(["--engine-groups", "4", "--engine-peers", "5",
                 "--engine-device", "cpu", "--data-dir", str(cli)]) == 1


def test_engine_mesh_flag_is_refused(tmp_path, capsys):
    """--engine-mesh-peers-axis 1 --engine-device cpu serves on a mesh
    (one CPU cell: the state is sharded, and a data dir written on the
    mesh restarts on it); an axis that does not divide the visible
    devices is still refused at flag level, before the data dir."""
    from etcd_tpu_torch.parallel.mesh import Sharded
    cfg = _engine_cfg(tmp_path / "mesh")
    cfg.engine_mesh_peers_axis = 1
    s = EngineServer(cfg)
    s.start()
    try:
        assert isinstance(s.engine.st.term, Sharded)
        assert s.engine.cfg.mesh.shape == (1, 1)
        assert s.engine.wait_leaders(60.0)
        st, b = _put(s.client_urls[0], 1, "m", "onmesh")
        assert st == 201 and b["node"]["value"] == "onmesh"
    finally:
        s.stop()
    s2 = EngineServer(cfg)
    s2.start()
    try:
        assert _get(s2.client_urls[0], 1, "m") == "onmesh"
    finally:
        s2.stop()

    assert main(["--engine-groups", "4", "--engine-mesh-peers-axis", "2",
                 "--engine-device", "cpu",
                 "--data-dir", str(tmp_path / "mesh2")]) == 1
    assert "does not divide the 1 visible devices" in \
        capsys.readouterr().err
    assert not os.path.exists(tmp_path / "mesh2")


def _member(tmp_path, name="m0"):
    """One port member in process, with its peer and client URLs."""
    from etcd_tpu_torch.embed import Etcd, EtcdConfig
    from test_http import free_ports
    pport, cport = free_ports(2)
    m = Etcd(EtcdConfig(
        name=name, data_dir=str(tmp_path / name),
        initial_cluster={name: [f"http://127.0.0.1:{pport}"]},
        listen_client_urls=[f"http://127.0.0.1:{cport}"],
        advertise_client_urls=[f"http://127.0.0.1:{cport}"],
        tick_ms=10, request_timeout=5.0))
    m.start()
    assert m.wait_leader(10)
    return m


def _until_served(url, proc, timeout=60.0):
    from test_http import req
    deadline = time.monotonic() + timeout
    while True:
        assert proc.poll() is None, proc.communicate(timeout=10)
        try:
            st, _, body = req("GET", url, timeout=5)
            if st == 200:
                return body
        except OSError:
            pass
        assert time.monotonic() < deadline, f"{url} never served"
        time.sleep(0.2)


def _sigterm(p):
    p.send_signal(signal.SIGTERM)
    out, err = p.communicate(timeout=60)
    assert p.returncode == 0, err[-2000:]


def test_proxy_flag_serves_a_members_keys(tmp_path):
    """`python -m etcd_tpu_torch --proxy on` (refused before the port had
    the proxy): a process that forwards to the member named by
    --initial-cluster, writes its cluster file, loads no torch and exits
    0 on SIGTERM."""
    from test_http import free_ports, req
    m = _member(tmp_path)
    (port,) = free_ports(1)
    base = f"http://127.0.0.1:{port}"
    d = tmp_path / "pxy"
    p = _spawn(["--proxy", "on", "--listen-client-urls", base,
                "--initial-cluster", f"m0={m.peer_urls[0]}"], d)
    try:
        _until_served(base + "/v2/keys/", p)
        st, _, body = req("PUT", base + "/v2/keys/viaproxy", b"value=p",
                          FORM)
        assert st == 201 and body["node"]["value"] == "p"
        assert req("GET", m.client_urls[0] + "/v2/keys/viaproxy")[2][
            "node"]["value"] == "p"
        assert not loads_torch(p.pid)
        _sigterm(p)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=30)
        m.stop()
    assert identify_data_dir(str(d)) == DIR_PROXY
    with open(d / "proxy" / "cluster") as f:
        assert json.load(f)["PeerURLs"] == list(m.peer_urls)


def test_discovery_flag_joins_a_registry(tmp_path):
    """`python -m etcd_tpu_torch --discovery URL` (refused before the port
    had discovery): the member registers itself in a registry of size 1
    hosted by another member, boots as that one-member cluster, serves,
    loads no torch and exits 0 on SIGTERM."""
    from test_http import free_ports, req
    reg = _member(tmp_path, "reg")
    pport, cport = free_ports(2)
    base = f"http://127.0.0.1:{cport}"
    disc = f"{reg.client_urls[0]}/v2/keys/_etcd/registry/one"
    assert req("PUT", disc + "/_config/size", b"value=1", FORM)[0] == 201
    p = _spawn(["--name", "d0", "--discovery", disc,
                "--listen-peer-urls", f"http://127.0.0.1:{pport}",
                "--initial-advertise-peer-urls", f"http://127.0.0.1:{pport}",
                "--listen-client-urls", base,
                "--advertise-client-urls", base,
                "--heartbeat-interval", "10", "--election-timeout", "100"],
               tmp_path / "d0")
    try:
        body = _until_served(base + "/v2/members", p)
        assert [x["name"] for x in body["members"]] == ["d0"]
        st, _, body = req("GET", disc + "?recursive=true")
        entries = [n["value"] for n in body["node"]["nodes"]
                   if not n["key"].endswith("_config")]
        assert entries == [f"d0=http://127.0.0.1:{pport}"]
        # Writes during the first election answer an error: retry like a
        # real client.
        deadline = time.monotonic() + 30
        while req("PUT", base + "/v2/keys/joined", b"value=1",
                  FORM)[0] != 201:
            assert time.monotonic() < deadline, "no write was acked"
            time.sleep(0.2)
        assert not loads_torch(p.pid)
        _sigterm(p)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=30)
        reg.stop()
    assert identify_data_dir(str(tmp_path / "d0")) == DIR_MEMBER


def test_discovery_srv_reaches_srv_cluster(tmp_path, monkeypatch):
    """--discovery-srv (refused before the port had discovery):
    start_etcd asks `srv_cluster` for the domain's SRV records (a fake
    resolver here: no DNS) and boots the member from the cluster they
    name."""
    import etcd_tpu_torch.discovery as discovery
    from test_http import free_ports, req
    pport, cport = free_ports(2)
    asked = []
    real = discovery.srv_cluster

    def lookup(service, proto, domain):
        asked.append((service, proto, domain))
        return [] if service == "etcd-server-ssl" else [("127.0.0.1",
                                                         pport)]

    monkeypatch.setattr(discovery, "srv_cluster",
                        lambda domain, name, apurls: real(
                            domain, name, apurls, lookup=lookup))
    flags = ["--name", "s0", "--data-dir", str(tmp_path / "s0"),
             "--discovery-srv", "example.com",
             "--listen-peer-urls", f"http://127.0.0.1:{pport}",
             "--initial-advertise-peer-urls", f"http://127.0.0.1:{pport}",
             "--listen-client-urls", f"http://127.0.0.1:{cport}",
             "--advertise-client-urls", f"http://127.0.0.1:{cport}",
             "--heartbeat-interval", "10", "--election-timeout", "100"]
    m = start_etcd(parse_args(flags, env={}))
    try:
        assert asked == [("etcd-server-ssl", "tcp", "example.com"),
                         ("etcd-server", "tcp", "example.com")]
        assert m.cfg.initial_cluster == {
            "s0": [f"http://127.0.0.1:{pport}"]}
        assert m.cfg.cluster_token == "example.com"
        assert m.wait_leader(30)
        st, _, body = req("PUT", m.client_urls[0] + "/v2/keys/srv",
                          b"value=1", FORM)
        assert st == 201
    finally:
        m.stop()


_em = on_the_port("test_etcdmain")
one_member = _em.one_member
test_proxy_forwards_kv = _em.test_proxy_forwards_kv
test_readonly_proxy_rejects_writes = _em.test_readonly_proxy_rejects_writes
test_proxy_no_endpoints_503 = _em.test_proxy_no_endpoints_503
test_proxy_passes_watch_longpoll = _em.test_proxy_passes_watch_longpoll
test_proxy_fails_over_dead_endpoint = _em.test_proxy_fails_over_dead_endpoint


def test_the_proxy_cases_build_the_ports_modules():
    assert _em.ProxyServer is ProxyServer
    assert _em.Director.__module__ == "etcd_tpu_torch.proxy.director"


def test_identify_data_dir(tmp_path):
    """Mirror of tests/test_etcdmain.py's test of this name."""
    assert identify_data_dir(str(tmp_path / "nope")) == DIR_EMPTY
    d = tmp_path / "m"
    (d / "member").mkdir(parents=True)
    assert identify_data_dir(str(d)) == DIR_MEMBER
    p = tmp_path / "p"
    (p / "proxy").mkdir(parents=True)
    assert identify_data_dir(str(p)) == DIR_PROXY
    (p / "member").mkdir()
    with pytest.raises(ConfigError):
        identify_data_dir(str(p))


def test_member_dir_refuses_proxy_mode(tmp_path):
    """Mirror of tests/test_etcdmain.py's test of this name: no proxy/
    dir is planted beside member/."""
    d = tmp_path / "was-member"
    (d / "member").mkdir(parents=True)
    assert main(["--proxy", "on", "--data-dir", str(d)]) == 1
    assert identify_data_dir(str(d)) == DIR_MEMBER


def test_member_mode_refuses_an_engine_dir(tmp_path, capsys):
    d = tmp_path / "was-engine"
    (d / "engine").mkdir(parents=True)
    assert main(["--data-dir", str(d)]) == 1
    assert "previously initialized as engine" in capsys.readouterr().err
    assert sorted(os.listdir(d)) == ["engine"]


def test_start_etcd_serves_a_member_and_restarts(tmp_path):
    """The CLI's member mode in process: flags -> start_etcd -> a member
    serving /v2/keys, /v2/members and /v3/kv; the data dir is a member's,
    and a restart from it serves the write."""
    from test_http import free_ports, req
    pport, cport = free_ports(2)
    d = tmp_path / "m0"
    flags = ["--name", "m0", "--data-dir", str(d),
             "--initial-cluster", f"m0=http://127.0.0.1:{pport}",
             "--listen-peer-urls", f"http://127.0.0.1:{pport}",
             "--listen-client-urls", f"http://127.0.0.1:{cport}",
             "--advertise-client-urls", f"http://127.0.0.1:{cport}",
             "--heartbeat-interval", "10", "--election-timeout", "100"]
    m = start_etcd(parse_args(flags, env={}))
    try:
        assert m.wait_leader(30)
        base = m.client_urls[0]
        st, _, body = req("PUT", base + "/v2/keys/cli", b"value=member",
                          FORM)
        assert st == 201 and body["node"]["value"] == "member"
        st, _, body = req("GET", base + "/v2/members")
        assert [x["name"] for x in body["members"]] == ["m0"]
        st, _, body = req("POST", base + "/v3/kv/put",
                          b'{"key": "YQ==", "value": "Yg=="}')
        assert st == 200
    finally:
        m.stop()
    assert identify_data_dir(str(d)) == DIR_MEMBER
    m = start_etcd(parse_args(flags, env={}))
    try:
        assert m.wait_leader(30)
        assert req("GET", m.client_urls[0] + "/v2/keys/cli")[2]["node"][
            "value"] == "member"
    finally:
        m.stop()


def test_no_card_refuses_and_leaves_the_data_dir_empty(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    d = tmp_path / "d"
    assert main(["--engine-groups", "4", "--data-dir", str(d),
                 "--listen-client-urls", "http://127.0.0.1:0"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists(d / DIR_ENGINE)


def _spawn(args, data_dir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch", *args,
         "--data-dir", str(data_dir)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def test_cli_process_without_a_card_exits_1(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    d = tmp_path / "d"
    p = _spawn(["--engine-groups", "4",
                "--listen-client-urls", "http://127.0.0.1:0"], d)
    out, err = p.communicate(timeout=120)
    assert p.returncode == 1, (out, err)
    assert "no CUDA device" in err and "Traceback" not in err
    assert not os.path.exists(d / DIR_ENGINE)


def _wait_for_http(base, proc, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate(timeout=10)
        try:
            with urllib.request.urlopen(base + "/engine/status",
                                        timeout=5) as r:
                st = json.loads(r.read())
            if st["groups_with_leader"] == st["groups"]:
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError("the CLI never served /engine/status")


def test_cli_process_serves_and_exits_0_on_sigterm(tmp_path):
    from test_http import free_ports
    (port,) = free_ports(1)
    base = f"http://127.0.0.1:{port}"
    p = _spawn(["--engine-groups", "4", "--engine-peers", "3",
                "--engine-window", "16", "--engine-device", "cpu",
                "--listen-client-urls", base], tmp_path / "d")
    try:
        _wait_for_http(base, p)
        st, b = _put(base, 3, "proc", "up")
        assert st == 201 and b["node"]["value"] == "up"
        assert _get(base, 3, "proc") == "up"
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
        assert p.returncode == 0, err[-2000:]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=30)
    assert identify_data_dir(str(tmp_path / "d")) == DIR_ENGINE


def _serve(server_cls, parse, flags):
    s = server_cls(parse(flags))
    s.start()
    assert s.engine.wait_leaders(120.0)
    return s


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_cli_data_dir_restarts_under_the_other_cli(tmp_path, writer,
                                                   reader):
    """A data dir written by one package's CLI engine mode restarts under
    the other's and serves every acked write over HTTP."""
    flags = ["--engine-groups", "4", "--engine-peers", "3",
             "--engine-window", "16", "--data-dir", str(tmp_path / "d"),
             "--listen-client-urls", "http://127.0.0.1:0"]
    clis = {"jax": (JaxEngineServer, jax_parse_args, flags),
            "torch": (EngineServer, parse_args,
                      flags + ["--engine-device", "cpu"])}
    s = _serve(*clis[writer])
    acked = {}
    try:
        for i in range(12):
            g, key, val = i % 4, f"k{i}", f"{writer}-{i}"
            st, _ = _put(s.client_urls[0], g, key, val)
            assert st == 201
            acked[(g, key)] = val
    finally:
        s.stop()
    s = _serve(*clis[reader])
    try:
        for (g, key), val in acked.items():
            assert _get(s.client_urls[0], g, key) == val
        st, _ = _put(s.client_urls[0], 0, "after", reader)
        assert st == 201
    finally:
        s.stop()
