"""The port's member mode: an embedded cluster of `etcd_tpu_torch.embed.Etcd`
members over real sockets, and `python -m etcd_tpu_torch` member
processes.

1. tests/test_http.py's cases (the v2 keys matrix, watches, members,
   stats, version, health, metrics, CORS, the cluster-version monitor,
   a member's peer URLs updated through the port's members API),
   compiled against the port (tests/port_tests.py), so their fixtures
   build the port's members; TestKeys::test_follower_serves_writes is a
   hand mirror (below).
2. Three `python -m etcd_tpu_torch` member processes from a static
   `--initial-cluster` bootstrap on localhost: a write through one member
   read back from the others (v2 and v3), `/v2/members` and
   `/v2/stats/self`, SIGKILL of a member and its restart on its own data
   dir, and rc 0 on SIGTERM.

Tolerance: exact (values read back equal the values written)."""
import base64
import json
import os
import signal
import subprocess
import sys
import time

from port_tests import on_the_port

_http = on_the_port("test_http")
cluster = _http.cluster
TestWatch, TestMeta = _http.TestWatch, _http.TestMeta
test_cors_enforced = _http.test_cors_enforced
test_cors_wildcard = _http.test_cors_wildcard
test_version_monitor_decides_min_and_upgrades = \
    _http.test_version_monitor_decides_min_and_upgrades
test_member_update_peer_urls = _http.test_member_update_peer_urls

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORM = {"Content-Type": "application/x-www-form-urlencoded"}


class TestKeys(_http.TestKeys):
    def test_follower_serves_writes(self, cluster):
        """Mirror of the JAX test of this name: each member takes a
        write. The reference reads each back at once, without quorum,
        through the next member, which need not have applied it yet (etcd
        v2 serves such a read from that member's own store; see
        tests/test_torch_bootstrap.py::
        test_a_follower_serves_a_plain_read_from_its_own_store). Here the
        member that acked reads it back at once, the next member without
        quorum once it has applied it (polled, 10 s), then with quorum."""
        for i in range(3):
            st, _, body = _http.curl(cluster, "PUT", f"/v2/keys/via{i}",
                                     _http.form({"value": str(i)}), FORM,
                                     member=i)
            assert st in (200, 201)
            st, _, body = _http.curl(cluster, "GET", f"/v2/keys/via{i}",
                                     member=i)
            assert body["node"]["value"] == str(i)
        for i in range(3):
            nxt = (i + 1) % 3
            deadline = time.monotonic() + 10
            while True:
                st, _, body = _http.curl(cluster, "GET", f"/v2/keys/via{i}",
                                         member=nxt)
                if st != 404:
                    break
                assert body["errorCode"] == 100, body
                assert time.monotonic() < deadline, f"via{i} on m{nxt}"
                time.sleep(0.05)
            assert body["node"]["value"] == str(i)
            st, _, body = _http.curl(cluster, "GET",
                                     f"/v2/keys/via{i}?quorum=true",
                                     member=nxt)
            assert body["node"]["value"] == str(i)


def test_the_http_cases_build_the_ports_members():
    assert _http.Etcd.__module__ == "etcd_tpu_torch.embed"


def _spawn(name, data_dir, peers, clients, initial, log):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = ["--name", name, "--data-dir", str(data_dir),
            "--initial-cluster", initial,
            "--initial-advertise-peer-urls", peers[name],
            "--listen-peer-urls", peers[name],
            "--listen-client-urls", clients[name],
            "--advertise-client-urls", clients[name],
            "--initial-cluster-token", "port-members",
            "--initial-cluster-state", "new",
            "--heartbeat-interval", "50", "--election-timeout", "500"]
    return subprocess.Popen([sys.executable, "-m", "etcd_tpu_torch", *args],
                            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                            stderr=open(log, "ab"))


def _self_stats(base):
    st, _, body = _http.req("GET", base + "/v2/stats/self", timeout=5)
    return body if st == 200 else None


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            got = cond()
            if got:
                return got
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _leader(clients):
    """The name of the member whose /v2/stats/self says it leads, once
    every member answers and names that leader."""
    stats = {n: _self_stats(u) for n, u in clients.items()}
    if any(s is None for s in stats.values()):
        return None
    leads = {s["leaderInfo"]["leader"] for s in stats.values()}
    if len(leads) != 1:
        return None
    lead_id = leads.pop()
    return next((n for n, s in stats.items() if s["id"] == lead_id), None)


def _put(base, key, val):
    return _http.req("PUT", f"{base}/v2/keys/{key}",
                     _http.form({"value": val}), FORM, timeout=15)


def _value(base, key, quorum=False):
    q = "?quorum=true" if quorum else ""
    st, _, body = _http.req("GET", f"{base}/v2/keys/{key}{q}", timeout=15)
    return body["node"]["value"] if st == 200 else None


def test_three_member_processes_serve_and_survive_sigkill(tmp_path):
    names = ["m0", "m1", "m2"]
    ports = _http.free_ports(6)
    peers = {n: f"http://127.0.0.1:{ports[i]}" for i, n in enumerate(names)}
    clients = {n: f"http://127.0.0.1:{ports[3 + i]}"
               for i, n in enumerate(names)}
    initial = ",".join(f"{n}={peers[n]}" for n in names)
    log = tmp_path / "members.log"
    procs = {n: _spawn(n, tmp_path / n, peers, clients, initial, log)
             for n in names}
    try:
        lead = _wait(lambda: _leader(clients), "a leader")
        fol = next(n for n in names if n != lead)
        # A write through a follower (forwarded), read back everywhere.
        st, _, body = _put(clients[fol], "k", "v1")
        assert st == 201 and body["node"]["value"] == "v1", (st, body)
        for n in names:
            _wait(lambda: _value(clients[n], "k") == "v1", f"k on {n}")
        assert _value(clients[lead], "k", quorum=True) == "v1"
        st, _, body = _http.req("GET", clients["m0"] + "/v2/members")
        assert st == 200
        assert sorted(m["name"] for m in body["members"]) == names
        assert sorted(u for m in body["members"]
                      for u in m["peerURLs"]) == sorted(peers.values())
        st, _, body = _http.req(
            "POST", clients[fol] + "/v3/kv/put",
            json.dumps({"key": base64.b64encode(b"v3k").decode(),
                        "value": base64.b64encode(b"ok").decode()}
                       ).encode(), {"Content-Type": "application/json"})
        assert st == 200 and body["header"]["revision"] >= 1, (st, body)

        # SIGKILL a member, write while it is down, restart it on its own
        # data dir: it serves every acked write.
        victim = next(n for n in names if n not in (lead, fol))
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait(timeout=30)
        st, _, _ = _put(clients[lead], "k2", "while-down")
        assert st == 201
        procs[victim] = _spawn(victim, tmp_path / victim, peers, clients,
                               initial, log)
        for key, val in (("k", "v1"), ("k2", "while-down")):
            _wait(lambda: _value(clients[victim], key) == val,
                  f"{key} on the restarted {victim}")
        st, _, body = _http.req(
            "POST", clients[victim] + "/v3/kv/range",
            json.dumps({"key": base64.b64encode(b"v3k").decode()}).encode(),
            {"Content-Type": "application/json"})
        assert st == 200 and body["count"] == 1, (st, body)
        stats = _wait(lambda: _self_stats(clients[victim]), "stats")
        assert stats["name"] == victim
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = {}
        for n, p in procs.items():
            try:
                rcs[n] = p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                rcs[n] = p.wait(timeout=30)
    assert rcs == {n: 0 for n in names}, open(log).read()[-3000:]
