"""The port's members grown, rebuilt and secured through the port's SDK:
tests/test_bootstrap.py (member add and join, membership validation,
--force-new-cluster, a full member rotation) and tests/test_tls.py
(HTTPS client listeners, mutual-TLS peer links, the SDK with CA pinning,
client-certificate auth), compiled against the port
(tests/port_tests.py), so their members are `etcd_tpu_torch.embed.Etcd`
and their clients `etcd_tpu_torch.client`; test_https_cluster_end_to_end
is a hand mirror (below). Tolerance: exact, as there."""
import base64
import json
import ssl
import threading
import time
import urllib.error
import urllib.request

import pytest

from port_tests import on_the_port

_boot = on_the_port("test_bootstrap")
_tls = on_the_port("test_tls")
pki = _tls.pki
globals().update({name: obj for mod in (_boot, _tls)
                  for name, obj in vars(mod).items()
                  if name.startswith("test_")
                  and name != "test_https_cluster_end_to_end"})


def test_the_bootstrap_cases_build_the_ports_modules():
    assert _boot.Etcd.__module__ == "etcd_tpu_torch.embed"
    assert _boot.MembersAPI.__module__ == "etcd_tpu_torch.client.members"
    assert _tls.Client.__module__ == "etcd_tpu_torch.client.client"
    assert _tls.TLSInfo.__module__ == "etcd_tpu_torch.utils.tlsutil"


def test_https_cluster_end_to_end(tmp_path, pki):
    """Mirror of tests/test_tls.py's test of this name (that file stays
    as it is): three members over mutual-TLS peer links, the SDK over
    HTTPS with CA pinning, a write through another member, and an
    untrusted CA refused. The reference reads that write back through
    `keys`, which is pinned to urls[0], without `quorum` (its line 111).
    etcd v2 serves such a read from the local store of the member that
    receives it, and urls[-1] acked the write after its own apply; a
    follower at urls[0] learns the commit only from the leader's next
    message, so under load it can still answer "Key not found" (shown by
    test_a_follower_serves_a_plain_read_from_its_own_store). Here that
    read is three: (a) through urls[-1] without quorum, at once; (c)
    through `keys` without quorum, polled within the client's 10 s
    timeout until that member has applied the write; (b) through `keys`
    with quorum=True, etcd v2's linearizable read."""
    from etcd_tpu_torch.client import KeysError

    members = _tls._tls_cluster(tmp_path, pki)
    try:
        assert any(m.wait_leader(20) for m in members)
        urls = [u for m in members for u in m.client_urls]
        assert all(u.startswith("https://") for u in urls)

        c = _tls.Client(urls, timeout=10.0,
                        tls=_tls.TLSInfo(ca_file=str(pki / "ca.crt")))
        keys = _tls.KeysAPI(c)
        keys.set("/secure", "value")
        assert keys.get("/secure").node.value == "value"
        # Write via a DIFFERENT member's endpoint (peer forwarding rides
        # the mutual-TLS transport).
        c2 = _tls.Client([urls[-1]], timeout=10.0,
                         tls=_tls.TLSInfo(ca_file=str(pki / "ca.crt")))
        acker = _tls.KeysAPI(c2)
        acker.set("/via-follower", "x")
        # (a) The member that acked has applied the write.
        assert acker.get("/via-follower").node.value == "x"
        # (c) urls[0]'s own store has it once that member has applied it.
        deadline = time.monotonic() + 10.0
        while True:
            try:
                got = keys.get("/via-follower")
                break
            except KeysError as e:
                assert e.code == 100, e
                assert time.monotonic() < deadline, "never applied"
                time.sleep(0.05)
        assert got.node.value == "x"
        # (b) A linearizable read through urls[0].
        assert keys.get("/via-follower", quorum=True).node.value == "x"

        # Wrong CA: TLS verification must fail.
        bad = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        bad.load_verify_locations(str(pki / "evil-ca.crt"))
        bad.check_hostname = False
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(urls[0] + "/version", context=bad,
                                   timeout=5)
    finally:
        for m in members:
            m.stop()


@pytest.mark.parametrize("api", ["v2", "v3"])
def test_a_follower_serves_a_plain_read_from_its_own_store(api, tmp_path):
    """Why a read without quorum through a member other than the one
    that acked a write may miss it. Three plain-HTTP port members; one
    follower's apply of the write is held (its `_apply_request` wrapped
    on the instance), and the write goes through the other follower,
    which acks after its own apply. The held follower has the entry
    committed, yet a v2 GET through it without quorum answers 404, code
    100 (a v3 serializable range: no kvs), every time. Once the hold is
    released, a quorum GET (a linearizable range) through it returns the
    value."""
    from etcd_tpu_torch.embed import Etcd, EtcdConfig
    from etcd_tpu_torch.server.request import METHOD_PUT, METHOD_V3
    from etcd_tpu_torch.tools.multihost_supervisor import listen_ports
    from test_http import req

    # Below the ephemeral range, where no outbound connection of the
    # members (or of a test beside this one) can take a port first.
    ports = listen_ports(6)
    peers = {f"h{i}": [f"http://127.0.0.1:{ports[i]}"] for i in range(3)}
    members = [Etcd(EtcdConfig(
        name=f"h{i}", data_dir=str(tmp_path / f"h{i}"), initial_cluster=peers,
        listen_client_urls=[f"http://127.0.0.1:{ports[3 + i]}"],
        tick_ms=10, request_timeout=10.0)) for i in range(3)]
    for m in members:
        m.start()
    release, entered = threading.Event(), threading.Event()
    try:
        assert all(m.wait_leader(20) for m in members)
        deadline = time.monotonic() + 30
        while not any(m.server.is_leader() for m in members):
            assert time.monotonic() < deadline, "no leader"
            time.sleep(0.01)
        held, writer = [m for m in members if not m.server.is_leader()]
        apply = held.server._apply_request
        key = base64.b64encode(b"held").decode()

        def hold(r, index=0):
            if ((r.method == METHOD_PUT and r.path.endswith("/held")) or
                    (r.method == METHOD_V3 and (r.v3 or {}).get("type")
                     == "put" and r.v3.get("key") == key)):
                entered.set()
                release.wait(60)
            return apply(r, index)

        held.server._apply_request = hold
        hurl, wurl = held.client_urls[0], writer.client_urls[0]
        form = {"Content-Type": "application/x-www-form-urlencoded"}
        js = {"Content-Type": "application/json"}
        if api == "v2":
            st, _, body = req("PUT", wurl + "/v2/keys/held", b"value=x",
                              form)
            assert st == 201 and body["node"]["value"] == "x", (st, body)
            assert entered.wait(30)
            assert held.server.applied_index < held.server.commit_index
            st, _, body = req("GET", hurl + "/v2/keys/held")
            assert (st, body["errorCode"]) == (404, 100), (st, body)
            release.set()
            st, _, body = req("GET", hurl + "/v2/keys/held?quorum=true",
                              timeout=30)
            assert st == 200 and body["node"]["value"] == "x", (st, body)
        else:
            x = base64.b64encode(b"x").decode()
            st, _, body = req("POST", wurl + "/v3/kv/put", json.dumps(
                {"key": key, "value": x}).encode(), js)
            assert st == 200, (st, body)
            assert entered.wait(30)
            assert held.server.applied_index < held.server.commit_index
            st, _, body = req("POST", hurl + "/v3/kv/range", json.dumps(
                {"key": key, "serializable": True}).encode(), js)
            assert st == 200 and body["count"] == 0, (st, body)
            release.set()
            st, _, body = req("POST", hurl + "/v3/kv/range", json.dumps(
                {"key": key}).encode(), js, timeout=30)
            assert st == 200 and body["count"] == 1, (st, body)
            assert base64.b64decode(body["kvs"][0]["value"]) == b"x"
    finally:
        release.set()
        for m in members:
            m.stop()
