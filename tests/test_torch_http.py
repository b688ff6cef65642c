"""The port's tenant HTTP front (etcd_tpu_torch.etcdhttp.tenants over the
port's MultiEngine, device="cpu") against the JAX package's.

1. The differential: one scripted sequence of HTTP requests goes to a JAX
   `EngineHttp` and to the port's, each over its own `MultiEngine`
   (G=4, P=3, W=16, E=4, fsync off). Status codes, errorCodes, JSON
   bodies and X-Etcd-Index must be equal request by request.
2. The conformance tables of tests/test_v2_http_matrix.py and the tests
   of tests/test_tenant_security.py that take everything from their
   fixture, imported as they are and run against the port's front.

Tolerance: exact everywhere, apart from these masks, which the
differential applies to both sides alike:
- the `expiration` and `ttl` fields of a node: they are computed from
  the wall clock at the moment of the request, which two live engines
  never share;
- the X-Raft-Index and X-Raft-Term headers: they are read from the round
  loop's mirrors at the moment the answer is formed, and the two round
  loops run on their own wall-clock timers.
"""
import base64
import json
import socket
import time
import urllib.error
import urllib.parse
import urllib.request
from types import SimpleNamespace

import pytest

from etcd_tpu.etcdhttp.tenants import EngineHttp as JaxEngineHttp
from etcd_tpu.server import engine as jax_engine
from etcd_tpu_torch import native
from etcd_tpu_torch.etcdhttp.tenants import EngineHttp
from etcd_tpu_torch.server import batchframe
from etcd_tpu_torch.server import engine as torch_engine
from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine

from test_v2_http_matrix import (  # noqa: F401 — collected here
    test_cad_table, test_cas_table, test_create_update_table,
    test_delete_table, test_get_tree_shapes, test_head,
    test_unique_in_order_table, test_watch_key_in_expiring_dir,
    test_watch_with_index)
from test_tenant_security import (  # noqa: F401 — collected here
    FH, _auth, _req, test_tenant_auth_matrix,
    test_tenant_delete_requires_credentials,
    test_tenant_recreate_gets_fresh_security_state, test_tenant_stats)

G, P = 4, 3
MASKED_FIELDS = ("expiration", "ttl")


def _start(mod, front_cls, data_dir, **kw):
    extra = {"device": "cpu"} if mod is torch_engine else {}
    eng = mod.MultiEngine(mod.EngineConfig(
        groups=G, peers=P, data_dir=str(data_dir), window=16, max_ents=4,
        heartbeat_tick=3, fsync=False, request_timeout=30.0,
        round_interval=0.0005, **kw, **extra))
    front = front_cls(eng)
    front.start()
    eng.start()
    if not eng.wait_leaders(120.0):
        front.stop()
        eng.stop()
        raise AssertionError("engine elections failed")
    return eng, front


# -- the conformance tables, against the port ---------------------------------

@pytest.fixture(scope="module")
def member(tmp_path_factory):
    """The fixture of tests/test_v2_http_matrix.py's "tenant" leg, with
    the port's engine and front: tenant 2 of a G=4 engine."""
    eng, front = _start(torch_engine, EngineHttp,
                        tmp_path_factory.mktemp("v2matrix") / "eng")
    yield SimpleNamespace(client_urls=[front.url + "/tenants/2"])
    front.stop()
    eng.stop()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """tests/test_tenant_security.py's fixture on the port's engine."""
    tmp = tmp_path_factory.mktemp("tenant-sec")
    eng = MultiEngine(EngineConfig(
        groups=3, peers=3, data_dir=str(tmp / "e"), fsync=False,
        request_timeout=30.0, device="cpu"))
    eng.start()
    http = EngineHttp(eng)
    http.start()
    assert eng.wait_leaders(60)
    yield eng, http.url, str(tmp / "e")
    http.stop()
    eng.stop()


@pytest.fixture()
def lifecycle_cluster(tmp_path):
    eng = MultiEngine(EngineConfig(
        groups=3, peers=3, data_dir=str(tmp_path / "e"), fsync=False,
        request_timeout=30.0, device="cpu"))
    eng.start()
    http = EngineHttp(eng, admin_credentials=("op", "opsecret"))
    http.start()
    assert eng.wait_leaders(60)
    yield eng, http.url
    http.stop()
    eng.stop()


def test_tenant_auth_survives_restart(cluster):
    """tests/test_tenant_security.py's restart test, on the port: the
    auth state the matrix test wrote rides tenant 1's own log and
    comes back after a restart of the port's engine."""
    eng, base, data_dir = cluster
    st, _ = _req("GET", f"{base}/tenants/1/v2/security/enable")
    assert st == 200

    eng._stop_ev.set()
    eng._thread.join(10)
    eng.wal.close()
    eng2 = MultiEngine(EngineConfig(
        groups=3, peers=3, data_dir=data_dir, fsync=False,
        request_timeout=30.0, device="cpu"))
    eng2.start()
    http2 = EngineHttp(eng2)
    http2.start()
    try:
        assert eng2.wait_leaders(60)
        b2 = http2.url
        st, body = _req("GET", f"{b2}/tenants/1/v2/security/enable")
        assert st == 200 and body["enabled"] is True
        st, body = _req("PUT", f"{b2}/tenants/1/v2/keys/app/y",
                        b"value=2", FH)
        assert st == 401 and body.get("errorCode") == 110
        st, _ = _req("PUT", f"{b2}/tenants/1/v2/keys/app/y", b"value=2",
                     {**FH, **_auth("alice", "apw")})
        assert st == 201
    finally:
        http2.stop()
        eng2.stop()


# -- the differential ----------------------------------------------------------

JSON_HDR = {"Content-Type": "application/json"}
ROOT_AUTH = "Basic " + base64.b64encode(b"root:pw").decode()


def _form(**kv):
    return (urllib.parse.urlencode(kv).encode(),
            {"Content-Type": "application/x-www-form-urlencoded"})


def _json(obj):
    return json.dumps(obj).encode(), JSON_HDR


def _script(follower):
    """(method, path, (body, headers) or None) in order. Tenant 1 takes
    the keys API, tenant 3 the security sequence, tenant 2 `follower`'s
    removal and re-addition."""
    k = "/tenants/1/v2/keys"
    batch = {"reqs": [
        {"method": "PUT", "path": "/e", "value": "1"},
        {"method": "PUT", "path": "/a", "value": "x", "prevValue": "wrong"},
        {"method": "DELETE", "path": "/missing"},
        {"method": "POST", "path": "/queue", "value": "j3"},
    ]}
    return [
        # create and update
        ("PUT", k + "/a", _form(value="1")),
        ("PUT", k + "/a", _form(value="2")),
        ("PUT", k + "/a?prevExist=false", _form(value="x")),
        ("PUT", k + "/a?prevExist=true", _form(value="3")),
        ("PUT", k + "/b?prevExist=true", _form(value="x")),
        ("PUT", k + "/ttl", _form(value="t", ttl="100")),
        ("PUT", k + "/ttl", _form(ttl="200", refresh="true",
                                  prevExist="true")),
        ("PUT", k + "/d1", _form(dir="true")),
        ("PUT", k + "/d1/x", _form(value="x")),
        ("PUT", k + "/d1/sub/y", _form(value="y")),
        ("PUT", k + "/d1", _form(value="onto-a-dir")),
        # compare-and-swap, winners and losers
        ("PUT", k + "/a?prevValue=3", _form(value="4")),
        ("PUT", k + "/a?prevValue=nope", _form(value="5")),
        ("PUT", k + "/a?prevIndex=1", _form(value="5")),
        ("PUT", k + "/a?prevIndex=4&prevValue=4", _form(value="6")),
        ("PUT", k + "/a?prevIndex=9", _form(value="6")),
        # compare-and-delete, winners and losers
        ("PUT", k + "/c", _form(value="c")),
        ("DELETE", k + "/c?prevValue=wrong", None),
        ("DELETE", k + "/c?prevValue=c", None),
        ("DELETE", k + "/c", None),
        ("DELETE", k + "/d1?dir=true", None),
        # in-order POST
        ("POST", k + "/queue", _form(value="j1")),
        ("POST", k + "/queue", _form(value="j2")),
        ("GET", k + "/queue?recursive=true&sorted=true", None),
        # directory GET, serial and quorum
        ("GET", k + "/d1", None),
        ("GET", k + "/d1?recursive=true&sorted=true", None),
        ("GET", k + "/d1?quorum=true", None),
        ("GET", k + "/d1?recursive=true&sorted=true&quorum=true", None),
        ("GET", k + "/missing?quorum=true", None),
        ("GET", k + "/ttl", None),
        ("GET", k + "/", None),
        # HEAD
        ("HEAD", k + "/a", None),
        ("HEAD", k + "/missing", None),
        # watch at an index the history holds (answers at once)
        ("GET", k + "/a?wait=true&waitIndex=1", None),
        ("GET", k + "/d1?wait=true&recursive=true&waitIndex=3", None),
        ("GET", k + "/queue?wait=true&recursive=true&waitIndex=2", None),
        # /batch with failing slots
        ("POST", "/tenants/1/batch", _json(batch)),
        ("POST", "/tenants/1/batch", _json({"reqs": "nope"})),
        ("POST", "/tenants/1/batch", _json([
            {"method": "PUT", "path": "/../../escape", "value": "x"}])),
        ("GET", k + "/e", None),
        # per-tenant security, then a denied and an allowed slot
        ("PUT", "/tenants/3/v2/security/enable", None),
        ("PUT", "/tenants/3/v2/security/users/root",
         _json({"user": "root", "password": "pw"})),
        ("PUT", "/tenants/3/v2/security/roles/guest",
         _json({"role": "guest",
                "permissions": {"kv": {"read": ["/*"], "write": []}}})),
        ("PUT", "/tenants/3/v2/security/enable", None),
        ("GET", "/tenants/3/v2/security/enable", None),
        ("PUT", "/tenants/3/v2/keys/denied", _form(value="x")),
        ("POST", "/tenants/3/batch", _json({"reqs": [
            {"method": "PUT", "path": "/s/anon", "value": "x"},
            {"method": "PUT", "path": "/s/root", "value": "ok",
             "auth": ROOT_AUTH}]})),
        ("GET", "/tenants/3/v2/keys/s/root", None),
        ("GET", "/tenants/3/v2/security/users", None),
        # membership through the group's own consensus
        ("POST", "/tenants/2/conf", _json({"op": "remove",
                                           "slot": follower})),
        ("GET", "/tenants/2/status", None),
        ("POST", "/tenants/2/conf", _json({"op": "add",
                                           "slot": follower})),
        ("POST", "/tenants/2/conf", _json({"op": "add",
                                           "slot": follower})),
        ("POST", "/tenants/2/conf", (b"junk", JSON_HDR)),
        ("PUT", "/tenants/2/v2/keys/after-conf", _form(value="v")),
        # stats and status
        ("GET", "/tenants/1/v2/stats/store", None),
        ("GET", "/tenants/1/v2/stats/self", None),
        ("GET", "/tenants/1/v2/stats/leader", None),
        ("GET", "/tenants/1/v2/stats/nope", None),
        ("GET", "/tenants/1/status", None),
        ("GET", "/tenants/2/status", None),
        ("GET", "/tenants", None),
        ("GET", "/tenants/9/v2/keys/a", None),
        ("GET", "/tenants/1/unknown", None),
        ("GET", "/version", None),
        ("GET", "/health", None),
    ]


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in MASKED_FIELDS else _mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _exchange(base, method, path, body_headers):
    body, headers = body_headers or (None, {})
    r = urllib.request.Request(base + path, data=body, method=method,
                               headers=headers)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            st, hd, raw = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        st, hd, raw = e.code, e.headers, e.read()
    try:
        payload = _mask(json.loads(raw)) if raw else None
    except ValueError:
        payload = raw
    out = {"status": st, "X-Etcd-Index": hd.get("X-Etcd-Index"),
           "Content-Type": hd.get("Content-Type"), "body": payload}
    if method == "HEAD":
        out["Content-Length"] = hd.get("Content-Length")
    return out


def _batchframe_round_trip(port):
    """One pipelined pair of request frames on a fresh channel to tenant
    1; returns the two response frames with the slot bodies parsed."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        sock.sendall(batchframe.handshake_request(1, "t"))
        rfile = sock.makefile("rb")
        assert batchframe.read_handshake_status(rfile) == 101
        items = [[{"method": "PUT", "path": "/bf/a", "value": "1"},
                  {"method": "PUT", "path": "/bf/a", "value": "2",
                   "prevValue": "wrong"},
                  {"method": "POST", "path": "/bf/q", "value": "j"}],
                 [{"method": "DELETE", "path": "/bf/a"},
                  {"method": "PUT", "path": "/bf/a", "value": "3",
                   "prevExist": True}]]
        for fid, part in enumerate(items, 7):
            payload = native.pack_multi(
                [(0, b"\x00" + json.dumps(d).encode()) for d in part],
                batchframe.P_MULTI)
            sock.sendall(batchframe.pack_request_frame(fid, b"", payload))
        sock.sendall(batchframe.pack_request_frame(9, b"", b"junk"))
        out = []
        for _ in range(3):
            fid, slots, err = batchframe.read_response_frame(rfile)
            out.append((fid, None if slots is None else
                        [(s, _mask(json.loads(b))) for s, b in slots],
                        err if err == () else (err[0], json.loads(err[1]))))
        return out
    finally:
        sock.close()


def _warm_quorum_read(base, deadline_s=60.0):
    """The JAX engine builds its read step at the first quorum read,
    which can outlast a request's timeout on the CPU: retry one quorum
    GET of tenant 0 (which the script does not touch) until it answers
    from the store (404, key not found)."""
    deadline = time.monotonic() + deadline_s
    while True:
        got = _exchange(base, "GET", "/tenants/0/v2/keys/warm?quorum=true",
                        None)
        if got["status"] == 404:
            return
        assert time.monotonic() < deadline, got


def test_http_front_matches_the_jax_front(tmp_path):
    fronts = {}
    try:
        for name, mod, cls in (("jax", jax_engine, JaxEngineHttp),
                               ("torch", torch_engine, EngineHttp)):
            fronts[name] = _start(mod, cls, tmp_path / name)
        for _, front in fronts.values():
            _warm_quorum_read(front.url)
        leads = {n: e.leader_slot(2) for n, (e, _) in fronts.items()}
        assert leads["jax"] == leads["torch"] >= 0, leads
        follower = (leads["jax"] + 1) % P
        got = {n: [] for n in fronts}
        for i, (method, path, bh) in enumerate(_script(follower)):
            for n, (_, front) in fronts.items():
                got[n].append(_exchange(front.url, method, path, bh))
            assert got["torch"][-1] == got["jax"][-1], (i, method, path)
        for n, (_, front) in fronts.items():
            got[n].append(_batchframe_round_trip(front.http.port))
        assert got["torch"][-1] == got["jax"][-1]
        # The script reached every answer it was written for.
        statuses = {g["status"] for g in got["jax"][:-1]}
        assert {200, 201, 400, 401, 403, 404, 412}.issubset(statuses), \
            statuses
    finally:
        for eng, front in fronts.values():
            front.stop()
            eng.stop()

