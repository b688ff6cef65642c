"""The coalescing ingress tier and the batched write surface on the port's
stack: the port's MultiEngine (device="cpu"), its EngineHttp front and
its Ingress (etcd_tpu_torch.server.ingress, in process or as
`python -m etcd_tpu_torch.server.ingress`).

Mirrors of tests/test_ingress.py (per-client FIFO through coalescing,
error fan-back, no acked write lost across a SIGKILL of the ingress,
client identity through coalescing) and tests/test_do_many.py (the
/batch route, the batchframe channel's WAL parity with /batch, and a
channel severed mid-flight collecting its staged flushes). The port
builds its C ingress core at first use, so its ingress runs the C
scanner and formatter (etcd_ingress_native_enabled 1); the FIFO test
also runs with use_native=False, the Python hot loop (0). Tolerance:
exact (statuses, errorCodes, values, event histories and store dumps
equal).
"""
import base64
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from etcd_tpu_torch import errors, native
from etcd_tpu_torch.etcdhttp.tenants import EngineHttp
from etcd_tpu_torch.server import batchframe
from etcd_tpu_torch.server import engine as engine_mod
from etcd_tpu_torch.server.cluster import STORE_KEYS_PREFIX
from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
from etcd_tpu_torch.server.ingress import Ingress, IngressConfig
from etcd_tpu_torch.server.request import Request
from etcd_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, P = 4, 3


def make_engine(tmp, **kw):
    kw.setdefault("groups", G)
    kw.setdefault("peers", P)
    kw.setdefault("window", 16)
    kw.setdefault("max_ents", 4)
    kw.setdefault("heartbeat_tick", 3)
    kw.setdefault("request_timeout", 30.0)
    kw.setdefault("fsync", False)  # tmpdirs; durability logic unchanged
    kw.setdefault("checkpoint_rounds", 1 << 30)
    return MultiEngine(EngineConfig(data_dir=str(tmp), device="cpu", **kw))


class front:
    """engine + EngineHttp front, torn down in reverse order."""

    def __init__(self, tmp):
        self.eng = make_engine(tmp, round_interval=0.001)
        self.front = EngineHttp(self.eng)
        self.front.start()
        self.eng.start()
        self.url = self.front.url
        self.port = self.front.http.port
        assert self.eng.wait_leaders(60.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.front.stop()
        self.eng.stop()


class stack(front):
    """engine + EngineHttp front + in-process Ingress."""

    def __init__(self, tmp, **ingress_kw):
        super().__init__(tmp)
        self.ing = Ingress(IngressConfig(upstream=self.url, **ingress_kw))
        self.ing.start()
        self.base = f"http://127.0.0.1:{self.ing.port}"

    def __exit__(self, *exc):
        self.ing.stop()
        super().__exit__(*exc)


def _put(base, t, key, val, timeout=30, headers=None, **params):
    q = "&".join(f"{k}={v}" for k, v in params.items())
    req = urllib.request.Request(
        f"{base}/tenants/{t}/v2/keys{key}" + (f"?{q}" if q else ""),
        data=f"value={val}".encode(), method="PUT")
    req.add_header("Content-Type", "application/x-www-form-urlencoded")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _req_json(url, method="PUT", payload=None, headers=None, timeout=30):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            return r.status, (json.loads(raw) if raw else None)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else None)


def _get_json(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _scrape(base, name):
    with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
        text = r.read().decode()
    for ln in text.splitlines():
        if ln.startswith(name) and " " in ln:
            return float(ln.rsplit(" ", 1)[1])
    return None


def _join_all(threads, timeout):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert all(not t.is_alive() for t in threads), "clients hung"


# -- tests/test_ingress.py ---------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False],
                         ids=["c-hot-loop", "python-hot-loop"])
def test_per_client_fifo_through_coalescing(tmp_path, use_native):
    """Depth-1 clients writing sequentially through small flush windows:
    every client's writes apply in its submission order, and the lanes
    really coalesced (flushes < requests). The port's ingress reports
    the hot loop it runs: the C one by default, the Python one with
    use_native=False."""
    with stack(tmp_path, flush_max_requests=8,
               use_native=use_native) as s:
        assert _scrape(s.base, "etcd_ingress_native_enabled") == \
            (1.0 if use_native else 0.0)
        n0 = _scrape(s.base, "etcd_ingress_coalesce_batch_requests_count")
        s0 = _scrape(s.base, "etcd_ingress_coalesce_batch_requests_sum")
        N, W = 24, 12
        fails = []
        indexes = {c: [] for c in range(N)}

        def client(c):
            for seq in range(W):
                st, body = _put(s.base, c % G, f"/c{c}", f"{c}:{seq}")
                if st not in (200, 201):
                    fails.append((c, seq, st, body))
                    return
                indexes[c].append(body["node"]["modifiedIndex"])

        _join_all([threading.Thread(target=client, args=(c,))
                   for c in range(N)], 120)
        assert not fails, fails[:3]
        for c in range(N):
            ix = indexes[c]
            assert len(ix) == W and ix == sorted(ix) and \
                len(set(ix)) == W, (c, ix)
            _, body = _put(s.base, c % G, f"/c{c}", "final",
                           prevValue=f"{c}:{W-1}")
            assert body.get("action") == "compareAndSwap", (c, body)
        n1 = _scrape(s.base, "etcd_ingress_coalesce_batch_requests_count")
        s1 = _scrape(s.base, "etcd_ingress_coalesce_batch_requests_sum")
        flushes, reqs = n1 - n0, s1 - s0
        assert reqs >= N * W and flushes < reqs, (flushes, reqs)


def test_error_fanback_routing(tmp_path):
    """Failing CAS writes share flush windows with valid writes: each
    client gets exactly its own outcome (412/101 or 201)."""
    with stack(tmp_path, flush_max_requests=16) as s:
        assert _put(s.base, 0, "/cas", "base")[0] == 201
        outcomes = {}

        def loser(i):
            st, body = _put(s.base, 0, "/cas", f"steal{i}",
                            prevValue="wrong")
            outcomes[("l", i)] = (st, body.get("errorCode"))

        def writer(i):
            st, _ = _put(s.base, 0, f"/ok{i}", f"v{i}")
            outcomes[("w", i)] = (st, None)

        _join_all([threading.Thread(target=loser, args=(i,))
                   for i in range(8)]
                  + [threading.Thread(target=writer, args=(i,))
                     for i in range(8)], 60)
        for i in range(8):
            assert outcomes[("l", i)] == (412, 101), outcomes[("l", i)]
            assert outcomes[("w", i)] == (201, None), outcomes[("w", i)]
        assert _get_json(f"{s.base}/tenants/0/v2/keys/cas"
                         )["node"]["value"] == "base"
        for i in range(8):
            assert _get_json(f"{s.base}/tenants/0/v2/keys/ok{i}"
                             )["node"]["value"] == f"v{i}"


def _spawn_ingress(upstream):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch.server.ingress",
         "--upstream", upstream],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=REPO)
    info = json.loads(p.stdout.readline())
    return p, info["port"]


def test_sigkill_loses_no_acked_write(tmp_path):
    """Depth-1 clients count a write only after the ingress relayed the
    upstream ack; SIGKILL the ingress process mid-stream; every counted
    write must be in the engine. A fresh ingress then resumes service
    and exits 0 on SIGTERM."""
    import http.client

    stop = threading.Event()
    proc = None
    with front(tmp_path) as f:
        try:
            proc, port = _spawn_ingress(f.url)
            NC = 8
            acked = [-1] * NC

            def client(cid):
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=15)
                seq = 0
                while not stop.is_set():
                    try:
                        conn.request(
                            "PUT", f"/tenants/{cid % G}/v2/keys/s{cid}",
                            body=f"value={cid}:{seq}",
                            headers={"Content-Type":
                                     "application/x-www-form-urlencoded"})
                        r = conn.getresponse()
                        r.read()
                        if not 200 <= r.status < 300:
                            return
                    except (OSError, http.client.HTTPException):
                        return      # killed mid-request: seq stays unacked
                    acked[cid] = seq    # ONLY after the relayed ack
                    seq += 1
                conn.close()

            ths = [threading.Thread(target=client, args=(c,))
                   for c in range(NC)]
            for t in ths:
                t.start()
            deadline = time.time() + 60
            while time.time() < deadline and min(acked) < 5:
                time.sleep(0.05)
            assert min(acked) >= 5, f"clients never got going: {acked}"
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
            for t in ths:
                t.join(timeout=30)
            assert all(not t.is_alive() for t in ths), "client hung"

            for cid in range(NC):
                ev = f.eng.do(cid % G, Request(
                    method="GET", path=f"{STORE_KEYS_PREFIX}/s{cid}"))
                stored = int(ev.node.value.split(":")[1])
                assert stored >= acked[cid], \
                    f"client {cid}: acked seq {acked[cid]} but engine " \
                    f"has {stored}: an acked write was lost"

            proc, port2 = _spawn_ingress(f.url)
            st, body = _put(f"http://127.0.0.1:{port2}", 0, "/s0",
                            "after-restart")
            assert st in (200, 201), (st, body)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        finally:
            stop.set()
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


def test_auth_identity_survives_coalescing(tmp_path):
    """With tenant security enabled, coalesced writes are authorized as
    THEIR client: each batch slot carries its own credentials."""
    with stack(tmp_path, flush_max_requests=16) as s:
        fb = s.url
        auth = {"Authorization": "Basic " +
                base64.b64encode(b"root:pw").decode()}
        st, body = _req_json(fb + "/tenants/0/v2/security/users/root",
                             payload={"user": "root", "password": "pw"})
        assert st == 201, body
        st, body = _req_json(
            fb + "/tenants/0/v2/security/roles/guest",
            payload={"role": "guest", "permissions":
                     {"kv": {"read": ["/*"], "write": []}}})
        assert st == 201, body
        st, body = _req_json(fb + "/tenants/0/v2/security/enable")
        assert st == 200, body

        st, body = _put(s.base, 0, "/sec/anon", "x")
        assert st == 401 and body["errorCode"] == 110, (st, body)
        st, body = _put(s.base, 0, "/sec/root", "ok", headers=auth)
        assert st == 201, (st, body)
        outcomes = {}

        def anon(i):
            outcomes[("a", i)] = _put(s.base, 0, f"/sec/a{i}", "x")[0]

        def rootw(i):
            outcomes[("r", i)] = _put(s.base, 0, f"/sec/r{i}", "v",
                                      headers=auth)[0]

        _join_all([threading.Thread(target=anon, args=(i,))
                   for i in range(6)]
                  + [threading.Thread(target=rootw, args=(i,))
                     for i in range(6)], 60)
        for i in range(6):
            assert outcomes[("a", i)] == 401, outcomes
            assert outcomes[("r", i)] == 201, outcomes
        assert _get_json(f"{s.base}/tenants/0/v2/keys/sec/root"
                         )["node"]["value"] == "ok"
        st, body = _req_json(f"{s.base}/tenants/0/v2/security/users",
                             method="GET")
        assert st == 401, (st, body)
        st, body = _req_json(f"{s.base}/tenants/0/v2/security/users",
                             method="GET", headers=auth)
        assert st == 200 and "root" in body.get("users", []), (st, body)


# -- tests/test_do_many.py -----------------------------------------------------

def ev_sig(e):
    def nd(x):
        if x is None:
            return None
        return (x.key, x.value, x.dir, x.created_index, x.modified_index,
                x.expiration)
    return (e.action, nd(e.node), nd(e.prev_node), e.etcd_index)


def history_replay(st):
    hist = st.watcher_hub.event_history
    out = []
    i = hist.start_index
    while i <= hist.last_index:
        e = hist.scan("/", True, i)
        if e is None:
            break
        out.append(ev_sig(e))
        i = e.etcd_index + 1
    return out


def watch_replay(st, since):
    w = st.watch("/", recursive=True, stream=True, since_index=since)
    out = []
    while True:
        e = w.next_event(timeout=0.05)
        if e is None:
            return out
        out.append(ev_sig(e))


def _workload(g):
    return [
        Request(method="PUT", path="/k0", val=f"v{g}_0"),
        Request(method="PUT", path="/k1", val=f"v{g}_1"),
        Request(method="PUT", path="/k0", val="swapped",
                prev_value=f"v{g}_0"),
        Request(method="POST", path="/q", val="job"),
        Request(method="PUT", path="/new", val="n", prev_exist=False),
        Request(method="DELETE", path="/k1"),
        Request(method="PUT", path="/k0", val="nope",
                prev_value="wrong"),              # fails: 101
        Request(method="PUT", path="/k2", val=f"v{g}_2"),
    ]


def _state_after_restart(tmp):
    eng2 = make_engine(tmp)   # restart: state = WAL replay only
    try:
        state = {}
        for g in range(G):
            st = eng2.store(g)
            dump = st.get("/", recursive=True, want_sorted=True)
            state[g] = {"dump": ev_sig(dump),
                        "index": st.current_index,
                        "history": history_replay(st),
                        "watch": watch_replay(st, 1)}
        return state
    finally:
        eng2.stop()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST")
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def test_p_multi_tag_pin():
    """batchframe.P_MULTI mirrors the engine's (the ingress process must
    not import the engine)."""
    assert batchframe.P_MULTI == engine_mod.P_MULTI


def test_batch_http_route(tmp_path):
    """POST /tenants/{t}/batch: slot-aligned results with mixed outcomes,
    201 vs 200, tenant isolation, and the refusals."""
    with front(tmp_path) as f:
        base = f.url
        st, body = _post(f"{base}/tenants/0/batch", {"reqs": [
            {"method": "PUT", "path": "/a", "value": "1"},
            {"method": "PUT", "path": "/a", "value": "2"},
            {"method": "PUT", "path": "/a", "value": "x",
             "prevValue": "wrong"},
            {"method": "DELETE", "path": "/missing"},
            {"method": "POST", "path": "/q", "value": "job"},
        ]})
        assert st == 200
        rs = body["results"]
        assert [r["status"] for r in rs] == [201, 200, 412, 404, 201]
        assert rs[0]["event"]["node"]["value"] == "1"
        assert rs[1]["event"]["action"] == "set"
        assert rs[2]["error"]["errorCode"] == 101
        assert not rs[3]["error"]["cause"].startswith("/_etcd")
        st, body = _post(f"{base}/tenants/1/batch",
                         [{"method": "PUT", "path": "/a", "value": "t1"}])
        assert st == 200 and body["results"][0]["status"] == 201
        assert _get_json(f"{base}/tenants/1/v2/keys/a"
                         )["node"]["value"] == "t1"
        assert _get_json(f"{base}/tenants/0/v2/keys/a"
                         )["node"]["value"] == "2"
        assert _post(f"{base}/tenants/0/batch", {"reqs": []})[0] == 200
        assert _post(f"{base}/tenants/0/batch", {"reqs": "nope"})[0] == 400
        st, body = _post(f"{base}/tenants/0/batch",
                         [{"method": "GET", "path": "/a"}])
        assert st == 400 or body.get("results") is None
        st, _ = _post(f"{base}/tenants/0/batch",
                      [{"method": "PUT", "path": "/../../escape",
                        "value": "x"}])
        assert st in (400, 403)
        req = urllib.request.Request(f"{base}/tenants/0/batch",
                                     method="GET")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=15)
        assert ei.value.code == 405


def _item(r):
    d = {"method": r.method, "path": r.path}
    if r.val is not None:
        d["value"] = r.val
    if r.prev_value is not None:
        d["prevValue"] = r.prev_value
    if r.prev_exist is not None:
        d["prevExist"] = r.prev_exist
    if r.prev_index:
        d["prevIndex"] = r.prev_index
    return d


def _open_channel(port, tenant):
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    sock.sendall(batchframe.handshake_request(tenant, "t"))
    rfile = sock.makefile("rb")
    assert batchframe.read_handshake_status(rfile) == 101
    return sock, rfile


def _frame_payload(dicts):
    return native.pack_multi([(0, b"\x00" + json.dumps(d).encode())
                              for d in dicts], batchframe.P_MULTI)


def test_batchframe_route_and_wal_parity(tmp_path):
    """The same per-group workload as PIPELINED request frames and as
    JSON /batch posts: the same slot statuses, and after a restart the
    same store state, event history and watch replay."""
    d_frame, d_batch = tmp_path / "frame", tmp_path / "batch"
    frame_status = {}
    with front(d_frame) as f:
        for g in range(G):
            w = _workload(g)
            sock, rfile = _open_channel(f.port, g)
            try:
                for fid, part in ((7, w[:5]), (8, w[5:])):
                    sock.sendall(batchframe.pack_request_frame(
                        fid, b"", _frame_payload(map(_item, part))))
                sts = []
                for fid in (7, 8):
                    rid, slots, err = batchframe.read_response_frame(rfile)
                    assert rid == fid and err == (), (rid, err)
                    sts += [s for s, _ in slots]
                frame_status[g] = sts
                assert json.loads(slots[-1][1])["node"]["key"] == "/k2"
            finally:
                sock.close()
    for g in range(G):
        assert frame_status[g] == [201, 201, 200, 201, 201,
                                   200, 412, 201], frame_status[g]

    with front(d_batch) as f:
        for g in range(G):
            w = _workload(g)
            for part in (w[:5], w[5:]):
                st, _ = _post(f"{f.url}/tenants/{g}/batch",
                              {"reqs": [_item(r) for r in part]})
                assert st == 200

    s1, s2 = _state_after_restart(d_frame), _state_after_restart(d_batch)
    for g in range(G):
        assert s1[g] == s2[g], g


def test_batchframe_sever_midflight_collects_staged_flushes(tmp_path):
    """A channel severed with flushes still staged must not leak them:
    the engine-side collector collects every staged flush, so the
    pending-proposal gauge returns to its base; a fresh channel works."""
    with front(tmp_path) as f:
        base = metrics.propose_pending.value
        sock, rfile = _open_channel(f.port, 0)
        for fid in range(1, 4):
            sock.sendall(batchframe.pack_request_frame(
                fid, b"", _frame_payload(
                    {"method": "PUT", "path": f"/sv/{fid}_{i}",
                     "value": "x"} for i in range(3))))
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        rfile.close()
        sock.close()
        deadline = time.time() + 30
        while time.time() < deadline:
            if metrics.propose_pending.value <= base:
                break
            time.sleep(0.1)
        assert metrics.propose_pending.value <= base, \
            metrics.propose_pending.value
        sock2, rfile2 = _open_channel(f.port, 0)
        try:
            sock2.sendall(batchframe.pack_request_frame(
                9, b"", _frame_payload(
                    [{"method": "PUT", "path": "/sv/after",
                      "value": "y"}])))
            fid, slots, err = batchframe.read_response_frame(rfile2)
            assert fid == 9 and err == () and slots[0][0] == 201
        finally:
            sock2.close()


def test_do_many_in_slot_errors(tmp_path):
    """MultiEngine.do_many on the port: one result per request in order,
    failures in their slots; read methods refused."""
    with front(tmp_path) as f:
        res = f.eng.do_many(0, _workload(0))
        sig = [("err", r.code) if isinstance(r, errors.EtcdError)
               else r.action for r in res]
        assert sig == ["set", "set", "compareAndSwap", "create", "create",
                       "delete", ("err", 101), "set"]
        with pytest.raises(errors.EtcdError, match="bad batch method"):
            f.eng.do_many(0, [Request(method="GET", path="/x")])
