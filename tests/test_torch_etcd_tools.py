"""etcd's own tools in the port: dump-logs (etcd_tpu_torch/tools/
dump_logs.py) and the card tools `latency_hops`, `soak` and
`multihost_bench`, here on the CPU.

1. tests/test_tools.py's stresser, dump-logs and v3 dump cases, compiled
   against the port (tests/port_tests.py), and a mirror of its
   test_dump_engine_wal on a `device="cpu"` engine (the source builds its
   engine without a device; the port's default is the card).
2. The JAX package's dump-logs and the port's print the same text on the
   same data dir: a member's written by either package, both ways round;
   a member's v3 backend; the WAL of the port's engine.
3. `python -m etcd_tpu_torch.tools.soak kernel 2 --device cpu`,
   `python -m etcd_tpu_torch.tools.latency_hops 64 --device cpu` and
   `MHB_DEVICE=cpu python -m etcd_tpu_torch.tools.multihost_bench` at
   small sizes, each rc 0 with its result.

Tolerance: exact."""
import base64
import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from port_tests import on_the_port

_tools = on_the_port("test_tools")
test_stresser_counts = _tools.test_stresser_counts
test_dump_logs = _tools.test_dump_logs
test_dump_v3 = _tools.test_dump_v3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_tools_cases_build_the_ports_modules():
    assert _tools.dump_logs.__name__ == "etcd_tpu_torch.tools.dump_logs"
    assert _tools.Stresser.__module__ == \
        "etcd_tpu_torch.tools.functional_tester"


def _engine_wal(d, batch=()):
    """A `device="cpu"` engine's data dir with one acked PUT in it, and
    after it, given `batch` paths, one batched entry of PUTs to them."""
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from etcd_tpu_torch.server.request import Request

    eng = MultiEngine(EngineConfig(groups=2, peers=3, window=16, max_ents=4,
                                   data_dir=d, fsync=False,
                                   request_timeout=30.0, device="cpu"))
    try:
        for _ in range(200):
            if all(eng.leader_slot(g) >= 0 for g in range(2)):
                break
            eng.run_round()
        out = {}

        def put():
            out["r"] = eng.do(0, Request(method="PUT", path="/dumped",
                                         val="v"))
        def put_batch():
            out["b"] = eng.do_many(1, [Request(method="PUT", path=p,
                                               val="b") for p in batch])

        for work, key in ((put, "r"), (put_batch, "b"))[:1 + bool(batch)]:
            t = threading.Thread(target=work, daemon=True)
            t.start()
            for _ in range(300):
                if not t.is_alive():
                    break
                eng.run_round()
                t.join(timeout=0.001)
            assert key in out
    finally:
        eng.stop()


def test_dump_engine_wal(tmp_path):
    """Mirror of tests/test_tools.py's test of this name on a
    `device="cpu"` engine."""
    from etcd_tpu_torch.tools.dump_logs import dump_engine

    _engine_wal(str(tmp_path / "e"))
    buf = io.StringIO()
    assert dump_engine(str(tmp_path / "e"), out=buf) == 0
    text = buf.getvalue()
    assert "round" in text
    assert "PUT /dumped" in text


def _member_dir(pkg, d):
    """A one-member data dir written by `pkg`'s member: v2 writes across
    a snapshot, a v3 put and a lease."""
    import importlib

    from test_http import free_ports
    embed = importlib.import_module(f"{pkg}.embed")
    client = importlib.import_module(f"{pkg}.client")
    pport, cport = free_ports(2)
    m = embed.Etcd(embed.EtcdConfig(
        name="d0", data_dir=d,
        initial_cluster={"d0": [f"http://127.0.0.1:{pport}"]},
        listen_client_urls=[f"http://127.0.0.1:{cport}"],
        tick_ms=10, snap_count=8))
    m.start()
    try:
        assert m.wait_leader(10)
        kapi = client.KeysAPI(client.Client(list(m.client_urls)))
        for i in range(20):
            kapi.set(f"dump-{i}", f"v{i}")
        e64 = lambda s: base64.b64encode(s.encode()).decode()  # noqa: E731

        def post(path, body):
            r = urllib.request.Request(
                m.client_urls[0] + path, data=json.dumps(body).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(r, timeout=10).read())

        post("/v3/kv/put", {"key": e64("dv3/a"), "value": e64("1")})
        b = post("/v3/lease/grant", {"ttl": 600})
        post("/v3/lease/attach", {"lease_id": b["lease_id"],
                                  "key": e64("dv3/a")})
    finally:
        m.stop()


def _dumps(fn_name, d):
    """(JAX package's text, port's text, their return codes) of one dump
    function on one data dir."""
    from etcd_tpu.tools import dump_logs as jax_dump
    from etcd_tpu_torch.tools import dump_logs as port_dump
    out = []
    for mod in (jax_dump, port_dump):
        buf = io.StringIO()
        out.append((getattr(mod, fn_name)(d, out=buf), buf.getvalue()))
    return out


@pytest.mark.parametrize("writer", ["etcd_tpu", "etcd_tpu_torch"],
                         ids=["jax-member", "port-member"])
def test_dump_logs_prints_what_the_jax_packages_prints(tmp_path, writer):
    """A member's data dir written by `writer`: the two packages' dump
    and dump_v3 print the same text (snapshot, WAL metadata, the entries
    after it, hard state; consistent index, keys, leases)."""
    d = str(tmp_path / "d0")
    _member_dir(writer, d)
    for fn in ("dump", "dump_v3"):
        (rc_j, jax_text), (rc_p, port_text) = _dumps(fn, d)
        assert rc_j == rc_p == 0
        assert port_text == jax_text
        assert ("HardState: term=" if fn == "dump" else "dv3/a\t") \
            in jax_text


def test_dump_engine_prints_what_the_jax_packages_prints(tmp_path):
    """The WAL of the port's engine: the two packages' dump_engine print
    the same text."""
    d = str(tmp_path / "e")
    _engine_wal(d)
    (rc_j, jax_text), (rc_p, port_text) = _dumps("dump_engine", d)
    assert rc_j == rc_p == 0
    assert port_text == jax_text and "PUT /dumped" in jax_text


def test_dump_engine_decodes_batched_entries(tmp_path):
    """An entry of coalesced writes (P_MULTI, what the ingress's batches
    and concurrent writes to one tenant become): the port's dump_engine
    prints each of its Requests, where the JAX package's prints "?";
    every other line is the same."""
    d = str(tmp_path / "e")
    _engine_wal(d, batch=["/b0", "/b1", "/b2"])
    (rc_j, jax_text), (rc_p, port_text) = _dumps("dump_engine", d)
    assert rc_j == rc_p == 0
    batched = " multi[3] PUT /b0, PUT /b1, PUT /b2"
    assert port_text.count(batched) == 1
    assert port_text.replace(batched, " ?") == jax_text


def _run(args, env=None):
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(env or {})
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          env=full, capture_output=True, text=True,
                          timeout=300)


def test_dump_logs_module_names_the_port():
    res = _run(["etcd_tpu_torch.tools.dump_logs"])
    assert res.returncode == 2
    assert "python -m etcd_tpu_torch.tools.dump_logs" in res.stderr


def test_soak_kernel_on_the_cpu():
    res = _run(["etcd_tpu_torch.tools.soak", "kernel", "2", "--device",
                "cpu"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "kernel soak OK: 2 schedules" in res.stdout
    assert "zero divergences" in res.stdout


def test_latency_hops_on_the_cpu():
    res = _run(["etcd_tpu_torch.tools.latency_hops", "64", "--device",
                "cpu"])
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["groups"] == line["groups_led"] == \
        line["groups_committing"] == 64
    assert line["rounds"] == 80 and line["commits_per_s"] > 0
    # The plain resolve serves CPU tensors: no kernel launch.
    assert set(line["launches_by_variant"].values()) == {0}


def test_multihost_bench_on_the_cpu(tmp_path):
    out = tmp_path / "mhb.json"
    res = _run(["etcd_tpu_torch.tools.multihost_bench"], env={
        "MHB_DEVICE": "cpu", "MHB_GROUPS": "8", "MHB_SECONDS": "1",
        "MHB_OUT": str(out)})
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(out.read_text())
    assert got["device"] == "cpu" and got["groups"] == 8
    for phase in ("frames3", "single_h1", "single_h3"):
        assert got[phase]["acked_writes_per_sec"] > 0, got
        # Both phases ack: the saturated closed loop and the paced one.
        assert got[phase]["saturated_acked"] > 0, got
        assert got[phase]["paced_acked"] > 0, got
        assert got[phase]["in_flight_cap"] == 16384, got
        assert got[phase]["drained"] is True, got
        # Each write counts once: frames3's three hosts each apply it.
        assert (got[phase]["saturated_acked"]
                == got[phase]["saturated_offered"]), got
    assert json.loads(res.stdout.strip().splitlines()[-1]) == got


def test_multihost_bench_saturates_through_a_closed_loop():
    """The saturated phase keeps the writes in flight (offered, not yet
    acked) at or under `in_flight_cap(G)` whatever G, where an open loop
    offering 4·G writes every 5 ms flooded the engines at 100,000 groups
    (they acked nothing). Here a stand-in engine acks 1,000 queued writes
    a millisecond, FIFO, at G = 100,000: its queue holds more than one
    round's admission (4·G) and never more than the cap, phase A drains,
    and both phases ack."""
    import collections
    from etcd_tpu_torch.tools import multihost_bench as mhb
    G = 100_000
    lock = threading.Lock()
    queue = collections.deque()      # [count, sample or None]
    state = {"acked": 0, "peak": 0, "stop": False}

    def enqueue(k):
        with lock:
            queue.append([k, None])
            state["peak"] = max(state["peak"],
                                sum(c for c, _ in queue))

    def sample_one():
        s = mhb._Sample()
        with lock:
            queue.append([1, s])
        return s

    def engine():
        while not state["stop"]:
            with lock:
                budget = 1000
                while queue and budget:
                    item = queue[0]
                    n = min(item[0], budget)
                    item[0] -= n
                    budget -= n
                    state["acked"] += n
                    if item[0] == 0:
                        queue.popleft()
                        if item[1] is not None:
                            item[1].put(True)
            time.sleep(0.001)

    th = threading.Thread(target=engine, daemon=True)
    th.start()
    try:
        res = mhb._measure("stand-in", G, 0.5, enqueue, sample_one,
                           lambda: 1.0, lambda: state["acked"])
    finally:
        state["stop"] = True
        th.join(timeout=10)
    cap = mhb.in_flight_cap(G)
    assert cap == 2 * 4 * G
    assert res["in_flight_cap"] == cap and res["drained"] is True
    assert 4 * G < state["peak"] <= cap, state["peak"]
    assert res["saturated_acked"] > 0 and res["acked_writes_per_sec"] > 0
    assert res["paced_acked"] > 0 and res["latency_samples"] > 0
