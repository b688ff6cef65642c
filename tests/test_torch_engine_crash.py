"""Crash ordering of the port's engine (etcd_tpu_torch, device="cpu"):
mirrors of the JAX package's crash tests.

- tests/test_wal_writer.py: SIGKILL of a writer process mid group commit
  (S=1) and mid parallel per-stream fsync (S=4) loses no acked round;
  an engine restarts over torn tails on every shard stream; a failed
  writer shard stays failed.
- tests/test_applier_pool.py: a dying applier worker fails the engine at
  the next seam.
- tests/test_read_plane.py: a read parked under a partitioned leader is
  never served stale; stop() fails parked reads.

Tolerance: exact (replayed payloads and served values equal what was
acked; the errors are the same errorCodes).
"""
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from etcd_tpu_torch import errors
from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
from etcd_tpu_torch.server.enginewal import RoundRecord
from etcd_tpu_torch.server.request import Request
from etcd_tpu_torch.server.walwriter import WALWriter, shard_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, P = 8, 3


def make_engine(tmp, **kw):
    kw.setdefault("groups", G)
    kw.setdefault("peers", P)
    kw.setdefault("window", 16)
    kw.setdefault("max_ents", 4)
    kw.setdefault("heartbeat_tick", 3)
    kw.setdefault("request_timeout", 30.0)
    kw.setdefault("fsync", False)
    kw.setdefault("sync_interval", 0.0)
    kw.setdefault("checkpoint_rounds", 1 << 30)
    return MultiEngine(EngineConfig(data_dir=str(tmp), device="cpu", **kw))


# -- tests/test_wal_writer.py ----------------------------------------------------

def mkrec(round_no, groups=G, tag="p"):
    rec = RoundRecord(round_no=round_no)
    g = np.arange(groups, dtype=np.uint32)
    rec.hs_g = g
    rec.hs_p = np.zeros(groups, np.uint16)
    rec.hs_term = np.full(groups, round_no + 1, np.uint32)
    rec.hs_vote = np.zeros(groups, np.uint16)
    rec.hs_commit = np.full(groups, round_no, np.uint32)
    rec.entries = [(int(gg), round_no + 1, 1,
                    f"{tag}-{gg}-{round_no}".encode()) for gg in g]
    return rec


def test_writer_failure_is_fail_stop(tmp_path):
    """A failed shard stays failed: the error re-raises at every later
    seam and the thread is never respawned."""
    w = WALWriter(str(tmp_path), groups=G, shards=1, fsync=False)

    def boom():
        raise RuntimeError("disk on fire")

    w.shards[0].wal.sync = boom
    t = w.submit(mkrec(0))
    with pytest.raises(RuntimeError, match="disk on fire"):
        w.wait_durable(t)
    with pytest.raises(RuntimeError, match="disk on fire"):
        w.submit(mkrec(1))
    w.shards[0].thread.join(timeout=5)
    assert not w.shards[0].thread.is_alive()
    w._ensure_threads()
    assert not w.shards[0].thread.is_alive(), "failed shard respawned"
    w.close()


_CRASH_CHILD = r"""
import sys
from etcd_tpu_torch.server.enginewal import RoundRecord
from etcd_tpu_torch.server.walwriter import WALWriter

d, S, G, ackpath = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
w = WALWriter(d, groups=G, shards=S, fsync=True, queue_rounds=8)
ack = open(ackpath, "a")
pending = []
r = 0
print("READY", flush=True)
while True:
    rec = RoundRecord(round_no=r)
    rec.entries = [(g, r + 1, 1, ("c-%d-%d" % (g, r)).encode())
                   for g in range(G)]
    pending.append((r, w.submit(rec)))
    r += 1
    if len(pending) >= 6:
        rr, tt = pending.pop(0)
        w.wait_durable(tt)
        ack.write("%d\n" % rr)
        ack.flush()
"""


@pytest.mark.parametrize("S", [1, 4])
def test_sigkill_mid_commit_loses_no_acked_write(tmp_path, S):
    """SIGKILL the port's writer process while group commits (S=1) or
    parallel per-stream fsyncs (S=4) are in flight: every round the
    child acked replays in full, and replay is a gap-free prefix."""
    d = tmp_path / f"crash{S}"
    ackpath = tmp_path / f"acked{S}.log"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-c", _CRASH_CHILD, str(d), str(S), str(G),
         str(ackpath)], stdout=subprocess.PIPE, cwd=ROOT, env=env)
    try:
        assert proc.stdout.readline().strip() == b"READY"
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                if len(ackpath.read_text().splitlines()) >= 25:
                    break
            except OSError:
                pass
            time.sleep(0.005)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    acked = [int(x) for x in ackpath.read_text().splitlines() if x]
    assert len(acked) >= 25, "child never got going"

    w = WALWriter(str(d), groups=G, shards=S)
    per_round = {}
    for rec in w.replay(-1):
        for g, _, _, payload in rec.entries:
            per_round.setdefault(rec.round_no, {})[g] = payload
    w.close()
    for r in acked:
        assert per_round.get(r) == {
            g: ("c-%d-%d" % (g, r)).encode() for g in range(G)
        }, f"acked round {r} lost or partial after crash"
    assert sorted(per_round) == list(range(len(per_round)))


def test_engine_restart_sharded_wal_with_torn_tails(tmp_path):
    """Acked writes + torn bytes on every shard stream; the port's engine
    restarts, replays all acked data and keeps serving."""
    d = tmp_path / "torn"
    eng = make_engine(d, wal_shards=4, applier_shards=2)
    eng.start()
    try:
        assert eng.wait_leaders(60)
        for g in range(G):
            eng.do(g, Request(method="PUT", path="/persist", val=f"g{g}"),
                   timeout=30)
    finally:
        eng.stop()
    for k in range(4):
        sd = shard_dir(str(d), k)
        segs = sorted(n for n in os.listdir(sd) if n.endswith(".wal"))
        with open(os.path.join(sd, segs[-1]), "ab") as f:
            f.write(b"\x02\x00\x00\x00torn-mid-append")
    eng2 = make_engine(d, wal_shards=4, applier_shards=2)
    try:
        for g in range(G):
            ev = eng2.do(g, Request(method="GET", path="/persist"))
            assert ev.node.value == f"g{g}", f"group {g} lost data"
        eng2.start()
        assert eng2.wait_leaders(60)
        eng2.do(0, Request(method="PUT", path="/after", val="restart"),
                timeout=30)
        assert eng2.do(0, Request(method="GET", path="/after")
                       ).node.value == "restart"
    finally:
        eng2.stop()


# -- tests/test_applier_pool.py --------------------------------------------------

def inject(eng, g, r):
    """Queue a request without registering a waiter."""
    if r.id == 0:
        r = Request(**{**r.__dict__, "id": eng.reqid.next()})
    with eng._lock:
        eng._pending[g].append((r.id, b"\x00" + r.encode(), r))
        eng._dirty.add(g)
    return r.id


def _poison_store(eng, g, exc_factory):
    st = eng.store(g)

    def boom(*a, **kw):
        raise exc_factory()
    for name in ("set_applied_many", "set_applied", "set_applied_lazy",
                 "set"):
        if hasattr(st, name):
            setattr(st, name, boom)


def test_worker_crash_surfaces_engine_error(tmp_path):
    """A dying applier worker fails the engine at the next seam, halts
    for good (never respawned), and stop() keeps its error in .failed."""
    eng = make_engine(tmp_path / "crash", applier_shards=4)
    try:
        for _ in range(400):
            eng.run_round()
            if eng.wait_leaders(0.0):
                break
        assert eng.wait_leaders(5.0)
        _poison_store(eng, 0, lambda: RuntimeError("shard-0 store died"))
        inject(eng, 0, Request(method="PUT", path="/x", val="v"))
        with pytest.raises(RuntimeError, match="shard-0 store died"):
            for _ in range(200):
                eng.run_round()
            eng._drain_applies()
        broken = [sh for sh in eng._appliers if sh.exc is not None]
        assert len(broken) == 1, broken
        broken[0].thread.join(timeout=5)
        assert not broken[0].thread.is_alive(), "halted worker lived on"
        eng._ensure_appliers()
        assert not broken[0].thread.is_alive(), "halted worker respawned"
        with pytest.raises(RuntimeError, match="shard-0 store died"):
            eng._drain_applies()
        eng.stop()
        assert isinstance(eng.failed, RuntimeError)
    finally:
        eng.stop()


# -- tests/test_read_plane.py ----------------------------------------------------

def run_until(eng, pred, max_rounds=400, msg="condition"):
    for _ in range(max_rounds):
        if pred():
            return
        eng.run_round()
    raise AssertionError(f"{msg} not reached in {max_rounds} rounds")


def do_async(eng, g, r, timeout=None):
    out = {}

    def work():
        try:
            out["res"] = eng.do(g, r, timeout=timeout)
        except Exception as e:  # noqa: BLE001 — surfaced by settle()
            out["err"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t, out


def settle(eng, t, out, max_rounds=500):
    for _ in range(max_rounds):
        if not t.is_alive():
            break
        eng.run_round()
        t.join(timeout=0.001)
    t.join(timeout=1.0)
    if "err" in out:
        raise out["err"]
    assert "res" in out, "request did not complete"
    return out["res"]


def _read_engine(tmp, **kw):
    kw.setdefault("groups", 4)
    kw.setdefault("peers", 5)
    return make_engine(tmp, **kw)


def test_parked_read_fails_on_leadership_loss(tmp_path):
    """A read parked under a leader that lost its quorum ends in a raft
    error, never a stale Event; after the heal the read plane serves
    again.

    The JAX test cuts only the leader's links. The other four peers then
    elect a new leader within about a dozen rounds, and that leader may
    legally confirm the read. The JAX engine's rounds on the CPU are
    slow enough that the 2.5 s timeout comes first; the port's are not
    (12 rounds take about 0.3 s here). So this mirror cuts every link of
    group 0: no leader can confirm, re-confirmation is impossible, as
    the JAX test assumes, and the only legal outcome is the error."""
    eng = _read_engine(tmp_path / "ll", request_timeout=6.0)
    run_until(eng, lambda: all(eng.leader_slot(g) >= 0 for g in range(4)),
              msg="leaders")
    t, out = do_async(eng, 0, Request(method="PUT", path="/p",
                                      val="committed"))
    settle(eng, t, out)
    assert eng.leader_slot(0) >= 0
    mask = np.ones((eng.cfg.groups, eng.cfg.peers, eng.cfg.peers, 1),
                   np.int32)
    mask[0] = 0
    eng.drop_mask = mask

    t, out = do_async(eng, 0,
                      Request(method="GET", path="/p", quorum=True),
                      timeout=2.5)
    deadline = time.time() + 20.0
    while t.is_alive() and time.time() < deadline:
        eng.run_round()
        t.join(timeout=0.001)
    t.join(timeout=1.0)
    assert not t.is_alive(), "parked read neither served nor failed"
    assert "err" in out, f"read served under a partitioned leader: {out}"
    assert isinstance(out["err"], errors.EtcdError)
    assert out["err"].code == errors.ECODE_RAFT_INTERNAL

    eng.drop_mask = None
    run_until(eng, lambda: eng.leader_slot(0) >= 0, max_rounds=800,
              msg="re-elect")
    t, out = do_async(eng, 0, Request(method="GET", path="/p",
                                      quorum=True))
    assert settle(eng, t, out, max_rounds=800).node.value == "committed"
    eng.stop()


def test_engine_stop_fails_parked_reads(tmp_path):
    """stop() drains the parked-read queues with an error instead of
    leaving serving threads to ride out the request timeout."""
    eng = _read_engine(tmp_path / "st")
    run_until(eng, lambda: eng.leader_slot(0) >= 0, msg="leader")
    t, out = do_async(eng, 0, Request(method="PUT", path="/s", val="v"))
    settle(eng, t, out)
    t, out = do_async(eng, 0,
                      Request(method="GET", path="/s", quorum=True),
                      timeout=10.0)
    for _ in range(200):
        with eng._lock:
            if eng._reads_waiting:
                break
        time.sleep(0.005)
    eng.stop()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert "err" in out and isinstance(out["err"], errors.EtcdError)
