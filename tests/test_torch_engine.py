"""The port's MultiEngine (etcd_tpu_torch.server.engine, device="cpu")
against the JAX package's, driven by one deterministic schedule: seeded
PUTs, compare-and-swaps and deletes (some of which fail), parked quorum
reads, and a window in which the leaders of some groups are partitioned
away. Both engines must write the same WAL records field by field, hold
the same mirrors and stores and answer every request alike (errors by
errorCode). A data dir written by either engine restarts in the other."""
import os
import queue
import random
import shutil
import threading

import numpy as np
import pytest

import jax.numpy as jnp

from etcd_tpu.server import engine as jax_engine
from etcd_tpu.server.enginewal import EngineWAL
from etcd_tpu.store.event import LazyWriteEvent as JLazyWriteEvent
from etcd_tpu_torch import store as torch_store
from etcd_tpu_torch.server import engine as torch_engine
from etcd_tpu_torch.store.event import LazyWriteEvent
from etcd_tpu_torch.server.request import Request as TRequest
from etcd_tpu.server.request import Request as JRequest

G, P, W, E = 24, 3, 8, 2
ROUNDS = 60
CHURN_AT, HEAL_AT = 20, 34


class _Seq:
    """Sequential request ids (idutil embeds wall time; payload bytes must
    be equal across the two engines)."""

    def __init__(self):
        self.i = 0

    def next(self):
        self.i += 1
        return self.i


def _engine(mod, data_dir, **kw):
    extra = {"device": "cpu"} if mod is torch_engine else {}
    eng = mod.MultiEngine(mod.EngineConfig(
        groups=G, peers=P, data_dir=data_dir, window=W, max_ents=E,
        fsync=False, stagger=True, sync_interval=0.0,
        pipeline_applies=False, **{"checkpoint_rounds": 1 << 30, **kw},
        **extra))
    eng.reqid = _Seq()
    return eng


def _requests(rng, r):
    """This round's (group, method, kwargs) requests."""
    out = []
    for _ in range(rng.randrange(0, 10)):
        g = rng.randrange(G)
        k = f"/k{rng.randrange(4)}"
        roll = rng.random()
        if roll < 0.6:
            out.append((g, "PUT", dict(path=k, val=f"v{r}")))
        elif roll < 0.8:     # CAS: matches only sometimes
            out.append((g, "PUT", dict(path=k, val=f"c{r}",
                                       prev_value=f"v{rng.randrange(r + 1)}")))
        elif roll < 0.9:     # delete, of a key that may not exist
            out.append((g, "DELETE", dict(path=k)))
        else:                # quorum read through the read plane
            out.append((g, "QREAD", dict(path=k, quorum=True)))
    return out


def _drive(mod, data_dir, rounds=ROUNDS, **kw):
    """Run the schedule; returns (engine, {rid: waiter queue})."""
    Req = TRequest if mod is torch_engine else JRequest
    eng = _engine(mod, data_dir, **kw)
    rng = random.Random(7)
    waiters = {}
    for r in range(rounds):
        for g, method, kwargs in _requests(rng, r):
            rid = eng.reqid.next()
            waiters[rid] = eng.wait.register(rid)
            if method == "QREAD":
                rq = Req(method="GET", id=rid, **kwargs)
                with eng._lock:
                    eng._reads[g].append((rid, rq))
                    eng._read_dirty.add(g)
                    eng._reads_waiting += 1
                continue
            rq = Req(method=method, id=rid, **kwargs)
            with eng._lock:
                eng._pending[g].append((rid, bytes([0]) + rq.encode(), rq))
                eng._dirty.add(g)
        if r == CHURN_AT:
            mask = np.ones((G, P, P, 1), np.int32)
            lead = np.where(eng.h_mask, eng.h_state, 0) == 2
            for g in range(6):
                if lead[g].any():
                    s = int(lead[g].argmax())
                    mask[g, s, :, 0] = 0
                    mask[g, :, s, 0] = 0
            eng.drop_mask = (mask if mod is torch_engine
                             else jnp.asarray(mask))
        elif r == HEAL_AT:
            eng.drop_mask = None
        eng.run_round()
    return eng, waiters


def _result(q):
    """A waiter's result, a LazyWriteEvent resolved as the engine's own
    consumers resolve it (a C-store SET wakes its waiter with one)."""
    res = q.get_nowait()
    if isinstance(res, (LazyWriteEvent, JLazyWriteEvent)):
        return res.resolve()
    return res


def _answer(q):
    """A request's outcome in comparable form (None = not answered)."""
    try:
        res = _result(q)
    except queue.Empty:
        return None
    if isinstance(res, Exception):
        return ("error", getattr(res, "code", type(res).__name__))
    node = res.node
    return (res.action, node.key, node.value, node.modified_index,
            res.prev_node.value if res.prev_node is not None else None)


def _values(store):
    """key -> value of the keys the schedule writes."""
    out = {}
    for i in range(4):
        try:
            out[f"/k{i}"] = store.get(f"/k{i}", False, False).node.value
        except Exception as e:  # noqa: BLE001 — a missing key
            out[f"/k{i}"] = getattr(e, "code", None)
    return out


def _wal_records(data_dir):
    wal = EngineWAL(data_dir, fsync=False)
    recs = list(wal.replay(after_round=-1))
    wal.close()
    return recs


ARR_FIELDS = ("hs_g", "hs_p", "hs_term", "hs_vote", "hs_commit",
              "last_g", "last_p", "last_v", "ring_g", "ring_p", "ring_i",
              "ring_t")
MIRRORS = ("h_term", "h_vote", "h_commit", "h_state", "h_last", "h_ring",
           "h_mask", "applied")


def _assert_same_engines(a, b):
    for name in MIRRORS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.round_no == b.round_no
    assert a.acked_requests == b.acked_requests
    assert sorted(a._stores) == sorted(b._stores)
    for g in a._stores:
        assert a._stores[g].save() == b._stores[g].save(), g


@pytest.mark.parametrize("native", [True, False], ids=["c-store",
                                                      "python-store"])
def test_engine_matches_jax_engine(tmp_path, monkeypatch, native):
    """Both of the port's apply paths: the C store (a SET wakes its
    waiter with a LazyWriteEvent) and the Python store."""
    assert torch_store.HAVE_NATIVE_STORE
    monkeypatch.setattr(torch_store, "HAVE_NATIVE_STORE", native)
    je, jw = _drive(jax_engine, str(tmp_path / "jax"))
    te, tw = _drive(torch_engine, str(tmp_path / "torch"))
    try:
        want = torch_store.NativeStore if native else torch_store.Store
        assert all(type(s) is want for s in te._stores.values())
        lazy = sum(type(q.queue[0]) is LazyWriteEvent
                   for q in tw.values() if q.qsize())
        assert (lazy > 0) == native, lazy
        _assert_same_engines(je, te)
        assert sorted(jw) == sorted(tw)
        answers = {rid: (_answer(jw[rid]), _answer(tw[rid])) for rid in jw}
        for rid, (a, b) in answers.items():
            assert a == b, (rid, a, b)
        kinds = {a[0] for a, _ in answers.values() if a is not None}
        # The schedule really produced writes, deletes, failures and reads.
        assert {"set", "compareAndSwap", "delete", "get",
                "error"} <= kinds, kinds
        assert te.acked_requests > 50
    finally:
        je.stop()
        te.stop()
    ra = _wal_records(str(tmp_path / "jax"))
    rb = _wal_records(str(tmp_path / "torch"))
    assert len(ra) == len(rb) > 0
    for x, y in zip(ra, rb):
        assert x.round_no == y.round_no
        for f in ARR_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(x, f)),
                                          np.asarray(getattr(y, f)),
                                          err_msg=f"{x.round_no}: {f}")
        assert x.entries == y.entries, x.round_no
        assert x.confs == y.confs, x.round_no
    with open(tmp_path / "jax" / "geometry.json") as f1, \
            open(tmp_path / "torch" / "geometry.json") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("writer,reader", [(jax_engine, torch_engine),
                                           (torch_engine, jax_engine)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_data_dir_restarts_in_the_other_engine(tmp_path, writer, reader):
    """A checkpoint plus WAL written by one engine restores in the other
    and serves every acked write; the restarted engine keeps serving."""
    d = str(tmp_path / "data")
    eng, waiters = _drive(writer, d, rounds=40, checkpoint_rounds=16)
    acked = [a for a in map(_answer, waiters.values())
             if a is not None and a[0] in ("set", "compareAndSwap")]
    assert len(acked) > 20
    # Every acked write is in the writer's stores (later writes may have
    # replaced a value): the reader must serve the same values, and
    # restore the same mirrors and stores as the writer's own engine.
    want = {g: _values(s) for g, s in eng._stores.items()}
    eng.stop()
    shutil.copytree(d, str(tmp_path / "copy"))
    ref = _engine(writer, str(tmp_path / "copy"), checkpoint_rounds=16)
    ref_mirrors = {n: getattr(ref, n).copy() for n in MIRRORS}
    ref_stores = {g: s.save() for g, s in ref._stores.items()}
    ref_round = ref.round_no
    ref.stop()
    assert [f for f in os.listdir(d) if f.startswith("checkpoint-")], \
        os.listdir(d)

    re = _engine(reader, d, checkpoint_rounds=16)
    try:
        for n, v in ref_mirrors.items():
            np.testing.assert_array_equal(getattr(re, n), v, err_msg=n)
        assert re.round_no == ref_round
        assert {g: s.save() for g, s in re._stores.items()} == ref_stores
        assert {g: _values(s) for g, s in re._stores.items()} == want
        # It keeps serving: re-elect, then one more write per tenant.
        Req = TRequest if reader is torch_engine else JRequest
        rq = {}
        for g in range(G):
            rid = 10_000 + g
            rq[rid] = re.wait.register(rid)
            r = Req(method="PUT", path="/after", val=f"a{g}", id=rid)
            with re._lock:
                re._pending[g].append((rid, bytes([0]) + r.encode(), r))
                re._dirty.add(g)
        for _ in range(30):
            re.run_round()
        for g in range(G):
            assert _answer(rq[10_000 + g])[2] == f"a{g}"
            assert re.store(g).get("/after", False, False).node.value \
                == f"a{g}"
    finally:
        re.stop()


def _conf(eng, g, op, slot, waiters):
    """Enqueue a membership change the way conf_change does, without
    blocking on its answer."""
    import json
    rid = eng.reqid.next()
    waiters[rid] = eng.wait.register(rid)
    payload = bytes([1]) + json.dumps(
        {"id": rid, "op": op, "slot": slot}).encode()
    with eng._lock:
        eng._pending[g].append((rid, payload, None))
        eng._dirty.add(g)
        eng._confs_outstanding += 1


def _drive_surgery(mod, data_dir):
    """Host surgery through the round loop: a follower partitioned until
    its entries fall off the leader's ring (snapshot install on heal),
    membership changes, tenant create/remove, and the mask watchdog."""
    Req = TRequest if mod is torch_engine else JRequest
    G2 = 6
    extra = {"device": "cpu"} if mod is torch_engine else {}
    eng = mod.MultiEngine(mod.EngineConfig(
        groups=G2, peers=5, data_dir=data_dir, window=16, max_ents=4,
        heartbeat_tick=3, fsync=False, stagger=True, sync_interval=0.0,
        pipeline_applies=False, initial_peers=3, initial_tenants=4,
        mask_check_rounds=8, checkpoint_rounds=1 << 30, **extra))
    eng.reqid = _Seq()
    rng = random.Random(3)
    waiters, admin, victim = {}, [], None
    for r in range(90):
        for g in range(4):
            for _ in range(rng.randrange(0, 4 if g == 0 else 2)):
                rid = eng.reqid.next()
                waiters[rid] = eng.wait.register(rid)
                rq = Req(method="PUT", path=f"/s{rng.randrange(3)}",
                         val=f"{r}", id=rid)
                with eng._lock:
                    eng._pending[g].append((rid, bytes([0]) + rq.encode(),
                                            rq))
                    eng._dirty.add(g)
        if r == 6:
            lead = np.where(eng.h_mask, eng.h_state, 0) == 2
            victim = (int(lead[0].argmax()) + 1) % 3
            m_to = np.ones((G2, 5, 1, 1), np.int32)
            m_from = np.ones((G2, 1, 5, 1), np.int32)
            m_to[0, victim] = 0
            m_from[0, 0, victim] = 0
            mask = m_to * m_from
            eng.drop_mask = mask if mod is torch_engine else jnp.asarray(mask)
        elif r == 60:
            eng.drop_mask = None
        elif r == 14:
            _conf(eng, 1, "add", 3, waiters)
        elif r == 30:
            _conf(eng, 2, "remove", 0, waiters)
        elif r in (20, 50):
            op = ({"op": "create", "g": None, "n": 3} if r == 20
                  else {"op": "remove", "g": 3})
            item = (op, threading.Event(), {})
            admin.append(item)
            with eng._lock:
                eng._admin_q.append(item)
        eng.run_round()
    return eng, waiters, admin, victim


def test_host_surgery_matches_jax_engine(tmp_path):
    je, jw, ja, jv = _drive_surgery(jax_engine, str(tmp_path / "jax"))
    te, tw, ta, tv = _drive_surgery(torch_engine, str(tmp_path / "torch"))
    try:
        _assert_same_engines(je, te)
        assert jv == tv
        for rid in jw:
            a, b = jw[rid], tw[rid]
            assert _answer_any(a) == _answer_any(b), rid
        assert [(o.get("g"), type(o.get("err")).__name__) for _, _, o in ja] \
            == [(o.get("g"), type(o.get("err")).__name__) for _, _, o in ta]
        assert [o.get("g") for _, _, o in ta] == [4, 3]
        # The partitioned follower was snapshot-installed past the ring.
        assert te.h_commit[0, tv] > 16
        assert te.h_mask[1, 3] and not te.h_mask[2, 0]
        assert te.tenants() == [0, 1, 2, 4]
        assert te.mask_repairs == je.mask_repairs == 0
    finally:
        je.stop()
        te.stop()
    ra = _wal_records(str(tmp_path / "jax"))
    rb = _wal_records(str(tmp_path / "torch"))
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        for f in ARR_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(x, f)),
                                          np.asarray(getattr(y, f)),
                                          err_msg=f"{x.round_no}: {f}")
        assert x.entries == y.entries and x.confs == y.confs, x.round_no


def _answer_any(q):
    """Like _answer, also for conf-change answers (slot lists)."""
    try:
        res = _result(q)
    except queue.Empty:
        return None
    if isinstance(res, Exception):
        return ("error", getattr(res, "code", type(res).__name__))
    if isinstance(res, list):
        return ("slots", [int(s) for s in res])
    return (res.action, res.node.key, res.node.value, res.node.modified_index)


def test_profile_hook_writes_a_trace(tmp_path):
    eng = _engine(torch_engine, str(tmp_path / "p"))
    try:
        for _ in range(3):
            eng.run_round()
        out = eng.profile(rounds=2)
        traces = [f for f in os.listdir(out) if f.endswith(".json")]
        assert len(traces) == 1
        with open(os.path.join(out, traces[0])) as f:
            assert "traceEvents" in f.read(4096)
        assert eng.round_ms_ewma > 0
    finally:
        eng.stop()
