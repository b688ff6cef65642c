"""The port's C-core NativeStore (etcd_tpu_torch/native/storecore.c,
built at first use) against the port's Python Store and the JAX
package's Python Store (etcd_tpu.store.store.Store): the eight tests of
tests/test_native_store.py, the seeded random schedule over 8 seeds.

Every result event, every raised error (code, cause, index; the port's
stores raise etcd_tpu_torch.errors.EtcdError, never the JAX package's
class), the stats, the save() bytes, the expiry and watch streams,
recovery round trips and the history ring's wrap-around must agree.
Tolerance: exact."""
import itertools
import json
import random
import threading

import pytest

from etcd_tpu import errors as jerrors
from etcd_tpu.store.store import Store as JStore
from etcd_tpu.store.store import normalize as jnormalize
from etcd_tpu_torch import errors
from etcd_tpu_torch.store import HAVE_NATIVE_STORE, native_store
from etcd_tpu_torch.store.store import Store

NativeStore = native_store.NativeStore


def test_the_c_store_is_loaded():
    assert HAVE_NATIVE_STORE
    core = NativeStore()._core
    assert type(core).__module__ == "etcd_tpu_torch.native.storecore"
    with pytest.raises(errors.EtcdError) as ei:
        NativeStore().get("/missing")
    assert type(ei.value) is errors.EtcdError
    assert not isinstance(ei.value, jerrors.EtcdError)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def ev_sig(e):
    def nd(x):
        if x is None:
            return None
        return (x.key, x.value, x.dir, x.created_index, x.modified_index,
                x.expiration, x.ttl,
                None if x.nodes is None else tuple(nd(c) for c in x.nodes))
    return (e.action, nd(e.node), nd(e.prev_node), e.etcd_index)


def run_op(st, op):
    kind = op[0]
    if kind == "set":
        return st.set(op[1], is_dir=op[2], value=op[3], expire_time=op[4])
    if kind == "create":
        return st.create(op[1], is_dir=op[2], value=op[3], unique=op[4],
                         expire_time=op[5])
    if kind == "update":
        return st.update(op[1], value=op[2], expire_time=op[3],
                         refresh=op[4])
    if kind == "cas":
        return st.compare_and_swap(op[1], op[2], op[3], op[4])
    if kind == "cad":
        return st.compare_and_delete(op[1], op[2], op[3])
    if kind == "delete":
        return st.delete(op[1], is_dir=op[2], recursive=op[3])
    if kind == "get":
        return st.get(op[1], recursive=op[2], want_sorted=op[3])
    if kind == "expire":
        return st.delete_expired_keys(op[1])
    raise AssertionError(kind)


def gen_op(rng, clock):
    segs = ["a", "b", "_hid", "x", "longer-seg"]

    def path():
        return "/" + "/".join(rng.choice(segs)
                              for _ in range(rng.randint(1, 3)))
    k = rng.random()
    exp = clock.t + rng.choice([0.5, 2.0, 10.0]) if rng.random() < 0.3 \
        else None
    if k < 0.30:
        return ("set", path(), rng.random() < 0.15,
                rng.choice(["", "v", "w" * 40]), exp)
    if k < 0.45:
        return ("create", path(), rng.random() < 0.2, "cv",
                rng.random() < 0.2, exp)
    if k < 0.55:
        return ("update", path(), rng.choice([None, "", "u2"]), exp,
                rng.random() < 0.2)
    if k < 0.65:
        return ("cas", path(), rng.choice(["", "v", "nope"]),
                rng.choice([0, 1, 3]), "casv")
    if k < 0.72:
        return ("cad", path(), rng.choice(["", "v", "nope"]),
                rng.choice([0, 1, 3]))
    if k < 0.85:
        return ("delete", path(), rng.random() < 0.5, rng.random() < 0.5)
    if k < 0.95:
        return ("get", path(), rng.random() < 0.5, rng.random() < 0.5)
    return ("expire", clock.t + rng.choice([0.0, 1.0, 5.0]))


def _outcome(st, op, err_cls):
    """(events or None, (code, cause, index) or None); an error must be
    of the store's own package's class."""
    try:
        r = run_op(st, op)
    except Exception as e:  # noqa: BLE001 — class checked below
        assert type(e) is err_cls, (type(e), op)
        return None, (e.code, e.cause, e.index)
    return ([ev_sig(x) for x in r] if op[0] == "expire" else ev_sig(r)), None


def _three_stores(clock, **kw):
    return (NativeStore(clock=clock, **kw), Store(clock=clock, **kw),
            JStore(clock=clock, **kw))


ERR_CLASSES = (errors.EtcdError, errors.EtcdError, jerrors.EtcdError)


@pytest.mark.parametrize("seed", range(8))
def test_differential_random_schedule(seed):
    rng = random.Random(seed)
    clock = Clock()
    stores = _three_stores(clock, namespaces=("/0",))
    for i in range(400):
        if rng.random() < 0.05:
            clock.t += rng.choice([0.25, 1.0, 3.0])
        op = gen_op(rng, clock)
        outs = [_outcome(st, op, cls) for st, cls in zip(stores,
                                                          ERR_CLASSES)]
        assert outs[0] == outs[1] == outs[2], f"op {i} {op}: {outs}"
        assert len({st.current_index for st in stores}) == 1
    na, py, jx = stores
    assert na.save() == py.save() == jx.save()
    assert na.json_stats() == py.json_stats() == jx.json_stats()


def test_differential_recovery_roundtrip():
    rng = random.Random(99)
    clock = Clock()
    stores = _three_stores(clock, namespaces=("/0",))
    for _ in range(150):
        op = gen_op(rng, clock)
        for st, cls in zip(stores, ERR_CLASSES):
            _outcome(st, op, cls)
    na, py, jx = stores
    blob = jx.save()
    assert na.save() == py.save() == blob
    na2 = NativeStore(clock=clock, namespaces=("/0",))
    na2.recovery(blob)          # the C core loads the JAX store's snapshot
    assert na2.save() == blob
    py2 = Store(clock=clock, namespaces=("/0",))
    py2.recovery(na.save())     # the Python store loads the C one's
    assert py2.save() == blob
    jx2 = JStore(clock=clock, namespaces=("/0",))
    jx2.recovery(na.save())
    assert jx2.save() == blob
    c = na.clone()
    before = na.save()
    c.set("/mut", value="x")
    assert na.save() == before
    assert json.loads(c.save())["currentIndex"] == na.current_index + 1


def test_watch_vs_lazy_apply_race():
    """A watcher registering while set_applied runs on another thread
    never loses its event (tests/test_native_store.py's race)."""
    st = NativeStore()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            st.set_applied("/race/k", "v", None, False)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        misses = 0
        for _ in range(300):
            since = st.current_index + 1
            w = st.watch("/race/k", since_index=since)
            e = w.next_event(timeout=2.0)
            if e is None:
                misses += 1
            else:
                assert e.index >= since
            w.remove()
        assert misses == 0, f"{misses}/300 watchers lost their event"
    finally:
        stop.set()
        t.join(timeout=5)


def test_watch_parity_through_native():
    streams = []
    for cls in (NativeStore, Store, JStore):
        clock = Clock()
        st = cls(clock=clock)
        w = st.watch("/w", recursive=True, stream=True)
        st.set("/w/a", value="1")
        st.delete("/w/a")
        st.set("/w/_h", value="hidden")
        st.set("/w/b", value="2", expire_time=clock.t + 1)
        st.delete_expired_keys(clock.t + 2)
        got = []
        while True:
            e = w.next_event(timeout=0.05)
            if e is None:
                break
            got.append(ev_sig(e))
        w2 = st.watch("/w/a", since_index=1)
        e = w2.next_event(timeout=0.05)
        assert e is not None
        streams.append((got, ev_sig(e)))
    assert streams[0] == streams[1] == streams[2]
    assert [(s[0], s[1][0]) for s in streams[0][0]] == [
        ("set", "/w/a"), ("delete", "/w/a"), ("set", "/w/b"),
        ("expire", "/w/b")]
    assert streams[0][1][0] == "set" and streams[0][1][1][0] == "/w/a"


def test_set_many_inline_canonical_predicate_matches_norm():
    """set_applied_many's inline canonical-path check passes a path only
    when _norm leaves it unchanged, and the port's _norm equals the JAX
    package's normalize on every string up to length 6 over '/a.'."""
    from etcd_tpu_torch.store.native_store import _norm

    def inline_ok(p):
        return (p and p[0] == "/" and p[-1] != "/" and "//" not in p
                and "." not in p)

    for n in range(0, 7):
        for tup in itertools.product("/a.", repeat=n):
            p = "".join(tup)
            if inline_ok(p):
                assert _norm(p) == p, p
            if p:
                assert _norm(p) == jnormalize(p), p


def test_set_applied_many_need_returns_descriptors():
    """set_applied_many(need=...) descriptors, and the same writes on
    both Python stores leave the same tree."""
    st = NativeStore(clock=Clock(), namespaces=("/0", "/1"))
    st.set_applied_many(["/1/pre"], ["old"])
    applied, descs = st.set_applied_many(
        ["/1/a", "/", "/1/pre", "/1/b"],
        ["1", "x", "new", "2"], need=[0, 1, 2])
    assert applied == 3
    assert len(descs) == 3
    pos, nd, pd, idx = descs[0]
    assert (pos, pd) == (0, None) and nd[0] == "/1/a" and nd[1] == "1"
    assert idx == 2 and nd[4] == 2
    pos, nd, fail, idx = descs[1]
    assert pos == 1 and nd is None
    assert fail == (errors.ECODE_ROOT_RONLY, "/")
    pos, nd, pd, idx = descs[2]
    assert pos == 2 and nd[1] == "new" and pd[1] == "old"
    assert st.set_applied_many(["/1/c"], ["3"]) == 1
    for cls in (Store, JStore):
        other = cls(clock=Clock(), namespaces=("/0", "/1"))
        for p, v in (("/1/pre", "old"), ("/1/a", "1"), ("/", "x"),
                     ("/1/pre", "new"), ("/1/b", "2"), ("/1/c", "3")):
            try:
                other.set(p, value=v)
            except Exception as e:  # noqa: BLE001 — the root PUT
                assert e.code == errors.ECODE_ROOT_RONLY
        assert other.save() == st.save()


def test_set_applied_lazy_defers_event_materialization(monkeypatch):
    from etcd_tpu_torch.store import event as ev_mod
    from etcd_tpu_torch.store.event import LazyWriteEvent

    st = NativeStore(clock=Clock(), namespaces=("/0", "/1"))
    st.set_applied_lazy("/1/k", "v0", None)

    def boom(*a, **kw):
        raise AssertionError("Event materialized on the apply hot path")

    monkeypatch.setattr(native_store, "Event", boom)
    monkeypatch.setattr(native_store, "_extern", boom)
    r = st.set_applied_lazy("/1/k", "v1", None)
    monkeypatch.undo()

    assert isinstance(r, LazyWriteEvent)
    e = r.resolve()
    assert e.action == ev_mod.SET
    assert e.node.key == "/1/k" and e.node.value == "v1"
    assert e.prev_node.value == "v0"
    assert e.etcd_index == 2 and e.node.modified_index == 2
    replay = st.watcher_hub.event_history.scan("/1/k", False, 2)
    assert replay is not None and replay.node.value == "v1"
    # The resolved event is the one the Python stores return for the
    # same write.
    for cls in (Store, JStore):
        other = cls(clock=Clock(), namespaces=("/0", "/1"))
        other.set("/1/k", value="v0")
        assert ev_sig(other.set("/1/k", value="v1")) == ev_sig(e)

    w = st.watch("/1", recursive=True, stream=True)
    r2 = st.set_applied_lazy("/1/k", "v2", None)
    assert not isinstance(r2, LazyWriteEvent)
    got = w.next_event(timeout=1.0)
    assert got is not None and got.node.value == "v2"


def test_history_wraparound_since_before_window_differential():
    cap = 8
    stores = (NativeStore(cap, Clock()), Store(cap, Clock()),
              JStore(cap, Clock()))
    n = cap * 3
    for st in stores:
        for i in range(n):
            st.set(f"/w/k{i % 4}", value=str(i))
    for st, cls in zip(stores, ERR_CLASSES):
        h = st.watcher_hub.event_history
        assert h.last_index == n
        assert h.start_index == n - cap + 1
        with pytest.raises(cls) as ei:
            h.scan("/w/k0", False, h.start_index - 1)
        assert type(ei.value) is cls
        assert ei.value.code == errors.ECODE_EVENT_INDEX_CLEARED
        assert ei.value.index == h.last_index
        with pytest.raises(cls) as ei:
            st.watch("/w/k0", since_index=h.start_index - 1)
        assert ei.value.code == errors.ECODE_EVENT_INDEX_CLEARED
    hs = [st.watcher_hub.event_history for st in stores]
    for key, recursive in (("/w/k1", False), ("/w", True)):
        for since in range(hs[0].start_index, hs[0].last_index + 2):
            got = [h.scan(key, recursive, since) for h in hs]
            sigs = [None if e is None else ev_sig(e) for e in got]
            assert sigs[0] == sigs[1] == sigs[2], (key, since)
