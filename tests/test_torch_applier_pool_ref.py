"""tests/test_applier_pool.py's cases on the port's MultiEngine, on the
CPU (`on_the_port(..., cpu=True)`): four applier shards against one on
the same seeded workload, the queue cap of the deepest shard, and the
lazy ack path of the C store. test_worker_crash_surfaces_engine_error is
mirrored in tests/test_torch_engine_crash.py.

test_ack_path_is_lazy_for_native_store is mirrored by hand: the JAX test
skips unless the JAX package's C store is built (its `importorskip`
names `etcd_tpu.native.storecore`, a string the import rename does not
reach), and it drives its client through tests/test_engine.py's helpers,
which build the JAX package's Request. The mirror asks for the port's C
store and uses the port's Request; its assertions are the JAX test's."""
import pytest

from etcd_tpu_torch.store import native_store
from port_tests import on_the_port

_ap = on_the_port("test_applier_pool", cpu=True)
_eng = on_the_port("test_engine", cpu=True)
make_engine, inject, Request, LazyWriteEvent = (
    _ap.make_engine, _ap.inject, _ap.Request, _ap.LazyWriteEvent)

test_differential_k1_vs_k4 = _ap.test_differential_k1_vs_k4
test_backpressure_bounds_deepest_shard = \
    _ap.test_backpressure_bounds_deepest_shard


def test_ack_path_is_lazy_for_native_store(tmp_path):
    """Mirror: the apply-time ack path materializes no Event for plain
    PUTs on the C store; a waiter gets a LazyWriteEvent that resolves
    on the consuming thread, and do() resolves it for clients."""
    from etcd_tpu_torch.native import storecore  # noqa: F401 — required

    eng = make_engine(tmp_path / "lazy", shards=2)
    try:
        for _ in range(400):
            eng.run_round()
            if eng.wait_leaders(0.0):
                break
        assert eng.wait_leaders(5.0)

        captured = []

        class Cap:   # waiter: records exactly what the applier delivers
            def put(self, v):
                captured.append(v)

        def boom(*a, **kw):
            raise AssertionError("Event materialized on the apply path")

        rid = eng.reqid.next()
        eng.wait._waiters[rid] = Cap()
        real_event, real_extern = native_store.Event, native_store._extern
        native_store.Event = native_store._extern = boom
        try:
            inject(eng, 1, Request(method="PUT", path="/w", val="quiet"))
            inject(eng, 1, Request(method="PUT", path="/w", val="loud",
                                   id=rid))
            for _ in range(200):
                eng.run_round()
                if captured:
                    break
            eng._drain_applies()
        finally:
            native_store.Event, native_store._extern = (real_event,
                                                        real_extern)
        assert captured, "waiter never triggered"
        lw = captured[0]
        assert isinstance(lw, LazyWriteEvent), type(lw)
        e = lw.resolve()
        assert e.action == "set"
        assert e.node.key == "/w" and e.node.value == "loud"
        assert e.prev_node.value == "quiet"
        t, out = _eng.put_async(eng, 2, "/z", "zz")
        res = _eng.settle(eng, t, out)
        assert res.node.key == "/z" and res.node.value == "zz"
    finally:
        eng.stop()
