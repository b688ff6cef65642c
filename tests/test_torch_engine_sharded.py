"""The port's MultiEngine over a device mesh: the multi-device serving path,
mirroring tests/test_engine_sharded.py.

The engine round (proposals -> sharded step -> readback -> WAL -> apply
-> ack) runs with the state sharded over a ("groups", "peers") mesh of
eight CPU cells (etcd_tpu_torch.parallel.mesh: one block per cell, one
thread per cell, routing between the cells of a groups row by
all-to-all). Layouts: groups8 (8 x 1) and g4xp2 (4 x 2).

Then a differential against the JAX package's mesh engine: the same
requests, the same WAL records, stores and acks, and data dirs that
restart in the other package's mesh engine, both ways."""
import threading

import pytest

from etcd_tpu_torch.parallel.mesh import Sharded, make_mesh, state_sharding
from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
from etcd_tpu_torch.server.request import Request


def make_cfg(tmp, mesh, **kw):
    kw.setdefault("groups", 8)
    kw.setdefault("peers", 4)
    kw.setdefault("window", 16)
    kw.setdefault("max_ents", 4)
    kw.setdefault("heartbeat_tick", 3)
    kw.setdefault("request_timeout", 30.0)
    kw.setdefault("fsync", False)
    return EngineConfig(data_dir=str(tmp), mesh=mesh, device="cpu", **kw)


@pytest.fixture(scope="module", params=[1, 2], ids=["groups8", "g4xp2"])
def mesh(request):
    return make_mesh(["cpu"] * 8, peers_axis=request.param)


def run_until(eng, pred, max_rounds=400, msg="condition"):
    for _ in range(max_rounds):
        if pred():
            return
        eng.run_round()
    raise AssertionError(f"{msg} not reached in {max_rounds} rounds")


def put_async(eng, g, key, val):
    """A blocking do() on a side thread, so the test thread drives
    rounds."""
    out = {}

    def work():
        try:
            out["res"] = eng.do(g, Request(method="PUT", path=key, val=val))
        except Exception as e:  # pragma: no cover - surfaced by settle
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


def _assert_in_layout(eng, mesh):
    sh = state_sharding(mesh)
    ng, npr = mesh.shape
    for name in ("term", "log_term", "next", "peer_mask", "state", "prng"):
        x = getattr(eng.st, name)
        assert isinstance(x, Sharded), name
        assert x.mesh is mesh and x.spec == getattr(sh, name), name
        assert len(x.blocks) == ng and all(len(r) == npr for r in x.blocks)
        blk = x.blocks[0][0]
        assert blk.shape[:2] == (eng.cfg.groups // ng,
                                 eng.cfg.peers // npr), name


def test_sharded_engine_serves_and_keeps_shardings(tmp_path, mesh):
    eng = MultiEngine(make_cfg(tmp_path / "s1", mesh))
    G = eng.cfg.groups
    run_until(eng, lambda: all(eng.leader_slot(g) >= 0 for g in range(G)),
              msg="leaders")

    # The state really lives on the mesh: one block per cell.
    assert eng.st.term.mesh.axis_names == ("groups", "peers")
    _assert_in_layout(eng, mesh)
    assert sum(len(r) for r in eng.st.term.blocks) == 8

    for g in range(G):
        t, out = put_async(eng, g, "/k", f"v{g}")
        assert settle(eng, t, out).action == "set"
    for g in range(G):
        assert eng.do(g, Request(method="GET", path="/k")).node.value == \
            f"v{g}"

    # After serving rounds the inbox is still in its layout.
    assert isinstance(eng.inbox, Sharded)
    ng, npr = mesh.shape
    assert eng.inbox.blocks[0][0].shape == (G // ng, 4 // npr, 4,
                                            eng.kcfg.fields)
    eng.stop()


def test_sharded_engine_restart_from_wal(tmp_path, mesh):
    d = tmp_path / "s2"
    eng = MultiEngine(make_cfg(d, mesh))
    G = eng.cfg.groups
    run_until(eng, lambda: all(eng.leader_slot(g) >= 0 for g in range(G)),
              msg="leaders")
    for g in range(G):
        t, out = put_async(eng, g, "/persist", f"g{g}")
        settle(eng, t, out)
    eng.stop()

    eng2 = MultiEngine(make_cfg(d, mesh))
    for g in range(G):
        assert eng2.do(g, Request(method="GET", path="/persist")).node.value \
            == f"g{g}"
    _assert_in_layout(eng2, mesh)
    run_until(eng2, lambda: all(eng2.leader_slot(g) >= 0 for g in range(G)),
              msg="re-election")
    t, out = put_async(eng2, 0, "/after", "restart")
    settle(eng2, t, out)
    eng2.stop()


def test_sharded_engine_conf_change_and_host_surgery_keep_sharding(tmp_path,
                                                                   mesh):
    """Membership surgery (host writebacks) must put every field back in
    its cells, in its layout."""
    eng = MultiEngine(make_cfg(tmp_path / "s3", mesh, initial_peers=3))
    run_until(eng, lambda: eng.leader_slot(0) >= 0, msg="leader")

    res = {}

    def conf():
        try:
            res["slots"] = eng.conf_change(0, "add", 3, timeout=30.0)
        except Exception as e:  # pragma: no cover
            res["err"] = e

    th = threading.Thread(target=conf, daemon=True)
    th.start()
    for _ in range(400):
        if not th.is_alive():
            break
        eng.run_round()
        th.join(timeout=0.001)
    th.join(1.0)
    assert "err" not in res, res.get("err")
    assert 3 in res["slots"]
    _assert_in_layout(eng, mesh)

    # Still serves after surgery.
    t, out = put_async(eng, 0, "/post-conf", "ok")
    settle(eng, t, out)
    assert eng.do(0, Request(method="GET", path="/post-conf")).node.value \
        == "ok"
    eng.stop()


# ---------------------------------------------------------------------------
# Differential: the port's mesh engine against the JAX package's mesh
# engine (8 virtual CPU devices), driven by tests/test_torch_engine.py's
# schedule (PUTs, CASes, deletes, parked quorum reads, a partition): the
# same WAL records field by field, mirrors, stores and answers; and data
# dirs carried across the two, both ways. Layouts: groups8 (8 x 1) and
# 1x3 (1 x 3, the peers axis only).
# ---------------------------------------------------------------------------

DIFF_LAYOUTS = {"groups8": (8, 1), "1x3": (3, 3)}    # (devices, peers_axis)


def _meshes(layout):
    import jax
    from etcd_tpu.parallel.mesh import make_mesh as jax_make_mesh
    n, pa = DIFF_LAYOUTS[layout]
    return (jax_make_mesh(jax.devices()[:n], peers_axis=pa),
            make_mesh(["cpu"] * n, peers_axis=pa))


@pytest.mark.parametrize("layout", list(DIFF_LAYOUTS))
def test_mesh_engine_matches_jax_mesh_engine(tmp_path, layout):
    import numpy as np
    from etcd_tpu.server import engine as jax_engine
    from etcd_tpu_torch.server import engine as torch_engine
    from tests import test_torch_engine as te

    jm, tm = _meshes(layout)
    je, jw = te._drive(jax_engine, str(tmp_path / "jax"), mesh=jm)
    ce, cw = te._drive(torch_engine, str(tmp_path / "torch"), mesh=tm)
    try:
        assert isinstance(ce.st.term, Sharded)
        te._assert_same_engines(je, ce)
        assert sorted(jw) == sorted(cw)
        answers = {rid: (te._answer(jw[rid]), te._answer(cw[rid]))
                   for rid in jw}
        for rid, (a, b) in answers.items():
            assert a == b, (rid, a, b)
        kinds = {a[0] for a, _ in answers.values() if a is not None}
        assert {"set", "compareAndSwap", "delete", "get",
                "error"} <= kinds, kinds
        assert ce.acked_requests > 50
    finally:
        je.stop()
        ce.stop()
    ra = te._wal_records(str(tmp_path / "jax"))
    rb = te._wal_records(str(tmp_path / "torch"))
    assert len(ra) == len(rb) > 0
    for x, y in zip(ra, rb):
        assert x.round_no == y.round_no
        for f in te.ARR_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(x, f)),
                                          np.asarray(getattr(y, f)),
                                          err_msg=f"{x.round_no}: {f}")
        assert x.entries == y.entries, x.round_no
        assert x.confs == y.confs, x.round_no
    with open(tmp_path / "jax" / "geometry.json") as f1, \
            open(tmp_path / "torch" / "geometry.json") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("writer", ["jax", "torch"],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_mesh_data_dir_restarts_in_the_other_mesh_engine(tmp_path, writer):
    """A checkpoint plus WAL written by one package's mesh engine restores
    in the other's: the same mirrors, stores and round, and it serves."""
    import shutil

    import numpy as np
    from etcd_tpu.server import engine as jax_engine
    from etcd_tpu.server.request import Request as JRequest
    from etcd_tpu_torch.server import engine as torch_engine
    from tests import test_torch_engine as te

    jm, tm = _meshes("groups8")
    mods = {"jax": (jax_engine, jm, JRequest),
            "torch": (torch_engine, tm, Request)}
    w_mod, w_mesh, _ = mods[writer]
    r_mod, r_mesh, Req = mods["torch" if writer == "jax" else "jax"]
    d = str(tmp_path / "data")
    eng, waiters = te._drive(w_mod, d, rounds=40, checkpoint_rounds=16,
                             mesh=w_mesh)
    acked = [a for a in map(te._answer, waiters.values())
             if a is not None and a[0] in ("set", "compareAndSwap")]
    assert len(acked) > 20
    want = {g: te._values(s) for g, s in eng._stores.items()}
    eng.stop()
    # The reference: the same data dir restored by the writer's package.
    shutil.copytree(d, str(tmp_path / "copy"))
    ref = te._engine(w_mod, str(tmp_path / "copy"), checkpoint_rounds=16,
                     mesh=w_mesh)
    ref_mirrors = {n: getattr(ref, n).copy() for n in te.MIRRORS}
    ref_stores = {g: s.save() for g, s in ref._stores.items()}
    ref_round = ref.round_no
    ref.stop()

    re = te._engine(r_mod, d, checkpoint_rounds=16, mesh=r_mesh)
    try:
        for n, v in ref_mirrors.items():
            np.testing.assert_array_equal(getattr(re, n), v, err_msg=n)
        assert re.round_no == ref_round
        assert {g: s.save() for g, s in re._stores.items()} == ref_stores
        assert {g: te._values(s) for g, s in re._stores.items()} == want
        rq = {}
        for g in range(te.G):
            rid = 10_000 + g
            rq[rid] = re.wait.register(rid)
            r = Req(method="PUT", path="/after", val=f"a{g}", id=rid)
            with re._lock:
                re._pending[g].append((rid, bytes([0]) + r.encode(), r))
                re._dirty.add(g)
        for _ in range(30):
            re.run_round()
        for g in range(te.G):
            assert te._answer(rq[10_000 + g])[2] == f"a{g}"
    finally:
        re.stop()
