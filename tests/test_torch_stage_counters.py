"""The port's per-write stage counters, the round's seconds blocked on the
device and its host ranges (etcd_tpu_torch.server.engine on the CPU):

- `phase_s["ack.*"]`: each acked write's path from submit to ack, split
  at staging, admission, the end of its apply pass and its ack;
- `phase_s["dispatch.wait"]`: the round thread's blocking reads;
- `engine.*` profiler ranges around host-only phases;

and the benchmark's readers of them (`benchmark/metrics/`)."""
import importlib.util
import os
import tempfile
import threading
import time

import numpy as np
import pytest

from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
from etcd_tpu_torch.server.request import Request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = 8
STAGES = ("queue", "round", "apply", "gate")


def _engine(data_dir, **kw):
    return MultiEngine(EngineConfig(**{
        "groups": G, "peers": 3, "data_dir": data_dir, "window": 8,
        "max_ents": 2, "device": "cpu", "checkpoint_rounds": 1 << 30,
        "applier_shards": 2, "wal_shards": 2, **kw}))


def _writes(eng, n, gap=0.002):
    """n PUTs from one client, one `submit_many` each; returns the
    results as `collect_many` gives them."""
    toks = []
    for i in range(n):
        g = i % G
        toks.append((g, eng.submit_many(g, [Request(
            method="PUT", path=f"/k{i % 4}", val=f"v{i}")])))
        time.sleep(gap)
    return [eng.collect_many(g, t, 20.0)[0] for g, t in toks]


def _sum(ph, stage):
    return sum(v for k, v in ph.items()
               if k == f"ack.{stage}" or k.startswith(f"ack.{stage}["))


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["two_applier_shards", "synchronous"])
def test_stage_sums_add_up_to_each_writes_latency(pipelined):
    """The four stages of every acked write add up to its t_acked -
    t_submit, each write is counted once, the stamps come in stage
    order, each path writes its own keys, and the blocking reads are a
    part of dispatch + readback."""
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, pipeline_applies=pipelined)
        seen = []
        account = eng._ack_account

        def spy(sfx, rids, t_applied, t_acked):
            seen.append((sfx, [list(eng._ack_t[r]) for r in rids
                               if r in eng._ack_t], t_applied, t_acked))
            account(sfx, rids, t_applied, t_acked)
        eng._ack_account = spy
        eng.start()
        try:
            assert eng.wait_leaders(60)
            res = _writes(eng, 120)
        finally:
            eng.stop()
        ph = dict(eng.phase_s)
    acked = sum(getattr(r, "node", None) is not None for r in res)
    assert acked == 120
    assert _sum(ph, "writes") == acked
    recs = [(sfx, w, ta, tk) for sfx, ws, ta, tk in seen for w in ws]
    assert len(recs) == acked
    for _sfx, w, t_applied, t_acked in recs:
        assert w[0] <= w[1] <= w[2] <= t_applied <= t_acked
    total = sum(t_acked - w[0] for _s, w, _a, t_acked in recs)
    assert sum(_sum(ph, s) for s in STAGES) == pytest.approx(total,
                                                              rel=1e-9)
    keys = {k for k in ph if k.startswith("ack.")}
    if pipelined:
        assert {s for s, *_ in seen} <= {"[0]", "[1]"}
        assert keys <= {f"ack.{s}[{k}]" for s in STAGES + ("writes",)
                        for k in (0, 1)}
    else:
        assert {s for s, *_ in seen} == {""}
        assert keys == {f"ack.{s}" for s in STAGES + ("writes",)}
        assert ph["ack.gate"] == 0.0
    assert 0.0 < ph["dispatch.wait"] <= ph["dispatch"] + ph["readback"]


def test_tracer_spans_agree_with_the_counters(monkeypatch):
    """Every write sampled: the Tracer's mean stage times match the
    counters' within the spacing of the once-a-round stamps."""
    monkeypatch.setenv("ETCD_TPU_TRACE_EVERY", "1")
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d)
        eng.start()
        try:
            assert eng.wait_leaders(60)
            rounds0 = eng.round_no
            t0 = time.perf_counter()
            _writes(eng, 100)
            time.sleep(0.1)
            per_round = (time.perf_counter() - t0) / (eng.round_no - rounds0)
        finally:
            eng.stop()
        ph = dict(eng.phase_s)
        spans = [s["stages"] for s in eng.obs.tracer.spans()
                 if {"submit", "admitted", "applied", "acked"}
                 <= set(s["stages"])]
    n = _sum(ph, "writes")
    assert len(spans) == n == 100
    pairs = [("submit", "admitted", _sum(ph, "queue") + _sum(ph, "round")),
             ("admitted", "applied", _sum(ph, "apply")),
             ("applied", "acked", _sum(ph, "gate"))]
    for a, b, counted in pairs:
        traced = np.mean([s[b] - s[a] for s in spans])
        assert abs(traced - counted / n) <= per_round, (a, b)


def test_no_stamps_outlive_their_writes():
    """Writes that time out in `collect_many` or `do`, and writes never
    collected when the engine stops, leave nothing behind."""
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d)            # no round runs: no write commits
        toks = eng.submit_many(0, [Request(method="PUT", path="/a",
                                           val=str(i)) for i in range(5)])
        assert len(eng._ack_t) == 5
        out = eng.collect_many(0, toks, 0.05)
        assert all("timed out" in str(r) for r in out)
        with pytest.raises(Exception, match="timed out"):
            eng.do(1, Request(method="PUT", path="/b", val="x"), 0.05)
        assert eng._ack_t == {}
        eng.submit_many(2, [Request(method="PUT", path="/c", val="y")])
        assert len(eng._ack_t) == 1
        eng.stop()
        assert eng._ack_t == {}


def test_off_leaves_no_new_keys(monkeypatch):
    monkeypatch.setenv("ETCD_TPU_OBS", "off")
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d)
        eng.start()
        try:
            assert eng.wait_leaders(60)
            res = _writes(eng, 20, gap=0.0)
        finally:
            eng.stop()
    assert all(getattr(r, "node", None) is not None for r in res)
    assert eng._ack_t is None
    assert eng.phase_s["dispatch"] > 0
    assert not [k for k in eng.phase_s
                if k.startswith("ack.") or k == "dispatch.wait"]


def test_profiler_ranges_name_host_phases_and_enclose_no_op():
    """A profiler of every thread, started on this thread while the round
    thread runs (as the benchmark's traced window does), records the
    round thread's and an applier's ranges, and no torch operation runs
    inside a range of the round thread."""
    from torch.profiler import ProfilerActivity, profile
    from torch._C._profiler import _ExperimentalConfig
    with tempfile.TemporaryDirectory() as d:
        eng = _engine(d, round_interval=0.05)
        eng.start()
        stop = threading.Event()
        client = threading.Thread(target=lambda: [
            _writes(eng, 10) for _ in iter(stop.is_set, True)], daemon=True)
        try:
            assert eng.wait_leaders(60)
            client.start()
            time.sleep(0.2)
            prof = profile(activities=[ProfilerActivity.CPU],
                           experimental_config=_ExperimentalConfig(
                               profile_all_threads=True))
            prof.start()
            time.sleep(0.5)
            prof.stop()
        finally:
            stop.set()
            client.join(30)
            eng.stop()
        assert not client.is_alive()
    events = [(e.name, e.thread, e.time_range.start, e.time_range.end)
              for e in prof.events()]
    names = {n for n, *_ in events}
    assert {"engine.stage", "engine.record", "engine.apply[0]"} <= names
    round_thread = {t for n, t, _s, _e in events if n == "engine.stage"}
    assert len(round_thread) == 1
    ranges = [(s, e) for n, t, s, e in events
              if n.startswith("engine.") and t in round_thread]
    ops = [(n, s) for n, t, s, _e in events
           if n.startswith("aten::") and t in round_thread]
    assert ops, "the round's torch operations were not recorded"
    inside = [n for n, s in ops if any(a <= s <= b for a, b in ranges)]
    assert inside == []


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "stage_counter_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


PHASES = {"dispatch": 0.5, "readback": 0.02, "dispatch.wait": 0.3,
          "apply[0]": 0.1, "apply[1]": 0.1,
          "ack.queue[0]": 0.8, "ack.queue[1]": 1.2, "ack.queue": 0.5,
          "ack.round[0]": 1.5, "ack.round[1]": 1.5, "ack.round": 1.0,
          "ack.apply[0]": 0.2, "ack.apply[1]": 0.3, "ack.apply": 0.25,
          "ack.gate[0]": 0.05, "ack.gate[1]": 0.1, "ack.gate": 0.0,
          "ack.writes[0]": 20.0, "ack.writes[1]": 20.0, "ack.writes": 10.0}
EXPECT = {"ack_queue_ms": 50.0, "ack_round_ms": 80.0, "ack_apply_ms": 15.0,
          "ack_gate_ms": 3.0, "dispatch_wait_ms": 30.0}


@pytest.mark.parametrize("name", sorted(EXPECT) + sorted(
    f"{n}.rate" for n in EXPECT))
def test_reader(name):
    read = _reader(name)
    want = EXPECT[name.removesuffix(".rate")]
    assert read({"phase_s": dict(PHASES), "rounds": 10}) == \
        pytest.approx(want)
    # A program without these counters writes none of the keys; an idle window
    # counts no write and no round.
    old = {k: v for k, v in PHASES.items()
           if not k.startswith("ack.") and k != "dispatch.wait"}
    assert read({"phase_s": old, "rounds": 10}) is None
    assert read({"phase_s": dict(PHASES, **{
        k: 0.0 for k in PHASES if k.startswith("ack.")}), "rounds": 0}) \
        is None
