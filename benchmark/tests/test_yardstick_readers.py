"""Each metric's reader on observations made by hand: the number it
should give, and nothing where there is nothing to read."""
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import manifest, reference
from benchmark.peaks import HBM_BYTES_PER_S

ROOT = Path(__file__).resolve().parents[2]
MAN = manifest.Manifest(ROOT)
CFG = json.loads((ROOT / "benchmark" / "configs" / "mt100k-r5.json")
                 .read_text())


def obs(profile=None, rounds=10):
    return {"config": CFG, "window_s": 2.0, "setup_s": 17.5,
            "latencies_ms": np.arange(1, 101, dtype=float),
            "acked_in_window": 4800, "rounds": rounds,
            "phase_s": {"stage": 0.1, "record": 0.05, "wal_submit": 0.01,
                        "dispatch": 0.4, "readback": 0.02,
                        "apply[0]": 0.3, "apply[1]": 0.2},
            "launches": {"generic": 0, "te4": 20, "te5": 40},
            "fsync_ms": list(np.linspace(1, 10, 100)), "profile": profile}


def profile():
    rows = CFG["groups"] * CFG["peers"]
    b5 = 4 * (2 * rows * 5 + rows)
    # Two TE=5 launches, each at exactly half its bound's speed.
    dur_us = b5 / HBM_BYTES_PER_S * 2 * 1e6
    return {"busy_s": 0.5, "window_s": 2.0, "device_ops": [
        ("void ring_resolve_tiles<5>(int const*, ...)", 0.0, dur_us),
        ("void ring_resolve_tiles<5>(int const*, ...)", 9.0, dur_us),
        ("elementwise_kernel", 20.0, 5.0)]}


def read(name, o):
    return MAN.reader(name)(o)


def test_end_to_end():
    o = obs()
    assert read("ack_p50_ms", o) == pytest.approx(50.5)
    assert read("ack_p95_ms", o) == pytest.approx(95.05)
    assert read("acked_writes_per_s", o) == 2400.0
    assert read("setup_s", o) == 17.5
    assert read("ack_p50_ms", dict(o, latencies_ms=np.empty(0))) is None


def test_per_layer_from_phases_and_counters():
    o = obs()
    assert read("round_ms", o) == pytest.approx(200.0)
    assert read("dispatch_ms", o) == pytest.approx(42.0)
    assert read("stage_record_ms", o) == pytest.approx(16.0)
    assert read("apply_ms", o) == pytest.approx(50.0)
    assert read("ring_resolve_launches", o) == 6.0
    assert read("wal_fsync_p99_ms", o) == pytest.approx(
        float(np.percentile(np.linspace(1, 10, 100), 99)))
    for name in ("round_ms", "dispatch_ms", "ring_resolve_launches"):
        assert read(name, obs(rounds=0)) is None


def test_device_trace_readers():
    assert read("device_idle_share", obs(profile())) == pytest.approx(75.0)
    assert read("ring_resolve_roofline", obs(profile())) == \
        pytest.approx(50.0)
    for name in ("device_idle_share", "ring_resolve_roofline"):
        assert read(name, obs()) is None
    empty = dict(profile(), device_ops=[("elementwise_kernel", 0.0, 5.0)])
    assert read("ring_resolve_roofline", obs(empty)) is None


def test_generic_instantiation_takes_the_unspecialised_site():
    cfg7 = dict(CFG, peers=7)
    rows = cfg7["groups"] * 7
    b7 = 4 * (2 * rows * 7 + rows)
    dur_us = b7 / HBM_BYTES_PER_S * 4 * 1e6
    p = {"busy_s": 1.0, "window_s": 2.0, "device_ops": [
        ("void ring_resolve_tiles<0>(int const*, ...)", 0.0, dur_us)]}
    o = dict(obs(p), config=cfg7)
    assert read("ring_resolve_roofline", o) == pytest.approx(25.0)


def test_expected_index_and_last_writes():
    tenant = np.array([3, 1, 3, 3, 1, 7])
    key = np.array([0, 0, 1, 0, 0, 2])
    assert reference.expected_index(tenant).tolist() == [1, 1, 2, 3, 2, 1]
    w = reference.Writes(tenant, key, np.zeros(6, np.int64),
                         np.zeros(6), np.zeros(6, np.int64), [None] * 6,
                         [None] * 6, str, str)
    assert sorted(reference.last_writes(w).tolist()) == [2, 3, 4, 5]


RATE_TWINS = sorted(m.name for m in MAN.metrics if m.name.endswith(".rate"))


@pytest.mark.parametrize("name", RATE_TWINS)
def test_rate_twin_reads_as_its_base(name):
    """A `.rate` metric is its base metric read the same way, in the cells
    judged by `acked_writes_per_s`."""
    base = name[:-len(".rate")]
    for o in (obs(), obs(profile()), obs(rounds=0),
              dict(obs(), latencies_ms=np.empty(0))):
        assert read(name, o) == read(base, o)
