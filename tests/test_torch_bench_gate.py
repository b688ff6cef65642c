"""tests/test_bench_gate.py's cases against the port's regression gate
(`etcd_tpu_torch.bench._regression_gate`), and the port's own rule: a
line compares only with an artifact of the same platform AND card, so no
TPU or CPU artifact (the JAX package's carry no "device") and no other
card's artifact reads as comparable to a line measured on the card.

The JAX module loads the root `bench.py` by path in `_load_bench`, which
the import rename does not reach: it is pointed at the port's bench."""
import json
import os

import pytest

from etcd_tpu_torch import bench
from port_tests import on_the_port

_gate = on_the_port("test_bench_gate")
_gate._load_bench = lambda: bench

test_gate_flags_big_drop = _gate.test_gate_flags_big_drop
test_gate_geometry_change_not_a_regression = \
    _gate.test_gate_geometry_change_not_a_regression
test_gate_healthy_is_silent = _gate.test_gate_healthy_is_silent
test_gate_scenario_subset_not_compared = \
    _gate.test_gate_scenario_subset_not_compared
test_gate_flags_deep_queue_drop_and_fsync_rise = \
    _gate.test_gate_flags_deep_queue_drop_and_fsync_rise
test_gate_wal_columns_absent_in_old_artifact_silent = \
    _gate.test_gate_wal_columns_absent_in_old_artifact_silent
test_gate_wal_shards_change_not_comparable = \
    _gate.test_gate_wal_shards_change_not_comparable
test_gate_flags_obs_overhead_over_budget = \
    _gate.test_gate_flags_obs_overhead_over_budget
test_gate_obs_overhead_within_budget_silent = \
    _gate.test_gate_obs_overhead_within_budget_silent
test_gate_flags_qread_ratio_fall_and_tail_rises = \
    _gate.test_gate_flags_qread_ratio_fall_and_tail_rises
test_gate_qread_throughput_rides_generic_column = \
    _gate.test_gate_qread_throughput_rides_generic_column
test_gate_watcher_count_change_not_comparable = \
    _gate.test_gate_watcher_count_change_not_comparable
test_gate_flags_ingress_ratio_fall_and_ack_rise = \
    _gate.test_gate_flags_ingress_ratio_fall_and_ack_rise
test_gate_shallow_conns_change_not_comparable = \
    _gate.test_gate_shallow_conns_change_not_comparable
test_gate_ingress_columns_absent_in_old_artifact_silent = \
    _gate.test_gate_ingress_columns_absent_in_old_artifact_silent
test_gate_flags_pipelined_ratio_fall = \
    _gate.test_gate_flags_pipelined_ratio_fall
test_gate_collapsed_direct_ratio_silent = \
    _gate.test_gate_collapsed_direct_ratio_silent
test_gate_pipelined_column_absent_in_r10_artifact_silent = \
    _gate.test_gate_pipelined_column_absent_in_r10_artifact_silent
test_gate_read_columns_absent_in_old_artifact_silent = \
    _gate.test_gate_read_columns_absent_in_old_artifact_silent

H100 = "NVIDIA H100 80GB HBM3"
METRIC = "aggregate_commits_per_sec_100000_groups_5_peers"


@pytest.mark.parametrize("prev_platform,prev_device,comparable", [
    ("cpu", None, False),              # the JAX package's CPU artifact
    ("tpu", None, False),              # and its TPU one
    ("cpu", "cpu", False),             # the port on the CPU
    ("gpu", "NVIDIA A100-SXM4-80GB", False),
    ("gpu", H100, True)])
def test_gate_compares_only_the_same_platform_and_card(
        tmp_path, capsys, prev_platform, prev_device, comparable):
    """A line of the card against artifacts of every other platform and
    card, each with the same metric, scenarios and geometry and numbers
    five times better: only the same card's artifact flags the drops."""
    scen = {"engine": {"groups": 100_000, "commits_per_sec": 50_000.0},
            "shallow_clients": {"conns": 10_000, "commits_per_sec": 900.0,
                                "ingress_ack_p99_ms": 80.0}}
    prev = {"metric": METRIC, "value": 5e7, "scenario": "uniform",
            "platform": prev_platform,
            "scenarios": {k: {kk: (vv * 5 if kk == "commits_per_sec"
                                   else vv / 5 if kk.endswith("_ms")
                                   else vv) for kk, vv in v.items()}
                          for k, v in scen.items()}}
    if prev_device is not None:
        prev["device"] = prev_device
    with open(tmp_path / "BENCH_r01.json", "w") as f:
        json.dump({"parsed": prev}, f)
    cur = {"metric": METRIC, "value": 1e7, "scenario": "uniform",
           "platform": "gpu", "device": H100, "power_limit_w": 700.0,
           "scenarios": scen}
    bench._regression_gate(json.dumps(cur), artifact_dir=str(tmp_path))
    out = capsys.readouterr()
    if comparable:
        flagged = {f["scenario"] for f in
                   json.loads(out.out.strip().splitlines()[-1])
                   ["perf_regressions"]}
        assert flagged == {"primary", "engine", "shallow_clients",
                           "shallow_clients.ingress_ack_p99_ms"}
    else:
        assert "PERF REGRESSION" not in out.err
        assert "not comparable" in out.err
        assert not out.out.strip()


def test_gate_reads_the_checkouts_artifacts_by_default(capsys):
    """Without artifact_dir the gate reads the checkout's BENCH_r*.json
    (the JAX package's CPU lines): a card's line is never compared."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(bench.__file__)))
    if not any(f.startswith("BENCH_r") for f in os.listdir(root)):
        pytest.skip("no artifact in the checkout")
    bench._regression_gate(json.dumps(
        {"metric": METRIC, "value": 1.0, "scenario": "uniform",
         "platform": "gpu", "device": H100, "scenarios": {}}))
    out = capsys.readouterr()
    assert "PERF REGRESSION" not in out.err
    assert "not comparable" in out.err and not out.out.strip()
