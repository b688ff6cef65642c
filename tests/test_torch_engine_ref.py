"""tests/test_engine.py's cases on the port's MultiEngine, on the CPU.

The JAX test module runs compiled against the port and bound to the CPU
(tests/port_tests.py, `on_the_port(..., cpu=True)`). Its helper
`partition_mask` builds a jnp array; here it is rebound to a torch
version that draws the same random numbers. Three tests write jnp
arrays into the engine's device state and are mirrored by hand below,
with the same sizes, rounds and assertions on torch tensors:
- test_engine_mask_watchdog_repairs_corrupt_device_mask;
- test_engine_snapshot_install_catches_up_partitioned_follower;
- test_engine_violation_dumps_and_fails (`.at[].set` becomes a clone
  and an index assignment).

test_engine_chaos_soak_acked_writes_survive runs in
tests/test_torch_engine_soak_ref.py, a file of its own: the port's eager
rounds on the CPU make it the longest test of this suite."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from etcd_tpu_torch.ops.state import NH_VIOLATION
from etcd_tpu_torch.server.engine import EngineViolation
from etcd_tpu_torch.server.request import Request
from port_tests import on_the_port

_eng = on_the_port("test_engine", cpu=True)
make_cfg, run_until, put_async, settle = (
    _eng.make_cfg, _eng.run_until, _eng.put_async, _eng.settle)
MultiEngine = _eng.MultiEngine


def partition_mask(G, P, rng, prob=0.4):
    """tests/test_engine.py's partition_mask, returning a torch tensor:
    one random slot fully cut in ~prob of the groups, or None."""
    m_to = np.ones((G, P, 1, 1), np.int32)
    m_from = np.ones((G, 1, P, 1), np.int32)
    any_cut = False
    for g in range(G):
        if rng.rand() < prob:
            s = rng.randint(P)
            m_to[g, s] = 0
            m_from[g, 0, s] = 0
            any_cut = True
    return torch.from_numpy(m_to * m_from) if any_cut else None


_eng.partition_mask = partition_mask

test_engine_serves_puts_and_gets = _eng.test_engine_serves_puts_and_gets
test_engine_background_thread_serving = \
    _eng.test_engine_background_thread_serving
test_engine_restart_from_wal = _eng.test_engine_restart_from_wal
test_engine_checkpoint_and_segment_purge = \
    _eng.test_engine_checkpoint_and_segment_purge
test_engine_conf_change_grow_and_shrink = \
    _eng.test_engine_conf_change_grow_and_shrink
test_engine_restart_after_slot_readd_keeps_writes = \
    _eng.test_engine_restart_after_slot_readd_keeps_writes
test_engine_watch_fires_on_apply = _eng.test_engine_watch_fires_on_apply
test_engine_http_surface = _eng.test_engine_http_surface
test_engine_profile_hook = _eng.test_engine_profile_hook
test_engine_chaos_soak_membership_churn = \
    _eng.test_engine_chaos_soak_membership_churn
test_engine_batches_hot_group_writes = _eng.test_engine_batches_hot_group_writes
test_engine_ttl_expiry_watch_and_restart = \
    _eng.test_engine_ttl_expiry_watch_and_restart
test_engine_tenant_lifecycle = _eng.test_engine_tenant_lifecycle
test_engine_tenant_lifecycle_soak = _eng.test_engine_tenant_lifecycle_soak
test_engine_tenant_remove_recreate_same_record = \
    _eng.test_engine_tenant_remove_recreate_same_record
test_engine_batched_fast_path_mixed_entry = \
    _eng.test_engine_batched_fast_path_mixed_entry


def test_engine_mask_watchdog_repairs_corrupt_device_mask(tmp_path):
    """Mirror: a corrupted device peer_mask (one active slot per group)
    is detected and restored from h_mask within mask_check_rounds, and
    replication resumes."""
    eng = MultiEngine(make_cfg(tmp_path / "wd", mask_check_rounds=16))
    run_until(eng, lambda: all(eng.leader_slot(g) >= 0 for g in range(4)),
              msg="leaders")
    t, out = put_async(eng, 0, "/a", "1")
    settle(eng, t, out)
    G, P = eng.cfg.groups, eng.cfg.peers
    diag = np.zeros((G, P), bool)
    diag[np.arange(G), np.arange(G) % P] = True
    eng.st = eng.st._replace(peer_mask=torch.from_numpy(diag))
    for _ in range(eng.cfg.mask_check_rounds + 1):
        eng.run_round()
    assert eng.mask_repairs >= 1
    assert np.array_equal(eng.st.peer_mask.numpy(), eng.h_mask)
    t, out = put_async(eng, 0, "/b", "2")
    ev = settle(eng, t, out)
    assert ev.node.value == "2"
    eng.stop()


def test_engine_snapshot_install_catches_up_partitioned_follower(tmp_path):
    """Mirror: a follower cut off while the leader's log runs past the
    ring window rejoins through the engine's snapshot install."""
    eng = MultiEngine(make_cfg(tmp_path / "e6", initial_peers=3))
    run_until(eng, lambda: eng.leader_slot(0) >= 0, msg="leader")
    s = eng.leader_slot(0)
    f = (s + 1) % 3

    G, P = eng.cfg.groups, eng.cfg.peers
    m_to = np.ones((G, P, 1, 1), np.int32)
    m_from = np.ones((G, 1, P, 1), np.int32)
    m_to[0, f] = 0
    m_from[0, 0, f] = 0
    eng.drop_mask = torch.from_numpy(m_to * m_from)

    for i in range(eng.cfg.window + 8):
        t, out = put_async(eng, 0, f"/k{i}", str(i))
        settle(eng, t, out)
    assert eng.h_last[0, s] - eng.h_commit[0, f] > eng.cfg.window

    eng.drop_mask = None
    run_until(
        eng,
        lambda: (eng.leader_slot(0) >= 0
                 and eng.h_commit[0, f] >= eng.h_commit[0].max() - 1
                 and eng.h_commit[0, f] > eng.cfg.window),
        max_rounds=1500, msg="lagging follower catch-up")
    t, out = put_async(eng, 0, "/healed", "ok")
    settle(eng, t, out, max_rounds=800)
    assert eng.do(0, Request(method="GET", path="/healed")).node.value == "ok"
    eng.stop()


def test_engine_violation_dumps_and_fails(tmp_path):
    """Mirror: a raised NH_VIOLATION bit makes the engine dump the
    flagged group's state and raise EngineViolation."""
    cfg = make_cfg(tmp_path)
    eng = MultiEngine(cfg)
    run_until(eng, lambda: all(eng.leader_slot(g) >= 0
                               for g in range(cfg.groups)),
              msg="leaders")
    need_host = eng.st.need_host.clone()
    need_host[1, 2] = NH_VIOLATION
    eng.st = eng.st._replace(need_host=need_host)
    with pytest.raises(EngineViolation):
        run_until(eng, lambda: False, max_rounds=3, msg="violation")
    dumps = glob.glob(os.path.join(str(tmp_path), "diagnostics",
                                   "violation-*.json"))
    assert dumps, "no violation dump written"
    with open(dumps[0]) as f:
        d = json.load(f)
    assert "1" in d["flagged"]
    assert d["flagged"]["1"]["slots"] == [2]
    assert "term" in d["flagged"]["1"] and "log_term" in d["flagged"]["1"]
