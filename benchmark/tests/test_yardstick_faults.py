"""The reference on a tiny engine on the CPU: a sound run is correct, and
each fault a run can have, planted underneath the timed path, and the
control (the program's own fsync-off path: acks no longer wait for a
durable WAL) come out not correct. A run here skips the harness's look
for a card and drives everything else of a run."""
import json
from pathlib import Path

import pytest

from benchmark import driver, reference, run

H = Path(__file__).resolve().parents[1]


def tiny(cfg_name="mt100k-r5", mix_name="steady", **over):
    cfg = json.loads((H / "configs" / f"{cfg_name}.json").read_text())
    cfg.update(groups=32, **over)
    mix = json.loads((H / "traffic" / f"{mix_name}.json").read_text())
    mix.update(rate_per_s=150, warmup_s=0.5)
    return cfg, mix


def go(cfg, mix, seed=2 ** 31 + 3, factory=None, drain_s=15.0):
    return driver.run_cell(cfg, mix, seed, 1.5, False, "cpu",
                           run.process_start(), drain_s=drain_s,
                           engine_factory=factory)


def bad(res):
    return {k: v for k, v in res.checks.items() if v}


@pytest.mark.parametrize("cfg_name,mix_name", [
    ("mt100k-r5", "steady"), ("mt100k-r7", "steady"), ("mt100k-r5", "lag5")])
def test_sound_run_is_correct(cfg_name, mix_name):
    res = go(*tiny(cfg_name, mix_name))
    assert bad(res) == {} and res.failed == 0
    assert res.attempted == int(150 * 0.5) + int(150 * 1.5)
    assert res.obs["acked_in_window"] > 0 and res.obs["rounds"] > 0


def test_control_fsync_off_is_not_correct():
    res = go(*tiny(fsync=False))
    assert set(bad(res)) == {"ack_before_fsync"}
    assert res.checks["ack_before_fsync"] == res.attempted


def _engine():
    from etcd_tpu_torch.server.engine import MultiEngine
    return MultiEngine


def test_fault_state_left_unchanged():
    """The round's device state stays as it was once the tenants have
    leaders: the host still acks, the device never holds the writes."""
    class Frozen(_engine()):
        frozen = None

        def run_round(self):
            super().run_round()
            if self.frozen is None and all(
                    self.leader_slot(g) >= 0 for g in range(self.cfg.groups)):
                self.frozen = self.st
            if self.frozen is not None:
                self.st = self.frozen
    res = go(*tiny(), factory=Frozen)
    assert res.checks["below_quorum"] + res.checks["above_commit"] \
        + res.checks["unacked"] > 0


def test_fault_half_the_requests_left_out():
    """Every second submission is registered but never staged."""
    class Half(_engine()):
        n = 0

        def submit_many(self, g, reqs):
            self.n += 1
            if self.n % 2:
                return super().submit_many(g, reqs)
            rid = self.reqid.next()
            return [(rid, self.wait.register(rid))]
    res = go(*tiny(), factory=Half, drain_s=3.0)
    assert res.checks["unacked"] >= res.attempted // 2 - 1


def test_fault_answer_altered_where_produced():
    """The applied value differs from the one the client sent."""
    from etcd_tpu_torch.server.request import Request

    class Altered(_engine()):
        def submit_many(self, g, reqs):
            return super().submit_many(g, [
                Request(**{**r.__dict__, "val": r.val[::-1]}) for r in reqs])
    res = go(*tiny(), factory=Altered)
    assert res.checks["ack_mismatch"] == res.attempted
    assert res.checks["store_mismatch"] > 0


def test_fault_dropped_ack():
    """One ack in ten never reaches its client."""
    from etcd_tpu_torch import errors

    class Drop(_engine()):
        n = 0

        def collect_many(self, g, queues, timeout=None):
            out = super().collect_many(g, queues, timeout)
            self.n += 1
            if self.n % 10 == 0:
                out = [errors.EtcdError(errors.ECODE_RAFT_INTERNAL,
                                        cause="lost")]
            return out
    res = go(*tiny(), factory=Drop)
    assert res.checks["unacked"] == res.failed >= res.attempted // 10 - 1


def test_fault_acked_without_a_quorum():
    """Once every tenant has a leader, each leader hears from one
    follower only, and the applier takes the leader's last index for the
    commit: writes are acked that no quorum holds."""
    import numpy as np
    import torch

    class Unquorate(_engine()):
        def run_round(self):
            super().run_round()
            if self.drop_mask is None and all(
                    self.leader_slot(g) >= 0 for g in range(self.cfg.groups)):
                G, P = self.cfg.groups, self.cfg.peers
                lead = np.array([self.leader_slot(g) for g in range(G)])
                keep = np.zeros((G, P), np.int32)
                keep[np.arange(G), lead] = 1
                keep[np.arange(G), (lead + 1) % P] = 1
                mask = keep[:, :, None, None] * keep[:, None, :, None]
                self.drop_mask = torch.as_tensor(mask)

        def _commit_view(self):
            view = super()._commit_view()
            last = np.where(self.h_mask, self.h_last, 0)
            return (last.max(axis=1), last.argmax(axis=1)) + view[2:]
    res = go(*tiny(), factory=Unquorate)
    assert res.checks["below_quorum"] > 0 and res.checks["above_commit"] > 0


def test_fault_entries_left_out_of_the_wal():
    """The WAL records go to disk without their entries."""
    class Forgetful(_engine()):
        def __init__(self, cfg):
            super().__init__(cfg)
            submit = self.wal.submit

            def without_entries(rec):
                rec.entries = []
                return submit(rec)
            self.wal.submit = without_entries
    res = go(*tiny(), factory=Forgetful)
    assert res.checks["not_in_wal"] == res.attempted


def test_checks_are_the_printed_ones():
    assert set(reference.CHECKS) == {
        "unacked", "ack_mismatch", "store_mismatch", "not_in_wal",
        "ack_before_fsync", "below_quorum", "above_commit"}


@pytest.mark.card
def test_control_at_a_card_size(cuda_device):
    """On the card: the program at 10,000 tenants is correct and the
    fsync-off control is not."""
    cfg, mix = tiny()
    cfg["groups"] = 10000
    mix["rate_per_s"] = 2000
    ok = driver.run_cell(cfg, mix, 11, 2.0, False, cuda_device,
                         run.process_start())
    assert bad(ok) == {}
    cfg["fsync"] = False
    ctl = driver.run_cell(cfg, mix, 11, 2.0, False, cuda_device,
                          run.process_start())
    assert ctl.checks["ack_before_fsync"] > 0


def test_ack_watch_leaves_no_cycle():
    """The watch announces the ack once and is taken off the queue with
    it, so a request's wait queue is freed by its last reference and not
    left to the cyclic collector."""
    import gc
    import queue
    import weakref

    class Stub:
        acked = queue.SimpleQueue()

    for early in (False, True):
        q = queue.Queue(maxsize=1)
        if early:
            q.put("ack")
        driver.Clients.hand(Stub, 7, 3, [(11, q)])
        if not early:
            q.put("ack")
        assert "put" not in q.__dict__
        assert Stub.acked.get_nowait() == (7, 3, [(11, q)])
        assert Stub.acked.empty()
        ref = weakref.ref(q)
        gc.disable()
        try:
            del q
            assert ref() is None
        finally:
            gc.enable()
