"""tests/test_multihost_snapshot.py's cases on the port, on the CPU
(`on_the_port(..., cpu=True)`): the WAL's snap records
(`RoundRecord.snaps`, the format written before them), `load_terms`
from a checkpoint plus replay, the supervisor's term floor
(`prepare_dirs`) and the truncation refusal of `_unpack_snaps`; and the
three end-to-end recoveries, which the JAX module marks `slow` and which
stay `slow` here (chip_smoke.py's multihost_collective phase holds the
disk-loss recovery on the card).

The JAX module names the supervisor and the rank launcher by path
(`scripts/multihost_supervisor.py`, and tests/test_hostengine.py's
Cluster spawns `scripts/multihost_engine.py`). Here `SUP` is the port's
`etcd_tpu_torch/tools/multihost_supervisor.py`, run with the module's own
PYTHONPATH; test_supervisor_prepare_dirs_writes_floor imports the port's
supervisor module; and test_stale_disk_restart_catches_up_via_snapshots
runs the JAX test's steps on a Cluster whose ranks are `python -m
etcd_tpu_torch.tools.multihost_engine`. Every child gets
`MHE_DEVICE=cpu`."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from etcd_tpu_torch.server.enginewal import EngineWAL, RoundRecord
from etcd_tpu_torch.tools import multihost_supervisor as sup_mod
from port_tests import CHILD_ENV, on_the_port

_ms = on_the_port("test_multihost_snapshot", cpu=True)
REPO = _ms.REPO
_ms.SUP = os.path.join(REPO, "etcd_tpu_torch", "tools",
                       "multihost_supervisor.py")

test_roundrecord_snaps_roundtrip = _ms.test_roundrecord_snaps_roundtrip
test_roundrecord_pre_snaps_format_decodes = \
    _ms.test_roundrecord_pre_snaps_format_decodes
test_load_terms_checkpoint_plus_replay = \
    _ms.test_load_terms_checkpoint_plus_replay
test_unpack_snaps_truncation_rejected = \
    _ms.test_unpack_snaps_truncation_rejected
test_host_loss_with_disk_loss_recovers_via_snapshots = \
    _ms.test_host_loss_with_disk_loss_recovers_via_snapshots
test_two_sequential_disk_losses_recover = \
    _ms.test_two_sequential_disk_losses_recover


def test_supervisor_prepare_dirs_writes_floor(tmp_path):
    """Mirror: two survivor dirs with terms [5, 2] and [4, 9] give the
    missing rank a floor of their elementwise max plus one; survivors'
    dirs are untouched, and a fresh job invents no floors."""
    data = str(tmp_path)
    for r, terms in ((0, [5, 2]), (1, [4, 9])):
        d = os.path.join(data, f"host{r}")
        wal = EngineWAL(d, fsync=False)
        wal.append(RoundRecord(round_no=1,
                               hs_g=np.array([0, 1], "<u4"),
                               hs_p=np.array([r, r], "<u2"),
                               hs_term=np.array(terms, "<u4"),
                               hs_vote=np.array([0, 0], "<u2"),
                               hs_commit=np.array([0, 0], "<u4")))
        wal.close()
    sup = sup_mod.Supervisor(3, 2, data, os.path.join(data, "s.json"),
                             stall_s=5.0, poll_s=0.5)
    sup.prepare_dirs()
    with open(os.path.join(data, "host2", "term_floor.json")) as f:
        floor = json.load(f)["term"]
    assert floor == [6, 10]
    assert not os.path.exists(os.path.join(data, "host0",
                                           "term_floor.json"))
    empty = str(tmp_path / "fresh")
    os.makedirs(empty)
    sup2 = sup_mod.Supervisor(3, 2, empty, os.path.join(empty, "s.json"),
                              stall_s=5.0, poll_s=0.5)
    sup2.prepare_dirs()
    assert not any(os.path.exists(os.path.join(empty, f"host{r}",
                                               "term_floor.json"))
                   for r in range(3))


def _port_cluster():
    """tests/test_hostengine.py's Cluster with the port's ranks."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_hostengine import Cluster, _free_port

    class PortCluster(Cluster):
        def start(self):
            coord = f"127.0.0.1:{_free_port()}"
            self.procs = []
            self.gen += 1
            for r in range(self.n):
                env = dict(os.environ, MHE_RANK=str(r),
                           MHE_NHOSTS=str(self.n), MHE_COORD=coord,
                           MHE_DATA=self.data, MHE_GROUPS=str(self.groups),
                           MHE_HTTP_PORTS=",".join(map(str,
                                                       self.http_ports)),
                           MHE_FRAME_PORTS=",".join(map(str,
                                                        self.frame_ports)),
                           **CHILD_ENV, **self.extra_env)
                logf = open(os.path.join(self.data,
                                         f"rank{r}.gen{self.gen}.log"), "ab")
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "etcd_tpu_torch.tools.multihost_engine"],
                    cwd=REPO, env=env, stdout=logf,
                    stderr=subprocess.STDOUT))
                logf.close()
            return self

    return PortCluster


@pytest.mark.slow
def test_stale_disk_restart_catches_up_via_snapshots(tmp_path):
    """Mirror: a host restarting from a stale backup of its disk, behind
    by more than the ring window, converges by snapshot install over its
    existing store, and serves every write after one more bounce."""
    from test_hostengine import _get, _put
    W = 8
    cl = _port_cluster()(tmp_path, n=3, groups=2,
                         extra_env={"MHE_WINDOW": str(W),
                                    "MHE_CKPT_ROUNDS": "40"}).start()
    try:
        cl.wait_up()
        for g in range(2):
            for i in range(3):
                _put(cl.base(g % 3), g, f"s{i}", f"old{g}{i}")
        time.sleep(1.0)
        cl.kill_all()
        backup = str(tmp_path / "host2.backup")
        shutil.copytree(os.path.join(cl.data, "host2"), backup)

        cl.start()
        cl.wait_up()
        for g in range(2):
            for i in range(W + 6):
                _put(cl.base((g + i) % 3), g, f"k{i}", f"new{g}{i}")
        cl.kill_all()

        shutil.rmtree(os.path.join(cl.data, "host2"))
        shutil.copytree(backup, os.path.join(cl.data, "host2"))
        cl.start()
        cl.wait_up()
        deadline = time.time() + 90
        sv = None
        while time.time() < deadline:
            try:
                sv = cl.status(2)
                s0 = cl.status(0)
                if (sv.get("snaps_installed", 0) >= 1
                        and sv["applied_total"]
                        >= s0["applied_total"] - 2):
                    break
            except Exception:
                pass
            time.sleep(0.5)
        else:
            cl.dump_logs()
            raise AssertionError(f"stale host never caught up: {sv}")
        for g in range(2):
            for i in range(W + 6):
                got = _get(cl.base(2), g, f"k{i}")
                assert got["node"]["value"] == f"new{g}{i}", (g, i, got)
            got = _get(cl.base(2), g, "s0")
            assert got["node"]["value"] == f"old{g}0"

        cl.kill_all()
        cl.start()
        cl.wait_up()
        for g in range(2):
            got = _get(cl.base(2), g, f"k{W + 5}")
            assert got["node"]["value"] == f"new{g}{W + 5}", (g, got)
            got = _get(cl.base(2), g, "s0")
            assert got["node"]["value"] == f"old{g}0"
    finally:
        cl.kill_all()
