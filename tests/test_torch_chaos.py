"""The port's chaos harness (etcd_tpu_torch/tools/functional_tester.py)
boots and breaks the port's members, not the JAX package's.

1. A mirror of tests/test_tools.py::test_functional_tester_one_round
   (marked slow there): kill-one, kill-majority and isolate-one against
   a live cluster of three `python -m etcd_tpu_torch` member processes
   under stress; every case must inject, recover and commit new writes
   on every member afterwards. Rerunning the source through
   tests/port_tests.py would import the port's harness, but the module
   under test is the one that chooses which package's members to spawn:
   this mirror checks that choice too.
2. A member the harness starts is a `python -m etcd_tpu_torch` process
   that loads no torch, and one of the JAX package's harness is not.

Tolerance: exact (every case passes)."""
import logging

from etcd_tpu_torch.tools.functional_tester import (FAILURES, Agent,
                                                    Cluster)
from etcd_tpu_torch.tools.functional_tester import Tester as ChaosTester
from port_tests import loads_torch
from test_http import free_ports


def _cmdline(pid) -> list:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().decode().split("\0")


def test_functional_tester_one_round(tmp_path):
    """Mirror of tests/test_tools.py's test of this name on the port's
    harness, with its budgets and its one retry round."""
    logging.getLogger("functional-tester").setLevel(logging.INFO)
    c = Cluster(3, str(tmp_path / "cluster"), health_timeout=240.0)
    c.bootstrap()
    cases = [FAILURES[2], FAILURES[1], FAILURES[5]]
    try:
        assert all(_cmdline(a.proc.pid)[1:3] == ["-m", "etcd_tpu_torch"]
                   for a in c.agents)   # healthy: each has run its exec
        t = ChaosTester(c, failures=cases, rounds=1, progress_timeout=240.0)
        t.run_loop()
        if t.failed:
            t = ChaosTester(c, failures=cases, rounds=1,
                            progress_timeout=240.0)
            t.run_loop()
    finally:
        c.stop()
    assert t.failed == 0, f"{t.failed} chaos cases failed (incl. retry)"
    assert t.succeeded == len(cases)


def test_the_harness_spawns_the_ports_members(tmp_path, monkeypatch):
    """The port's Agent starts `python -m etcd_tpu_torch`, a member that
    serves and loads no torch; the JAX package's Agent, given the same
    member, would start `python -m etcd_tpu` with the same flags."""
    import subprocess
    import time

    from etcd_tpu.tools.functional_tester import Agent as JaxAgent
    pport, cport = free_ports(2)
    peer, client = f"http://127.0.0.1:{pport}", f"http://127.0.0.1:{cport}"
    a = Agent("m0", str(tmp_path / "m0"), peer, client, f"m0={peer}")
    a.start()
    try:
        deadline = time.time() + 60
        while not a.healthy():
            assert a.running and time.time() < deadline
            time.sleep(0.1)
        ours = _cmdline(a.proc.pid)
        assert ours[1:3] == ["-m", "etcd_tpu_torch"]
        assert not loads_torch(a.proc.pid)
    finally:
        a.stop()
    spawned = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda argv, **kw: spawned.append(argv))
    JaxAgent("m0", str(tmp_path / "m0"), peer, client, f"m0={peer}").start()
    assert spawned[0][1:3] == ["-m", "etcd_tpu"]
    assert spawned[0][3:] == ours[3:-1] == a._args()
