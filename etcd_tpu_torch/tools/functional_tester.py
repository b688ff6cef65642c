"""Distributed chaos harness.

Behavioral equivalent of reference tools/functional-tester: `Agent`
daemons manage real member processes (etcd-agent/rpc.go start/stop/
restart/terminate/cleanup), a `Tester` controller loops rounds of failure
cases over a live cluster under continuous write load (`Stresser`,
etcd-tester/stresser.go), waiting for full health between cases
(etcd-tester/tester.go:31-75) and archiving+rebootstrapping on a stuck
round (tester.go cleanup). Failure classes match etcd-tester/failure.go:
kill-all, kill-majority, kill-one, kill-leader-for-long,
kill-one-for-long (snapshot catch-up), isolate-one, isolate-all.

Process control here is in-process (subprocess + signals) instead of a
net/rpc daemon: "kill" is SIGKILL, and "isolate" is SIGSTOP — a frozen
process drops off the network for peers exactly like the reference's
iptables DropPort (pkg/netutil/isolate_linux.go) while keeping its state
intact for SIGCONT recovery.
"""
from __future__ import annotations

import json
import logging
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Callable, List, NamedTuple, Optional, Sequence

log = logging.getLogger("functional-tester")


def _free_ports(n: int) -> List[int]:
    import socket
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _get_json(url: str, timeout: float = 2.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


class Agent:
    """Manages one etcd-tpu member process (reference etcd-agent)."""

    def __init__(self, name: str, data_dir: str, peer_url: str,
                 client_url: str, initial_cluster: str,
                 heartbeat_ms: int = 20, election_ms: int = 200,
                 snapshot_count: int = 1000,
                 log_dir: Optional[str] = None) -> None:
        self.name = name
        self.data_dir = data_dir
        self.peer_url = peer_url
        self.client_url = client_url
        self.initial_cluster = initial_cluster
        self.heartbeat_ms = heartbeat_ms
        self.election_ms = election_ms
        self.snapshot_count = snapshot_count
        self.log_path = os.path.join(log_dir or data_dir + "-logs",
                                     f"{name}.log")
        os.makedirs(os.path.dirname(self.log_path), exist_ok=True)
        self.proc: Optional[subprocess.Popen] = None
        self._isolated = False

    def _args(self) -> List[str]:
        return ["--name", self.name, "--data-dir", self.data_dir,
                "--listen-peer-urls", self.peer_url,
                "--initial-advertise-peer-urls", self.peer_url,
                "--listen-client-urls", self.client_url,
                "--advertise-client-urls", self.client_url,
                "--initial-cluster", self.initial_cluster,
                "--heartbeat-interval", str(self.heartbeat_ms),
                "--election-timeout", str(self.election_ms),
                "--snapshot-count", str(self.snapshot_count)]

    def start(self) -> None:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [p for p in (os.environ.get("PYTHONPATH"),
                         os.path.dirname(os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__)))))
             if p]), JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "etcd_tpu_torch"] + self._args(),
            stdout=open(self.log_path, "ab"), stderr=subprocess.STDOUT,
            env=env)
        self._isolated = False

    def stop(self) -> None:
        """Hard-kill the member ("kill" failure class)."""
        if self.proc is not None:
            if self._isolated:
                self.unisolate()
            self.proc.kill()
            self.proc.wait()
            self.proc = None

    def restart(self) -> None:
        if self.proc is None:
            self.start()

    def terminate(self) -> None:
        """Stop + wipe data (reference agent Terminate)."""
        self.stop()
        shutil.rmtree(self.data_dir, ignore_errors=True)

    def cleanup(self) -> None:
        """Stop + archive the data dir for postmortem, leaving a fresh slate
        (reference agent Cleanup archives to a failure_archive)."""
        self.stop()
        if os.path.isdir(self.data_dir):
            archive = f"{self.data_dir}.failure_archive.{int(time.time())}"
            shutil.move(self.data_dir, archive)

    def isolate(self) -> None:
        """Freeze the process — it vanishes from the network while keeping
        state (the SIGSTOP analogue of iptables DropPort)."""
        if self.proc is not None and not self._isolated:
            os.kill(self.proc.pid, signal.SIGSTOP)
            self._isolated = True

    def unisolate(self) -> None:
        if self.proc is not None and self._isolated:
            os.kill(self.proc.pid, signal.SIGCONT)
            self._isolated = False

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def healthy(self) -> bool:
        try:
            return _get_json(self.client_url + "/health").get(
                "health") == "true"
        except Exception:
            return False


class Cluster:
    """N agents + bootstrap/health plumbing (reference etcd-tester
    cluster.go)."""

    def __init__(self, size: int, base_dir: str, heartbeat_ms: int = 20,
                 election_ms: int = 200, snapshot_count: int = 1000,
                 health_timeout: float = 60.0) -> None:
        self.size = size
        self.base_dir = base_dir
        # Member subprocesses pay a multi-second JAX import on every
        # (re)start and share CPUs with whatever else runs (a full pytest
        # session, the reference CI's parallel jobs) — callers under heavy
        # contention raise this (reference tester budgets minutes/round).
        self.health_timeout = health_timeout
        ports = _free_ports(2 * size)
        peer_urls = [f"http://127.0.0.1:{ports[i]}" for i in range(size)]
        client_urls = [f"http://127.0.0.1:{ports[size + i]}"
                       for i in range(size)]
        ic = ",".join(f"m{i}={peer_urls[i]}" for i in range(size))
        self.agents = [
            Agent(f"m{i}", os.path.join(base_dir, f"m{i}"), peer_urls[i],
                  client_urls[i], ic, heartbeat_ms, election_ms,
                  snapshot_count, log_dir=os.path.join(base_dir, "logs"))
            for i in range(size)]

    def bootstrap(self) -> None:
        for a in self.agents:
            a.start()
        self.wait_health()

    def wait_health(self, timeout: Optional[float] = None) -> None:
        """All running members healthy (reference cluster.WaitHealth)."""
        deadline = time.time() + (timeout if timeout is not None
                                  else self.health_timeout)
        while time.time() < deadline:
            if all(a.healthy() for a in self.agents if a.running):
                if any(a.running for a in self.agents):
                    return
            time.sleep(0.25)
        raise TimeoutError("cluster did not become healthy")

    def leader_index(self) -> Optional[int]:
        for i, a in enumerate(self.agents):
            if not a.running:
                continue
            try:
                st = _get_json(a.client_url + "/v2/stats/self")
                if st.get("state") == "StateLeader":
                    return i
            except Exception:
                continue
        return None

    def client_endpoints(self) -> List[str]:
        return [a.client_url for a in self.agents if a.running]

    def cleanup_and_rebootstrap(self) -> None:
        for a in self.agents:
            a.cleanup()
        self.bootstrap()

    def stop(self) -> None:
        for a in self.agents:
            a.stop()


class Stresser:
    """Continuous write load during failures (reference stresser.go):
    N threads PUT random suffixed keys with `key_size` values."""

    def __init__(self, endpoints: Sequence[str], n: int = 4,
                 key_size: int = 64, key_suffix_range: int = 100) -> None:
        self.endpoints = list(endpoints)
        self.n = n
        self.key_size = key_size
        self.key_suffix_range = key_suffix_range
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.success = 0
        self.failure = 0
        self._threads: List[threading.Thread] = []

    def _loop(self, seed: int) -> None:
        rng = random.Random(seed)
        body = ("value=" + "x" * self.key_size).encode()
        while not self._stop.is_set():
            ep = rng.choice(self.endpoints)
            key = f"/v2/keys/stress-{rng.randrange(self.key_suffix_range)}"
            req = urllib.request.Request(
                ep + key, data=body, method="PUT",
                headers={"Content-Type":
                         "application/x-www-form-urlencoded"})
            try:
                with urllib.request.urlopen(req, timeout=1.0) as r:
                    ok = r.status < 400
            except Exception:
                ok = False
            with self._lock:
                if ok:
                    self.success += 1
                else:
                    self.failure += 1

    def stress(self) -> None:
        self._stop.clear()
        self._threads = [threading.Thread(target=self._loop, args=(i,),
                                          daemon=True)
                         for i in range(self.n)]
        for t in self._threads:
            t.start()

    def cancel(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=3)

    def report(self):
        with self._lock:
            return self.success, self.failure


# -- failure cases (reference etcd-tester/failure.go:25-228) -----------------

class Failure(NamedTuple):
    desc: str
    inject: Callable[[Cluster, int], None]
    recover: Callable[[Cluster, int], None]


def _kill_all(c: Cluster, r: int) -> None:
    for a in c.agents:
        a.stop()


def _recover_all(c: Cluster, r: int) -> None:
    for a in c.agents:
        a.restart()
    c.wait_health()


def _to_kill(size: int, seed: int) -> List[int]:
    rng = random.Random(seed)
    majority = size // 2 + 1
    picked: set = set()
    while len(picked) < majority:
        picked.add(rng.randrange(size))
    return sorted(picked)


def _kill_majority(c: Cluster, r: int) -> None:
    for i in _to_kill(c.size, r):
        c.agents[i].stop()


def _recover_majority(c: Cluster, r: int) -> None:
    for i in _to_kill(c.size, r):
        c.agents[i].restart()
    c.wait_health()


def _kill_one(c: Cluster, r: int) -> None:
    c.agents[r % c.size].stop()


def _recover_one(c: Cluster, r: int) -> None:
    c.agents[r % c.size].restart()
    c.wait_health()


def _kill_leader_long(c: Cluster, r: int) -> None:
    i = c.leader_index()
    c._last_leader = i if i is not None else r % c.size
    c.agents[c._last_leader].stop()
    time.sleep(2.0)  # long outage: the rest must re-elect and make progress


def _recover_leader_long(c: Cluster, r: int) -> None:
    c.agents[c._last_leader].restart()
    c.wait_health()


def _kill_one_long(c: Cluster, r: int) -> None:
    """Down long enough that catch-up needs a snapshot (snapshot_count is
    set low; the stresser keeps writing meanwhile)."""
    c.agents[r % c.size].stop()
    time.sleep(3.0)


def _isolate_one(c: Cluster, r: int) -> None:
    c.agents[r % c.size].isolate()
    time.sleep(1.0)


def _unisolate_one(c: Cluster, r: int) -> None:
    c.agents[r % c.size].unisolate()
    c.wait_health()


def _isolate_all(c: Cluster, r: int) -> None:
    for a in c.agents:
        a.isolate()
    time.sleep(1.0)


def _unisolate_all(c: Cluster, r: int) -> None:
    for a in c.agents:
        a.unisolate()
    c.wait_health()


FAILURES: List[Failure] = [
    Failure("kill all members", _kill_all, _recover_all),
    Failure("kill majority of the cluster", _kill_majority,
            _recover_majority),
    Failure("kill one random member", _kill_one, _recover_one),
    Failure("kill leader for long time", _kill_leader_long,
            _recover_leader_long),
    Failure("kill one member for long time (snapshot catch-up)",
            _kill_one_long, _recover_one),
    Failure("isolate one member", _isolate_one, _unisolate_one),
    Failure("isolate all members", _isolate_all, _unisolate_all),
]


class Tester:
    """Round loop (reference tester.go runLoop): per round, run every
    failure case against a healthy cluster under stress; on any error,
    archive data dirs and re-bootstrap."""

    def __init__(self, cluster: Cluster,
                 failures: Optional[List[Failure]] = None,
                 rounds: int = 1, progress_timeout: float = 90.0) -> None:
        self.cluster = cluster
        self.failures = failures if failures is not None else FAILURES
        self.rounds = rounds
        self.progress_timeout = progress_timeout
        self.round = 0
        self.case = 0
        self.succeeded = 0
        self.failed = 0

    def run_loop(self) -> None:
        stresser = Stresser(self.cluster.client_endpoints())
        stresser.stress()
        try:
            for i in range(self.rounds):
                self.round = i
                for j, f in enumerate(self.failures):
                    self.case = j
                    tag = f"[round#{i} case#{j}]"
                    try:
                        self.cluster.wait_health()
                        log.info("%s injecting: %s", tag, f.desc)
                        f.inject(self.cluster, i)
                        log.info("%s recovering: %s", tag, f.desc)
                        f.recover(self.cluster, i)
                        self._verify_progress()
                        log.info("%s succeed!", tag)
                        self.succeeded += 1
                    except Exception as e:
                        log.warning("%s FAILED (%s); cleaning up", tag, e)
                        self.failed += 1
                        self.cluster.cleanup_and_rebootstrap()
        finally:
            stresser.cancel()
        s, fcount = stresser.report()
        log.info("stresser: %d success, %d failure writes", s, fcount)

    def _verify_progress(self) -> None:
        """After recovery the cluster must commit NEW writes on every
        member's endpoint (the reference's health+progress bar)."""
        import urllib.parse
        for a in self.cluster.agents:
            if not a.running:
                continue
            body = urllib.parse.urlencode(
                {"value": f"progress-{time.time()}"}).encode()
            req = urllib.request.Request(
                a.client_url + "/v2/keys/tester-progress", data=body,
                method="PUT",
                headers={"Content-Type":
                         "application/x-www-form-urlencoded"})
            # Generous: member subprocesses share CPUs with the test
            # runner; the reference tester budgets minutes per round
            # (etcd-tester/tester.go round deadlines).
            deadline = time.time() + self.progress_timeout
            while True:
                try:
                    with urllib.request.urlopen(req, timeout=2.0) as r:
                        if r.status < 400:
                            break
                except Exception:
                    pass
                if time.time() > deadline:
                    raise TimeoutError(
                        f"member {a.name} makes no progress")
                time.sleep(0.25)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import tempfile
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(prog="etcd-tpu-functional-tester")
    ap.add_argument("--size", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--base-dir", default="")
    ns = ap.parse_args(argv)
    base = ns.base_dir or tempfile.mkdtemp(prefix="etcd-tpu-tester-")
    c = Cluster(ns.size, base)
    c.bootstrap()
    t = Tester(c, rounds=ns.rounds)
    try:
        t.run_loop()
    finally:
        c.stop()
    print(json.dumps({"rounds": ns.rounds, "cases": len(t.failures),
                      "succeeded": t.succeeded, "failed": t.failed}))
    return 0 if t.failed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
