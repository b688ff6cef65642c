"""The port's multi-host engine on the collective data plane: rank
processes of `python -m etcd_tpu_torch.tools.multihost_engine` on the CPU
(MHE_DEVICE=cpu) with MHE_PLANE=collective on a gloo process group (the
ranks are the peers axis of a (1, N) mesh; the per-round mailbox is an
all-to-all). Mirrors of tests/test_hostengine.py's collective tests and
of tests/test_read_plane.py's zero-append test.

The kill test is the contract: clients ack writes against both hosts
while one host is SIGKILLed mid-traffic; the survivors stall on the
collective, the whole job restarts from the per-host WALs, and every
acked write reads back from the host that acked it (acks fire only after
the acker's own fsync + apply). Tolerance: exact (values read back equal
the values written)."""
import concurrent.futures as futs
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from tests.test_torch_multihost import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "etcd_tpu_torch.tools.multihost_engine"


class Cluster:
    """N collective ranks; every start() is a new generation with a fresh
    MHE_COORD, as the supervisor spawns them."""

    def __init__(self, data, n=2, groups=4, extra_env=None):
        self.data, self.n, self.groups = str(data), n, groups
        self.extra_env = extra_env or {}
        self.http_ports = [_free_port() for _ in range(n)]
        self.frame_ports = [_free_port() for _ in range(n)]
        self.procs = []
        self.gen = 0

    def start(self):
        coord = f"127.0.0.1:{_free_port()}"
        self.procs = []
        self.gen += 1
        for r in range(self.n):
            env = dict(os.environ, MHE_RANK=str(r), MHE_NHOSTS=str(self.n),
                       MHE_COORD=coord, MHE_DATA=self.data,
                       MHE_GROUPS=str(self.groups),
                       MHE_HTTP_PORTS=",".join(map(str, self.http_ports)),
                       MHE_FRAME_PORTS=",".join(map(str, self.frame_ports)),
                       MHE_PLANE="collective", MHE_BACKEND="gloo",
                       MHE_DEVICE="cpu", **self.extra_env)
            with open(os.path.join(self.data, f"rank{r}.gen{self.gen}.log"),
                      "ab") as logf:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", MODULE], cwd=REPO, env=env,
                    stdout=logf, stderr=subprocess.STDOUT))
        return self

    def base(self, h):
        return f"http://127.0.0.1:{self.http_ports[h]}"

    def status(self, h, timeout=3):
        return json.loads(urllib.request.urlopen(
            self.base(h) + "/engine/status", timeout=timeout).read())

    def dump_logs(self):
        for name in sorted(os.listdir(self.data)):
            if name.startswith("rank") and name.endswith(".log"):
                with open(os.path.join(self.data, name),
                          errors="replace") as f:
                    print(f"\n===== {name} =====\n{f.read()[-4000:]}",
                          file=sys.stderr)

    def wait_up(self, timeout=60):
        deadline = time.time() + timeout
        for h in range(self.n):
            while True:
                if any(p.poll() is not None for p in self.procs):
                    raise AssertionError(
                        f"rank died: {[p.poll() for p in self.procs]}")
                try:
                    if self.status(h)["groups_with_leader"] == self.groups:
                        break
                except OSError:
                    pass
                if time.time() > deadline:
                    raise AssertionError(f"host {h} never converged")
                time.sleep(0.2)

    def kill_all(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def terminate(self):
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=30))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        return rcs

    def exit_lines(self):
        """Each rank's JSON exit line of the last generation."""
        out = []
        for r in range(self.n):
            with open(os.path.join(self.data,
                                   f"rank{r}.gen{self.gen}.log")) as f:
                out.append([json.loads(ln) for ln in f
                            if ln.startswith('{"rank"')][-1])
        return out


def _put(base, g, k, v, timeout=20):
    req = urllib.request.Request(
        f"{base}/tenants/{g}/v2/keys/{k}", f"value={v}".encode(),
        method="PUT",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def _get(base, g, k, timeout=10, quorum=False):
    q = "?quorum=true" if quorum else ""
    return json.loads(urllib.request.urlopen(
        f"{base}/tenants/{g}/v2/keys/{k}{q}", timeout=timeout).read())


def _run(cl, body):
    try:
        body()
    except BaseException:
        cl.dump_logs()
        raise
    finally:
        cl.kill_all()


def test_two_hosts_serve_forward_and_survive_sigkill(tmp_path):
    cl = Cluster(tmp_path, n=2, groups=4).start()

    def body():
        cl.wait_up()
        acked = {}
        stop_blast = threading.Event()

        def write(i):
            g, h = i % 4, (i // 4) % 2
            try:
                if _put(cl.base(h), g, f"k{i}", f"v{i}")["action"] == "set":
                    acked[i] = h
            except OSError:
                pass

        for i in range(40):
            write(i)
        assert len(acked) >= 30, f"only {len(acked)} of 40 acked"

        # Keep writing from a pool while host 1 is SIGKILLed.
        def blaster(start):
            i = start
            while not stop_blast.is_set() and i < start + 200:
                write(i)
                i += 1

        with futs.ThreadPoolExecutor(8) as ex:
            fs = [ex.submit(blaster, 1000 + 300 * w) for w in range(4)]
            time.sleep(1.0)
            cl.procs[1].kill()          # hard kill ONE host mid-traffic
            time.sleep(2.0)
            stop_blast.set()
            futs.wait(fs, timeout=60)
        n_acked = len(acked)
        cl.kill_all()                   # the survivor stalls: whole job

        # Full restart from the per-host WALs (a new process group).
        cl.start()
        cl.wait_up()
        missing = []
        for i, h in acked.items():
            try:
                if _get(cl.base(h), i % 4, f"k{i}")["node"]["value"] \
                        != f"v{i}":
                    missing.append(i)
            except OSError:
                missing.append(i)
        assert not missing, (
            f"{len(missing)}/{n_acked} ACKED writes lost after SIGKILL + "
            f"restart: {missing[:10]}")

        # Cross-host convergence: a write acked by host 0 is readable
        # from host 1.
        some = next(i for i, h in acked.items() if h == 0)
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                if (_get(cl.base(1), some % 4, f"k{some}")
                        ["node"]["value"] == f"v{some}"):
                    break
            except OSError:
                pass
            time.sleep(0.3)
        else:
            pytest.fail("cross-host convergence never happened")
        assert cl.terminate() == [0, 0]
        for line in cl.exit_lines():
            assert line["plane"] == "collective" and line["device"] == "cpu"
            assert line["backend"] == "gloo" and line["failed"] is None
            assert line["comm"]["all_to_all"]["calls"] > 0

    _run(cl, body)


def test_three_hosts_write_everywhere_and_converge(tmp_path):
    """N=3: every host takes writes for every group (two of three involve
    PROPOSE forwarding per group), all three converge on every value, and
    a restart preserves everything (per-host WAL replay at N>2).

    Its JAX counterpart (tests/test_hostengine.py) failed in the last
    tier-1 run of this repo, so this mirror has no passing reference on
    this box; its checks are the counterpart's, whole."""
    cl = Cluster(tmp_path, n=3, groups=6).start()

    def body():
        cl.wait_up()
        acked = {}
        for i in range(36):
            g, h = i % 6, i % 3
            if _put(cl.base(h), g, f"t{i}", f"w{i}")["action"] == "set":
                acked[i] = h
        assert len(acked) >= 30, f"only {len(acked)}/36 acked"

        deadline = time.time() + 30
        remaining = {(i, h) for i in acked for h in range(3)}
        while remaining and time.time() < deadline:
            for i, h in list(remaining):
                try:
                    if (_get(cl.base(h), i % 6, f"t{i}")
                            ["node"]["value"] == f"w{i}"):
                        remaining.discard((i, h))
                except OSError:
                    pass
            if remaining:
                time.sleep(0.3)
        assert not remaining, \
            f"{len(remaining)} (write, host) pairs never converged"

        cl.kill_all()
        cl.start()
        cl.wait_up()
        for i, h in acked.items():
            r = _get(cl.base(h), i % 6, f"t{i}")
            assert r["node"]["value"] == f"w{i}", (i, r)
        # Post-restart writes to every group via a different host than
        # before (payload catch-up after a restart must not starve).
        for g in range(6):
            r = _put(cl.base((g + 1) % 3), g, "after", f"a{g}", timeout=30)
            assert r["action"] == "set", (g, r)
        assert cl.terminate() == [0, 0, 0]

    _run(cl, body)


def test_payload_catchup_pull_path(tmp_path):
    """60% of outgoing payload fan-out frames are dropped (seeded), so the
    non-admitting host stalls its apply cursor on missing payloads and
    must repair via pull; writes still ack and both hosts converge."""
    cl = Cluster(tmp_path, n=2, groups=4,
                 extra_env={"MHE_DROP_PAY_PCT": "60",
                            "MHE_FAULT_SEED": "7",
                            "MHE_REQ_TIMEOUT": "30"}).start()

    def body():
        cl.wait_up()
        acked = {}
        for i in range(32):
            g, h = i % 4, i % 2
            try:
                r = _put(cl.base(h), g, f"p{i}", f"x{i}", timeout=35)
                if r["action"] == "set":
                    acked[i] = h
            except OSError:
                pass
        assert len(acked) >= 24, f"only {len(acked)}/32 acked under " \
                                 f"payload drops"
        deadline = time.time() + 45
        remaining = {(i, 1 - h) for i, h in acked.items()}
        while remaining and time.time() < deadline:
            for i, h in list(remaining):
                try:
                    if (_get(cl.base(h), i % 4, f"p{i}")
                            ["node"]["value"] == f"x{i}"):
                        remaining.discard((i, h))
                except OSError:
                    pass
            if remaining:
                time.sleep(0.3)
        assert not remaining, \
            f"{len(remaining)} dropped payloads never repaired"
        stats = [cl.status(h) for h in range(2)]
        assert sum(s["pay_frames_dropped"] for s in stats) > 0, stats
        assert sum(s["pulls_sent"] for s in stats) > 0, stats
        assert sum(s["payloads_pulled"] for s in stats) > 0, stats

    _run(cl, body)


def _wal_bytes(data, h):
    d = os.path.join(data, f"host{h}")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if f.startswith("engine-"))


def test_quorum_read_appends_nothing(tmp_path):
    """A quorum GET at the group's leader host takes the zero-append read
    plane: after the writes settle, a read-only phase of quorum GETs
    moves no host's WAL and serves the written values."""
    cl = Cluster(tmp_path, n=3, groups=4).start()

    def body():
        cl.wait_up()
        for g in range(4):
            assert _put(cl.base(g % 3), g, "k", f"v{g}")["action"] == "set"
        # Each group's leader host, as every host's status reports it.
        lead = None
        deadline = time.time() + 30
        while lead is None and time.time() < deadline:
            views = [{g: json.loads(urllib.request.urlopen(
                f"{cl.base(h)}/tenants/{g}/status", timeout=3).read()
            )["lead"] for g in range(4)} for h in range(3)]
            if all(v == views[0] for v in views) and \
                    all(x >= 0 for x in views[0].values()):
                lead = views[0]
            time.sleep(0.3)
        assert lead is not None, "leadership views never agreed"
        # Settle: the WAL stops moving once commit indexes converge.
        stable, last = 0, None
        deadline = time.time() + 30
        while stable < 6 and time.time() < deadline:
            now = [_wal_bytes(cl.data, h) for h in range(3)]
            stable = stable + 1 if now == last else 0
            last = now
            time.sleep(0.25)
        assert stable >= 6, "WAL never quiesced"
        for rep in range(3):
            for g in range(4):
                r = _get(cl.base(lead[g]), g, "k", quorum=True)
                assert r["node"]["value"] == f"v{g}", (g, r)
        time.sleep(1.0)   # a (wrong) append would reach the WAL by now
        assert [_wal_bytes(cl.data, h) for h in range(3)] == last, \
            "quorum reads appended WAL bytes"

    _run(cl, body)


def test_supervisor_restarts_the_job_after_sigkill(tmp_path):
    """A mirror of tests/test_multihost_recovery.py on the port's
    supervisor: one of three collective ranks is SIGKILLed, and the
    supervisor alone detects it, restarts every rank with a fresh
    MHE_COORD, and the job serves again with every acked write."""
    data = str(tmp_path)
    status_path = os.path.join(data, "supervisor.json")
    env = dict(os.environ, MHE_NHOSTS="3", MHE_GROUPS="4", MHE_DATA=data,
               MHE_STATUS=status_path, MHE_STALL_S="5.0",
               MHE_MAX_RECOVERIES="1", MHE_DEVICE="cpu", MHE_POLL_S="0.2")
    sup = subprocess.Popen(
        [sys.executable, "-m", "etcd_tpu_torch.tools.multihost_supervisor"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)

    def status():
        try:
            with open(status_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def wait(pred, what, timeout=60):
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = status()
            if st and pred(st):
                return st
            time.sleep(0.2)
        raise AssertionError(f"{what} not reached: {status()}")

    cl = Cluster(data, n=3, groups=4)
    try:
        st = wait(lambda s: s["state"] == "serving", "first generation")
        cl.http_ports = st["http_ports"]
        cl.wait_up()
        for g in range(4):
            assert _put(cl.base(g % 3), g, "pre", f"v{g}")["action"] == "set"
        os.kill(st["pids"]["1"], signal.SIGKILL)
        st = wait(lambda s: s["recoveries"] and s["state"] == "serving",
                  "recovery")
        rec = st["recoveries"][0]
        assert rec["ok"] and rec["cause"] == "rank-exit:1", rec
        assert st["generation"] == 2
        assert sup.wait(timeout=30) == 0     # MHE_MAX_RECOVERIES reached
        cl.wait_up()
        for g in range(4):
            assert _get(cl.base(0), g, "pre")["node"]["value"] == f"v{g}"
            assert _put(cl.base((g + 1) % 3), g, "post", "after")[
                "action"] == "set"
    except BaseException:
        cl.dump_logs()
        raise
    finally:
        if sup.poll() is None:
            sup.terminate()
            sup.wait(timeout=30)
        for pid in status().get("pids", {}).values():
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


def test_disk_loss_rejoin_through_snapshots(tmp_path):
    """A rank whose data dir is lost restarts empty, fenced by the
    supervisor's term floor (prepare_dirs), and catches up through the
    cross-host snapshot installs: every group's log runs past the ring
    window before the loss, so append repair cannot reach it."""
    import numpy as np

    from etcd_tpu_torch.tools import multihost_supervisor

    W = 8
    cl = Cluster(tmp_path, n=3, groups=4,
                 extra_env={"MHE_WINDOW": str(W)}).start()

    def body():
        cl.wait_up()
        for i in range(W + 4):
            for g in range(4):
                assert _put(cl.base(i % 3), g, f"deep{i}", f"d{i}")[
                    "action"] == "set"
        cl.kill_all()
        import shutil
        shutil.rmtree(os.path.join(cl.data, "host2"))
        sup = multihost_supervisor.Supervisor(
            3, 4, cl.data, os.path.join(cl.data, "s.json"), stall_s=5.0,
            poll_s=0.5)
        sup.prepare_dirs()
        with open(os.path.join(cl.data, "host2", "term_floor.json")) as f:
            floor = np.asarray(json.load(f)["term"])
        assert floor.shape == (4,) and (floor >= 1).all()
        cl.start()
        cl.wait_up()
        deadline = time.time() + 60
        want = {(g, f"deep{i}"): f"d{i}" for g in range(4)
                for i in range(W + 4)}
        while want and time.time() < deadline:
            for (g, k), v in list(want.items()):
                try:
                    if _get(cl.base(2), g, k)["node"]["value"] == v:
                        del want[(g, k)]
                except OSError:
                    pass
            time.sleep(0.3)
        assert not want, f"{len(want)} values never reached the empty rank"
        assert cl.status(2)["snaps_installed"] >= 4, cl.status(2)
        for g in range(4):
            assert _put(cl.base(2), g, "fresh", "f")["action"] == "set"

    _run(cl, body)
