"""The port's rank launcher (python -m etcd_tpu_torch.tools
.multihost_engine) as separate processes on the CPU (MHE_DEVICE=cpu), in
the spirit of tests/test_hostengine.py's kill test, on the frames plane:
clients ack writes against two of three ranks while one of them is
SIGKILLed mid-traffic; the survivors keep acking; the killed rank
restarts alone on its own data dir, and every acked write reads back
from the rank that acked it (acks fire only after the acker's own fsync
+ apply)."""
import concurrent.futures as futs
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "etcd_tpu_torch.tools.multihost_engine"
G = 4


def _free_port():
    """A free TCP port below the kernel's ephemeral range: a port taken
    by bind(0) would be ephemeral, and any connection or bind(0) on the
    box (other tests' HTTP clients and gloo pairs) could take it between
    this choice and the rank's own bind."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        lo = 32768
    for _ in range(1000):
        port = random.randrange(10000, lo)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port below the ephemeral range")


class Ranks:
    def __init__(self, data, n=3, extra_env=None):
        self.data, self.n = str(data), n
        self.extra_env = extra_env or {}
        self.http_ports = [_free_port() for _ in range(n)]
        self.frame_ports = [_free_port() for _ in range(n)]
        self.procs = [None] * n
        self.logs = [os.path.join(self.data, f"rank{r}.log")
                     for r in range(n)]

    def start(self, r):
        env = dict(os.environ, MHE_RANK=str(r), MHE_NHOSTS=str(self.n),
                   MHE_DATA=self.data, MHE_GROUPS=str(G),
                   MHE_HTTP_PORTS=",".join(map(str, self.http_ports)),
                   MHE_FRAME_PORTS=",".join(map(str, self.frame_ports)),
                   MHE_PLANE="frames", MHE_DEVICE="cpu",
                   MHE_ROUND_INTERVAL="0.01", **self.extra_env)
        with open(self.logs[r], "ab") as logf:
            self.procs[r] = subprocess.Popen(
                [sys.executable, "-m", MODULE], cwd=REPO, env=env,
                stdout=logf, stderr=subprocess.STDOUT)

    def base(self, r):
        return f"http://127.0.0.1:{self.http_ports[r]}"

    def status(self, r, timeout=3):
        return json.loads(urllib.request.urlopen(
            self.base(r) + "/engine/status", timeout=timeout).read())

    def dump_logs(self):
        for path in self.logs:
            if os.path.exists(path):
                with open(path, errors="replace") as f:
                    print(f"\n===== {path} =====\n{f.read()[-4000:]}",
                          file=sys.stderr)

    def wait_up(self, ranks, timeout=180):
        deadline = time.time() + timeout
        for r in ranks:
            while True:
                if self.procs[r].poll() is not None:
                    raise AssertionError(f"rank {r} died rc="
                                         f"{self.procs[r].returncode}")
                try:
                    if self.status(r)["groups_with_leader"] == G:
                        break
                except OSError:
                    pass
                if time.time() > deadline:
                    raise AssertionError(f"rank {r} never led every group")
                time.sleep(0.3)

    def kill_all(self):
        for p in self.procs:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    def terminate(self):
        for p in self.procs:
            p.send_signal(signal.SIGTERM)
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=30))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        return rcs


def _put(base, g, k, v, timeout=20):
    req = urllib.request.Request(
        f"{base}/tenants/{g}/v2/keys/{k}", f"value={v}".encode(),
        method="PUT",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def _get(base, g, k, timeout=10):
    return json.loads(urllib.request.urlopen(
        f"{base}/tenants/{g}/v2/keys/{k}", timeout=timeout).read())


def test_ranks_serve_and_survive_sigkill_of_one(tmp_path):
    cl = Ranks(tmp_path)
    try:
        for r in range(3):
            cl.start(r)
        cl.wait_up(range(3))

        acked = {}            # i -> the rank that acked write k{i}
        ack_times = []
        lock = threading.Lock()

        def write(i, r):
            try:
                if _put(cl.base(r), i % G, f"k{i}", f"v{i}")["action"] \
                        == "set":
                    with lock:
                        acked[i] = r
                        ack_times.append((time.time(), r))
            except OSError:
                pass

        # Phase 1: writes against ranks 0 and 1, most forwarded to the
        # group's leader on another rank.
        for i in range(16):
            write(i, i % 2)
        assert len(acked) >= 12, f"only {len(acked)} of 16 acked"

        # Phase 2: keep writing against both while rank 1 is SIGKILLed.
        stop = threading.Event()

        def blaster(start, r):
            i = start
            while not stop.is_set() and i < start + 400:
                write(i, r)
                i += 1

        with futs.ThreadPoolExecutor(4) as ex:
            fs = [ex.submit(blaster, 1000 + 500 * w, w % 2)
                  for w in range(4)]
            time.sleep(1.5)
            cl.procs[1].kill()
            cl.procs[1].wait()
            t_kill = time.time()
            # The survivors keep acking: writes at rank 0 land after the
            # kill, through the groups' re-elections among ranks 0 and 2.
            deadline = t_kill + 60
            while time.time() < deadline:
                with lock:
                    after = sum(1 for t, r in ack_times
                                if t > t_kill + 0.5 and r == 0)
                if after >= 2 * G:
                    break
                time.sleep(0.2)
            stop.set()
            futs.wait(fs, timeout=120)
        assert after >= 2 * G, f"only {after} acks after the kill"

        # Phase 3: the killed rank restarts alone on its own data dir.
        cl.start(1)
        cl.wait_up([1])
        missing = []
        for i, r in sorted(acked.items()):
            try:
                if _get(cl.base(r), i % G, f"k{i}")["node"]["value"] \
                        != f"v{i}":
                    missing.append(i)
            except OSError:
                missing.append(i)
        assert not missing, (f"{len(missing)}/{len(acked)} acked writes "
                             f"lost: {missing[:10]}")
        assert any(r == 1 for r in acked.values())
        rcs = cl.terminate()
        assert rcs == [0, 0, 0], rcs
        for path in cl.logs:
            with open(path) as f:
                lines = [json.loads(ln) for ln in f
                         if ln.startswith('{"rank"')]
            assert lines and lines[-1]["device"] == "cpu", (path, lines)
    except BaseException:
        cl.dump_logs()
        raise
    finally:
        cl.kill_all()


def test_collective_plane_is_refused(tmp_path):
    """The collective plane is no longer refused: one rank with
    MHE_PLANE=collective boots on the CPU on a one-rank gloo process
    group (MHE_COORD), leads every group, acks a write, and on SIGTERM
    shuts down with rc 0 and its exit line."""
    env = dict(os.environ, MHE_RANK="0", MHE_NHOSTS="1",
               MHE_DATA=str(tmp_path), MHE_HTTP_PORTS=str(_free_port()),
               MHE_FRAME_PORTS=str(_free_port()), MHE_PLANE="collective",
               MHE_COORD=f"127.0.0.1:{_free_port()}", MHE_BACKEND="gloo",
               MHE_DEVICE="cpu", MHE_GROUPS=str(G))
    log_path = tmp_path / "rank0.log"
    base = f"http://127.0.0.1:{env['MHE_HTTP_PORTS']}"
    with open(log_path, "ab") as logf:
        proc = subprocess.Popen([sys.executable, "-m", MODULE], cwd=REPO,
                                env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 60
        while True:
            assert proc.poll() is None, log_path.read_text()
            try:
                if json.loads(urllib.request.urlopen(
                        base + "/engine/status", timeout=3).read()
                        )["groups_with_leader"] == G:
                    break
            except OSError:
                pass
            assert time.time() < deadline, log_path.read_text()
            time.sleep(0.2)
        assert _put(base, 1, "c", "one")["action"] == "set"
        assert _get(base, 1, "c")["node"]["value"] == "one"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, log_path.read_text()
        out = log_path.read_text()
        line = json.loads([ln for ln in out.splitlines()
                           if ln.startswith('{"rank"')][-1])
        assert line["plane"] == "collective" and line["backend"] == "gloo"
        assert line["failed"] is None and line["device"] == "cpu"
        assert "Traceback" not in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
