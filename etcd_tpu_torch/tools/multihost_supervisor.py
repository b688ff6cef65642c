"""Supervisor for the multi-host engine: automatic failure detection,
whole-job restart, per-host WAL replay, and a measured MTTR.

The launcher is `python -m etcd_tpu_torch.tools.multihost_engine`
(server/hostengine.py). On the collective plane one dead rank stalls the
whole job's collective; on the frames plane ranks fail independently and
survivors keep serving. Either way this supervisor treats a rank exit or
a frozen round counter as a job failure: it SIGKILLs the whole job,
respawns every rank on its own data dir (per-host WAL replay restores
every acked write) with a fresh MHE_COORD (a new TCPStore address, so a
generation never meets the last one's process group), and records the
detect->serving wall time.
Before a respawn, `prepare_dirs` writes the term floor that fences a rank
whose data dir was lost (see its docstring and
HostEngine._load_term_floor).

Status file (MHE_STATUS, JSON, rewritten atomically):
    {"pids": {rank: pid}, "http_ports": [...], "state": "serving"|...,
     "generation": N, "recoveries": [
        {"detect_s": ..., "restart_s": ..., "total_s": ...,
         "cause": "rank-exit"|"round-stall"}]}

Usage:
    MHE_NHOSTS=3 MHE_GROUPS=8 MHE_STATUS=/tmp/sup.json \
        python -m etcd_tpu_torch.tools.multihost_supervisor
Env knobs: MHE_STALL_S (6.0) poll window with no round progress that
declares a stall; MHE_POLL_S (0.5); MHE_MAX_RECOVERIES (unbounded); the
ranks read the launcher's MHE_* variables (MHE_PLANE, MHE_BACKEND and
MHE_DEVICE among them).
"""
import json
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANK_MODULE = "etcd_tpu_torch.tools.multihost_engine"


def listen_ports(n: int) -> list:
    """n distinct ports free to listen on, below the kernel's ephemeral
    range. A rank keeps its ports across respawns; a port from the
    ephemeral range can meanwhile become the local end of some outbound
    connection, and the respawned rank then fails to bind it."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    span = range(1024, low)
    socks = []
    try:
        for p in random.sample(span, len(span)):
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", p))
            except OSError:
                s.close()
                continue
            socks.append(s)
            if len(socks) == n:
                return [s.getsockname()[1] for s in socks]
        raise OSError(f"fewer than {n} free ports")
    finally:
        for s in socks:
            s.close()


def get_status(port: int, timeout: float = 2.0):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/engine/status",
                timeout=timeout) as r:
            return json.loads(r.read())
    except Exception:  # noqa: BLE001 — any failure counts as unreachable
        return None


class Supervisor:
    def __init__(self, n: int, groups: int, data: str, status_path: str,
                 stall_s: float, poll_s: float) -> None:
        self.n = n
        self.groups = groups
        self.data = data
        self.status_path = status_path
        self.stall_s = stall_s
        self.poll_s = poll_s
        ports = listen_ports(2 * n)
        self.http_ports, self.frame_ports = ports[:n], ports[n:]
        self.procs: list = []
        self.generation = 0
        self.recoveries: list = []
        self.state = "starting"

    # -- lifecycle ---------------------------------------------------------

    def prepare_dirs(self) -> None:
        """Degraded restart: if some rank's data dir vanished with its
        machine while survivors still hold WAL data, write a per-group
        TERM FLOOR of (elementwise max of every survivor's recorded
        terms) + 1 into a fresh dir for it. The respawned rank boots at
        the floor with a clear vote, so the EARLIEST term at which it can
        grant a vote is the floor itself. No pre-crash election can have
        COMPLETED at any term >= floor: completing a quorum in an N=3
        mesh needs a durable grant on at least one survivor (per-host
        round records fsync term and log diffs atomically), and every
        survivor's durable term is <= floor-1 by construction. A vote
        the dead incarnation cast at >= floor can only have been its own
        self-vote, which can never complete a quorum now that the
        incarnation is gone. The +1 closes the boundary race where one
        survivor durably recorded an election at exactly max(survivor
        terms) — won pre-crash with the dead host's now-lost grant —
        while a lagging survivor (unsynchronized per-round fsyncs) still
        reads one term lower, re-campaigns at exactly that term, and the
        empty host's grant would seat a second leader at the same term.
        The empty rank rejoins as a follower and catches up through the
        engines' cross-host snapshot-install path
        (hostengine._send_snapshots)."""
        dirs = [os.path.join(self.data, f"host{r}") for r in range(self.n)]

        def has_data(d):
            if not os.path.isdir(d):
                return False
            return any(n.startswith(("engine-", "checkpoint-"))
                       for n in os.listdir(d))

        has = [has_data(d) for d in dirs]
        if all(has) or not any(has):
            return
        import numpy as np
        from etcd_tpu_torch.server.enginewal import load_terms
        floor = None
        for d, h in zip(dirs, has):
            if h:
                t = load_terms(d, self.groups)
                floor = t if floor is None else np.maximum(floor, t)
        # +1: fence the boundary term (see docstring) — the rebooted empty
        # host must not be able to grant at a term where a pre-crash
        # election may have completed.
        floor = floor + 1
        for r, (d, h) in enumerate(zip(dirs, has)):
            if h:
                continue
            os.makedirs(d, exist_ok=True)
            tmp = os.path.join(d, "term_floor.json.tmp")
            with open(tmp, "w") as f:
                json.dump({"term": [int(x) for x in floor]}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(d, "term_floor.json"))
            print(f"supervisor: rank {r} data dir is empty — wrote term "
                  f"floor (max {int(floor.max(initial=0))}) from "
                  f"survivors for a degraded restart", flush=True)

    def spawn(self) -> None:
        self.prepare_dirs()
        coord = f"127.0.0.1:{listen_ports(1)[0]}"
        self.generation += 1
        self.procs = []
        self._logfs = []
        for r in range(self.n):
            env = dict(os.environ,
                       MHE_RANK=str(r), MHE_NHOSTS=str(self.n),
                       MHE_COORD=coord, MHE_DATA=self.data,
                       MHE_GROUPS=str(self.groups),
                       MHE_HTTP_PORTS=",".join(map(str, self.http_ports)),
                       MHE_FRAME_PORTS=",".join(map(str, self.frame_ports)))
            log_path = os.path.join(
                self.data, f"rank{r}.gen{self.generation}.log")
            logf = open(log_path, "ab")
            self._logfs.append(logf)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", RANK_MODULE], cwd=REPO, env=env,
                stdout=logf, stderr=subprocess.STDOUT))
        self.write_status()

    def kill_all(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        # Close the dead generation's log handles — an unbounded-recovery
        # supervisor must not leak N fds per restart.
        for f in getattr(self, "_logfs", []):
            try:
                f.close()
            except OSError:
                pass
        self._logfs = []

    def wait_serving(self, deadline: float) -> bool:
        """All ranks answer /engine/status AND their round counters
        advance between two polls (proof every round loop is live)."""
        last = [None] * self.n
        while time.time() < deadline:
            sts = [get_status(p) for p in self.http_ports]
            if all(s is not None for s in sts):
                if all(last[i] is not None
                       and sts[i]["round"] > last[i] for i in range(self.n)):
                    return True
                last = [s["round"] for s in sts]
            time.sleep(self.poll_s)
        return False

    # -- monitoring --------------------------------------------------------

    def monitor(self) -> str:
        """Block until a failure is detected; returns the cause."""
        last_round = [None] * self.n
        last_adv = time.time()
        while True:
            for i, p in enumerate(self.procs):
                if p.poll() is not None:
                    return f"rank-exit:{i}"
            sts = [get_status(p) for p in self.http_ports]
            advanced = False
            for i, s in enumerate(sts):
                if s is not None and (last_round[i] is None
                                      or s["round"] > last_round[i]):
                    last_round[i] = s["round"]
                    advanced = True
            if advanced:
                last_adv = time.time()
            elif time.time() - last_adv > self.stall_s:
                return "round-stall"
            time.sleep(self.poll_s)

    def write_status(self) -> None:
        st = {"pids": {i: p.pid for i, p in enumerate(self.procs)},
              "http_ports": self.http_ports,
              "frame_ports": self.frame_ports,
              "data": self.data,
              "state": self.state,
              "generation": self.generation,
              "recoveries": self.recoveries}
        tmp = self.status_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(st, f)
        os.replace(tmp, self.status_path)

    # -- main loop ---------------------------------------------------------

    def run(self, max_recoveries: int) -> int:
        self.spawn()
        if not self.wait_serving(time.time() + 180):
            print("supervisor: initial boot never became healthy",
                  flush=True)
            self.kill_all()
            return 1
        self.state = "serving"
        self.write_status()
        print(f"supervisor: {self.n} ranks serving "
              f"(http {self.http_ports})", flush=True)
        while True:
            cause = self.monitor()
            t_detect = time.time()
            print(f"supervisor: failure detected ({cause}); "
                  f"restarting job", flush=True)
            self.state = "recovering"
            self.write_status()
            self.kill_all()
            t_killed = time.time()
            self.spawn()
            ok = self.wait_serving(time.time() + 180)
            t_up = time.time()
            rec = {"cause": cause,
                   "detect_to_killed_s": round(t_killed - t_detect, 3),
                   "restart_s": round(t_up - t_killed, 3),
                   "total_s": round(t_up - t_detect, 3),
                   "ok": ok}
            self.recoveries.append(rec)
            self.state = "serving" if ok else "failed"
            self.write_status()
            print(f"supervisor: recovery {rec}", flush=True)
            if not ok:
                self.kill_all()
                return 1
            if max_recoveries and len(self.recoveries) >= max_recoveries:
                return 0


def main() -> int:
    n = int(os.environ.get("MHE_NHOSTS", "3"))
    groups = int(os.environ.get("MHE_GROUPS", "8"))
    data = os.environ.get("MHE_DATA") or tempfile.mkdtemp(prefix="mhe-sup-")
    status = os.environ.get("MHE_STATUS",
                            os.path.join(data, "supervisor.json"))
    stall_s = float(os.environ.get("MHE_STALL_S", "6.0"))
    poll_s = float(os.environ.get("MHE_POLL_S", "0.5"))
    max_rec = int(os.environ.get("MHE_MAX_RECOVERIES", "0"))
    sup = Supervisor(n, groups, data, status, stall_s, poll_s)

    def on_term(signum, frame):
        sup.kill_all()
        sys.exit(0)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    print(f"supervisor: status file {status}", flush=True)
    return sup.run(max_rec)


if __name__ == "__main__":
    sys.exit(main())
