"""The frames plane's kill step in a loop: a rank SIGKILLed while
clients write through the others, again and again, with each write's
time from the kill to its first ack.

`hosts` ranks of `python -m etcd_tpu_torch.tools.multihost_engine` on
the frames plane (MHE_WINDOW=16, MHE_MAX_ENTS=8, MHE_FSYNC=1, as
chip_smoke.py's multihost_frames phase runs them) serve `groups` groups
on `--device` ("cuda" unless asked for the CPU). Once every group is
led, each of `repeats` turns:

1. picks as victim the rank that leads the most of the `tenants`
   written groups (ties to the highest rank), as rank 0 sees them;
2. writes the key `killed` of every written group through the
   survivors, with a value of the turn's own (`kill_step`, which
   chip_smoke.py's multihost_frames phase runs as its kill step);
3. for a write that missed its deadline, prints the group's lead, term,
   commit and applied on every survivor and each survivor's catch-up
   counters (pulls sent, payloads pulled), twice, 5 s apart;
4. restarts the victim on its own data dir and waits until it serves
   every group and has applied what the survivors have; then says
   whether the stalled groups applied their writes on every survivor.

At the end each group's key is read back from the rank that acked its
last acked write, so an earlier turn's write applied late shows as
lost; a write that never acked may still have been applied. `busy`
processes that spin on the CPU load the host throughout.

    python -m etcd_tpu_torch.tools.frames_kill_loop [--device cpu]
        [--groups 100000] [--tenants 200] [--hosts 5] [--repeats 16]
        [--busy 0] [--out PATH]

One JSON line a turn on stdout, then a summary line: the count of
writes, of stalled writes, and the kill-to-ack seconds of every write
acked after its kill (p50, p90, p99, max). `--out` gets every time.
Exit 0 when every write acked, 1 when one did not or a step failed.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from etcd_tpu_torch.tools.launch import require_device
from etcd_tpu_torch.tools.multihost_supervisor import listen_ports

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORM = {"Content-Type": "application/x-www-form-urlencoded"}
ATTEMPT_S = 5.0      # a client's attempt at one write
DEADLINE_S = 180.0   # a write's time to ack through the kill


def _http(method, url, body=None, timeout=60):
    r = urllib.request.Request(url, data=body, method=method,
                               headers=FORM if body is not None else {})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            st, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        st, raw = e.code, e.read()
    return st, (json.loads(raw) if raw else None)


def _in_threads(fn, items, n_threads=100):
    errs = []

    def work(chunk):
        for it in chunk:
            try:
                fn(it)
            except Exception as e:  # noqa: BLE001 — returned to the caller
                errs.append((it, repr(e)))

    th = [threading.Thread(target=work, args=(items[i::n_threads],))
          for i in range(n_threads)]
    for t in th:
        t.start()
    for t in th:
        t.join()
    return errs


class Ranks:
    """`hosts` rank processes of the frames plane in one data dir."""

    def __init__(self, d, hosts, groups, device):
        self.d, self.hosts, self.groups = d, hosts, groups
        ports = listen_ports(2 * hosts)
        self.http, self.frames = ports[:hosts], ports[hosts:]
        self.bases = [f"http://127.0.0.1:{p}" for p in self.http]
        self.device = device
        self.procs = [None] * hosts

    def start(self, r):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(MHE_RANK=str(r), MHE_NHOSTS=str(self.hosts),
                   MHE_DATA=self.d, MHE_GROUPS=str(self.groups),
                   MHE_HTTP_PORTS=",".join(map(str, self.http)),
                   MHE_FRAME_PORTS=",".join(map(str, self.frames)),
                   MHE_WINDOW="16", MHE_MAX_ENTS="8", MHE_FSYNC="1",
                   MHE_PLANE="frames", MHE_DEVICE=self.device)
        with open(os.path.join(self.d, f"rank{r}.err"), "ab") as err:
            self.procs[r] = subprocess.Popen(
                [sys.executable, "-m",
                 "etcd_tpu_torch.tools.multihost_engine"],
                cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=err)

    def status(self, r, deadline_s=600.0, led=False, applied=None):
        """Rank r's /engine/status once it answers (and, with `led`,
        every group has a leader; with `applied`, its applied_total has
        reached it)."""
        t_end = time.monotonic() + deadline_s
        while True:
            if self.procs[r].poll() is not None:
                raise RuntimeError(f"rank {r} exited "
                                   f"rc={self.procs[r].returncode}")
            try:
                st, body = _http("GET", self.bases[r] + "/engine/status",
                                 timeout=30)
                if st == 200 and (not led or body["groups_with_leader"]
                                  == self.groups) and (
                        applied is None or body["applied_total"] >= applied):
                    return body
            except OSError:
                pass
            if time.monotonic() > t_end:
                raise RuntimeError(f"rank {r}: status not reached")
            time.sleep(0.5)

    def group(self, r, g):
        return _group(self.bases[r], g)

    def evidence(self, ranks, gs):
        """Each group's consensus status and each rank's catch-up
        counters, or the error that asking met."""
        out = {"groups": {g: statuses(self.bases, ranks, g) for g in gs},
               "ranks": {}}
        for r in ranks:
            try:
                st = _http("GET", self.bases[r] + "/engine/status",
                           timeout=30)[1]
                out["ranks"][r] = {k: st.get(k) for k in (
                    "round", "round_ms_ewma", "pulls_sent",
                    "payloads_pulled", "snaps_sent", "snaps_installed")}
            except Exception as e:  # noqa: BLE001 — evidence
                out["ranks"][r] = repr(e)
        return out

    def stop(self):
        for p in self.procs:
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=120))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        return rcs


def _group(base, g):
    st = _http("GET", f"{base}/tenants/{g}/status", timeout=10)[1]
    return {k: st.get(k) for k in ("lead", "term", "commit", "applied")}


def statuses(bases, ranks, g):
    """Group g's consensus status (lead, term, commit, applied) on each
    of `ranks`, or the error that asking met: a stall's evidence."""
    out = {}
    for r in ranks:
        try:
            out[r] = _group(bases[r], g)
        except Exception as e:  # noqa: BLE001 — evidence, not a check
            out[r] = repr(e)
    return out


def kill_step(bases, victim, survivors, gs, value, acked, on_kill=None):
    """The key `killed` of every group of `gs` written through the
    survivors (group g's through survivors[g % len(survivors)]) from 100
    threads, each write retried in ATTEMPT_S attempts until it acks or
    DEADLINE_S passes, while `victim` (a rank's process) is SIGKILLed
    once a tenth of them have acked; `on_kill(t)` runs at the kill, t
    its perf_counter time. An acked write of g goes into `acked` as
    (g, "killed") -> (value(g), the rank that acked it). Returns
    ({g: its first ack's perf_counter time}, the kill's time, {g: the
    last answer of a write that never acked}, {g: its attempts})."""
    first_ack, attempts, last, t_kill = {}, {}, {}, []
    killed = threading.Event()

    def put_through(g):
        r = survivors[g % len(survivors)]
        end = time.monotonic() + DEADLINE_S
        n = 0
        while True:
            n += 1
            try:
                st, body = _http("PUT", f"{bases[r]}/tenants/{g}/v2/keys/"
                                 "killed", f"value={value(g)}".encode(),
                                 timeout=ATTEMPT_S)
                if st in (200, 201):
                    first_ack[g] = time.perf_counter()
                    attempts[g] = n
                    acked[(g, "killed")] = (value(g), r)
                    return
                last[g] = (st, body)
            except OSError as e:
                last[g] = repr(e)
            if time.monotonic() > end:
                attempts[g] = n
                return
            time.sleep(0.05)

    def kill():
        while len(first_ack) < len(gs) // 10:
            time.sleep(0.01)
        victim.send_signal(signal.SIGKILL)
        t_kill.append(time.perf_counter())
        if on_kill is not None:
            on_kill(t_kill[0])
        victim.wait(timeout=60)
        killed.set()

    threading.Thread(target=kill, daemon=True).start()
    errs = _in_threads(put_through, gs)
    if errs or not killed.wait(60):
        raise RuntimeError(f"the kill step failed: {errs[:5]}, "
                           f"killed {killed.is_set()}")
    return (first_ack, t_kill[0],
            {g: last.get(g) for g in gs if g not in first_ack}, attempts)


def turn(ranks, gs, n, acked):
    """Turn n of the loop: the victim chosen, the kill step, a stall's
    evidence and the victim's rejoin; the turn's record."""
    lead0 = {g: ranks.group(0, g)["lead"] for g in gs}
    counts = [sum(1 for g in gs if lead0[g] == r)
              for r in range(ranks.hosts)]
    victim = max(range(ranks.hosts), key=lambda r: (counts[r], r))
    survivors = [r for r in range(ranks.hosts) if r != victim]
    t0 = time.perf_counter()
    first_ack, t_kill, stalled, attempts = kill_step(
        ranks.bases, ranks.procs[victim], survivors, gs,
        lambda g: f"k{n}-{g}", acked)
    stalled = sorted(stalled)
    rec = {"turn": n, "victim": victim, "victim_led": counts[victim],
           "writes": len(gs), "acked": len(first_ack),
           "stalled": stalled,
           "kill_to_ack_s": sorted(t - t_kill for t in first_ack.values()
                                   if t > t_kill),
           "attempts_max": max(attempts.values(), default=0),
           "step_s": time.perf_counter() - t0}
    if stalled:
        rec["evidence"] = [ranks.evidence(survivors, stalled[:8])]
        time.sleep(5.0)
        rec["evidence"].append(ranks.evidence(survivors, stalled[:8]))
    # The victim back on its own data dir, serving and caught up.
    t1 = time.perf_counter()
    want = max(ranks.status(r)["applied_total"] for r in survivors)
    ranks.start(victim)
    ranks.status(victim, led=True, applied=want)
    rec["rejoin_s"] = time.perf_counter() - t1
    if stalled:
        sts = [ranks.group(r, g) for g in stalled for r in survivors]
        rec["stalled_applied_after_rejoin"] = all(
            st["applied"] >= st["commit"] for st in sts)
    return rec


def _pct(xs):
    if not xs:
        return None
    a = np.asarray(xs)
    return {"n": len(xs), "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--groups", type=int, default=100_000)
    ap.add_argument("--tenants", type=int, default=200)
    ap.add_argument("--hosts", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=16)
    ap.add_argument("--busy", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    require_device(a.device, "pass --device cpu")
    card = None
    if a.device != "cpu":
        from etcd_tpu_torch.ops import cuda_build
        cuda_build.build("ring_resolve")   # once, before the ranks start
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    hosts, groups = a.hosts, a.groups
    step = max(groups // a.tenants, 1)
    gs = [(i * step - i * step % hosts + i % hosts) % groups
          for i in range(a.tenants)]
    busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(a.busy)]
    turns, acked, ok = [], {}, True
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="frames-kill-loop-") as d:
        ranks = Ranks(d, hosts, groups, a.device)
        try:
            for r in range(hosts):
                ranks.start(r)
            for r in range(hosts):
                ranks.status(r, led=True)
            boot_s = time.perf_counter() - t0
            for n in range(a.repeats):
                rec = turn(ranks, gs, n, acked)
                turns.append(rec)
                ok &= not rec["stalled"]
                print(json.dumps({k: v for k, v in rec.items()
                                  if k != "kill_to_ack_s"}
                                 | {"kill_to_ack_s": _pct(
                                     rec["kill_to_ack_s"])}), flush=True)
            lost = []

            def get(item):
                (g, key), (val, r) = item
                st, body = _http("GET", f"{ranks.bases[r]}/tenants/{g}/v2/"
                                 f"keys/{key}")
                if st != 200 or body["node"]["value"] != val:
                    lost.append((g, r, st))

            _in_threads(get, list(acked.items()))
            rcs = ranks.stop()
        except BaseException:
            ok = False
            for r in range(hosts):
                with open(os.path.join(d, f"rank{r}.err"), "rb") as f:
                    print(f"== rank {r}\n" + f.read()[-3000:].decode(
                        errors="replace"), file=sys.stderr)
            raise
        finally:
            for p in busy:
                p.kill()
                p.wait()
            for p in ranks.procs:
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()
    times = [t for rec in turns for t in rec["kill_to_ack_s"]]
    summary = {"groups": groups, "hosts": hosts, "tenants": a.tenants,
               "device": a.device, "card": card, "busy_loops": a.busy,
               "attempt_s": ATTEMPT_S, "deadline_s": DEADLINE_S,
               "turns": len(turns),
               "writes": sum(rec["writes"] for rec in turns),
               "stalled": sum(len(rec["stalled"]) for rec in turns),
               "turns_with_a_stall": sum(1 for rec in turns
                                         if rec["stalled"]),
               "kill_to_ack_s": _pct(times),
               "attempts_max": max((rec["attempts_max"] for rec in turns),
                                   default=0),
               "rejoin_s_max": max((rec["rejoin_s"] for rec in turns),
                                   default=None),
               "boot_s": boot_s, "read_back": len(acked),
               "lost": lost[:5], "rcs": rcs,
               "seconds": time.perf_counter() - t0}
    ok &= not lost and rcs == [0] * hosts
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"summary": summary, "turns": turns}, f)
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
