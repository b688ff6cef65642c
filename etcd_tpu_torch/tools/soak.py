"""Randomized soak campaigns, seeded and replayable: a failing seed is a
reproducer to pin as a regression test.

    python -m etcd_tpu_torch.tools.soak kernel [n] [meta_seed]
        n random-fault-mix schedules of `ops/oracle.py::run_equivalence`
        (default 200): the round with `ring_resolve` against the scalar
        Raft after every round
    python -m etcd_tpu_torch.tools.soak engine [n] [meta_seed]
        n conf-churn + partition + crash-restart MultiEngine campaigns
        (default 3); every acked write must survive
    python -m etcd_tpu_torch.tools.soak hostengine [n] [meta_seed]
        n multi-host campaigns (default 2): 2-3 collective rank processes
        with seeded payload-frame drops, a rank SIGKILLed mid-traffic and
        a whole-job restart; every acked write must be served by the host
        that acked it
    python -m etcd_tpu_torch.tools.soak all [n] [meta_seed]
        the three, each at its own default count (n applies to kernel)

Every mode runs on --device: "cuda" (the card) unless the caller asks for
"cpu". Without a meta seed every invocation replays the same campaign
seeds. A liveness-floor failure under a very harsh mix is usually
election starvation (the kernel mode re-runs the schedule with floor 0,
which must pass, and counts it as starved); a per-round equivalence
failure is a real bug.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

from etcd_tpu_torch.tools.launch import ROOT, child_env, free_ports, \
    require_device


def soak_kernel(n: int, meta_seed: int = 0, device="cuda") -> dict:
    from etcd_tpu_torch.ops.oracle import run_equivalence

    meta = np.random.RandomState(meta_seed)
    t0 = time.time()
    starved = 0
    for k in range(n):
        seed = int(meta.randint(1, 1 << 30))
        kw = dict(seed=seed,
                  drop_p=float(meta.uniform(0.05, 0.55)),
                  delay_p=float(meta.uniform(0.0, 0.35)),
                  tick_p=float(meta.choice([1.0, 0.9, 0.7, 0.5])),
                  partition_every=int(meta.choice([25, 40, 55, 70])),
                  partition_len=int(meta.choice([8, 12, 18])),
                  rounds=160, device=device)
        try:
            run_equivalence(min_live_groups=3, **kw)
        except AssertionError:
            # Starvation or divergence: the floor-0 re-run must pass
            # (equivalence holds every round), or it is a real bug.
            run_equivalence(min_live_groups=0, **kw)
            starved += 1
        if (k + 1) % 100 == 0:
            print(f"kernel {k + 1}/{n} ({time.time() - t0:.0f}s)",
                  flush=True)
    secs = time.time() - t0
    print(f"kernel soak OK: {n} schedules, {starved} starvation-only "
          f"floor trips, zero divergences ({secs:.0f}s)", flush=True)
    return {"schedules": n, "starved": starved, "seconds": secs,
            "meta_seed": meta_seed}


# -- the engine campaigns' helpers: rounds run on this thread, blocking
#    requests on side threads ------------------------------------------

def _run_until(eng, pred, max_rounds=400, msg="condition"):
    for _ in range(max_rounds):
        if pred():
            return
        eng.run_round()
    raise AssertionError(f"{msg} not reached in {max_rounds} rounds")


def _drive_conf(eng, g, op, slot, max_rounds=600, timeout=30.0):
    """Propose a conf change from a side thread while driving rounds;
    returns the new slot list (raises unless the change settled)."""
    res = {}

    def work():
        try:
            res["res"] = eng.conf_change(g, op, slot, timeout=timeout)
        except Exception as e:  # noqa: BLE001 — raised below
            res["err"] = e

    th = threading.Thread(target=work, daemon=True)
    th.start()
    for _ in range(max_rounds):
        if not th.is_alive():
            break
        eng.run_round()
        th.join(timeout=0.001)
    th.join(1.0)
    if "err" in res:
        raise res["err"]
    if "res" not in res:
        raise AssertionError(f"conf {op} slot {slot} never settled")
    return res["res"]


def _partition_mask(G, P, rng, prob=0.4):
    """Fully partition one random slot in ~prob of the groups: a
    (G, P, P, 1) 0/1 mask for eng.drop_mask, or None if nothing was cut."""
    m_to = np.ones((G, P, 1, 1), np.int32)
    m_from = np.ones((G, 1, P, 1), np.int32)
    any_cut = False
    for g in range(G):
        if rng.rand() < prob:
            s = rng.randint(P)
            m_to[g, s] = 0
            m_from[g, 0, s] = 0
            any_cut = True
    return m_to * m_from if any_cut else None


def _put_async(eng, g, key, val):
    """A blocking do() on a side thread, so this one can drive rounds."""
    from etcd_tpu_torch.server.request import Request
    out = {}

    def work():
        try:
            out["res"] = eng.do(g, Request(method="PUT", path=key, val=val))
        except Exception as e:  # noqa: BLE001 — raised by _settle
            out["err"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t, out


def _settle(eng, t, out, max_rounds=500):
    for _ in range(max_rounds):
        if not t.is_alive():
            break
        eng.run_round()
        t.join(timeout=0.001)
    t.join(timeout=1.0)
    if "err" in out:
        raise out["err"]
    if "res" not in out:
        raise AssertionError("request did not complete")
    return out["res"]


def soak_engine(n_seeds: int, meta_seed: int = 0, device="cuda") -> None:
    import tempfile

    from etcd_tpu_torch import errors
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from etcd_tpu_torch.server.request import Request

    meta = np.random.RandomState(meta_seed)
    for k in range(n_seeds):
        seed = int(meta.randint(1, 1 << 30))
        rng = np.random.RandomState(seed)
        # Small windows push partition/restart recovery onto the
        # snapshot-install path instead of plain appends; fixed per seed
        # (geometry is persisted per data dir).
        window = int(rng.choice([8, 16]))
        acked = {}
        with tempfile.TemporaryDirectory() as d:
            def mk():
                return MultiEngine(EngineConfig(
                    groups=4, peers=5, window=window, max_ents=4,
                    heartbeat_tick=3, data_dir=d, fsync=False,
                    request_timeout=60.0, initial_peers=3, device=device))

            eng = mk()
            G, P = eng.cfg.groups, eng.cfg.peers
            _run_until(eng, lambda: all(eng.leader_slot(g) >= 0
                                        for g in range(G)), msg="leaders")
            for restart in range(2):
                for ep in range(4):
                    g = rng.randint(G)
                    active = list(np.nonzero(eng.h_mask[g])[0])
                    grow = (len(active) <= 2
                            or (len(active) < P and rng.rand() < 0.5))
                    if grow:
                        free = [s for s in range(P) if s not in active]
                        _drive_conf(eng, g, "add", int(rng.choice(free)))
                    else:
                        _drive_conf(eng, g, "remove",
                                    int(rng.choice(active)))
                    eng.drop_mask = _partition_mask(G, P, rng)
                    outs = []
                    for w in range(5):
                        gg = rng.randint(G)
                        key = f"/soak/{restart}_{ep}_{w}"
                        t, out = _put_async(eng, gg, key, "v")
                        outs.append((t, out, key, gg))
                    for t, out, key, gg in outs:
                        try:
                            _settle(eng, t, out, max_rounds=800)
                        except (AssertionError, errors.EtcdError):
                            continue
                        acked[key] = gg
                    eng.drop_mask = None
                    for _ in range(10):
                        eng.run_round()
                eng.stop()
                if restart < 1:
                    eng = mk()
                    _run_until(eng, lambda: all(eng.leader_slot(g) >= 0
                                                for g in range(G)),
                               max_rounds=900, msg="post-restart")
            eng2 = mk()
            lost = []
            for key, gg in acked.items():
                try:
                    if eng2.do(gg, Request(method="GET", path=key)
                               ).node.value != "v":
                        lost.append(key)
                except errors.EtcdError:
                    lost.append(key)
            eng2.stop()
            if lost:
                raise AssertionError(f"seed {seed}: ACKED WRITES LOST "
                                     f"{lost[:5]}")
        print(f"engine seed {seed}: {len(acked)} acked, zero lost",
              flush=True)
    print(f"engine soak OK: {n_seeds} campaigns, zero acked writes lost",
          flush=True)


# -- the host-engine campaigns' cluster: collective rank processes of
#    tools.multihost_engine --------------------------------------------

class _Cluster:
    """N collective ranks on `device`; every start() is a new generation
    with a fresh process-group address, as the supervisor spawns them."""

    def __init__(self, data, n, groups, device, extra_env):
        self.data, self.n, self.groups = str(data), n, groups
        self.device, self.extra_env = device, extra_env
        ports = free_ports(2 * n)
        self.http_ports, self.frame_ports = ports[:n], ports[n:]
        self.procs = []
        self.gen = 0

    def start(self):
        (coord,) = free_ports(1)
        self.procs = []
        self.gen += 1
        for r in range(self.n):
            env = dict(child_env(), MHE_RANK=str(r), MHE_NHOSTS=str(self.n),
                       MHE_COORD=f"127.0.0.1:{coord}", MHE_DATA=self.data,
                       MHE_GROUPS=str(self.groups),
                       MHE_HTTP_PORTS=",".join(map(str, self.http_ports)),
                       MHE_FRAME_PORTS=",".join(map(str, self.frame_ports)),
                       MHE_DEVICE=self.device, **self.extra_env)
            with open(os.path.join(self.data, f"rank{r}.gen{self.gen}.log"),
                      "ab") as logf:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "etcd_tpu_torch.tools.multihost_engine"], cwd=ROOT,
                    env=env, stdout=logf, stderr=subprocess.STDOUT))
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

    def wait_up(self, timeout=240):
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
                time.sleep(0.5)

    def kill_all(self):
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in self.procs:
            p.wait()


def _put(base, g, k, v, timeout=25):
    req = urllib.request.Request(
        f"{base}/tenants/{g}/v2/keys/{k}", f"value={v}".encode(),
        method="PUT",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def _get(base, g, k, timeout=10):
    return json.loads(urllib.request.urlopen(
        f"{base}/tenants/{g}/v2/keys/{k}", timeout=timeout).read())


def soak_hostengine(n_seeds: int, meta_seed: int = 0,
                    device="cuda") -> None:
    """Per seed, a 2-3 host cluster with seeded payload-frame drops takes
    randomized writes via random hosts through kill/restart cycles (one
    rank SIGKILLed mid-traffic, then whole-job restart, the supervisor's
    recovery move, driven directly). Every write acked by a host must be
    served by that host after every restart; with drops, the pull
    counters must show the catch-up path engaged."""
    import tempfile

    meta = np.random.RandomState(meta_seed)
    for k in range(n_seeds):
        seed = int(meta.randint(1, 1 << 30))
        rng = np.random.RandomState(seed)
        n_hosts = int(rng.choice([2, 3]))
        groups = int(rng.choice([4, 6]))
        drop = float(rng.choice([0, 30, 60]))
        # Small windows push restart catch-up past the device ring, so
        # kill/restart cycles exercise the cross-host snapshot install
        # and the retained terms, not just pulls.
        window = int(rng.choice([8, 16, 32]))
        acked = {}
        with tempfile.TemporaryDirectory() as d:
            cl = _Cluster(d, n_hosts, groups, device,
                          {"MHE_DROP_PAY_PCT": str(drop),
                           "MHE_FAULT_SEED": str(seed),
                           "MHE_WINDOW": str(window),
                           "MHE_REQ_TIMEOUT": "30"}).start()
            try:
                cl.wait_up()
                saw_pulls = False
                for cycle in range(2):
                    for i in range(20):
                        g = int(rng.randint(groups))
                        h = int(rng.randint(n_hosts))
                        key = f"s{seed % 997}c{cycle}i{i}"
                        try:
                            r = _put(cl.base(h), g, key, "v", timeout=35)
                            if r["action"] == "set":
                                acked[(g, key)] = h
                        except Exception:  # noqa: BLE001 — timeouts legal
                            pass
                    # Counters reset with each generation: sample before
                    # the kill.
                    for h in range(n_hosts):
                        try:
                            if cl.status(h)["pulls_sent"] > 0:
                                saw_pulls = True
                        except Exception:  # noqa: BLE001
                            pass
                    # Kill one random rank mid-traffic, then restart the
                    # whole job (the collective stalls, by design).
                    victim = int(rng.randint(n_hosts))
                    cl.procs[victim].kill()
                    time.sleep(0.5)
                    cl.kill_all()
                    cl.start()
                    cl.wait_up()
                    time.sleep(1.0)
                    lost = []
                    for (g, key), h in acked.items():
                        try:
                            if (_get(cl.base(h), g, key, timeout=20)
                                    ["node"]["value"] != "v"):
                                lost.append(key)
                        except Exception:  # noqa: BLE001
                            lost.append(key)
                    if lost:
                        raise AssertionError(f"seed {seed} cycle {cycle}: "
                                             f"ACKED WRITES LOST {lost[:5]}")
                if drop > 0 and not saw_pulls:
                    raise AssertionError("drops never exercised the pull "
                                         "path")
            except Exception:
                cl.dump_logs()
                raise
            finally:
                cl.kill_all()
        print(f"hostengine seed {seed}: {n_hosts} hosts, drop={drop}%, "
              f"W={window}, {len(acked)} acked, zero lost", flush=True)
    print(f"hostengine soak OK: {n_seeds} campaigns, zero acked writes "
          f"lost", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m etcd_tpu_torch.tools.soak")
    ap.add_argument("what", nargs="?", default="all",
                    choices=("kernel", "engine", "hostengine", "all"))
    ap.add_argument("n", nargs="?", type=int, default=0,
                    help="schedules or campaigns (0: the mode's default)")
    ap.add_argument("meta_seed", nargs="?", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the rounds run: cuda (the card) or cpu")
    args = ap.parse_args(argv)
    require_device(args.device, "pass --device cpu")
    n, ms, dev = args.n, args.meta_seed, args.device
    if args.what == "kernel":
        soak_kernel(n or 200, meta_seed=ms, device=dev)
    elif args.what == "engine":
        soak_engine(n or 3, meta_seed=ms, device=dev)
    elif args.what == "hostengine":
        soak_hostengine(n or 2, meta_seed=ms, device=dev)
    else:
        # 'all' keeps per-soak defaults: a count meant for the short
        # kernel schedules must not launch that many engine campaigns.
        soak_kernel(n or 200, meta_seed=ms, device=dev)
        soak_engine(3, meta_seed=ms, device=dev)
        soak_hostengine(2, meta_seed=ms, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
