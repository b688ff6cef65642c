"""Multi-host engine performance against the single-host engine, in one
process, at one group count:

  frames3     3 frames-plane HostEngines (real TCP frames, real per-host
              WALs, fsync on): saturated acked writes/s (a closed loop
              holding `in_flight_cap(G)` writes in flight), then paced
              50%-load ack p50/p99 sampled at the leader host's wait
              registry.
  single_h1   single-host MultiEngine, same G, hops=1 (the multi-host
              durability constraint applied to the single-host path).
  single_h3   single-host MultiEngine, same G, hops=3 (its own config).

single_h1 against single_h3 is the price of the hops=1 persist-before-
send constraint; single_h1 against frames3 is the price of the frame
transport and three hosts. A multi-host commit takes about three host-
paced rounds (propose, append + ack, commit visible) plus a per-round
fsync, so ack p50 ~= 3 x round_ms + apply; the paced phase checks that.

Every engine runs on MHB_DEVICE ("cuda", the card, unless the caller
says "cpu"; all three hosts share it). Writes the result as JSON to
MHB_OUT, which the caller must give, and prints it.

Usage: MHB_OUT=out.json python -m etcd_tpu_torch.tools.multihost_bench
Env: MHB_GROUPS (64), MHB_SECONDS (12 per phase), MHB_DEVICE (cuda),
MHB_OUT (required).
"""
import json
import os
import sys
import tempfile
import time

import numpy as np

from etcd_tpu_torch.server.request import Request
from etcd_tpu_torch.tools.functional_tester import _free_ports
from etcd_tpu_torch.tools.launch import require_device

N = 3
VAL = "x" * 64


class _Sample:
    __slots__ = ("t0", "t1")

    def __init__(self):
        self.t0 = time.time()
        self.t1 = None

    def put(self, value):
        self.t1 = time.time()


def _percentiles(samples):
    lats = [s.t1 - s.t0 for s in samples if s.t1 is not None]
    if not lats:
        return None, None, 0
    return (round(1000 * float(np.percentile(lats, 50)), 2),
            round(1000 * float(np.percentile(lats, 99)), 2), len(lats))


def in_flight_cap(G):
    """Phase A's bound on writes offered and not yet acked: two rounds'
    admission (a round admits max_ents=4 entries a group), so the next
    round has work queued while one commits and applies; at least 16,384
    so that a small G still queues deep enough to batch."""
    return max(2 * 4 * G, 16384)


def drain_limit_s(secs):
    """How long phase A waits, after its window, for its writes in
    flight to ack."""
    return max(60.0, 8.0 * secs)


def _measure(label, G, secs, enqueue, sample_one, round_ms_fn, acked_fn):
    """Shared two-phase meter: saturated throughput, then paced 50%-load
    latency. `enqueue(k)` offers k pool writes spread over groups;
    `sample_one()` offers one latency-sampled write.

    Phase A is a closed loop: every 5 ms it tops the writes in flight
    (offered, not yet acked) back up to `in_flight_cap(G)`, so the
    engines always hold work and are never flooded. After its window the
    writes still in flight drain, for at most `drain_limit_s(secs)`; its
    rate is every write acked from its start to the drain's end over that
    time. `drained` says whether every offered write acked: only then
    does phase B start from empty queues. Where it is false, phase B's
    writes queue behind phase A's and its latencies are not a 50%-load
    reading."""
    cap = in_flight_cap(G)
    a0 = acked_fn()
    offered = 0
    t0 = time.time()
    while time.time() - t0 < secs:
        k = cap - (offered - (acked_fn() - a0))
        if k > 0:
            enqueue(k)
            offered += k
        time.sleep(0.005)
    t_drain = time.time()
    while (acked_fn() - a0 < offered
           and time.time() - t_drain < drain_limit_s(secs)):
        time.sleep(0.05)
    acked_a = acked_fn() - a0
    drained = acked_a >= offered
    aps = acked_a / (time.time() - t0)
    if not drained:
        print(f"[{label}] phase A did not drain: {offered - acked_a} of "
              f"{offered} writes unacked {drain_limit_s(secs)} s after "
              f"its window", file=sys.stderr, flush=True)

    # Phase B: paced at 50% of measured capacity, every 8th sampled.
    samples = []
    rate = max(aps * 0.5, 50.0)
    b0 = acked_fn()
    t_b = time.time()
    injected = 0
    while time.time() - t_b < secs:
        want = int(rate * (time.time() - t_b)) - injected
        if want > 0:
            n_s = sum(1 for i in range(want) if (injected + i) % 8 == 0)
            enqueue(want - n_s)
            for _ in range(n_s):
                samples.append(sample_one())
            injected += want
        time.sleep(0.002)
    time.sleep(2.0)   # let the tail ack
    p50, p99, n_lat = _percentiles(samples)
    res = {"acked_writes_per_sec": round(aps, 1),
           "saturated_acked": acked_a, "saturated_offered": offered,
           "in_flight_cap": cap, "drained": drained,
           "paced_acked": acked_fn() - b0,
           "paced_p50_ms": p50, "paced_p99_ms": p99,
           "latency_samples": n_lat, "round_ms": round(round_ms_fn(), 3),
           "groups": G, "hosts_or_hops": label}
    print(f"[{label}] {res}", flush=True)
    return res


def bench_frames3(tmp, G, secs, device):
    from etcd_tpu_torch.server.hostengine import HostEngine, HostEngineConfig
    ports = _free_ports(N)
    engines = []
    for r in range(N):
        engines.append(HostEngine(HostEngineConfig(
            groups=G, peers=N,
            data_dir=os.path.join(tmp, f"host{r}"), host_id=r,
            frame_listen=("127.0.0.1", ports[r]),
            frame_peers={h: ("127.0.0.1", ports[h]) for h in range(N)},
            window=16, max_ents=4, fsync=True, stagger=True,
            request_timeout=20.0, data_plane="frames", device=device)))
    for e in engines:
        e.start()
    deadline = time.time() + 120
    while time.time() < deadline:
        if all(any(e.leader_slot(g) >= 0 for e in engines)
               for g in range(G)):
            break
        time.sleep(0.1)

    def leader_of(g):
        for e in engines:
            if e.l_state[g] == 2:
                return e
        return engines[0]

    pool = {}
    rr = {"g": 0}

    def enqueue(k):
        # Exactly k writes, round-robin over groups (the paced phase's
        # accounting depends on it).
        for _ in range(k):
            g = rr["g"] = (rr["g"] + 1) % G
            e = pool.get(g)
            if e is None or e.l_state[g] != 2:
                e = pool[g] = leader_of(g)
            rid = e.reqid.next()
            r = Request(method="PUT", path="/1/bench", val=VAL, id=rid)
            with e._lock:
                e._pending[g].append((rid, bytes([0]) + r.encode()))
                e._dirty.add(g)

    gi = {"g": 0}

    def sample_one():
        g = gi["g"] = (gi["g"] + 1) % G
        e = leader_of(g)
        rid = e.reqid.next()
        r = Request(method="PUT", path="/1/bench", val=VAL, id=rid)
        s = _Sample()
        e.wait._waiters[rid] = s
        with e._lock:
            e._pending[g].append((rid, bytes([0]) + r.encode()))
            e._dirty.add(g)
        return s

    # Every host applies every committed write and counts it in its
    # acked_requests, the proposer's ack and the others' applies alike:
    # a write counts once, as the hosts' mean.
    res = _measure("frames3", G, secs, enqueue, sample_one,
                   lambda: float(np.mean([e.round_ms_ewma
                                          for e in engines])),
                   lambda: sum(e.acked_requests for e in engines) // N)
    for e in engines:
        e.stop()
    return res


def bench_single(tmp, G, secs, device, hops):
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    eng = MultiEngine(EngineConfig(
        groups=G, peers=N, data_dir=tmp, window=16, max_ents=4,
        fsync=True, stagger=True, checkpoint_rounds=1 << 30, hops=hops,
        device=device))
    eng.start()
    deadline = time.time() + 60
    while time.time() < deadline:
        if (np.where(eng.h_mask, eng.h_state, 0) == 2).any(axis=1).all():
            break
        time.sleep(0.05)

    rr = {"g": 0}

    def enqueue(k):
        rid = eng.reqid.next()
        r = Request(method="PUT", path="/1/bench", val=VAL, id=rid)
        blob = bytes([0]) + r.encode()
        with eng._lock:
            for _ in range(k):
                g = rr["g"] = (rr["g"] + 1) % G
                eng._pending[g].append((rid, blob, r))
                eng._dirty.add(g)

    gi = {"g": 0}

    def sample_one():
        g = gi["g"] = (gi["g"] + 1) % G
        rid = eng.reqid.next()
        r = Request(method="PUT", path="/1/bench", val=VAL, id=rid)
        s = _Sample()
        eng.wait._waiters[rid] = s
        with eng._lock:
            eng._pending[g].append((rid, bytes([0]) + r.encode(), r))
            eng._dirty.add(g)
        return s

    res = _measure(f"single_h{hops}", G, secs, enqueue, sample_one,
                   lambda: eng.round_ms_ewma,
                   lambda: eng.acked_requests)
    eng.stop()
    return res


def main() -> int:
    G = int(os.environ.get("MHB_GROUPS", "64"))
    secs = float(os.environ.get("MHB_SECONDS", "12"))
    device = os.environ.get("MHB_DEVICE", "cuda")
    path = os.environ.get("MHB_OUT")
    if not path:
        print("MHB_OUT must name the file the result is written to",
              file=sys.stderr)
        return 2
    require_device(device, "set MHB_DEVICE=cpu")
    import torch
    dev = torch.device(device)
    out = {"device": str(dev),
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
           "groups": G, "phase_seconds": secs, "fsync": True,
           "captured_unix": int(time.time())}
    with tempfile.TemporaryDirectory() as tmp:
        out["frames3"] = bench_frames3(os.path.join(tmp, "f3"), G, secs,
                                       device)
        out["single_h1"] = bench_single(os.path.join(tmp, "s1"), G, secs,
                                        device, hops=1)
        out["single_h3"] = bench_single(os.path.join(tmp, "s3"), G, secs,
                                        device, hops=3)
    f3, s1, s3 = out["frames3"], out["single_h1"], out["single_h3"]
    out["hops1_constraint_cost"] = {
        "throughput_ratio_h1_over_h3":
            round(s1["acked_writes_per_sec"]
                  / max(s3["acked_writes_per_sec"], 1), 3),
        "p50_ratio_h1_over_h3":
            (round(s1["paced_p50_ms"] / s3["paced_p50_ms"], 2)
             if s1["paced_p50_ms"] and s3["paced_p50_ms"] else None)}
    out["multi_host_cost"] = {
        "throughput_ratio_frames3_over_h1":
            round(f3["acked_writes_per_sec"]
                  / max(s1["acked_writes_per_sec"], 1), 3)}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
