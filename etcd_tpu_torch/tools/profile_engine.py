"""Phase profile of the MultiEngine serving round.

Drives the deep-queue load shape (every group's pending queue topped to
max_ents before each round) on the port's engine and prints the
per-phase share of the round (the advance of `MultiEngine.phase_s`
over the measured rounds) and the acked writes/s.

Usage: python -m etcd_tpu_torch.tools.profile_engine [G] [rounds]
           [--device cpu]
The engine runs on the card unless --device says "cpu".
"""
import argparse
import tempfile
import time

from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
from etcd_tpu_torch.server.request import Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("groups", type=int, nargs="?", default=2048)
    ap.add_argument("rounds", type=int, nargs="?", default=60)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (the card) or cpu")
    args = ap.parse_args(argv)
    G, n_rounds = args.groups, args.rounds
    E = 4
    P = 5
    payload = Request(method="PUT", path="/bench/k", val="x" * 64)

    with tempfile.TemporaryDirectory() as tmp:
        eng = MultiEngine(EngineConfig(
            groups=G, peers=P, data_dir=tmp, window=16, max_ents=E,
            heartbeat_tick=3, fsync=True, stagger=True,
            checkpoint_rounds=1 << 30, device=args.device))
        for _ in range(12):
            eng.run_round()
            if all(eng.leader_slot(g) >= 0 for g in range(G)):
                break
        assert all(eng.leader_slot(g) >= 0 for g in range(G))

        def offer():
            with eng._lock:
                for g in range(G):
                    dq = eng._pending[g]
                    while len(dq) < E:
                        rid = eng.reqid.next()
                        r = Request(**{**payload.__dict__, "id": rid})
                        dq.append((rid, b"\x00" + r.encode(), r))
                    eng._dirty.add(g)

        for _ in range(5):
            offer()
            eng.run_round()

        # phase_s is never reset: the WAL writer threads hold the dict
        # they were handed at construction, so take its difference.
        ph0 = dict(eng.phase_s)
        a0 = eng.acked_requests
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            offer()
            eng.run_round()
        elapsed = time.perf_counter() - t0
        acked = eng.acked_requests - a0

        total_ms = 1000.0 * elapsed / n_rounds
        print(f"\nG={G} P={P} E={E} fsync=on: {n_rounds} rounds, "
              f"{total_ms:.2f} ms/round, {acked/elapsed:,.0f} acked "
              f"writes/s")
        ph = {k: v - ph0.get(k, 0.0) for k, v in dict(eng.phase_s).items()}
        # The round's wall time leaves out "dispatch.wait" (a part of
        # dispatch and readback), the per-write "ack.*" stages and the
        # "hop.*" counts.
        hops = {k: ph.pop(k) for k in list(ph) if k.startswith("hop.")}
        acct = sum(v for k, v in ph.items()
                   if k != "dispatch.wait" and not k.startswith("ack."))
        if hops:
            print("  hops: " + ", ".join(f"{k[4:]} {int(v)}"
                                         for k, v in hops.items()))
        for k, v in sorted(ph.items(), key=lambda kv: -kv[1]):
            print(f"  {k:14s} {1000*v/n_rounds:9.3f} ms/round "
                  f"{100*v/elapsed:6.2f}% of wall")
        print(f"  {'(acct)':14s} {1000*acct/n_rounds:9.3f} ms/round "
              f"{100*acct/elapsed:6.2f}% of wall")
        eng.stop()


if __name__ == "__main__":
    main()
