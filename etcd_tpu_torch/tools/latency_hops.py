"""Propose->commit latency of the multi-hop round against group count.

With `step_routed_auto(hops=3)` a proposal admitted on hop 0 is
replicated and quorum-committed within the same round, so a proposal's
commit latency is bounded by one round (queueing adds at most one more).
This tool times that round under full proposals (every group's leader
proposes max_ents entries each round) at the group counts given: P=5,
W=16, E=4, 40 warm-up rounds (every group must have elected a leader by
then), then 80 timed rounds (every group's commit must advance). It
prints, per G, ms per round, commits/s and `ring_resolve`'s launches by
instantiation over the timed rounds.

Usage: python -m etcd_tpu_torch.tools.latency_hops [G ...]
           [--device cpu] [--warmup N] [--rounds N]
    (default G: 12500 32768 100000; the card unless --device says cpu)
"""
import argparse
import json
import time

import torch

from etcd_tpu_torch.ops import kernel
from etcd_tpu_torch.ops.ring_resolve import ring_resolve
from etcd_tpu_torch.ops.state import LEADER, KernelConfig, init_state
from etcd_tpu_torch.tools.launch import require_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(G: int, hops: int = 3, peers: int = 5, rounds: int = 80,
            warmup: int = 40, device="cuda") -> dict:
    """Time `rounds` full-proposal rounds at G groups on `device`."""
    dev = torch.device(device)
    cfg = KernelConfig(groups=G, peers=peers, window=16, max_ents=4,
                       election_tick=10, heartbeat_tick=3)
    st = init_state(cfg, stagger=True, device=dev)
    inbox = torch.zeros((G, peers, peers, cfg.fields), dtype=torch.int32,
                        device=dev)
    zero = torch.zeros(G, dtype=torch.int32, device=dev)
    for _ in range(warmup):
        st, inbox = kernel.step_routed_auto(cfg, st, inbox, zero, zero, True)
    lead = st.state == LEADER
    led = int(lead.any(dim=1).sum())
    if led != G:
        raise AssertionError(f"G={G}: {G - led} groups without a leader "
                             f"after {warmup} rounds")
    slots = lead.int().argmax(dim=1).to(torch.int32)
    full = torch.full((G,), cfg.max_ents, dtype=torch.int32, device=dev)

    def step(st, inbox):
        return kernel.step_routed_auto(cfg, st, inbox, full, slots, True,
                                       hops=hops)

    st, inbox = step(st, inbox)
    _sync(dev)
    c0 = st.commit.amax(dim=1)
    by0 = dict(ring_resolve.launches_by_variant)
    t0 = time.perf_counter()
    for _ in range(rounds):
        st, inbox = step(st, inbox)
    _sync(dev)
    dt = (time.perf_counter() - t0) / rounds
    c1 = st.commit.amax(dim=1)
    advanced = int((c1 > c0).sum())
    if advanced != G:
        raise AssertionError(f"G={G}: the commit of {G - advanced} groups "
                             f"did not advance in {rounds} rounds")
    return {"groups": G, "peers": peers, "hops": hops, "rounds": rounds,
            "ms_per_round": dt * 1e3,
            "commits_per_s": int((c1 - c0).sum()) / (rounds * dt),
            "groups_led": led, "groups_committing": advanced,
            "launches_by_variant": {
                k: ring_resolve.launches_by_variant[k] - by0[k]
                for k in by0}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m etcd_tpu_torch.tools.latency_hops")
    ap.add_argument("groups", type=int, nargs="*",
                    default=[12500, 32768, 100000])
    ap.add_argument("--device", default="cuda",
                    help="where the rounds run: cuda (the card) or cpu")
    ap.add_argument("--warmup", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=80)
    args = ap.parse_args(argv)
    require_device(args.device, "pass --device cpu")
    print("device:", torch.device(args.device), flush=True)
    for g in args.groups:
        r = measure(g, rounds=args.rounds, warmup=args.warmup,
                    device=args.device)
        print(f"G={g:>7} hops={r['hops']}: {r['ms_per_round']:6.2f} "
              f"ms/round, {r['commits_per_s']:,.0f} commits/s; "
              f"propose->commit within one round, 2-round worst case "
              f"{2 * r['ms_per_round']:.1f} ms", flush=True)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
