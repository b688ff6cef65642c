#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (etcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path at 100,000 groups × 5 peers (W=16, E=4,
heartbeat_tick=3, hops=3, fsync on) on the card, and fails (nonzero
exit) if any phase fails:

1. device: the card's name and power limit; the port's C host code
   (codecs and store), built with cc by the first import of the package,
   loaded (every HAVE_NATIVE* flag True, or the run fails); builds the
   CUDA kernels (one nvcc per build, all started together) and prints
   ptxas's registers and shared memory for each kernel instantiation.
2. kernel vs plain: `ring_resolve` against `ring_resolve_ref` on the card,
   exactly equal, through every instantiation (TE=4, TE=5, generic) at
   the round's call shapes (idx (G, P, 5), (G, P, 4) and, on the CLI's
   path, (G, P, 8)), a ragged row count, trailing shapes
   (P, E) and (), W=8, a misaligned idx, the blocks of the device
   mesh and of a collective rank (idx (25000, 5, 5), (25000, 5, 4),
   (100000, 1, 5), (100000, 1, 4), (100000, 1, 8)), and the bench's
   and frames_soak's other shapes (churn (100000, 7, 4) and
   (100000, 7, 7); shallow_clients (8, 3, 8) and (8, 3, 3); latency
   (12500, 5, 4/5), qread (8192, 5, 4/5), expiry_wave (4096, 5, 4/5);
   frames_soak at W=8 (12500, 5, 5) and (12500, 5, 2)). At every shape
   a path launches,
   over inputs that rotate through 8 copies (so L2 is cold, as in the
   round): CUDA-event times of the kernel, the plain version and one
   torch.gather beside the bound; the kernel's device time replayed from
   a CUDA graph, over the copies and over one input (warm L2); the
   launch floor (the wrapper's whole path with an empty kernel,
   `ring_resolve.launch_floor`) in both loops; host µs per call. The A/B
   of two commits' kernels is `etcd_tpu_torch/ops/ring_resolve_timing.py`.
2a. quiet_hop: the round's fused quiet hop (`ops/quiet_hop.py`, the
   passes of `csrc/quiet_hop.cu` around the two `ring_resolve`
   launches) against the PyTorch quiet hop, exactly equal: at
   QUIET_SHAPES (the benchmark's (100000, 5/7, W 16, E 4), the CLI's
   max_ents 8, the bench's latency, qread, expiry_wave and
   shallow_clients, frames_soak's W=8, P=8 with E=8, a ragged group
   count) on random quiescent states (`quiet_inputs`), tick on
   and off, the forced heartbeat, with and without a drop mask; the
   predicate pass against `_quiet_pred`, also on states made non-quiet;
   at the benchmark's two shapes the hop's device time beside its
   one-pass byte floor (`quiet_hop_bytes`), each pass's beside its own,
   and the predicate pass against `_quiet_pred`'s ops; then 40 lockstep
   `step_routed_compact` rounds (hops=3) at those shapes after 20 boot
   rounds, equal after every round, every steady hop fused and each
   pass launched once a hop. The engine's and the HTTP front's main
   paths (C host code on and off) must launch every pass; the report's
   `kernels` line has a `quiet_hop` entry with its times, floor and
   launches by path.
3. round: full-width rounds with the kernel and with
   `resolve=ring_resolve_ref` in lockstep, every output equal after every
   round, both call shapes' instantiations launched, at four shapes
   (ROUNDS): the engine's `step_routed_compact` (hops=3); the multi-host
   engine's slots round (`step_routed_slots_auto`, hops=1, max_ents 8:
   TE=5 at idx (G, P, P), generic at (G, P, 8)); the bench's churn (7
   peers, hops=1, 10% of leaders partitioned: TE=4 at (G, 7, 4), generic
   at (G, 7, 7)); frames_soak's engines (12,500 groups, W=8, max_ents 2:
   TE=5 at (12500, 5, 5), generic at (12500, 5, 2)); 30 small rounds on
   the card and on the CPU, bit-equal.
3a. raft_oracle: the card's round against the scalar Raft (the port's
   `raft/core.py`, etcd_tpu_torch/ops/oracle.py): `kernel.step` with the
   CUDA `ring_resolve` and `route_local` at G × P (W, E), faults (drops,
   delays, a leader partition) drawn on the card from a torch.Generator,
   under the tight-window schedule (90 rounds, also stepped in lockstep
   with the plain resolve, equal after every round) and the heavy-loss
   one (90 rounds); a scalar Raft per (group, slot) of 128 sampled
   groups (0, G-1, groups straddling a 256-row tile edge) equal to the
   card after every round; need_host never set on any group; ms per
   round, the mirror's ms per round, launches by instantiation.
4. engine: `MultiEngine` boots, elects, acks 1,000 PUTs from side
   threads, serves their GETs and 100 quorum GETs, and after a restart
   on the same data dir reads every acked write back. The kernels'
   launch counts are read across this phase (the main path). Then the
   same again at 300 tenants (30 quorum GETs) with the C host code off
   (the codecs' `_c_*` None and the Python store): `phase_s` (record,
   apply), acked writes/s and ack p50/p99 of both runs.
4a. suite_card: the engine behaviours that the JAX package's tests hold
   on the CPU, at the bench shape on the card, in three legs, each
   counting ring_resolve's launches across itself. race
   (tests/test_race_stress.py): 100 threads of CAS read-modify-write
   loops on 10 hot tenants while 1,000 tenants take their first write
   and 8 threads touch their stores; every counter equal to its acked
   CASes, one Store per tenant, every first write read back by quorum
   GET; acked writes/s, ack p50/p99. compact
   (tests/test_engine_compact.py): an engine with compact readback and
   one with full readback under the same seeded writes and 5% link
   drops for 40 rounds, mirrors and changed stores equal after every
   round, every store and WAL record at the end, and the compact
   engine's restart equal too. obs (tests/test_observability.py): an
   engine (2 WAL and 2 applier shards) behind EngineHttp, /metrics
   scraped while 1,000 PUTs from 100 threads run: every compartment
   series the JAX test names, +Inf equal to _count, monotone counters,
   the acked counter moved by the clients' acks, /debug/flight and a
   SIGUSR2 dump Chrome-trace JSON; each compartment's p50/p99 and
   phase_s.
5. http_front: the same G, P and window through the CLI's engine mode
   at its other defaults (max_ents 8, so the conflict scan takes the
   generic instantiation at idx (100000, 5, 8)), in three legs: in
   process over real sockets, launch counts read across it (PUT, GET,
   quorum GET, /batch); `python -m etcd_tpu_torch` with `python -m
   etcd_tpu_torch.server.ingress` in front (PUTs and a CAS race through
   the ingress, the server among the card's compute apps, every
   upstream frame answered); SIGKILL of the server, the same command
   again, every acked write read back as soon as it serves (local GETs
   need no re-elected leader), the traced request ids of acked writes
   (ETCD_TPU_TRACE_EVERY=4) among the restarted server's `replayed`
   spans, its launches from its stop line, rc 0 on SIGTERM for both. One
   JSON line per leg: acked writes/s, ack p50/p99, rounds/s, seconds
   per step. Then the three legs again at 300 tenants (30 quorum GETs)
   with the C host code off in every process (ETCD_TPU_PYSTORE=1, no C
   codecs, the ingress's `--no-native`), after phase 13, beside
   frames_soak (contended), as are 5a and 5b.
5a. pool_serve: `python -m etcd_tpu_torch.tools.pool_serve`, two shard
   processes of 50,000 groups each on the card (P, W, fsync on) behind
   one router: boot seconds per shard, 1,000 PUTs and 100 quorum GETs
   through the router, every acked write read back through it; then
   `python -m etcd_tpu_torch.tools.ingress_serve` with two ingresses in
   front of the router (JSON batches: the router relays no upgraded
   channel), 1,000 PUTs striped over them, every acked write read back;
   SIGTERM, rc 0 for both launchers, and each shard's stop line with its
   ring_resolve launches (TE=5 and generic above zero).
5b. tsan: `python -m etcd_tpu_torch.tools.tsan_check --if-available`,
   the port's C under ThreadSanitizer, or a printed skip without
   libtsan.
6. multihost_frames: five rank processes of `python -m
   etcd_tpu_torch.tools.multihost_engine` on the one card (the frames
   data plane: G, P=5 replicas of every group, one per rank, W=16,
   max_ents 8, fsync on), every rank among the card's compute apps and
   every group led on every rank; 500 PUTs from 100 threads spread
   over the ranks (all forwarded to another rank's leader; 1,000 before
   the phases below were added, cut to hold the script near 400 s);
   SIGKILL of one rank while writes go on through the survivors (worst
   gap between acks, re-election of the groups it led); its restart on
   its own data dir (to serving, to caught up); every acked write read
   back from the rank that acked it; SIGTERM, rc 0 and an exit line
   from every rank (device, `ring_resolve` launches by instantiation,
   both above zero for TE=5 and generic, peak device memory).
6a. frames_soak: tests/test_frames_plane.py's seeded chaos soak (seed
   11; its schedule is tools/frames_soak.py's) with five in-process
   `HostEngine`s on the card on the frames plane (12,500 groups, the
   bench's per-card shard shape, SOAK_GROUPS; P=5 replicas, the soak's
   W=8, max_ents 2 and fsync off; a client's attempt 20 s, not 2:
   SOAK_ATTEMPT_S): every group led; every engine alive and a write to
   each of 200 fixed groups (0 and G-1 among them) acked after each
   step, within the soak's deadlines; a stop() of one engine (once,
   SOAK_KILL_CYCLES, of the soak's two: depth), writes through the
   survivors, its restart on its own data dir; one
   pair's frames blocked both ways, writes through a third engine, the
   heal. Logged with the card's name and power limit: seconds to
   re-elect after each stop, until the restarted engine serves, to serve
   through the partition, the most attempts a step's write took, and
   ring_resolve's launches over the leg by instantiation. The leg runs
   in a process of its own, killed past SOAK_LIMIT_S, after
   multihost_collective (9) and beside phases 7, 8 and 10-13, then 5's
   C-off legs, 5a and 5b, whose numbers are taken beside it
   (contended).
7. mesh_round: the bench shape's round (hops=3, E=4) for 16 rounds with
   random proposals and 5% drops, unsharded, on a 4 x 1 mesh (groups
   axis) and on a 1 x 5 mesh (peers axis), every cell on the one card:
   state and inbox equal to the unsharded round's after every round;
   per layout ms per round, the comm's calls and ms per call,
   `ring_resolve`'s launches by instantiation, and torch.profiler over
   two more rounds (device-busy ms, idle share, CUDA kernels per round).
8. engine_mesh: phase 4 again with `EngineConfig.mesh` a 4 x 1 mesh on
   the card (1,000 PUTs, 100 quorum GETs, restart, every acked write
   read back; acked writes/s, ack p50/p99).
9. multihost_collective: five ranks on the collective data plane under
   `python -m etcd_tpu_torch.tools.multihost_supervisor`, on gloo (NCCL
   allows one rank per card; a probe shows whether gloo's all-to-all
   takes CUDA tensors, and the ranks move theirs through pinned host
   memory either way): boot, 1,000 forwarded PUTs, 100 quorum GETs on
   the zero-append read plane (no rank's applied index or WAL moves),
   10 groups written past the ring window, SIGKILL of one rank with
   its data dir taken away and the supervisor's whole-job restart
   (detect, restart, total seconds; the empty rank starts from the
   term floor the supervisor wrote it), seconds until the rebuilt rank
   has installed a snapshot of each of those groups and serves every
   acked write from its own store, every acked write read back from
   all five ranks, SIGTERM and each rank's exit line.
10. member_cluster: etcd's own deployment through the port's CLI:
   three `python -m etcd_tpu_torch` members from a static
   --initial-cluster bootstrap, at the reference's tick (heartbeat 100
   ms, election 1,000 ms) with fsync on and --snapshot-count 250 (the
   one cut; the reference's is 10,000): boot seconds; 1,000 PUTs from
   100 threads spread over the members (acked writes/s, ack p50/p99),
   100 quorum GETs and a CAS race; SIGKILL of a follower while writes go
   on and its restart (seconds to caught up); SIGKILL of the leader
   while writes go on (seconds to a new leader) and its restart; every
   acked write read back from every member; /v2/members and
   /v2/stats/self sane; no member among the card's compute apps (the
   member mode is host code: the card does no work here); rc 0 on
   SIGTERM for every member.
11. tools_engine: etcd's own tools against the CLI's engine on the card
   (the CLI shape at G, P, W), each pointed at a tenant's base URL
   /tenants/{g}: three `python -m etcd_tpu_torch --discovery` members
   (heartbeat 100 ms, election 1,000 ms) bootstrap from a registry in a
   tenant's keyspace and a fourth process on the same token falls back
   to proxy mode (200 PUTs through the proxy read back from every member,
   a long-poll watch through it, none of the four on the card or mapping
   torch, rc 0); `python -m etcd_tpu_torch.etcdctl.main` on three
   tenants (set, get, mk twice, update, ls, rm, mkdir, rmdir; none
   imports torch; seconds per command); the SDK (`KeysAPI(Client(...))`)
   on 1,000 tenants from 100 threads (set and get back, in-order create,
   a 20-way CAS race with one winner, a watcher that sees the next set,
   tenant isolation; acked writes/s, ack p50/p99); SIGTERM, rc 0, the
   server's ring_resolve launches from its stop line; `python -m
   etcd_tpu_torch.tools.dump_logs --engine` lists every write the SDK
   acked.
12. latency_hops: `etcd_tpu_torch.tools.latency_hops` at G = 12,500
   and 100,000 (P=5, W=16, E=4, hops=3, full proposals; 40
   warm-up rounds, every group led; 80 timed rounds, every group's
   commit advancing): ms per round, commits/s, launches.
13. soak_kernel: `etcd_tpu_torch.tools.soak kernel` for 3 schedules
   (meta seed 0): random fault mixes of `oracle.run_equivalence` on the
   card with the CUDA `ring_resolve`, equal to the scalar Raft after
   every round; schedules per second and the starved count.
14. bench: `python -m etcd_tpu_torch.bench` at its defaults (100,000
   groups × 5 peers; churn at 7 peers; engine 100,000, latency 12,500,
   qread 8,192, expiry_wave 4,096 × 16 TTL keys; 100,000 watchers;
   10,000 depth-1 connections, 8 tenants, 2,000 hub watchers; the
   direct leg 3,000; the kernel scenarios' measured rounds cut to 100
   from 300, the host-bound legs' floor to 3 rounds from 10, depth),
   its ten scenarios as five invocations in three lanes run at once:
   qread then the kernel scenarios, engine, shallow_clients then
   latency (BENCH_LANES: disjoint BENCH_SCENARIO sets, each led by
   uniform; one after another they take ~650 s; shallow_clients'
   measured legs 3 s): every scenario in its
   line at those widths on platform "gpu", and its invariants (uniform,
   zipf, lag and churn commit; lag partitions G/20 groups; churn's
   liveness floor, every group led after the heal; engine's and
   latency's acked counter equal to the engine's own count; qread's
   read-only leg appends nothing; expiry_wave expires every TTL key;
   shallow_clients loses no acked write through the ingress's SIGKILL);
   ring_resolve's launches by scenario, TE=4 and TE=5 both above zero.
15. one JSON line describing every kernel, then the last line
   {"ok": true, "device": {...}}.

Needs a CUDA device; without one it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import select
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

G, P, W, E = 100_000, 5, 16, 4
CLI_E = 8            # EngineConfig's max_ents, which the CLI leaves as it is
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
CUDA_SOURCES = ("ring_resolve", "quiet_hop")   # etcd_tpu_torch/ops/csrc
SEED = 1234


def log(phase: str, t0: float, **kv) -> None:
    print(json.dumps({"phase": phase, "s": round(time.perf_counter() - t0, 3),
                      **kv}), flush=True)


def _launches_reset():
    """Zero ring_resolve's and the fused quiet hop's launch counts (a
    counted path starts)."""
    from etcd_tpu_torch.ops import quiet_hop
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    ring_resolve.launches = 0
    for k in ring_resolve.launches_by_variant:
        ring_resolve.launches_by_variant[k] = 0
    for k in quiet_hop.launches:
        quiet_hop.launches[k] = 0


def _launches_read() -> tuple:
    """ring_resolve's launches since the reset, in all and by
    instantiation (a counted path ends)."""
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    return ring_resolve.launches, dict(ring_resolve.launches_by_variant)


def _require_quiet_hop(path: str, by_pass: dict) -> None:
    """Raise unless every pass of the fused quiet hop was launched on
    `path` (by_pass: `_quiet_launches()` at its end)."""
    if not all(by_pass.values()):
        raise AssertionError(f"the fused quiet hop's passes were not all "
                             f"launched on {path}: {by_pass}")


def _quiet_launches() -> dict:
    """The fused quiet hop's passes launched since the reset, by pass (a
    counted path ends)."""
    from etcd_tpu_torch.ops import quiet_hop
    return dict(quiet_hop.launches)


# The entry points of the port's C that the loaders bind at import.
C_ENTRY_POINTS = ("_c_encode", "_c_scan", "_c_pack_multi",
                  "_c_scan_requests", "_c_format_responses")


def native_flags() -> dict:
    import etcd_tpu_torch.native as native
    import etcd_tpu_torch.store as store
    return {"HAVE_NATIVE": native.HAVE_NATIVE,
            "HAVE_NATIVE_INGRESS": native.HAVE_NATIVE_INGRESS,
            "HAVE_NATIVE_STORE": store.HAVE_NATIVE_STORE}


def python_host() -> list:
    """Turn this process's C host code off: the codecs' `_c_*` entry
    points become None and new stores are the Python Store (what
    ETCD_TPU_PYSTORE=1 does at import). Returns what it replaced."""
    import etcd_tpu_torch.native as native
    import etcd_tpu_torch.store as store
    from etcd_tpu_torch.server import engine
    saved = [(native, k, getattr(native, k)) for k in C_ENTRY_POINTS]
    saved += [(engine, "_c_pack_multi", engine._c_pack_multi),
              (store, "HAVE_NATIVE_STORE", store.HAVE_NATIVE_STORE)]
    for mod, k, _ in saved:
        setattr(mod, k, False if k == "HAVE_NATIVE_STORE" else None)
    return saved


@contextlib.contextmanager
def host_code(native: bool):
    """The C host code on (the default, which must have been built) or
    off for the body of the `with`."""
    if native:
        flags = native_flags()
        if not all(flags.values()):
            raise AssertionError(f"the C host code is not loaded: {flags}")
        yield
        return
    saved = python_host()
    try:
        yield
    finally:
        for mod, k, v in saved:
            setattr(mod, k, v)


# `python -c PY_HOST_MODULE <module> <args>`: run a module as `python -m`
# does, with the C host code off in its process.
PY_HOST_MODULE = ("import runpy, sys\n"
                  "import chip_smoke\n"
                  "chip_smoke.python_host()\n"
                  "sys.argv[0] = sys.argv.pop(1)\n"
                  "runpy.run_module(sys.argv[0], run_name='__main__', "
                  "alter_sys=True)\n")


def bound_ms(ring, idx, last) -> tuple:
    """(bound ms, bytes, sector bytes): idx and out once, last once, and
    the distinct ring words that in-window indices touch, over the HBM
    rate. Sector bytes count each touched ring word as the 32-byte
    sector it moves in between device memory and L2 (W a multiple of 8,
    so ring rows are whole sectors): what a cold call must move."""
    import torch
    g, p, w = ring.shape
    flat = idx.reshape(g * p, -1)
    lst = last.reshape(g * p, 1)
    valid = (flat >= 1) & (flat > lst - w) & (flat <= lst)
    touched = torch.zeros(g * p, w, dtype=torch.bool, device=idx.device)
    rows = torch.arange(g * p, device=idx.device)[:, None].expand_as(flat)
    touched[rows[valid], torch.remainder(flat, w)[valid].long()] = True
    streamed = 4 * (2 * idx.numel() + last.numel())
    nbytes = streamed + 4 * int(touched.sum())
    sectors = int(touched.view(-1, 8).any(dim=1).sum()) if w % 8 == 0 else 0
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes, streamed + 32 * sectors


# phase_kernel's cases: (label, trailing idx dims, groups, W, peer
# columns). The engine's shapes and edge cases; the blocks of the device
# mesh (a groups cell of 4 x 1, a peers cell of 1 x 5) and of a
# collective rank; then the bench's other shapes (BENCH_WIDTHS): churn at
# 7 peers, shallow_clients' 8 tenants of 3 peers at max_ents 8, latency,
# qread and expiry_wave, and frames_soak's engines (W=8, max_ents 2).
KERNEL_CASES = (
    ("send_assembly", (P,), G, W, P), ("conflict_scan", (E,), G, W, P),
    ("cli_conflict_scan", (CLI_E,), G, W, P),
    ("ragged_rows", (P,), 99_999, W, P), ("PxE", (P, E), G, W, P),
    ("empty_trailing", (), G, W, P), ("W8", (P,), G, 8, P),
    ("misaligned_idx", (E,), G, W, P),
    ("mesh_groups_send", (P,), G // 4, W, P),
    ("mesh_groups_conflict", (E,), G // 4, W, P),
    ("mesh_peers_send", (P,), G, W, 1),
    ("mesh_peers_conflict", (E,), G, W, 1),
    ("collective_conflict", (CLI_E,), G, W, 1),
    ("churn_send", (7,), G, W, 7), ("churn_conflict", (E,), G, W, 7),
    ("shallow_send", (3,), 8, W, 3), ("shallow_conflict", (CLI_E,), 8, W, 3),
    ("latency_send", (P,), 12_500, W, P),
    ("latency_conflict", (E,), 12_500, W, P),
    ("qread_send", (P,), 8_192, W, P), ("qread_conflict", (E,), 8_192, W, P),
    ("expiry_send", (P,), 4_096, W, P),
    ("expiry_conflict", (E,), 4_096, W, P),
    ("soak_send", (P,), 12_500, 8, P), ("soak_conflict", (2,), 12_500, 8, P))
# Cases held for equality only: the rest are the shapes paths launch, timed.
KERNEL_EDGE_CASES = {"ragged_rows", "PxE", "empty_trailing", "W8",
                     "misaligned_idx"}


def phase_kernel(dev):
    """Kernel vs plain on the card: every instantiation exactly equal to
    `ring_resolve_ref` at every case; at every launched shape (all cases
    but KERNEL_EDGE_CASES) the kernel's, the plain version's and
    torch.gather's times beside the bound, the launch floor and host µs
    per call. Returns the kernel entry of the report (times at the first
    case, send assembly T=(P,))."""
    import torch
    from etcd_tpu_torch.ops import ring_resolve as rr
    from etcd_tpu_torch.ops.ring_resolve_timing import (
        cuda_ms, graph_ms, host_us, resolve_inputs, rotating)
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    resolve, ref = rr.ring_resolve, rr.ring_resolve_ref
    counts0 = dict(resolve.launches_by_variant)
    max_err = 0
    inputs = {}
    for label, trailing, groups, w, peers in KERNEL_CASES:
        ring, idx, last = (torch.from_numpy(a).to(dev) for a in
                           resolve_inputs(rng, trailing, groups, w, peers))
        if label == "misaligned_idx":   # 4 bytes past a 16-byte boundary
            buf = torch.empty(idx.numel() + 1, dtype=torch.int32, device=dev)
            buf[1:] = idx.reshape(-1)
            idx = buf[1:].view(idx.shape)
        got = resolve(ring, idx, last)
        want = ref(ring, idx, last)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"ring_resolve != plain at {label}")
        inputs[label] = (ring, idx, last)
    by_variant = {k: resolve.launches_by_variant[k] - counts0[k]
                  for k in counts0}
    if not all(by_variant.values()):
        raise AssertionError(f"an instantiation was not held against the "
                             f"plain version: {by_variant}")
    log("kernel_equal", t0, cases=list(inputs), equal=True,
        max_abs_err=max_err, launches_by_variant=by_variant)

    entry = None
    for label, args in inputs.items():
        if label in KERNEL_EDGE_CASES:
            continue
        ring, idx, last = args
        g, p, w = ring.shape
        b_ms, nbytes, sector_bytes = bound_ms(ring, idx, last)
        slot = torch.remainder(idx.reshape(g, p, -1), w).long()
        kern = rotating(resolve, args)
        floor = rotating(rr.launch_floor, args)
        ms = cuda_ms(kern)
        dev_ms = graph_ms(kern)
        warm_ms = graph_ms(lambda: resolve(ring, idx, last))
        plain_ms = cuda_ms(rotating(ref, args))
        library_ms = cuda_ms(rotating(
            lambda r, s: torch.gather(r, 2, s), (ring, slot)))
        copy_ms = graph_ms(rotating(lambda x, o: o.copy_(x),
                                    (idx, torch.empty_like(idx))))
        plan = rr.device_plan(g * p, idx.numel() // (g * p), w, dev.index)
        log("kernel_vs_plain", t0, shape=label, idx_shape=list(idx.shape),
            equal=True, ms=ms, graph_ms=dev_ms, graph_ms_one_input=warm_ms,
            plain_ms=plain_ms, gather_ms=library_ms, copy_idx_graph_ms=copy_ms,
            bound_ms=b_ms, bytes=nbytes, sector_bytes=sector_bytes,
            sector_bound_ms=sector_bytes / HBM_BYTES_PER_S * 1e3,
            share_of_bound=b_ms / ms,
            graph_share_of_bound=b_ms / dev_ms, plan=plan._asdict())
        host, host_floor = host_us(kern), host_us(floor)
        log("launch_floor", t0, shape=label, empty_kernel_ms=cuda_ms(floor),
            empty_kernel_graph_ms=graph_ms(floor),
            host_us_per_call=host[0], us_per_call_after_sync=host[1],
            empty_kernel_host_us_per_call=host_floor[0],
            empty_like_host_us_per_call=host_us(
                lambda: torch.empty_like(idx))[0])
        if entry is None:
            entry = {"name": "ring_resolve", "route": "cuda",
                     "source": "etcd_tpu_torch/ops/csrc/ring_resolve.cu",
                     "replaces": "etcd_tpu/ops/pallas_kernels.py:94",
                     "shape": list(idx.shape), "ms": ms,
                     "graph_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms,
                     "bound_by": "bytes", "library_ms": library_ms}
    entry["max_abs_err"] = max_err
    return entry


# phase_quiet_hop's kernel-level shapes: (label, groups, peers, W, E).
# The benchmark's two (mt100k-r5, mt100k-r7), the CLI's max_ents 8, the
# bench's smaller quiet rounds (latency, qread, expiry_wave,
# shallow_clients), frames_soak's W=8 and max_ents 2, the widest the
# passes take (P=8, E=8) and a group count that leaves a ragged block.
QUIET_SHAPES = (
    ("mt100k_r5", G, 5, W, E), ("mt100k_r7", G, 7, W, E),
    ("cli", G, P, W, CLI_E), ("latency", 12_500, P, W, E),
    ("qread", 8_192, P, W, E), ("expiry_wave", 4_096, P, W, E),
    ("shallow_clients", 8, 3, W, CLI_E), ("frames_soak_w8", 12_500, P, 8, 2),
    ("widest_p8_e8", 50_000, 8, W, 8), ("ragged", 99_991, 7, W, E))
# (tick, force_hb, drop) variants of every shape.
QUIET_VARIANTS = ((True, False, True), (False, False, False),
                  (True, True, False), (False, True, True))


def quiet_inputs(rng: np.random.RandomState, groups: int, peers: int,
                 window: int, max_ents: int, tick: bool,
                 election_tick: int = 10) -> tuple:
    """Random (state fields, inbox, prop_count, prop_slot, drop) numpy
    arrays on which `_quiet_pred` holds, for the differentials of the
    fused passes against the PyTorch hop: at most one live leader a
    group, no live candidate, no pending host work, every message at
    its receiver's term and no vote traffic, and (with `tick`) no
    follower due to campaign. Indices, terms and counts are drawn in
    small ranges around each row's log so that every branch of the hop
    is taken: appends that match, conflict (truncating, at or below the
    commit), escape below the window or are below the commit; rejects in
    probe and replicate; stale heartbeat responses; admission near half
    the window; masked slots."""
    from etcd_tpu_torch.ops.state import (CANDIDATE, FOLLOWER, LEADER, M_APP,
                                          M_APP_RESP, M_HB, M_HB_RESP,
                                          N_FIXED_FIELDS)
    G, P, W, E = groups, peers, window, max_ents
    F = N_FIXED_FIELDS + E
    r = rng.randint
    mask = rng.rand(G, P) < 0.85
    ldr = np.where(rng.rand(G) < 0.9, r(0, P, G), -1)
    state = np.full((G, P), FOLLOWER, np.int32)
    state[np.arange(G), np.maximum(ldr, 0)] = np.where(ldr >= 0, LEADER,
                                                       FOLLOWER)
    # A slot out of the mask may hold any role.
    state = np.where(mask, state, r(0, 3, (G, P))).astype(np.int32)
    term = (r(1, 4, G)[:, None] + (rng.rand(G, P) < 0.1)).astype(np.int32)
    is_l = state == LEADER
    elapsed = np.where(is_l, r(0, 6, (G, P)),
                       r(0, election_tick - 1 if tick else 30, (G, P)))
    last = r(0, 40, (G, P))
    commit = np.where(rng.rand(G, P) < 0.05, last + r(1, 3, (G, P)),
                      (last * rng.rand(G, P)).astype(np.int64))
    # The leader's tail near half the window (admission near its room).
    log_term = r(0, 5, (G, P, W))
    match = r(0, 44, (G, P, P))
    nxt = np.where(rng.rand(G, P, P) < 0.8, match + 1 + r(0, 8, (G, P, P)),
                   r(-1, 46, (G, P, P)))
    ack_age = np.where(rng.rand(G, P, P) < 0.02, (1 << 20) - r(0, 2,
                                                                (G, P, P)),
                       r(0, 12, (G, P, P)))
    st = {
        "term": term, "vote": r(0, P + 1, (G, P)), "commit": commit,
        "lead": r(0, P + 1, (G, P)), "state": state, "elapsed": elapsed,
        "prng": r(1, 2 ** 31, (G, P)).astype(np.uint32),
        "log_term": log_term, "last_index": last, "match": match,
        "next": nxt, "pr_state": r(0, 2, (G, P, P)),
        "paused": rng.rand(G, P, P) < 0.3, "ack_age": ack_age,
        "votes": r(0, 3, (G, P, P)), "peer_mask": mask,
        "need_host": np.zeros((G, P), np.int32)}
    st = {k: (v if k in ("prng", "paused", "peer_mask")
              else v.astype(np.int32)) for k, v in st.items()}

    inbox = np.zeros((G, P, P, F), np.int32)
    kinds = np.array([0, 0, M_APP, M_APP_RESP, M_HB, M_HB_RESP])
    mtype = kinds[r(0, len(kinds), (G, P, P))]
    inbox[..., 0] = mtype
    inbox[..., 1] = term[:, :, None]
    last3 = last[:, :, None]
    index = np.clip(last3 + r(-W - 3, 6, (G, P, P)), 0, None)
    inbox[..., 2] = np.where(rng.rand(G, P, P) < 0.1, r(0, 50, (G, P, P)),
                             index)
    # Log terms that match the receiver's ring more often than not.
    ring_t = np.take_along_axis(log_term, inbox[..., 2] % W, axis=2)
    inbox[..., 3] = np.where(rng.rand(G, P, P) < 0.7, ring_t,
                             r(0, 5, (G, P, P)))
    inbox[..., 4] = r(0, 50, (G, P, P))
    inbox[..., 5] = (rng.rand(G, P, P) < 0.3) & (mtype == M_APP_RESP)
    inbox[..., 6] = r(0, 45, (G, P, P))
    inbox[..., 7] = np.where(mtype == M_APP, r(0, E + 1, (G, P, P)), 0)
    # Entry terms equal to the receiver's ring but, now and then, one.
    slots = (inbox[..., 2:3] + 1 + np.arange(E)) % W
    ents = np.take_along_axis(log_term[:, :, None, :].repeat(P, 2), slots,
                              axis=3)
    flip = rng.rand(G, P, P, E) < 0.08
    inbox[..., N_FIXED_FIELDS:] = np.where(flip, r(0, 5, (G, P, P, E)),
                                           ents)
    prop_count = r(0, E + 3, G).astype(np.int32)
    prop_slot = np.where(rng.rand(G) < 0.9, np.maximum(ldr, 0),
                         r(0, P, G)).astype(np.int32)
    drop = (rng.rand(G, P, P, 1) < 0.9).astype(np.int32)
    if CANDIDATE in state[mask]:
        raise AssertionError("quiet_inputs: a live candidate")
    return st, inbox, prop_count, prop_slot, drop


def quiet_hop_bytes(g, p, w, e) -> int:
    """Least device-memory bytes of a whole quiet hop, its predicate
    included: every array the hop reads read once and every array it
    writes written once, as a single pass would. The hop's device time
    is held against this floor."""
    gp, gpp = g * p, g * p * p
    mail = 4 * gpp * (8 + e)
    # inbox; term, state, elapsed, lead, commit, last_index, need_host;
    # peer_mask; log_term; match, next, pr_state, ack_age; paused;
    # prop_count, prop_slot
    read = mail + 28 * gp + gp + 4 * gp * w + 16 * gpp + gpp + 8 * g
    # routed inbox; elapsed, lead, commit, last_index, need_host;
    # log_term; match, next, pr_state, ack_age; paused
    written = mail + 20 * gp + 4 * gp * w + 16 * gpp + gpp
    return read + written


def quiet_pass_bytes(g, p, w, e) -> dict:
    """Least device-memory bytes of each fused pass: the words it must
    read and write, each once (the two ring_resolve launches between
    them are held against their own floor). The passes re-read state
    between them, so these sum to more than `quiet_hop_bytes`: a
    breakdown, not the hop's floor."""
    gp, gpp, f = g * p, g * p * p, 8 + e
    mail = 4 * gpp * f
    return {
        # types and terms of every message; term, state, elapsed,
        # need_host, mask
        "qh_pred": 8 * gpp + 16 * gp + gp,
        # mailbox, 7 words, mask, the ring word at the append's index,
        # match/next/pr/ack_age and paused in and out; elapsed, lead,
        # need_host, idx_j, sel, hb_fire, resp out
        "qh_msgs": mail + 28 * gp + gp + 4 * gp + 2 * (16 * gpp + gpp)
        + 12 * gp + 4 * gp * e + 8 * gp + 16 * gp,
        # the chosen message, my_t, 7 words, mask, props, ring,
        # match/next/pr, paused; ring, last, commit, need_host,
        # match/next, paused, prev, plan out
        "qh_commit": 4 * gp * f + 4 * gp * e + 28 * gp + gp + 8 * g
        + 4 * gp * w + 12 * gpp + gpp + 4 * gp * w + 12 * gp + 8 * gpp
        + gpp + 4 * gpp + 8 * gp,
        # plan, sel, resp, term, commit, ring, prev, prev_t, match; the
        # routed mailbox
        "qh_route": 8 * gp + 4 * gp + 16 * gp + 8 * gp + 4 * gp * w
        + 12 * gpp + mail,
    }


def _quiet_case(dev, cfg, arrays):
    """(state, inbox, prop_count, prop_slot, drop) on `dev` from
    quiet_inputs' numpy arrays."""
    import torch
    from etcd_tpu_torch.ops.state import state_from_numpy
    st_np, ib, pc, ps, drop = arrays
    return (state_from_numpy(st_np, dev),
            *(torch.from_numpy(a).to(dev) for a in (ib, pc, ps, drop)))


def _pytorch_quiet_hop(cfg, st, ib, pc, ps, tick, force_hb, drop):
    """The PyTorch hop the fused passes replace: `_step_body` with the
    quiet branch and the plain resolve, `route_local`, the drop mask."""
    from etcd_tpu_torch.ops import kernel
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve_ref
    s, out = kernel._step_body(cfg, st, ib, pc, ps, tick, quiet=True,
                               force_hb=force_hb, resolve=ring_resolve_ref)
    routed = kernel.route_local(out)
    return s, routed if drop is None else routed * drop


def _fields_equal(a, b, ib_a, ib_b) -> list:
    """The fields of two (state, inbox) results that differ."""
    import torch
    from etcd_tpu_torch.ops.state import GroupState
    bad = [n for n, x, y in zip(GroupState._fields, a, b)
           if not torch.equal(x, y)]
    return bad + ([] if torch.equal(ib_a, ib_b) else ["inbox"])


def phase_quiet_hop(dev, shapes=QUIET_SHAPES, round_groups=G, rounds=40,
                    warmup=20):
    """The fused quiet hop (ops/quiet_hop.py, csrc/quiet_hop.cu) against
    the PyTorch quiet hop on the card, exactly equal:

    - kernel level, at every QUIET_SHAPES shape and QUIET_VARIANTS
      variant, on random quiescent states (quiet_inputs): the
      predicate pass agrees with `_quiet_pred` (also on states made
      non-quiet in each of its six ways), and every state field and the
      routed inbox equal;
    - each pass's device time (torch.profiler over 20 hops) beside its
      byte floor, and a hop's time, fused and PyTorch, at the benchmark's
      two shapes;
    - round level, `step_routed_compact` (hops=3) at mt100k-r5's and
      mt100k-r7's shapes in lockstep with the PyTorch hop (the plain
      resolve): `warmup` boot rounds, then `rounds` rounds whose every
      hop is fused, equal after every round, each pass launched once a
      hop.

    Returns the report's kernel entry: the first shape's hop time (a
    CUDA-event loop, host path included), device time (the profiler's
    passes and resolves) and one-pass byte floor (`quiet_hop_bytes`),
    each timed shape's beside it, and the passes this phase launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from etcd_tpu_torch.ops import kernel, quiet_hop
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve_ref
    from etcd_tpu_torch.ops.ring_resolve_timing import cuda_ms
    from etcd_tpu_torch.ops.state import (KernelConfig, LEADER, init_state,
                                          state_from_numpy)
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    timed, by_shape = {}, {}
    launches0 = dict(quiet_hop.launches)
    for label, g, p, w, e in shapes:
        cfg = KernelConfig(groups=g, peers=p, window=w, max_ents=e,
                           heartbeat_tick=3)
        arrays = quiet_inputs(rng, g, p, w, e, tick=True)
        st, ib, pc, ps, drop = _quiet_case(dev, cfg, arrays)
        for tick, force_hb, with_drop in QUIET_VARIANTS:
            dm = drop if with_drop else None
            flag = quiet_hop.quiet_flag(cfg, st, ib, tick)
            want = kernel._quiet_pred(st, cfg, ib, st.peer_mask, tick)
            if int(flag) != 1 or not bool(want):
                raise AssertionError(f"quiet_hop {label}: flag "
                                     f"{int(flag)}, _quiet_pred "
                                     f"{bool(want)}")
            got = quiet_hop.fused_hop(cfg, st, ib, pc, ps, tick, force_hb,
                                      dm)
            ref = _pytorch_quiet_hop(cfg, st, ib, pc, ps, tick, force_hb,
                                     dm)
            torch.cuda.synchronize()
            bad = _fields_equal(got[0], ref[0], got[1], ref[1])
            if bad:
                raise AssertionError(f"quiet_hop {label} tick={tick} "
                                     f"force_hb={force_hb} drop="
                                     f"{with_drop}: {bad} differ")
        # The predicate on states each made non-quiet one way.
        st_np = arrays[0]
        for way in range(6):
            s2 = {k: v.copy() for k, v in st_np.items()}
            ib2 = arrays[1].copy()
            gi, pi = int(rng.randint(g)), int(rng.randint(p))
            if way == 0:
                s2["need_host"][gi, pi] = 1
            elif way == 1:
                s2["state"][gi, pi], s2["peer_mask"][gi, pi] = 1, True
            elif way == 2:
                ib2[gi, pi, 0, 0] = 3
            elif way == 3:
                ib2[gi, pi, 0, :2] = (2, 99)
            elif way == 4:
                s2["state"][gi, :], s2["peer_mask"][gi, :] = LEADER, True
            else:
                s2["state"][gi, pi], s2["peer_mask"][gi, pi] = 0, True
                s2["elapsed"][gi, pi] = cfg.election_tick
            st2 = state_from_numpy(s2, dev)
            ib2 = torch.from_numpy(ib2).to(dev)
            want = bool(kernel._quiet_pred(st2, cfg, ib2, st2.peer_mask,
                                           True))
            got = int(quiet_hop.quiet_flag(cfg, st2, ib2, True))
            if want != bool(got) or (want and p > 1):
                raise AssertionError(f"quiet_hop {label}: predicate pass "
                                     f"{got} != _quiet_pred {want} "
                                     f"(way {way})")
        log("quiet_hop_equal", t0, shape=label, groups=g, peers=p, window=w,
            max_ents=e, variants=len(QUIET_VARIANTS), equal=True)
        if label in ("mt100k_r5", "mt100k_r7"):
            timed[label] = (cfg, st, ib, pc, ps)

    for label, (cfg, st, ib, pc, ps) in timed.items():
        g, p, w, e = cfg.groups, cfg.peers, cfg.window, cfg.max_ents
        floor = quiet_pass_bytes(g, p, w, e)

        def fused():
            quiet_hop.quiet_flag(cfg, st, ib, True)
            return quiet_hop.fused_hop(cfg, st, ib, pc, ps, True)

        def pytorch():
            kernel._quiet_pred(st, cfg, ib, st.peer_mask, True)
            return _pytorch_quiet_hop(cfg, st, ib, pc, ps, True, False,
                                      None)
        fused_ms, pytorch_ms = cuda_ms(fused, 20), cuda_ms(pytorch, 5)
        # The predicate alone, which every hop on the card runs (the
        # full path's hops too): the pass against `_quiet_pred`'s ops.
        pred_ms_fused = cuda_ms(
            lambda: quiet_hop.quiet_flag(cfg, st, ib, True), 20)
        pred_ms_pytorch = cuda_ms(
            lambda: kernel._quiet_pred(st, cfg, ib, st.peer_mask, True), 20)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kernel._quiet_pred(st, cfg, ib, st.peer_mask, True)
            torch.cuda.synchronize()
        pred_ops = [ev for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fused()
            torch.cuda.synchronize()
        by = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                name = next((k for k in (*floor, "ring_resolve")
                             if k in ev.name), "other")
                by[name] = by.get(name, 0.0) + ev.time_range.elapsed_us()
        passes = {}
        for name, us in by.items():
            ms = us / 20 / 1e3 / (2 if name == "ring_resolve" else 1)
            row = {"device_ms": ms}
            if name in floor:
                bound = floor[name] / HBM_BYTES_PER_S * 1e3
                row.update(bytes=floor[name], bound_ms=bound,
                           share_of_bound=bound / ms)
            passes[name] = row
        hop_bytes = quiet_hop_bytes(g, p, w, e)
        device_ms = sum(v["device_ms"] * (2 if k == "ring_resolve" else 1)
                        for k, v in passes.items())
        hop = {"shape": [g, p, w, e], "ms": fused_ms,
               "device_ms": device_ms, "plain_ms": pytorch_ms,
               "bytes": hop_bytes,
               "bound_ms": hop_bytes / HBM_BYTES_PER_S * 1e3,
               "pred_ms": pred_ms_fused, "plain_pred_ms": pred_ms_pytorch,
               "plain_pred_device_ops": len(pred_ops),
               "plain_pred_device_ms": sum(ev.time_range.elapsed_us()
                                           for ev in pred_ops) / 1e3}
        by_shape[label] = hop
        pass_bytes = sum(floor.values())
        log("quiet_hop_time", t0, shape=label, groups=g, peers=p,
            hop_ms_fused=fused_ms, hop_ms_pytorch=pytorch_ms,
            passes=passes, floor_bytes=hop_bytes,
            floor_ms=hop["bound_ms"], device_ms=device_ms,
            share_of_bound=hop["bound_ms"] / device_ms,
            pass_floor_bytes=pass_bytes,
            pass_floor_ms=pass_bytes / HBM_BYTES_PER_S * 1e3,
            pred_ms_fused=pred_ms_fused, pred_ms_pytorch=pred_ms_pytorch,
            pred_device_ops_pytorch=hop["plain_pred_device_ops"],
            pred_device_ms_pytorch=hop["plain_pred_device_ms"])
    del timed

    for peers in (5, 7):
        cfg = KernelConfig(groups=round_groups, peers=peers, window=W,
                           max_ents=E, heartbeat_tick=3)
        st_k = init_state(cfg, stagger=True, device=dev)
        st_p = init_state(cfg, stagger=True, device=dev)
        ib_k = torch.zeros((round_groups, peers, peers, cfg.fields),
                           dtype=torch.int32, device=dev)
        ib_p = ib_k.clone()
        counts = dict.fromkeys(kernel.hop_counts, 0)
        launched = dict.fromkeys(quiet_hop.launches, 0)
        t_f = t_p = 0.0
        for r in range(warmup + rounds):
            lead = (st_k.state == LEADER) & st_k.peer_mask
            props = (torch.where(lead.any(dim=1), E, 0).to(torch.int32),
                     kernel._first_true(lead, dim=1))
            h0, q0 = dict(kernel.hop_counts), dict(quiet_hop.launches)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out_k = kernel.step_routed_compact(cfg, st_k, ib_k, *props,
                                               True, None, 3)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            d = {k: kernel.hop_counts[k] - h0[k] for k in h0}
            dq = {k: quiet_hop.launches[k] - q0[k] for k in q0}
            out_p = kernel.step_routed_compact(cfg, st_p, ib_p, *props,
                                               True, None, 3,
                                               resolve=ring_resolve_ref)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            (st_k, ib_k), (st_p, ib_p) = out_k[:2], out_p[:2]
            if not (_states_equal(st_k, st_p)
                    and _states_equal(out_k[1:], out_p[1:])):
                raise AssertionError(f"quiet_hop round P={peers}: fused "
                                     f"round != PyTorch at {r}")
            if r >= warmup:
                for k in d:
                    counts[k] += d[k]
                for k in dq:
                    launched[k] += dq[k]
                t_f += t2 - t1
                t_p += t3 - t2
        share = counts["fused"] / max(1, sum(counts.values()))
        if counts["fused"] != 3 * rounds:
            raise AssertionError(f"quiet_hop round P={peers}: hops "
                                 f"{counts}, not {3 * rounds} fused")
        if launched != dict.fromkeys(launched, 3 * rounds):
            raise AssertionError(f"quiet_hop round P={peers}: passes "
                                 f"launched {launched} in {3 * rounds} "
                                 f"fused hops")
        log("quiet_hop_round", t0, groups=round_groups, peers=peers, hops=3,
            rounds=rounds, warmup=warmup, equal_to_pytorch=True,
            hop_counts=counts, launches_by_pass=launched,
            fused_hop_share=100.0 * share,
            ms_per_round_fused=t_f / rounds * 1e3,
            ms_per_round_pytorch=t_p / rounds * 1e3,
            commits=int(st_k.commit.amax(dim=1).sum()))
    first = by_shape.get("mt100k_r5", {})
    return {"name": "quiet_hop", "route": "cuda",
            "source": "etcd_tpu_torch/ops/csrc/quiet_hop.cu",
            "replaces": "etcd_tpu_torch/ops/kernel.py:_hop (the quiet "
                        "branch of _step_body and route_local)",
            **first, "bound_by": "bytes", "by_shape": by_shape,
            "launches_by_pass": {k: quiet_hop.launches[k] - launches0[k]
                                 for k in launches0}}


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _states_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


# phase_round's locksteps: name -> (KernelConfig fields, hops, slots).
# slots: the multi-host engine's step_routed_slots_auto, E entries at
# each leader slot; else step_routed_compact, E entries at each group's
# first leader slot, as the engine and the bench's rounds propose.
ROUNDS = {
    "round": (dict(groups=G, peers=P, window=W, max_ents=E), 3, False),
    # the multi-host ranks (either plane) at the CLI's max_ents
    "round_slots": (dict(groups=G, peers=P, window=W, max_ents=CLI_E), 1,
                    True),
    # the bench's churn: 7 peers, hops 1, 10% of leaders partitioned
    "round_churn": (dict(groups=G, peers=7, window=W, max_ents=E), 1, False),
    # frames_soak's engines (SOAK_GROUPS; W=8, max_ents 2)
    "round_frames_soak": (dict(groups=12_500, peers=P, window=8,
                               max_ents=2), 1, True),
}
CHURN_AT = 8     # round_churn partitions once every group has led (bench.boot)


def phase_round(dev, name="round", groups=None, rounds=40):
    """Full-width rounds at ROUNDS[name] with the kernel and with the
    plain resolve, in lockstep, every output equal after every round; on
    the card, the instantiations of both call shapes (send assembly
    (G, P, P), conflict scan (G, P, E)) launched. round_churn partitions
    the leaders of 10% of groups at round CHURN_AT, as the bench's churn
    does (`bench.churn_mask`). "round" also profiles its steady state on
    the card."""
    import torch
    from etcd_tpu_torch import bench
    from etcd_tpu_torch.ops import kernel
    from etcd_tpu_torch.ops.ring_resolve import (
        ring_resolve, ring_resolve_ref, stage_shape)
    from etcd_tpu_torch.ops.state import KernelConfig, LEADER, init_state
    t0 = time.perf_counter()
    fields, hops, slots = ROUNDS[name]
    cfg = KernelConfig(**dict(fields, groups=groups or fields["groups"]),
                       heartbeat_tick=3)
    g, p, e = cfg.groups, cfg.peers, cfg.max_ents
    step = (kernel.step_routed_slots_auto if slots
            else kernel.step_routed_compact)
    st_k = init_state(cfg, stagger=True, device=dev)
    st_p = init_state(cfg, stagger=True, device=dev)
    ib_k = torch.zeros((g, p, p, cfg.fields), dtype=torch.int32, device=dev)
    ib_p = ib_k.clone()
    by0 = dict(ring_resolve.launches_by_variant)
    drop = None
    t_kernel = 0.0
    for r in range(rounds):
        lead = (st_k.state == LEADER) & st_k.peer_mask
        if slots:
            props = (torch.where(lead, e, 0).to(torch.int32),)
        else:
            props = (torch.where(lead.any(dim=1), e, 0).to(torch.int32),
                     kernel._first_true(lead, dim=1))
        if name == "round_churn" and r == CHURN_AT:
            m, _ = bench.churn_mask(np.random.RandomState(SEED), g, p,
                                    bench.current_slots(st_k))
            drop = torch.from_numpy(m).to(dev)
        _sync(dev)
        t1 = time.perf_counter()
        out_k = step(cfg, st_k, ib_k, *props, True, drop, hops)
        _sync(dev)
        t_kernel += time.perf_counter() - t1
        out_p = step(cfg, st_p, ib_p, *props, True, drop, hops,
                     resolve=ring_resolve_ref)
        (st_k, ib_k), (st_p, ib_p) = out_k[:2], out_p[:2]
        if not (_states_equal(st_k, st_p) and _states_equal(out_k[1:],
                                                            out_p[1:])):
            raise AssertionError(f"{name}: kernel round != plain at {r}")
    led = bool(((st_k.state == LEADER) & st_k.peer_mask).any(dim=1).all())
    commits = int(st_k.commit.amax(dim=1).sum())
    if not led or commits <= 0:
        raise AssertionError(f"{name}: led={led} commits={commits}")
    by = {k: ring_resolve.launches_by_variant[k] - by0[k] for k in by0}
    want = {stage_shape(p)[0], stage_shape(e)[0]}
    if torch.device(dev).type == "cuda" and not all(by[v] for v in want):
        raise AssertionError(f"{name}: {sorted(want)} not all launched: "
                             f"{by}")
    log(name, t0, groups=g, peers=p, window=cfg.window, max_ents=e,
        hops=hops, rounds=rounds, equal_to_plain=True,
        ms_per_round=t_kernel / rounds * 1e3,
        committed_entries_per_s=commits / t_kernel,
        launches=sum(by.values()), launches_by_variant=by)
    if name == "round" and torch.device(dev).type == "cuda":
        round_profile(cfg, st_k, ib_k, *props)


def round_profile(cfg, st, inbox, pc, ps, rounds=5):
    """Where a steady-state round's time goes: torch.profiler over a few
    rounds; device busy time, CUDA kernels per round, the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from etcd_tpu_torch.ops import kernel
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(rounds):
            st, inbox, _, _ = kernel.step_routed_compact(
                cfg, st, inbox, pc, ps, True, None, 3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    avg = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    top = sorted(avg, key=dev_us, reverse=True)[:6]
    log("round_profile", t0, rounds=rounds,
        wall_ms_per_round=wall / rounds * 1e3,
        device_busy_ms_per_round=busy_ms / rounds if kern else None,
        device_idle_share=1 - busy_ms / (wall * 1e3) if kern else None,
        cuda_kernels_per_round=len(kern) / rounds if kern else None,
        top_device_ops=[[e.key[:60], e.count // rounds,
                         round(dev_us(e) / rounds / 1e3, 4)] for e in top])


MESH_LAYOUTS = (("unsharded", None), ("groups_4x1", (4, 1)),
                ("peers_1x5", (1, P)))


def _mesh_step(name, meshes, cfg, st, ib, pc, ps, drop, stats=None):
    """One bench-shape round (hops=3) of layout `name`, in place in the
    st/ib dicts: unsharded, or on the layout's mesh."""
    from etcd_tpu_torch.ops import kernel
    from etcd_tpu_torch.parallel.mesh import mesh_round
    if name not in meshes:
        st[name], ib[name] = kernel.step_routed_auto(
            cfg, st[name], ib[name], pc, ps, True, drop, 3)
    else:
        st[name], ib[name] = mesh_round(
            kernel.step_routed_auto, cfg, st[name], ib[name], pc, ps, True,
            drop, 3, stats=stats)


def _mesh_profile(step, rounds=2) -> dict:
    """torch.profiler over `rounds` calls of step(): wall and device-busy
    ms per round, the device's idle share and CUDA kernels per round."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(rounds):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    return {"rounds": rounds, "wall_ms_per_round": wall / rounds * 1e3,
            "device_busy_ms_per_round": busy_ms / rounds,
            "device_idle_share": 1 - busy_ms / (wall * 1e3),
            "cuda_kernels_per_round": len(kern) / rounds}


def phase_mesh_round(dev, groups=G, rounds=40, layouts=MESH_LAYOUTS,
                     devices=None):
    """The round on the in-process device mesh at the bench shape (E=4,
    hops=3, stagger boot): unsharded, the groups axis (4 x 1 cells) and
    the peers axis (1 x 5 cells), every cell on `dev` (the one card).
    Each round takes the same random proposals (a count and a slot per
    group) and drops (5% of the mailbox, cut after every hop) in every
    layout, and the sharded layouts' state and inbox must equal the
    unsharded round's after every round. Per layout: ms per round, the
    comm's calls per round and ms per call (one cell's view),
    ring_resolve's launches by instantiation and, on the card, a
    torch.profiler window of two more rounds. `devices` (default: `dev`
    repeated) are the cells' devices, row by row. Returns the launches
    by layout."""
    import torch
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    from etcd_tpu_torch.ops.state import KernelConfig, LEADER, init_state
    from etcd_tpu_torch.parallel.comm import CommStats
    from etcd_tpu_torch.parallel.mesh import (make_mesh, shard_mailbox,
                                              shard_state, unshard_mailbox,
                                              unshard_state)
    t0 = time.perf_counter()
    cfg = KernelConfig(groups=groups, peers=P, window=W, max_ents=E,
                       heartbeat_tick=3)
    meshes, st, ib, stats = {}, {}, {}, {}
    for name, shape in layouts:
        st[name] = init_state(cfg, stagger=True, device=dev)
        ib[name] = torch.zeros((groups, P, P, cfg.fields),
                               dtype=torch.int32, device=dev)
        if shape is not None:
            n = shape[0] * shape[1]
            m = meshes[name] = make_mesh(
                (devices or [dev] * n)[:n], peers_axis=shape[1])
            st[name] = shard_state(st[name], m)
            ib[name] = shard_mailbox(ib[name], m)
            stats[name] = CommStats()
    secs = dict.fromkeys(st, 0.0)
    _launches_reset()  # this path starts here
    by = {name: dict.fromkeys(ring_resolve.launches_by_variant, 0)
          for name in st}
    rng = np.random.RandomState(SEED)
    for r in range(rounds):
        pc = torch.from_numpy(rng.randint(0, E + 1, groups)
                              .astype(np.int32)).to(dev)
        ps = torch.from_numpy(rng.randint(0, P, groups)
                              .astype(np.int32)).to(dev)
        drop = torch.from_numpy((rng.rand(groups, P, P, 1) >= 0.05)
                                .astype(np.int32)).to(dev)
        for name, _ in layouts:
            before = dict(ring_resolve.launches_by_variant)
            _sync(dev)
            t1 = time.perf_counter()
            _mesh_step(name, meshes, cfg, st, ib, pc, ps, drop,
                       stats.get(name))
            _sync(dev)
            secs[name] += time.perf_counter() - t1
            for k, v in ring_resolve.launches_by_variant.items():
                by[name][k] += v - before[k]
        for name in meshes:
            if not (_states_equal(st["unsharded"],
                                  unshard_state(st[name], dev))
                    and torch.equal(ib["unsharded"],
                                    unshard_mailbox(ib[name], dev))):
                raise AssertionError(f"mesh round {name} != unsharded "
                                     f"round at {r}")
    ref = st["unsharded"]
    led = int(((ref.state == LEADER) & ref.peer_mask).any(dim=1).sum())
    commits = int(ref.commit.amax(dim=1).sum())
    if led < groups // 2 or commits <= 0:
        raise AssertionError(f"mesh_round: led={led} commits={commits}")
    if torch.device(dev).type == "cuda" and not all(
            sum(v.values()) for v in by.values()):
        raise AssertionError(f"mesh_round: kernels launched {by}")
    prof = {}
    if torch.device(dev).type == "cuda":
        for name, _ in layouts:
            prof[name] = _mesh_profile(
                lambda name=name: _mesh_step(name, meshes, cfg, st, ib,
                                             pc, ps, drop))
    for name, shape in layouts:
        comm = None
        if name in stats:
            comm = {op: {"calls_per_round": d["calls"] / rounds,
                         "ms_per_call": d["seconds"] / d["calls"] * 1e3}
                    for op, d in stats[name].as_dict().items()}
        log("mesh_round", t0, layout=name,
            mesh=None if shape is None else list(shape), groups=groups,
            rounds=rounds, hops=3, equal_to_unsharded=True,
            ms_per_round=secs[name] / rounds * 1e3,
            launches_by_variant=by[name], comm=comm,
            profile=prof.get(name))
    log("mesh_round", t0, step="end", groups_led=led,
        committed_entries=commits, launches=ring_resolve.launches)
    return by


def phase_small_card_vs_cpu(dev, groups=64, rounds=30):
    """Small-G trajectory with random drops on the card and on the CPU."""
    import torch
    from etcd_tpu_torch.ops import kernel
    from etcd_tpu_torch.ops.state import (KernelConfig, LEADER, init_state,
                                          state_to_numpy)
    t0 = time.perf_counter()
    cfg = KernelConfig(groups=groups, peers=P, window=W, max_ents=E,
                       heartbeat_tick=3)
    rng = np.random.RandomState(SEED)
    sts = {d: init_state(cfg, stagger=True, device=d) for d in (dev, "cpu")}
    ibs = {d: torch.zeros((groups, P, P, cfg.fields), dtype=torch.int32,
                          device=d) for d in (dev, "cpu")}
    for r in range(rounds):
        s_np = state_to_numpy(sts["cpu"])
        lead = (s_np["state"] == LEADER) & s_np["peer_mask"]
        pc = (rng.randint(0, E + 2, groups) * lead.any(1)).astype(np.int32)
        ps = lead.argmax(1).astype(np.int32)
        drop = (rng.rand(groups, P, P, 1) >= 0.1).astype(np.int32)
        outs = {}
        for d in (dev, "cpu"):
            t = lambda a: torch.from_numpy(a).to(d)  # noqa: E731
            outs[d] = kernel.step_routed_compact(
                cfg, sts[d], ibs[d], t(pc), t(ps), bool(r % 4 != 3),
                t(drop), 3)
            sts[d], ibs[d] = outs[d][0], outs[d][1]
        a, b = state_to_numpy(sts[dev]), state_to_numpy(sts["cpu"])
        same = all(np.array_equal(a[k], b[k]) for k in a) and all(
            torch.equal(x.cpu(), y) for x, y in zip(outs[dev][1:],
                                                    outs["cpu"][1:]))
        if not same:
            raise AssertionError(f"card round != cpu round at {r}")
    log("small_card_vs_cpu", t0, groups=groups, rounds=rounds, equal=True)


def phase_engine(dev, groups=G, tenants=1000, quorum_gets=100, mesh=None,
                 name="engine", native=True):
    """The serving path through MultiEngine's public entry points, on one
    device or (`mesh`) sharded over a device mesh, with the C host code
    (codecs and store) on or off. Returns the ring_resolve launches
    counted across it, in all and by instantiation, and the fused quiet
    hop's by pass."""
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from etcd_tpu_torch.server.request import Request
    t0 = time.perf_counter()
    cfg = dict(groups=groups, peers=P, window=W, max_ents=E,
               heartbeat_tick=3, fsync=True, stagger=True, hops=3,
               device=str(dev), mesh=mesh)
    gs = [i * groups // tenants for i in range(tenants)]
    with host_code(native), \
            tempfile.TemporaryDirectory(prefix="chip_smoke-") as d:
        _launches_reset()  # the main path starts here
        eng = MultiEngine(EngineConfig(data_dir=d, **cfg))
        boot_rounds = 0
        for _ in range(12):
            eng.run_round()
            boot_rounds += 1
            if (np.where(eng.h_mask, eng.h_state, 0) == 2).any(1).all():
                break
        if not (np.where(eng.h_mask, eng.h_state, 0) == 2).any(1).all():
            raise AssertionError("engine elections did not converge")
        log(f"{name}_boot", t0, rounds=boot_rounds,
            mesh=None if mesh is None else list(mesh.shape))
        eng.start()
        lat, errs = {}, []

        def worker(chunk, method):
            for g in chunk:
                try:
                    t1 = time.perf_counter()
                    if method == "PUT":
                        res = eng.do(g, Request(method="PUT", path="/smoke",
                                                val=f"v{g}"), timeout=60)
                        lat[g] = time.perf_counter() - t1
                    else:
                        res = eng.do(g, Request(method="GET", path="/smoke",
                                                quorum=True), timeout=60)
                        if res.node.value != f"v{g}":
                            raise AssertionError(f"quorum GET g={g}")
                except Exception as e:  # noqa: BLE001 — reported below
                    errs.append((g, method, repr(e)))

        def run(items, method, n_threads):
            th = [threading.Thread(target=worker,
                                   args=(items[i::n_threads], method))
                  for i in range(n_threads)]
            for t in th:
                t.start()
            for t in th:
                t.join(timeout=300)
            if any(t.is_alive() for t in th):
                raise AssertionError(f"{method} workers hung")

        r0, t1 = eng.round_no, time.perf_counter()
        run(gs, "PUT", 100)
        t_w = time.perf_counter() - t1
        rounds_w = eng.round_no - r0
        if errs or len(lat) != tenants:
            raise AssertionError(f"PUT failures: {errs[:5]}")
        store_cls = type(eng.store(gs[0])).__name__
        if store_cls != ("NativeStore" if native else "Store"):
            raise AssertionError(f"native={native} served from {store_cls}")
        for g in gs:
            if eng.do(g, Request(method="GET", path="/smoke")).node.value \
                    != f"v{g}":
                raise AssertionError(f"local GET g={g}")
        t1 = time.perf_counter()
        run(gs[:quorum_gets], "GET", quorum_gets)
        t_q = time.perf_counter() - t1
        if errs:
            raise AssertionError(f"quorum GET failures: {errs[:5]}")
        eng.stop()
        if eng.failed is not None:
            raise eng.failed
        launches = ring_resolve.launches   # the main path ends here
        by_variant = dict(ring_resolve.launches_by_variant)
        quiet = _quiet_launches()
        ms = np.array(sorted(lat.values())) * 1e3
        log(f"{name}_serve", t0, native=native, store=store_cls,
            acked=len(lat), write_s=t_w,
            acked_writes_per_s=len(lat) / t_w, rounds=rounds_w,
            rounds_per_s=rounds_w / t_w, ack_p50_ms=float(np.percentile(ms, 50)),
            ack_p99_ms=float(np.percentile(ms, 99)), quorum_gets=quorum_gets,
            quorum_get_s=t_q, launches=launches,
            launches_by_variant=by_variant, quiet_hop_launches=quiet,
            phase_s={k: round(v, 4) for k, v in eng.phase_s.items()},
            comm=None if eng.comm_stats is None
            else eng.comm_stats.as_dict())
        eng2 = MultiEngine(EngineConfig(data_dir=d, **cfg))
        missing = [g for g in gs if eng2.store(g).get(
            "/smoke", False, False).node.value != f"v{g}"]
        eng2.stop()
        if missing:
            raise AssertionError(f"acked writes lost on restart: {missing[:5]}")
        log(f"{name}_restart", t0, read_back=len(gs))
    return launches, by_variant, quiet


FORM = {"Content-Type": "application/x-www-form-urlencoded"}
REPO = os.path.dirname(os.path.abspath(__file__))


def _http(method, url, body=None, headers=None, timeout=60):
    """(status, JSON body or None) of one request over a real socket."""
    r = urllib.request.Request(url, data=body, method=method,
                               headers=headers or {})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            st, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        st, raw = e.code, e.read()
    return st, (json.loads(raw) if raw else None)


def _free_port() -> int:
    return _free_ports(1)[0]


def _free_ports(n: int) -> list:
    """n distinct free ports below the ephemeral range, so that a server
    restarted on its port does not find it taken by an outbound
    connection."""
    from etcd_tpu_torch.tools.multihost_supervisor import listen_ports
    return listen_ports(n)


def _in_threads(fn, items, n_threads=100, timeout=300):
    """fn(item) for every item, from n_threads threads; the errors."""
    errs = []

    def work(chunk):
        for it in chunk:
            try:
                fn(it)
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append((it, repr(e)))

    th = [threading.Thread(target=work, args=(items[i::n_threads],))
          for i in range(n_threads)]
    for t in th:
        t.start()
    for t in th:
        t.join(timeout=timeout)
    if any(t.is_alive() for t in th):
        raise AssertionError(f"{fn.__name__} workers hung")
    return errs


def _put_all(base, gs, val):
    """PUT /tenants/{g}/v2/keys/smoke for every g from 100 threads, the
    i-th through base (or through base[i % len(base)] given a list);
    {g: seconds to its ack}."""
    lat = {}
    bases = [base] if isinstance(base, str) else list(base)
    via = {g: bases[i % len(bases)] for i, g in enumerate(gs)}

    def put(g):
        t1 = time.perf_counter()
        st, body = _http("PUT", f"{via[g]}/tenants/{g}/v2/keys/smoke",
                         f"value={val(g)}".encode(), FORM)
        if st not in (200, 201) or body["node"]["value"] != val(g):
            raise AssertionError(f"PUT g={g}: {st} {body}")
        lat[g] = time.perf_counter() - t1

    errs = _in_threads(put, gs)
    if errs or len(lat) != len(gs):
        raise AssertionError(f"PUT failures: {errs[:5]}")
    return lat


def _get_all(base, want, quorum=False):
    """GET every tenant's /smoke from 100 threads, each equal to want[g]."""
    q = "?quorum=true" if quorum else ""

    def get(g):
        st, body = _http("GET", f"{base}/tenants/{g}/v2/keys/smoke{q}")
        if st != 200 or body["node"]["value"] != want[g]:
            raise AssertionError(f"GET{q} g={g}: {st} {body}")

    errs = _in_threads(get, list(want))
    if errs:
        raise AssertionError(f"GET{q} failures: {errs[:5]}")


def _wait_status(base, groups=None, proc=None, deadline_s=300.0):
    """Poll GET /engine/status every 0.5 s (each poll walks every group
    in Python) until it answers and, given `groups`, every group has a
    leader."""
    t_end = time.monotonic() + deadline_s
    while True:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"server exited rc={proc.returncode}")
        try:
            st, body = _http("GET", base + "/engine/status", timeout=30)
            if st == 200 and groups in (None, body["groups_with_leader"]):
                return body
        except OSError:
            pass
        if time.monotonic() > t_end:
            raise AssertionError(f"{base}: status not reached")
        time.sleep(0.5)


def _leg(t0, leg, lat, write_s, rounds, step_s, phase="http_front", **kv):
    ms = np.array(sorted(lat.values())) * 1e3
    log(phase, t0, leg=leg, acked=len(lat), write_s=write_s,
        acked_writes_per_s=len(lat) / write_s,
        ack_p50_ms=float(np.percentile(ms, 50)),
        ack_p99_ms=float(np.percentile(ms, 99)), rounds=rounds,
        rounds_per_s=None if rounds is None else rounds / write_s,
        step_s={k: round(v, 3) for k, v in step_s.items()}, **kv)


class _Steps(dict):
    """Seconds of each named step of a leg, in order."""

    def __init__(self):
        super().__init__()
        self._t = time.perf_counter()

    def done(self, name):
        now = time.perf_counter()
        self[name] = now - self._t
        self._t = now


def _spawn(args, log_path, stdout=subprocess.DEVNULL, env=None,
           native=True):
    """`python -m args...`; with native=False its C host code is off
    (ETCD_TPU_PYSTORE=1, and `python_host` before the module runs)."""
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(env or {})
    head = ["-m"]
    if not native:
        full["ETCD_TPU_PYSTORE"] = "1"
        head = ["-c", PY_HOST_MODULE]
    return subprocess.Popen([sys.executable, *head, *args], cwd=REPO,
                            env=full, stdout=stdout,
                            stderr=open(log_path, "ab"), text=True)


def _ready_line(proc, deadline_s=120.0, who="the ingress") -> dict:
    """The one JSON line a launcher prints on its standard output."""
    ready, _, _ = select.select([proc.stdout], [], [], deadline_s)
    if not ready:
        raise AssertionError(f"{who} printed no ready line")
    line = proc.stdout.readline()
    if not line:
        raise AssertionError(f"{who} exited rc={proc.wait(10)}")
    return json.loads(line)


def _maps_lib(pid, name) -> bool:
    """Whether process pid has the port's C library `name` mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return any(os.path.basename(ln.split()[-1]).startswith(name + ".")
                   for ln in f if ln.rstrip().endswith(".so"))


def _scrape(base, name) -> dict:
    """{labels: value} of one metric family on a /metrics page."""
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    return {ln.split(" ")[0][len(name):]: float(ln.rsplit(" ", 1)[1])
            for ln in text.splitlines() if ln.startswith(name)}


def _compute_apps() -> list:
    """nvidia-smi's rows of processes that hold a context on the card.
    Inside the chip machine's sandbox it reports every such process
    with pid 1, so a process is told by the count of rows, not by its
    pid."""
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return [ln.strip() for ln in apps.strip().splitlines() if ln.strip()]


# The CLI server's sampling of request traces in phase_http_front: about
# 250 of its 1,000 writes, within the tracer's 512 spans.
TRACE_EVERY = 4


def phase_http_front(dev, groups=G, tenants=1000, quorum_gets=100,
                     device_flags=(), native=True):
    """The tenant HTTP front and the ingress as users run them, at the
    CLI's defaults but for G, P and the window (fsync on, max_ents 8):

    1. in process, counted: EngineServer(parse_args(flags)), PUT, GET,
       quorum GET and /batch over real sockets; returns the ring_resolve
       launches counted across this leg, in all and by instantiation
       (and, third, the restarted server's of leg 3, from its stop
       line), and, fourth, the fused quiet hop's across this leg by
       pass;
    2. `python -m etcd_tpu_torch` and `python -m
       etcd_tpu_torch.server.ingress` as processes; writes and a CAS
       race through the ingress; every batchframe sent was answered;
    3. SIGKILL of the server, the same command again, every write acked
       in 2 read back, and every traced acked write's request id among
       the restarted server's `replayed` spans; SIGTERM ends both
       processes with rc 0.

    With native=False the C host code is off in every process of the
    phase: this one's (`host_code`), the servers' (ETCD_TPU_PYSTORE=1 and
    no C codecs) and the ingress's (`--no-native`)."""
    import torch
    from etcd_tpu_torch.etcdmain import parse_args
    from etcd_tpu_torch.etcdmain.etcd import EngineServer
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    gs = [i * groups // tenants for i in range(tenants)]
    procs = []
    with host_code(native), \
            tempfile.TemporaryDirectory(prefix="chip_smoke-http-") as d:
        def flags(name, port):
            return ["--engine-groups", str(groups), "--engine-peers", str(P),
                    "--engine-window", str(W),
                    "--data-dir", os.path.join(d, name),
                    "--listen-client-urls", f"http://127.0.0.1:{port}",
                    *device_flags]

        # Leg 1: in process, the kernels' launches counted.
        steps = _Steps()
        _launches_reset()  # the main path starts here
        srv = EngineServer(parse_args(flags("inproc", 0)))
        if srv.engine.device.type != torch.device(dev).type:
            raise AssertionError(f"engine on {srv.engine.device}")
        srv.start()
        try:
            base = srv.client_urls[0]
            status = _wait_status(base, groups)
            steps.done("boot")
            r0, t1 = srv.engine.round_no, time.perf_counter()
            lat = _put_all(base, gs, lambda g: f"h{g}")
            write_s = time.perf_counter() - t1
            rounds = srv.engine.round_no - r0
            steps.done("put")
            _get_all(base, {g: f"h{g}" for g in gs})
            steps.done("get")
            _get_all(base, {g: f"h{g}" for g in gs[:quorum_gets]},
                     quorum=True)
            steps.done("quorum_get")
            st, body = _http("POST", f"{base}/tenants/{gs[1]}/batch",
                             json.dumps({"reqs": [
                                 {"method": "PUT", "path": "/smoke-batch",
                                  "value": "b"},
                                 {"method": "PUT", "path": "/smoke",
                                  "value": "x", "prevValue": "wrong"}]}
                             ).encode(), {"Content-Type": "application/json"})
            if st != 200 or [r["status"] for r in body["results"]] \
                    != [201, 412]:
                raise AssertionError(f"/batch: {st} {body}")
            steps.done("batch")
            store_cls = type(srv.engine.store(gs[0])).__name__
            if store_cls != ("NativeStore" if native else "Store"):
                raise AssertionError(f"native={native} served from "
                                     f"{store_cls}")
        finally:
            srv.stop()
        if srv.engine.failed is not None:
            raise srv.engine.failed
        launches = ring_resolve.launches   # the main path ends here
        by_variant = dict(ring_resolve.launches_by_variant)
        quiet = _quiet_launches()
        steps.done("stop")
        _leg(t0, "in_process", lat, write_s, rounds, steps, native=native,
             store=store_cls,
             phase_s={k: round(v, 4) for k, v in srv.engine.phase_s.items()},
             groups_with_leader=status["groups_with_leader"],
             quorum_gets=quorum_gets, batch_statuses=[201, 412],
             launches=launches, launches_by_variant=by_variant,
             quiet_hop_launches=quiet)

        # Leg 2: the CLI and the ingress, as processes; the server
        # traces 1 request in TRACE_EVERY (its /debug/traces).
        steps = _Steps()
        trace_env = {"ETCD_TPU_TRACE_EVERY": str(TRACE_EVERY)}
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        cmd = ["etcd_tpu_torch", *flags("cli", port)]
        srv_log = os.path.join(d, "server.log")
        try:
            apps0 = _compute_apps() if on_card else []
            server = _spawn(cmd, srv_log, native=native, env=trace_env)
            procs.append(server)
            status = _wait_status(base, groups, server)
            steps.done("boot")
            if _maps_lib(server.pid, "storecore") != native:
                raise AssertionError(f"native={native}: the server's C "
                                     f"store loaded: {not native}")
            apps = _compute_apps() if on_card else []
            with open(srv_log, "rb") as f:
                said_cuda = b" peers on cuda:" in f.read()
            if on_card and (len(apps) != len(apps0) + 1 or not said_cuda):
                raise AssertionError(f"the server is not on the card: "
                                     f"{apps0} -> {apps}, log says cuda: "
                                     f"{said_cuda}")
            ing = _spawn(["etcd_tpu_torch.server.ingress", "--upstream",
                          base, *([] if native else ["--no-native"])],
                         os.path.join(d, "ingress.log"),
                         stdout=subprocess.PIPE, native=native)
            procs.append(ing)
            ing_base = f"http://127.0.0.1:{_ready_line(ing)['port']}"
            steps.done("ingress_ready")
            r0 = _http("GET", base + "/engine/status")[1]["round"]
            t1 = time.perf_counter()
            lat = _put_all(ing_base, gs, lambda g: f"i{g}")
            write_s = time.perf_counter() - t1
            rounds = _http("GET", base + "/engine/status")[1]["round"] - r0
            steps.done("put")
            cas_g = gs[2]
            cas = {}

            def swap(v):
                cas[v] = _http("PUT", f"{ing_base}/tenants/{cas_g}/v2/keys/"
                               f"smoke?prevValue=i{cas_g}",
                               f"value={v}".encode(), FORM)

            if _in_threads(swap, ["left", "right"], n_threads=2):
                raise AssertionError("CAS requests failed")
            outcomes = sorted((st, (b or {}).get("errorCode"))
                              for st, b in cas.values())
            if outcomes != [(200, None), (412, 101)]:
                raise AssertionError(f"CAS race: {cas}")
            winner = next(v for v, (st, _) in cas.items() if st == 200)
            steps.done("cas")
            frames = _scrape(ing_base, "etcd_ingress_upstream_frames_total")
            sent = frames.get('{direction="sent"}', 0.0)
            recv = frames.get('{direction="recv"}', 0.0)
            if not 0 < sent == recv:
                raise AssertionError(f"upstream frames: {frames}")
            ing_native = _scrape(ing_base, "etcd_ingress_native_enabled")
            if ing_native.get("") != (1.0 if native else 0.0):
                raise AssertionError(f"native={native}: ingress reports "
                                     f"{ing_native}")
            _leg(t0, "cli_ingress", lat, write_s, rounds, steps,
                 native=native,
                 groups_with_leader=status["groups_with_leader"],
                 compute_apps_before_server=apps0,
                 compute_apps_with_server=apps,
                 cas_outcomes=outcomes, upstream_frames_sent=sent,
                 upstream_frames_recv=recv,
                 ingress_native_enabled=ing_native[""])

            # Leg 3: SIGKILL the server, run the same command again. The
            # acked writes are read back as soon as it serves: a local
            # GET needs the replayed store, not a re-elected leader. The
            # traced request ids of the acked writes come back as
            # `replayed` spans (tests/test_observability.py::
            # test_trace_ids_survive_sigkill_and_replay).
            steps = _Steps()
            traced = {s["rid"] for s in _http(
                "GET", base + "/debug/traces")[1]["spans"]
                if {"wal_submit", "acked"} <= set(s["stages"])}
            if len(traced) < len(gs) // TRACE_EVERY // 2:
                raise AssertionError(f"{len(traced)} traced acked writes")
            server.send_signal(signal.SIGKILL)
            server.wait(timeout=60)
            server = _spawn(cmd, srv_log, native=native, env=trace_env)
            procs.append(server)
            _wait_status(base, proc=server)
            steps.done("restart")
            replayed = {s["rid"] for s in _http(
                "GET", base + "/debug/traces")[1]["spans"]
                if "replayed" in s["stages"]}
            if traced - replayed:
                raise AssertionError(f"traced acked writes not replayed: "
                                     f"{sorted(traced - replayed)[:5]}")
            want = {g: f"i{g}" for g in gs}
            want[cas_g] = winner
            _get_all(base, want)
            leaders = _http("GET", base + "/engine/status")[1][
                "groups_with_leader"]
            steps.done("read_back")
            rcs = {}
            for name, p in (("ingress", ing), ("server", server)):
                p.send_signal(signal.SIGTERM)
                rcs[name] = p.wait(timeout=120)
            steps.done("sigterm")
            if rcs != {"ingress": 0, "server": 0}:
                raise AssertionError(f"exit codes on SIGTERM: {rcs}")
            with open(srv_log) as f:    # the killed server printed none
                stops = [json.loads(ln.split(STOP_LINE, 1)[1]) for ln in f
                         if STOP_LINE in ln]
            if len(stops) != 1 or on_card and not sum(stops[0].values()):
                raise AssertionError(f"restarted server's stop line: "
                                     f"{stops}")
            restarted = stops[0]
            log("http_front", t0, leg="sigkill_restart", native=native,
                launches_by_variant=restarted,
                read_back=len(want), trace_every=TRACE_EVERY,
                traced_acked_writes=len(traced),
                replayed_spans=len(replayed),
                groups_with_leader_after_read_back=leaders, rcs=rcs,
                step_s={k: round(v, 3) for k, v in steps.items()})
        except BaseException:
            with open(srv_log, "rb") as f:
                print(f.read()[-4000:].decode(errors="replace"),
                      file=sys.stderr)
            raise
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
    return launches, by_variant, restarted, quiet


# -- suite_card: the JAX package's behavioural suite at full width -----------

def _bench_engine(dev, d, groups, **kw):
    """A MultiEngine at the bench shape (fsync on) on `dev`, every group
    led: run_round until then, at most 12 rounds."""
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    eng = MultiEngine(EngineConfig(
        data_dir=d, groups=groups, peers=P, window=W, max_ents=E,
        heartbeat_tick=3, fsync=True, stagger=True, hops=3,
        device=str(dev), **kw))
    for _ in range(12):
        eng.run_round()
        if (np.where(eng.h_mask, eng.h_state, 0) == 2).any(1).all():
            return eng
    raise AssertionError("engine elections did not converge")


def _suite_race(dev, groups, hot=10, cas_threads=100, cas_attempts=8,
                first_writes=1000):
    """tests/test_race_stress.py's engine tests at full width, on the
    live engine thread: `cas_threads` threads doing read-modify-write
    CAS loops on `hot` hot tenants' counters while `first_writes`
    tenants with no store yet take their first write and 8 threads
    touch those tenants' stores (the lazy creation race). Each counter
    must equal its count of acked CASes, one Store instance must have
    existed per tenant, and every acked first write must read back with
    a quorum GET."""
    from etcd_tpu_torch import errors
    from etcd_tpu_torch.server.request import Request
    t0 = time.perf_counter()
    hot_gs = [i * groups // hot for i in range(hot)]
    first_gs = [i * groups // first_writes + 1 for i in range(first_writes)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke-race-") as d:
        _launches_reset()
        eng = _bench_engine(dev, d, groups, request_timeout=60.0)
        eng.start()
        try:
            for g in hot_gs:
                eng.do(g, Request(method="PUT", path="/ctr", val="0"),
                       timeout=60)
            fresh = [g for g in first_gs if g not in eng._stores]
            if len(fresh) != first_writes:
                raise AssertionError("first-write tenants already had a "
                                     "store")
            wins = {g: 0 for g in hot_gs}
            lat, errs, lock = [], [], threading.Lock()
            stores_seen = {g: set() for g in first_gs}

            def cas(t):
                g = hot_gs[t % hot]
                for _ in range(cas_attempts):
                    n = int(eng.do(g, Request(method="GET", path="/ctr")
                                   ).node.value)
                    t1 = time.perf_counter()
                    try:
                        eng.do(g, Request(method="PUT", path="/ctr",
                                          val=str(n + 1),
                                          prev_value=str(n)), timeout=60)
                    except errors.EtcdError as e:
                        if e.code != errors.ECODE_TEST_FAILED:
                            raise
                        continue
                    with lock:
                        wins[g] += 1
                        lat.append(time.perf_counter() - t1)

            def first(g):
                t1 = time.perf_counter()
                ev = eng.do(g, Request(method="PUT", path="/lazy",
                                       val=f"x{g}"), timeout=60)
                if ev.node.value != f"x{g}":
                    raise AssertionError(f"first write g={g}: {ev}")
                with lock:
                    lat.append(time.perf_counter() - t1)

            def touch(_):
                for g in first_gs:
                    s = eng.store(g)
                    with lock:
                        stores_seen[g].add(id(s))

            def guarded(fn, items):
                for x in items:
                    try:
                        fn(x)
                    except Exception as e:  # noqa: BLE001 — below
                        with lock:
                            errs.append((fn.__name__, x, repr(e)))

            work = ([threading.Thread(target=guarded, args=(cas, [t]))
                     for t in range(cas_threads)]
                    + [threading.Thread(target=guarded,
                                        args=(first, first_gs[i::100]))
                       for i in range(100)]
                    + [threading.Thread(target=guarded, args=(touch, [i]))
                       for i in range(8)])
            r0, t1 = eng.round_no, time.perf_counter()
            for th in work:
                th.start()
            for th in work:
                th.join(timeout=300)
            write_s = time.perf_counter() - t1
            rounds = eng.round_no - r0
            if any(th.is_alive() for th in work) or errs:
                raise AssertionError(f"race workers failed: {errs[:5]}")
            raced = [g for g, ids in stores_seen.items() if len(ids) != 1]
            if raced:
                raise AssertionError(f"store created twice: {raced[:5]}")
            counters = {g: int(eng.do(g, Request(
                method="GET", path="/ctr", quorum=True), timeout=60
                ).node.value) for g in hot_gs}
            if counters != wins:
                raise AssertionError(f"lost updates: counters {counters}, "
                                     f"acked CASes {wins}")
            missing = []

            def qget(g):
                ev = eng.do(g, Request(method="GET", path="/lazy",
                                       quorum=True), timeout=60)
                if ev.node.value != f"x{g}":
                    missing.append(g)

            errs = _in_threads(qget, first_gs)
            if errs or missing:
                raise AssertionError(f"first writes not read back: "
                                     f"{(errs + missing)[:5]}")
        finally:
            eng.stop()
        if eng.failed is not None:
            raise eng.failed
        launches, by_variant = _launches_read()
    ms = np.array(sorted(lat)) * 1e3
    log("suite_card", t0, leg="race", hot_tenants=hot,
        cas_threads=cas_threads, cas_attempts=cas_threads * cas_attempts,
        acked_cas=sum(wins.values()), counters=list(counters.values()),
        first_writes=first_writes, read_back=len(first_gs),
        acked=len(lat), write_s=write_s,
        acked_writes_per_s=len(lat) / write_s,
        ack_p50_ms=float(np.percentile(ms, 50)),
        ack_p99_ms=float(np.percentile(ms, 99)), rounds=rounds,
        launches=launches, launches_by_variant=by_variant)
    return launches, by_variant


class _Seq:
    """Sequential request ids: two engines given the same requests then
    write the same payload bytes (idutil's ids embed the clock)."""

    def __init__(self):
        self.i = 0

    def next(self):
        self.i += 1
        return self.i


MIRRORS = ("h_term", "h_vote", "h_commit", "h_state", "h_last", "h_ring",
           "h_mask", "applied")
RECORD_ARRAYS = ("hs_g", "hs_p", "hs_term", "hs_vote", "hs_commit",
                 "last_g", "last_p", "last_v", "ring_g", "ring_p", "ring_i",
                 "ring_t")


def _wal_records(d) -> list:
    from etcd_tpu_torch.server.enginewal import EngineWAL
    wal = EngineWAL(d, fsync=False)
    try:
        return list(wal.replay(after_round=-1))
    finally:
        wal.close()


def _suite_compact(dev, groups, rounds=40, writes_per_round=200):
    """tests/test_engine_compact.py at full width: an engine with
    compact readback (`gather_rows` of the flagged rows) and one with
    full readback take the same seeded writes and the same seeded 5%
    link drops for `rounds` rounds; after every round their mirrors,
    round numbers, acked counts and the stores of every group whose
    applied index moved are equal, and at the end every store and every
    WAL record, field by field. The compact engine's data dir then
    restarts into the same mirrors and stores."""
    import torch
    from etcd_tpu_torch.server.request import Request
    t0 = time.perf_counter()
    quiet = dict(sync_interval=0.0, checkpoint_rounds=1 << 30,
                 pipeline_applies=False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke-compact-") as d:
        dirs = {k: os.path.join(d, k) for k in ("full", "compact")}
        _launches_reset()
        engs = {k: _bench_engine(dev, dirs[k], groups,
                                 compact_readback=k == "compact", **quiet)
                for k in dirs}
        for eng in engs.values():
            eng.reqid = _Seq()
        full, comp = engs["full"], engs["compact"]
        rng = np.random.RandomState(SEED)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        secs = dict.fromkeys(engs, 0.0)
        stores_checked = 0
        for r in range(rounds):
            for g in rng.randint(0, groups, writes_per_round).tolist():
                path = f"/k{rng.randint(4)}"
                for eng in engs.values():
                    rid = eng.reqid.next()
                    rq = Request(method="PUT", path=path, val=f"v{r}",
                                 id=rid)
                    with eng._lock:
                        eng._pending[g].append(
                            (rid, bytes([0]) + rq.encode(), rq))
                        eng._dirty.add(g)
            drop = (torch.rand((groups, P, P, 1), generator=gen, device=dev)
                    >= 0.05).to(torch.int32)
            before = full.applied.copy()
            for k, eng in engs.items():
                eng.drop_mask = drop
                t1 = time.perf_counter()
                eng.run_round()
                secs[k] += time.perf_counter() - t1
            for name in MIRRORS:
                if not np.array_equal(getattr(full, name),
                                      getattr(comp, name)):
                    raise AssertionError(f"compact != full: {name} after "
                                         f"round {r}")
            if (full.round_no, full.acked_requests) != \
                    (comp.round_no, comp.acked_requests):
                raise AssertionError(f"compact != full: round/acks at {r}")
            for g in np.flatnonzero(full.applied != before).tolist():
                if full._stores.get(g) is None:
                    continue
                stores_checked += 1
                if full._stores[g].save() != comp._stores[g].save():
                    raise AssertionError(f"compact != full: store {g} "
                                         f"after round {r}")
        if set(full._stores) != set(comp._stores) or any(
                full._stores[g].save() != comp._stores[g].save()
                for g in full._stores):
            raise AssertionError("compact != full: the stores")
        # A restart replays every slot as a follower: h_state is not
        # compared, as in the JAX test.
        mirrors = {n: getattr(comp, n).copy()
                   for n in ("h_term", "h_vote", "h_commit", "h_last",
                             "h_ring")}
        stores = {g: s.save() for g, s in comp._stores.items()}
        committed = int(full.applied.sum())
        for eng in engs.values():
            eng.stop()
            if eng.failed is not None:
                raise eng.failed
        launches, by_variant = _launches_read()
        recs = {k: _wal_records(v) for k, v in dirs.items()}
        if len(recs["full"]) != len(recs["compact"]):
            raise AssertionError("compact != full: WAL record counts")
        for ra, rb in zip(recs["full"], recs["compact"]):
            if ra.round_no != rb.round_no or ra.entries != rb.entries \
                    or ra.confs != rb.confs or any(
                        not np.array_equal(np.asarray(getattr(ra, f)),
                                           np.asarray(getattr(rb, f)))
                        for f in RECORD_ARRAYS):
                raise AssertionError(f"compact != full: WAL record of "
                                     f"round {ra.round_no}")
        t1 = time.perf_counter()
        from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
        re = MultiEngine(EngineConfig(
            data_dir=dirs["compact"], groups=groups, peers=P, window=W,
            max_ents=E, heartbeat_tick=3, fsync=True, stagger=True, hops=3,
            device=str(dev), **quiet))
        try:
            bad = [n for n, v in mirrors.items()
                   if not np.array_equal(getattr(re, n), v)]
            bad += [g for g, blob in stores.items()
                    if re._stores[g].save() != blob]
        finally:
            re.stop()
        if bad:
            raise AssertionError(f"compact restart differs: {bad[:5]}")
        restart_s = time.perf_counter() - t1
    log("suite_card", t0, leg="compact", rounds=rounds,
        writes_per_round=writes_per_round, drop_rate=0.05,
        ms_per_round={k: v / rounds * 1e3 for k, v in secs.items()},
        stores_compared_by_round=stores_checked, stores=len(stores),
        wal_records=len(recs["full"]), applied_entries=committed,
        restart_s=restart_s, launches=launches,
        launches_by_variant=by_variant)
    return launches, by_variant


OBS_SERIES = (    # the families tests/test_observability.py names
    "etcd_engine_round_phase_seconds_bucket",
    "etcd_engine_kernel_step_seconds_bucket",
    "etcd_engine_round_batch_requests_bucket",
    "etcd_wal_writer_queue_depth", "etcd_wal_writer_watermark_lag_tickets",
    "etcd_wal_writer_group_commit_rounds_bucket",
    "etcd_applier_apply_batch_requests_bucket",
    "etcd_ack_gate_wait_seconds_bucket",
    "etcd_server_proposal_durations_milliseconds_count",
    "etcd_server_pending_proposal_total")
OBS_PHASES = {"stage", "dispatch", "readback", "record", "wal_submit",
              "tail"}
OBS_MONOTONE = ("etcd_engine_rounds_total",
                "etcd_engine_acked_requests_total",
                "etcd_server_proposal_durations_milliseconds_count")


def _chrome_stages(doc) -> set:
    """The instant-event names of a Chrome trace-event document."""
    return {e["name"] for e in doc["traceEvents"] if e["ph"] == "i"}


def _suite_obs(dev, groups, tenants=1000):
    """tests/test_observability.py's engine tests at full width: an
    engine (2 WAL shards, 2 applier shards) behind EngineHttp, /metrics
    scraped every 0.4 s while `tenants` PUTs from 100 threads run. Every
    scrape parses; every compartment series the JAX test names is
    present (round phases, kernel step, WAL fsync per shard, applier
    queues, ack gate, the reference's proposal metrics); +Inf equals
    _count; the counters never move back; the acked counter moves by
    exactly the acks the clients saw; /debug/flight and a SIGUSR2 dump
    parse as Chrome-trace JSON with all six stages. Logs each
    compartment's p50/p99 over the writes, with the engine's phase_s."""
    from etcd_tpu_torch.etcdhttp.tenants import EngineHttp
    from etcd_tpu_torch.server import obs as obs_mod
    from etcd_tpu_torch.tools import etcd_top
    t0 = time.perf_counter()
    gs = [i * groups // tenants for i in range(tenants)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke-obs-") as d:
        _launches_reset()
        eng = _bench_engine(dev, d, groups, applier_shards=2, wal_shards=2,
                            request_timeout=60.0,
                            checkpoint_rounds=1 << 30)
        front = EngineHttp(eng, port=0)
        eng.start()
        front.start()
        base = front.url.rstrip("/")

        def scrape():
            with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
                return etcd_top.parse_metrics(r.read().decode())

        try:
            first = scrape()
            scrapes, done = [first], threading.Event()

            def scraper():
                while not done.wait(0.4):
                    scrapes.append(scrape())

            sc = threading.Thread(target=scraper)
            sc.start()
            t1 = time.perf_counter()
            try:
                lat = _put_all(base, gs, lambda g: f"o{g}")
            finally:
                done.set()
                sc.join(timeout=120)
            write_s = time.perf_counter() - t1
            last = scrape()
            scrapes.append(last)
            names = {k[0] for k in last}
            missing = [n for n in OBS_SERIES if n not in names]
            phases = {dict(k[1]).get("phase") for k in last
                      if k[0] == "etcd_engine_round_phase_seconds_bucket"}
            shards = {fam: {dict(k[1]).get("shard") for k in last
                            if k[0] == fam}
                      for fam in ("etcd_wal_writer_fsync_seconds_bucket",
                                  "etcd_applier_queue_depth")}
            if missing or not OBS_PHASES <= phases or any(
                    not {"0", "1"} <= s for s in shards.values()):
                raise AssertionError(f"/metrics lacks {missing}, phases "
                                     f"{phases}, shards {shards}")
            for fam in ("etcd_engine_kernel_step_seconds",
                        "etcd_ack_gate_wait_seconds"):
                inf = sum(v for k, v in last.items()
                          if k[0] == fam + "_bucket"
                          and dict(k[1]).get("le") == "+Inf")
                if inf != last[(fam + "_count", ())]:
                    raise AssertionError(f"{fam}: +Inf {inf} != _count")
            for a, b in zip(scrapes, scrapes[1:]):
                for key in OBS_MONOTONE:
                    if b[(key, ())] < a[(key, ())]:
                        raise AssertionError(f"{key} moved back")
            acked = (last[("etcd_engine_acked_requests_total", ())]
                     - first[("etcd_engine_acked_requests_total", ())])
            if acked != len(lat):
                raise AssertionError(f"acked counter moved {acked}, the "
                                     f"clients saw {len(lat)} acks")
            st, flight = _http("GET", base + "/debug/flight")
            if st != 200 or _chrome_stages(flight) != set(
                    obs_mod.STAGE_NAMES):
                raise AssertionError(f"/debug/flight: {st}")
            diag = os.path.join(d, "diagnostics")
            os.kill(os.getpid(), signal.SIGUSR2)
            t_end, dumps = time.monotonic() + 15, []
            while not dumps and time.monotonic() < t_end:
                time.sleep(0.1)
                dumps = [f for f in (os.listdir(diag) if os.path.isdir(diag)
                                     else []) if "sigusr2" in f]
            if not dumps:
                raise AssertionError("SIGUSR2 produced no flight dump")
            with open(os.path.join(diag, dumps[0])) as f:
                if _chrome_stages(json.load(f)) != set(obs_mod.STAGE_NAMES):
                    raise AssertionError("SIGUSR2 dump lacks stages")
        finally:
            front.stop()
            eng.stop()
        if eng.failed is not None:
            raise eng.failed
        launches, by_variant = _launches_read()

    def pct(name, match=()):
        buckets, total, _ = etcd_top.hist_delta(first, last, name, match)
        return {"p50": etcd_top.quantile(buckets, total, 0.5),
                "p99": etcd_top.quantile(buckets, total, 0.99),
                "count": total}

    compartments = {
        **{f"round_phase_s[{p}]": pct("etcd_engine_round_phase_seconds",
                                      (("phase", p),))
           for p in sorted(phases - {None})},
        "kernel_step_s": pct("etcd_engine_kernel_step_seconds"),
        "round_batch_requests": pct("etcd_engine_round_batch_requests"),
        **{f"wal_fsync_s[{s}]": pct("etcd_wal_writer_fsync_seconds",
                                    (("shard", s),)) for s in ("0", "1")},
        "wal_group_commit_rounds": pct(
            "etcd_wal_writer_group_commit_rounds"),
        "applier_batch_requests": pct(
            "etcd_applier_apply_batch_requests"),
        "ack_gate_wait_s": pct("etcd_ack_gate_wait_seconds")}
    log("suite_card", t0, leg="obs_compartments", bucket_bounds=True,
        compartments=compartments,
        phase_s={k: round(v, 4) for k, v in eng.phase_s.items()})
    ms = np.array(sorted(lat.values())) * 1e3
    log("suite_card", t0, leg="obs", acked=len(lat), write_s=write_s,
        acked_writes_per_s=len(lat) / write_s,
        ack_p50_ms=float(np.percentile(ms, 50)),
        ack_p99_ms=float(np.percentile(ms, 99)), scrapes=len(scrapes),
        acked_counter_moved=acked, series=len(OBS_SERIES),
        flight_stages=len(obs_mod.STAGE_NAMES), sigusr2_dump=dumps[0],
        launches=launches, launches_by_variant=by_variant)
    return launches, by_variant


def phase_suite_card(dev, groups=G, race=None, compact=None, obs=None):
    """The engine's behaviours that the JAX package's tests hold on the
    CPU (tests/test_race_stress.py, test_engine_compact.py,
    test_observability.py), at the bench shape on the card, where the
    rounds are faster and the interleavings differ. Three legs; each
    counts ring_resolve's launches across itself. Keyword dicts pass
    sizes to the legs (the CPU rehearsal's). Returns {leg: (launches,
    by instantiation)}."""
    import torch
    out = {"race": _suite_race(dev, groups, **(race or {})),
           "compact": _suite_compact(dev, groups, **(compact or {})),
           "obs": _suite_obs(dev, groups, **(obs or {}))}
    if torch.device(dev).type == "cuda" and not all(
            n > 0 for n, _ in out.values()):
        raise AssertionError(f"suite_card: ring_resolve not launched on "
                             f"every leg: {out}")
    return out


POOL_SHARDS = 2      # engine processes of phase_pool_serve on the card
STOP_LINE = "ring_resolve launches by instantiation "


def phase_pool_serve(dev, groups=G, shards=POOL_SHARDS, tenants=1000,
                     quorum_gets=100, ingresses=2):
    """`python -m etcd_tpu_torch.tools.pool_serve`: `shards` engine
    processes (the CLI at G/shards tenants each, P, W, fsync on) on the
    card behind one router, every shard among the card's compute apps;
    PUTs and quorum GETs through the router, every acked write read back
    through it; then `python -m etcd_tpu_torch.tools.ingress_serve` with
    `ingresses` ingress processes in front of the router (their lanes
    flush JSON batches: the router relays no upgraded channel), PUTs
    striped over them, every acked write read back through the router;
    SIGTERM ends both launchers with rc 0, and every shard's stop line
    counts its ring_resolve launches. Returns the launches by shard."""
    import torch
    on_card = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    gs = [i * groups // tenants for i in range(tenants)]
    procs, shard_pids, pool = [], [], None
    with tempfile.TemporaryDirectory(prefix="chip_smoke-pool-") as d:
        pool_log = os.path.join(d, "pool.log")
        try:
            steps = _Steps()
            apps0 = _compute_apps() if on_card else []
            pool = _spawn(["etcd_tpu_torch.tools.pool_serve", "--groups",
                           str(groups), "--shards", str(shards), "--peers",
                           str(P), "--window", str(W), "--data-dir",
                           os.path.join(d, "pool"), "--engine-device",
                           torch.device(dev).type], pool_log,
                          stdout=subprocess.PIPE)
            procs.append(pool)
            info = _ready_line(pool, deadline_s=660, who="pool_serve")
            if "error" in info:
                raise AssertionError(f"pool_serve: {info}")
            shard_pids = info["pids"]
            router = f"http://127.0.0.1:{info['router']}"
            apps = _compute_apps() if on_card else []
            if on_card and len(apps) != len(apps0) + shards:
                raise AssertionError(f"the shards are not on the card: "
                                     f"{apps0} -> {apps}")
            steps.done("boot")
            t1 = time.perf_counter()
            lat = _put_all(router, gs, lambda g: f"p{g}")
            write_s = time.perf_counter() - t1
            steps.done("put")
            _get_all(router, {g: f"p{g}" for g in gs[:quorum_gets]},
                     quorum=True)
            steps.done("quorum_get")
            _get_all(router, {g: f"p{g}" for g in gs})
            steps.done("read_back")
            _leg(t0, "router", lat, write_s, None, steps, phase="pool_serve",
                 shards=shards, groups_per_shard=info["per_shard"],
                 boot_s_by_shard=info["boot_s"], quorum_gets=quorum_gets,
                 read_back=len(gs), compute_apps_before=apps0,
                 compute_apps_with_pool=apps)

            steps = _Steps()
            ing = _spawn(["etcd_tpu_torch.tools.ingress_serve", "--upstream",
                          router, "--ingress", str(ingresses)],
                         os.path.join(d, "ingress.log"),
                         stdout=subprocess.PIPE)
            procs.append(ing)
            bases = [f"http://127.0.0.1:{p}" for p in
                     _ready_line(ing, who="ingress_serve")["ingress"]]
            steps.done("ingress_ready")
            t1 = time.perf_counter()
            lat = _put_all(bases, gs, lambda g: f"q{g}")
            write_s = time.perf_counter() - t1
            steps.done("put")
            _get_all(router, {g: f"q{g}" for g in gs})
            steps.done("read_back")
            fallbacks = []
            for b in bases:     # JSON batches: the router relays no 101
                on = _scrape(b, "etcd_ingress_native_enabled").get("")
                fb = _scrape(b, "etcd_ingress_upstream_fallbacks_total")
                if on != 1.0 or not fb.get("", 0.0) > 0:
                    raise AssertionError(f"ingress {b}: native {on}, "
                                         f"fallbacks to JSON {fb}")
                fallbacks.append(fb[""])
            rcs = {}
            for name, p in (("ingress_serve", ing), ("pool_serve", pool)):
                p.send_signal(signal.SIGTERM)
                rcs[name] = p.wait(timeout=120)
            steps.done("sigterm")
            if rcs != {"ingress_serve": 0, "pool_serve": 0}:
                raise AssertionError(f"exit codes on SIGTERM: {rcs}")
            with open(pool_log) as f:
                stops = [json.loads(ln.split(STOP_LINE, 1)[1]) for ln in f
                         if STOP_LINE in ln]
            if len(stops) != shards or on_card and not all(
                    s["te5"] and s["generic"] for s in stops):
                raise AssertionError(f"shard stop lines: {stops}")
            _leg(t0, "ingress", lat, write_s, None, steps, phase="pool_serve",
                 ingresses=ingresses, lanes_on_json_batches=fallbacks,
                 read_back=len(gs), rcs=rcs,
                 launches_by_shard=stops)
        except BaseException:
            with open(pool_log, "rb") as f:
                print(f.read()[-4000:].decode(errors="replace"),
                      file=sys.stderr)
            raise
        finally:
            # A launcher stops its children on SIGTERM; SIGKILL only one
            # that does not exit, and then reap the shards it leaves.
            killed = []
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
                    try:
                        p.wait(timeout=60)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait(timeout=60)
                        killed.append(p)
            for pid in shard_pids if pool in killed else ():
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        if b"etcd_tpu_torch" in f.read():
                            os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
    return stops


def phase_tsan() -> None:
    """The port's C under ThreadSanitizer where libtsan is installed
    (`python -m etcd_tpu_torch.tools.tsan_check`), else a printed skip."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "etcd_tpu_torch.tools.tsan_check",
         "--if-available"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    said = res.stdout.strip().splitlines()[:1]
    if res.returncode != 0 or not said:
        raise AssertionError(f"tsan_check rc={res.returncode}: "
                             f"{res.stdout[-4000:]}{res.stderr[-2000:]}")
    log("tsan", t0, result=said[0].split(" — ")[0], said=said[0])


NHOSTS = 5           # one replica of every group per rank process


def _serving_line(path, deadline_s=60.0) -> str:
    """The line a rank prints once it serves (it names its device)."""
    t_end = time.monotonic() + deadline_s
    while True:
        with open(path) as f:
            for ln in f:
                if " serving tenants on " in ln:
                    return ln.strip()
        if time.monotonic() > t_end:
            raise AssertionError(f"{path}: no serving line")
        time.sleep(0.2)


def _rank_line(path) -> dict:
    """The JSON line a rank prints on its way out after SIGTERM."""
    with open(path) as f:
        lines = [ln for ln in f if ln.startswith('{"rank"')]
    if not lines:
        raise AssertionError(f"{path}: no exit line")
    return json.loads(lines[-1])


def phase_multihost_frames(dev, groups=G, tenants=1000, hosts=NHOSTS,
                           device_env=None):
    """The multi-host engine on the frames data plane as users run it:
    `hosts` rank processes of `python -m
    etcd_tpu_torch.tools.multihost_engine`, all on the one card, each
    owning one replica of every group (MHE_GROUPS=groups, MHE_WINDOW=16,
    MHE_MAX_ENTS=8, MHE_FSYNC=1), the mailbox, proposals and payloads on
    frames between them.

    1. spawn; every rank among the card's compute apps; every group led
       on every rank;
    2. `tenants` PUTs from 100 threads spread over the ranks' HTTP ports,
       each to a rank that is not its group's first leader (so most
       forward): acked writes/s, ack p50/p99, rounds/s per rank;
    3. SIGKILL of one rank, then one write to every tenant through the
       survivors, each retried until it acks: the worst gap from the
       kill to a group's first ack, and the written groups the victim
       led that re-elected;
    4. the rank restarts on its own data dir: seconds until it serves
       and until it has applied what the survivors have;
    5. every acked write read back from the rank that acked it;
    6. SIGTERM: rc 0 for every rank, and each rank's exit line (device,
       ring_resolve launches by instantiation, peak device memory).
    Returns the ring_resolve launches summed over the ranks' exit lines,
    in all and by instantiation, and the exit lines."""
    import torch
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    step = max(groups // tenants, 1)
    # Tenant i: its group's stagger-boot leader is rank i % hosts; its
    # writes go to rank (i + 1) % hosts.
    gs = [(i * step - i * step % hosts + i % hosts) % groups
          for i in range(tenants)]
    client = {g: (i + 1) % hosts for i, g in enumerate(gs)}
    victim = hosts - 1
    ports = _free_ports(2 * hosts)     # one draw: the two sets disjoint
    http_ports, frame_ports = ports[:hosts], ports[hosts:]
    procs = [None] * hosts
    with tempfile.TemporaryDirectory(prefix="chip_smoke-mhe-") as d:
        logs = [os.path.join(d, f"rank{r}.err") for r in range(hosts)]
        outs = [os.path.join(d, f"rank{r}.out") for r in range(hosts)]
        bases = [f"http://127.0.0.1:{p}" for p in http_ports]

        def start(r):
            env = dict(MHE_RANK=str(r), MHE_NHOSTS=str(hosts), MHE_DATA=d,
                       MHE_HTTP_PORTS=",".join(map(str, http_ports)),
                       MHE_FRAME_PORTS=",".join(map(str, frame_ports)),
                       MHE_GROUPS=str(groups), MHE_WINDOW=str(W),
                       MHE_MAX_ENTS=str(CLI_E), MHE_FSYNC="1",
                       MHE_PLANE="frames", **(device_env or {}))
            procs[r] = _spawn(["etcd_tpu_torch.tools.multihost_engine"],
                              logs[r], stdout=open(outs[r], "a"), env=env)

        def rounds():
            return [_http("GET", b + "/engine/status")[1]["round"]
                    for b in bases]

        try:
            # 1. spawn, on the card, every group led on every rank.
            steps = _Steps()
            apps0 = _compute_apps() if on_card else []
            for r in range(hosts):
                start(r)
            for r in range(hosts):
                _wait_status(bases[r], proc=procs[r], deadline_s=600)
            steps.done("serving")
            apps = _compute_apps() if on_card else []
            said = [_serving_line(path) for path in outs]
            if on_card and (len(apps) != len(apps0) + hosts
                            or not all(" on cuda:" in ln for ln in said)):
                raise AssertionError(f"ranks not all on the card: {apps0} "
                                     f"-> {apps}, on cuda: {said}")
            for r in range(hosts):
                _wait_status(bases[r], groups, procs[r], deadline_s=600)
            steps.done("every_group_led")
            log("multihost_frames", t0, step="boot", ranks=hosts,
                groups=groups, peers=hosts, window=W, max_ents=CLI_E,
                fsync=True, compute_apps_before=len(apps0),
                compute_apps_with_ranks=len(apps),
                step_s={k: round(v, 3) for k, v in steps.items()})

            # 2. PUTs spread over the ranks.
            acked = {}                    # (g, key) -> (value, rank)
            lat = {}

            def put(g):
                r = client[g]
                t1 = time.perf_counter()
                st, body = _http("PUT", f"{bases[r]}/tenants/{g}/v2/keys/"
                                 f"smoke", f"value=m{g}".encode(), FORM)
                if st not in (200, 201) or body["node"]["value"] != f"m{g}":
                    raise AssertionError(f"PUT g={g} at rank {r}: {st} "
                                         f"{body}")
                lat[g] = time.perf_counter() - t1
                acked[(g, "smoke")] = (f"m{g}", r)

            r0, t1 = rounds(), time.perf_counter()
            errs = _in_threads(put, gs)
            write_s = time.perf_counter() - t1
            r1 = rounds()
            if errs or len(lat) != len(gs):
                raise AssertionError(f"PUT failures: {errs[:5]}")
            ms = np.array(sorted(lat.values())) * 1e3
            log("multihost_frames", t0, step="put", acked=len(lat),
                write_s=write_s, acked_writes_per_s=len(lat) / write_s,
                ack_p50_ms=float(np.percentile(ms, 50)),
                ack_p99_ms=float(np.percentile(ms, 99)),
                forwarded_share=sum(1 for g in gs if client[g] != g % hosts)
                / len(gs),
                rounds_per_s_by_rank=[(b - a) / write_s
                                      for a, b in zip(r0, r1)])

            # 3. one write to every tenant through the survivors, each
            # retried (5 s attempts) until it acks; one rank is SIGKILLed
            # once a tenth of them have acked (tools/frames_kill_loop.py's
            # kill step, which loops it).
            from etcd_tpu_torch.tools import frames_kill_loop
            victim_gs = {g for g in gs if _http(
                "GET", f"{bases[0]}/tenants/{g}/status")[1]["lead"]
                == victim}
            survivors = [r for r in range(hosts) if r != victim]
            reelected = {}     # written group the victim led -> seconds
            t_kill = []

            def watch():
                """Each written group the victim led, from the kill until
                rank 0 sees a survivor lead it (polled every 0.1 s)."""
                def check(g):
                    lead = _http("GET", f"{bases[0]}/tenants/{g}/status",
                                 timeout=30)[1]["lead"]
                    if lead in survivors:
                        reelected[g] = time.perf_counter() - t_kill[0]

                t_end = time.monotonic() + 180
                while time.monotonic() < t_end:
                    left = [g for g in victim_gs if g not in reelected]
                    if not left:
                        return
                    _in_threads(check, left, n_threads=20)
                    time.sleep(0.1)

            watcher = threading.Thread(target=watch, daemon=True)

            def on_kill(t):
                t_kill.append(t)
                watcher.start()

            first_ack, _, stalled, _ = frames_kill_loop.kill_step(
                bases, procs[victim], survivors, gs, lambda g: f"k{g}",
                acked, on_kill)
            if stalled:
                raise AssertionError("writes through the kill: " + "; ".join(
                    f"g={g} never acked at {survivors[g % len(survivors)]} "
                    f"(last answer {last}); status by rank "
                    f"{frames_kill_loop.statuses(bases, survivors, g)}"
                    for g, last in list(stalled.items())[:5]))
            watcher.join(timeout=240)
            acks = sorted(t for t in first_ack.values() if t > t_kill[0])
            gaps = np.diff([t_kill[0]] + acks)
            after = {g: t - t_kill[0] for g, t in first_ack.items()
                     if t > t_kill[0]}
            moved = len(reelected)
            reelect_ms = np.array(sorted(reelected.values()) or [0]) * 1e3
            log("multihost_frames", t0, step="sigkill", victim=victim,
                acked=len(first_ack), acked_after_kill=len(acks),
                worst_ack_gap_s=float(gaps.max()) if len(gaps) else None,
                attempt_timeout_s=frames_kill_loop.ATTEMPT_S,
                victim_led_last_first_ack_s=max(
                    (after[g] for g in victim_gs if g in after),
                    default=None),
                others_last_first_ack_s=max(
                    (t for g, t in after.items() if g not in victim_gs),
                    default=None),
                written_groups_victim_led=len(victim_gs),
                written_groups_reelected=moved,
                reelect_p50_ms=float(np.percentile(reelect_ms, 50)),
                reelect_max_ms=float(reelect_ms.max()))
            if moved != len(victim_gs):
                raise AssertionError(f"{len(victim_gs) - moved} groups the "
                                     f"victim led did not re-elect")

            # 4. the rank restarts on its own data dir.
            steps = _Steps()
            start(victim)
            _wait_status(bases[victim], proc=procs[victim], deadline_s=600)
            steps.done("serving")
            want = max(_http("GET", bases[r] + "/engine/status")[1][
                "applied_total"] for r in survivors)
            t_end = time.monotonic() + 600
            while True:
                st = _wait_status(bases[victim], proc=procs[victim])
                if st["applied_total"] >= want \
                        and st["groups_with_leader"] == groups:
                    break
                if time.monotonic() > t_end:
                    raise AssertionError(f"rank {victim} did not catch up: "
                                         f"{st}")
                time.sleep(1.0)
            steps.done("caught_up")

            # 5. every acked write from the rank that acked it.
            def get(item):
                (g, key), (val, r) = item
                st, body = _http("GET", f"{bases[r]}/tenants/{g}/v2/keys/"
                                 f"{key}")
                if st != 200 or body["node"]["value"] != val:
                    raise AssertionError(f"GET g={g} {key} at {r}: {st} "
                                         f"{body}")

            errs = _in_threads(get, list(acked.items()))
            if errs:
                raise AssertionError(f"acked writes lost: {errs[:5]}")
            steps.done("read_back")
            log("multihost_frames", t0, step="rejoin", read_back=len(acked),
                step_s={k: round(v, 3) for k, v in steps.items()})

            # 6. SIGTERM: rc 0 and an exit line from every rank.
            for p in procs:
                p.send_signal(signal.SIGTERM)
            rcs = [p.wait(timeout=120) for p in procs]
            if rcs != [0] * hosts:
                raise AssertionError(f"exit codes on SIGTERM: {rcs}")
            lines = [_rank_line(path) for path in outs]
        except BaseException:
            for path in logs:
                with open(path, "rb") as f:
                    print(f"== {path}\n" + f.read()[-3000:].decode(
                        errors="replace"), file=sys.stderr)
            raise
        finally:
            for p in procs:
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
    by_variant = {k: sum(ln["launches_by_variant"][k] for ln in lines)
                  for k in lines[0]["launches_by_variant"]}
    if on_card and not all(ln["device"].startswith("cuda")
                           and ln["launches_by_variant"]["te5"] > 0
                           and ln["launches_by_variant"]["generic"] > 0
                           for ln in lines):
        raise AssertionError(f"a rank did not run the TE=5 and generic "
                             f"kernels on the card: {lines}")
    log("multihost_frames", t0, step="sigterm", rcs=rcs, ranks=lines,
        groups_led_by_rank=[ln["leading"] for ln in lines],
        peak_device_mib_by_rank=[None if ln["peak_device_bytes"] is None
                                 else ln["peak_device_bytes"] / 2 ** 20
                                 for ln in lines])
    return sum(by_variant.values()), by_variant, lines


SOAK_SAMPLE = 200     # groups each of its "all serving" steps writes
# The soak's client gives a write 2 s an attempt and then proposes it
# anew. Five engines in one process share one GIL: on an H100 their
# rounds take 0.7-1.0 s at 12,500 and 100,000 groups alike, and a write
# forwarded to another engine's leader takes five to seven of them
# (PERF.md §7). An attempt not much longer than that can be cancelled
# just before its write acks, again and again: with 6 s attempts a few
# writes through a restarted engine never acked within a step's 150 s.
# An attempt here is 20 s, about three times the slowest write; the
# soak's deadline for each step stays as it is.
SOAK_ATTEMPT_S = 20.0
# The bench's per-card shard shape. At 100,000 groups the leg takes
# ~380 s against phases 7-13's ~175 s beside it, which would put the
# script near its 1,200 s limit; with 6 s attempts it also missed there
# once (188 of 200 writes acked in the 150 s after the first restart;
# PERF.md §7).
SOAK_GROUPS = 12_500
# Depth: one stop-and-restart cycle of the soak's two (the second took
# 77-100 s more and checks nothing the first does not).
SOAK_KILL_CYCLES = 1
# The leg's limit: with two cycles it took 229-309 s at 12,500 groups
# and 381 s at 100,000 beside phases 7-13 on an H100 (PERF.md §6).
SOAK_LIMIT_S = 600


def phase_frames_soak(dev, groups=SOAK_GROUPS, hosts=NHOSTS,
                      sample=SOAK_SAMPLE):
    """tests/test_frames_plane.py's seeded chaos soak of the frames
    plane (`slow` there), on the card: `hosts` in-process `HostEngine`s
    on `dev`, one replica of every group each, with the soak's engine
    settings (W=8, max_ents 2, fsync off, 5 ms between rounds,
    request_timeout 6 s), the mailbox, proposals and payloads on frames
    between them. Every group led (90 s), then tools/frames_soak.py's
    schedule (seed 11: every engine serving; SOAK_KILL_CYCLES times a
    stop(), writes through the survivors, the restart; a pair
    partitioned and healed),
    writing one key to each of `sample` fixed groups (0 and G-1 among
    them) from 100 threads: the depth cut (the soak writes every one of
    its 6 groups). Logs per step: seconds to the step's last ack; after
    each stop, the seconds until every one of the G groups has a live
    leader again (measured beside the schedule, up to 150 s; null and
    the count of groups left without one past that); after each restart,
    the seconds to rebuild the engine on its data dir and from its start
    until it acks every write sent through it; through the partition,
    the seconds to its last ack; ring_resolve's launches over the leg by
    instantiation, and the card's name and power limit. Returns the
    launches, in all and by instantiation."""
    import torch
    from etcd_tpu_torch.server.hostengine import HostEngine, HostEngineConfig
    from etcd_tpu_torch.tools import frames_soak
    t0 = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip() if torch.device(dev).type == "cuda" \
        else "cpu"
    gs = [int(g) for g in np.linspace(0, groups - 1, sample)]
    assert len(set(gs)) == sample and gs[0] == 0 and gs[-1] == groups - 1
    ports = _free_ports(hosts)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_soak_")

    def mk(r):
        return HostEngine(HostEngineConfig(
            groups=groups, peers=hosts,
            data_dir=os.path.join(tmp, f"host{r}"), host_id=r,
            frame_listen=("127.0.0.1", ports[r]),
            frame_peers={h: ("127.0.0.1", ports[h]) for h in range(hosts)},
            window=8, max_ents=2, fsync=False, stagger=True,
            round_interval=0.005, request_timeout=6.0,
            data_plane="frames", device=str(dev)))

    def led(among):
        known = np.zeros(groups, bool)
        for e in among:
            known |= (e.l_state == 2) | (e.l_lead > 0)
        return bool(known.all())

    def until(cond, deadline_s, what):
        t1 = time.perf_counter()
        while not cond():
            if time.perf_counter() - t1 > deadline_s:
                raise AssertionError(f"frames_soak: {what} not within "
                                     f"{deadline_s} s")
            time.sleep(0.05)
        return round(time.perf_counter() - t1, 3)

    def last_ack(acks):
        return round(max(s for _, s, _ in acks.values()), 3)

    def attempts(acks):
        return max(n for _, _, n in acks.values())

    def live_led():
        live = [e for i, e in enumerate(engines) if i != cur["victim"]]
        return bool(np.any([e.l_state == 2 for e in live], axis=0).all())

    def watch():
        # Every group led by a live engine again: the survivors, and the
        # restarted engine once it runs. Measured beside the schedule,
        # which does not wait for it.
        try:
            cur["reelect_s"] = until(live_led, 150, "re-election")
        except AssertionError:
            cur["reelect_s"] = None

    cur = {}

    def on_step(name, info):
        if name == "baseline":
            log("frames_soak", t0, step="baseline", card=card,
                groups=groups, hosts=hosts, sampled_groups=sample,
                boot_s=boot_s, serve_s=last_ack(info["acks"]),
                attempts_max=attempts(info["acks"]))
        elif name == "stopped":
            cur.clear()
            cur.update(victim=info["victim"], t_stop=time.perf_counter())
            cur["watch"] = threading.Thread(target=watch, daemon=True)
            cur["watch"].start()
        elif name == "outage":
            cur["through_s"] = last_ack(info["acks"])
            cur["through_attempts"] = attempts(info["acks"])
        elif name == "restarted":
            cur["rebuild_s"] = info["rebuild_s"]
            cur["t_start"] = time.perf_counter()
        elif name == "post_restart":
            cur["victim"] = None      # live_led: every engine again
            mine = [s for i, s, _ in info["acks"].values()
                    if i == info["victim"]]
            cur["watch"].join(timeout=max(
                0.0, 155 - (time.perf_counter() - cur["t_stop"])))
            log("frames_soak", t0, step=f"kill_cycle_{info['cycle']}",
                card=card, victim=info["victim"],
                reelect_s=cur.get("reelect_s"),
                unled_groups=None if cur.get("reelect_s") is not None
                else int(groups - np.any([e.l_state == 2 for e in engines],
                                         axis=0).sum()),
                write_through_outage_s=cur["through_s"],
                outage_attempts_max=cur["through_attempts"],
                outage_s=round(cur["t_start"] - cur["t_stop"], 3),
                rebuild_s=round(cur["rebuild_s"], 3),
                restarted_serves_s=round(max(mine), 3),
                restarted_writes=len(mine),
                serve_s=last_ack(info["acks"]),
                attempts_max=attempts(info["acks"]))
        elif name == "partition":
            cur.update(info)
        elif name == "post_heal":
            launches, by_variant = _launches_read()
            cur.update(launches=launches, by_variant=by_variant)
            log("frames_soak", t0, step="partition", card=card,
                pair=cur["pair"], via=cur["via"],
                partition_serve_s=last_ack(cur["acks"]),
                blocked_frames_dropped=cur["blocked_frames_dropped"],
                post_heal_serve_s=last_ack(info["acks"]),
                attempts_max=max(attempts(cur["acks"]),
                                 attempts(info["acks"])),
                round_ms=[round(e.round_ms_ewma, 3) for e in engines],
                launches=launches, launches_by_variant=by_variant)

    _launches_reset()
    engines = [mk(r) for r in range(hosts)]
    for e in engines:
        e.start()
    try:
        boot_s = until(lambda: led(engines), 90, "every group led")
        frames_soak.run(engines, mk, gs, attempt_s=SOAK_ATTEMPT_S,
                        threads=100, on_step=on_step,
                        kill_cycles=SOAK_KILL_CYCLES)
    finally:
        for e in engines:
            try:
                e.stop()
            except Exception:  # noqa: BLE001 — stopped in the schedule
                pass
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    if cur["launches"] <= 0:
        raise AssertionError("ring_resolve was not launched on frames_soak")
    return cur["launches"], cur["by_variant"]


def phase_frames_soak_process(dev, groups=SOAK_GROUPS,
                              timeout_s=SOAK_LIMIT_S, hold=None):
    """phase_frames_soak in a fresh interpreter of its own, each of its
    lines passed on when the next comes, killed past `timeout_s` whether
    it prints or not. The five engines share one GIL; in the smoke's own
    process, after every earlier phase, their rounds took ~25% longer
    (990 against 705-830 ms at 12,500 groups, 1,017-1,039 against 765-779
    at 100,000) and a restarted engine missed the soak's 150 s deadline
    at both sizes (PERF.md §6). With `hold` (a threading.Event) the
    child, its result printed, keeps its context on the card until
    `hold` is set: the phases beside it tell their processes on the card
    by the count of compute apps, which the child's exit would change
    under them. Returns the leg's ring_resolve launches, in all and by
    instantiation, from the child's result line."""
    import queue
    code = ("import json, sys, chip_smoke, torch\n"
            "n, by = chip_smoke.phase_frames_soak("
            f"torch.device({str(dev)!r}), groups={groups})\n"
            "print(json.dumps({'launches': n, 'by_variant': by}),"
            " flush=True)\n"
            "sys.stdin.read()\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    lines = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    t_end = time.monotonic() + timeout_s
    last = ""
    try:
        while True:
            try:
                line = lines.get(timeout=max(0.0, t_end - time.monotonic()))
            except queue.Empty:
                raise AssertionError(
                    f"frames_soak: past its {timeout_s} s limit") from None
            if line is None:
                break
            if last:
                print(last, end="", flush=True)
            last = line
            if line.startswith('{"launches"'):
                if hold is not None:
                    hold.wait(max(0.0, t_end - time.monotonic()))
                proc.stdin.close()
        rc = proc.wait(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        if not proc.stdin.closed:
            proc.stdin.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"frames_soak: rc={rc}; last line {last!r}")
    out = json.loads(last)
    return out["launches"], out["by_variant"]


def _gloo_cuda_probe(dev) -> str:
    """Whether gloo's all-to-all takes CUDA tensors as they are, on a
    one-rank group in a fresh process: "accepts", or the error."""
    code = (
        "import torch, torch.distributed as d\n"
        f"d.init_process_group('gloo', init_method='tcp://127.0.0.1:"
        f"{_free_port()}', rank=0, world_size=1)\n"
        f"x = torch.arange(8, dtype=torch.int32, device='{dev}')\n"
        "y = torch.empty_like(x)\n"
        "try:\n"
        "    d.all_to_all_single(y, x); torch.cuda.synchronize()\n"
        "    print('accepts' if torch.equal(x, y) else 'wrong result')\n"
        "except Exception as e:\n"
        "    print(type(e).__name__ + ': ' + str(e).splitlines()[0])\n"
        "d.destroy_process_group()\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    return (res.stdout.strip().splitlines() or [res.stderr[-300:]])[-1]


def _wal_bytes(d) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if f.startswith("engine-"))


def _read_status(path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def phase_multihost_collective(dev, groups=G, tenants=1000, quorum_gets=100,
                               hosts=NHOSTS, device_env=None, backend="gloo",
                               deep_groups=10):
    """The multi-host engine on the collective data plane as users run
    it: `python -m etcd_tpu_torch.tools.multihost_supervisor` spawning
    `hosts` rank processes of the launcher on the one card, the ranks
    the peers axis of a (1, hosts) mesh on a gloo process group
    (MHE_PLANE=collective, MHE_BACKEND=gloo: NCCL allows one rank per
    card, and this machine has one card; gloo moves the CUDA mailbox
    through pinned host memory), MHE_GROUPS=groups, MHE_WINDOW=16,
    MHE_MAX_ENTS=8, MHE_FSYNC=1.

    1. spawn; seconds until the supervisor sees the ranks serving and
       until every group is led on every rank;
    2. `tenants` PUTs from 100 threads, each to a rank that is not its
       group's first leader: acked writes/s, ack p50/p99, rounds/s per
       rank;
    3. `quorum_gets` quorum GETs, each at its group's leader rank (the
       zero-append read plane): every rank's applied index and WAL
       unchanged by them, every one counted by the read plane;
    4. disk loss: `deep_groups` groups written past the ring window,
       then SIGKILL of one rank and its data dir taken away; the
       supervisor's detect, restart and total seconds (whole-job
       restart, a new process group, each survivor replaying its own
       WAL, the empty rank starting from the term floor the supervisor
       wrote it);
    5. seconds until the rebuilt rank has installed a snapshot of every
       deep group and serves every acked write from its own store; then
       every acked write read back from every rank;
    6. SIGTERM of every rank: each rank's exit line (rounds,
       ring_resolve launches by instantiation, peak device memory, comm
       calls and seconds, no failure).
    Returns the ring_resolve launches summed over the restarted ranks'
    exit lines, in all and by instantiation, and the exit lines.
    `backend="nccl"` runs the ranks on NCCL instead, rank r on card r
    (one card per rank)."""
    import torch
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    if on_card and backend == "gloo":
        log("multihost_collective", t0, step="gloo_cuda_probe",
            all_to_all_on_cuda_tensors=_gloo_cuda_probe(dev))
    step = max(groups // tenants, 1)
    gs = [(i * step - i * step % hosts + i % hosts) % groups
          for i in range(tenants)]
    client = {g: (i + 1) % hosts for i, g in enumerate(gs)}
    victim = hosts - 1
    sup = None
    pids: list = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke-mhc-") as d:
        status = os.path.join(d, "supervisor.json")
        env = dict(MHE_NHOSTS=str(hosts), MHE_GROUPS=str(groups),
                   MHE_DATA=d, MHE_STATUS=status, MHE_WINDOW=str(W),
                   MHE_MAX_ENTS=str(CLI_E), MHE_FSYNC="1",
                   MHE_PLANE="collective", MHE_BACKEND=backend,
                   MHE_MAX_RECOVERIES="1", MHE_STALL_S="30",
                   MHE_POLL_S="0.2", **(device_env or {}))
        sup_log = os.path.join(d, "supervisor.log")

        def wait_sup(pred, what, deadline_s=600):
            t_end = time.monotonic() + deadline_s
            while True:
                st = _read_status(status)
                if st and pred(st):
                    return st
                if sup.poll() is not None and not pred(_read_status(status)):
                    raise AssertionError(f"supervisor exited rc="
                                         f"{sup.returncode} before {what}")
                if time.monotonic() > t_end:
                    raise AssertionError(f"supervisor: {what} not reached")
                time.sleep(0.05)

        try:
            # 1. spawn under the supervisor; every group led on every rank.
            steps = _Steps()
            sup = _spawn(["etcd_tpu_torch.tools.multihost_supervisor"],
                         sup_log, stdout=open(sup_log, "a"), env=env)
            st = wait_sup(lambda s: s.get("state") == "serving", "serving")
            steps.done("serving")
            pids = list(st["pids"].values())
            bases = [f"http://127.0.0.1:{p}" for p in st["http_ports"]]
            for b in bases:
                _wait_status(b, groups, deadline_s=600)
            steps.done("every_group_led")
            said = [_serving_line(os.path.join(d, f"rank{r}.gen1.log"))
                    for r in range(hosts)]
            if on_card and not all(" on cuda:" in ln for ln in said):
                raise AssertionError(f"ranks not on the card: {said}")
            log("multihost_collective", t0, step="boot", ranks=hosts,
                groups=groups, peers=hosts, window=W, max_ents=CLI_E,
                fsync=True, backend=backend,
                **({"why_gloo": "one card: NCCL allows one rank per card",
                    "staging": "each rank copies its CUDA mailbox to pinned "
                               "host memory for every collective and back"}
                   if backend == "gloo" else {}),
                step_s={k: round(v, 3) for k, v in steps.items()})

            def rounds():
                return [_http("GET", b + "/engine/status")[1]["round"]
                        for b in bases]

            # 2. PUTs spread over the ranks.
            acked, lat = {}, {}

            def put(g):
                r = client[g]
                t1 = time.perf_counter()
                st_, body = _http("PUT", f"{bases[r]}/tenants/{g}/v2/keys/"
                                  f"smoke", f"value=c{g}".encode(), FORM)
                if st_ not in (200, 201) or body["node"]["value"] != f"c{g}":
                    raise AssertionError(f"PUT g={g} at rank {r}: {st_} "
                                         f"{body}")
                lat[g] = time.perf_counter() - t1
                acked[g] = (f"c{g}", r)

            r0, t1 = rounds(), time.perf_counter()
            errs = _in_threads(put, gs)
            write_s = time.perf_counter() - t1
            r1 = rounds()
            if errs or len(lat) != len(gs):
                raise AssertionError(f"PUT failures: {errs[:5]}")
            ms = np.array(sorted(lat.values())) * 1e3
            log("multihost_collective", t0, step="put", acked=len(lat),
                write_s=write_s, acked_writes_per_s=len(lat) / write_s,
                ack_p50_ms=float(np.percentile(ms, 50)),
                ack_p99_ms=float(np.percentile(ms, 99)),
                rounds_per_s_by_rank=[(b - a) / write_s
                                      for a, b in zip(r0, r1)])

            # 3. quorum GETs at the leader ranks, on the read plane.
            t_end = time.monotonic() + 120
            prev = None
            while True:       # every rank applied the same, twice in a row
                now = [_http("GET", b + "/engine/status")[1]["applied_total"]
                       for b in bases]
                if now == prev and len(set(now)) == 1:
                    break
                if time.monotonic() > t_end:
                    raise AssertionError(f"applied never settled: {now}")
                prev = now
                time.sleep(0.5)
            qgs = gs[:quorum_gets]
            leader = {g: _http("GET", f"{bases[0]}/tenants/{g}/status")[1]
                      ["lead"] for g in qgs}
            served0 = [_scrape(b, "etcd_read_index_reads_total").get("", 0.0)
                       for b in bases]
            wal0 = [_wal_bytes(os.path.join(d, f"host{r}"))
                    for r in range(hosts)]
            t1 = time.perf_counter()

            def qget(g):
                r = leader[g]
                st_, body = _http("GET", f"{bases[r]}/tenants/{g}/v2/keys/"
                                  f"smoke?quorum=true")
                if st_ != 200 or body["node"]["value"] != f"c{g}":
                    raise AssertionError(f"quorum GET g={g} at {r}: {st_} "
                                         f"{body}")

            errs = _in_threads(qget, qgs)
            q_s = time.perf_counter() - t1
            if errs:
                raise AssertionError(f"quorum GET failures: {errs[:5]}")
            time.sleep(1.0)   # an append would have reached the WAL by now
            after = [_http("GET", b + "/engine/status")[1]["applied_total"]
                     for b in bases]
            served = [_scrape(b, "etcd_read_index_reads_total").get("", 0.0)
                      for b in bases]
            wal = [_wal_bytes(os.path.join(d, f"host{r}"))
                   for r in range(hosts)]
            read_plane = sum(served) - sum(served0)
            if after != now or read_plane != len(qgs):
                raise AssertionError(
                    f"quorum GETs appended or left the read plane: applied "
                    f"{now} -> {after}, read plane served {read_plane}")
            log("multihost_collective", t0, step="quorum_get",
                quorum_gets=len(qgs), seconds=q_s,
                read_plane_served=read_plane, applied_by_rank=after,
                wal_bytes_grown_by_rank=[b - a for a, b in zip(wal0, wal)])

            # 4. Disk loss: `deep_groups` groups' logs pushed past the
            # ring window (W + 6 writes each, so only a snapshot can
            # bridge them to an empty rank), then SIGKILL of one rank and
            # its data dir taken away before the supervisor restarts the
            # job (tests/test_multihost_snapshot.py::
            # test_host_loss_with_disk_loss_recovers_via_snapshots). The
            # supervisor writes the empty dir a term floor from the
            # survivors' WALs (`load_terms`).
            deep_gs = gs[quorum_gets:quorum_gets + deep_groups]

            def push(g):
                r = client[g]
                for i in range(W + 6):
                    st_, body = _http(
                        "PUT", f"{bases[r]}/tenants/{g}/v2/keys/k{i}",
                        f"value=d{g}.{i}".encode(), FORM)
                    if st_ not in (200, 201):
                        raise AssertionError(f"PUT g={g} k{i}: {st_} {body}")
                    deep[(g, f"k{i}")] = f"d{g}.{i}"

            deep: dict = {}
            t1 = time.perf_counter()
            errs = _in_threads(push, deep_gs, n_threads=len(deep_gs))
            if errs:
                raise AssertionError(f"deep writes failed: {errs[:5]}")
            deep_s = time.perf_counter() - t1
            t_kill = time.perf_counter()
            os.kill(pids[victim], signal.SIGKILL)
            lost = os.path.join(d, f"host{victim}")
            os.rename(lost, lost + ".lost")
            wait_sup(lambda s: s.get("state") == "recovering", "detection",
                     deadline_s=120)
            detect_s = time.perf_counter() - t_kill
            st = wait_sup(lambda s: len(s.get("recoveries", [])) >= 1
                          and s.get("state") in ("serving", "failed"),
                          "recovery")
            rec = st["recoveries"][0]
            if not rec["ok"]:
                raise AssertionError(f"recovery failed: {rec}")
            pids = list(st["pids"].values())
            if not os.path.exists(os.path.join(lost, "term_floor.json")):
                raise AssertionError("no term floor in the lost rank's dir")
            for b in bases:
                _wait_status(b, groups, deadline_s=600)
            led_s = time.perf_counter() - t_kill
            if sup.wait(timeout=60) != 0:
                raise AssertionError(f"supervisor rc={sup.returncode}")
            log("multihost_collective", t0, step="sigkill_disk_loss",
                victim=victim, deep_groups=len(deep_gs),
                deep_writes=len(deep), deep_write_s=deep_s,
                detect_s=detect_s, cause=rec["cause"],
                kill_job_s=rec["detect_to_killed_s"],
                restart_s=rec["restart_s"], total_s=rec["total_s"],
                every_group_led_s=led_s, generation=st["generation"])

            # 5. every acked write, from all five ranks: the rebuilt
            # rank's own store serves them once it has caught up through
            # snapshot installs and appends (a plain GET is local).
            writes = {(g, "smoke"): val for g, (val, _) in acked.items()}
            writes.update(deep)

            def read_all(ranks):
                def get(item):
                    r, (g, key) = item
                    st_, body = _http("GET", f"{bases[r]}/tenants/{g}/v2/"
                                      f"keys/{key}")
                    if st_ != 200 or body["node"]["value"] != writes[
                            (g, key)]:
                        raise AssertionError(f"GET g={g} {key} at {r}: "
                                             f"{st_} {body}")
                return _in_threads(get, [(r, k) for r in ranks
                                         for k in writes])

            t_end = time.monotonic() + 300
            while True:
                stv = _http("GET", bases[victim] + "/engine/status")[1]
                errs = (read_all([victim]) if stv.get("snaps_installed", 0)
                        >= len(deep_gs) else ["no snapshot yet"])
                if not errs:
                    break
                if time.monotonic() > t_end:
                    raise AssertionError(f"the rebuilt rank never caught "
                                         f"up: {stv} {errs[:5]}")
                time.sleep(1.0)
            caught_up_s = time.perf_counter() - t_kill
            t1 = time.perf_counter()
            errs = read_all(range(hosts))
            if errs:
                raise AssertionError(f"acked writes lost: {errs[:5]}")
            log("multihost_collective", t0, step="read_back",
                read_back=len(writes), ranks=hosts,
                seconds=time.perf_counter() - t1,
                caught_up_s_after_kill=caught_up_s,
                caught_up_s_after_every_group_led=caught_up_s - led_s,
                victim_snaps_installed=stv["snaps_installed"],
                snaps_sent_by_rank=[_http("GET", b + "/engine/status")[1]
                                    ["snaps_sent"] for b in bases])

            # 6. SIGTERM: an exit line from every rank, no failure.
            gen = st["generation"]
            outs = [os.path.join(d, f"rank{r}.gen{gen}.log")
                    for r in range(hosts)]
            for pid in pids:
                os.kill(pid, signal.SIGTERM)
            t_end = time.monotonic() + 120
            while True:
                try:
                    lines = [_rank_line(path) for path in outs]
                    break
                except AssertionError:
                    if time.monotonic() > t_end:
                        raise
                    time.sleep(0.2)
        except BaseException:
            for name in sorted(os.listdir(d)):
                if name.endswith(".log"):
                    with open(os.path.join(d, name), "rb") as f:
                        print(f"== {name}\n" + f.read()[-3000:].decode(
                            errors="replace"), file=sys.stderr)
            raise
        finally:
            if sup is not None and sup.poll() is None:
                sup.send_signal(signal.SIGTERM)   # it SIGKILLs its ranks
                sup.wait(timeout=60)
            for pid in pids:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
            time.sleep(0.5)
    failed = [ln for ln in lines if ln["failed"] is not None
              or ln["plane"] != "collective"]
    by_variant = {k: sum(ln["launches_by_variant"][k] for ln in lines)
                  for k in lines[0]["launches_by_variant"]}
    # Send assembly resolves (G, 1, hosts) indices, the conflict scan
    # (G, 1, 8): the instantiations every rank must have launched.
    send = {4: "te4", 5: "te5"}.get(hosts, "generic")
    if failed or (on_card and not all(
            ln["device"].startswith("cuda")
            and ln["launches_by_variant"][send] > 0
            and ln["launches_by_variant"]["generic"] > 0 for ln in lines)):
        raise AssertionError(f"a rank failed or did not run the {send} and "
                             f"generic kernels on the card: {lines}")
    log("multihost_collective", t0, step="sigterm", ranks=lines,
        gloo_stages_through_host=[ln["stages_through_host"] for ln in lines],
        rounds_by_rank=[ln["rounds"] for ln in lines],
        groups_led_by_rank=[ln["leading"] for ln in lines],
        peak_device_mib_by_rank=[None if ln["peak_device_bytes"] is None
                                 else ln["peak_device_bytes"] / 2 ** 20
                                 for ln in lines])
    return sum(by_variant.values()), by_variant, lines


ORACLE_SCHEDULES = (
    # (name, rounds, run_sampled's fault knobs, twin resolve): the tight
    # window and heavy-loss schedules of tests/test_equivalence.py; the
    # first also runs in lockstep on the plain resolve.
    ("tight_window", 90, dict(drop_p=0.2, delay_p=0.1, prop_p=0.95), True),
    ("heavy_loss", 90, dict(drop_p=0.45, delay_p=0.2, partition_every=60),
     False))


def phase_raft_oracle(dev, groups=G, schedules=ORACLE_SCHEDULES):
    """The card's round against the scalar Raft (etcd_tpu_torch/ops/
    oracle.py): `kernel.step` with the CUDA `ring_resolve`, then
    `route_local`, at groups × P (W, E; TE=5 in send assembly, TE=4 in the
    conflict scan), faults drawn on the card from a torch.Generator
    seeded from SEED; the port's scalar `raft.core.Raft` mirrors a sample
    of at least 128 groups (0, G-1, and groups whose rows straddle a
    256-row tile edge of the kernel's launch plan) and must agree with
    the card on every field after every round; `need_host` never fires
    on any group; more than half the groups commit. The first schedule
    also steps a twin state with `ring_resolve_ref`, equal after every
    round. Returns the ring_resolve launches of the kernel runs, in all
    and by instantiation."""
    import torch
    from etcd_tpu_torch.ops import oracle
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve, ring_resolve_ref
    from etcd_tpu_torch.ops.state import KernelConfig
    t0 = time.perf_counter()
    cfg = KernelConfig(groups=groups, peers=P, window=W, max_ents=E)
    by0 = dict(ring_resolve.launches_by_variant)
    for k, (name, rounds, faults, twin) in enumerate(schedules):
        out = oracle.run_sampled(
            cfg, SEED + k, rounds, device=dev,
            twin_resolve=ring_resolve_ref if twin else None, **faults)
        log("raft_oracle", t0, schedule=name, window=W, max_ents=E,
            equal_to_scalar_raft=True, need_host=False,
            equal_to_plain=True if twin else None, **faults, **out)
    by = {k: ring_resolve.launches_by_variant[k] - by0[k] for k in by0}
    if torch.device(dev).type == "cuda" and not (by["te4"] and by["te5"]):
        raise AssertionError(f"raft_oracle: kernels launched {by}")
    return sum(by.values()), by


MEMBERS = ("m0", "m1", "m2")
# The one cut of the member cluster: the reference's --snapshot-count is
# 10,000; at 250 the phase's writes cross several snapshots.
MEMBER_SNAPSHOT_COUNT = 250


def _member_args(name, d, peers, clients):
    initial = ",".join(f"{n}={peers[n]}" for n in MEMBERS)
    return ["etcd_tpu_torch", "--name", name,
            "--data-dir", os.path.join(d, name),
            "--initial-cluster", initial,
            "--initial-advertise-peer-urls", peers[name],
            "--listen-peer-urls", peers[name],
            "--listen-client-urls", clients[name],
            "--advertise-client-urls", clients[name],
            "--initial-cluster-token", "chip-smoke-members",
            "--initial-cluster-state", "new",
            "--heartbeat-interval", "100", "--election-timeout", "1000",
            "--snapshot-count", str(MEMBER_SNAPSHOT_COUNT)]


def _member_stats(base):
    try:
        st, body = _http("GET", base + "/v2/stats/self", timeout=5)
    except OSError:
        return None
    return body if st == 200 else None


def _member_leader(clients, among):
    """The member of `among` that leads, once every member of `among`
    answers /v2/stats/self and names it as leader; else None."""
    stats = {n: _member_stats(clients[n]) for n in among}
    if any(s is None for s in stats.values()):
        return None
    leads = {s["leaderInfo"]["leader"] for s in stats.values()}
    if len(leads) != 1:
        return None
    lead = leads.pop()
    return next((n for n, s in stats.items()
                 if s["id"] == lead and s["state"] == "StateLeader"), None)


def _until(cond, what, deadline_s=120.0, every=0.05):
    """cond()'s first true value, polled until the deadline; an OSError
    (a process still starting) counts as false."""
    t_end = time.monotonic() + deadline_s
    while True:
        try:
            got = cond()
        except OSError:
            got = None
        if got:
            return got
        if time.monotonic() > t_end:
            raise AssertionError(f"timed out on {what}")
        time.sleep(every)


def _member_value(base, key):
    try:
        st, body = _http("GET", f"{base}/v2/keys/{key}", timeout=10)
    except OSError:
        return None
    return body["node"]["value"] if st == 200 else None


def phase_member_cluster(dev, writes=1000, quorum_gets=100, cas_racers=20):
    """etcd's own deployment through the port's CLI: three `python -m
    etcd_tpu_torch` members from a static --initial-cluster bootstrap on
    localhost, at the reference's tick (--heartbeat-interval 100,
    --election-timeout 1000), fsync on, --snapshot-count 250 (the cut).

    1. boot: every member answers /v2/stats/self and one leads;
    2. `writes` PUTs from 100 threads spread over the three members
       (followers forward to the leader), `quorum_gets` quorum GETs, and
       a CAS race of `cas_racers` threads (exactly one wins);
    3. SIGKILL of a follower while writes go on through the others, its
       restart on its own data dir: seconds until it has caught up;
    4. SIGKILL of the leader while writes go on: seconds until a new
       leader; the old leader restarts on its own data dir;
    5. every acked write read back from every member; /v2/members and
       each member's /v2/stats/self sane; no member among the card's
       compute apps (the member mode is host code only); SIGTERM, rc 0
       for every member.
    The card does no work in this phase."""
    import torch
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    ports = _free_ports(2 * len(MEMBERS))
    peers = {n: f"http://127.0.0.1:{ports[i]}"
             for i, n in enumerate(MEMBERS)}
    clients = {n: f"http://127.0.0.1:{ports[len(MEMBERS) + i]}"
               for i, n in enumerate(MEMBERS)}
    procs = {}
    acked = {}               # key -> value
    lock = threading.Lock()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-members-") as d:
        logp = os.path.join(d, "members.err")

        def start(n):
            procs[n] = _spawn(_member_args(n, d, peers, clients), logp)

        def put(n, key, val, timeout=60):
            st, body = _http("PUT", f"{clients[n]}/v2/keys/{key}",
                             f"value={val}".encode(), FORM, timeout=timeout)
            if st not in (200, 201) or body["node"]["value"] != val:
                raise AssertionError(f"PUT {key} at {n}: {st} {body}")
            with lock:
                acked[key] = val

        try:
            # 1. boot.
            apps0 = _compute_apps() if on_card else []
            t1 = time.perf_counter()
            for n in MEMBERS:
                start(n)
            lead = _until(lambda: _member_leader(clients, MEMBERS),
                          "a leader at boot")
            boot_s = time.perf_counter() - t1
            apps = _compute_apps() if on_card else []
            if len(apps) > len(apps0):
                raise AssertionError(f"a member holds a context on the "
                                     f"card: {apps0} -> {apps}")
            log("member_cluster", t0, step="boot", members=len(MEMBERS),
                boot_s=boot_s, leader=lead,
                snapshot_count=MEMBER_SNAPSHOT_COUNT,
                compute_apps_before=len(apps0),
                compute_apps_with_members=len(apps))

            # 2. load spread over the members.
            lat = {}

            def timed_put(i):
                t2 = time.perf_counter()
                put(MEMBERS[i % len(MEMBERS)], f"w/{i}", f"v{i}")
                lat[i] = time.perf_counter() - t2

            t1 = time.perf_counter()
            errs = _in_threads(timed_put, list(range(writes)))
            write_s = time.perf_counter() - t1
            if errs or len(lat) != writes:
                raise AssertionError(f"PUT failures: {errs[:5]}")

            def qget(i):
                n = MEMBERS[i % len(MEMBERS)]
                st, body = _http("GET", f"{clients[n]}/v2/keys/w/{i}"
                                 "?quorum=true")
                if st != 200 or body["node"]["value"] != f"v{i}":
                    raise AssertionError(f"quorum GET w/{i} at {n}: {st} "
                                         f"{body}")

            errs = _in_threads(qget, list(range(quorum_gets)))
            if errs:
                raise AssertionError(f"quorum GET failures: {errs[:5]}")
            put(lead, "cas", "0")
            won = []

            def race(i):
                n = MEMBERS[i % len(MEMBERS)]
                st, body = _http("PUT", f"{clients[n]}/v2/keys/cas"
                                 "?prevValue=0", f"value=r{i}".encode(),
                                 FORM)
                if st == 200:
                    won.append(i)
                elif not (st == 412 and body["errorCode"] == 101):
                    raise AssertionError(f"CAS r{i}: {st} {body}")

            errs = _in_threads(race, list(range(cas_racers)))
            if errs or len(won) != 1:
                raise AssertionError(f"CAS race: winners {won}, {errs[:5]}")
            acked["cas"] = f"r{won[0]}"
            ms = np.array(sorted(lat.values())) * 1e3
            log("member_cluster", t0, step="load", acked=writes,
                write_s=write_s, acked_writes_per_s=writes / write_s,
                ack_p50_ms=float(np.percentile(ms, 50)),
                ack_p99_ms=float(np.percentile(ms, 99)),
                quorum_gets=quorum_gets, cas_racers=cas_racers,
                cas_winners=len(won))

            # 3 and 4: writes go on through the live members while one
            # member is killed; the ones that ack count.
            def writer(stop, live, tag):
                i = 0
                while not stop.is_set():
                    n = live[i % len(live)]
                    try:
                        put(n, f"{tag}/{i}", f"{tag}{i}", timeout=10)
                    except (AssertionError, OSError, ValueError):
                        time.sleep(0.05)
                    i += 1

            def kill_with_writes(victim, live, tag):
                stop = threading.Event()
                ths = [threading.Thread(target=writer,
                                        args=(stop, live, f"{tag}{k}"))
                       for k in range(4)]
                for th in ths:
                    th.start()
                time.sleep(0.5)
                procs[victim].send_signal(signal.SIGKILL)
                procs[victim].wait(timeout=30)
                return stop, ths

            def caught_up(n, key):
                return _member_value(clients[n], key) == acked[key]

            fol = next(n for n in MEMBERS if n != lead)
            others = [n for n in MEMBERS if n != fol]
            stop, ths = kill_with_writes(fol, others, "f")
            time.sleep(2.0)
            put(lead, "before-restart", "1")
            t1 = time.perf_counter()
            start(fol)
            _until(lambda: caught_up(fol, "before-restart"),
                   "the follower's catch-up")
            restart_s = time.perf_counter() - t1
            stop.set()
            for th in ths:
                th.join(timeout=60)
            log("member_cluster", t0, step="follower_sigkill", member=fol,
                restart_to_caught_up_s=restart_s, acked_so_far=len(acked))

            old = lead
            others = [n for n in MEMBERS if n != old]
            stop, ths = kill_with_writes(old, others, "l")
            t1 = time.perf_counter()
            lead = _until(lambda: _member_leader(clients, others),
                          "a new leader", every=0.02)
            reelect_s = time.perf_counter() - t1
            time.sleep(1.0)
            stop.set()
            for th in ths:
                th.join(timeout=60)
            start(old)
            log("member_cluster", t0, step="leader_sigkill", old=old,
                new=lead, reelection_s=reelect_s, acked_so_far=len(acked))

            # 5. every acked write from every member.
            _until(lambda: _member_leader(clients, MEMBERS),
                   "all three members back")
            want = dict(acked)

            def read_back(n):
                missing = [k for k, v in want.items()
                           if _member_value(clients[n], k) != v]
                for k in missing:   # a member may still be applying
                    _until(lambda: _member_value(clients[n], k) == want[k],
                           f"{k} on {n}", deadline_s=60)

            errs = _in_threads(read_back, list(MEMBERS),
                               n_threads=len(MEMBERS))
            if errs:
                raise AssertionError(f"read-back failures: {errs}")
            st, body = _http("GET", clients[lead] + "/v2/members")
            if st != 200 or sorted(
                    (m["name"], m["peerURLs"][0], m["clientURLs"][0])
                    for m in body["members"]) != sorted(
                    (n, peers[n], clients[n]) for n in MEMBERS):
                raise AssertionError(f"/v2/members: {st} {body}")
            stats = {n: _member_stats(clients[n]) for n in MEMBERS}
            if (sorted(s["name"] for s in stats.values()) != list(MEMBERS)
                    or [s["state"] for s in stats.values()].count(
                        "StateLeader") != 1):
                raise AssertionError(f"/v2/stats/self: {stats}")
            apps = _compute_apps() if on_card else []
            if len(apps) > len(apps0):
                raise AssertionError(f"a member holds a context on the "
                                     f"card: {apps0} -> {apps}")
            snaps = {n: len([f for f in os.listdir(
                os.path.join(d, n, "member", "snap"))
                if f.endswith(".snap")]) for n in MEMBERS}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            rcs = {}
            for n, p in procs.items():
                try:
                    rcs[n] = p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    rcs[n] = p.wait(timeout=30)
        if rcs != {n: 0 for n in MEMBERS}:
            with open(logp) as f:
                raise AssertionError(f"member exit codes {rcs}: "
                                     f"{f.read()[-2000:]}")
    log("member_cluster", t0, step="read_back", acked=len(want),
        read_back_from=len(MEMBERS), snapshot_files=snaps,
        exit_codes=rcs, card_work=False)


REGISTRY_TOKEN = "chip-smoke"
CTL_COMMANDS = (             # (etcdctl arguments, rc, expected stdout)
    (("set", "/ctl/a", "1"), 0, "1"), (("get", "/ctl/a"), 0, "1"),
    (("mk", "/ctl/b", "2"), 0, "2"), (("mk", "/ctl/b", "3"), 1, None),
    (("update", "/ctl/b", "4"), 0, "4"), (("ls", "/"), 0, "/ctl"),
    (("rm", "/ctl/a"), 0, ""), (("mkdir", "/ctl/d"), 0, ""),
    (("rmdir", "/ctl/d"), 0, ""))


def _imports_torch(importtime_stderr) -> bool:
    """Whether `python -X importtime` imported torch, from its stderr."""
    return any(ln.startswith("import time:") and ln.rsplit("|", 1)[-1]
               .strip().split(".")[0] == "torch"
               for ln in importtime_stderr.splitlines())


def _loads_torch(pid) -> bool:
    """Whether process pid has torch's shared libraries mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in ln for ln in f)


def _dumped_writes(text) -> set:
    """{(group, method, path)} of every request in a `dump_logs --engine`
    listing (single `req` entries and batched `multi[n]` ones)."""
    out = set()
    for line in text.splitlines():
        cols = line.split("\t")
        if len(cols) != 5 or not cols[0].isdigit():
            continue
        for item in filter(None, cols[4].split("; ")):
            head, _, rest = item.partition(" ")
            kind, _, body = rest.partition(" ")
            if kind == "req" or kind.startswith("multi["):
                g = int(head[1:head.index("@")])
                for req in body.split(", "):
                    method, _, path = req.partition(" ")
                    out.add((g, method, path))
    return out


def phase_tools_engine(dev, groups=G, tenants=1000, cas_racers=20,
                       proxy_writes=200, device_flags=()):
    """etcd's own tools against the CLI's engine (`python -m
    etcd_tpu_torch --engine-groups groups --engine-peers P --engine-window
    W`, the CLI shape: max_ents 8, fsync on, rounds 1 ms apart), every
    tool pointed at a tenant's base URL /tenants/{g}:

    1. discovery and proxy: a registry of size 3 in tenant T's keyspace;
       three `python -m etcd_tpu_torch --discovery URL` members
       (heartbeat 100 ms, election 1,000 ms) bootstrap from it; a fourth
       process on the same token finds the cluster full and falls back to
       proxy mode; /v2/members shows 3, the registry holds 3; writes
       through the proxy read back from every member; a long-poll watch
       through the proxy fires; none of the four processes is among the
       card's compute apps or maps torch; rc 0 on SIGTERM;
    2. etcdctl: `python -m etcd_tpu_torch.etcdctl.main --peers
       URL/tenants/g` on three tenants (set, get, mk twice, update, ls,
       rm, mkdir, rmdir), each command's rc and output, and no command
       imports torch (`-X importtime`);
    3. the SDK: KeysAPI(Client([URL/tenants/g])) on `tenants` tenants
       from 100 threads: set and get back, in-order create, a
       `cas_racers`-way prev_value race with one winner, a watcher from
       after_index that sees the next set, tenant isolation (KeysError
       100). It starts with at least a fifth of a checkpoint interval of
       rounds ahead, so that the engine's next checkpoint (which purges
       the WAL before it) falls after the dump;
    4. dump-logs: SIGTERM, rc 0, the server's stop line (its
       ring_resolve launches); `python -m etcd_tpu_torch.tools.dump_logs
       --engine DIR` rc 0, every write the SDK acked in it.
    Returns the ring_resolve launches of the server process, in all and
    by instantiation (its counts start at 0 with the process)."""
    import torch
    from etcd_tpu_torch.client import Client, KeysAPI, KeysError
    from etcd_tpu_torch.server.engine import EngineConfig
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    gs = [i * groups // tenants for i in range(tenants)]
    reg_t, ctl_ts, sdk_ts = gs[1], gs[2:5], gs[5:]
    procs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke-tools-") as d:
        srv_log = os.path.join(d, "server.log")
        mem_log = os.path.join(d, "members.log")
        port = _free_port()
        url = f"http://127.0.0.1:{port}"
        data = os.path.join(d, "cli")
        try:
            steps = _Steps()
            apps0 = _compute_apps() if on_card else []
            procs["server"] = _spawn(
                ["etcd_tpu_torch", "--engine-groups", str(groups),
                 "--engine-peers", str(P), "--engine-window", str(W),
                 "--data-dir", data, "--listen-client-urls", url,
                 *device_flags], srv_log)
            _wait_status(url, groups, procs["server"])
            steps.done("boot")
            apps = _compute_apps() if on_card else []
            if on_card and len(apps) != len(apps0) + 1:
                raise AssertionError(f"the server is not on the card: "
                                     f"{apps0} -> {apps}")

            # 1. Discovery and the fallback proxy on tenant reg_t.
            disc = (f"{url}/tenants/{reg_t}/v2/keys/_etcd/registry/"
                    f"{REGISTRY_TOKEN}")
            st, body = _http("PUT", f"{disc}/_config/size", b"value=3", FORM)
            if st not in (200, 201):
                raise AssertionError(f"registry size: {st} {body}")
            ports = _free_ports(8)
            names = ["m0", "m1", "m2", "m3"]
            clients = {n: f"http://127.0.0.1:{ports[4 + i]}"
                       for i, n in enumerate(names)}

            def start(i):
                n = names[i]
                procs[n] = _spawn(
                    ["etcd_tpu_torch", "--name", n,
                     "--data-dir", os.path.join(d, n),
                     "--listen-peer-urls", f"http://127.0.0.1:{ports[i]}",
                     "--initial-advertise-peer-urls",
                     f"http://127.0.0.1:{ports[i]}",
                     "--listen-client-urls", clients[n],
                     "--advertise-client-urls", clients[n],
                     "--discovery", disc, "--heartbeat-interval", "100",
                     "--election-timeout", "1000"], mem_log)

            t1 = time.perf_counter()
            for i in range(3):
                start(i)

            def three():
                st, body = _http("GET", clients["m0"] + "/v2/members",
                                 timeout=5)
                ms = body["members"] if st == 200 else []
                return (len(ms) == 3 and all(m["clientURLs"] for m in ms)
                        and _member_leader(clients, names[:3]))

            _until(three, "three discovery members")
            boot_s = time.perf_counter() - t1
            st, body = _http("GET", f"{disc}?recursive=true")
            registered = [nd["value"] for nd in body["node"]["nodes"]
                          if not nd["key"].endswith("_config")]
            if len(registered) != 3:
                raise AssertionError(f"registry: {body}")
            start(3)                  # the cluster is full: a proxy
            proxy = clients["m3"]
            _until(lambda: _http("GET", proxy + "/v2/keys/",
                                 timeout=5)[0] == 200, "the fallback proxy")
            if not os.path.isdir(os.path.join(d, "m3", "proxy")) or \
                    os.path.exists(os.path.join(d, "m3", "member")):
                raise AssertionError("m3 did not fall back to a proxy")
            steps.done("discovery")
            lat = {}

            def proxy_put(i):
                t2 = time.perf_counter()
                st, body = _http("PUT", f"{proxy}/v2/keys/px/{i}",
                                 f"value=v{i}".encode(), FORM)
                if st not in (200, 201) or body["node"]["value"] != f"v{i}":
                    raise AssertionError(f"proxy PUT px/{i}: {st} {body}")
                lat[i] = time.perf_counter() - t2

            t1 = time.perf_counter()
            errs = _in_threads(proxy_put, list(range(proxy_writes)))
            proxy_s = time.perf_counter() - t1
            if errs or len(lat) != proxy_writes:
                raise AssertionError(f"proxy PUT failures: {errs[:5]}")

            def read_back(n):
                for i in range(proxy_writes):
                    _until(lambda: _member_value(clients[n], f"px/{i}")
                           == f"v{i}", f"px/{i} on {n}", deadline_s=60)

            errs = _in_threads(read_back, names[:3], n_threads=3)
            if errs:
                raise AssertionError(f"read-back failures: {errs}")
            got = {}

            def watch():
                got["w"] = _http("GET", proxy + "/v2/keys/pw?wait=true",
                                 timeout=60)

            th = threading.Thread(target=watch, daemon=True)
            th.start()
            time.sleep(0.5)
            st, _ = _http("PUT", proxy + "/v2/keys/pw", b"value=fired",
                          FORM)
            th.join(30)
            if th.is_alive() or got["w"][0] != 200 or \
                    got["w"][1]["node"]["value"] != "fired":
                raise AssertionError(f"watch through the proxy: {got}")
            apps_tools = _compute_apps() if on_card else []
            if len(apps_tools) != len(apps):
                raise AssertionError(f"a member or the proxy holds a "
                                     f"context on the card: {apps} -> "
                                     f"{apps_tools}")
            torch_maps = [n for n in names if _loads_torch(procs[n].pid)]
            if torch_maps:
                raise AssertionError(f"{torch_maps} mapped torch")
            rcs = {}
            for n in names:
                procs[n].send_signal(signal.SIGTERM)
            for n in names:
                rcs[n] = procs[n].wait(timeout=60)
            if rcs != dict.fromkeys(names, 0):
                raise AssertionError(f"member and proxy exit codes {rcs}")
            steps.done("proxy")
            ms = np.array(sorted(lat.values())) * 1e3
            log("tools_engine", t0, step="discovery_proxy", tenant=reg_t,
                members=3, boot_s=boot_s, registered=len(registered),
                proxy_writes=proxy_writes, proxy_write_s=proxy_s,
                proxy_acked_writes_per_s=proxy_writes / proxy_s,
                proxy_ack_p50_ms=float(np.percentile(ms, 50)),
                proxy_ack_p99_ms=float(np.percentile(ms, 99)),
                read_back_from=3, watch_fired=True,
                compute_apps_with_server=len(apps),
                compute_apps_with_members_and_proxy=len(apps_tools),
                rcs=rcs, step_s={k: round(v, 3) for k, v in steps.items()})

            # 2. etcdctl on three tenants, as processes, in parallel.
            steps = _Steps()
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            ctl_s = []

            def ctl_tenant(g):
                for args, rc, want in CTL_COMMANDS:
                    t2 = time.perf_counter()
                    res = subprocess.run(
                        [sys.executable, "-X", "importtime", "-m",
                         "etcd_tpu_torch.etcdctl.main", "--peers",
                         f"{url}/tenants/{g}", *args], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=120)
                    ctl_s.append(time.perf_counter() - t2)
                    out = res.stdout.strip()
                    said = want is None or (want in out.split()
                                            if args[0] == "ls"
                                            else out == want)
                    if res.returncode != rc or not said:
                        raise AssertionError(
                            f"etcdctl {args} on tenant {g}: rc "
                            f"{res.returncode}, {out!r}, "
                            f"{res.stderr[-300:]!r}")
                    if _imports_torch(res.stderr):
                        raise AssertionError(f"etcdctl {args} imported "
                                             "torch")

            errs = _in_threads(ctl_tenant, ctl_ts, n_threads=len(ctl_ts))
            if errs:
                raise AssertionError(f"etcdctl: {errs}")
            steps.done("etcdctl")
            log("tools_engine", t0, step="etcdctl", tenants=ctl_ts,
                commands=len(ctl_s),
                median_s_per_command=float(np.median(ctl_s)),
                max_s_per_command=max(ctl_s), imported_torch=False,
                step_s={k: round(v, 3) for k, v in steps.items()})

            # 3. The SDK, with the next checkpoint far enough ahead.
            steps = _Steps()
            every = EngineConfig.checkpoint_rounds

            def round_no():
                return _http("GET", url + "/engine/status")[1]["round"]

            r0 = round_no()
            if every - r0 % every < every // 5:
                _until(lambda: round_no() // every > r0 // every,
                       "the engine's next checkpoint", deadline_s=300)
                r0 = round_no()
            steps.done("checkpoint_room")

            def api(g):
                return KeysAPI(Client([f"{url}/tenants/{g}"], timeout=60))

            acked = {}                # (g, method, path) -> value
            lock = threading.Lock()
            lat = {}

            def sdk_put(g):
                t2 = time.perf_counter()
                r = api(g).set("/sdk", f"s{g}")
                if r.node.value != f"s{g}":
                    raise AssertionError(f"SDK set on {g}: {r.node}")
                lat[g] = time.perf_counter() - t2
                with lock:
                    acked[(g, "PUT", "/1/sdk")] = f"s{g}"

            t1 = time.perf_counter()
            errs = _in_threads(sdk_put, sdk_ts)
            write_s = time.perf_counter() - t1
            if errs or len(lat) != len(sdk_ts):
                raise AssertionError(f"SDK set failures: {errs[:5]}")
            steps.done("set")

            def sdk_get(g):
                if api(g).get("/sdk").node.value != f"s{g}":
                    raise AssertionError(f"SDK get on {g}")

            errs = _in_threads(sdk_get, sdk_ts)
            if errs:
                raise AssertionError(f"SDK get failures: {errs[:5]}")
            steps.done("get")
            g_q, g_cas, g_w, g_iso = sdk_ts[:4]
            k = api(g_q)
            r1 = k.create_in_order("/q", "one")
            r2 = k.create_in_order("/q", "two")
            nodes = k.get("/q", recursive=True, sorted=True).node.nodes
            if not r1.node.key < r2.node.key or \
                    [n.value for n in nodes] != ["one", "two"]:
                raise AssertionError(f"in-order create: {nodes}")
            acked[(g_q, "POST", "/1/q")] = None
            k = api(g_cas)
            k.set("/cas", "0")
            acked[(g_cas, "PUT", "/1/cas")] = "0"
            won, lost = [], []

            def race(i):
                try:
                    api(g_cas).set("/cas", f"r{i}", prev_value="0")
                    won.append(i)
                except KeysError as e:
                    if e.code != 101:
                        raise
                    lost.append(i)

            errs = _in_threads(race, list(range(cas_racers)),
                               n_threads=cas_racers)
            if errs or len(won) != 1 or len(lost) != cas_racers - 1 or \
                    k.get("/cas").node.value != f"r{won[0]}":
                raise AssertionError(f"CAS race: winners {won}, {errs[:3]}")
            k = api(g_w)
            start_r = k.get("/sdk")
            w = k.watcher("/sdk", after_index=start_r.node.modified_index)
            seen = {}
            th = threading.Thread(target=lambda: seen.update(
                ev=w.next(timeout=10)), daemon=True)
            th.start()
            time.sleep(0.3)
            k.set("/sdk", "watched")
            th.join(12)
            if th.is_alive() or seen.get("ev") is None or \
                    seen["ev"].node.value != "watched":
                raise AssertionError(f"watcher: {seen}")
            api(g_iso).set("/iso", "only-here")
            acked[(g_iso, "PUT", "/1/iso")] = "only-here"
            try:
                api(sdk_ts[4]).get("/iso")
                raise AssertionError("tenant isolation: /iso leaked")
            except KeysError as e:
                if e.code != 100:
                    raise
            steps.done("sdk_checks")
            ms = np.array(sorted(lat.values())) * 1e3
            log("tools_engine", t0, step="sdk", tenants=len(sdk_ts),
                write_s=write_s, acked_writes_per_s=len(sdk_ts) / write_s,
                ack_p50_ms=float(np.percentile(ms, 50)),
                ack_p99_ms=float(np.percentile(ms, 99)),
                in_order=[r1.node.key, r2.node.key], cas_racers=cas_racers,
                cas_winners=len(won), watch_fired=True,
                isolation_error=100, round_at_start=r0,
                step_s={k: round(v, 3) for k, v in steps.items()})

            # 4. SIGTERM, then dump-logs over the engine's WAL.
            steps = _Steps()
            procs["server"].send_signal(signal.SIGTERM)
            rc = procs["server"].wait(timeout=120)
            if rc != 0:
                raise AssertionError(f"server rc {rc} on SIGTERM")
            with open(srv_log) as f:
                stops = [json.loads(ln.split(STOP_LINE, 1)[1]) for ln in f
                         if STOP_LINE in ln]
            if len(stops) != 1 or on_card and not (
                    stops[0]["te5"] and stops[0]["generic"]):
                raise AssertionError(f"server stop line: {stops}")
            steps.done("sigterm")
            t1 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "etcd_tpu_torch.tools.dump_logs",
                 "--engine", os.path.join(data, "engine")], cwd=REPO,
                env=env, capture_output=True, text=True, timeout=600)
            dump_s = time.perf_counter() - t1
            if res.returncode != 0:
                raise AssertionError(f"dump_logs rc {res.returncode}: "
                                     f"{res.stderr[-2000:]}")
            head = res.stdout.split("\n", 1)[0]
            if head.startswith("Checkpoint: round="):
                ckpt = int(head.split("=", 1)[1].split()[0])
                if ckpt >= r0:
                    raise AssertionError(f"a checkpoint at round {ckpt} "
                                         f"covers the SDK's writes (from "
                                         f"round {r0})")
            dumped = _dumped_writes(res.stdout)
            missing = [w for w in acked if w not in dumped]
            if missing:
                raise AssertionError(f"acked writes not in the dump: "
                                     f"{missing[:5]}")
            entries = sum(len(list(filter(None, ln.split("\t")[4]
                                          .split("; "))))
                          for ln in res.stdout.splitlines()
                          if ln.split("\t")[0].isdigit())
            steps.done("dump")
            log("tools_engine", t0, step="dump_logs", rc=rc, dump_rc=0,
                dump_s=dump_s, checkpoint=head, entries=entries,
                requests_in_dump=len(dumped), acked_checked=len(acked),
                launches=sum(stops[0].values()),
                launches_by_variant=stops[0],
                step_s={k: round(v, 3) for k, v in steps.items()})
        except BaseException:
            for path in (srv_log, mem_log):
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        print(f.read()[-3000:].decode(errors="replace"),
                              file=sys.stderr)
            raise
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
    return sum(stops[0].values()), stops[0]


LATENCY_GROUPS = (12_500, 32_768, 100_000)


def phase_latency_hops(dev, groups=LATENCY_GROUPS):
    """`etcd_tpu_torch.tools.latency_hops` in process: at each G, P=5,
    W=16, E=4, hops=3, 40 warm-up rounds (every group led) and 80 timed
    rounds under full proposals (every group's commit advances): ms per
    round and commits/s. Returns the ring_resolve launches of the phase,
    in all and by instantiation."""
    import torch
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    from etcd_tpu_torch.tools.latency_hops import measure
    t0 = time.perf_counter()
    _launches_reset()  # this path starts here
    for g in groups:
        log("latency_hops", t0, **measure(g, device=dev))
    by = dict(ring_resolve.launches_by_variant)
    if torch.device(dev).type == "cuda" and not (by["te4"] and by["te5"]):
        raise AssertionError(f"latency_hops: kernels launched {by}")
    return ring_resolve.launches, by


def phase_soak_kernel(dev, schedules=5, meta_seed=0):
    """`etcd_tpu_torch.tools.soak kernel` in process: `schedules` random
    fault mixes (meta seed `meta_seed`) of `oracle.run_equivalence` on
    dev, the round with the CUDA ring_resolve equal to the scalar Raft
    after every round. Returns the ring_resolve launches of the phase."""
    import torch
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    from etcd_tpu_torch.tools.soak import soak_kernel
    t0 = time.perf_counter()
    _launches_reset()  # this path starts here
    out = soak_kernel(schedules, meta_seed=meta_seed, device=dev)
    by = dict(ring_resolve.launches_by_variant)
    if torch.device(dev).type == "cuda" and not ring_resolve.launches:
        raise AssertionError("soak_kernel: ring_resolve was not launched")
    log("soak_kernel", t0, passed=out["schedules"], starved=out["starved"],
        meta_seed=meta_seed, seconds=out["seconds"],
        schedules_per_s=out["schedules"] / out["seconds"],
        equal_to_scalar_raft=True,
        launches=ring_resolve.launches, launches_by_variant=by)
    return ring_resolve.launches, by


# The bench's widths on the card, its defaults (etcd_tpu_torch/bench.py):
# every one is checked in its result lines.
BENCH_WIDTHS = {"groups": G, "peers": P, "churn_peers": 7,
                "engine_groups": G, "latency_groups": 12_500,
                "qread_groups": 8_192, "expiry_groups": 4_096,
                "ttl_keys": 4_096 * 16, "watchers": 100_000,
                "conns": 10_000, "tenants": 8, "hub_watchers": 2_000}
# The bench's invocations: lanes run at once, the (BENCH_SCENARIO,
# BENCH_BUDGET_S, more environment) of a lane one after another. At its
# widths the ten scenarios take ~650 s one after another on an H100 host
# (host-bound rounds are a floor: qread ~185 s and engine ~115 s at ten
# a leg; shallow_clients ~135 s with 3 s legs; PERF.md), which with the
# phases before it would pass the script's time limit. Each lane opens
# with one of the three host-bound ones, each a few cores of the host
# and little of the card, so at most three invocations run at once (four
# overran); the kernel scenarios, which keep the card busy, follow
# qread (~150 s), latency follows shallow_clients (~185 s), and the
# engine runs alone in its lane. Every set starts with uniform (4 s),
# whose result is a line's headline; the others keep every key. zipf,
# lag and churn stay in one set, in order: they draw from one generator.
# Depth is cut: the host-bound legs to 3 rounds (BENCH_MIN_ROUNDS, 10 by
# default), shallow_clients' measured legs to 3 s (15). A child is
# killed 15 s past its budget. The engine at 100,000 groups runs past
# its share of the budget by its fixed rounds (boot, warm-up, drain, the
# paced phase's tail): 149-185 s here, 288 s on a slower host, where a
# 300 s budget ended it; shallow_clients' legs are fixed (125-154 s).
# Both budgets are 420 s: on a host loaded to 1.4-2x (PERF.md §6) both
# passed 365-375 s. The engine's larger share of it still ends before
# shallow_clients' lane; the others' take no time from a larger one.
BENCH_MIN_ROUNDS = 3
BENCH_LANES = ((("uniform,qread", 300, {}),
                ("uniform,watch_storm,expiry_wave,zipf,lag,churn", 120,
                 {})),
               (("uniform,engine", 420, {}),),
               (("uniform,shallow_clients", 420,
                 {"BENCH_SHALLOW_LEG_S": "3"}),
                ("uniform,latency", 80, {})))


def _bench_widths(metric, results) -> dict:
    """The widths the bench ran at, by BENCH_WIDTHS' keys."""
    groups, peers = (int(x) for x in metric.split("_")[4:7:2])
    sh, ex = results["shallow_clients"], results["expiry_wave"]
    return {"groups": groups, "peers": peers,
            "churn_peers": results["churn"]["peers"],
            "engine_groups": results["engine"]["groups"],
            "latency_groups": results["latency"]["groups"],
            "qread_groups": results["qread"]["groups"],
            "expiry_groups": ex["groups"], "ttl_keys": ex["ttl_keys"],
            "watchers": results["watch_storm"]["watchers"],
            "conns": sh["conns"], "tenants": sh["tenants"],
            "hub_watchers": sh["hub_fanout"]}


def phase_bench(dev, lanes=BENCH_LANES, env=None,
                widths=BENCH_WIDTHS) -> dict:
    """`python -m etcd_tpu_torch.bench` as a user runs it, at its
    defaults on the card: one invocation per (BENCH_SCENARIO,
    BENCH_BUDGET_S, more environment) of `lanes`, the lanes at once and
    a lane's invocations one after another (so their numbers are
    contended; PERF.md has each scenario's alone), together the ten
    scenarios. `env` adds
    variables, e.g. BENCH_PLATFORM=cpu and small sizes to rehearse on
    the CPU with widths=None. Fails unless each exits 0 with its
    scenarios in its last line (a scenario skipped for budget fails),
    measured at `widths`, on the device's platform, and unless the
    invariants hold: uniform, zipf, lag and churn commit; lag
    partitions G//20 groups; churn's liveness floor holds with every
    group led after the heal; engine's and latency's
    `etcd_engine_acked_requests_total` moved by the engine's own acked
    count; qread's read-only leg moved neither WAL bytes nor the log;
    expiry_wave expired every TTL key; shallow_clients lost no acked
    write. On the card both ring_resolve instantiations of the bench
    shape (TE=4, TE=5) must have launched. Returns ring_resolve's
    launches by scenario, summed over the invocations (shallow_clients':
    its engine process's)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from etcd_tpu_torch import bench
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    runs = [r for lane in lanes for r in lane]
    starts = [0]
    for lane in lanes:
        starts.append(starts[-1] + len(lane))
    procs, walls = [None] * len(runs), [None] * len(runs)
    with tempfile.TemporaryDirectory(prefix="smoke-bench-") as d:

        def run_lane(i):
            for k in range(starts[i], starts[i + 1]):
                scenarios, budget_s, more = runs[k]
                with open(os.path.join(d, f"{k}.out"), "w") as out, \
                        open(os.path.join(d, f"{k}.err"), "w") as err:
                    procs[k] = subprocess.Popen(
                        [sys.executable, "-m", "etcd_tpu_torch.bench"],
                        cwd=REPO, stdout=out, stderr=err,
                        env=dict(os.environ, BENCH_SCENARIO=scenarios,
                                 BENCH_BUDGET_S=str(budget_s),
                                 BENCH_MIN_ROUNDS=str(BENCH_MIN_ROUNDS),
                                 **more, **(env or {})))
                procs[k].wait(timeout=budget_s + 120)
                walls[k] = round(time.perf_counter() - t0, 1)

        try:
            with ThreadPoolExecutor(len(lanes)) as pool:
                for f in [pool.submit(run_lane, i)
                          for i in range(len(lanes))]:
                    f.result()
        finally:
            for p in procs:
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()
        outs, failed = [], []
        for k, p in enumerate(procs):
            with open(os.path.join(d, f"{k}.out")) as f:
                out = f.read()
            with open(os.path.join(d, f"{k}.err")) as f:
                err = f.read()
            if p.returncode != 0:
                failed.append(f"bench {runs[k][0]}: rc {p.returncode}; "
                              f"stderr tail:\n{err[-3000:]}")
                continue
            outs.append((json.loads([ln for ln in out.splitlines()
                                     if ln.startswith("{")][-1]), err))
        if failed:
            raise AssertionError("\n".join(failed))
    results, primaries, launches, seconds = {}, [], {}, {}
    for (line, err), (scenarios, _, _) in zip(outs, runs):
        got = dict(line["scenarios"])
        got[line["scenario"]] = dict(line, commits_per_sec=line["value"])
        lines = {d["scenario"]: d for d in
                 (json.loads(ln.split(bench.SCENARIO_LINE, 1)[1])
                  for ln in err.splitlines()
                  if ln.startswith(bench.SCENARIO_LINE))}
        want = (bench.ORDER if scenarios == "all"
                else scenarios.split(","))
        missing = [sc for sc in want if sc not in got or sc not in lines
                   or "skipped" in got[sc]]
        if missing:
            raise AssertionError(f"bench {scenarios}: scenarios missing "
                                 f"or skipped: {missing}")
        if line["platform"] != ("gpu" if on_card else "cpu"):
            raise AssertionError(f"bench: platform {line['platform']}")
        primaries.append(got.pop(line["scenario"]))
        for sc, ln in lines.items():
            if sc in got:
                got[sc]["engine_acked"] = ln.get("engine_acked")
            by = launches.setdefault(sc, dict.fromkeys(
                ("generic", "te4", "te5"), 0))
            for v, n in ln["launches_by_variant"].items():
                by[v] += n
            seconds.setdefault(sc, []).append(ln["seconds"])
        results.update(got)
    results.setdefault("uniform", primaries[0])
    if set(results) != set(bench.ORDER):
        raise AssertionError(f"bench: scenarios {sorted(results)}")
    got_widths = _bench_widths(line["metric"], results)
    if widths is not None and got_widths != widths:
        raise AssertionError(f"bench: widths {got_widths} != {widths}")
    G_b = got_widths["groups"]
    bad = [sc for sc in ("zipf", "lag", "churn")
           if not results[sc]["commits_per_sec"] > 0]
    bad += ["uniform" for u in primaries if not u["value"] > 0]
    ch = results["churn"]
    if results["lag"]["lagged_groups"] != G_b // 20:
        bad.append("lag.lagged_groups")
    if not (ch["liveness_floor_ok"] is True
            and ch["groups_with_leader_after_heal"] == G_b):
        bad.append("churn.liveness")
    for sc in ("engine", "latency"):
        moved = results[sc]["metrics_delta"].get(
            "etcd_engine_acked_requests_total")
        if moved != results[sc]["engine_acked"]:
            bad.append(f"{sc}.acked {moved} != "
                       f"{results[sc]['engine_acked']}")
    q = results["qread"]
    if q["qread_wal_bytes_delta"] != 0 or q["qread_log_delta"] != 0:
        bad.append("qread.zero_append")
    if results["expiry_wave"]["unswept_tenants"] != 0:
        bad.append("expiry_wave.unswept")
    if results["shallow_clients"]["lost_acked_writes"] != 0:
        bad.append("shallow_clients.lost_acked_writes")
    if bad:
        raise AssertionError(f"bench: invariants broken: {bad}")
    total = {k: sum(v[k] for v in launches.values())
             for k in ("generic", "te4", "te5")}
    if on_card and not (total["te4"] and total["te5"]):
        raise AssertionError(f"bench: the TE=4 and TE=5 kernels were not "
                             f"both launched: {launches}")
    log("bench", t0, lanes=[[list(r) for r in lane] for lane in lanes],
        walls_s=walls,
        device=line["device"],
        power_limit_w=line["power_limit_w"], metric=line["metric"],
        uniform_values=[u["value"] for u in primaries],
        widths=got_widths, seconds=seconds,
        launches_by_scenario=launches,
        scenarios={sc: {k: v for k, v in r.items()
                        if k not in ("metrics_delta", "scenarios")}
                   for sc, r in results.items()})
    return launches


def ptxas_by_kernel(lines) -> dict:
    """ptxas's resource line for each compiled entry function."""
    out, name = {}, None
    for line in lines:
        if line.startswith("Compiling entry function"):
            name = line.split("'")[1]
            for short in ("ring_resolve_tilesILi4E", "ring_resolve_tilesILi5E",
                          "ring_resolve_tilesILi0E", "ring_resolve_empty",
                          "qh_pred", "qh_msgs", "qh_commit", "qh_route"):
                if short in name:
                    name = short.replace("ILi", "<").replace("E", ">")
        elif line.startswith("Used") and name:
            out[name] = line
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_c = time.perf_counter()
    from etcd_tpu_torch import native_build   # builds the C at first use
    c_build_s = time.perf_counter() - t_c
    from concurrent.futures import ThreadPoolExecutor
    from etcd_tpu_torch.ops import cuda_build
    from etcd_tpu_torch.ops.ring_resolve import stage_shape
    from etcd_tpu_torch.server import engine  # noqa: F401 — fail early
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    flags = native_flags()
    log("build_c", t0, import_s=c_build_s, flags=flags,
        libraries=[native_build.installed_path(n).name
                   for n in native_build.NAMES
                   if native_build.installed_path(n).exists()])
    if not all(flags.values()):
        raise AssertionError(f"the C host code did not build on this "
                             f"machine (it needs cc and Python.h): {flags}")
    with ThreadPoolExecutor() as pool:   # one nvcc per build, all at once
        builds = [pool.submit(cuda_build.build, k) for k in CUDA_SOURCES]
        reports = [pool.submit(cuda_build.ptxas_report, k)
                   for k in CUDA_SOURCES]
        ptxas = [line for f in reports for line in f.result()]
        for f in builds:
            f.result()
    log("build", t0, kernels=list(CUDA_SOURCES), ptxas=ptxas_by_kernel(ptxas),
        smem_by_variant={v: stage_shape(te)[2] for v, te in
                         (("te4", 4), ("te5", 5), ("generic", P * E))})

    entry = phase_kernel(dev)
    quiet_entry = phase_quiet_hop(dev)
    # The depths cut to hold the whole script under the time limit with
    # phase bench (PERF.md §4; no width is cut): the C-off runs at 300
    # tenants, latency_hops at two sizes, 3 soak schedules, 20 rounds of
    # phase round, mesh_round 6 rounds, the suite's compact leg 20
    # rounds, 300 tenants with 30 quorum GETs on every path but the
    # engine's main one (500 and 50 on the HTTP front's), one of
    # frames_soak's two stop-and-restart cycles and the bench's
    # host-bound legs at 3 rounds.
    for name in ROUNDS:
        phase_round(dev, name, rounds=20)
    phase_small_card_vs_cpu(dev)
    oracle_launches, oracle_by_variant = phase_raft_oracle(dev)
    launches, by_variant, quiet = phase_engine(dev)
    if launches <= 0:
        raise AssertionError("ring_resolve was not launched on the main path")
    if not (by_variant["te4"] and by_variant["te5"]):
        raise AssertionError(f"the TE=4 and TE=5 kernels were not both "
                             f"launched on the main path: {by_variant}")
    _require_quiet_hop("the main path", quiet)
    off_launches, off_by_variant, off_quiet = phase_engine(
        dev, name="engine_native_off", native=False, tenants=300,
        quorum_gets=30)
    _require_quiet_hop("the main path, C host code off", off_quiet)
    suite = phase_suite_card(dev, race=dict(first_writes=300),
                             compact=dict(rounds=20), obs=dict(tenants=300))
    http_launches, http_by_variant, http_restart, http_quiet = \
        phase_http_front(dev, tenants=500, quorum_gets=50)
    _require_quiet_hop("the HTTP front's path", http_quiet)
    if not (http_by_variant["te5"] and http_by_variant["generic"]):
        raise AssertionError(f"the TE=5 and generic kernels were not both "
                             f"launched on the HTTP front's path: "
                             f"{http_by_variant}")
    mh_launches, mh_by_variant, mh_lines = phase_multihost_frames(
        dev, tenants=200)
    mc_launches, mc_by_variant, mc_lines = phase_multihost_collective(
        dev, tenants=300, quorum_gets=30)
    # frames_soak (~200 s in a process of its own, its engines a core or
    # two) runs beside the phases from mesh_round on, which hold the card
    # and the host lightly, and beside the C-off HTTP front, pool_serve
    # and tsan after them (without these the leg ran ~65 s past the
    # others): the script stays inside its time limit. Their numbers are
    # taken beside it (contended). Its process keeps its context on the
    # card until they end (`hold`), so that the count of compute apps
    # they check is not changed by its exit.
    soak_hold = threading.Event()
    with ThreadPoolExecutor(1) as beside:
        soak_f = beside.submit(phase_frames_soak_process, dev,
                               hold=soak_hold)
        try:
            mesh_by_layout = phase_mesh_round(dev, rounds=6)
            from etcd_tpu_torch.parallel.mesh import make_mesh
            em_launches, em_by_variant, em_quiet = phase_engine(
                dev, mesh=make_mesh([dev] * 4, peers_axis=1),
                name="engine_mesh", tenants=300, quorum_gets=30)
            if not (em_by_variant["te4"] and em_by_variant["te5"]):
                raise AssertionError(f"the TE=4 and TE=5 kernels were not "
                                     f"both launched on the mesh engine's "
                                     f"path: {em_by_variant}")
            phase_member_cluster(dev, writes=300, quorum_gets=30)
            tools_launches, tools_by_variant = phase_tools_engine(
                dev, tenants=300, proxy_writes=100)
            hops_launches, hops_by_variant = phase_latency_hops(
                dev, groups=(12_500, G))
            soak_launches, soak_by_variant = phase_soak_kernel(
                dev, schedules=3)
            (http_off_launches, http_off_by_variant, http_off_restart,
             http_off_quiet) = phase_http_front(dev, native=False,
                                                tenants=300, quorum_gets=30)
            pool_stops = phase_pool_serve(dev, tenants=300, quorum_gets=30)
            phase_tsan()
        finally:
            soak_hold.set()
        soak_f_launches, soak_f_by_variant = soak_f.result()
    _require_quiet_hop("the HTTP front's path, C host code off",
                       http_off_quiet)
    if not (soak_f_by_variant["te5"] and soak_f_by_variant["generic"]):
        raise AssertionError(f"the TE=5 and generic kernels were not both "
                             f"launched on frames_soak: {soak_f_by_variant}")
    # The kernel scenarios' measured rounds cut to 100 (300): depth.
    bench_launches = phase_bench(dev, env={"BENCH_ROUNDS": "100"})
    entry["launches"] = launches
    entry["launches_by_variant"] = by_variant
    entry["launches_by_path"] = {
        "engine": {"launches": launches, "by_variant": by_variant,
                   "quiet_hop_by_pass": quiet},
        "engine_native_off": {"launches": off_launches,
                              "by_variant": off_by_variant,
                              "quiet_hop_by_pass": off_quiet},
        "http_front": {"launches": http_launches,
                       "by_variant": http_by_variant,
                       "quiet_hop_by_pass": http_quiet},
        "http_front_native_off": {"launches": http_off_launches,
                                  "by_variant": http_off_by_variant,
                                  "quiet_hop_by_pass": http_off_quiet},
        "http_front_sigkill_restart": {
            "launches": sum(http_restart.values()),
            "by_variant": http_restart},
        "http_front_native_off_sigkill_restart": {
            "launches": sum(http_off_restart.values()),
            "by_variant": http_off_restart},
        **{f"suite_card_{leg}": {"launches": n, "by_variant": by}
           for leg, (n, by) in suite.items()},
        "pool_serve": {"launches": sum(sum(s.values()) for s in pool_stops),
                       "by_shard": pool_stops},
        "multihost_frames": {
            "launches": mh_launches, "by_variant": mh_by_variant,
            "by_rank": [ln["launches_by_variant"] for ln in mh_lines]},
        "frames_soak": {"launches": soak_f_launches,
                        "by_variant": soak_f_by_variant},
        "mesh_round": {
            "launches": sum(sum(v.values()) for v in mesh_by_layout.values()),
            "by_layout": mesh_by_layout},
        "engine_mesh": {"launches": em_launches,
                        "by_variant": em_by_variant,
                        "quiet_hop_by_pass": em_quiet},
        "raft_oracle": {"launches": oracle_launches,
                        "by_variant": oracle_by_variant},
        "multihost_collective": {
            "launches": mc_launches, "by_variant": mc_by_variant,
            "by_rank": [ln["launches_by_variant"] for ln in mc_lines]},
        "tools_engine": {"launches": tools_launches,
                         "by_variant": tools_by_variant},
        "latency_hops": {"launches": hops_launches,
                         "by_variant": hops_by_variant},
        "soak_kernel": {"launches": soak_launches,
                        "by_variant": soak_by_variant},
        "bench": {"launches": sum(sum(v.values())
                                  for v in bench_launches.values()),
                  "by_scenario": bench_launches}}
    entry["equal_to_plain"] = True
    # The fused quiet hop's launches on the main path, and by path where
    # they are counted (in process; mesh cells take the PyTorch hop).
    quiet_entry["launches"] = sum(quiet.values())
    quiet_entry["launches_by_path"] = {
        "quiet_hop_phase": quiet_entry.pop("launches_by_pass"),
        **{path: entry["launches_by_path"][path]["quiet_hop_by_pass"]
           for path in ("engine", "engine_native_off", "http_front",
                        "http_front_native_off", "engine_mesh")}}
    quiet_entry["equal_to_plain"] = True
    print(json.dumps({"kernels": [entry, quiet_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
