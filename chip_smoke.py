#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (etcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path at 100,000 groups × 5 peers (W=16, E=4,
heartbeat_tick=3, hops=3, fsync on) on the card, and fails (nonzero
exit) if any phase fails:

1. device: the card's name and power limit; builds the CUDA kernels
   (one nvcc per build, all started together) and prints ptxas's
   registers and shared memory for each kernel instantiation.
2. kernel vs plain: `ring_resolve` against `ring_resolve_ref` on the card,
   exactly equal, through every instantiation (TE=4, TE=5, generic) at
   the round's call shapes (idx (G, P, 5), (G, P, 4) and, on the CLI's
   path, (G, P, 8)), a ragged row count, trailing shapes
   (P, E) and (), W=8, a misaligned idx, and the blocks of the device
   mesh and of a collective rank (idx (25000, 5, 5), (25000, 5, 4),
   (100000, 1, 5), (100000, 1, 4), (100000, 1, 8)). At the call and
   block shapes,
   over inputs that rotate through 8 copies (so L2 is cold, as in the
   round): CUDA-event times of the kernel, the plain version and one
   torch.gather beside the bound; the kernel's device time replayed from
   a CUDA graph, over the copies and over one input (warm L2); the
   launch floor (the wrapper's whole path with an empty kernel,
   `ring_resolve.launch_floor`) in both loops; host µs per call. The A/B
   of two commits' kernels is `etcd_tpu_torch/ops/ring_resolve_timing.py`.
3. round: 40 full-width `step_routed_compact` rounds with the kernel and
   with `resolve=ring_resolve_ref`, every output equal after every round,
   and their twin on the multi-host engine's slots round (40 rounds of
   `step_routed_slots_auto`, hops=1, max_ents 8: TE=5 at idx (G, P, P),
   generic at (G, P, 8)); 30 small rounds on the card and on the CPU,
   bit-equal.
4. engine: `MultiEngine` boots, elects, acks 1,000 PUTs from side
   threads, serves their GETs and 100 quorum GETs, and after a restart
   on the same data dir reads every acked write back. The kernels'
   launch counts are read across this phase (the main path).
5. http_front: the same G, P and window through the CLI's engine mode
   at its other defaults (max_ents 8, so the conflict scan takes the
   generic instantiation at idx (100000, 5, 8)), in three legs: in
   process over real sockets, launch counts read across it (PUT, GET,
   quorum GET, /batch); `python -m etcd_tpu_torch` with `python -m
   etcd_tpu_torch.server.ingress` in front (PUTs and a CAS race through
   the ingress, the server among the card's compute apps, every
   upstream frame answered); SIGKILL of the server, the same command
   again, every acked write read back as soon as it serves (local GETs
   need no re-elected leader), rc 0 on SIGTERM for both. One
   JSON line per leg: acked writes/s, ack p50/p99, rounds/s, seconds
   per step.
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
7. mesh_round: the bench shape's round (hops=3, E=4) for 40 rounds with
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
   SIGKILL of one rank and the supervisor's whole-job restart (detect,
   restart, total seconds), every acked write read back, SIGTERM and
   each rank's exit line.
10. one JSON line describing every kernel, then the last line
   {"ok": true, "device": {...}}.

Needs a CUDA device; without one it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import select
import signal
import socket
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
SEED = 1234


def log(phase: str, t0: float, **kv) -> None:
    print(json.dumps({"phase": phase, "s": round(time.perf_counter() - t0, 3),
                      **kv}), flush=True)


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


def phase_kernel(dev):
    """Kernel vs plain on the card: every instantiation exactly equal to
    `ring_resolve_ref` (both main-path shapes, a ragged row count, (P, E),
    (), W=8, a misaligned idx); at both main-path shapes the kernel's,
    the plain version's and torch.gather's times beside the bound, the
    launch floor and host µs per call. Returns the kernel entry of the
    report (times at the send-assembly shape T=(P,))."""
    import torch
    from etcd_tpu_torch.ops import ring_resolve as rr
    from etcd_tpu_torch.ops.ring_resolve_timing import (
        cuda_ms, graph_ms, host_us, resolve_inputs, rotating)
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED)
    resolve, ref = rr.ring_resolve, rr.ring_resolve_ref
    counts0 = dict(resolve.launches_by_variant)
    max_err = 0
    # (label, trailing idx dims, groups, W, peer columns): the engine's
    # shapes, edge cases, then the blocks of the device mesh (a groups
    # cell of 4 x 1, a peers cell of 1 x 5) and of a collective rank.
    cases = (("send_assembly", (P,), G, W, P),
             ("conflict_scan", (E,), G, W, P),
             ("cli_conflict_scan", (CLI_E,), G, W, P),
             ("ragged_rows", (P,), 99_999, W, P), ("PxE", (P, E), G, W, P),
             ("empty_trailing", (), G, W, P), ("W8", (P,), G, 8, P),
             ("misaligned_idx", (E,), G, W, P),
             ("mesh_groups_send", (P,), G // 4, W, P),
             ("mesh_groups_conflict", (E,), G // 4, W, P),
             ("mesh_peers_send", (P,), G, W, 1),
             ("mesh_peers_conflict", (E,), G, W, 1),
             ("collective_conflict", (CLI_E,), G, W, 1))
    inputs = {}
    for label, trailing, groups, w, peers in cases:
        ring, idx, last = (torch.from_numpy(
            np.ascontiguousarray(a[:, :peers])).to(dev) for a in
            resolve_inputs(rng, trailing, groups, w))
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
    log("kernel_equal", t0, cases=[c[0] for c in cases], equal=True,
        max_abs_err=max_err, launches_by_variant=by_variant)

    entry = None
    for label in ("send_assembly", "conflict_scan", "cli_conflict_scan",
                  "mesh_groups_send", "mesh_groups_conflict",
                  "mesh_peers_send", "mesh_peers_conflict",
                  "collective_conflict"):
        args = inputs[label]
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


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _states_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_round(dev, groups=G, rounds=40):
    """Full-width rounds with the kernel and with the plain resolve, in
    lockstep, every output equal after every round."""
    import torch
    from etcd_tpu_torch.ops import kernel
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve, ring_resolve_ref
    from etcd_tpu_torch.ops.state import KernelConfig, LEADER, init_state
    t0 = time.perf_counter()
    cfg = KernelConfig(groups=groups, peers=P, window=W, max_ents=E,
                       heartbeat_tick=3)
    st_k = init_state(cfg, stagger=True, device=dev)
    st_p = init_state(cfg, stagger=True, device=dev)
    ib_k = torch.zeros((groups, P, P, cfg.fields), dtype=torch.int32,
                       device=dev)
    ib_p = ib_k.clone()
    launches0 = ring_resolve.launches
    t_kernel = 0.0
    for r in range(rounds):
        lead = (st_k.state == LEADER) & st_k.peer_mask
        has = lead.any(dim=1)
        pc = torch.where(has, E, 0).to(torch.int32)
        ps = kernel._first_true(lead, dim=1)
        _sync(dev)
        t1 = time.perf_counter()
        st_k, ib_k, fl_k, nh_k = kernel.step_routed_compact(
            cfg, st_k, ib_k, pc, ps, True, None, 3)
        _sync(dev)
        t_kernel += time.perf_counter() - t1
        st_p, ib_p, fl_p, nh_p = kernel.step_routed_compact(
            cfg, st_p, ib_p, pc, ps, True, None, 3, resolve=ring_resolve_ref)
        if not (_states_equal(st_k, st_p) and torch.equal(ib_k, ib_p)
                and torch.equal(fl_k, fl_p) and torch.equal(nh_k, nh_p)):
            raise AssertionError(f"kernel round != plain round at {r}")
    led = bool(((st_k.state == LEADER) & st_k.peer_mask).any(dim=1).all())
    commits = int(st_k.commit.amax(dim=1).sum())
    if not led or commits <= 0:
        raise AssertionError(f"round: led={led} commits={commits}")
    log("round", t0, groups=groups, rounds=rounds, equal_to_plain=True,
        ms_per_round=t_kernel / rounds * 1e3,
        committed_entries_per_s=commits / t_kernel,
        launches=ring_resolve.launches - launches0)
    if torch.device(dev).type == "cuda":
        round_profile(cfg, st_k, ib_k, pc, ps)
    round_slots(dev, groups, rounds)


def round_slots(dev, groups=G, rounds=40):
    """The multi-host engine's slots round (`step_routed_slots_auto`,
    hops=1, per-slot counts at the leader slots) at the frames plane's
    shape (max_ents 8, so the conflict scan takes the generic
    instantiation at idx (G, P, 8) and send assembly TE=5 at (G, P, P)),
    with the kernel and with the plain resolve in lockstep, every output
    equal after every round."""
    import torch
    from etcd_tpu_torch.ops import kernel
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve, ring_resolve_ref
    from etcd_tpu_torch.ops.state import KernelConfig, LEADER, init_state
    t0 = time.perf_counter()
    cfg = KernelConfig(groups=groups, peers=P, window=W, max_ents=CLI_E,
                       heartbeat_tick=3)
    st_k = init_state(cfg, stagger=True, device=dev)
    st_p = init_state(cfg, stagger=True, device=dev)
    ib_k = torch.zeros((groups, P, P, cfg.fields), dtype=torch.int32,
                       device=dev)
    ib_p = ib_k.clone()
    by0 = dict(ring_resolve.launches_by_variant)
    t_kernel = 0.0
    for r in range(rounds):
        lead = (st_k.state == LEADER) & st_k.peer_mask
        cnt = torch.where(lead, CLI_E, 0).to(torch.int32)
        _sync(dev)
        t1 = time.perf_counter()
        st_k, ib_k = kernel.step_routed_slots_auto(cfg, st_k, ib_k, cnt,
                                                   True)
        _sync(dev)
        t_kernel += time.perf_counter() - t1
        st_p, ib_p = kernel.step_routed_slots_auto(
            cfg, st_p, ib_p, cnt, True, resolve=ring_resolve_ref)
        if not (_states_equal(st_k, st_p) and torch.equal(ib_k, ib_p)):
            raise AssertionError(f"kernel slots round != plain at {r}")
    led = bool(((st_k.state == LEADER) & st_k.peer_mask).any(dim=1).all())
    commits = int(st_k.commit.amax(dim=1).sum())
    if not led or commits <= 0:
        raise AssertionError(f"round_slots: led={led} commits={commits}")
    by = {k: ring_resolve.launches_by_variant[k] - by0[k] for k in by0}
    if torch.device(dev).type == "cuda" and not (by["te5"]
                                                 and by["generic"]):
        raise AssertionError(f"round_slots: kernels launched {by}")
    log("round_slots", t0, groups=groups, rounds=rounds, hops=1,
        max_ents=CLI_E, equal_to_plain=True,
        ms_per_round=t_kernel / rounds * 1e3,
        committed_entries_per_s=commits / t_kernel,
        launches=sum(by.values()), launches_by_variant=by)


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
    ring_resolve.launches = 0           # this path starts here
    for k in ring_resolve.launches_by_variant:
        ring_resolve.launches_by_variant[k] = 0
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
                 name="engine"):
    """The serving path through MultiEngine's public entry points, on one
    device or (`mesh`) sharded over a device mesh. Returns the
    ring_resolve launches counted across it, in all and by
    instantiation."""
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from etcd_tpu_torch.server.request import Request
    t0 = time.perf_counter()
    cfg = dict(groups=groups, peers=P, window=W, max_ents=E,
               heartbeat_tick=3, fsync=True, stagger=True, hops=3,
               device=str(dev), mesh=mesh)
    gs = [i * groups // tenants for i in range(tenants)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as d:
        ring_resolve.launches = 0       # the main path starts here
        for k in ring_resolve.launches_by_variant:
            ring_resolve.launches_by_variant[k] = 0
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
        ms = np.array(sorted(lat.values())) * 1e3
        log(f"{name}_serve", t0, acked=len(lat), write_s=t_w,
            acked_writes_per_s=len(lat) / t_w, rounds=rounds_w,
            rounds_per_s=rounds_w / t_w, ack_p50_ms=float(np.percentile(ms, 50)),
            ack_p99_ms=float(np.percentile(ms, 99)), quorum_gets=quorum_gets,
            quorum_get_s=t_q, launches=launches,
            launches_by_variant=by_variant,
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
    return launches, by_variant


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
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _free_ports(n: int) -> list:
    """n distinct free ports (all held open until every one is bound)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


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
    """PUT /tenants/{g}/v2/keys/smoke for every g from 100 threads;
    {g: seconds to its ack}."""
    lat = {}

    def put(g):
        t1 = time.perf_counter()
        st, body = _http("PUT", f"{base}/tenants/{g}/v2/keys/smoke",
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


def _leg(t0, leg, lat, write_s, rounds, step_s, **kv):
    ms = np.array(sorted(lat.values())) * 1e3
    log("http_front", t0, leg=leg, acked=len(lat), write_s=write_s,
        acked_writes_per_s=len(lat) / write_s,
        ack_p50_ms=float(np.percentile(ms, 50)),
        ack_p99_ms=float(np.percentile(ms, 99)), rounds=rounds,
        rounds_per_s=rounds / write_s,
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


def _spawn(args, log_path, stdout=subprocess.DEVNULL, env=None):
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(env or {})
    return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO,
                            env=full, stdout=stdout,
                            stderr=open(log_path, "ab"), text=True)


def _ready_line(proc, deadline_s=120.0) -> dict:
    """The ingress's one JSON line on its standard output."""
    ready, _, _ = select.select([proc.stdout], [], [], deadline_s)
    if not ready:
        raise AssertionError("the ingress printed no ready line")
    line = proc.stdout.readline()
    if not line:
        raise AssertionError(f"the ingress exited rc={proc.wait(10)}")
    return json.loads(line)


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


def phase_http_front(dev, groups=G, tenants=1000, quorum_gets=100,
                     device_flags=()):
    """The tenant HTTP front and the ingress as users run them, at the
    CLI's defaults but for G, P and the window (fsync on, max_ents 8):

    1. in process, counted: EngineServer(parse_args(flags)), PUT, GET,
       quorum GET and /batch over real sockets; returns the ring_resolve
       launches counted across this leg, in all and by instantiation;
    2. `python -m etcd_tpu_torch` and `python -m
       etcd_tpu_torch.server.ingress` as processes; writes and a CAS
       race through the ingress; every batchframe sent was answered;
    3. SIGKILL of the server, the same command again, every write acked
       in 2 read back; SIGTERM ends both processes with rc 0."""
    import torch
    from etcd_tpu_torch.etcdmain import parse_args
    from etcd_tpu_torch.etcdmain.etcd import EngineServer
    from etcd_tpu_torch.ops.ring_resolve import ring_resolve
    t0 = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    gs = [i * groups // tenants for i in range(tenants)]
    procs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke-http-") as d:
        def flags(name, port):
            return ["--engine-groups", str(groups), "--engine-peers", str(P),
                    "--engine-window", str(W),
                    "--data-dir", os.path.join(d, name),
                    "--listen-client-urls", f"http://127.0.0.1:{port}",
                    *device_flags]

        # Leg 1: in process, the kernels' launches counted.
        steps = _Steps()
        ring_resolve.launches = 0       # the main path starts here
        for k in ring_resolve.launches_by_variant:
            ring_resolve.launches_by_variant[k] = 0
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
        finally:
            srv.stop()
        if srv.engine.failed is not None:
            raise srv.engine.failed
        launches = ring_resolve.launches   # the main path ends here
        by_variant = dict(ring_resolve.launches_by_variant)
        steps.done("stop")
        _leg(t0, "in_process", lat, write_s, rounds, steps,
             groups_with_leader=status["groups_with_leader"],
             quorum_gets=quorum_gets, batch_statuses=[201, 412],
             launches=launches, launches_by_variant=by_variant)

        # Leg 2: the CLI and the ingress, as processes.
        steps = _Steps()
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        cmd = ["etcd_tpu_torch", *flags("cli", port)]
        srv_log = os.path.join(d, "server.log")
        try:
            apps0 = _compute_apps() if on_card else []
            server = _spawn(cmd, srv_log)
            procs.append(server)
            status = _wait_status(base, groups, server)
            steps.done("boot")
            apps = _compute_apps() if on_card else []
            with open(srv_log, "rb") as f:
                said_cuda = b" peers on cuda:" in f.read()
            if on_card and (len(apps) != len(apps0) + 1 or not said_cuda):
                raise AssertionError(f"the server is not on the card: "
                                     f"{apps0} -> {apps}, log says cuda: "
                                     f"{said_cuda}")
            ing = _spawn(["etcd_tpu_torch.server.ingress", "--upstream",
                          base], os.path.join(d, "ingress.log"),
                         stdout=subprocess.PIPE)
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
            native = _scrape(ing_base, "etcd_ingress_native_enabled")
            _leg(t0, "cli_ingress", lat, write_s, rounds, steps,
                 groups_with_leader=status["groups_with_leader"],
                 compute_apps_before_server=apps0,
                 compute_apps_with_server=apps,
                 cas_outcomes=outcomes, upstream_frames_sent=sent,
                 upstream_frames_recv=recv,
                 ingress_native_enabled=native.get("", None))

            # Leg 3: SIGKILL the server, run the same command again. The
            # acked writes are read back as soon as it serves: a local
            # GET needs the replayed store, not a re-elected leader.
            steps = _Steps()
            server.send_signal(signal.SIGKILL)
            server.wait(timeout=60)
            server = _spawn(cmd, srv_log)
            procs.append(server)
            _wait_status(base, proc=server)
            steps.done("restart")
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
            log("http_front", t0, leg="sigkill_restart", read_back=len(want),
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
    return launches, by_variant


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
    http_ports = _free_ports(hosts)
    frame_ports = _free_ports(hosts)
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
            # once a tenth of them have acked.
            victim_gs = {g for g in gs if _http(
                "GET", f"{bases[0]}/tenants/{g}/status")[1]["lead"]
                == victim}
            survivors = [r for r in range(hosts) if r != victim]
            first_ack = {}
            killed = threading.Event()
            t_kill = []
            reelected = {}     # written group the victim led -> seconds

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

            def put_through(g):
                r = survivors[g % len(survivors)]
                deadline = time.monotonic() + 180
                while True:
                    try:
                        st, body = _http(
                            "PUT", f"{bases[r]}/tenants/{g}/v2/keys/killed",
                            f"value=k{g}".encode(), FORM, timeout=5)
                        if st in (200, 201):
                            first_ack[g] = time.perf_counter()
                            acked[(g, "killed")] = (f"k{g}", r)
                            return
                    except OSError:
                        pass
                    if time.monotonic() > deadline:
                        raise AssertionError(f"g={g} never acked at {r}")
                    time.sleep(0.05)

            def kill():
                while len(first_ack) < len(gs) // 10:
                    time.sleep(0.01)
                procs[victim].send_signal(signal.SIGKILL)
                t_kill.append(time.perf_counter())
                watcher.start()
                procs[victim].wait(timeout=60)
                killed.set()

            killer = threading.Thread(target=kill, daemon=True)
            watcher = threading.Thread(target=watch, daemon=True)
            killer.start()
            errs = _in_threads(put_through, gs)
            if errs or not killed.wait(60):
                raise AssertionError(f"writes through the kill: {errs[:5]}")
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
                attempt_timeout_s=5,
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
                               hosts=NHOSTS, device_env=None, backend="gloo"):
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
    4. SIGKILL of one rank: the supervisor's detect, restart and total
       seconds (whole-job restart, a new process group, each rank
       replaying its own WAL);
    5. every acked write read back from the rank that acked it;
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

            # 4. SIGKILL of one rank; the supervisor restarts the job.
            t_kill = time.perf_counter()
            os.kill(pids[victim], signal.SIGKILL)
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
            for b in bases:
                _wait_status(b, groups, deadline_s=600)
            led_s = time.perf_counter() - t_kill
            if sup.wait(timeout=60) != 0:
                raise AssertionError(f"supervisor rc={sup.returncode}")
            log("multihost_collective", t0, step="sigkill", victim=victim,
                detect_s=detect_s, cause=rec["cause"],
                kill_job_s=rec["detect_to_killed_s"],
                restart_s=rec["restart_s"], total_s=rec["total_s"],
                every_group_led_s=led_s, generation=st["generation"])

            # 5. every acked write from the rank that acked it.
            def get(item):
                g, (val, r) = item
                st_, body = _http("GET", f"{bases[r]}/tenants/{g}/v2/keys/"
                                  f"smoke")
                if st_ != 200 or body["node"]["value"] != val:
                    raise AssertionError(f"GET g={g} at {r}: {st_} {body}")

            t1 = time.perf_counter()
            errs = _in_threads(get, list(acked.items()))
            if errs:
                raise AssertionError(f"acked writes lost: {errs[:5]}")
            log("multihost_collective", t0, step="read_back",
                read_back=len(acked), seconds=time.perf_counter() - t1)

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


def ptxas_by_kernel(lines) -> dict:
    """ptxas's resource line for each compiled entry function."""
    out, name = {}, None
    for line in lines:
        if line.startswith("Compiling entry function"):
            name = line.split("'")[1]
            for short in ("ring_resolve_tilesILi4E", "ring_resolve_tilesILi5E",
                          "ring_resolve_tilesILi0E", "ring_resolve_empty"):
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
    with ThreadPoolExecutor() as pool:   # one nvcc per build, all at once
        build = pool.submit(cuda_build.build, "ring_resolve")
        ptxas = pool.submit(cuda_build.ptxas_report, "ring_resolve").result()
        build.result()
    log("build", t0, kernels=["ring_resolve"], ptxas=ptxas_by_kernel(ptxas),
        smem_by_variant={v: stage_shape(te)[2] for v, te in
                         (("te4", 4), ("te5", 5), ("generic", P * E))})

    entry = phase_kernel(dev)
    phase_round(dev)
    phase_small_card_vs_cpu(dev)
    launches, by_variant = phase_engine(dev)
    if launches <= 0:
        raise AssertionError("ring_resolve was not launched on the main path")
    if not (by_variant["te4"] and by_variant["te5"]):
        raise AssertionError(f"the TE=4 and TE=5 kernels were not both "
                             f"launched on the main path: {by_variant}")
    http_launches, http_by_variant = phase_http_front(dev)
    if not (http_by_variant["te5"] and http_by_variant["generic"]):
        raise AssertionError(f"the TE=5 and generic kernels were not both "
                             f"launched on the HTTP front's path: "
                             f"{http_by_variant}")
    # 500 tenants, not 1,000: the load of this phase is what is cut to
    # keep the whole script near 400 s with the phases after it.
    mh_launches, mh_by_variant, mh_lines = phase_multihost_frames(
        dev, tenants=500)
    mesh_by_layout = phase_mesh_round(dev)
    from etcd_tpu_torch.parallel.mesh import make_mesh
    em_launches, em_by_variant = phase_engine(
        dev, mesh=make_mesh([dev] * 4, peers_axis=1), name="engine_mesh")
    if not (em_by_variant["te4"] and em_by_variant["te5"]):
        raise AssertionError(f"the TE=4 and TE=5 kernels were not both "
                             f"launched on the mesh engine's path: "
                             f"{em_by_variant}")
    mc_launches, mc_by_variant, mc_lines = phase_multihost_collective(dev)
    entry["launches"] = launches
    entry["launches_by_variant"] = by_variant
    entry["launches_by_path"] = {
        "engine": {"launches": launches, "by_variant": by_variant},
        "http_front": {"launches": http_launches,
                       "by_variant": http_by_variant},
        "multihost_frames": {
            "launches": mh_launches, "by_variant": mh_by_variant,
            "by_rank": [ln["launches_by_variant"] for ln in mh_lines]},
        "mesh_round": {
            "launches": sum(sum(v.values()) for v in mesh_by_layout.values()),
            "by_layout": mesh_by_layout},
        "engine_mesh": {"launches": em_launches,
                        "by_variant": em_by_variant},
        "multihost_collective": {
            "launches": mc_launches, "by_variant": mc_by_variant,
            "by_rank": [ln["launches_by_variant"] for ln in mc_lines]}}
    entry["equal_to_plain"] = True
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
