"""Headline benchmark of the port: aggregate Raft commits/s across G groups
on one card, and the serving path's scenarios around it.

    python -m etcd_tpu_torch.bench                    # the card (cuda:0)
    BENCH_PLATFORM=cpu python -m etcd_tpu_torch.bench # the CPU, when asked

The JAX package's `bench.py` on the port's round (`ops/kernel.py`, whose
`_terms_at_many` launches the CUDA `ring_resolve`) and engine
(`server/engine.py::MultiEngine`): the same scenarios, environment
variables, metric name and result keys, so one reader takes either
package's line.

Baseline for vs_baseline: the reference's best published write
throughput, 4,157 writes/sec (256B values, 256 clients, leader-only —
BASELINE.md, Documentation/benchmarks/etcd-2-1-0-benchmarks.md:46). One
committed entry here == one write there (payloads ride the host log
store; the device commits index metadata).

Latency is measured: per-round history of the leader's last_index
(admission) and commit gives per-proposal propose->commit latency over
sampled groups.

Result lines are cumulative and streamed: after every completed scenario
a full JSON line (every scenario measured so far) reaches stdout, so a
consumer takes the last line. The measurement runs in a child process
(its own session); the parent streams its lines, kills the child and
everything it started at the deadline (budget + 15 s) and exits 1 if the
child failed or was killed. Without a card, and without
BENCH_PLATFORM=cpu, it exits 1 at once: nothing falls back to the CPU.

Scenario matrix (BASELINE.json configs 3-5):
  uniform — every group's leader admits max_ents/round (configs 1-2 shape)
  zipf    — Zipf(1.1)-skewed per-group admission rates (config 3: hot
            tenants get orders of magnitude more writes than the tail)
  lag     — 5% of groups have one fully partitioned follower (config 4:
            Progress.Paused flow control engages)
  churn   — every 40 rounds the leaders of 10% of groups are partitioned
            for 15 rounds, forcing re-elections mid-load (config 5, at 7
            peers)
  engine  — the full serving path: MultiEngine rounds with the engine WAL
            (fsync on), payload store, apply-to-store and acks; acked
            writes/s against the reference's 4,157 writes/s
  latency — the engine at the per-card shard shape (12,500 groups), most
            of its time at 50% load: ack p50/p99
  qread   — quorum reads through the zero-append batched-ReadIndex read
            plane, interleaved with the same reads down the propose path
            (METHOD_QGET), then a mixed phase; the read-only leg's WAL
            byte and log-length deltas (both 0)
  watch_storm — 100k stream watchers fed from the event-history ring under
            concurrent writes: deliveries/s, p99 staleness
  expiry_wave — every tenant's TTL keys expire at one instant; SYNCs sweep
            them through consensus: expired keys/s, the round stall
  shallow_clients — 10,000 depth-1 connections through the coalescing
            ingress (`python -m etcd_tpu_torch.server.ingress`) to the
            CLI's engine (`python -m etcd_tpu_torch`), A/B against the
            JSON ingress and direct, a SIGKILL of the ingress mid-leg
            (lost acked writes: 0), then hub fan-out
The primary metric is the uniform run; the others report under
"scenarios".

What differs from the JAX bench:
- The device: `cuda:0` (BENCH_PLATFORM=cpu: the CPU). "platform" is
  "gpu" or "cpu"; the line also carries "device" and "power_limit_w"
  (nvidia-smi's name and power limit of the card; "cpu" and null on the
  CPU). No backend-init watchdog, no compile cache, no retry, no CPU
  fallback, no error line with exit 0, no `./build` (the port builds its
  C at import).
- The rounds read `_quiet_pred` back to the host once per hop (JAX's
  `lax.cond` stays on the device), so the "pipelined" phase of uniform,
  lag and churn syncs with the card every round; its keys
  (round_ms_pipelined, rounds_pipelined) keep their names.
- shallow_clients' engine runs on the bench's device (the JAX bench
  pins it to the CPU), its stderr goes to a file whose stop line gives
  its ring_resolve launches, and its ports come from below the
  ephemeral range (`tools.launch.free_ports`): the ingress restarts on
  its port while 10,000 client sockets reconnect, and a port from the
  ephemeral range can be taken by one of them meanwhile. The soft
  RLIMIT_NOFILE is raised to the hard limit where the connections need
  it; the processes and the data dir are removed on any exit. Its
  direct leg holds at most DIRECT_CONNS_MAX (3,000) connections, since
  the engine's front starts a thread for each (reported as
  "direct_conns"; ingress_vs_direct is null unless it held them all),
  and its connect storm retries a refused connect for up to 60 s where
  the JAX bench gives up after 200 refusals (that machine's network
  stack refuses a connect on a full listen queue; Linux drops the SYN).
- One stderr line per scenario, `bench scenario {json}`: the scenario,
  its seconds, ring_resolve's launches by variant in this process (for
  shallow_clients: in the engine process) and, for engine and latency,
  `engine_acked` (the engine's own acked count, which
  `metrics_delta["etcd_engine_acked_requests_total"]` must equal).
- The regression gate compares only lines of the same platform and
  device: no TPU or CPU artifact reads as comparable to a card's line.

Env knobs: BENCH_GROUPS, BENCH_PEERS (5), BENCH_ROUNDS, BENCH_WARM_ROUNDS,
BENCH_BUDGET_S (480), BENCH_SCENARIO (all, or one or more of uniform,
engine, latency, qread, shallow_clients, watch_storm, expiry_wave, zipf,
lag, churn, comma-separated; they run in that order), BENCH_PLATFORM,
BENCH_ENGINE_GROUPS, BENCH_LAT_GROUPS, BENCH_QREAD_GROUPS,
BENCH_EXPIRY_GROUPS, BENCH_TTL_KEYS, BENCH_WATCHERS, BENCH_WATCH_KEYS,
BENCH_CHURN_PEERS (7), BENCH_APPLIER_SHARDS, BENCH_WAL_SHARDS,
BENCH_WAL_PIPELINE, BENCH_OBS_AB, BENCH_SHALLOW_CONNS,
BENCH_SHALLOW_TENANTS, BENCH_HUB_WATCHERS, BENCH_SHALLOW_LEG_S,
BENCH_MIN_ROUNDS (10: the fewest rounds of each measured leg of the
host-bound engine, latency and qread scenarios, past their share of the
budget), BENCH_KILL_ORPHANS.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from etcd_tpu_torch.ops import kernel
from etcd_tpu_torch.ops.ring_resolve import ring_resolve
from etcd_tpu_torch.ops.state import LEADER, KernelConfig, init_state
from etcd_tpu_torch.tools.launch import child_env, free_ports, require_device
from etcd_tpu_torch.utils.metrics import REGISTRY

BASELINE_WRITES_PER_SEC = 4157.0
# The fewest measured rounds of each leg of the host-bound scenarios
# (engine, latency, qread), however short their share of the budget.
MIN_ROUNDS = int(os.environ.get("BENCH_MIN_ROUNDS", 10))
# The stderr prefix of each scenario's JSON line (launches, engine acks).
SCENARIO_LINE = "bench scenario "
# The engine CLI's stop line, as etcdmain/etcd.py logs it.
STOP_LINE = "ring_resolve launches by instantiation "

# churn LAST: it boots a second kernel geometry (7 peers, BASELINE config
# 5). The serving scenarios carry the headline claims and come right
# after the primary; zipf/lag are quick synced loops.
ORDER = ("uniform", "engine", "latency", "qread", "shallow_clients",
         "watch_storm", "expiry_wave", "zipf", "lag", "churn")
WEIGHTS = {"uniform": 0.20, "zipf": 0.05, "lag": 0.05, "engine": 0.17,
           "latency": 0.15, "churn": 0.08, "qread": 0.09,
           "watch_storm": 0.06, "expiry_wave": 0.06,
           "shallow_clients": 0.09}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _metrics_snapshot():
    """Flat registry snapshot, bucket series dropped for size (the
    _count/_sum pair already summarizes each histogram)."""
    return {k: v for k, v in REGISTRY.snapshot().items()
            if not k.split("{", 1)[0].endswith("_bucket")}


def _metrics_delta(before, after):
    """What the registry saw during one scenario: monotone series
    (_total/_count/_sum) as after-minus-before movement, gauges as
    their final value (a depth-gauge 'delta' means nothing). Series
    born mid-scenario count from zero. This is the cross-check column:
    etcd_engine_acked_requests_total's movement must equal the
    scenario's own acked count (tests/test_torch_observability_ref.py
    holds the same invariant in process)."""
    out = {}
    for k, v in sorted(after.items()):
        base = k.split("{", 1)[0]
        if base.endswith(("_total", "_count", "_sum")):
            d = v - before.get(k, 0.0)
            if d:
                out[k] = round(d, 6)
        else:
            out[k] = round(v, 6)
    return out


# ---------------------------------------------------------------------------
# Child: the measurement
# ---------------------------------------------------------------------------

class Ctx(NamedTuple):
    """What the scenarios share: where the rounds run, the kernel's
    geometry, the one generator the masks and rates draw from (in
    scenario order: zipf, lag, churn) and the warm-up rounds."""
    device: torch.device
    cfg: KernelConfig
    rng: np.random.Generator
    warm: int

    @property
    def G(self) -> int:
        return self.cfg.groups

    @property
    def P(self) -> int:
        return self.cfg.peers

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"


def bench_device() -> str:
    """"cpu" when BENCH_PLATFORM asks for it, else the card."""
    return "cpu" if os.environ.get("BENCH_PLATFORM") == "cpu" else "cuda:0"


def card_info(dev: torch.device) -> tuple:
    """(device name, power limit in W): nvidia-smi's for the card,
    ("cpu", None) on the CPU."""
    if dev.type != "cuda":
        return "cpu", None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = out.rsplit(",", 1)
    try:
        watts = float(limit.split()[0])
    except (ValueError, IndexError):
        watts = None
    return name.strip(), watts


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _on(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def lag_mask(rng, G, P, slots_np):
    """Fully partition one non-leader slot in 5% of groups (config 4);
    flow control engages at effective_flow_window un-acked entries.
    Returns the (G, P, P, 1) int32 keep-mask and the lagged count."""
    lag_groups = rng.choice(G, size=max(1, G // 20), replace=False)
    mask_to = np.ones((G, P, 1, 1), np.int32)
    mask_from = np.ones((G, 1, P, 1), np.int32)
    lag_slot = (slots_np[lag_groups] + 1) % P
    mask_to[lag_groups, lag_slot] = 0
    mask_from[lag_groups, 0, lag_slot] = 0
    return mask_to * mask_from, len(lag_groups)


def churn_mask(rng, G, P, slots_np):
    """Partition the LEADER of 10% of groups (config 5): those groups
    must re-elect among the remaining peers while the rest keep
    committing. Returns the keep-mask and the churned groups."""
    churned = rng.choice(G, size=max(1, G // 10), replace=False)
    mask_to = np.ones((G, P, 1, 1), np.int32)
    mask_from = np.ones((G, 1, P, 1), np.int32)
    mask_to[churned, slots_np[churned]] = 0
    mask_from[churned, 0, slots_np[churned]] = 0
    return mask_to * mask_from, churned


def zipf_rates(rng, G, max_ents):
    """Per-group client-write arrival rates, Zipf(1.1)-skewed, scaled so
    the AGGREGATE offered load equals the uniform scenario's
    (G * max_ents writes/round): same total load, skewed placement."""
    w = 1.0 / np.arange(1, G + 1, dtype=np.float64) ** 1.1
    rng.shuffle(w)
    return w * (G * max_ents) / w.sum()


def current_slots(st) -> np.ndarray:
    """Each group's first leader slot (0 where it has none)."""
    return (st.state == LEADER).cpu().numpy().argmax(axis=1).astype(np.int32)


def extract(st, slots):
    """(last_index, commit) at each group's `slots`, and the max commit
    over peers (the leader-change-proof count), on the device."""
    col = slots.long()[:, None]
    return (st.last_index.gather(1, col)[:, 0], st.commit.gather(1, col)[:, 0],
            st.commit.amax(dim=1))


def bench_round(cfg, st, inbox, props, slots, drop=None):
    """One round of the kernel scenarios: step_routed_auto (one hop, a
    tick) with props (G,) entries proposed at slots (G,), then the
    (G, P, P, 1) keep-mask `drop` applied to the routed inbox."""
    st, inbox = kernel.step_routed_auto(cfg, st, inbox, props, slots, True)
    if drop is not None:
        inbox = inbox * drop
    return st, inbox


def boot(cfg, dev):
    """Fresh staggered state; elections converge within 8 rounds.
    Returns (state, inbox, rounds taken)."""
    G, P = cfg.groups, cfg.peers
    st = init_state(cfg, stagger=True, device=dev)
    inbox = torch.zeros((G, P, P, cfg.fields), dtype=torch.int32, device=dev)
    zero = torch.zeros(G, dtype=torch.int32, device=dev)
    for r in range(8):
        st, inbox = bench_round(cfg, st, inbox, zero, zero)
        if bool((st.state == LEADER).any(dim=1).all()):
            return st, inbox, r + 1
    raise RuntimeError("staggered elections did not converge in 8 rounds")


# Writes-per-entry cap of zipf's admission: the engine's byte-capped group
# commit (EngineConfig.batch_bytes = 1MB, the reference's maxSizePerMsg)
# over ~300B per write (256B values + JSON envelope).
ZIPF_BATCH = min(4096, (1 << 20) // 300)


def zipf_staged(queue, B, EB):
    """What zipf's admission stages this round: (writes admitted, entries
    proposed) per group, from the queued writes."""
    a_w = np.minimum(np.floor(queue), EB)
    pc = np.ceil(a_w / B).astype(np.int32)
    return a_w, pc


def measure_zipf(ctx, st, inbox, sc_deadline, max_rounds):
    """Config 3 (hot tenants) through the engine's write-batching
    admission model: queued client writes coalesce into log entries of
    up to B writes each, at most max_ents entries per group per round.
    Rounds are SYNCED (per-round last_index/commit readback) so entry
    admission is exact. The metric is committed client WRITES/s; entry
    commits are reported alongside."""
    cfg, G, P, dev = ctx.cfg, ctx.G, ctx.P, ctx.device
    B = ZIPF_BATCH
    slots = _on(current_slots(st), dev)
    zr = zipf_rates(ctx.rng, G, cfg.max_ents)
    queue = np.zeros(G)
    EB = cfg.max_ents * B

    def step(st, inbox, queue, li_prev):
        queue += zr
        a_w, pc = zipf_staged(queue, B, EB)
        st, inbox = bench_round(cfg, st, inbox, _on(pc, dev), slots)
        li, ci, _ = extract(st, slots)
        li_np = li.cpu().numpy()
        adm_w = np.minimum(a_w, (li_np - li_prev) * B)
        queue -= adm_w
        return st, inbox, li_np, ci, adm_w

    # Warmup (queue evolves; nothing counted).
    li_prev = extract(st, slots)[0].cpu().numpy()
    for r in range(ctx.warm):
        st, inbox, li_prev, _, _ = step(st, inbox, queue, li_prev)
        if time.time() > sc_deadline:
            break
    li0 = li_prev.copy()

    li_hist, ci_hist, aw_hist = [], [], []
    t_hist = [time.time()]
    n = 0
    while n < min(max_rounds, 400):
        st, inbox, li_np, ci, adm_w = step(st, inbox, queue, li_prev)
        li_hist.append(li_np)
        ci_hist.append(ci.cpu().numpy())
        aw_hist.append(adm_w)
        li_prev = li_np
        t_hist.append(time.time())
        n += 1
        if n >= 10 and time.time() > sc_deadline:
            break
    elapsed = t_hist[-1] - t_hist[0]
    # Drain the measurement boundary: entries admitted in the window but
    # not yet committed at its close would count as offered yet never
    # committed. A few proposal-free rounds let the tail commit; the
    # offered clock stays stopped.
    zero = torch.zeros(G, dtype=torch.int32, device=dev)
    for _ in range(6):
        st, inbox = bench_round(cfg, st, inbox, zero, slots)
    ci_drained = extract(st, slots)[1].cpu().numpy()
    li_h = np.stack(li_hist)                      # (n, G)
    ci_h = np.stack(ci_hist)                      # (n, G)
    aw_h = np.stack(aw_hist)                      # (n, G)
    # Commits credited up to the END of the measured admissions.
    ci_f = np.minimum(ci_drained, li_h[-1])
    li_base = np.concatenate([li0[None], li_h[:-1]])  # prev li per round

    # Committed writes: rounds whose admitted entries all sit at or below
    # the final commit count fully; the boundary round counts B-packed
    # writes of its committed prefix of entries.
    com_e = np.minimum(li_h, ci_f[None, :]) - np.minimum(li_base,
                                                         ci_f[None, :])
    com_w = np.minimum(aw_h, com_e * B)
    committed_writes = int(com_w.sum())
    committed_entries = int((np.minimum(li_h[-1], ci_f) - li0).sum())
    wps = committed_writes / elapsed
    round_ms = 1000.0 * elapsed / n

    # Write-weighted propose->commit latency over sampled groups.
    t_arr = np.asarray(t_hist)
    lrng = np.random.default_rng(1)
    sample = lrng.choice(G, size=min(G, 1024), replace=False)
    lats, weights = [], []
    for g in sample:
        li_g = li_h[:, g]
        # Only commits observed inside the measured window have a
        # timestamp (drain-phase commits count for the share only).
        first, last = li0[g] + 1, min(ci_h[-1, g], li_g[-1])
        if last < first:
            continue
        idx = np.arange(first, last + 1)
        r_adm = np.searchsorted(li_g, idx, side="left")
        r_com = np.searchsorted(ci_h[:, g], idx, side="left")
        lats.append(t_arr[r_com + 1] - t_arr[r_adm])
        j = idx - li_base[r_adm, g] - 1           # entry # within round
        w = np.minimum(B, aw_h[r_adm, g] - j * B).clip(min=0)
        weights.append(w)
    if lats:
        lat = np.concatenate(lats)
        w = np.concatenate(weights).astype(np.int64)
        lat = np.repeat(lat, np.maximum(w, 0))
        p50 = round(1000.0 * float(np.percentile(lat, 50)), 3)
        p99 = round(1000.0 * float(np.percentile(lat, 99)), 3)
    else:
        p50 = p99 = None
    offered = float(zr.sum()) * n
    log(f"[zipf] G={G} P={P}: {committed_writes} committed writes "
        f"({committed_entries} entries) in {elapsed:.2f}s / {n} synced "
        f"rounds ({round_ms:.2f} ms/round) -> {wps:,.0f} writes/s "
        f"({100 * committed_writes / max(offered, 1):.0f}% of offered); "
        f"latency p50 {p50} p99 {p99} ms (write-weighted)")
    # Structural admission ceiling, computed in the artifact: per-group
    # capacity is max_ents entries x B writes per round; tenants offered
    # more can never commit the excess (per-group backpressure,
    # reference raft/node.go:279).
    ceiling = float(np.minimum(zr, EB).sum() / zr.sum())
    share = committed_writes / max(offered, 1)
    if share < 0.95 * ceiling:
        log(f"ZIPF ADMISSION GAP: share {share:.3f} is more than 5% "
            f"under the structural ceiling {ceiling:.3f} — engine "
            f"admission is leaving capacity on the table")
    res = {"commits_per_sec": round(wps, 1),
           "entry_commits_per_sec": round(committed_entries / elapsed, 1),
           "write_batching": B,
           "offered_writes_per_round": int(zr.sum()),
           "committed_share_of_offered": round(share, 4),
           "admission_ceiling": round(ceiling, 4),
           "share_of_ceiling": round(share / ceiling, 4),
           "p50_commit_latency_ms": p50,
           "p99_commit_latency_ms": p99,
           "round_ms_synced": round(round_ms, 3),
           "rounds_synced": n,
           "hottest_rate_share": round(float(zr.max() / zr.sum()), 4)}
    return res, st, inbox


CHURN_PERIOD, CHURN_LEN = 40, 15


def measure(ctx, scenario, st, inbox, sc_deadline, max_rounds):
    """uniform, lag and churn: a "pipelined" throughput phase (no
    readback but the per-hop quiescence read) and a synced latency
    phase."""
    cfg, G, P, dev = ctx.cfg, ctx.G, ctx.P, ctx.device
    full = torch.full((G,), cfg.max_ents, dtype=torch.int32, device=dev)
    slots_np = current_slots(st)
    slots = _on(slots_np, dev)
    drop = None
    extra = {}
    if scenario == "lag":
        m, extra["lagged_groups"] = lag_mask(ctx.rng, G, P, slots_np)
        drop = _on(m, dev)

    def churn_phase(r, st, drop):
        """The churn schedule at round r: a fresh partition of the
        current leaders, the heal, or no change. Returns (drop, churned
        groups or None)."""
        ph = r % CHURN_PERIOD
        if ph == 0:
            m, churned = churn_mask(ctx.rng, G, P, current_slots(st))
            return _on(m, dev), churned
        if ph == CHURN_LEN:
            return None, None
        return drop, None

    # Warmup + per-round cost estimate under THIS scenario.
    for r in range(ctx.warm):
        st, inbox = bench_round(cfg, st, inbox, full, slots, drop)
        if time.time() > sc_deadline:
            break
    _sync(dev)
    t_est = time.time()
    for r in range(3):
        st, inbox = bench_round(cfg, st, inbox, full, slots, drop)
    _sync(dev)
    est = (time.time() - t_est) / 3
    n = max(10, min(max_rounds,
                    int((sc_deadline - time.time() - 1.0) / max(est, 1e-4))))

    # --- Throughput phase: no readback between rounds (but the per-hop
    # quiescence read, see the module docstring). Churn partitions are
    # injected here too. Takes ~60% of the scenario budget; the synced
    # latency phase gets the rest.
    n_t = max(min(n, int(0.6 * (sc_deadline - time.time())
                         / max(est, 1e-4))), 20)
    cm0_t = extract(st, slots)[2]
    _sync(dev)
    t0 = time.time()
    for r in range(n_t):
        if scenario == "churn":
            drop, _ = churn_phase(r, st, drop)
        st, inbox = bench_round(cfg, st, inbox, full, slots, drop)
    _sync(dev)
    t_elapsed = time.time() - t0
    cm1_t = extract(st, slots)[2]
    commits_t = int((cm1_t - cm0_t).sum())
    cps = commits_t / t_elapsed
    pipelined_round_ms = 1000.0 * t_elapsed / n_t

    # --- Latency phase: per-round synced history for the propose->commit
    # estimator (bounded; sync costs dominate it).
    n = min(n, 60)
    slots_np = current_slots(st)
    slots = _on(slots_np, dev)
    stable = np.ones(G, bool)   # groups whose leader never churned
    li0, ci0, cm0 = extract(st, slots)
    _sync(dev)
    li_hist, ci_hist = [], []
    t_hist = np.zeros(n + 1)
    t_hist[0] = time.time()
    done = 0
    for r in range(n):
        if scenario == "churn":
            drop, churned = churn_phase(r, st, drop)
            if churned is not None:
                stable[churned] = False
        st, inbox = bench_round(cfg, st, inbox, full, slots, drop)
        li, ci, cm = extract(st, slots)
        li_hist.append(li)
        ci_hist.append(ci)
        _sync(dev)
        t_hist[r + 1] = time.time()
        done = r + 1
        # Each synced round pays the full host<->device round trip:
        # stop at the deadline instead of overrunning the matrix.
        if done >= 10 and time.time() > sc_deadline:
            break
    n = done
    t_hist = t_hist[:n + 1]
    elapsed = t_hist[n] - t_hist[0]

    li_h = torch.stack(li_hist).cpu().numpy()   # (n, G)
    ci_h = torch.stack(ci_hist).cpu().numpy()
    li0 = li0.cpu().numpy()
    round_ms = 1000.0 * elapsed / n

    # Measured propose->commit latency over sampled STABLE groups: entry
    # i admitted in the first round with last_index >= i, commit visible
    # at t[rc+1]; uncommitted tail censored.
    lrng = np.random.default_rng(1)
    pool = np.nonzero(stable)[0]
    sample = lrng.choice(pool, size=min(len(pool), 1024), replace=False)
    lats = []
    for g in sample:
        li, ci = li_h[:, g], ci_h[:, g]
        first, last = li0[g] + 1, ci[-1]
        if last < first:
            continue
        idx = np.arange(first, last + 1)
        r_adm = np.searchsorted(li, idx, side="left")
        r_com = np.searchsorted(ci, idx, side="left")
        lats.append(t_hist[r_com + 1] - t_hist[r_adm])
    if lats:
        lat = np.concatenate(lats)
        p50 = round(1000.0 * float(np.percentile(lat, 50)), 3)
        p99 = round(1000.0 * float(np.percentile(lat, 99)), 3)
        nlat = int(lat.size)
    else:
        p50 = p99 = None
        nlat = 0
    if scenario == "churn":
        extra["churned_groups"] = int((~stable).sum())
        extra["groups_with_leader_at_end"] = int(
            (st.state == LEADER).any(dim=1).sum())
        # LIVENESS FLOOR: heal every partition and give churned groups 8
        # election ticks' worth of rounds (>= 2 full randomized attempts
        # for every group). A shortfall past that is an
        # election-starvation regression, not timing noise.
        heal_rounds = 8 * cfg.election_tick
        for _ in range(heal_rounds):
            st, inbox = bench_round(cfg, st, inbox, full, slots)
        healed = int((st.state == LEADER).any(dim=1).sum())
        extra["groups_with_leader_after_heal"] = healed
        extra["liveness_floor_ok"] = bool(healed == G)
        if healed != G:
            log(f"LIVENESS FLOOR VIOLATION: {G - healed} groups "
                f"still leaderless {heal_rounds} rounds "
                f"after churn healed")

    log(f"[{scenario}] G={G} P={P}: {commits_t} commits in "
        f"{t_elapsed:.2f}s / {n_t} pipelined rounds "
        f"({pipelined_round_ms:.2f} ms/round) -> {cps:,.0f} commits/s; "
        f"synced-loop latency p50 {p50} p99 {p99} ms over {nlat} "
        f"proposals ({n} rounds at {round_ms:.2f} ms, stable groups: "
        f"{int(stable.sum())})")
    res = {"commits_per_sec": round(cps, 1),
           "round_ms_pipelined": round(pipelined_round_ms, 3),
           "rounds_pipelined": n_t,
           "p50_commit_latency_ms": p50,
           "p99_commit_latency_ms": p99,
           "round_ms_synced": round(round_ms, 3),
           "rounds_synced": n, **extra}
    return res, st, inbox


class _AckSample:
    """Wait-registry waiter that timestamps the ack as it fires (a
    collector thread reading queues would add its own scheduling delay
    to the tail percentiles)."""
    __slots__ = ("t0", "t1")

    def __init__(self):
        self.t0 = time.time()
        self.t1 = None

    def put(self, value):
        self.t1 = time.time()


def _pct(xs, q):
    return round(1000 * float(np.percentile(xs, q)), 3) if xs else None


def _all_led(eng) -> bool:
    # Vectorized: leader_slot() per group is a Python loop over G.
    return bool((np.where(eng.h_mask, eng.h_state, 0) == 2)
                .any(axis=1).all())


def _elect(eng) -> None:
    for _ in range(12):
        eng.run_round()
        if _all_led(eng):
            return
    raise AssertionError("engine elections did not converge")


def measure_engine(ctx, sc_deadline, G_e=None, sat_frac=0.55,
                   label="engine", report=None):
    """End-to-end serving-path throughput: acked writes/s through the
    MultiEngine (kernel round + WAL fsync + payload store + apply +
    wait-trigger), offered load = max_ents per group per round.

    Two callers: the `engine` scenario runs the full north-star tenant
    count (100k on the card), and the `latency` scenario runs the
    per-card shard shape (G=12,500 = 100k/8) with most of its budget on
    the paced 50%-load phase. `report` (a dict) gets `engine_acked`,
    every request the engine acked over its life."""
    import tempfile

    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from etcd_tpu_torch.server.request import Request

    # Peers from env, not the context's (churn runs at 7).
    P = int(os.environ.get("BENCH_PEERS", 5))
    if G_e is None:
        G_e = int(os.environ.get("BENCH_ENGINE_GROUPS",
                                 min(ctx.G, 100_000 if ctx.on_card
                                     else 2048)))
    E = 4
    # Applier pool width and WAL-writer shards: the measured sweet spots
    # of the JAX package's sweeps (docs/perf.md); 1 and
    # BENCH_WAL_PIPELINE=0 give the single-applier / inline-WAL baselines.
    K_appl = int(os.environ.get("BENCH_APPLIER_SHARDS", 2))
    S_wal = int(os.environ.get("BENCH_WAL_SHARDS", 2))
    wal_pipe = os.environ.get("BENCH_WAL_PIPELINE", "1") != "0"
    with tempfile.TemporaryDirectory() as tmp:
        eng = MultiEngine(EngineConfig(
            groups=G_e, peers=P, data_dir=tmp, window=16, max_ents=E,
            heartbeat_tick=3, fsync=True, stagger=True,
            applier_shards=K_appl, wal_shards=S_wal,
            pipeline_wal=wal_pipe, checkpoint_rounds=1 << 30,
            device=str(ctx.device)))
        _elect(eng)

        payload = Request(method="PUT", path="/bench/k", val="x" * 64)
        samples = []

        def sample_rid(rid):
            if rid in eng.wait._waiters:
                return   # already sampled (undrained queue head)
            s = _AckSample()
            eng.wait._waiters[rid] = s
            samples.append(s)

        # Offered load rides a pre-encoded request pool: the bench
        # measures the ENGINE's serving capacity, not the generator's
        # Request construct+encode cost. Only latency-sampled requests
        # need fresh ids (their ack is observed through the wait
        # registry).
        pool = []
        for i in range(4096):
            rid = eng.reqid.next()
            rq = Request(**{**payload.__dict__, "id": rid})
            pool.append((rid, b"\x00" + rq.encode(), rq))
        pool_i = 0

        def fresh_sampled():
            rid = eng.reqid.next()
            rq = Request(**{**payload.__dict__, "id": rid})
            sample_rid(rid)
            return (rid, b"\x00" + rq.encode(), rq)

        def offer(r, depth=E, sample=True):
            """Top pending queues up to `depth` per group; optionally
            sample one fresh-id waiter's ack latency per round."""
            nonlocal pool_i
            item = fresh_sampled() if sample else None
            with eng._lock:
                for g in range(G_e):
                    dq = eng._pending[g]
                    while len(dq) < depth:
                        dq.append(pool[pool_i & 4095])
                        pool_i += 1
                    eng._dirty.add(g)
                if item is not None:
                    eng._pending[r % G_e].append(item)
                    eng._dirty.add(r % G_e)

        for r in range(5):   # warm the serving loop
            offer(r)
            eng.run_round()

        # -- Phase A: SATURATED throughput (queues topped every round;
        # latency samples here measure full-backlog queueing).
        sat_end = time.time() + sat_frac * max(
            sc_deadline - time.time(), 20.0)
        a0 = eng.acked_requests
        t0 = time.time()
        r = 0
        while time.time() < sat_end - 1.0 or r < MIN_ROUNDS:
            offer(r)
            eng.run_round()
            r += 1
            if r >= 100000:
                break
        elapsed = time.time() - t0
        acked = eng.acked_requests - a0

        def drain():
            """Queues empty + applier settled: the next phase starts
            from a quiescent engine."""
            for _ in range(200):
                eng.run_round()
                with eng._lock:
                    if not any(eng._pending[g] for g in range(G_e)):
                        break
            eng._drain_applies()

        drain()
        sat_samples, samples = samples, []
        aps = acked / elapsed

        # -- Phase A2 (engine scenario only): DEEP-QUEUE throughput at
        # depth 64 per tenant. Skipped out of budget, for the latency
        # scenario (its budget belongs to phase B), and where topping
        # G_e queues to depth 64 would measure the generator (> 2M
        # appends per round).
        DEEP = 64
        deep_aps = rd = None
        deep_samples = []
        if (label.split("/", 1)[0] == "engine"
                and G_e * DEEP <= 2_000_000
                and time.time() < sc_deadline - 5.0):
            deep_end = time.time() + 0.3 * (sc_deadline - time.time())
            d0 = eng.acked_requests
            t_d = time.time()
            rd = 0
            while time.time() < deep_end - 0.5 or rd < 5:
                # One fresh-id waiter per round rides the depth-64
                # backlog: what a request waits behind a saturated
                # pipeline.
                offer(rd, depth=DEEP)
                eng.run_round()
                rd += 1
                if rd >= 100000:
                    break
            deep_elapsed = time.time() - t_d
            deep_acked = eng.acked_requests - d0
            drain()
            deep_aps = deep_acked / deep_elapsed
            deep_samples, samples = samples, []

        # -- Phase B: latency AT LOAD, offered load paced to ~50% of the
        # measured saturated capacity. Every 8th request is sampled.
        rate = 0.5 * aps
        b_end = max(sc_deadline - 1.0, time.time() + 5.0)
        injected = 0
        sample_every = 8
        t_b = time.time()
        rb = 0
        while time.time() < b_end:
            want = int(rate * (time.time() - t_b)) - injected
            if want > 0:
                with eng._lock:
                    for k in range(want):
                        g = (injected + k) % G_e
                        if (injected + k) % sample_every == 0:
                            item = fresh_sampled()
                        else:
                            item = pool[(injected + k) & 4095]
                        eng._pending[g].append(item)
                        eng._dirty.add(g)
                injected += want
            eng.run_round()
            rb += 1
        t_b_end = time.time()   # before drain/stop/teardown skew it
        for _ in range(6):
            eng.run_round()
        eng._drain_applies()
        # Per-shard apply share before stop tears the workers down.
        apply_s = {k: v for k, v in eng.phase_s.items()
                   if k == "apply" or k.startswith("apply[")}
        n_shards = len(eng._appliers)
        # Writer-compartment profile before stop closes the streams.
        wal_stats = eng.wal.stats()
        eng.stop()
        if report is not None:
            report["engine_acked"] = eng.acked_requests
    # Discard phase-B warmup (first 20% of the window).
    cut = t_b + 0.2 * (t_b_end - t_b)
    b_lats = [s.t1 - s.t0 for s in samples
              if s.t1 is not None and s.t0 >= cut]
    s_lats = [s.t1 - s.t0 for s in sat_samples if s.t1 is not None]
    d_lats = [s.t1 - s.t0 for s in deep_samples if s.t1 is not None]
    p50, p99 = _pct(b_lats, 50), _pct(b_lats, 99)
    sp50, sp99 = _pct(s_lats, 50), _pct(s_lats, 99)
    dp50, dp99 = _pct(d_lats, 50), _pct(d_lats, 99)
    # Each worker's fraction of the pool's apply seconds: flags
    # range-imbalance.
    tot_apply = sum(apply_s.values())
    shard_share = ({k: round(v / tot_apply, 3)
                    for k, v in sorted(apply_s.items())}
                   if tot_apply > 0 else {})
    deep_txt = (f"deep-queue (depth {DEEP}) {deep_aps:,.0f} writes/s "
                f"over {rd} rounds (p50 {dp50} p99 {dp99} ms); "
                if deep_aps is not None else "")
    log(f"[{label}] G={G_e} P={P} applier_shards={n_shards} "
        f"wal_shards={wal_stats['wal_shards']}"
        f"{'' if wal_pipe else ' (wal pipeline OFF)'}: "
        f"{acked} acked writes in "
        f"{elapsed:.2f}s / {r} rounds -> {aps:,.0f} writes/s "
        f"(fsync on, depth {E}); {deep_txt}ack latency at "
        f"50% load p50 {p50} p99 {p99} ms over {len(b_lats)} samples "
        f"({rb} paced rounds); saturated p50 {sp50} p99 {sp99} ms; "
        f"apply share {shard_share}; wal fsync p50 "
        f"{wal_stats['wal_fsync_p50_ms']} p99 "
        f"{wal_stats['wal_fsync_p99_ms']} ms/commit, group-commit "
        f"mean {wal_stats['wal_group_commit_mean']} max "
        f"{wal_stats['wal_group_commit_max']} rounds, queue depth "
        f"p50 {wal_stats['wal_queue_depth_p50']} max "
        f"{wal_stats['wal_queue_depth_max']}")
    deep_keys = ({"deep_queue_acked_writes_per_sec": round(deep_aps, 1),
                  "deep_queue_depth": DEEP,
                  "deep_queue_rounds": rd,
                  "deep_queue_p50_ms": dp50,
                  "deep_queue_p99_ms": dp99}
                 if deep_aps is not None else {})
    return {"acked_writes_per_sec": round(aps, 1),
            "applier_shards": n_shards,
            "apply_share_per_shard": shard_share,
            "commits_per_sec": round(aps, 1),
            **deep_keys,
            **wal_stats,
            "wal_pipeline": wal_pipe,
            "groups": G_e,
            "rounds_pipelined": r,
            "round_ms_pipelined": round(1000 * elapsed / max(r, 1), 3),
            "p50_commit_latency_ms": p50,
            "p99_commit_latency_ms": p99,
            "latency_load_fraction": 0.5,
            "saturated_p50_ms": sp50,
            "saturated_p99_ms": sp99,
            "fsync": True}


def measure_obs_ab(ctx, sc_deadline, pairs, report=None):
    """Instrumentation-overhead A/B (BENCH_OBS_AB=N pairs): the engine
    scenario run 2N times with the observability plane alternately off
    (ETCD_TPU_OBS=off) and on, interleaved so slow drift cancels.
    Reports the mean deep-queue throughput cost as obs_overhead_pct on
    the ON leg's result (budget <= 3%, gated by _regression_gate).
    `report["engine_acked"]` sums every leg's acks."""
    legs = []
    n = 2 * pairs
    t0 = time.time()
    span = max(sc_deadline - t0, 1.0)
    prev_env = os.environ.get("ETCD_TPU_OBS")
    acked = 0
    try:
        for i in range(n):
            mode = "off" if i % 2 == 0 else "on"
            os.environ["ETCD_TPU_OBS"] = mode
            leg_report = {}
            legs.append((mode, measure_engine(
                ctx, min(t0 + span * (i + 1) / n, sc_deadline),
                label=f"engine/obs-{mode}", report=leg_report)))
            acked += leg_report["engine_acked"]
    finally:
        if prev_env is None:
            os.environ.pop("ETCD_TPU_OBS", None)
        else:
            os.environ["ETCD_TPU_OBS"] = prev_env
    if report is not None:
        report["engine_acked"] = acked
    col = "deep_queue_acked_writes_per_sec"
    offs = [r[col] for m, r in legs if m == "off" and r.get(col)]
    ons = [r[col] for m, r in legs if m == "on" and r.get(col)]
    out = dict(next((r for m, r in reversed(legs) if m == "on"),
                    legs[-1][1]))
    if offs and ons:
        off_m = sum(offs) / len(offs)
        on_m = sum(ons) / len(ons)
        out["obs_overhead_pct"] = round(100 * (1 - on_m / off_m), 2)
        out["obs_ab"] = {"pairs": pairs, "deep_queue_off": offs,
                         "deep_queue_on": ons}
        log(f"[engine/obs-ab] deep-queue off {off_m:,.0f} vs on "
            f"{on_m:,.0f} writes/s -> overhead "
            f"{out['obs_overhead_pct']}% ({pairs} interleaved pairs)")
    return out


def _dir_bytes(root) -> int:
    n = 0
    for d, _dirs, files in os.walk(root):
        for f in files:
            try:
                n += os.path.getsize(os.path.join(d, f))
            except OSError:
                pass
    return n


def measure_qread(ctx, sc_deadline):
    """Read plane A/B: quorum reads through the zero-append batched
    ReadIndex path vs the SAME reads down the propose path (METHOD_QGET,
    a log entry per read), interleaved qread/qget/qread/qget/qread. The
    leading qread leg runs READ-ONLY against a QUIESCED WAL and reports
    the zero-append claim as measured columns: the WAL byte delta and
    log-length delta across the leg (both exactly 0). A trailing mixed
    phase drives writes and quorum reads together."""
    import tempfile

    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from etcd_tpu_torch.server.request import Request

    P = int(os.environ.get("BENCH_PEERS", 5))
    G_q = int(os.environ.get("BENCH_QREAD_GROUPS",
                             min(ctx.G, 8192 if ctx.on_card else 1024)))
    DEPTH = 64
    with tempfile.TemporaryDirectory() as tmp:
        eng = MultiEngine(EngineConfig(
            groups=G_q, peers=P, data_dir=tmp, window=16, max_ents=4,
            heartbeat_tick=3, fsync=True, stagger=True,
            checkpoint_rounds=1 << 30, device=str(ctx.device)))
        _elect(eng)

        # Seed the key every read hits, one acked PUT per group.
        put = Request(method="PUT", path="/bench/k", val="x" * 64)
        with eng._lock:
            for g in range(G_q):
                rq = Request(**{**put.__dict__, "id": eng.reqid.next()})
                eng._pending[g].append((rq.id, b"\x00" + rq.encode(), rq))
                eng._dirty.add(g)
        for _ in range(400):
            eng.run_round()
            with eng._lock:
                if not any(eng._pending[g] for g in range(G_q)):
                    break
        eng._drain_applies()

        def log_len():
            return int(np.where(eng.h_mask, eng.h_last, 0)
                       .max(axis=1).sum())

        # QUIESCE: commit-index convergence keeps appending hardstate
        # diffs for a few rounds after the last ack; the zero-append
        # baseline is taken on a WAL that has stopped moving.
        stable, wb = 0, _dir_bytes(tmp)
        for _ in range(400):
            eng.run_round()
            nb = _dir_bytes(tmp)
            stable = stable + 1 if nb == wb else 0
            wb = nb
            if stable >= 20:
                break

        rsamples = []
        gq = Request(method="GET", path="/bench/k", quorum=True)
        rpool = []
        for _ in range(1024):
            rq = Request(**{**gq.__dict__, "id": eng.reqid.next()})
            rpool.append((rq.id, rq))
        qpool = []
        for _ in range(1024):
            rq = Request(**{**gq.__dict__, "method": "QGET",
                            "id": eng.reqid.next()})
            qpool.append((rq.id, b"\x00" + rq.encode(), rq))
        wpool = []
        for _ in range(1024):
            rq = Request(**{**put.__dict__, "id": eng.reqid.next()})
            wpool.append((rq.id, b"\x00" + rq.encode(), rq))
        rp_i = qp_i = wp_i = 0

        def offer_reads(depth, sample=True):
            """Top the parked-read queues to `depth` per group; pooled
            items ride unregistered ids (wait.trigger no-ops), one
            fresh-id waiter per round samples latency."""
            nonlocal rp_i
            item = None
            if sample:
                rq = Request(**{**gq.__dict__, "id": eng.reqid.next()})
                s = _AckSample()
                eng.wait._waiters[rq.id] = s
                rsamples.append(s)
                item = (rq.id, rq)
            added = 0
            with eng._lock:
                for g in range(G_q):
                    dq = eng._reads[g]
                    while len(dq) < depth:
                        dq.append(rpool[rp_i & 1023])
                        rp_i += 1
                        added += 1
                    eng._read_dirty.add(g)
                if item is not None:
                    eng._reads[0].append(item)
                    eng._read_dirty.add(0)
                    added += 1
                eng._reads_waiting += added
            return added

        def offer_writes(pool, depth):
            nonlocal qp_i, wp_i
            with eng._lock:
                for g in range(G_q):
                    dq = eng._pending[g]
                    while len(dq) < depth:
                        if pool is qpool:
                            dq.append(pool[qp_i & 1023])
                            qp_i += 1
                        else:
                            dq.append(pool[wp_i & 1023])
                            wp_i += 1
                    eng._dirty.add(g)

        def drain_reads():
            for _ in range(400):
                eng.run_round()
                with eng._lock:
                    if eng._reads_waiting == 0 and eng._ripe_waiting == 0:
                        return

        def drain_writes():
            for _ in range(400):
                eng.run_round()
                with eng._lock:
                    if not any(eng._pending[g] for g in range(G_q)):
                        break
            eng._drain_applies()

        def leg_qread(end_t):
            injected = 0
            t0 = time.time()
            r = 0
            while time.time() < end_t or r < MIN_ROUNDS:
                injected += offer_reads(DEPTH)
                eng.run_round()
                r += 1
                if r >= 100000:
                    break
            with eng._lock:
                backlog = eng._reads_waiting + eng._ripe_waiting
            elapsed = time.time() - t0
            drain_reads()
            return (injected - backlog) / elapsed

        def leg_qget(end_t):
            a0 = eng.acked_requests
            t0 = time.time()
            r = 0
            while time.time() < end_t or r < MIN_ROUNDS:
                offer_writes(qpool, DEPTH)
                eng.run_round()
                r += 1
                if r >= 100000:
                    break
            elapsed = time.time() - t0
            acked = eng.acked_requests - a0
            drain_writes()
            return acked / elapsed

        # Warm the read plane before anything is timed or snapshotted.
        offer_reads(4, sample=False)
        drain_reads()

        # Zero-append qread first (the WAL is quiesced now), then the
        # interleaved ratio legs, then the mixed phase.
        span = max(sc_deadline - time.time(), 15.0)
        t_base = time.time()
        wb0, ll0 = _dir_bytes(tmp), log_len()
        qread_legs = [leg_qread(t_base + 0.20 * span)]
        wb1, ll1 = _dir_bytes(tmp), log_len()
        qget_legs = [leg_qget(t_base + 0.36 * span)]
        qread_legs.append(leg_qread(t_base + 0.52 * span))
        qget_legs.append(leg_qget(t_base + 0.68 * span))
        qread_legs.append(leg_qread(t_base + 0.84 * span))

        # Mixed read/write phase at the same total depth.
        a0 = eng.acked_requests
        injected = 0
        t0 = time.time()
        r = 0
        m_end = max(sc_deadline - 1.0, time.time() + 3.0)
        while time.time() < m_end or r < MIN_ROUNDS:
            injected += offer_reads(DEPTH // 2, sample=False)
            offer_writes(wpool, DEPTH // 2)
            eng.run_round()
            r += 1
            if r >= 100000:
                break
        with eng._lock:
            backlog = eng._reads_waiting + eng._ripe_waiting
        m_elapsed = time.time() - t0
        m_reads = (injected - backlog) / m_elapsed
        m_writes = (eng.acked_requests - a0) / m_elapsed
        drain_reads()
        drain_writes()
        eng.stop()

    lats = [s.t1 - s.t0 for s in rsamples if s.t1 is not None]
    p50, p99 = _pct(lats, 50), _pct(lats, 99)
    rps = sum(qread_legs) / len(qread_legs)
    qps = sum(qget_legs) / len(qget_legs)
    ratio = round(rps / qps, 2) if qps > 0 else None
    log(f"[qread] G={G_q} P={P} depth {DEPTH}: quorum reads "
        f"{rps:,.0f}/s vs propose-path QGET {qps:,.0f}/s -> "
        f"{ratio}x ({len(qread_legs)}+{len(qget_legs)} interleaved "
        f"legs); read latency p50 {p50} p99 {p99} ms over "
        f"{len(lats)} samples; read-only leg wal delta {wb1 - wb0} "
        f"bytes / {ll1 - ll0} entries; mixed {m_reads:,.0f} reads/s "
        f"+ {m_writes:,.0f} writes/s")
    if wb1 != wb0 or ll1 != ll0:
        log(f"ZERO-APPEND VIOLATION: read-only quorum-read leg "
            f"moved the WAL ({wb1 - wb0} bytes, {ll1 - ll0} log "
            f"entries) — the read plane is appending")
    return {"commits_per_sec": round(rps, 1),
            "qread_reads_per_sec": round(rps, 1),
            "qget_reads_per_sec": round(qps, 1),
            "qread_vs_qget": ratio,
            "qread_p50_ms": p50,
            "qread_p99_ms": p99,
            "p50_commit_latency_ms": p50,
            "p99_commit_latency_ms": p99,
            "qread_wal_bytes_delta": int(wb1 - wb0),
            "qread_log_delta": int(ll1 - ll0),
            "mixed_reads_per_sec": round(m_reads, 1),
            "mixed_acked_writes_per_sec": round(m_writes, 1),
            "depth": DEPTH,
            "groups": G_q,
            "fsync": True}


def measure_watch_storm(ctx, sc_deadline):
    """Watch fan-out under write load, at the store plane the engine's
    appliers drive: W stream watchers spread over K keys, one writer
    mutating the keys round-robin with the write timestamp as the value,
    consumer threads draining the watcher queues. Reported: deliveries/s
    summed over all watchers and delivery staleness (write timestamp ->
    consumer dequeue) p50/p99. Host work: the card does none here."""
    import queue as _q
    import threading as _th

    from etcd_tpu_torch.store import HAVE_NATIVE_STORE, new_store

    W = int(os.environ.get("BENCH_WATCHERS",
                           100_000 if ctx.on_card else 25_000))
    K = int(os.environ.get("BENCH_WATCH_KEYS", 256))
    st_ = new_store(history_capacity=8192)
    watchers = [st_.watch(f"/storm/k{i % K}", recursive=False,
                          stream=True, since_index=0)
                for i in range(W)]
    end_t = max(time.time() + 5.0, sc_deadline - 2.0)
    stop = _th.Event()
    writes = [0]

    def writer():
        i = 0
        while not stop.is_set() and time.time() < end_t:
            st_.set_applied(f"/storm/k{i % K}", repr(time.time()),
                            None, False)
            i += 1
        writes[0] = i

    n_cons = 2
    delivered = [0] * n_cons
    stale = [[] for _ in range(n_cons)]

    def consumer(ci):
        part = watchers[ci::n_cons]
        got = 0
        samp = stale[ci]
        while True:
            moved = 0
            for w in part:
                # Bounded drain per watcher per pass: a hot watcher must
                # not starve the rest of the partition.
                for _k in range(32):
                    try:
                        e = w._q.get_nowait()
                    except _q.Empty:
                        break
                    got += 1
                    moved += 1
                    if got % 64 == 0 and e is not None and e.node:
                        try:
                            samp.append(time.time() - float(e.node.value))
                        except (TypeError, ValueError):
                            pass
            # Publish progress every pass and stop AT the window edge:
            # the backlog still queued is what the storm could not
            # deliver in time.
            delivered[ci] = got
            if stop.is_set() and moved == 0:
                break
            if time.time() > end_t + 5.0:
                break

    threads = [_th.Thread(target=writer, daemon=True)]
    threads += [_th.Thread(target=consumer, args=(ci,), daemon=True)
                for ci in range(n_cons)]
    t0 = time.time()
    for t in threads:
        t.start()
    while time.time() < end_t:
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=15.0)
    elapsed = time.time() - t0
    dps = sum(delivered) / elapsed
    wps = writes[0] / elapsed
    samp = [s for lst in stale for s in lst]
    p50, p99 = _pct(samp, 50), _pct(samp, 99)
    log(f"[watch_storm] {W} stream watchers over {K} keys "
        f"(native={HAVE_NATIVE_STORE}): {sum(delivered)} deliveries "
        f"in {elapsed:.2f}s -> {dps:,.0f}/s ({wps:,.0f} writes/s, "
        f"fan-out ~{W // K}/write); staleness p50 {p50} p99 {p99} "
        f"ms over {len(samp)} samples")
    return {"commits_per_sec": round(dps, 1),
            "deliveries_per_sec": round(dps, 1),
            "writes_per_sec": round(wps, 1),
            "staleness_p50_ms": p50,
            "staleness_p99_ms": p99,
            "p50_commit_latency_ms": p50,
            "p99_commit_latency_ms": p99,
            "watchers": W,
            "keys": K,
            "native_store": HAVE_NATIVE_STORE}


def measure_expiry_wave(ctx, sc_deadline):
    """Mass-TTL expiry through the engine: every tenant holds
    BENCH_TTL_KEYS keys expiring at the SAME instant; the host's sync
    scan stages one SYNC per due tenant, each SYNC commits through
    consensus and its apply sweeps the tenant's TTL heap. Reported:
    expired keys/s over the wave and the round-loop stall the wave adds
    (wave-round p99 vs quiesced-baseline p50)."""
    import tempfile

    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    from etcd_tpu_torch.server.request import Request

    P = int(os.environ.get("BENCH_PEERS", 5))
    G_x = int(os.environ.get("BENCH_EXPIRY_GROUPS",
                             min(ctx.G, 4096 if ctx.on_card else 512)))
    NK = int(os.environ.get("BENCH_TTL_KEYS", 16))
    with tempfile.TemporaryDirectory() as tmp:
        eng = MultiEngine(EngineConfig(
            groups=G_x, peers=P, data_dir=tmp, window=16, max_ents=4,
            heartbeat_tick=3, fsync=True, stagger=True,
            sync_interval=0.05, checkpoint_rounds=1 << 30,
            device=str(ctx.device)))
        _elect(eng)

        # Load NK TTL keys per tenant, all due at exp_at.
        exp_at = time.time() + max(
            3.0, min(8.0, 0.3 * (sc_deadline - time.time())))
        with eng._lock:
            for g in range(G_x):
                for i in range(NK):
                    rq = Request(method="PUT", path=f"/ttl/k{i}",
                                 val="v", expiration=exp_at,
                                 id=eng.reqid.next())
                    eng._pending[g].append(
                        (rq.id, b"\x00" + rq.encode(), rq))
                eng._dirty.add(g)
        for _ in range(2000):
            eng.run_round()
            with eng._lock:
                if not any(eng._pending[g] for g in range(G_x)):
                    break
        eng._drain_applies()
        loaded = G_x * NK

        # Baseline cadence on the idle engine until the wave is due.
        base_ms = []
        while time.time() < exp_at - 0.2 and len(base_ms) < 4000:
            t_r = time.perf_counter()
            eng.run_round()
            base_ms.append(1000 * (time.perf_counter() - t_r))
        while time.time() < exp_at:
            time.sleep(0.005)

        def unswept():
            return sum(1 for g in range(G_x)
                       if eng.store(g).next_expiration() is not None)

        # The wave: rounds until every tenant's TTL heap is empty.
        wave_ms = []
        t_w = time.time()
        r = 0
        left = G_x
        while time.time() < sc_deadline and r < 20000:
            t_r = time.perf_counter()
            eng.run_round()
            wave_ms.append(1000 * (time.perf_counter() - t_r))
            r += 1
            if r % 10 == 0:
                left = unswept()
                if left == 0:
                    break
        wave_elapsed = time.time() - t_w
        eng._drain_applies()
        if left:
            left = unswept()
        eng.stop()
    # delete_expired_keys sweeps a tenant's due keys atomically, so the
    # expired count is exact even on a deadline-truncated wave.
    expired = loaded - left * NK
    eps = expired / wave_elapsed if wave_elapsed > 0 else 0.0
    base_p50 = (round(float(np.percentile(base_ms, 50)), 3)
                if base_ms else None)
    wave_p99 = (round(float(np.percentile(wave_ms, 99)), 3)
                if wave_ms else None)
    log(f"[expiry_wave] G={G_x} x {NK} TTL keys: {expired} expired "
        f"in {wave_elapsed:.2f}s / {r} rounds -> {eps:,.0f} keys/s; "
        f"round p99 during wave {wave_p99} ms vs idle baseline p50 "
        f"{base_p50} ms ({left} tenants unswept)")
    return {"commits_per_sec": round(eps, 1),
            "expired_keys_per_sec": round(eps, 1),
            "ttl_keys": loaded,
            "unswept_tenants": int(left),
            "round_stall_ms": wave_p99,
            "baseline_round_p50_ms": base_p50,
            "p50_commit_latency_ms": base_p50,
            "p99_commit_latency_ms": wave_p99,
            "groups": G_x,
            "fsync": True}


# The direct leg's connections at most: the engine's front starts a thread
# per connection, and the sandbox of the H100 machines this bench runs on
# kills a process at its ~4,100th thread (a plain ThreadingHTTPServer and
# the engine alike, at 4,211-5,120 connections). The JAX bench's direct
# leg holds all CONNS (and collapses there: a handful of acks).
DIRECT_CONNS_MAX = 3_000


def _raise_nofile(need: int) -> None:
    """Raise the soft RLIMIT_NOFILE to the hard limit where `need`
    descriptors exceed it (the child processes inherit it)."""
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft >= need:
        return
    if hard != resource.RLIM_INFINITY and hard < need:
        log(f"RLIMIT_NOFILE hard limit {hard} is under the {need} "
            f"descriptors the connections need")
    resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    log(f"RLIMIT_NOFILE soft limit raised from {soft} to {hard}")


def measure_shallow_clients(ctx, sc_deadline, report=None):
    """The ingress tier under its reason-to-exist load: CONNS concurrent
    DEPTH-1 clients (each waits for its ack before its next write, the
    worst shape for a batching engine) against one engine process (fsync
    on). Interleaved A/B: the pipelined binary-channel ingress
    (flush_window frames in flight, native hot loop) vs a JSON ingress
    (--upstream-mode json --no-native: one JSON POST at a time),
    json/frame/json/frame, after one direct-to-engine leg over at most
    DIRECT_CONNS_MAX connections (it collapses under 10k depth-1 conns;
    a collapsed leg, or one over fewer connections, records a NULL
    ratio). The last leg SIGKILLs the pipelined ingress mid-leg and
    restarts it: every write acked to a client must still be readable
    from the engine afterwards (values are per-client monotone seqs, so
    stored seq >= last acked seq per key is exact). Ends with the hub
    fan-out phase: W stream watchers of ONE key through the ingress ride
    a single upstream stream. `report["launches_by_variant"]` gets the
    engine process's ring_resolve launches from its stop line."""
    import selectors as _selmod
    import shutil
    import socket as _sock
    import tempfile
    import urllib.request as _url

    CONNS = int(os.environ.get("BENCH_SHALLOW_CONNS", 10_000))
    D_CONNS = min(CONNS, DIRECT_CONNS_MAX)
    T = int(os.environ.get("BENCH_SHALLOW_TENANTS", 8))
    W_HUB = int(os.environ.get("BENCH_HUB_WATCHERS", 2_000))
    # The clients' sockets here; the ingress's upstream and clients there.
    _raise_nofile(CONNS + W_HUB + 1024)
    env = child_env()
    eport, iport, jport = free_ports(3)
    ebase = f"http://127.0.0.1:{eport}"
    work = tempfile.mkdtemp(prefix="bench-shallow-")
    engine_log = os.path.join(work, "engine.log")
    procs = []

    def boot_engine():
        with open(engine_log, "w") as f:
            p = subprocess.Popen(
                [sys.executable, "-m", "etcd_tpu_torch",
                 "--engine-groups", str(T), "--engine-peers", "3",
                 "--engine-device", ctx.device.type,
                 "--data-dir", os.path.join(work, "data"),
                 "--listen-client-urls", ebase],
                env=env, stdout=subprocess.DEVNULL, stderr=f)
        procs.append(p)
        dl = time.time() + 180
        while time.time() < dl:
            if p.poll() is not None:
                raise RuntimeError(f"shallow_clients: the engine exited "
                                   f"rc={p.returncode} while booting")
            try:
                with _url.urlopen(f"{ebase}/engine/status",
                                  timeout=2) as r:
                    stt = json.loads(r.read())
                if stt.get("groups_with_leader") == stt.get("groups"):
                    return p
            except Exception:  # noqa: BLE001 — still booting
                time.sleep(0.3)
        raise RuntimeError("shallow_clients: engine never led")

    def boot_ingress(port=iport, mode="frame"):
        # The json arm is the round-10 ingress: JSON single-POST
        # upstream AND the pure-Python hot loop, so
        # ingress_pipelined_vs_r10 measures the whole pipelined-channel
        # delta. The frame arm runs the full configuration.
        cmd = [sys.executable, "-m", "etcd_tpu_torch.server.ingress",
               "--upstream", ebase, "--port", str(port),
               "--upstream-mode", mode]
        if mode == "json":
            cmd.append("--no-native")
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL)
        procs.append(p)
        p.stdout.readline()            # its ready line
        return p

    # -- the depth-1 client harness (event-driven: this process holds
    # CONNS sockets without a thread per client). Every leg writes its
    # OWN key namespace (/l{leg}s{cid}) with per-leg seqs: a direct-leg
    # write that timed out client-side may commit much later and must
    # not overwrite a seq a later ingress leg acked.
    cur = {}    # run_leg installs {"prefix", "next", "acked", ...}

    class _C:
        __slots__ = ("sock", "cid", "buf", "need", "status", "out",
                     "seq", "t0", "dead")

        def __init__(self, cid):
            self.cid = cid
            self.buf = bytearray()
            self.out = b""
            self.need = -1
            self.seq = -1
            self.dead = False

    def _connect(port, n, tag):
        conns = []
        t_c = last_ok = time.time()
        while len(conns) < n:
            burst = min(96, n - len(conns))
            for _ in range(burst):
                c = _C(len(conns))
                s = _sock.socket()
                s.settimeout(10.0)
                try:
                    s.connect(("127.0.0.1", port))
                except OSError:
                    # A full listen queue: Linux drops the SYN and the
                    # connect retries by itself; some network stacks
                    # (the card machine's) refuse it instead. Back off
                    # and retry; a listener that takes no connection
                    # for 60 s is gone.
                    s.close()
                    if time.time() - last_ok > 60.0:
                        raise
                    time.sleep(0.1)
                    continue
                last_ok = time.time()
                s.setsockopt(_sock.IPPROTO_TCP, _sock.TCP_NODELAY, 1)
                s.setblocking(False)
                c.sock = s
                conns.append(c)
            # Pace the storm: the direct leg's thread-per-conn front
            # accepts at finite speed.
            time.sleep(0.02)
        log(f"[shallow_clients] {len(conns)} conns up ({tag}) in "
            f"{time.time() - t_c:.1f}s")
        return conns

    def _send_next(c, selx):
        c.seq = cur["next"][c.cid]
        cur["next"][c.cid] += 1
        body = f"value={c.cid}:{c.seq}"
        c.out += (
            f"PUT /tenants/{c.cid % T}/v2/keys/{cur['prefix']}"
            f"s{c.cid} HTTP/1.1\r\n"
            f"Host: b\r\nContent-Type: application/"
            f"x-www-form-urlencoded\r\n"
            f"Content-Length: {len(body)}\r\n\r\n{body}").encode()
        c.t0 = time.perf_counter()
        _flush_out(c, selx)

    def _flush_out(c, selx):
        try:
            while c.out:
                n = c.sock.send(c.out)
                c.out = c.out[n:]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            c.dead = True
            return
        try:
            selx.modify(c.sock, _selmod.EVENT_READ
                        | (_selmod.EVENT_WRITE if c.out else 0), c)
        except (KeyError, ValueError):
            pass

    def _feed(c):
        """Consume ONE complete response (depth-1: never more)."""
        if c.need < 0:
            i = c.buf.find(b"\r\n\r\n")
            if i < 0:
                return None
            head = bytes(c.buf[:i]).lower()
            c.status = int(c.buf[9:12])
            j = head.find(b"content-length:")
            clen = 0
            if j >= 0:
                e = head.find(b"\r\n", j)
                clen = int(head[j + 15:e if e >= 0 else len(head)])
            c.need = i + 4 + clen
        if len(c.buf) < c.need:
            return None
        del c.buf[:c.need]
        c.need = -1
        return c.status

    def run_leg(leg, port, leg_s, lat, kill_proc=None, n_conns=CONNS):
        """One measured leg. The clock starts after the connect storm
        completes; both modes get identical post-connect windows.
        Returns the leg's acked/errors/elapsed plus its acked-seq table
        and the seqs in flight when a connection died (the kill leg's
        audit needs both)."""
        cur.clear()
        cur.update(prefix=f"l{leg}", next=[0] * CONNS,
                   acked=[-1] * CONNS, dead_inflight={})
        conns = _connect(port, n_conns,
                         {eport: "direct", iport: "frame-ingress",
                          jport: "json-ingress"}.get(port, "?"))
        selx = _selmod.DefaultSelector()
        for c in conns:
            selx.register(c.sock, _selmod.EVENT_READ, c)
            _send_next(c, selx)
        t_meas = time.time()
        leg_end = t_meas + leg_s
        kill_at = t_meas + leg_s / 2.0 if kill_proc is not None else None
        acked = errors = 0
        killed = False
        dead_pool = []
        while time.time() < leg_end:
            if (kill_at is not None and not killed
                    and time.time() >= kill_at):
                kill_proc.kill()       # SIGKILL, mid-leg
                kill_proc.wait()
                killed = True
                boot_ingress(port, "frame")
                log("[shallow_clients] ingress SIGKILLed mid-leg "
                    "and restarted")
            for key, mask in selx.select(0.2):
                c = key.data
                if mask & _selmod.EVENT_READ:
                    try:
                        data = c.sock.recv(65536)
                    except (BlockingIOError, InterruptedError):
                        data = None
                    except OSError:
                        data = b""
                    if data == b"":
                        c.dead = True
                    elif data:
                        c.buf += data
                        stc = _feed(c)
                        if stc is not None:
                            if 200 <= stc < 300:
                                acked += 1
                                cur["acked"][c.cid] = c.seq
                                if acked % 16 == 0:
                                    lat.append(time.perf_counter() - c.t0)
                            else:
                                errors += 1
                            _send_next(c, selx)
                if not c.dead and (mask & _selmod.EVENT_WRITE):
                    _flush_out(c, selx)
                if c.dead:
                    # An in-flight write on a dying conn was never acked
                    # and must not count. Its seq is recorded: its batch
                    # may already have left the dead ingress and commit
                    # after newer acked writes (linearizability places
                    # an unacked op anywhere after its invocation); the
                    # audit exempts exactly that seq.
                    if c.seq > cur["acked"][c.cid]:
                        cur["dead_inflight"].setdefault(
                            c.cid, set()).add(c.seq)
                    try:
                        selx.unregister(c.sock)
                    except (KeyError, ValueError):
                        pass
                    c.sock.close()
                    dead_pool.append(c)
            # Resurrect killed-ingress casualties in small batches.
            if dead_pool and killed:
                batch, dead_pool[:] = dead_pool[:256], dead_pool[256:]
                for c in batch:
                    s = _sock.socket()
                    s.settimeout(2.0)
                    try:
                        s.connect(("127.0.0.1", port))
                    except OSError:
                        s.close()
                        dead_pool.append(c)
                        continue
                    s.setsockopt(_sock.IPPROTO_TCP, _sock.TCP_NODELAY, 1)
                    s.setblocking(False)
                    c.sock, c.dead = s, False
                    c.buf.clear()
                    c.out, c.need = b"", -1
                    selx.register(s, _selmod.EVENT_READ, c)
                    _send_next(c, selx)
        for c in conns:
            if not c.dead:
                try:
                    selx.unregister(c.sock)
                except (KeyError, ValueError):
                    pass
                c.sock.close()
        selx.close()
        return (acked, errors, time.time() - t_meas,
                cur["acked"], cur["dead_inflight"])

    def _drain_engine(max_s):
        """Barrier between legs: wait until the engine has no pending
        proposals, so a leg's timed-out writes do not steal the next
        leg's capacity."""
        dl = time.time() + max_s
        while time.time() < dl:
            try:
                with _url.urlopen(f"{ebase}/metrics", timeout=10) as r:
                    m = r.read().decode()
                pend = next(
                    (float(ln.rsplit(" ", 1)[1])
                     for ln in m.splitlines()
                     if ln.startswith("etcd_server_pending_proposal_total")),
                    0.0)
                if pend == 0.0:
                    return
            except Exception:  # noqa: BLE001 — engine busy
                pass
            time.sleep(1.0)
        log("[shallow_clients] drain barrier timed out "
            f"after {max_s:.0f}s — next leg may share capacity")

    try:
        boot_engine()
        frame_proc = boot_ingress(iport, "frame")
        boot_ingress(jport, "json")    # the comparison side
        # Warm both paths (first quorum round + route caches).
        for t in range(T):
            with _url.urlopen(_url.Request(
                    f"{ebase}/tenants/{t}/v2/keys/warm", method="PUT",
                    data=b"value=w",
                    headers={"Content-Type":
                             "application/x-www-form-urlencoded"}),
                    timeout=30) as r:
                r.read()

        # One direct leg, then the interleaved A/B json/frame/json/frame,
        # plus a dedicated KILL leg. Each leg's MEASURE window
        # (post-connect) is an equal share of what remains, overridable
        # via BENCH_SHALLOW_LEG_S. The kill leg is excluded from the
        # rates: half its window is a reconnect storm by design.
        span = max(20.0, (sc_deadline - time.time()) - 25.0)
        leg_s = float(os.environ.get("BENCH_SHALLOW_LEG_S", "0")) \
            or max(15.0, span / 6.0)
        d_acked = d_err = j_acked = j_err = i_acked = i_err = 0
        d_time = j_time = i_time = 0.0
        d_lat, j_lat, i_lat = [], [], []
        ingress_audits = []        # (leg, acked_tbl, dead_inflight)
        for leg, mode in enumerate(
                ("direct", "json", "frame", "json", "frame")):
            if mode == "direct":
                a, e, dt, _, _ = run_leg(leg, eport, leg_s, d_lat,
                                         n_conns=D_CONNS)
                d_acked += a
                d_err += e
                d_time += dt
            elif mode == "json":
                a, e, dt, atbl, dinf = run_leg(leg, jport, leg_s, j_lat)
                j_acked += a
                j_err += e
                j_time += dt
                ingress_audits.append((leg, atbl, dinf))
            else:
                a, e, dt, atbl, dinf = run_leg(leg, iport, leg_s, i_lat)
                i_acked += a
                i_err += e
                i_time += dt
                ingress_audits.append((leg, atbl, dinf))
            log(f"[shallow_clients] leg {leg} {mode}: {a} acked "
                f"({e} errors) in {dt:.1f}s measured")
            _drain_engine(120.0)
        kl = 5
        a, e, dt, atbl, dinf = run_leg(kl, iport, leg_s, [],
                                       kill_proc=frame_proc)
        ingress_audits.append((kl, atbl, dinf))
        log(f"[shallow_clients] kill leg: {a} acked ({e} errors) in "
            f"{dt:.1f}s measured (excluded from rates)")
        _drain_engine(120.0)

        # Zero-lost-acked-writes audit, per ingress leg: read every key
        # back from the ENGINE and compare against the last seq each
        # client saw acked (exempting a seq in flight on a dead conn).
        lost = 0
        stored = {}
        for t in range(T):
            with _url.urlopen(
                    f"{ebase}/tenants/{t}/v2/keys/?recursive=true",
                    timeout=60) as r:
                for nd in json.loads(r.read())["node"].get("nodes", []):
                    stored[(t, nd["key"])] = nd.get("value", "")
        for leg, atbl, dinf in ingress_audits:
            for cid in range(CONNS):
                if atbl[cid] < 0:
                    continue
                v = stored.get((cid % T, f"/l{leg}s{cid}"), "")
                got = int(v.split(":")[1]) if ":" in v else -1
                if got < atbl[cid] and got not in dinf.get(cid, ()):
                    lost += 1
        if lost:
            raise AssertionError(f"{lost} acked writes missing after "
                                 f"ingress SIGKILL — the "
                                 f"ack-after-upstream-ack contract is "
                                 f"broken")

        # Hub fan-out phase: W stream watchers of one key through the
        # ingress; ONE upstream stream serves them all.
        hub_deliveries = 0
        hub_events = 8
        hw_conns = []
        selx = _selmod.DefaultSelector()
        try:
            for i in range(W_HUB):
                s = _sock.socket()
                hw_conns.append(s)
                s.settimeout(10.0)
                s.connect(("127.0.0.1", iport))
                s.sendall(b"GET /tenants/0/v2/keys/hub?wait=true&stream="
                          b"true HTTP/1.1\r\nHost: b\r\n\r\n")
                s.setblocking(False)
                selx.register(s, _selmod.EVENT_READ, bytearray())
                if i % 96 == 95:
                    time.sleep(0.01)
            time.sleep(1.0)                    # all subscribed
            t_hub = time.time()
            for i in range(hub_events):
                with _url.urlopen(_url.Request(
                        f"http://127.0.0.1:{iport}/tenants/0/v2/keys/hub",
                        method="PUT", data=f"value=h{i}".encode(),
                        headers={"Content-Type":
                                 "application/x-www-form-urlencoded"}),
                        timeout=30) as r:
                    r.read()
            hub_end = time.time() + 20.0
            want = W_HUB * hub_events
            while hub_deliveries < want and time.time() < hub_end:
                for key, _m in selx.select(0.5):
                    try:
                        data = key.fileobj.recv(65536)
                    except OSError:
                        data = b""
                    if data:
                        key.data.extend(data)
                        n = key.data.count(b'"action"')
                        if n:
                            hub_deliveries += n
                            key.data.clear()
            hub_elapsed = time.time() - t_hub
            # Scrape WHILE the watchers are attached: the claim is W
            # live watchers over N upstream streams.
            with _url.urlopen(f"http://127.0.0.1:{iport}/metrics",
                              timeout=10) as r:
                mtx = r.read().decode()
            hub_streams = next(
                (float(ln.split()[-1]) for ln in mtx.splitlines()
                 if ln.startswith("etcd_ingress_hub_streams")), -1.0)
        finally:
            for s in hw_conns:
                s.close()
            selx.close()
        _stop_all(procs, timeout=60)
        with open(engine_log) as f:
            stops = [json.loads(ln.split(STOP_LINE, 1)[1]) for ln in f
                     if STOP_LINE in ln]
        if report is not None and stops:
            report["launches_by_variant"] = stops[-1]
    except BaseException:
        _stop_all(procs, timeout=10)
        if os.path.exists(engine_log):
            with open(engine_log, errors="replace") as f:
                log(f"[shallow_clients] failed; the engine's log ends:\n"
                    f"{f.read()[-4000:]}")
        raise
    finally:
        shutil.rmtree(work, ignore_errors=True)

    d_rate = d_acked / d_time if d_time else 0.0
    j_rate = j_acked / j_time if j_time else 0.0
    i_rate = i_acked / i_time if i_time else 0.0
    # A collapsed direct leg (a handful of acks) makes the ratio a
    # division artifact, and one over fewer connections compares
    # nothing: record NULL, never a six-figure "advantage".
    collapsed = d_rate < 1.0
    ratio = (None if collapsed or D_CONNS != CONNS
             else round(i_rate / d_rate, 2))
    r10_ratio = round(i_rate / j_rate, 2) if j_rate else None
    dp99, jp99 = _pct(d_lat, 99), _pct(j_lat, 99)
    ip50, ip99 = _pct(i_lat, 50), _pct(i_lat, 99)
    hub_rate = hub_deliveries / hub_elapsed if hub_elapsed else 0.0
    d_txt = ("direct: collapsed "
             f"({d_acked} acks in {d_time:.0f}s)" if collapsed
             else f"direct {d_rate:,.0f} acked/s over {D_CONNS} conns "
             f"-> {ratio}x")
    log(f"[shallow_clients] {CONNS} depth-1 conns, {T} tenants, "
        f"fsync on: pipelined ingress {i_rate:,.0f} acked/s vs "
        f"round-10 json ingress {j_rate:,.0f} acked/s -> "
        f"{r10_ratio}x (target >= 5x); {d_txt}; pipelined ack p50 "
        f"{ip50} p99 {ip99} ms (json p99 {jp99}, direct p99 "
        f"{dp99}); {lost} lost acked writes across SIGKILL; hub "
        f"{W_HUB} watchers x {hub_events} events -> "
        f"{hub_deliveries} deliveries ({hub_rate:,.0f}/s) over "
        f"{hub_streams:.0f} upstream stream(s)")
    return {"commits_per_sec": round(i_rate, 1),
            "direct_acked_per_sec": round(d_rate, 1),
            "direct_conns": D_CONNS,
            "direct_collapsed": collapsed,
            "ingress_acked_per_sec": round(i_rate, 1),
            "ingress_json_acked_per_sec": round(j_rate, 1),
            "ingress_vs_direct": ratio,
            "ingress_pipelined_vs_r10": r10_ratio,
            "ingress_ack_p50_ms": ip50,
            "ingress_ack_p99_ms": ip99,
            "ingress_json_ack_p99_ms": jp99,
            "direct_ack_p99_ms": dp99,
            "p50_commit_latency_ms": ip50,
            "p99_commit_latency_ms": ip99,
            "flush_window": 4,
            "hub_fanout": W_HUB,
            "hub_deliveries": int(hub_deliveries),
            "hub_deliveries_per_sec": round(hub_rate, 1),
            "hub_upstream_streams": int(hub_streams),
            "direct_errors": int(d_err),
            "ingress_json_errors": int(j_err),
            "ingress_errors": int(i_err),
            "lost_acked_writes": int(lost),
            "ingress_sigkilled": True,
            "conns": CONNS,
            "tenants": T,
            "fsync": True}


def _stop_all(procs, timeout) -> None:
    """SIGTERM every live process, wait up to `timeout` s each, then
    SIGKILL what is left."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def emit(results, order, G, P0, platform, device, power_w) -> None:
    """Print the CUMULATIVE result line after every scenario: if a later
    scenario overruns and the parent kills the child, the completed
    measurements already reached stdout (the consumer keeps the LAST
    line)."""
    primary = results[order[0]]
    out = {
        "metric": f"aggregate_commits_per_sec_{G}_groups_{P0}_peers",
        "value": primary["commits_per_sec"],
        "unit": "commits/s",
        "vs_baseline": round(primary["commits_per_sec"]
                             / BASELINE_WRITES_PER_SEC, 2),
        "p50_commit_latency_ms": primary["p50_commit_latency_ms"],
        "p99_commit_latency_ms": primary["p99_commit_latency_ms"],
        "round_ms": primary.get("round_ms_pipelined",
                                primary.get("round_ms_synced")),
        "rounds": primary.get("rounds_pipelined",
                              primary.get("rounds_synced")),
        "platform": platform,
        "device": device,
        "power_limit_w": power_w,
        "scenario": order[0],
        "scenarios": {k: v for k, v in results.items() if k != order[0]},
    }
    # The observability columns reach the artifact even when engine
    # leads the run (BENCH_SCENARIO=engine BENCH_OBS_AB=N).
    for extra in ("obs_overhead_pct", "obs_ab", "metrics_delta"):
        if extra in primary:
            out[extra] = primary[extra]
    print(json.dumps(out), flush=True)


def child_main() -> int:
    budget = float(os.environ.get("BENCH_BUDGET_S", 480.0))
    deadline = time.time() + budget * 0.9
    scenario = os.environ.get("BENCH_SCENARIO", "all")
    wanted = ORDER if scenario == "all" else scenario.split(",")
    if not set(wanted) <= set(ORDER):
        raise ValueError(f"BENCH_SCENARIO={scenario!r}: all, or one or "
                         f"more (comma-separated) of {', '.join(ORDER)}")
    dev = torch.device(bench_device())
    device_name, power_w = card_info(dev)
    platform = "gpu" if dev.type == "cuda" else "cpu"
    log(f"device: {dev} ({device_name}, power limit {power_w} W)")
    on_card = dev.type == "cuda"
    G = int(os.environ.get("BENCH_GROUPS", 100_000 if on_card else 8_192))
    P = int(os.environ.get("BENCH_PEERS", 5))
    rounds = int(os.environ.get("BENCH_ROUNDS", 300 if on_card else 60))
    warm = int(os.environ.get("BENCH_WARM_ROUNDS", 20 if on_card else 5))
    cfg = KernelConfig(groups=G, peers=P, window=16, max_ents=4,
                       election_tick=10, heartbeat_tick=3)
    ctx = Ctx(dev, cfg, np.random.default_rng(0), warm)

    # --- Phase 1: staggered elections converge in 3 rounds -----------------
    t0 = time.time()
    st, inbox, n_el = boot(cfg, dev)
    log(f"elections converged in {n_el} rounds ({time.time() - t0:.1f}s "
        f"incl the kernel's build)")

    order = [sc for sc in ORDER if sc in wanted]
    results = {}
    if scenario == "all" and not on_card \
            and "BENCH_LAT_GROUPS" not in os.environ:
        # On the CPU the latency scenario would repeat the engine
        # scenario's shape (G=2048, the same paced phase B): skip it with
        # a marker and let the others inherit its share. BENCH_LAT_GROUPS
        # (or selecting `latency`) still runs it.
        order.remove("latency")
        results["latency"] = {
            "skipped": "cpu-duplicate-of-engine-shape",
            "note": "engine scenario at the same G already reports the "
                    "50%-load p50/p99; set BENCH_LAT_GROUPS or run "
                    "`latency` directly to force a distinct shape"}
    remaining = deadline - time.time()
    shares = [WEIGHTS[sc] for sc in order]
    # Reallocate a dropped scenario's share instead of idling it.
    shares = [s / sum(shares) for s in shares]

    for i, (sc, share) in enumerate(zip(order, shares)):
        if i > 0 and time.time() > deadline - 5.0:
            log(f"budget exhausted; skipping scenarios {order[i:]}")
            break
        sc_deadline = min(time.time() + remaining * share, deadline)
        t_sc = time.time()
        snap0 = _metrics_snapshot()
        by0 = dict(ring_resolve.launches_by_variant)
        report = {}
        if sc == "engine":
            ab_pairs = int(os.environ.get("BENCH_OBS_AB", "0"))
            if ab_pairs:
                results[sc] = measure_obs_ab(ctx, sc_deadline, ab_pairs,
                                             report=report)
            else:
                results[sc] = measure_engine(ctx, sc_deadline,
                                             report=report)
        elif sc == "latency":
            # The per-card shard shape: 100k north-star groups / 8;
            # most of the budget goes to the paced 50%-load phase.
            G_lat = int(os.environ.get("BENCH_LAT_GROUPS",
                                       12_500 if on_card else 2048))
            results[sc] = measure_engine(ctx, sc_deadline, G_e=G_lat,
                                         sat_frac=0.35, label=sc,
                                         report=report)
            results[sc]["target_p99_ms"] = 10.0
        elif sc == "qread":
            results[sc] = measure_qread(ctx, sc_deadline)
        elif sc == "shallow_clients":
            results[sc] = measure_shallow_clients(ctx, sc_deadline,
                                                  report=report)
        elif sc == "watch_storm":
            results[sc] = measure_watch_storm(ctx, sc_deadline)
        elif sc == "expiry_wave":
            results[sc] = measure_expiry_wave(ctx, sc_deadline)
        elif sc == "zipf":
            results[sc], st, inbox = measure_zipf(ctx, st, inbox,
                                                  sc_deadline, rounds)
        elif sc == "churn":
            # BASELINE config 5 runs churn at SEVEN peers: a fresh 7-peer
            # state, the same generator.
            P7 = int(os.environ.get("BENCH_CHURN_PEERS", 7))
            ctx7 = ctx._replace(cfg=cfg._replace(peers=P7))
            st7, in7, _ = boot(ctx7.cfg, dev)
            res, st7, in7 = measure(ctx7, sc, st7, in7, sc_deadline, rounds)
            del st7, in7
            res["peers"] = P7
            results[sc] = res
        else:
            results[sc], st, inbox = measure(ctx, sc, st, inbox,
                                             sc_deadline, rounds)
        results[sc].setdefault("platform", platform)
        results[sc]["metrics_delta"] = _metrics_delta(
            snap0, _metrics_snapshot())
        launches = {k: ring_resolve.launches_by_variant[k] - by0[k]
                    for k in by0}
        if "launches_by_variant" in report:   # launched in the engine CLI
            launches = report.pop("launches_by_variant")
        log(SCENARIO_LINE + json.dumps({
            "scenario": sc, "seconds": round(time.time() - t_sc, 3),
            "launches_by_variant": launches, **report}))
        emit(results, order, G, P, platform, device_name, power_w)
    return 0


# ---------------------------------------------------------------------------
# Parent: streams the child's lines, ends it at its deadline
# ---------------------------------------------------------------------------

def _run_child(timeout_s: float):
    """Run the measurement child in its own session, STREAMING its
    cumulative JSON lines to our stdout as they appear. At `timeout_s`
    the child's whole session (its engine and ingress processes too) is
    killed. Returns (last line seen or None, the child's exit code)."""
    import selectors

    env = child_env()
    env["BENCH_CHILD"] = "1"
    p = subprocess.Popen([sys.executable, "-m", "etcd_tpu_torch.bench"],
                         env=env, stdout=subprocess.PIPE, stderr=None,
                         start_new_session=True)
    best = None
    deadline = time.time() + timeout_s

    def feed(raw: bytes):
        """Forward a candidate result line iff it is WHOLE, valid JSON:
        a kill can leave a truncated tail."""
        nonlocal best
        line = raw.decode(errors="replace").strip()
        if not (line.startswith("{") and '"metric"' in line):
            return
        try:
            json.loads(line)
        except ValueError:
            return
        best = line
        print(line, flush=True)

    sel = selectors.DefaultSelector()
    sel.register(p.stdout, selectors.EVENT_READ)
    buf = b""
    try:
        while True:
            if p.poll() is not None:
                buf += p.stdout.read() or b""
                break
            if time.time() > deadline:
                log(f"bench child timed out after {timeout_s:.0f}s")
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
                buf += p.stdout.read() or b""
                break
            if sel.select(timeout=0.5):
                chunk = os.read(p.stdout.fileno(), 65536)
                if not chunk:
                    p.wait()
                    break
                buf += chunk
            while b"\n" in buf:
                raw, buf = buf.split(b"\n", 1)
                feed(raw)
    finally:
        sel.close()
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    for raw in buf.splitlines():
        feed(raw)
    return best, p.returncode


def _regression_gate(line: str, artifact_dir=None) -> None:
    """Diff the final result against the newest artifact (BENCH_r{N}.json)
    and flag >20% same-workload drops LOUDLY. Comparisons are gated on
    matching platform AND device AND geometry (the metric name carries
    groups/peers; churn its own 'peers'; engine its own 'groups') so a
    workload, platform or card change reads as 'not comparable', never
    as a regression: the JAX package's TPU and CPU artifacts carry no
    "device" and never compare with a line of the port. On a flagged
    drop the LAST emitted line carries 'perf_regressions'."""
    import glob as _g
    import re as _re
    try:
        cur = json.loads(line)
    except ValueError:
        return
    root = artifact_dir or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    arts = sorted(
        _g.glob(os.path.join(root, "BENCH_r*.json")),
        key=lambda p: int(_re.search(r"r(\d+)",
                                     os.path.basename(p)).group(1)))
    prev = None
    for p in reversed(arts):
        try:
            with open(p) as f:
                cand = json.load(f).get("parsed")
            if cand and cand.get("value"):
                prev, prev_name = cand, os.path.basename(p)
                break
        except (ValueError, OSError):
            continue
    if prev is None:
        return
    flags = []

    def cmp(name, new, old, new_geom, old_geom, lower_better=False):
        if not new or not old:
            return
        if new_geom != old_geom:
            log(f"perf-gate: {name} not comparable to {prev_name} "
                f"({new_geom} vs {old_geom})")
            return
        # The same >20% rule both ways: throughput dropping below 0.8x,
        # or a lower-better column (latency) rising above 1/0.8 = 1.25x.
        worse = (new > old / 0.8) if lower_better else (new < 0.8 * old)
        if worse:
            pct = (new / old - 1) if lower_better else (1 - new / old)
            flags.append({"scenario": name, "now": new, "prev": old,
                          "prev_artifact": prev_name,
                          "drop_pct": round(100 * pct, 1)})

    plat = (cur.get("platform"), cur.get("device"))
    prev_plat = (prev.get("platform"), prev.get("device"))
    # The primary's metric string doesn't encode WHICH scenario led the
    # run (a BENCH_SCENARIO=engine run reuses it): gate on the scenario
    # name too.
    cmp("primary", cur.get("value"), prev.get("value"),
        (cur.get("metric"), cur.get("scenario"), plat),
        (prev.get("metric"), prev.get("scenario"), prev_plat))
    for sc, v in (cur.get("scenarios") or {}).items():
        o = (prev.get("scenarios") or {}).get(sc)
        if not o:
            continue
        geom_keys = {"churn": "peers", "engine": "groups",
                     "latency": "groups", "qread": "groups",
                     "expiry_wave": "groups",
                     "watch_storm": "watchers",
                     "shallow_clients": "conns"}.get(sc)
        # Geometry tuple: the scenario's own shape key where it has one,
        # the platform and device (a scenario's own platform key where
        # it has one, else the line's), AND the primary metric string —
        # zipf/lag inherit the top-level G/P.
        ng = (v.get(geom_keys) if geom_keys else None,
              (v.get("platform", plat[0]), plat[1]), cur.get("metric"))
        og = (o.get(geom_keys) if geom_keys else None,
              (o.get("platform", prev_plat[0]), prev_plat[1]),
              prev.get("metric"))
        cmp(sc, v.get("commits_per_sec"), o.get("commits_per_sec"),
            ng, og)
        # Writer-compartment columns, gated only when BOTH artifacts
        # carry them; the compartment's geometry is part of the tuple.
        wg_n = ng + (v.get("applier_shards"), v.get("wal_shards"))
        wg_o = og + (o.get("applier_shards"), o.get("wal_shards"))
        cmp(f"{sc}.deep_queue",
            v.get("deep_queue_acked_writes_per_sec"),
            o.get("deep_queue_acked_writes_per_sec"), wg_n, wg_o)
        for col in ("wal_fsync_p50_ms", "wal_fsync_p99_ms"):
            cmp(f"{sc}.{col}", v.get(col), o.get(col), wg_n, wg_o,
                lower_better=True)
        # Read/watch/expiry and ingress columns: advantage ratios gate a
        # >20% fall, lower-better tails a >25% rise.
        for col, lb in (("qread_vs_qget", False),
                        ("qread_p99_ms", True),
                        ("staleness_p99_ms", True),
                        ("round_stall_ms", True),
                        ("ingress_vs_direct", False),
                        ("ingress_pipelined_vs_r10", False),
                        ("ingress_ack_p99_ms", True)):
            cmp(f"{sc}.{col}", v.get(col), o.get(col), ng, og,
                lower_better=lb)
        # Instrumentation-overhead budget: at most 3% of deep-queue
        # throughput in its own interleaved A/B (absolute budget).
        ov = v.get("obs_overhead_pct")
        if ov is not None and ov > 3.0:
            flags.append({"scenario": f"{sc}.obs_overhead_pct",
                          "now": ov, "prev": 3.0,
                          "prev_artifact": "obs-overhead-budget",
                          "drop_pct": round(ov, 1)})
    # The overhead budget also applies when engine LED the run.
    ov0 = cur.get("obs_overhead_pct")
    if ov0 is not None and ov0 > 3.0:
        flags.append({"scenario": f"{cur.get('scenario')}.obs_overhead_pct",
                      "now": ov0, "prev": 3.0,
                      "prev_artifact": "obs-overhead-budget",
                      "drop_pct": round(ov0, 1)})
    if flags:
        for fl in flags:
            log(f"PERF REGRESSION vs {fl['prev_artifact']}: "
                f"{fl['scenario']} {fl['now']:,} vs {fl['prev']:,} "
                f"(-{fl['drop_pct']}%)")
        cur["perf_regressions"] = flags
        print(json.dumps(cur), flush=True)


def _warn_orphans() -> None:
    """A leaked `python -m etcd_tpu_torch` process (a timeout-killed test
    run's subprocess) shares this machine's cores and skews every number
    measured here. Warn loudly; kill them first with
    BENCH_KILL_ORPHANS=1 (safe on a dedicated bench box)."""
    try:
        out = subprocess.run(["ps", "-eo", "pid,args"], capture_output=True,
                             text=True, timeout=10).stdout
        orphans = [ln.split(None, 1) for ln in out.splitlines()
                   if ("-m etcd_tpu_torch" in ln or "multihost_engine" in ln)
                   and "etcd_tpu_torch.bench" not in ln]
        orphans = [(int(p), a) for p, a in orphans if int(p) != os.getpid()]
        if not orphans:
            return
        if os.environ.get("BENCH_KILL_ORPHANS") == "1":
            for pid, _ in orphans:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
            log(f"killed {len(orphans)} orphan engine process(es) "
                f"before measuring")
        else:
            log(f"WARNING: {len(orphans)} stray engine process(es) are "
                f"sharing this machine — numbers below are contended "
                f"(pids {[p for p, _ in orphans]}; "
                f"BENCH_KILL_ORPHANS=1 removes them)")
    except Exception:  # noqa: BLE001 — diagnostics must not break bench
        pass


def main() -> int:
    if os.environ.get("BENCH_CHILD") == "1":
        return child_main()
    require_device(bench_device(), "set BENCH_PLATFORM=cpu")
    _warn_orphans()
    budget = float(os.environ.get("BENCH_BUDGET_S", 480.0))
    line, rc = _run_child(timeout_s=budget + 15)
    if rc != 0 or line is None:
        log(f"bench child exited rc={rc}"
            + ("" if line else " without a result line"))
        return 1
    try:
        _regression_gate(line)
    except Exception as e:  # noqa: BLE001 — the gate must never
        log(f"perf-gate skipped: {e}")   # invalidate a measurement
    return 0


if __name__ == "__main__":
    sys.exit(main())
