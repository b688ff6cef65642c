"""MultiEngine: the batched MultiNode host engine — G Raft groups served
from one GPU, the serving path of the PyTorch/CUDA port.

This is the integrated run loop the reference implements per-process in
raft.MultiNode (raft/multinode.go:166-322) + raftNode (etcdserver/raft.go:
112-172), re-expressed for the batched round (etcd_tpu_torch/ops/kernel.py;
the JAX package's server/engine.py is the reference this file follows):

  one engine round =
    batch proposals -> kernel round launched on the card (CUDA launches
    are asynchronous; the round reads one quiescence flag back per hop)
    for all G x P -> flush the PREVIOUS round while the device computes: hand the
    round record to the WAL-writer compartment (walwriter.WALWriter, which
    group-commits queued rounds with ONE fsync on its own thread[s]), then
    hand committed entries to the applier pool — workers apply to the
    per-group stores and trigger client waiters only after the writer's
    durability watermark passes the round's ticket (acks strictly follow
    their round's fsync — the doc.go:31-39 ordering contract, enforced by
    GATING rather than inline ordering; the pipeline overlap is the
    batched form of the reference's apply/persist pipeline,
    etcdserver/raft.go:112-172) -> read back state deltas -> consume
    need_host flags (snapshot-install lagging followers via host-side
    state surgery). On the single-host crash model, letting round k+1's
    device step start before round k's fsync completes is safe: a crash
    truncates the WAL at a round boundary no client ever observed (applies
    may run ahead of durability, but acks never do, and in-memory store
    state dies with the process), and device state never survives a crash
    anyway.

Entry payloads never touch the device: the kernel commits (index, term)
metadata; payloads live in the host log store keyed (group, index, term) —
the Raft log-matching invariant makes that key unique, so leader turnover
overwrites at an index can never alias a committed payload. Leader no-op
entries are simply absent from the payload store and skip application.

Crash model: ALL P peer slots of a group live in this process, so a crash
is a whole-cluster crash — restart reconstructs every slot from the newest
checkpoint + WAL replay at the last durable round boundary. Nothing after
that boundary was ever acked to a client (applies happen after the WAL
fsync), so the restart is externally indistinguishable from a crash of a
real P-member cluster at that instant. This engine is the
single-host/multi-tenant serving path.

Device rule: every tensor lives on EngineConfig.device ("cuda" unless the
caller asks for "cpu"), or, with EngineConfig.mesh, on the mesh's cells
(parallel/mesh.py: each field is a `Sharded`, one block per cell, and the
round runs on every cell in lockstep, routing between cells by
all-to-all); host mirrors (h_*) are numpy copies, so applier threads
never touch device tensors. The WAL, geometry.json and checkpoint
formats are the JAX engine's, byte for byte: a data dir written by either
engine restarts in the other.

Membership changes are committed entries (reference multinode.go:181-218
CreateGroup-/RemoveGroup-at-commit semantics): applying one flips a bit in
the device peer_mask and resets the affected progress column; a joining
empty slot is then caught up by the leader (direct appends while within the
ring window, host snapshot-install beyond it).
"""
from __future__ import annotations

import contextlib
import json
import logging
import queue
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from etcd_tpu_torch import errors
from etcd_tpu_torch.server import obs as obs_mod
from etcd_tpu_torch.server.enginewal import (CONF_ADD, CONF_REMOVE, EngineWAL,
                                       RoundRecord, b64_np, np_b64)
from etcd_tpu_torch.server.walwriter import WALWriter
from etcd_tpu_torch.utils import metrics
from etcd_tpu_torch.server.request import (METHOD_DELETE, METHOD_GET, METHOD_POST,
                                     METHOD_PUT, METHOD_QGET, METHOD_SYNC,
                                     Request)
from etcd_tpu_torch.store import new_store
from etcd_tpu_torch.store.event import LazyWriteEvent
from etcd_tpu_torch.utils import idutil
from etcd_tpu_torch.utils.wait import Wait

log = logging.getLogger("etcd_tpu_torch.engine")

# Payload tags (first byte of every entry payload).
P_REQ = 0x00    # etcd v2 Request (JSON)
P_CONF = 0x01   # membership change (JSON {"id", "op", "slot"})
P_MULTI = 0x02  # batched Requests: u32 count, then (u32 len, Request JSON)*

_LEADER = 2  # ops.state.LEADER (kept in sync; imported lazily with torch)


try:
    from etcd_tpu_torch.native.walcodec import pack_multi as _c_pack_multi
except ImportError:          # pure-Python fallback (un-built tree)
    _c_pack_multi = None


def _pack_entry(items: List[tuple]) -> bytes:
    """One log entry's payload from its coalesced (rid, tagged-payload,
    ...) items: singletons keep their original tagged bytes (P_REQ/P_CONF,
    replay-compatible with pre-batching WALs); multi-request entries pack
    as P_MULTI + u32 count + (u32 len + Request JSON)*. The C packer
    (walcodec.pack_multi, byte-identical — tests/test_native.py) carries
    the deep-queue stage phase; the Python body is the un-built-tree
    fallback and the reference implementation."""
    if len(items) == 1:
        return items[0][1]
    if _c_pack_multi is not None:
        return _c_pack_multi(items, P_MULTI)
    out = [bytes([P_MULTI]), struct.pack("<I", len(items))]
    for it in items:
        blob = it[1][1:]            # strip the P_REQ tag
        out.append(struct.pack("<I", len(blob)))
        out.append(blob)
    return b"".join(out)


def _unpack_multi(payload: bytes) -> List[bytes]:
    (n,) = struct.unpack_from("<I", payload, 1)
    off = 5
    blobs = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", payload, off)
        off += 4
        blobs.append(payload[off:off + ln])
        off += ln
    return blobs


# What MultiEngine._range returns when no profiler runs.
_NO_RANGE = contextlib.nullcontext()


def _host(t) -> np.ndarray:
    """A tensor's values as a fresh numpy array (never a view of a CPU
    tensor: host mirrors are mutated in place, device state never)."""
    return t.to("cpu", copy=True).numpy()


class EngineViolation(RuntimeError):
    """A consensus safety violation detected by the kernel (NH_VIOLATION:
    an append conflicted with a committed entry — the condition the
    reference panics on in log.maybeAppend). The engine dumps the affected
    groups' state and refuses to continue; state after this point cannot
    be trusted."""


@dataclass
class EngineConfig:
    groups: int
    peers: int
    data_dir: str
    window: int = 32
    max_ents: int = 8
    election_tick: int = 10
    heartbeat_tick: int = 3
    fsync: bool = True
    checkpoint_rounds: int = 2048     # rounds between full checkpoints
    request_timeout: float = 5.0
    # How often the host scans tenant stores for DUE TTL expirations and
    # stages a replicated SYNC into those groups (reference SyncTicker,
    # etcdserver/server.go:667-681; expiry must ride the log so replay
    # after restart deletes identically). 0 disables.
    sync_interval: float = 0.5
    # Max client requests coalesced into ONE log entry (group commit). The
    # device commits (index, term) metadata only, so entry payloads are
    # free to carry many requests — this is what lets a hot tenant drain
    # max_ents*batch_max writes per round while the on-device ring stays
    # statically shaped (the Zipf-skew answer; the reference's analogue is
    # batching many Ready entries into one WAL fsync, wal.go:459-487).
    # The REAL cap is bytes (batch_bytes, mirroring the reference's 1MB
    # maxSizePerMsg, etcdserver/raft.go:48): a hot tenant's admission
    # scales with its queue depth up to ~max_ents MB/round instead of
    # pinning at a fixed request count.
    batch_max: int = 4096
    batch_bytes: int = 1 << 20
    round_interval: float = 0.0       # seconds between rounds (0 = flat out)
    ticks_per_round: int = 1          # logical clock rate
    stagger: bool = True              # deterministic fast first election
    initial_peers: Optional[int] = None  # active slots at fresh boot (<= peers)
    # Tenants (groups) provisioned at fresh boot. None = all `groups` (the
    # pre-lifecycle behavior); smaller values leave the rest of the pool
    # inactive (peer_mask all-false: no elections, no ticks) for runtime
    # create_tenant()/remove_tenant() — the engine's CreateGroup/
    # RemoveGroup (reference raft/multinode.go:181-218), without
    # recompilation: the kernel shape is the POOL, liveness is the mask.
    initial_tenants: Optional[int] = None
    # Optional parallel.mesh.Mesh with ("groups", "peers") axes: the
    # kernel state shards over it and the per-hop message routing becomes
    # an all-to-all between the cells of a groups row — the multi-device
    # serving path. The state then lives on the mesh's devices and
    # `device` is ignored. None = one device.
    mesh: Any = None
    # Where the consensus state lives and the rounds run: "cuda" (the
    # card; the default) or "cpu" (tests). A "cuda" engine on a machine
    # without a card refuses to start.
    device: str = "cuda"
    # Store applies + client acks run on a dedicated applier thread,
    # decoupling the round cadence (device step + WAL fsync + diff) from
    # the O(committed requests) Python apply work — the engine's version
    # of the reference's separate apply goroutine (etcdserver/raft.go:
    # 112-172 hands committed entries to the server loop and only waits
    # at the NEXT Ready). False = apply inline each round (deterministic
    # single-thread mode).
    pipeline_applies: bool = True
    # Backpressure: how many rounds of committed-but-unapplied work may
    # queue at the applier before the round loop blocks. Bounds ack
    # latency at ~(this+1) x apply-time-per-round under saturation.
    # With applier_shards > 1 this bounds the DEEPEST shard's backlog,
    # not the sum — one hot shard cannot borrow the others' budget.
    apply_queue_rounds: int = 2
    # Compartmentalized applier pool (PAPERS.md "Scaling Replicated
    # State Machines with Compartmentalization"): partition each round's
    # committed-entry view by tenant range into this many shards, each
    # applied+acked by its own worker thread. storecore.c releases the
    # GIL around batched mutations and every shard owns a disjoint set
    # of tenant stores, so K workers make real parallel progress on a
    # multi-core box while per-group apply order stays FIFO (a group
    # lives in exactly one shard). 1 = today's single-applier behavior.
    applier_shards: int = 1
    # WAL-writer compartment (walwriter.WALWriter): the round loop hands
    # each non-empty RoundRecord to a dedicated writer stage and steps
    # the device ahead; the writer group-commits queued rounds (ONE
    # fsync covers every round queued when it starts) and publishes a
    # durability watermark that applier workers gate acks on — fsync
    # leaves the round loop's critical path without weakening the
    # ack-after-fsync contract. False = the pre-compartment behavior:
    # append+fsync inline in the round loop before applies (rounds that
    # carry conf flips do this regardless — device surgery must follow
    # a durable record).
    pipeline_wal: bool = True
    # Per-tenant-range WAL segment streams (aligned with applier_shards
    # ranges): each RoundRecord splits into per-range sub-records
    # appended to its range's own stream by its own writer thread, so S
    # fsyncs proceed in parallel on a multi-core box. Replay reassembles
    # the streams at the consistent round boundary (min over stream
    # tails) and truncates whole records beyond it. 1 = one stream, in
    # the pre-compartment root-dir layout (byte-compatible). The value
    # is pinned in geometry.json; an existing dir may go 1 -> S once
    # (the root stream freezes as legacy history) but never change
    # between sharded values.
    wal_shards: int = 1
    # Backpressure: rounds that may queue at a writer shard before
    # submit() blocks. Deeper = bigger group commits under load; ack
    # latency stays bounded at ~(this x append + 1 fsync).
    wal_queue_rounds: int = 64
    # Message hops chained inside ONE kernel invocation. 3 = propose -> replicate ->
    # commit completes within the round it was staged, cutting ack
    # latency from ~4 round-trips to ~1.5 (kernel.step_routed_auto).
    hops: int = 3
    # Compact readback (kernel.step_routed_compact): the round's state
    # diff is computed ON DEVICE and the host reads back a (G, P) uint8
    # flag map plus values for only the rows that changed, instead of
    # the full O(G*P*W) state every round (32 MB of ring alone at
    # G=100k, copied over PCIe every round otherwise). Rounds that change
    # more rows than compact_cap — or that raise need_host — fall back to
    # the full readback, so saturated throughput is untouched. None =
    # auto (enabled when mesh is None); the mesh path keeps the full
    # readback.
    compact_readback: Optional[bool] = None
    # Max changed+staged rows served by the gather path before a round
    # falls back to full readback. 0 = auto: max(2048, G*P//8).
    compact_cap: int = 0
    # Liveness watchdog cadence (rounds): every N rounds verify the
    # DEVICE peer_mask still equals the host h_mask and repair it from
    # the host copy if not. Membership only ever flows host -> device
    # (_apply_conf / _restore surgery), so any divergence is device
    # buffer corruption. A corrupt mask is a PERMANENT wedge (it silences
    # every cross-slot send and suppresses campaigns), so the check is on
    # by default as defense-in-depth; it costs one (G, P) bool readback
    # per N rounds. 0 disables.
    mask_check_rounds: int = 64
    # Leader-lease read fast path (OFF by default). After a ReadIndex
    # round confirms a group's leader, quorum reads arriving within the
    # next read_lease_ms milliseconds skip the confirmation round and
    # park directly at the current commit mirror. This trades the strict
    # message-proven ReadIndex guarantee for the classic clock-bound
    # lease assumption (bounded drift: a deposed leader's host notices
    # within the lease window); 0 keeps every quorum read on the full
    # confirmation path.
    read_lease_ms: int = 0


class _AckCounter:
    """Mutable ack tally. _apply_committed increments whichever tally it
    is handed — a shard worker's own, or the engine's synchronous-path
    one — so the counters need no locking (one writer each) and
    MultiEngine.acked_requests sums them. `rids`, where it is a list,
    collects the request ids the synchronous path triggered inline, for
    the per-write stage counters."""

    __slots__ = ("acked", "rids")

    def __init__(self) -> None:
        self.acked = 0
        self.rids: Optional[List[int]] = None


class _AckBatch:
    """Deferred waiter wakeups: an applier worker collects its pass's
    (rid, result) triggers and ack tally here instead of firing them
    inline, then releases everything after wait_durable(ticket) — the
    apply work may run AHEAD of the WAL pipeline (stores are in-memory
    and die with the process anyway), but no client observes a result
    before its round's record is fsynced (doc.go:31-39). Synchronous
    paths pass no sink and keep the inline trigger."""

    __slots__ = ("items", "acked")

    def __init__(self) -> None:
        self.items: List[Tuple[int, Any]] = []
        self.acked = 0


class _ApplierShard:
    """One compartment of the applier pool: a worker thread owning the
    contiguous tenant range [g_lo, g_hi), with its own commit-view
    queue, its own backpressure/condition variable, and its own ack
    tally. Shards share no mutable state except disjoint slices of
    engine.applied and disjoint tenant stores, so K workers drive K
    GIL-releasing storecore batch applies in true parallel."""

    __slots__ = ("idx", "g_lo", "g_hi", "cv", "q", "stop", "exc",
                 "thread", "acct")

    def __init__(self, idx: int, g_lo: int, g_hi: int) -> None:
        self.idx = idx
        self.g_lo = g_lo
        self.g_hi = g_hi
        self.cv = threading.Condition()
        self.q: deque = deque()
        self.stop = False
        self.exc: Optional[Exception] = None
        self.thread: Optional[threading.Thread] = None
        self.acct = _AckCounter()


class MultiEngine:
    """G consensus groups stepped by the batched kernel, served as G
    independent etcd v2 keyspaces ("tenants")."""

    def __init__(self, cfg: EngineConfig) -> None:
        # torch imports deferred so constructing configs stays cheap.
        import torch
        from etcd_tpu_torch.ops import kernel
        from etcd_tpu_torch.ops.state import KernelConfig, LEADER

        assert LEADER == _LEADER
        self._torch, self._kernel = torch, kernel
        # On a mesh the engine's own tensors (proposal counts, the drop
        # mask) start on the first cell's device; each cell takes its part.
        self.device = torch.device(cfg.device if cfg.mesh is None
                                   else cfg.mesh.devices[0][0])
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"EngineConfig.device={cfg.device!r} but no CUDA device "
                    "is available; pass device='cpu' to run on the CPU")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.cfg = cfg
        self.kcfg = KernelConfig(
            groups=cfg.groups, peers=cfg.peers, window=cfg.window,
            max_ents=cfg.max_ents, election_tick=cfg.election_tick,
            heartbeat_tick=cfg.heartbeat_tick)
        G, P, W = cfg.groups, cfg.peers, cfg.window

        # The three round programs (ops/kernel.py): quiescent rounds (the
        # serving steady state) take the one-pass fast path, election /
        # term-change rounds the full sequential path — chosen per hop,
        # bit-identical trajectories. cfg.hops chains propose -> replicate
        # -> commit inside one call; the drop mask rides into the round so
        # fault injection cuts every hop.
        # On a mesh (parallel/mesh.py) each round runs on every cell's
        # block in lockstep, one thread per cell.
        # comm_stats counts one cell's comm calls and their wall time.
        self.comm_stats = None
        if cfg.mesh is not None:
            from etcd_tpu_torch.parallel.comm import CommStats
            self.comm_stats = CommStats()

        def _round(fn):
            if cfg.mesh is not None:
                from etcd_tpu_torch.parallel.mesh import mesh_round
                return lambda st, inbox, pc, ps, t: mesh_round(
                    fn, self.kcfg, st, inbox, pc, ps, t, self._drop(),
                    self.cfg.hops, stats=self.comm_stats)
            return lambda st, inbox, pc, ps, t: fn(
                self.kcfg, st, inbox, pc, ps, t, self._drop(),
                self.cfg.hops)

        self._step_fn = _round(kernel.step_variant("step_routed_auto"))
        self._compact = (cfg.compact_readback if cfg.compact_readback
                         is not None else cfg.mesh is None)
        if cfg.mesh is not None:
            self._compact = False    # see EngineConfig.compact_readback
        self._compact_cap = cfg.compact_cap or max(2048, G * P // 8)
        # Set whenever device state was mutated WITHOUT updating the
        # h_* mirrors (the snapshot-install surgery leaves mirrors stale
        # on purpose so the NEXT round's full diff journals the install,
        # _service_need_host). A compact diff is device-vs-device and
        # would never see the surgery — the next round must take the
        # full-readback path to re-sync mirrors and journal it.
        self._force_full = False
        # Count of peer_mask watchdog repairs (EngineConfig.
        # mask_check_rounds); >0 means the device mask diverged from the
        # host's and was restored.
        self.mask_repairs = 0
        self._step_fn_c = _round(kernel.step_variant("step_routed_compact"))
        # The ReadIndex step (the zero-append read plane): the same
        # routed round plus a forced leader heartbeat and a per-group
        # read-quorum tally — one extra (G,) confirmed flag and one (G,)
        # captured commit index come back with the state.
        self._step_fn_r = _round(
            kernel.step_variant("step_routed_read_auto"))

        # Geometry guard BEFORE anything touches the data dir: a mismatch
        # must refuse the dir before the WAL opens/creates any file in it.
        self._check_geometry()
        self.wait = Wait()
        self.reqid = idutil.Generator(1)
        self._pending: List[deque] = [deque() for _ in range(G)]
        self._dirty: set = set()            # groups with queued proposals
        self._confs_outstanding = 0         # enqueued, not-yet-applied
        # Per group: the entries staged this round, each a list of
        # (request id, tagged payload) items coalesced into one log entry.
        # g -> (leader_slot, [entry batches]) staged this round
        self._staged: Dict[int, Tuple[int, list]] = {}
        # The read plane's two parking lots (both under self._lock):
        # _reads holds quorum reads waiting for a ReadIndex confirmation
        # (rid, Request); _ripe holds confirmed reads waiting for the
        # apply cursor to reach their read index (rid, Request, index).
        # The waiting counters let run_round skip the plane when idle,
        # and the dirty sets bound per-round scans to active groups.
        self._reads: List[deque] = [deque() for _ in range(G)]
        self._read_dirty: set = set()
        self._ripe: List[deque] = [deque() for _ in range(G)]
        self._ripe_dirty: set = set()
        self._reads_waiting = 0
        self._ripe_waiting = 0
        # Leader-lease fast path state (cfg.read_lease_ms): per-group
        # monotonic-clock deadline and the term the lease was granted
        # under — a lease dies with its term.
        self._lease_until = np.zeros(G, np.float64)
        self._lease_term = np.zeros(G, np.int64)
        self._stores: Dict[int, Any] = {}
        self._lock = threading.Lock()       # guards _pending/_dirty enqueue
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.round_no = 0
        self.round_ms_ewma = 0.0   # smoothed wall time per round
        # Cumulative seconds since construction, never reset (a reader
        # takes the difference of two copies); one thread at a time
        # writes a key. Key families:
        # - the round's phases, on the round thread: "stage", "dispatch",
        #   "readback", "record", "wal_submit", "tail", and "apply" on
        #   the synchronous path;
        # - "apply" (a one-shard pool) or "apply[k]": applier shard k's
        #   passes;
        # - "wal_fsync" or "wal_fsync[k]": the WAL writer threads, which
        #   hold this dict from construction on;
        # - with the observability plane on (ETCD_TPU_OBS): the round's
        #   seconds blocked on the card, "dispatch.wait" (a part of
        #   dispatch + readback), and each write's path from submit to
        #   ack, summed over the acked writes: "ack.queue", "ack.round",
        #   "ack.apply", "ack.gate" and the COUNT of writes "ack.writes",
        #   suffixed "[k]" when applier shard k acked them (unsuffixed:
        #   the synchronous path). See _ack_account. And the COUNTS of
        #   the round's hops by branch, "hop.fused", "hop.quiet" and
        #   "hop.full" (ops/kernel.py's hop_counts).
        self.phase_s: Dict[str, float] = {}
        # Observability plane (obs.py): per-compartment Prometheus
        # series with children pre-bound to this engine's shard
        # geometry, the round flight recorder, and the sampled proposal
        # tracer. Constructed before the WAL writer and applier pool so
        # both compartments can record into it. ETCD_TPU_OBS=off keeps
        # it inert (the overhead A/B's baseline side).
        self.obs = obs_mod.EngineObs(
            wal_shards=max(1, min(cfg.wal_shards, G)),
            applier_shards=max(1, min(cfg.applier_shards, G)))
        # Requests admitted into this round's entries / sampled rids
        # admitted this round (round-thread-private, reset per round).
        self._last_admitted = 0
        self._trace_rids: List[int] = []
        # Each client write's stamps, rid -> [t_submit, t_staged,
        # t_admitted] (perf_counter), from do/submit_many until its
        # waiter is triggered or given up; None with the plane off. One
        # dict operation per access, so the GIL is the lock.
        self._ack_t: Optional[Dict[int, list]] = (
            {} if self.obs.enabled else None)
        # When this round took _pending, and the seconds it spent reading
        # gathered rows back (round-thread-private).
        self._t_staged = 0.0
        self._rows_wait = 0.0
        # Host ranges on the profiler's clock (see _range).
        self._prof = torch.autograd.profiler
        # The WAL compartment: submit() hands records to the writer
        # stage; acks gate on its durability watermark (wait_durable).
        # Constructed after phase_s — the writer threads profile into it.
        self.wal = WALWriter(cfg.data_dir, groups=G,
                             shards=cfg.wal_shards, fsync=cfg.fsync,
                             queue_rounds=cfg.wal_queue_rounds,
                             phase_s=self.phase_s, obs=self.obs)
        # Last few durable round records, kept for the violation dump.
        self._recent_recs: deque = deque(maxlen=8)
        self.failed: Optional[Exception] = None
        # Applier pool (cfg.pipeline_applies): committed spans are handed
        # off as immutable views and applied+acked concurrently with the
        # next rounds' device steps and WAL fsyncs (both of which release
        # the GIL, so the appliers make real progress under them). With
        # applier_shards=K the tenant pool is partitioned into K
        # contiguous ranges — shard k owns [k*ceil(G/K), ...), the same
        # convention scripts/pool_serve.py uses — each applied by its own
        # worker. Empty tail shards (K not dividing G) get no thread.
        K = max(1, min(cfg.applier_shards, G))
        per = -(-G // K)
        self._appliers = [
            _ApplierShard(k, min(k * per, G), min((k + 1) * per, G))
            for k in range(K)]
        self._appliers = [sh for sh in self._appliers if sh.g_lo < sh.g_hi]
        # Acks from synchronous applies (conf rounds, pipeline off,
        # restore); shard workers tally into their own counters.
        self._acks = _AckCounter()
        if self.obs.enabled:
            self._acks.rids = []
        self._last_sync_scan = 0.0
        # g -> redeadline for the one in-flight SYNC allowed per tenant.
        self._sync_pending: Dict[int, float] = {}
        # Tenant-lifecycle admin ops: (op dict, done Event, result dict),
        # processed at a round boundary by the engine loop; acks fire only
        # after the record carrying the flips is fsynced.
        self._admin_q: deque = deque()
        self._admin_flips: List[Tuple[int, int, int]] = []
        self._admin_acks: List[threading.Event] = []
        # Per-slot lifecycle generation: bumped on every create/remove so
        # frontends can invalidate per-tenant caches (an HTTP layer that
        # cached handlers for generation k must not serve a recycled slot's
        # generation k+1 keyspace through them).
        self.tenant_gen = np.zeros(G, np.int64)

        # Host mirrors of the last read-back device state.
        self.h_term = np.zeros((G, P), np.int32)
        self.h_vote = np.zeros((G, P), np.int32)
        self.h_commit = np.zeros((G, P), np.int32)
        self.h_state = np.zeros((G, P), np.int32)
        self.h_last = np.zeros((G, P), np.int32)
        self.h_ring = np.zeros((G, P, W), np.int32)
        self.h_mask = np.zeros((G, P), bool)
        self.applied = np.zeros(G, np.int64)
        self.payloads: Dict[Tuple[int, int, int], bytes] = {}
        # Live-path sidecar of self.payloads: the already-decoded Requests
        # of an admitted entry, so the apply loop skips re-parsing JSON it
        # produced moments ago (restart replay decodes from bytes). Popped
        # at apply; GC'd with the payload store.
        self.payload_reqs: Dict[Tuple[int, int, int], list] = {}

        ckpt_round, ckpt = self.wal.load_checkpoint()
        # Full consumption also positions the writer (next segment seq) and
        # seeds the rolling CRC for appends.
        recs = list(self.wal.replay(after_round=ckpt_round))
        if ckpt is not None or recs:
            self._restore(ckpt_round, ckpt, recs)
        else:
            from etcd_tpu_torch.ops.state import init_state
            self.st = init_state(self.kcfg, n_peers=self._boot_peers(),
                                 stagger=cfg.stagger, device=self.device)
            self.h_mask = _host(self.st.peer_mask)
        self.inbox = torch.zeros((G, P, P, self.kcfg.fields),
                                 dtype=torch.int32, device=self.device)
        if cfg.mesh is not None:
            from etcd_tpu_torch.parallel.mesh import (shard_mailbox,
                                                      shard_state)
            self.st = shard_state(self.st, cfg.mesh)
            self.inbox = shard_mailbox(self.inbox, cfg.mesh)
        # Chaos hook: (G, P_to, P_from, 1)-broadcastable 0/1 mask applied to
        # the routed inbox (tests inject drops/partitions here); a numpy
        # array or a tensor.
        self.drop_mask = None

    def _drop(self):
        """The drop mask as an int32 tensor on the engine's device."""
        if self.drop_mask is None:
            return None
        return self._torch.as_tensor(self.drop_mask, dtype=self._torch.int32,
                                     device=self.device)

    def _boot_peers(self):
        """Per-group active-slot counts at fresh boot: the first
        initial_tenants groups get initial_peers (or all P) slots, the
        rest of the pool stays unprovisioned (all-false mask rows)."""
        n = self.cfg.initial_peers or self.cfg.peers
        if self.cfg.initial_tenants is None:
            return n
        arr = np.zeros(self.cfg.groups, np.int32)
        arr[:min(self.cfg.initial_tenants, self.cfg.groups)] = n
        return arr

    def _check_geometry(self) -> None:
        """Persist (groups, peers, window) beside the WAL and refuse a
        restart with different values — the checkpoint/WAL arrays are
        shaped by them, and restoring a (G,P)-shaped checkpoint into a
        different-shaped state would crash at best and silently corrupt
        consensus state at worst. (max_ents shapes only the mailbox, not
        persisted state, so it may change.)"""
        import os
        from etcd_tpu_torch.utils.fileutil import touch_dir_all
        touch_dir_all(self.cfg.data_dir)
        self._grew_from: Optional[int] = None
        path = os.path.join(self.cfg.data_dir, "geometry.json")
        S = max(1, min(self.cfg.wal_shards, self.cfg.groups))
        want = {"groups": self.cfg.groups, "peers": self.cfg.peers,
                "window": self.cfg.window, "wal_shards": S}

        def write(d):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(d, f)
            os.replace(tmp, path)

        if os.path.exists(path):
            with open(path) as f:
                have = json.load(f)
            # WAL shard layout is pinned separately from the array
            # shapes: an unsharded dir (including pre-wal_shards dirs,
            # where the key is absent) may upgrade 1 -> S once — the
            # root stream freezes as legacy history and new records go
            # to the shard streams. Any OTHER change is refused: a
            # shrunk/re-grown stream set would leave frozen streams
            # whose stale tails drag the min-over-streams replay
            # boundary below live records forever.
            have_ws = have.pop("wal_shards", 1)
            core = {k: want[k] for k in ("groups", "peers", "window")}
            if have_ws != S and have_ws != 1:
                raise ValueError(
                    f"engine data dir {self.cfg.data_dir} was written "
                    f"with wal_shards={have_ws}, refusing to open with "
                    f"wal_shards={S} — the segment-stream layout may "
                    "only go 1 -> S once; move the data dir aside or "
                    "match the flag")
            if have != core:
                # The pool may GROW (tenant lifecycle: restart with more
                # groups; restore pads the arrays, WAL group ids stay
                # valid). Peer/window shapes and shrinking still refuse.
                if (have["peers"] == core["peers"]
                        and have["window"] == core["window"]
                        and core["groups"] > have["groups"]):
                    # Remember the old pool size: groups beyond it were
                    # never provisioned, whatever the boot defaults say.
                    self._grew_from = have["groups"]
                    write(want)
                    return
                raise ValueError(
                    f"engine data dir {self.cfg.data_dir} was initialized "
                    f"with geometry {have}, refusing to open with {core} — "
                    "move the data dir aside or match the flags (only the "
                    "group pool may grow)")
            if have_ws != S:
                write(want)
        else:
            write(want)

    def _dev(self, name: str, arr) -> Any:
        """Host array -> a fresh tensor on the engine's device, in the
        dtype of state field `name` (the int64-carried prng lanes
        included); on a mesh, sharded in the field's layout (host-surgery
        writebacks keep every field in its cells)."""
        torch = self._torch
        dtype = (torch.bool if name in ("paused", "peer_mask") else
                 torch.int64 if name == "prng" else torch.int32)
        x = torch.tensor(np.asarray(arr), dtype=dtype, device=self.device)
        if self.cfg.mesh is not None:
            from etcd_tpu_torch.parallel.mesh import Sharded, state_sharding
            x = Sharded.split(self.cfg.mesh, x,
                              getattr(state_sharding(self.cfg.mesh), name))
        return x

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------

    def _restore(self, ckpt_round: int, ckpt: Optional[dict],
                 recs: List[RoundRecord]) -> None:
        """Rebuild host mirrors + device state from checkpoint + WAL replay.
        Every slot restarts as a follower with its replayed log, term, vote
        and commit (reference RestartNode semantics, raft/node.go:186-192)."""
        from etcd_tpu_torch.ops.state import init_state
        G, P, W = self.cfg.groups, self.cfg.peers, self.cfg.window

        base = init_state(self.kcfg, n_peers=self._boot_peers(),
                          stagger=self.cfg.stagger, device=self.device)
        self.h_mask = _host(base.peer_mask)
        if self._grew_from is not None:
            # Pool slots added by a post-boot growth were never
            # provisioned — the checkpoint pad and the WAL both know
            # nothing of them.
            self.h_mask[self._grew_from:] = False
        def pool_pad(a):
            """Pad checkpoint arrays along the group axis when the pool
            grew since the checkpoint (new slots: zeroed, unprovisioned)."""
            if a.shape[0] < G:
                pad = np.zeros((G - a.shape[0],) + a.shape[1:], a.dtype)
                return np.concatenate([a, pad], axis=0)
            return a

        if ckpt is not None:
            self.h_term = pool_pad(b64_np(ckpt["term"]).astype(np.int32))
            self.h_vote = pool_pad(b64_np(ckpt["vote"]).astype(np.int32))
            self.h_commit = pool_pad(b64_np(ckpt["commit"])
                                     .astype(np.int32))
            self.h_last = pool_pad(b64_np(ckpt["last"]).astype(np.int32))
            self.h_ring = pool_pad(b64_np(ckpt["ring"]).astype(np.int32))
            self.h_mask = pool_pad(b64_np(ckpt["mask"]).astype(bool))
            self.applied = pool_pad(b64_np(ckpt["applied"])
                                    .astype(np.int64))
            for g_s, blob in ckpt["stores"].items():
                st = new_store(namespaces=("/0", "/1"))
                st.recovery(blob.encode())
                self._stores[int(g_s)] = st
            for g, i, t, b64p in ckpt["payloads"]:
                import base64 as _b64
                self.payloads[(g, i, t)] = _b64.b64decode(b64p)

        # Per-slot log terms reconstructed from history: the final ring only
        # covers the last W entries, but the restart apply span can reach
        # further back (committed-but-unapplied suffix). Seed from the
        # checkpoint's ring, then track BOTH ring deltas (term rewrites —
        # conflicts always change the term) and last_index advances (a
        # same-term append leaves its ring slot's VALUE unchanged when it
        # aliases an equal-term entry, so it is only visible as growth).
        slot_log: Dict[Tuple[int, int], Dict[int, int]] = {}

        def _log_set(g, p, i, t):
            slot_log.setdefault((int(g), int(p)), {})[int(i)] = int(t)

        if ckpt is not None:
            for g in range(G):
                for p in range(P):
                    lastv = int(self.h_last[g, p])
                    for w in range(W):
                        i = lastv - ((lastv - w) % W)
                        if i >= 1:
                            _log_set(g, p, i, self.h_ring[g, p, w])

        last_round = ckpt_round
        for rec in recs:
            last_round = max(last_round, rec.round_no)
            gi = rec.hs_g.astype(np.int64)
            pi = rec.hs_p.astype(np.int64)
            self.h_term[gi, pi] = rec.hs_term
            self.h_vote[gi, pi] = rec.hs_vote
            self.h_commit[gi, pi] = rec.hs_commit
            # Ring deltas first: the round's appends need the post-round
            # ring to resolve their terms.
            gi = rec.ring_g.astype(np.int64)
            pi = rec.ring_p.astype(np.int64)
            self.h_ring[gi, pi, rec.ring_i.astype(np.int64) % W] = rec.ring_t
            for g, p, i, t in zip(rec.ring_g, rec.ring_p, rec.ring_i,
                                  rec.ring_t):
                _log_set(g, p, i, t)
            for g, p, new in zip(rec.last_g.astype(np.int64),
                                 rec.last_p.astype(np.int64),
                                 rec.last_v.astype(np.int64)):
                prev = int(self.h_last[g, p])
                self.h_last[g, p] = new
                for i in range(max(prev + 1, int(new) - W + 1), int(new) + 1):
                    _log_set(g, p, i, self.h_ring[g, p, i % W])
            for g, i, t, payload in rec.entries:
                self.payloads[(g, i, t)] = payload
            for g, slot, op in rec.confs:
                self.h_mask[g, slot] = (op == CONF_ADD)
                if op == CONF_ADD:
                    # Live _apply_conf zeroes a joining slot's state (it may
                    # have a stale former life); replay must match, or the
                    # restarted slot would claim a log it no longer has.
                    self.h_term[g, slot] = 0
                    self.h_vote[g, slot] = 0
                    self.h_commit[g, slot] = 0
                    self.h_last[g, slot] = 0
                    self.h_ring[g, slot] = 0
                    slot_log.pop((int(g), int(slot)), None)
                elif not self.h_mask[g].any():
                    # This REMOVE flip deprovisioned the tenant: replay the
                    # host-side reset AT THIS POINT in the flip sequence —
                    # a remove+re-create batched into the same record must
                    # reset between the two, or the re-created tenant's
                    # fresh indices land below the stale apply cursor and
                    # acked writes vanish while old data resurfaces.
                    g = int(g)
                    self.applied[g] = 0
                    self._stores.pop(g, None)
                    for k in [k for k in self.payloads if k[0] == g]:
                        del self.payloads[k]
        self.round_no = last_round + 1

        # Device state: followers everywhere, logs/HS restored.
        self.st = base._replace(
            term=self._dev("term", self.h_term),
            vote=self._dev("vote", self.h_vote),
            commit=self._dev("commit", self.h_commit),
            last_index=self._dev("last_index", self.h_last),
            log_term=self._dev("log_term", self.h_ring),
            peer_mask=self._dev("peer_mask", self.h_mask),
        )
        self.h_state = np.zeros((G, P), np.int32)  # all followers
        # Committed terms across ALL slots: where committed, every slot's
        # log agrees at an index (log matching), so any slot with
        # commit >= i supplies THE term. Zero terms are placeholder slots
        # (e.g. zeroed by a snapshot install) and are skipped.
        hist: Dict[Tuple[int, int], int] = {}
        for (g, p), entries in slot_log.items():
            c = int(self.h_commit[g, p])
            lastv = int(self.h_last[g, p])
            for i, t in entries.items():
                if t > 0 and i <= c and i <= lastv:
                    hist.setdefault((g, i), t)
        # Re-apply the committed-but-unapplied suffix; hist supplies entry
        # terms older than the live ring window.
        self._apply_committed(trigger=False, hist=hist)
        self._gc_payloads()
        # Admitted-but-uncommitted conf entries survive restart in the
        # payload store; the committed-conf scan must stay armed for them
        # (its short-circuit would otherwise skip binding the mask flip
        # into the committing round's durable record).
        self._confs_outstanding = sum(
            1 for (g, i, t), p in self.payloads.items()
            if p and p[0] == P_CONF and i > self.applied[g])

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._install_flight_signal()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="multi-engine")
        self._thread.start()

    def dump_flight(self, reason: str = "manual") -> Optional[str]:
        """Write the flight-recorder ring as Chrome trace-event JSON
        under <data_dir>/diagnostics; returns the path (None on
        failure). Also reachable via SIGUSR2 and GET /debug/flight."""
        return self.obs.flight.dump(self.cfg.data_dir, reason)

    def _install_flight_signal(self) -> None:
        """SIGUSR2 -> flight dump. Best-effort: only the main thread
        may install handlers (tests start engines from worker threads),
        and with several engines in one process the last one started
        owns the signal — the /debug/flight endpoint and fail-stop
        auto-dump cover the rest."""
        import signal as _signal
        if not hasattr(_signal, "SIGUSR2"):
            return
        try:
            _signal.signal(_signal.SIGUSR2,
                           lambda _s, _f: self.dump_flight("sigusr2"))
        except ValueError:
            pass

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                # A wedged device round still owns the WAL and the applier
                # queue; draining or closing under it would race.
                log.error("engine thread did not stop in 10s; leaving "
                          "final round unflushed")
                return
        if self.failed is None:
            try:
                self._drain_applies()
            except Exception as e:  # noqa: BLE001 — applier's deferred error
                self.failed = e
        for sh in self._appliers:
            with sh.cv:
                sh.stop = True
                sh.cv.notify_all()
        for sh in self._appliers:
            if sh.thread is not None:
                sh.thread.join(timeout=10)
        # Parked quorum reads can never ripen once the round loop is
        # down; fail them now instead of letting clients ride out the
        # request timeout.
        self._fail_parked_reads("engine stopped")
        self.wal.close()
        if self._ack_t is not None:
            self._ack_t.clear()     # writes never acked leave no stamps

    # ------------------------------------------------------------------
    # applier pool (cfg.pipeline_applies, cfg.applier_shards)
    # ------------------------------------------------------------------

    @property
    def acked_requests(self) -> int:
        """Client REQUESTS acked in LIVE rounds (not entries: a batched
        entry carries many; restart replay does not count). The
        serving-throughput counter — meters measure deltas. Summed across
        the synchronous path and every applier shard's own tally."""
        return self._acks.acked + sum(sh.acct.acked
                                      for sh in self._appliers)

    def _commit_view(self) -> tuple:
        """Immutable snapshot of what the applier needs from this round's
        mirrors: per-group commit (masked max over live slots), the slot
        holding it, the ring/last arrays it resolves terms from, and the
        WAL durability ticket ack release gates on (wait_durable). The
        mirror arrays are replaced (never mutated) each round, so handing
        references across threads is safe. The trailing round number is
        for the flight recorder's applied/acked marks."""
        c = np.where(self.h_mask, self.h_commit, 0)
        return (c.max(axis=1), c.argmax(axis=1), self.h_ring, self.h_last,
                self.wal.ticket, self.round_no)

    def _ensure_appliers(self) -> None:
        for sh in self._appliers:
            t = sh.thread
            if t is None or not t.is_alive():
                if sh.exc is not None:
                    # The worker HALTed mid-span; respawning would
                    # re-apply (and re-ack) the queued view from the
                    # top. Stay down — the seam re-raises.
                    continue
                sh.stop = False
                sh.thread = threading.Thread(
                    target=self._applier_loop, args=(sh,), daemon=True,
                    name=f"engine-applier-{sh.idx}")
                sh.thread.start()

    def _applier_loop(self, sh: _ApplierShard) -> None:
        # Phase key: "apply" for the single-shard pool (keeps profiles
        # comparable with pre-pool captures), "apply[k]" per worker
        # otherwise — each key has exactly one writer thread.
        pkey = "apply" if len(self._appliers) == 1 else f"apply[{sh.idx}]"
        rng = f"engine.{pkey}"
        # The stage counters of the writes this shard acks ("[k]" always:
        # the unsuffixed keys are the synchronous path's).
        akey = f"[{sh.idx}]"
        o = self.obs if self.obs.enabled else None
        tr = self.obs.tracer
        while True:
            with sh.cv:
                while not sh.q and not sh.stop:
                    sh.cv.wait(0.2)
                if not sh.q:
                    return           # stop requested and queue drained
                view = sh.q[0]       # stays queued while in progress
            t0 = time.perf_counter()
            try:
                with self._range(rng):
                    # Applies run ahead of the WAL pipeline; the acks
                    # they produce are collected and released only once
                    # the view's durability ticket clears the writer's
                    # watermark (ack-after-fsync, gated not ordered).
                    batch = _AckBatch()
                    self._apply_committed(trigger=True, view=view,
                                          g_lo=sh.g_lo, g_hi=sh.g_hi,
                                          acct=sh.acct, sink=batch)
                    if o:
                        o.flight.mark(view[5], obs_mod.APPLIED)
                    if batch.acked or batch.items:
                        t_gate = time.perf_counter()
                        self.wal.wait_durable(view[4])
                        if o:
                            o.h_ack_wait.observe(time.perf_counter()
                                                 - t_gate)
                        if tr.every:
                            for rid, _res in batch.items:
                                tr.mark(rid, "durable", ticket=view[4])
                        for rid, res in batch.items:
                            self.wait.trigger(rid, res)
                            if tr.every:
                                tr.mark(rid, "acked")
                        sh.acct.acked += batch.acked
                        if o:
                            o.c_acked.inc(batch.acked)
                            o.h_appl_batch[sh.idx].observe(batch.acked)
                            o.flight.mark(view[5], obs_mod.ACKED)
                            self._ack_account(
                                akey, [rid for rid, _res in batch.items],
                                t_gate, time.perf_counter())
            except Exception as e:  # noqa: BLE001 — re-raised at the seam
                log.exception("engine applier shard %d failed", sh.idx)
                self.obs.flight.dump(self.cfg.data_dir,
                                     f"applier-shard-{sh.idx}")
                with sh.cv:
                    sh.exc = e
                    sh.cv.notify_all()
                # HALT — consuming further views after a mid-span failure
                # would re-apply and re-ack around the hole. The engine
                # fail-stops at the next enqueue/drain, which re-raises.
                return
            self.phase_s[pkey] = self.phase_s.get(pkey, 0.0) + \
                (time.perf_counter() - t0)
            with sh.cv:
                sh.q.popleft()
                sh.cv.notify_all()

    def _ack_account(self, sfx: str, rids: List[int], t_applied: float,
                     t_acked: float) -> None:
        """Pop the stamps of the writes whose waiters one apply pass just
        triggered and add their stages to phase_s, the key suffix `sfx`
        "[k]" for applier shard k and "" for the synchronous path:

        - ack.queue  += t_staged - t_submit: waiting in _pending;
        - ack.round  += t_admitted - t_staged: the round that admits it
          (stage, dispatch, readback, record);
        - ack.apply  += t_applied - t_admitted: the WAL hand-off, the
          round's tail, the applier queue, a later round's commit if it
          lags, and the apply pass;
        - ack.gate   += t_acked - t_applied: the durability gate and the
          waiter triggers;
        - ack.writes += 1 for each: a count, kept in this dict of
          seconds because readers window phase_s alone.

        The boundaries are the Tracer's marks submit, admitted, applied
        and acked, each taken once per call, round or pass."""
        acks = self._ack_t
        q = r = a = 0.0
        n = 0
        for rid in rids:
            w = acks.pop(rid, None)
            if w is None:
                continue    # not a client write, or its client gave up
            q += w[1] - w[0]
            r += w[2] - w[1]
            a += t_applied - w[2]
            n += 1
        if not n:
            return
        ph = self.phase_s
        for key, v in (("ack.queue", q), ("ack.round", r), ("ack.apply", a),
                       ("ack.gate", (t_acked - t_applied) * n),
                       ("ack.writes", n)):
            key += sfx
            ph[key] = ph.get(key, 0.0) + v

    def _enqueue_apply(self, view: tuple) -> None:
        """Hand one round's committed work to every applier shard,
        blocking while the DEEPEST shard's backlog is at the cap (bounds
        ack latency under saturation; a sum-bound would let one hot
        shard spend the other shards' latency budget)."""
        self._ensure_appliers()
        o = self.obs if self.obs.enabled else None
        for sh in self._appliers:
            with sh.cv:
                while (len(sh.q) >= self.cfg.apply_queue_rounds
                       and sh.exc is None):
                    sh.cv.wait(0.5)
                sh.q.append(view)
                if o:
                    o.g_appl_queue[sh.idx].set(len(sh.q))
                sh.cv.notify_all()
        self._raise_apply_exc()

    def _drain_applies(self) -> None:
        """Block until every queued apply on every shard finished; then
        surface any applier error. All synchronous seams (conf changes,
        checkpoints, admin surgery, stop) come through here before
        touching state the appliers also own (stores, applied, payload
        GC)."""
        for sh in self._appliers:
            if sh.thread is not None:
                with sh.cv:
                    while (sh.q and sh.exc is None
                           and sh.thread.is_alive()):
                        sh.cv.notify_all()
                        sh.cv.wait(0.5)
        self._raise_apply_exc()
        for sh in self._appliers:
            if sh.q and (sh.thread is None or not sh.thread.is_alive()):
                raise RuntimeError(
                    f"applier shard {sh.idx} died with work queued")

    def _raise_apply_exc(self) -> None:
        # sh.exc stays set: a HALTed shard is terminally failed (its
        # worker never respawns — see _ensure_appliers), so EVERY later
        # seam re-raises rather than letting one caller absorb the
        # error and the next one sail past a dead compartment.
        for sh in self._appliers:
            if sh.exc is not None:
                raise sh.exc

    def store(self, g: int):
        s = self._stores.get(g)
        if s is None:
            # Lock: HTTP handler threads race the engine apply thread on
            # first touch of a tenant; an unsynchronized check-then-set
            # could discard a Store already holding applied writes.
            # Namespaces match the classic server's store (reference
            # store.New(StoreClusterPrefix, StoreKeysPrefix)) so an empty
            # tenant serves GET /v2/keys/ identically.
            with self._lock:
                s = self._stores.get(g)
                if s is None:
                    s = self._stores[g] = new_store(namespaces=("/0", "/1"))
        return s

    def leader_slot(self, g: int) -> int:
        """The group's current leader slot, or -1. Only ACTIVE slots count —
        a just-removed slot's device row freezes in whatever state it held
        (reference removed-member tombstones make its traffic inert the same
        way, server.go:387-391)."""
        row = np.where(self.h_mask[g], self.h_state[g], 0)
        idx = np.nonzero(row == _LEADER)[0]
        return int(idx[0]) if len(idx) else -1

    def wait_leaders(self, timeout: float = 30.0, groups=None) -> bool:
        """Block until every (requested) PROVISIONED group has a leader —
        unprovisioned pool slots have no peers and never elect."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            gs = (np.nonzero(self.h_mask.any(axis=1))[0]
                  if groups is None else groups)
            if all(self.leader_slot(int(g)) >= 0 for g in gs):
                return True
            time.sleep(0.005)
        return False

    def do(self, g: int, r: Request, timeout: Optional[float] = None) -> Any:
        """Serve one request against group g (the engine's Do,
        reference server.go:519-576). Reads are local; writes ride the
        kernel's consensus."""
        if r.method == METHOD_GET:
            if r.quorum:
                if not r.wait:
                    # The zero-append read plane: ReadIndex confirmation
                    # + local serve; no log entry, no WAL bytes, no
                    # fsync. (A quorum WATCH still rides the propose
                    # path below, unchanged.)
                    return self._quorum_read(g, r, timeout)
                r = Request(**{**r.__dict__, "method": METHOD_QGET})
            elif r.wait:
                return self.store(g).watch(r.path, r.recursive, r.stream,
                                           r.since)
            else:
                return self.store(g).get(r.path, r.recursive, r.sorted)
        if r.method not in (METHOD_PUT, METHOD_POST, METHOD_DELETE,
                            METHOD_QGET, METHOD_SYNC):
            raise errors.EtcdError(errors.ECODE_INVALID_FORM,
                                   cause=f"bad method {r.method}")
        if r.id == 0:
            r = Request(**{**r.__dict__, "id": self.reqid.next()})
        obs_on = self.obs.enabled
        tr = self.obs.tracer
        acks = self._ack_t
        if tr.every:
            tr.mark(r.id, "submit", g=g)
        q = self.wait.register(r.id)
        if acks is not None:
            acks[r.id] = [time.perf_counter(), 0.0, 0.0]
        payload = bytes([P_REQ]) + r.encode()
        with self._lock:
            # The decoded Request rides along so the live apply path never
            # re-parses JSON it already has (replay still decodes bytes).
            self._pending[g].append((r.id, payload, r))
            self._dirty.add(g)
        # Reference proposal metrics (etcdserver/metrics.go), previously
        # observed only by the legacy server.py path.
        if obs_on:
            metrics.propose_pending.inc()
        t0 = time.perf_counter()
        try:
            result = q.get(timeout=timeout or self.cfg.request_timeout)
        except queue.Empty:
            if obs_on:
                metrics.propose_failed.inc()
            self.wait.cancel(r.id)
            if acks is not None:
                acks.pop(r.id, None)
            raise errors.EtcdError(errors.ECODE_RAFT_INTERNAL,
                                   cause="request timed out",
                                   index=int(self.applied[g]))
        finally:
            if obs_on:
                metrics.propose_pending.dec()
        if obs_on:
            metrics.propose_durations.observe(
                (time.perf_counter() - t0) * 1000.0)
        if isinstance(result, errors.EtcdError):
            # Application-level error (e.g. a failed CAS) — served, not
            # a failed proposal; propose_failed counts only proposals
            # that never produced a result.
            raise result
        if type(result) is LazyWriteEvent:
            # The ack/waiter stage woke us with raw C descriptors; the
            # Event/NodeExtern churn happens HERE, on the serving thread,
            # off the (serialized) apply stage.
            return result.resolve()
        return result

    def do_many(self, g: int, reqs: List[Request],
                timeout: Optional[float] = None) -> List[Any]:
        """Serve a BATCH of write requests against group g from one
        caller (the ingress tier's coalesced submission surface): all of
        them are enqueued under ONE lock acquisition, so the next round's
        staging packs them into deep P_MULTI log entries — the exact
        multi-request packing `do()` traffic already coalesces into, which
        keeps the WAL format and replay path unchanged (an entry written
        through this path is indistinguishable from one that coalesced
        out of N concurrent `do()` calls).

        Returns one result per request, in request order. Application
        errors (failed CAS, auth, timeout) come back IN-SLOT as EtcdError
        instances instead of raising — the caller is a demultiplexer that
        must fan each slot's outcome back to a different waiting client,
        so one bad request must never poison its batch-mates. Results are
        only produced after the engine's ack path released the waiters,
        i.e. after this batch's round is fsync-durable — an ingress crash
        after `do_many` returns can never lose an acked write."""
        return self.collect_many(g, self.submit_many(g, reqs), timeout)

    def submit_many(self, g: int, reqs: List[Request]) -> List[tuple]:
        """The NON-BLOCKING half of do_many: validate, assign request
        ids, register wait queues and stage everything under one lock
        acquisition — then return immediately with the (rid, queue)
        tokens collect_many() blocks on. The batchframe channel
        (etcdhttp/tenants.py) submits frame N+1 through this before
        frame N's round has committed, which is what lets a pipelined
        ingress window keep the staging queue deep instead of draining
        it to zero between flushes. Submission order IS log-staging
        order per group, so frames submitted in channel-arrival order
        keep the lane's FIFO."""
        for r in reqs:
            if r.method not in (METHOD_PUT, METHOD_POST, METHOD_DELETE,
                                METHOD_QGET, METHOD_SYNC):
                raise errors.EtcdError(errors.ECODE_INVALID_FORM,
                                       cause=f"bad batch method {r.method}")
        obs_on = self.obs.enabled
        tr = self.obs.tracer
        acks = self._ack_t
        t_submit = time.perf_counter() if acks is not None else 0.0
        items = []
        queues = []
        for r in reqs:
            if r.id == 0:
                r = Request(**{**r.__dict__, "id": self.reqid.next()})
            if tr.every:
                tr.mark(r.id, "submit", g=g)
            queues.append((r.id, self.wait.register(r.id)))
            if acks is not None:
                acks[r.id] = [t_submit, 0.0, 0.0]
            items.append((r.id, bytes([P_REQ]) + r.encode(), r))
        with self._lock:
            self._pending[g].extend(items)
            if items:
                self._dirty.add(g)
        if obs_on:
            for _ in range(len(items)):
                metrics.propose_pending.inc()
        return queues

    def collect_many(self, g: int, queues: List[tuple],
                     timeout: Optional[float] = None) -> List[Any]:
        """The BLOCKING half of do_many: gather one result per submitted
        (rid, queue) token, in submission order, timing out slots that
        never produce one. Only returns results the ack path released —
        i.e. after their round's fsync."""
        obs_on = self.obs.enabled
        n = len(queues)
        t0 = time.perf_counter()
        deadline = t0 + (timeout or self.cfg.request_timeout)
        out = []
        try:
            for rid, q in queues:
                try:
                    result = q.get(
                        timeout=max(0.0, deadline - time.perf_counter()))
                except queue.Empty:
                    if obs_on:
                        metrics.propose_failed.inc()
                    self.wait.cancel(rid)
                    if self._ack_t is not None:
                        self._ack_t.pop(rid, None)
                    out.append(errors.EtcdError(
                        errors.ECODE_RAFT_INTERNAL,
                        cause="request timed out",
                        index=int(self.applied[g])))
                    continue
                if type(result) is LazyWriteEvent:
                    result = result.resolve()
                out.append(result)
        finally:
            if obs_on:
                for _ in range(n):
                    metrics.propose_pending.dec()
        if obs_on and n:
            # One batch = one client-visible submission window; the
            # per-request proposal latency is the window's mean.
            dt = (time.perf_counter() - t0) * 1000.0 / n
            for _ in range(n):
                metrics.propose_durations.observe(dt)
        return out

    # ------------------------------------------------------------------
    # the read plane (batched ReadIndex; zero-append quorum reads)
    # ------------------------------------------------------------------

    def _mirror_term(self, g: int) -> int:
        return int(np.where(self.h_mask[g], self.h_term[g], 0).max())

    def _mirror_commit(self, g: int) -> int:
        return int(np.where(self.h_mask[g], self.h_commit[g], 0).max())

    def _quorum_read(self, g: int, r: Request,
                     timeout: Optional[float] = None) -> Any:
        """Linearizable GET without a log entry (the reference's
        ReadIndex protocol, raft read_only.go, batched over all G
        groups): park the read, let the next round's ReadIndex step
        confirm the group's leader still holds a quorum and capture its
        commit index, then serve from the local store once the apply
        cursor reaches that index. Quorum reads leave the
        etcd_server_proposal_* families entirely (nothing is proposed)
        and meter the read_index_* families instead."""
        if r.id == 0:
            r = Request(**{**r.__dict__, "id": self.reqid.next()})
        obs_on = self.obs.enabled
        tr = self.obs.tracer
        if tr.every:
            tr.mark(r.id, "submit", g=g)
        q = self.wait.register(r.id)
        t0 = time.perf_counter()
        with self._lock:
            lease_ms = self.cfg.read_lease_ms
            if (lease_ms > 0
                    and time.monotonic() < float(self._lease_until[g])
                    and int(self._lease_term[g]) == self._mirror_term(g)):
                # Lease fast path: a confirmation round within the lease
                # window proved leadership, and the lease term still
                # matches — skip the confirmation and park directly at
                # the CURRENT commit mirror (>= every acked write's
                # index, so acked writes stay visible).
                self._ripe[g].append((r.id, r, self._mirror_commit(g)))
                self._ripe_dirty.add(g)
                self._ripe_waiting += 1
                if obs_on:
                    self.obs.c_reads_lease.inc()
            else:
                self._reads[g].append((r.id, r))
                self._read_dirty.add(g)
                self._reads_waiting += 1
            if obs_on:
                self.obs.g_read_parked.inc()
        try:
            result = q.get(timeout=timeout or self.cfg.request_timeout)
        except queue.Empty:
            if obs_on:
                self.obs.c_reads_failed.inc()
            self.wait.cancel(r.id)
            raise errors.EtcdError(errors.ECODE_RAFT_INTERNAL,
                                   cause="quorum read timed out",
                                   index=int(self.applied[g]))
        finally:
            if obs_on:
                self.obs.g_read_parked.dec()
        if obs_on:
            self.obs.s_read_dur.observe(
                (time.perf_counter() - t0) * 1000.0)
        if isinstance(result, errors.EtcdError):
            raise result
        return result

    def _confirm_reads(self, read_take: Dict[int, int], conf: np.ndarray,
                       rc: np.ndarray) -> None:
        """Move snapshotted parked reads of confirmed groups to the ripe
        queue at this round's captured read index. Only the
        PRE-DISPATCH snapshot count moves — a read that parked after the
        step was dispatched could postdate a write acked at a commit
        index above the captured one, so it waits for its own round.
        Unconfirmed groups keep their reads parked: a deposed leader's
        reads either re-confirm under the next leader (at its >= read
        index — still linearizable) or time out; never served stale."""
        o = self.obs if self.obs.enabled else None
        n_conf = 0
        now = time.monotonic()
        lease_s = self.cfg.read_lease_ms / 1000.0
        with self._lock:
            for g, take in read_take.items():
                if not conf[g]:
                    continue
                n_conf += 1
                ri = int(rc[g])
                dq = self._reads[g]
                moved = min(take, len(dq))
                for _ in range(moved):
                    self._ripe[g].append(dq.popleft() + (ri,))
                if moved:
                    self._ripe_dirty.add(g)
                    self._ripe_waiting += moved
                    self._reads_waiting -= moved
                if not dq:
                    self._read_dirty.discard(g)
                if lease_s > 0:
                    # A confirmed quorum round proves leadership NOW;
                    # the clock bound extends it lease_ms forward.
                    self._lease_until[g] = now + lease_s
                    self._lease_term[g] = self._mirror_term(g)
        if o:
            o.h_read_confirms.observe(n_conf)

    def _serve_ripe_reads(self) -> None:
        """Serve every ripe read whose group's apply cursor has reached
        its read index. Queue surgery holds self._lock; the store gets
        (GIL-released in the C core) and waiter triggers run outside
        it. Per group the ripe queue is FIFO and read indexes are
        nondecreasing (commit is monotone within a term, and a new
        leader's own-term-committed index covers everything previously
        committed), so serving stops at the first not-yet-applied
        head."""
        served: List[Tuple[int, Request, int]] = []
        with self._lock:
            for g in list(self._ripe_dirty):
                dq = self._ripe[g]
                a = int(self.applied[g])
                while dq and dq[0][2] <= a:
                    rid, r, _ri = dq.popleft()
                    served.append((rid, r, g))
                if not dq:
                    self._ripe_dirty.discard(g)
            self._ripe_waiting -= len(served)
        if not served:
            return
        o = self.obs if self.obs.enabled else None
        tr = self.obs.tracer
        # Read coalescing: every read in this pass is at-or-past its
        # read index NOW, so one store get per distinct (group, path,
        # recursive, sorted) answers all of them — the get's instant
        # lies inside every coalesced read's [park, serve] window,
        # which is all linearizability requires. (The reference serves
        # a whole ReadIndex batch from one state the same way,
        # read_only.go advance; hot-key read storms collapse to one
        # tree walk per key per round.)
        memo: Dict[Tuple[int, str, bool, bool], Any] = {}
        for rid, r, g in served:
            k = (g, r.path, r.recursive, r.sorted)
            result = memo.get(k)
            if result is None:
                try:
                    result = self.store(g).get(r.path, r.recursive,
                                               r.sorted)
                except errors.EtcdError as err:
                    result = err
                memo[k] = result
            self.wait.trigger(rid, result)
            if tr.every:
                tr.mark(rid, "acked", g=g)
        if o:
            o.c_reads_served.inc(len(served))

    def _fail_parked_reads(self, why: str) -> None:
        """Fail every parked and ripe quorum read (engine shutdown) so
        serving threads don't ride out the full request timeout."""
        rids: List[int] = []
        with self._lock:
            for g in self._read_dirty:
                rids.extend(rid for rid, _r in self._reads[g])
                self._reads[g].clear()
            for g in self._ripe_dirty:
                rids.extend(rid for rid, _r, _i in self._ripe[g])
                self._ripe[g].clear()
            self._read_dirty.clear()
            self._ripe_dirty.clear()
            self._reads_waiting = 0
            self._ripe_waiting = 0
        for rid in rids:
            self.wait.trigger(rid, errors.EtcdError(
                errors.ECODE_RAFT_INTERNAL, cause=why))

    def conf_change(self, g: int, op: str, slot: int,
                    timeout: Optional[float] = None) -> List[int]:
        """Propose a membership change for group g through its own
        consensus; returns the new active slot list (reference
        configure() server.go:640-662 + multinode group management)."""
        if not 0 <= slot < self.cfg.peers:
            raise ValueError(f"slot {slot} out of range")
        if op == "add":
            if self.h_mask[g, slot]:
                raise errors.EtcdError(errors.ECODE_NODE_EXIST,
                                       cause=f"slot {slot} already active")
        elif op == "remove":
            if not self.h_mask[g, slot]:
                raise errors.EtcdError(errors.ECODE_KEY_NOT_FOUND,
                                       cause=f"slot {slot} not active")
        else:
            raise ValueError(op)
        rid = self.reqid.next()
        payload = bytes([P_CONF]) + json.dumps(
            {"id": rid, "op": op, "slot": slot}).encode()
        q = self.wait.register(rid)
        with self._lock:
            self._pending[g].append((rid, payload, None))
            self._dirty.add(g)
            self._confs_outstanding += 1
        try:
            result = q.get(timeout=timeout or self.cfg.request_timeout)
        except queue.Empty:
            self.wait.cancel(rid)
            raise errors.EtcdError(errors.ECODE_RAFT_INTERNAL,
                                   cause="conf change timed out")
        if isinstance(result, errors.EtcdError):
            raise result
        return result

    # ------------------------------------------------------------------
    # tenant lifecycle (the engine's CreateGroup/RemoveGroup — reference
    # raft/multinode.go:181-218 — over a fixed pre-compiled pool)
    # ------------------------------------------------------------------

    def tenant_active(self, g: int) -> bool:
        """Provisioned = at least one active peer slot."""
        return bool(self.h_mask[g].any())

    def tenants(self) -> List[int]:
        return [int(g) for g in np.nonzero(self.h_mask.any(axis=1))[0]]

    def create_tenant(self, g: Optional[int] = None,
                      n_peers: Optional[int] = None,
                      timeout: Optional[float] = None) -> int:
        """Provision a tenant group at runtime (g=None allocates the
        lowest free pool slot). Returns the group id once the creation is
        DURABLE (its conf flips fsynced in a round record). No
        recompilation: the kernel shape is the pool; creation is a masked
        state reset + peer-mask flips, exactly the shape a committed
        membership change already takes in the WAL — so replay needs no
        new machinery."""
        n = n_peers or self.cfg.initial_peers or self.cfg.peers
        if not 1 <= n <= self.cfg.peers:
            raise ValueError(f"n_peers {n} out of range 1..{self.cfg.peers}")
        return self._admin({"op": "create", "g": g, "n": n}, timeout)

    def remove_tenant(self, g: int,
                      timeout: Optional[float] = None) -> int:
        """Deprovision a tenant: all peer slots go inactive, its store,
        payloads and pending proposals are dropped (pending waiters get an
        error), and the pool slot becomes reusable."""
        return self._admin({"op": "remove", "g": int(g)}, timeout)

    def _admin(self, op: dict, timeout: Optional[float]) -> int:
        done = threading.Event()
        out: dict = {}
        item = (op, done, out)
        with self._lock:
            self._admin_q.append(item)
        if not done.wait(timeout or self.cfg.request_timeout):
            # Withdraw the op if it never started — a timed-out create must
            # not silently provision later (a client retry would then
            # consume a second pool slot). If it already left the queue,
            # give the in-flight execution a short grace.
            with self._lock:
                try:
                    self._admin_q.remove(item)
                    withdrawn = True
                except ValueError:
                    withdrawn = False
            if withdrawn or not done.wait(2.0):
                raise errors.EtcdError(errors.ECODE_RAFT_INTERNAL,
                                       cause="tenant admin op timed out")
        if "err" in out:
            raise out["err"]
        return out["g"]

    def _process_admin(self) -> None:
        """Apply queued tenant ops at a round boundary: device surgery via
        the shared per-slot conf machinery (CONF_ADD zeroes the slot on
        both live and replay paths — a freshly created tenant IS a set of
        added slots). The flips are persisted in their OWN record at this
        boundary, BEFORE the upcoming round's record: live surgery happens
        before the round runs, so replay must zero the slot before it sees
        that round's term/vote/commit deltas — appending the flips to the
        round's record would replay them AFTER its HS deltas and wipe the
        new group's first campaign (a restarted slot could then re-vote at
        a term it already voted in). Requester acks fire after the flips'
        fsync."""
        self._drain_applies()    # applies must not straddle the surgery
        with self._lock:
            ops = list(self._admin_q)
            self._admin_q.clear()
        for op, done, out in ops:
            try:
                if op["op"] == "create":
                    g = op["g"]
                    if g is None:
                        free = np.nonzero(~self.h_mask.any(axis=1))[0]
                        if not len(free):
                            raise errors.EtcdError(
                                errors.ECODE_RAFT_INTERNAL,
                                cause=f"tenant pool exhausted "
                                      f"({self.cfg.groups} groups)")
                        g = int(free[0])
                    g = int(g)
                    if not 0 <= g < self.cfg.groups:
                        raise errors.EtcdError(
                            errors.ECODE_KEY_NOT_FOUND,
                            cause=f"group {g} outside pool")
                    if self.h_mask[g].any():
                        raise errors.EtcdError(
                            errors.ECODE_NODE_EXIST,
                            cause=f"tenant {g} already provisioned")
                    self._tenant_reset(g)
                    for s in range(op["n"]):
                        self._apply_conf(g, "add", s, admin=True)
                        self._admin_flips.append((g, s, CONF_ADD))
                    # Fast first election (same trick as boot stagger).
                    el = _host(self.st.elapsed)
                    el[g, g % op["n"]] = 2 * self.cfg.election_tick
                    self.st = self.st._replace(
                        elapsed=self._dev("elapsed", el))
                    out["g"] = g
                else:
                    g = int(op["g"])
                    if not (0 <= g < self.cfg.groups
                            and self.h_mask[g].any()):
                        raise errors.EtcdError(
                            errors.ECODE_KEY_NOT_FOUND,
                            cause=f"no such tenant {g}")
                    for s in np.nonzero(self.h_mask[g])[0]:
                        self._apply_conf(g, "remove", int(s), admin=True)
                        self._admin_flips.append((g, int(s), CONF_REMOVE))
                    self._tenant_reset(g)
                    out["g"] = g
            except Exception as e:  # noqa: BLE001 — relayed to requester
                out["err"] = e
                done.set()
                continue
            self._admin_acks.append(done)
        if self._admin_flips:
            rec = RoundRecord(round_no=self.round_no)
            rec.confs.extend(self._admin_flips)
            self._admin_flips = []
            self.wal.append_sync(rec)     # fsync: the op is durable NOW
            self._recent_recs.append(rec)
        for done in self._admin_acks:
            done.set()
        self._admin_acks = []

    def _tenant_reset(self, g: int) -> None:
        """Drop all host-side state of a pool slot (store, payloads,
        apply cursor, queued proposals)."""
        self.tenant_gen[g] += 1
        st = self._stores.pop(g, None)
        if st is not None:
            st.watcher_hub.clear()   # wake/close blocked watchers
        self.applied[g] = 0
        self._sync_pending.pop(g, None)
        for k in [k for k in self.payloads if k[0] == g]:
            del self.payloads[k]
            self.payload_reqs.pop(k, None)
        with self._lock:
            dq = self._pending[g]
            while dq:
                rid = dq.popleft()[0]
                self.wait.trigger(rid, errors.EtcdError(
                    errors.ECODE_RAFT_INTERNAL, cause="tenant removed"))
                if self._ack_t is not None:
                    self._ack_t.pop(rid, None)
            self._dirty.discard(g)

    def _stage_syncs(self, now: float) -> None:
        """Enqueue METHOD_SYNC for every tenant whose store holds an
        expiration <= now. At most one SYNC in flight per tenant (a
        leaderless group must not accumulate one queued SYNC per interval);
        the inflight marker self-heals by deadline in case the SYNC entry
        is orphaned by a leader change and never applies."""
        due = [g for g, s in list(self._stores.items())
               if (x := s.next_expiration()) is not None and x <= now
               and self._sync_pending.get(g, 0.0) <= now]
        if not due:
            return
        redeadline = now + max(2.0, 10 * self.cfg.sync_interval)
        with self._lock:
            for g in due:
                self._sync_pending[g] = redeadline
                r = Request(method=METHOD_SYNC, time=now,
                            id=self.reqid.next())
                self._pending[g].append((r.id, bytes([P_REQ]) + r.encode(),
                                         r))
                self._dirty.add(g)

    def status(self, g: int) -> dict:
        """Introspection snapshot for one group (/debug/vars analogue)."""
        lead = self.leader_slot(g)
        return {
            "group": g,
            "lead": lead,
            "term": int(self.h_term[g].max()),
            "commit": int(self.h_commit[g].max()),
            "applied": int(self.applied[g]),
            "active_slots": [int(s) for s in np.nonzero(self.h_mask[g])[0]],
        }

    def profile(self, rounds: int = 20, out_dir: Optional[str] = None) -> str:
        """Capture a torch.profiler trace (host and, on the card, CUDA
        activity) of `rounds` engine rounds. Writes a Chrome trace-event
        JSON into <data_dir>/profiles (or out_dir) and returns that
        directory. Drive rounds manually if the engine thread isn't
        running."""
        import os
        from torch.profiler import ProfilerActivity, profile
        out = out_dir or os.path.join(self.cfg.data_dir, "profiles")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, f"trace-{self.round_no:016x}.json")
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        running = self._thread is not None and self._thread.is_alive()
        with profile(activities=acts) as prof:
            if running:
                target = self.round_no + rounds
                while (self.round_no < target
                       and not self._stop_ev.is_set()):
                    time.sleep(0.001)
            else:
                for _ in range(rounds):
                    self.run_round()
        prof.export_chrome_trace(path)
        return out

    def _range(self, name: str):
        """A host range `name` on the profiler's clock while a profiler
        runs and the observability plane is on, so a trace names what
        the host did across the card's idle gaps; otherwise a shared
        no-op, at the cost of one flag test. A range wraps host-only
        code: one around a launch would also put it on the device's
        timeline (a gpu_user_annotation), where it reads as busy time."""
        if self._ack_t is not None and self._prof._is_profiler_enabled:
            return self._prof.record_function(name)
        return _NO_RANGE

    # ------------------------------------------------------------------
    # the round
    # ------------------------------------------------------------------

    def _run(self) -> None:
        try:
            if self.device.type == "cuda":
                # The current CUDA device is per thread.
                self._torch.cuda.set_device(self.device)
            while not self._stop_ev.is_set():
                self.run_round()
                if self.cfg.round_interval:
                    time.sleep(self.cfg.round_interval)
        except Exception as e:  # noqa: BLE001 — record, then re-raise
            self.failed = e
            self._stop_ev.set()
            raise

    def run_round(self) -> None:
        """One engine round. Callable directly (tests drive the engine
        synchronously); the background thread just loops it."""
        t_round = time.perf_counter()
        torch = self._torch
        G, P, W, E = (self.cfg.groups, self.cfg.peers, self.cfg.window,
                      self.cfg.max_ents)
        o = self.obs if self.obs.enabled else None
        r_no = self.round_no
        self._last_admitted = 0
        self._trace_rids.clear()
        if o:
            o.flight.mark(r_no, obs_mod.SUBMITTED, t_round)

        # -- -1. tenant lifecycle admin ops (rare; round-boundary surgery)
        if self._admin_q:
            self._process_admin()

        # -- 0. TTL expiry: stage a replicated SYNC into tenants holding a
        # DUE expiration (leader-clock cutoff; deletion applies — and
        # replays — deterministically from the log).
        if self.cfg.sync_interval:
            now = time.time()
            if now - self._last_sync_scan >= self.cfg.sync_interval:
                self._last_sync_scan = now
                self._stage_syncs(now)

        # -- 1. stage proposals at known leaders --------------------------
        # (host only, as every range's code: see _range)
        with self._range("engine.stage"):
            prop_count = np.zeros(G, np.int32)
            prop_slot = np.zeros(G, np.int32)
            self._staged.clear()
            with self._lock:
                if o:
                    # Every write in _pending now was submitted before.
                    self._t_staged = time.perf_counter()
                if self._dirty:
                    # One vectorized pass instead of a per-group leader_slot
                    # call (16k np calls/round at bench scale); .tolist() once
                    # beats 16k numpy scalar __getitem__s in the loop below.
                    lead_rows = (np.where(self.h_mask, self.h_state, 0)
                                 == _LEADER)
                    has_lead = lead_rows.any(axis=1).tolist()
                    lead_slots = lead_rows.argmax(axis=1).tolist()
                B = self.cfg.batch_max
                for g in list(self._dirty):
                    dq = self._pending[g]
                    if not dq:
                        self._dirty.discard(g)
                        continue
                    if not has_lead[g]:
                        continue
                    s = lead_slots[g]
                    # Pack queued requests into at most E log entries of up to
                    # B requests each (group commit): conf changes stay
                    # singleton entries (their committed-boundary scan keys on
                    # the payload tag), plain requests coalesce.
                    ents: List[List[Tuple[int, bytes]]] = []
                    while dq and len(ents) < E:
                        if dq[0][1] and dq[0][1][0] == P_CONF:
                            ents.append([dq.popleft()])
                            continue
                        cur: List[Tuple[int, bytes]] = []
                        nbytes = 0
                        while (dq and len(cur) < B
                               and nbytes < self.cfg.batch_bytes and dq[0][1]
                               and dq[0][1][0] == P_REQ):
                            nbytes += len(dq[0][1])
                            cur.append(dq.popleft())
                        if not cur:
                            # Head is neither P_CONF nor P_REQ (empty or junk
                            # tag): consume it or the group jams on count=0
                            # entries forever; fail its waiter immediately
                            # rather than letting the client ride out the
                            # full request timeout.
                            rid, junk = dq.popleft()[:2]
                            log.error("engine: dropping untagged proposal "
                                      "g=%d rid=%d len=%d", g, rid, len(junk))
                            self.wait.trigger(rid, errors.EtcdError(
                                errors.ECODE_RAFT_INTERNAL,
                                cause="untagged proposal dropped"))
                            if self._ack_t is not None:
                                self._ack_t.pop(rid, None)
                            continue
                        ents.append(cur)
                    if not dq:
                        self._dirty.discard(g)
                    self._staged[g] = (s, ents)
            # One pass builds the staged index arrays; they feed the two
            # scatter writes here AND the admission gather after the step
            # (_staged is round-thread-private and not mutated in between).
            # Batching replaces ~2*G numpy scalar stores at ~0.2 µs each.
            staged_gs = staged_ss = None
            if self._staged:
                gs_l, ss_l, cnt_l = [], [], []
                for g, (s, ents) in self._staged.items():
                    gs_l.append(g)
                    ss_l.append(s)
                    cnt_l.append(len(ents))
                staged_gs = np.asarray(gs_l, np.int64)
                staged_ss = np.asarray(ss_l, np.int64)
                prop_count[staged_gs] = cnt_l
                prop_slot[staged_gs] = ss_l

            # -- 1b. read plane: snapshot how many parked quorum reads each
            # group carries BEFORE the step is dispatched. A read parking
            # after this point must not adopt this round's confirmation —
            # an applier running under the device step could ack a write
            # whose commit index exceeds the index this round captures, and
            # serving such a late read at the captured index would miss that
            # acked write. The snapshot pins exactly which reads this
            # round's confirmation covers (see tests/test_read_plane.py).
            read_take: Optional[Dict[int, int]] = None
            if self._reads_waiting:
                with self._lock:
                    if self._reads_waiting:
                        read_take = {g: len(self._reads[g])
                                     for g in self._read_dirty
                                     if self._reads[g]}

        ph = self.phase_s
        t_ph = time.perf_counter()
        ph["stage"] = ph.get("stage", 0.0) + (t_ph - t_round)
        if o:
            o.h_phase["stage"].observe(t_ph - t_round)

        # -- 2. the kernel round (step + routing; CUDA launches queue
        # asynchronously, the round reads one quiescence flag per hop) ----
        tick = (self.round_no % self.cfg.ticks_per_round) == 0
        kernel = self._kernel
        w_quiet = kernel._quiet.wait_s
        hops0 = dict(kernel.hop_counts)
        pc_d = torch.as_tensor(prop_count, device=self.device)
        ps_d = torch.as_tensor(prop_slot, device=self.device)
        flags_d = anh_d = None
        conf_d = rc_d = None
        if read_take:
            # A ReadIndex round is a full round (proposals, ticks and
            # the forced leader heartbeat all ride the same program) but
            # skips the compact path: the read step returns no flag map,
            # and the confirmation wants the full mirror refresh anyway.
            st, inbox, conf_d, rc_d = self._step_fn_r(
                self.st, self.inbox, pc_d, ps_d, bool(tick))
        elif self._compact:
            st, inbox, flags_d, anh_d = self._step_fn_c(
                self.st, self.inbox, pc_d, ps_d, bool(tick))
        else:
            st, inbox = self._step_fn(
                self.st, self.inbox, pc_d, ps_d, bool(tick))
        self.st = st
        self.inbox = inbox
        t_now = time.perf_counter()
        d_dispatch = t_now - t_ph
        ph["dispatch"] = ph.get("dispatch", 0.0) + d_dispatch
        t_ph = t_now
        # The round's seconds blocked on the card: the hops' quiescence
        # reads (summed over the cells' threads on a mesh) and the
        # readback's reads below.
        d_wait = kernel._quiet.wait_s - w_quiet
        d_hops = {k: n - hops0[k] for k, n in kernel.hop_counts.items()}
        self._rows_wait = 0.0

        # -- 3. read back round k (blocks until the device finishes;
        # torch releases the GIL while it waits, so the applier thread makes
        # progress on earlier rounds' committed work here). Compact mode
        # reads the on-device diff flags first and fetches values for
        # only the changed rows; need_host rounds and rounds changing
        # more rows than the cap take the full readback below. ----------
        rec = None
        need_host = None
        d_readback = d_record = 0.0
        t_stepped = t_ph
        if flags_d is not None:
            # Check the 1-byte attestation BEFORE pulling the flag map:
            # need-host/post-surgery rounds take the full readback anyway
            # and must not pay a discarded (G, P) transfer first.
            if not bool(anh_d) and not self._force_full:
                flags_np = flags_d.cpu().numpy()
                t_now = time.perf_counter()
                d_readback = t_now - t_ph
                d_wait += d_readback     # the readback is its two reads
                ph["readback"] = ph.get("readback", 0.0) + d_readback
                t_ph = t_stepped = t_now
                rec = self._compact_record_admit(flags_np, staged_gs,
                                                 staged_ss)
                if rec is not None:
                    t_now = time.perf_counter()
                    d_record = t_now - t_ph
                    ph["record"] = ph.get("record", 0.0) + d_record
                    t_ph = t_now
        if rec is None:
            (term, vote, commit, state, last, ring, need_host) = (
                _host(a) for a in
                (st.term, st.vote, st.commit, st.state, st.last_index,
                 st.log_term, st.need_host))
            t_now = time.perf_counter()
            d_readback = t_now - t_ph
            d_wait += d_readback         # reads alone (and the attestation)
            ph["readback"] = ph.get("readback", 0.0) + d_readback
            t_ph = t_stepped = t_now

            # Violation check FIRST — before this round's WAL append,
            # applies, or acks: a flagged round's commits come from state
            # the kernel just classified as untrustworthy, and must never
            # reach clients.
            if need_host.any():
                from etcd_tpu_torch.ops.state import NH_VIOLATION
                viol = (need_host & NH_VIOLATION) != 0
                if viol.any():
                    self._fail_violation(viol)

            # -- 5. durable round record ----------------------------------
            with self._range("engine.record"):
                rec = RoundRecord(round_no=self.round_no)
                chg = (term != self.h_term) | (vote != self.h_vote) | \
                      (commit != self.h_commit)
                gi, pi = np.nonzero(chg)
                rec.hs_g, rec.hs_p = gi.astype(np.uint32), pi.astype(np.uint16)
                rec.hs_term = term[gi, pi].astype(np.uint32)
                rec.hs_vote = vote[gi, pi].astype(np.uint16)
                rec.hs_commit = commit[gi, pi].astype(np.uint32)

                last_chg = last != self.h_last
                gi, pi = np.nonzero(last_chg)
                rec.last_g = gi.astype(np.uint32)
                rec.last_p = pi.astype(np.uint16)
                rec.last_v = last[gi, pi].astype(np.uint32)

                # Ring diff in two stages: a vectorized per-row any-reduction
                # finds the rows whose ring changed (SIMD compare — NOT the
                # 3-axis np.nonzero over (G, P, W) that dominated host cost
                # at 100k groups), then the slot-level diff runs only on
                # those rows. The full compare is required for correctness:
                # an equal-length conflict overwrite can change ring terms in
                # a round where that row's term/vote/commit/last are ALL
                # unchanged (the follower adopted the new leader's term in an
                # earlier round), so a HardState-based row filter would
                # silently drop the overwrite from the WAL and crash replay
                # would resurrect superseded entries.
                act_g, act_p = np.nonzero(np.any(ring != self.h_ring, axis=2))
                if len(act_g):
                    sub = ring[act_g, act_p] != self.h_ring[act_g, act_p]
                    ai, wi = np.nonzero(sub)
                    gi, pi = act_g[ai], act_p[ai]
                    lastv = last[gi, pi]
                    # ring slot w holds absolute index
                    # i = last - ((last - w) mod W)
                    absi = lastv - ((lastv - wi) % W)
                    keep = absi >= 1
                    rec.ring_g = gi[keep].astype(np.uint32)
                    rec.ring_p = pi[keep].astype(np.uint16)
                    rec.ring_i = absi[keep].astype(np.uint32)
                    rec.ring_t = ring[gi[keep], pi[keep],
                                      wi[keep]].astype(np.uint32)

                # Index assignment for admitted proposals: a pre-existing
                # leader admits in order at prev_last+1.. (its last_index can
                # move this round ONLY by admission: it was already leader,
                # so no no-op, and leaders ignore MsgApp).
                if self._staged:
                    # Batch-gather the admission scalars: one fancy-indexed
                    # pull per array instead of 6 numpy scalar reads per
                    # staged group, reusing the index arrays built at staging
                    # time.
                    gs, ss = staged_gs, staged_ss
                    t_gs = term[gs, ss]
                    adm_l = np.where((state[gs, ss] == _LEADER)
                                     & (t_gs == self.h_term[gs, ss]),
                                     last[gs, ss] - self.h_last[gs, ss],
                                     0).tolist()
                    self._admit_staged(rec, adm_l, t_gs.tolist(),
                                       self.h_last[gs, ss].tolist())

                self.h_term, self.h_vote, self.h_commit = term, vote, commit
                self.h_state, self.h_last, self.h_ring = state, last, ring
                self._force_full = False   # mirrors == device state again
            t_now = time.perf_counter()
            d_record = t_now - t_ph
            ph["record"] = ph.get("record", 0.0) + d_record
            t_ph = t_now

        # -- 5b. read plane: pop the snapshotted reads of every group
        # whose ReadIndex confirmation landed into the ripe queue at the
        # captured commit index (read rounds always take the full
        # readback above, so the mirrors the confirmation consults are
        # this round's).
        if conf_d is not None:
            self._confirm_reads(read_take, _host(conf_d), _host(rc_d))

        # -- 6. persist, then apply+ack. WAL fsync strictly precedes the
        # acks of everything this round committed (doc.go:31-39 ordering)
        # — by GATING, not by inline ordering: the record is handed to
        # the writer compartment (which group-commits it with its queue
        # neighbors on its own thread) and the applier workers withhold
        # waiter wakeups until the writer's durability watermark passes
        # this round's ticket. Applies may run ahead of the fsync; acks
        # may not. Membership flips committed this round must be in the
        # SAME durable record as the round that commits them (replay
        # re-applies them) — and conf traffic forces the SYNCHRONOUS
        # path: applying a conf performs device-state surgery that must
        # precede the next dispatch, so the record is appended+fsynced
        # before the inline apply below (append_sync).
        if o:
            ph["dispatch.wait"] = (ph.get("dispatch.wait", 0.0) + d_wait
                                   + self._rows_wait)
            # The round's hops by branch, counts: the fused passes, the
            # PyTorch quiet branch, the full sequential path.
            for k, n in d_hops.items():
                ph[f"hop.{k}"] = ph.get(f"hop.{k}", 0.0) + n
            o.h_phase["dispatch"].observe(d_dispatch)
            o.h_phase["readback"].observe(d_readback)
            o.h_step.observe(d_dispatch + d_readback)
            o.h_phase["record"].observe(d_record)
            o.flight.mark(r_no, obs_mod.STEPPED, t_stepped)
            if self._staged:
                o.h_batch.observe(self._last_admitted)
        rec.confs.extend(self._collect_committed_confs())
        sync_round = bool(rec.confs or self._confs_outstanding
                          or not self.cfg.pipeline_applies)
        if not rec.is_empty():
            t0 = time.perf_counter()
            with self._range("engine.wal_submit"):
                if sync_round or not self.cfg.pipeline_wal:
                    self.wal.append_sync(rec)
                else:
                    self.wal.submit(rec)
            ph["wal_submit"] = ph.get("wal_submit", 0.0) + \
                (time.perf_counter() - t0)
            if o:
                o.h_phase["wal_submit"].observe(time.perf_counter() - t0)
                o.flight.mark(r_no, obs_mod.WAL_SUBMITTED)
            tr = self.obs.tracer
            if tr.every and self._trace_rids:
                for rid in self._trace_rids:
                    tr.mark(rid, "wal_submit", ticket=self.wal.ticket)
            self._recent_recs.append(rec)
        if sync_round:
            self._drain_applies()
            t0 = time.perf_counter()
            a0 = self._acks.acked
            self._apply_committed(trigger=True)
            ph["apply"] = ph.get("apply", 0.0) + (time.perf_counter() - t0)
            if o:
                o.flight.mark(r_no, obs_mod.APPLIED)
                o.flight.mark(r_no, obs_mod.ACKED)
                if self._acks.acked > a0:
                    o.c_acked.inc(self._acks.acked - a0)
                # append_sync fsynced the record before the apply: acked
                # as applied, so nothing waits at the gate.
                t_acked = time.perf_counter()
                self._ack_account("", self._acks.rids, t_acked, t_acked)
                self._acks.rids.clear()
        else:
            with self._range("engine.tail"):
                self._enqueue_apply(self._commit_view())

        # -- 6b. read plane: serve every ripe read whose group has
        # applied past its read index. Sync rounds serve their own reads
        # immediately (the inline apply above advanced the cursor);
        # pipelined rounds serve reads the applier shards ripened while
        # the device step ran — at most one round of extra latency.
        if self._ripe_waiting:
            with self._range("engine.tail"):
                self._serve_ripe_reads()

        # -- 7. need_host: snapshot-install lagging followers (violations
        # already failed the round before anything was persisted or
        # acked). need_host is None on a compact round — the device
        # already attested any_need_host == False for it.
        if need_host is not None and need_host.any():
            self._service_need_host(need_host)

        ph["tail"] = ph.get("tail", 0.0) + (time.perf_counter() - t_ph)
        if o:
            o.h_phase["tail"].observe(time.perf_counter() - t_ph)
            o.c_rounds.inc()
        self.round_no += 1
        if (self.cfg.mask_check_rounds
                and self.round_no % self.cfg.mask_check_rounds == 0):
            self._check_mask()
        ms = (time.perf_counter() - t_round) * 1000.0
        if self.round_ms_ewma == 0.0:
            self.round_ms_ewma = ms      # seed with the first sample
        else:
            self.round_ms_ewma += 0.05 * (ms - self.round_ms_ewma)
        if self.round_no % self.cfg.checkpoint_rounds == 0:
            self._drain_applies()    # checkpoint state must be consistent
            self._checkpoint()
            self._gc_payloads()

    def _admit_staged(self, rec: RoundRecord, adm_l: list, t_l: list,
                      base_l: list) -> None:
        """Turn this round's staged entries into payload-store entries +
        WAL records (admitted) or requeue them (rejected: the group's
        leader changed or throttled admission). Shared by the full- and
        compact-readback tails; iteration order is self._staged's
        insertion order, which both tails' scalar lists follow."""
        requeue: List[Tuple[int, List[Tuple[int, bytes]]]] = []
        tr = self.obs.tracer
        acks = self._ack_t
        t_staged, t_admitted = self._t_staged, time.perf_counter()
        n_admitted = 0
        for (g, (_, ents)), admitted, t, base in zip(
                self._staged.items(), adm_l, t_l, base_l):
            for j, items in enumerate(ents):
                if j < admitted:
                    i = base + 1 + j
                    payload = _pack_entry(items)
                    self.payloads[(g, i, t)] = payload
                    if payload[0] != P_CONF:
                        reqs = [it[2] for it in items]
                        if None not in reqs:
                            self.payload_reqs[(g, i, t)] = reqs
                    n_admitted += len(items)
                    if acks is not None:
                        # Stamped by the round that admits it, requeued
                        # or not.
                        for it in items:
                            w = acks.get(it[0])
                            if w is not None:
                                w[1] = t_staged
                                w[2] = t_admitted
                    if tr.every:
                        for it in items:
                            if tr.sampled(it[0]):
                                tr.mark(it[0], "admitted", g=g,
                                        round=rec.round_no)
                                self._trace_rids.append(it[0])
                    rec.entries.append((g, i, t, payload))
                else:
                    requeue.append(
                        (g, [it for e in ents[j:] for it in e]))
                    break
        self._last_admitted = n_admitted
        if requeue:
            with self._lock:
                for g, rest in requeue:
                    self._pending[g].extendleft(reversed(rest))
                    self._dirty.add(g)

    def _compact_record_admit(self, flags: np.ndarray,
                              staged_gs, staged_ss
                              ) -> Optional[RoundRecord]:
        """The compact-readback round tail: build the SAME durable round
        record (byte-identical; tests/test_engine_compact.py pins it)
        and run the same admission as the full tail, from a bounded
        gather of only the rows the device flagged as changed. Returns
        None when the round changed more rows than the cap — the caller
        then falls back to the full readback (saturation: the bulk
        transfer is amortized by the batch it carries)."""
        kernel, torch = self._kernel, self._torch
        G, P, W = self.cfg.groups, self.cfg.peers, self.cfg.window
        with self._range("engine.record"):    # host only: the rows to gather
            chg_g, chg_p = np.nonzero(flags)
            lin = chg_g.astype(np.int64) * P + chg_p
            if staged_gs is not None:
                lin = np.unique(np.concatenate(
                    [lin, staged_gs * P + staged_ss]))
        K = len(lin)
        if K > self._compact_cap:
            return None
        rec = RoundRecord(round_no=self.round_no)
        if K == 0:
            return rec
        gi = (lin // P).astype(np.int64)
        pi = (lin % P).astype(np.int64)
        rows_d = kernel.gather_rows(
            self.st, torch.as_tensor(gi, device=self.device),
            torch.as_tensor(pi, device=self.device))
        t0 = time.perf_counter()
        t_k, v_k, c_k, s_k, l_k, r_k = (a.cpu().numpy() for a in rows_d)
        self._rows_wait = time.perf_counter() - t0

        def rows(bit):
            g, p = np.nonzero((flags & bit) != 0)
            return g, p, np.searchsorted(lin, g.astype(np.int64) * P + p)

        with self._range("engine.record"):    # host only: the rows are here
            g0, p0, pos0 = rows(kernel.CHG_HS)
            rec.hs_g = g0.astype(np.uint32)
            rec.hs_p = p0.astype(np.uint16)
            rec.hs_term = t_k[pos0].astype(np.uint32)
            rec.hs_vote = v_k[pos0].astype(np.uint16)
            rec.hs_commit = c_k[pos0].astype(np.uint32)

            g1, p1, pos1 = rows(kernel.CHG_LAST)
            rec.last_g = g1.astype(np.uint32)
            rec.last_p = p1.astype(np.uint16)
            rec.last_v = l_k[pos1].astype(np.uint32)

            g2, p2, pos2 = rows(kernel.CHG_RING)
            if len(g2):
                new_rows = r_k[pos2]                    # (n2, W)
                sub = new_rows != self.h_ring[g2, p2]
                ai, wi = np.nonzero(sub)
                lastv = l_k[pos2][ai]
                absi = lastv - ((lastv - wi) % W)
                keep = absi >= 1
                rec.ring_g = g2[ai][keep].astype(np.uint32)
                rec.ring_p = p2[ai][keep].astype(np.uint16)
                rec.ring_i = absi[keep].astype(np.uint32)
                rec.ring_t = new_rows[ai, wi][keep].astype(np.uint32)

            if self._staged:
                pos_s = np.searchsorted(lin, staged_gs * P + staged_ss)
                t_gs = t_k[pos_s]
                adm_l = np.where((s_k[pos_s] == _LEADER)
                                 & (t_gs
                                    == self.h_term[staged_gs, staged_ss]),
                                 l_k[pos_s]
                                 - self.h_last[staged_gs, staged_ss],
                                 0).tolist()
                self._admit_staged(
                    rec, adm_l, t_gs.tolist(),
                    self.h_last[staged_gs, staged_ss].tolist())

            # Mirror update LAST (admission reads the pre-round mirrors).
            # Gathered values are authoritative for every union row —
            # writing back an unchanged staged row is a no-op.
            self.h_term[gi, pi] = t_k
            self.h_vote[gi, pi] = v_k
            self.h_commit[gi, pi] = c_k
            self.h_state[gi, pi] = s_k
            self.h_last[gi, pi] = l_k
            self.h_ring[gi, pi] = r_k
        return rec

    # ------------------------------------------------------------------
    # apply
    # ------------------------------------------------------------------

    def _group_commit(self) -> np.ndarray:
        c = np.where(self.h_mask, self.h_commit, 0)
        return c.max(axis=1)

    def _committed_span(self, g: int):
        """(slot, lo, hi] apply span for group g using the slot that has
        the highest commit (its ring covers the span: the admission
        throttle keeps last-commit <= W/2, so hi > last - W)."""
        row = np.where(self.h_mask[g], self.h_commit[g], 0)
        s = int(row.argmax())
        return s, int(self.applied[g]), int(row[s])

    def _collect_committed_confs(self) -> List[Tuple[int, int, int]]:
        """Scan newly committed spans for conf payloads WITHOUT applying —
        their mask flips must be in the same durable record as the round
        that commits them."""
        out = []
        if self._confs_outstanding == 0:
            # Common case: no membership change in flight anywhere — skip
            # re-scanning every committed span (the apply loop scans them
            # again right after; this scan only exists to bind mask flips
            # into the committing round's durable record).
            return out
        # The scan spans applied..commit, and `applied` is applier-owned:
        # settle it first (conf rounds are rare; the drain is the price of
        # binding flips into the right record).
        self._drain_applies()
        gc = self._group_commit()
        for g in np.nonzero(gc > self.applied)[0]:
            s, lo, hi = self._committed_span(int(g))
            for i in range(lo + 1, hi + 1):
                t = int(self.h_ring[g, s, i % self.cfg.window])
                payload = self.payloads.get((int(g), i, t))
                if payload and payload[0] == P_CONF:
                    d = json.loads(payload[1:].decode())
                    op = CONF_ADD if d["op"] == "add" else CONF_REMOVE
                    out.append((int(g), d["slot"], op))
        return out

    def _apply_committed(self, trigger: bool, hist=None, view=None,
                         g_lo: int = 0, g_hi: Optional[int] = None,
                         acct: Optional[_AckCounter] = None,
                         sink: Optional[_AckBatch] = None) -> None:
        """Apply every newly committed entry (applied..commit per group)
        to its tenant store and trigger waiters. `view` is an immutable
        (gc, s_vec, ring, last, ticket) snapshot when called from an
        applier worker; None applies against the live mirrors
        (synchronous callers + replay). [g_lo, g_hi) restricts the pass
        to one shard's tenant range (workers touch only their own slice
        of self.applied and their own stores); acct is the ack tally to
        charge — the worker's own, or the engine's synchronous one.
        With `sink` set, waiter wakeups and the ack tally are DEFERRED
        into it instead of fired inline — the worker releases them after
        the view's durability ticket clears the WAL watermark."""
        W = self.cfg.window
        tr = self.obs.tracer
        if acct is None:
            acct = self._acks
        if view is None:
            view = self._commit_view()
        gc, s_vec, h_ring, h_last = view[:4]
        if g_hi is None:
            g_hi = len(gc)
        changed = np.nonzero(gc[g_lo:g_hi] > self.applied[g_lo:g_hi])[0]
        for g in changed:
            g = int(g) + g_lo
            s, lo, hi = int(s_vec[g]), int(self.applied[g]), int(gc[g])
            ring_row = h_ring[g, s]
            last_gs = int(h_last[g, s])
            for i in range(lo + 1, hi + 1):
                t = 0
                if i > last_gs - W:
                    t = int(ring_row[i % W])
                if t == 0 and hist is not None:
                    # Restore path: the span slot's ring can hold the 0
                    # sentinel INSIDE the window — a slot removed and
                    # later re-added had its ring zeroed at the join, so
                    # indices below its join point are unresolvable from
                    # it even though other slots know them. hist (built
                    # from every slot's replayed log history) supplies
                    # the committed term; without this fallback those
                    # entries would silently apply as leader no-ops and
                    # ACKED WRITES WOULD VANISH on restart (soak-found).
                    t = hist.get((g, i), 0)
                if t == 0:
                    # Live path: unreachable (applies are incremental, so
                    # the span never reaches below a re-added slot's join
                    # point or the ring window); refusing beats
                    # misapplying.
                    log.error("engine: no term for committed entry g=%d "
                              "i=%d (slot=%d last=%d)", g, i, s, last_gs)
                    continue
                key = (g, i, t)
                payload = self.payloads.get(key)
                if payload is None:
                    continue  # leader no-op
                if payload[0] in (P_REQ, P_MULTI):
                    # Coalesced entries: each request applies independently
                    # in order, with its own result/error and its own
                    # waiter trigger — semantically identical to one entry
                    # per request. The live path reuses the Requests
                    # decoded at proposal time (payload_reqs sidecar);
                    # replay decodes from the durable bytes.
                    reqs = self.payload_reqs.pop(key, None)
                    if reqs is None:
                        if payload[0] == P_REQ:
                            reqs = (Request.decode(payload[1:]),)
                        else:
                            reqs = [Request.decode(b)
                                    for b in _unpack_multi(payload)]
                    if not trigger and tr.every:
                        # Restart replay: sampled rids ride the durable
                        # Request payloads, so the trace picks them back
                        # up in the new process.
                        for r0 in reqs:
                            tr.mark(r0.id, "replayed", g=g)
                    # Batched fast path: runs of plain-file PUTs with no
                    # conditions and no TTL apply through ONE
                    # GIL-releasing C call per run
                    # (NativeStore.set_applied_many) instead of a full
                    # Python dispatch per request — the apply loop's
                    # throughput ceiling at scale. Waiter-held plain PUTs
                    # ride the batch too: their positions go in `need`,
                    # the C call returns raw node descriptors for them,
                    # and the waiter is woken with a LazyWriteEvent (the
                    # Event/JSON churn happens on the HTTP thread that
                    # resolves it, not here — the ack/waiter stage of the
                    # compartmentalized path). A request that carries
                    # conditions/TTL or isn't a plain PUT flushes the run
                    # and applies through the scalar path, preserving log
                    # order exactly. Runs never span log entries (the
                    # per-entry cursor advance below must stay exact).
                    # Fast-path requests are client writes (SYNC never
                    # qualifies: its method is not PUT); their per-op
                    # store errors count as served, same as a scalar
                    # error result.
                    st = self.store(g)
                    many = getattr(st, "set_applied_many", None)
                    is_reg = self.wait.is_registered
                    fp, fv, fneed, frids = [], [], [], []
                    for r in reqs:
                        if (many is not None and r.method == METHOD_PUT
                                and not r.dir and not r.refresh
                                and r.prev_exist is None
                                and not r.prev_index and not r.prev_value
                                and r.expiration is None):
                            if is_reg(r.id):
                                fneed.append(len(fp))
                                frids.append(r.id)
                            fp.append(r.path)
                            fv.append(r.val or "")
                            continue
                        if fp:
                            self._flush_many(st, fp, fv, fneed, frids,
                                             trigger, acct, sink)
                            fp, fv, fneed, frids = [], [], [], []
                        try:
                            result = self._apply_request(g, r)
                        except errors.EtcdError as err:
                            result = err
                        if trigger:
                            if tr.every:
                                tr.mark(r.id, "applied")
                            if sink is not None:
                                if r.method != METHOD_SYNC:
                                    sink.acked += 1
                                sink.items.append((r.id, result))
                            else:
                                if r.method != METHOD_SYNC:
                                    acct.acked += 1
                                self.wait.trigger(r.id, result)
                                if acct.rids is not None:
                                    acct.rids.append(r.id)
                                if tr.every:
                                    tr.mark(r.id, "acked")
                    if fp:
                        self._flush_many(st, fp, fv, fneed, frids,
                                         trigger, acct, sink)
                elif payload[0] == P_CONF:
                    d = json.loads(payload[1:].decode())
                    self._apply_conf(g, d["op"], d["slot"])
                    if trigger:
                        self.wait.trigger(
                            d["id"],
                            [int(x) for x in np.nonzero(self.h_mask[g])[0]])
                # Advance the cursor PER ENTRY, not at span end: if an
                # apply raises mid-span, a retry (or post-mortem) must
                # resume after the last applied entry, never re-apply it
                # (duplicate watch events / double store mutations).
                self.applied[g] = i
            self.applied[g] = hi

    def _flush_many(self, st, fp: list, fv: list, fneed: list,
                    frids: list, trigger: bool, acct: _AckCounter,
                    sink: Optional[_AckBatch] = None) -> None:
        """Apply one batched run of plain-file PUTs. Positions listed in
        fneed hold waiters: the C call returns their raw node
        descriptors, and each waiter is woken with a LazyWriteEvent (or
        the per-op EtcdError) — Event materialization is deferred to the
        HTTP thread that resolves it in do(). With `sink`, wakeups and
        the tally are deferred for post-watermark release instead."""
        if not fneed:
            st.set_applied_many(fp, fv)
            if trigger:
                if sink is not None:
                    sink.acked += len(fp)
                else:
                    acct.acked += len(fp)
            return
        now = st.clock()
        _, descs = st.set_applied_many(fp, fv, need=fneed)
        if trigger:
            tr = self.obs.tracer
            if sink is not None:
                sink.acked += len(fp)
            else:
                acct.acked += len(fp)
            for (pos, nd, pd, idx), rid in zip(descs, frids):
                if nd is None:
                    code, cause = pd
                    res: Any = errors.EtcdError(code, cause=cause,
                                                index=idx)
                else:
                    res = LazyWriteEvent(nd, pd, idx, now)
                if tr.every:
                    tr.mark(rid, "applied")
                if sink is not None:
                    sink.items.append((rid, res))
                else:
                    self.wait.trigger(rid, res)
                    if tr.every:
                        tr.mark(rid, "acked")
            if sink is None and acct.rids is not None:
                acct.rids.extend(frids)

    def _apply_request(self, g: int, r: Request):
        """Deterministic request->store mapping (reference applyRequest
        server.go:766-820), against the group's own tenant store."""
        st = self.store(g)
        exp = r.expiration
        if r.method == METHOD_POST:
            return st.create(r.path, is_dir=r.dir, value=r.val, unique=True,
                             expire_time=exp)
        if r.method == METHOD_PUT:
            if r.refresh:
                return st.update(r.path, None, exp, refresh=True)
            if r.prev_exist is not None:
                if r.prev_exist:
                    if r.prev_index or r.prev_value:
                        return st.compare_and_swap(r.path, r.prev_value,
                                                   r.prev_index, r.val, exp)
                    return st.update(r.path, r.val, exp)
                return st.create(r.path, is_dir=r.dir, value=r.val,
                                 expire_time=exp)
            if r.prev_index or r.prev_value:
                return st.compare_and_swap(r.path, r.prev_value,
                                           r.prev_index, r.val, exp)
            if not r.dir:
                # Unconditional file PUT — the apply loop's dominant op.
                # The native store skips Event materialization entirely
                # unless a watcher is live; a waiter-held id gets the raw
                # descriptors (LazyWriteEvent) and the HTTP thread that
                # consumes the result materializes the Event in do().
                if self.wait.is_registered(r.id):
                    lazy = getattr(st, "set_applied_lazy", None)
                    if lazy is not None:
                        return lazy(r.path, r.val, exp)
                    return st.set_applied(r.path, r.val, exp, True)
                return st.set_applied(r.path, r.val, exp, False)
            return st.set(r.path, is_dir=r.dir, value=r.val, expire_time=exp)
        if r.method == METHOD_DELETE:
            if r.prev_index or r.prev_value:
                return st.compare_and_delete(r.path, r.prev_value,
                                             r.prev_index)
            return st.delete(r.path, is_dir=r.dir, recursive=r.recursive)
        if r.method == METHOD_QGET:
            return st.get(r.path, r.recursive, r.sorted)
        if r.method == METHOD_SYNC:
            st.delete_expired_keys(r.time)
            self._sync_pending.pop(g, None)
            return None
        raise errors.EtcdError(errors.ECODE_INVALID_FORM,
                               cause=f"bad method {r.method}")

    # ------------------------------------------------------------------
    # host surgery: conf changes + snapshot install
    # ------------------------------------------------------------------

    def _check_mask(self) -> None:
        """Liveness watchdog (EngineConfig.mask_check_rounds): the device
        peer_mask must ALWAYS equal the host h_mask — membership flows
        only host -> device through _apply_conf/_restore, in the round
        thread, with h_mask written first. Any divergence is therefore
        device buffer corruption, which would silence every cross-slot
        send AND suppress campaigns — a permanent wedge. Repair from the
        host copy (a fresh tensor); recovery then needs no further help —
        the next tick's heartbeat timeout resumes the leader's paused
        probes and replication catches up."""
        m = _host(self.st.peer_mask)
        if np.array_equal(m, self.h_mask):
            return
        self.mask_repairs += 1
        bad = int((m != self.h_mask).any(axis=1).sum())
        log.warning("device peer_mask diverged from host mask in %d "
                    "group(s) at round %d (repair #%d) — restoring",
                    bad, self.round_no, self.mask_repairs)
        self.st = self.st._replace(
            peer_mask=self._dev("peer_mask", self.h_mask.copy()))

    def _apply_conf(self, g: int, op: str, slot: int,
                    admin: bool = False) -> None:
        """Flip a membership bit at a committed boundary and reset the
        affected progress/vote columns (reference raft.go addNode/
        removeNode + multinode.go:181-218). admin=True flips come from the
        tenant-lifecycle path, which never incremented the outstanding-conf
        counter — decrementing would steal a concurrent real conf change's
        count and disable its committed-conf binding scan."""
        add = (op == "add")
        if not admin:
            with self._lock:   # pairs with conf_change's locked increment
                self._confs_outstanding = max(0, self._confs_outstanding - 1)
        self.h_mask[g, slot] = add
        mask = self._dev("peer_mask", self.h_mask)

        st = self.st
        if add:
            # Fresh empty follower state in the slot.
            def zero_at(name, a):
                arr = _host(a)
                arr[g, slot] = 0
                return self._dev(name, arr)

            ring = _host(st.log_term)
            ring[g, slot] = 0
            nxt = _host(st.next)
            nxt[g, :, slot] = 1        # every potential leader probes from 1
            match = _host(st.match)
            match[g, :, slot] = 0
            prs = _host(st.pr_state)
            prs[g, :, slot] = 0        # PR_PROBE
            paused = _host(st.paused)
            paused[g, :, slot] = False
            votes = _host(st.votes)
            votes[g, :, slot] = 0
            self.st = st._replace(
                peer_mask=mask,
                term=zero_at("term", st.term), vote=zero_at("vote", st.vote),
                commit=zero_at("commit", st.commit),
                lead=zero_at("lead", st.lead),
                state=zero_at("state", st.state),
                elapsed=zero_at("elapsed", st.elapsed),
                last_index=zero_at("last_index", st.last_index),
                log_term=self._dev("log_term", ring),
                next=self._dev("next", nxt),
                match=self._dev("match", match),
                pr_state=self._dev("pr_state", prs),
                paused=self._dev("paused", paused),
                votes=self._dev("votes", votes))
            self.h_ring[g, slot] = 0
            self.h_last[g, slot] = 0
            self.h_term[g, slot] = 0
            self.h_vote[g, slot] = 0
            self.h_commit[g, slot] = 0
            self.h_state[g, slot] = 0
        else:
            # Freeze the removed slot as an inert follower so a stale
            # LEADER row can never win leader_slot() again.
            stat = _host(st.state)
            stat[g, slot] = 0
            lead = _host(st.lead)
            lead[g, slot] = 0
            self.st = st._replace(peer_mask=mask,
                                  state=self._dev("state", stat),
                                  lead=self._dev("lead", lead))
            self.h_state[g, slot] = 0

    def _fail_violation(self, viol: np.ndarray) -> None:
        """NH_VIOLATION is a protocol-violation DETECTOR (an append
        conflicted at/below a committed index — reference log.go
        maybeAppend panics on this). Dump the flagged groups' full device
        state plus the recent WAL rounds for offline diagnosis, then
        refuse to continue: papering over it would let diverged state
        serve reads as if committed."""
        import os
        flagged = [int(g) for g in np.nonzero(viol.any(axis=1))[0]]
        arrays = {k: _host(getattr(self.st, k)) for k in (
            "term", "vote", "commit", "lead", "state", "last_index",
            "log_term", "match", "next", "pr_state", "need_host")}
        dump = {
            "round": self.round_no,
            "flagged": {str(g): {
                "slots": [int(p) for p in np.nonzero(viol[g])[0]],
                "applied": int(self.applied[g]),
                "mask": np.asarray(self.h_mask[g]).tolist(),
                **{k: np.asarray(v[g]).tolist() for k, v in arrays.items()},
            } for g in flagged},
            "recent_rounds": [{
                "round": r.round_no,
                "hs": [[int(a), int(b), int(c), int(d), int(e)]
                       for a, b, c, d, e in zip(r.hs_g, r.hs_p, r.hs_term,
                                                r.hs_vote, r.hs_commit)],
                "ring": [[int(a), int(b), int(c), int(d)]
                         for a, b, c, d in zip(r.ring_g, r.ring_p,
                                               r.ring_i, r.ring_t)],
                "entries": [[g, i, t, len(p)] for g, i, t, p in r.entries],
                "confs": list(r.confs),
            } for r in self._recent_recs],
        }
        ddir = os.path.join(self.cfg.data_dir, "diagnostics")
        os.makedirs(ddir, exist_ok=True)
        path = os.path.join(ddir, f"violation-{self.round_no:016x}.json")
        with open(path, "w") as f:
            json.dump(dump, f)
        log.critical("engine: CONSENSUS SAFETY VIOLATION in groups %s "
                     "(conflict at/below commit); state dumped to %s",
                     flagged, path)
        # Flight-recorder auto-dump: the last <ring> rounds' stage
        # timeline, beside the state dump.
        self.obs.flight.dump(self.cfg.data_dir,
                             f"violation-{self.round_no:016x}")
        raise EngineViolation(
            f"conflict at/below commit in groups {flagged}; dump: {path}")

    def _service_need_host(self, need_host: np.ndarray) -> None:
        """Consume need_host flags: for each flagged group with a live
        leader, snapshot-install every active follower whose needed entries
        fell below the leader's ring window (the host side of MsgSnap,
        reference raft.go:246-260 + etcdserver snapshot catch-up §3.5)."""
        st = self.st
        W = self.cfg.window
        flagged = np.nonzero(need_host.any(axis=1))[0]
        if not len(flagged):
            return
        nxt = _host(st.next)
        match = _host(st.match)
        prs = _host(st.pr_state)
        paused = _host(st.paused)
        term = self.h_term.copy()
        vote = self.h_vote.copy()
        commit = self.h_commit.copy()
        lastv = self.h_last.copy()
        ring = self.h_ring.copy()
        lead = _host(st.lead)
        stat = self.h_state.copy()
        elapsed = _host(st.elapsed)
        touched = False
        for g in flagged:
            g = int(g)
            s = self.leader_slot(g)
            if s < 0:
                continue
            c = int(commit[g, s])
            for f in np.nonzero(self.h_mask[g])[0]:
                f = int(f)
                if f == s:
                    continue
                # Lagging = the kernel's need_snap condition: entries from
                # next are no longer resolvable from the leader's ring
                # (next <= last - W; see kernel ents_ok/sendable).
                if nxt[g, s, f] > lastv[g, s] - W:
                    continue  # still reachable by appends
                if term[g, f] > term[g, s]:
                    continue  # follower is ahead in term; let raft sort it
                log.info("engine: snapshot-install g=%d slot=%d from "
                         "leader=%d commit=%d", g, f, s, c)
                if term[g, f] < term[g, s]:
                    vote[g, f] = 0
                term[g, f] = term[g, s]
                # Copy the leader's ring, but zero slots holding leader
                # entries ABOVE the install point: on the follower those
                # positions alias indices c-W..c and would otherwise carry
                # wrong terms (the device never reads them below commit,
                # but the WAL ring-diff would record the junk).
                row = ring[g, s].copy()
                l_s = int(lastv[g, s])
                for w in range(W):
                    if l_s - ((l_s - w) % W) > c:
                        row[w] = 0
                ring[g, f] = row
                lastv[g, f] = c
                commit[g, f] = c
                stat[g, f] = 0
                lead[g, f] = s + 1
                elapsed[g, f] = 0
                match[g, s, f] = c
                nxt[g, s, f] = c + 1
                prs[g, s, f] = 1       # PR_REPLICATE
                paused[g, s, f] = False
                touched = True
        nh = np.zeros_like(need_host)
        if touched:
            # Mirrors stay pre-surgery (see NOTE below); the next round
            # must therefore run the FULL readback so its diff journals
            # the install — a compact (device-vs-device) diff cannot see
            # surgery that happened between rounds.
            self._force_full = True
            self.st = st._replace(
                term=self._dev("term", term), vote=self._dev("vote", vote),
                commit=self._dev("commit", commit),
                last_index=self._dev("last_index", lastv),
                log_term=self._dev("log_term", ring),
                lead=self._dev("lead", lead),
                state=self._dev("state", stat),
                elapsed=self._dev("elapsed", elapsed),
                match=self._dev("match", match), next=self._dev("next", nxt),
                pr_state=self._dev("pr_state", prs),
                paused=self._dev("paused", paused),
                need_host=self._dev("need_host", nh))
            # NOTE: the h_* mirrors deliberately KEEP their pre-surgery
            # values — the next round's WAL diff then records the install's
            # term/commit/ring/last changes, making it durable.
        else:
            self.st = st._replace(need_host=self._dev("need_host", nh))

    # ------------------------------------------------------------------
    # checkpoint
    # ------------------------------------------------------------------

    def _checkpoint(self) -> None:
        import base64 as _b64
        state = {
            "round": self.round_no - 1,
            "term": np_b64(self.h_term), "vote": np_b64(self.h_vote),
            "commit": np_b64(self.h_commit), "last": np_b64(self.h_last),
            "ring": np_b64(self.h_ring), "mask": np_b64(self.h_mask),
            "applied": np_b64(self.applied),
            "stores": {str(g): s.save().decode()
                       for g, s in self._stores.items()},
            "payloads": [
                (g, i, t, _b64.b64encode(p).decode())
                for (g, i, t), p in self.payloads.items()
                if i > self.applied[g]],
        }
        self.wal.save_checkpoint(self.round_no - 1, state)

    def _gc_payloads(self) -> None:
        dead = [k for k in self.payloads if k[1] <= self.applied[k[0]]]
        for k in dead:
            del self.payloads[k]
            self.payload_reqs.pop(k, None)
        # Reconcile the conf counter: a conf entry superseded by leader
        # turnover never applies (so never decrements) and would pin the
        # committed-conf scan on forever. Recompute from ground truth —
        # un-applied admitted conf payloads PLUS confs still queued
        # (enqueued but unadmitted ones aren't in the payload store yet).
        with self._lock:
            self._confs_outstanding = sum(
                1 for (g, i, t), p in self.payloads.items()
                if p and p[0] == P_CONF and i > self.applied[g]) + sum(
                1 for dq in self._pending
                for it in dq if it[1] and it[1][0] == P_CONF)
