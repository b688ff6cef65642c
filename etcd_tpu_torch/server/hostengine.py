"""HostEngine: the multi-host MultiEngine — N processes, each owning one
peer-slot column of every Raft group, on one of two data planes.

The counterpart of the JAX package's `server/hostengine.py`, its host
logic copied as it is. Host h owns peer slot h of every group and steps
the slots round (`ops/kernel.py::step_routed_slots_auto`, hops=1) on its
own device ("cuda" unless the config says "cpu"). What the reference
moves over rafthttp that is not index metadata rides the frame transport
(parallel/frames.py): forwarded client proposals, entry payload fan-out,
payload catch-up pulls and snapshot images. The consensus metadata
(votes, appends, acks) rides one of two data planes:

- "collective" (the default, as in the JAX package): the hosts are the
  peers axis of a (1, P) mesh. Each host holds only its own column,
  (G, 1, ...) with the target-peer axis whole, and steps the round on
  that block with a `ProcessComm` (parallel/comm.py) on the
  `torch.distributed` process group (world = peers, rank = host id):
  the mailbox is an all-to-all per round, the quiescence vote and the
  peer_mask gather are collectives too. A dead host stalls every group
  until the supervisor restarts the whole job; each host then replays
  its own WAL. Quorum GETs at a leader column take the zero-append read
  plane (_quorum_read / _confirm_reads).
- "frames": every host steps the full (G, P) round on its own device, is
  authoritative for its own column only, and exchanges the per-round
  mailbox rows of its column over the frame transport. No collective and
  no process group: hosts fail independently like reference members
  (rafthttp peers, peer.go:87-190) — a dead host's frames just stop, its
  groups re-elect among the survivors within the election timeout, and a
  quorum keeps committing throughout (raft.go:323-332). The dead host
  rejoins by restarting on its own data dir, or on an empty one fenced
  by the supervisor's term floor (see _load_term_floor) through the
  cross-host snapshot-install path. Several frames engines can share one
  process and one device (the tests do).

Five rank processes of either plane share one card in chip_smoke.py.

Durability model (reference per-member WAL, etcdserver/raft.go:112-172):
every host journals its own slot column's per-round deltas plus every
entry payload it admits or receives to its own EngineWAL, and fsyncs
before its next round can deliver anything to another host — the
persist-before-send contract (raft/doc.go:31-39). On the frames plane the
round's mailbox frames are sent after the fsync. On the collective plane
round k's outbox is exchanged by the all-to-all at the end of round k's
step, but it is consumed by round k+1's step, whose first collective (the
peer_mask gather, then the quiescence vote) no host passes before every
host has entered that step, i.e. after every host's WAL append and fsync
of round k returned. Every host applies every group's store and
acks a client request only after its own fsync + apply, so an acked write
is always reconstructable from the acking host's WAL alone.

Proposal flow: a client hits any host; if the leader slot of the target
group is local it stages directly (per-slot proposal counts, no
cross-host agreement needed); otherwise the request forwards to the
leader's host over a PROPOSE frame (nonblocking, bounded, drop = client
timeout — reference peer.go:156-165 semantics).

What differs from the JAX package's module:

- Device state is a GroupState of torch tensors. State surgery builds a
  fresh field with this host's column assigned; nothing writes into a
  tensor an earlier state still holds. The JAX package donates the state
  to its jitted step where the backend allows; eager PyTorch has no
  donation.
- The collective plane's process group is `torch.distributed`'s default
  group, initialised by the caller (tools/multihost_engine.py does it
  from MHE_COORD). Its round is the port's block round: the cross-host
  points are named comm calls, where the JAX package lets XLA insert
  them into one SPMD program.
- hops must be 1 on both planes (the JAX package checks it on the frames
  plane; on the collective plane it is the documented requirement of
  step_routed_slots_auto).
- The frames round builds only the inbox row this host receives (to ==
  its slot) on the host, the only row the JAX package's host-built
  (G, P, P, F) inbox ever fills, and places it into a zeroed device
  inbox.
"""
from __future__ import annotations

import json
import logging
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from etcd_tpu_torch import errors
from etcd_tpu_torch.parallel.frames import FrameTransport
from etcd_tpu_torch.server.engine import (P_MULTI, P_REQ, _pack_entry,
                                          _unpack_multi)
from etcd_tpu_torch.server.enginewal import (EngineWAL, RoundRecord, b64_np,
                                             np_b64)
from etcd_tpu_torch.server.request import (METHOD_DELETE, METHOD_GET,
                                           METHOD_POST, METHOD_PUT,
                                           METHOD_QGET, METHOD_SYNC, Request)
from etcd_tpu_torch.server import obs as obs_mod
from etcd_tpu_torch.store import new_store
from etcd_tpu_torch.store.event import LazyWriteEvent
from etcd_tpu_torch.utils import idutil, metrics
from etcd_tpu_torch.utils.wait import Wait

log = logging.getLogger("etcd_tpu.hostengine")

_LEADER = 2
_MAX_HOPS = 3


@dataclass
class HostEngineConfig:
    groups: int
    peers: int                 # == number of hosts (one slot column each)
    data_dir: str              # THIS host's WAL/checkpoint dir
    host_id: int
    frame_listen: Tuple[str, int]
    frame_peers: Dict[int, Tuple[str, int]] = field(default_factory=dict)
    window: int = 32
    max_ents: int = 8
    election_tick: int = 10
    heartbeat_tick: int = 3
    fsync: bool = True
    checkpoint_rounds: int = 4096
    request_timeout: float = 10.0
    batch_max: int = 4096
    batch_bytes: int = 1 << 20   # reference maxSizePerMsg, raft.go:48
    round_interval: float = 0.0
    stagger: bool = True
    pull_interval: float = 0.25    # payload catch-up request pacing
    # Message hops per round. MUST remain 1 in
    # multi-host deployments: with hops>1 the leader would quorum-commit
    # on follower acks produced before those hosts journaled the entries
    # (kernel.step_routed_slots_auto's durability constraint) — an
    # acked write could then be lost to a follower-host crash. The
    # latency win here comes from the quiescent fast path alone.
    hops: int = 1
    # Fault injection (tests/chaos, reference rafthttp.Pausable analogue):
    # drop this percentage of outgoing per-peer PAYLOAD fan-out frames,
    # forcing the receiving hosts onto the PULL catch-up path. Seeded for
    # reproducible soaks.
    drop_pay_pct: float = 0.0
    fault_seed: int = 0
    # Cross-host snapshot install (the rafthttp snapshot side-channel,
    # reference peer.go:250-252): per-(group, target) resend holdoff and a
    # per-round cap on shipped images (bounds frame bytes and round time
    # during a mass catch-up, e.g. a host restarting with an empty disk).
    snap_interval: float = 1.0
    snaps_per_round: int = 128
    # Consensus data plane:
    #   "collective" — the hosts are the peers axis of a (1, P) mesh: each
    #     holds its own column and the votes/appends/acks ride an
    #     all-to-all on the torch.distributed process group (gloo or
    #     nccl; the caller initialises it). One dead host stalls EVERY
    #     group until the supervisor restarts the whole job: availability
    #     is traded for a dense data plane with no serialization.
    #   "frames" — every host runs the FULL (G, P) kernel on its own
    #     device, authoritative for its own peer-slot column only, and
    #     the per-round mailbox metadata rides the frame transport like
    #     payloads already do (sparse-encoded per-peer slices). No
    #     collective, no global process group: hosts fail INDEPENDENTLY
    #     exactly like reference members (rafthttp peers, peer.go:87-190)
    #     — a dead host's frames just stop, its groups' leaders re-elect
    #     among the survivors within the election timeout, and quorum
    #     n/2+1 keeps committing throughout (raft.go:323-332 semantics).
    #     The dead host rejoins by simply restarting: probes repair its
    #     lag via appends, or the snapshot-install path ships images.
    #     Cost: each host steps P columns but exports only its own (the
    #     P-1 ghost columns evolve as message-starved candidates and are
    #     never read), and metadata latency is frame-paced.
    data_plane: str = "collective"
    # Where the consensus state lives and the rounds run: "cuda" (the
    # card; the default) or "cpu". A "cuda" engine on a machine without
    # a card refuses to start, before it touches the data dir.
    device: str = "cuda"


class HostEngine:
    """One host's share of the multi-host MultiEngine."""

    def __init__(self, cfg: HostEngineConfig) -> None:
        import torch
        from etcd_tpu_torch.ops.kernel import step_routed_slots_auto
        from etcd_tpu_torch.ops.state import KernelConfig, init_state

        if cfg.data_plane not in ("collective", "frames"):
            raise ValueError(f"data_plane={cfg.data_plane!r}: expected "
                             "'collective' or 'frames'")
        # hops=1 keeps persist-before-send across hosts
        # (kernel.step_routed_slots_auto's durability constraint).
        if cfg.hops != 1:
            raise ValueError(f"{cfg.data_plane} data plane requires hops=1 "
                             "(persist-before-send across hosts)")
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"HostEngineConfig.device={cfg.device!r} but no CUDA "
                    "device is available; pass device='cpu' to run on the "
                    "CPU")
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self._torch = torch
        self._step = step_routed_slots_auto
        self.cfg = cfg
        G, Pn, W = cfg.groups, cfg.peers, cfg.window
        self.kcfg = KernelConfig(
            groups=G, peers=Pn, window=W, max_ents=cfg.max_ents,
            election_tick=cfg.election_tick,
            heartbeat_tick=cfg.heartbeat_tick)
        self.my_slot = cfg.host_id
        self._frames_plane = cfg.data_plane == "frames"
        self._comm = None
        if not self._frames_plane:
            # The (1, P) mesh of the collective plane: one process per
            # peer column on the torch.distributed default group.
            import torch.distributed as dist
            from etcd_tpu_torch.parallel.comm import ProcessComm
            if not dist.is_initialized():
                raise RuntimeError(
                    "the collective data plane needs torch.distributed "
                    "initialised (world size = peers, rank = host_id); "
                    "tools/multihost_engine.py does it from MHE_COORD")
            self._comm = ProcessComm()
            if self._comm.peers != Pn:
                raise ValueError(
                    f"multi-host engine needs one process per peer slot: "
                    f"{self._comm.peers} ranks for peers={Pn}")
            if self._comm.rank != self.my_slot:
                raise ValueError(
                    f"host_id {self.my_slot} must equal the process-group "
                    f"rank {self._comm.rank} (the column order)")
        # Per-sender queues of sparse mailbox frames (bounded: a slower
        # host drops OLDEST — raft retransmits; reference drop-on-full,
        # peer.go:156-165) + our own self-loop slice (frames plane).
        self._meta_rx: Dict[int, deque] = {}
        self._bad_meta_senders: set = set()
        self._self_loop: Optional[np.ndarray] = None
        # The collective plane's routed inbox, this column's block
        # (G, 1, P, F), kept on the device round to round.
        self.inbox = None

        self._check_geometry()
        self.wal = EngineWAL(cfg.data_dir, fsync=cfg.fsync)
        self.wait = Wait()
        self.reqid = idutil.Generator(cfg.host_id + 1)
        self._pending: List[deque] = [deque() for _ in range(G)]
        self._dirty: set = set()
        self._staged: Dict[int, List[List[Tuple[int, bytes]]]] = {}
        self._stores: Dict[int, Any] = {}
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.round_no = 0
        self.round_ms_ewma = 0.0
        self.acked_requests = 0
        self.failed: Optional[Exception] = None
        self._recent_recs: deque = deque(maxlen=8)
        # The read plane (collective plane only; see _quorum_read):
        # parked quorum reads awaiting a leadership confirmation, and
        # ripe ones awaiting the apply cursor. Both under self._lock.
        self._reads: List[deque] = [deque() for _ in range(G)]
        self._read_dirty: set = set()
        self._reads_waiting = 0
        self._ripe: List[deque] = [deque() for _ in range(G)]
        self._ripe_dirty: set = set()
        self._ripe_waiting = 0

        # Local column mirrors (this host's slot of every group).
        self.l_term = np.zeros(G, np.int32)
        self.l_vote = np.zeros(G, np.int32)
        self.l_commit = np.zeros(G, np.int32)
        self.l_state = np.zeros(G, np.int32)
        self.l_last = np.zeros(G, np.int32)
        self.l_lead = np.zeros(G, np.int32)     # leader slot+1 as we know it
        self.l_ring = np.zeros((G, W), np.int32)
        self.applied = np.zeros(G, np.int64)
        self.payloads: Dict[Tuple[int, int, int], bytes] = {}

        # Inbound frames (filled by transport threads, drained per round).
        self._rx: deque = deque()
        # rid -> forward hop count for requests that arrived via PROPOSE
        # frames (loop protection when leadership views are crossed).
        self._hops: Dict[int, int] = {}
        self._fresh_payloads: List[Tuple[int, int, int, bytes]] = []
        self._missing: Dict[Tuple[int, int, int], float] = {}
        self._last_pull = 0.0
        self.unreachable: Dict[int, int] = {}
        import random as _random
        self._fault_rng = (_random.Random(cfg.fault_seed)
                           if cfg.drop_pay_pct > 0 else None)
        self.pay_frames_dropped = 0
        self.pulls_sent = 0
        self.payloads_pulled = 0
        self.appends_cut = 0
        # Cross-host snapshot install state: staged inbound installs
        # (g -> newest (a, term, lead, ring_row, store_blob)), records to
        # journal this round, per-(g, target) send holdoff, counters.
        self._pending_snaps: Dict[int, Tuple[int, int, int, np.ndarray,
                                             bytes]] = {}
        self._snap_recs: List[Tuple[int, int, bytes]] = []
        self._snap_sent: Dict[Tuple[int, int], float] = {}
        self._hist: Dict[Tuple[int, int], int] = {}
        self.snaps_sent = 0
        self.snaps_installed = 0

        self.frames = FrameTransport(
            cfg.host_id, cfg.frame_listen, cfg.frame_peers,
            on_frame=self._on_frame,
            report_unreachable=self._report_unreachable)

        ckpt_round, ckpt = self.wal.load_checkpoint()
        recs = list(self.wal.replay(after_round=ckpt_round))
        base = init_state(self.kcfg, stagger=cfg.stagger, device=self.device)
        floor = self._load_term_floor() if ckpt is None else None
        if ckpt is not None or recs or floor is not None:
            self._restore(base, ckpt_round, ckpt, recs, floor)
        else:
            self.st = base
        if not self._frames_plane:
            # Keep this host's column only: the block it steps.
            from etcd_tpu_torch.parallel.mesh import state_block
            my = self.my_slot
            self.st = state_block(self.st, 0, None, my, my + 1)
            self.inbox = torch.zeros((G, 1, Pn, self.kcfg.fields),
                                     dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    # boot / restore
    # ------------------------------------------------------------------

    def _check_geometry(self) -> None:
        import os
        from etcd_tpu_torch.utils.fileutil import touch_dir_all
        touch_dir_all(self.cfg.data_dir)
        path = os.path.join(self.cfg.data_dir, "geometry.json")
        want = {"groups": self.cfg.groups, "peers": self.cfg.peers,
                "window": self.cfg.window, "host": self.cfg.host_id}
        if os.path.exists(path):
            with open(path) as f:
                have = json.load(f)
            if have != want:
                raise ValueError(
                    f"host-engine data dir {self.cfg.data_dir} was "
                    f"initialized with {have}, refusing {want}")
        else:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(want, f)
            os.replace(tmp, path)

    def _global_col(self, base_col: np.ndarray,
                    local_col: np.ndarray) -> np.ndarray:
        """A copy of the state array `base_col` (numpy, the JAX package's
        dtypes) whose THIS-host column holds restored local data; the
        other columns keep base values — they are local ghosts, never
        exported."""
        blk = base_col.copy()
        blk[:, self.my_slot] = local_col
        return blk

    def _load_term_floor(self) -> Optional[np.ndarray]:
        """Per-group term floor written by the degraded-restart supervisor
        into an EMPTY data dir (this host's disk was lost with the host):
        the elementwise max of every survivor's recorded terms, PLUS ONE.
        Booting at the floor with a clear vote fences the lost vote
        records: the earliest term this host can now grant at is the
        floor, and no pre-crash election can have completed at any term
        >= floor — completion needs a durable grant on a survivor (round
        records fsync term+log diffs atomically), and all survivors'
        durable terms are <= floor-1. The +1 (vs the elementwise max)
        closes the boundary race where one survivor durably recorded an
        election won at exactly max(survivor terms) with the dead host's
        lost grant while a lagging survivor still reads one term lower
        and would re-campaign at that same term. Ignored once a
        checkpoint exists (the checkpoint carries full term state
        recorded while the floor was in effect)."""
        import os
        path = os.path.join(self.cfg.data_dir, "term_floor.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            floor = np.asarray(json.load(f)["term"], np.int32)
        if floor.shape != (self.cfg.groups,):
            raise ValueError(
                f"term_floor.json has {floor.shape[0]} groups, "
                f"engine has {self.cfg.groups}")
        log.info("host %d: booting with a term floor (max %d) from the "
                 "degraded-restart supervisor", self.my_slot,
                 int(floor.max(initial=0)))
        return floor

    def _restore(self, base, ckpt_round: int, ckpt: Optional[dict],
                 recs: List[RoundRecord],
                 floor: Optional[np.ndarray] = None) -> None:
        """Rebuild THIS host's column from its checkpoint + WAL replay;
        every slot restarts as a follower (reference RestartNode)."""
        from etcd_tpu_torch.ops.state import state_from_numpy, state_to_numpy
        G, W = self.cfg.groups, self.cfg.window

        if floor is not None:
            # Base for diff replay: WAL records after a floor boot were
            # diffs against floor-initialized mirrors.
            self.l_term = floor.copy()
        if ckpt is not None:
            self.l_term = b64_np(ckpt["term"]).astype(np.int32)
            self.l_vote = b64_np(ckpt["vote"]).astype(np.int32)
            self.l_commit = b64_np(ckpt["commit"]).astype(np.int32)
            self.l_last = b64_np(ckpt["last"]).astype(np.int32)
            self.l_ring = b64_np(ckpt["ring"]).astype(np.int32)
            self.applied = b64_np(ckpt["applied"]).astype(np.int64)
            for g_s, blob in ckpt["stores"].items():
                st = new_store(namespaces=("/0", "/1"))
                st.recovery(blob.encode())
                self._stores[int(g_s)] = st
            import base64 as _b64
            for g, i, t, b64p in ckpt["payloads"]:
                self.payloads[(g, i, t)] = _b64.b64decode(b64p)

        # Our column's log-term history (ring window is finite; the
        # committed-but-unapplied span can reach further back).
        slot_log: Dict[int, Dict[int, int]] = {}

        def _log_set(g, i, t):
            slot_log.setdefault(int(g), {})[int(i)] = int(t)

        if ckpt is not None:
            for g in range(G):
                lastv = int(self.l_last[g])
                for w in range(W):
                    i = lastv - ((lastv - w) % W)
                    if i >= 1:
                        _log_set(g, i, self.l_ring[g, w])

        last_round = ckpt_round
        for rec in recs:
            last_round = max(last_round, rec.round_no)
            # Snapshot installs first: the same record's hs/ring/last diffs
            # were computed AFTER the install surgery and land on top.
            for g, a, blob in rec.snaps:
                s = new_store(namespaces=("/0", "/1"))
                s.recovery(blob)
                self._stores[int(g)] = s
                self.applied[int(g)] = a
            for g, t_, v_, c_ in zip(rec.hs_g, rec.hs_term, rec.hs_vote,
                                     rec.hs_commit):
                self.l_term[g] = t_
                self.l_vote[g] = v_
                self.l_commit[g] = c_
            for g, i, t in zip(rec.ring_g, rec.ring_i, rec.ring_t):
                self.l_ring[g, int(i) % W] = t
                _log_set(g, i, t)
            for g, new in zip(rec.last_g, rec.last_v):
                prev = int(self.l_last[g])
                self.l_last[g] = new
                for i in range(max(prev + 1, int(new) - W + 1),
                               int(new) + 1):
                    _log_set(g, i, self.l_ring[g, i % W])
            for g, i, t, payload in rec.entries:
                self.payloads[(g, i, t)] = payload
        self.round_no = last_round + 1

        hist: Dict[Tuple[int, int], int] = {}
        for g, entries in slot_log.items():
            c = int(self.l_commit[g])
            lastv = int(self.l_last[g])
            for i, t in entries.items():
                if t > 0 and i <= c and i <= lastv:
                    hist[(g, i)] = t
        self._apply_committed(trigger=False, hist=hist)
        self._gc_payloads()

        cols = state_to_numpy(base)
        for name, local_col in (("term", self.l_term), ("vote", self.l_vote),
                                ("commit", self.l_commit),
                                ("last_index", self.l_last),
                                ("log_term", self.l_ring)):
            cols[name] = self._global_col(cols[name], local_col)
        self.st = state_from_numpy(cols, self.device)
        # Terms of committed-but-not-yet-applied entries that are (or may
        # fall) below the device ring window: the live apply path resolves
        # from here when the ring has moved on (see _apply_committed).
        # Restore seeds it from the WAL's full ring-diff history; without
        # it, a host restoring with applied < commit — an acked entry's
        # payload lives on the ACKING host and must be pulled — jammed
        # forever once the window passed the stalled span ("no term for
        # committed entry", found by the stale-disk snapshot test).
        # >= applied (not >): the no-op check for the NEXT entry needs the
        # term of the last applied one (see _maybe_noop).
        self._hist = {k: t for k, t in hist.items()
                      if k[1] >= int(self.applied[k[0]])}
        if ckpt is not None:
            for g_s, i_s, t_s in ckpt.get("hist", []):
                if int(i_s) >= int(self.applied[int(g_s)]):
                    self._hist[(int(g_s), int(i_s))] = int(t_s)
        self.l_state = np.zeros(G, np.int32)
        self.l_lead = np.zeros(G, np.int32)

    # ------------------------------------------------------------------
    # frames
    # ------------------------------------------------------------------

    def _report_unreachable(self, h: int) -> None:
        self.unreachable[h] = self.unreachable.get(h, 0) + 1

    def _on_frame(self, frm: int, header: dict, blob: bytes) -> None:
        t = header.get("t")
        if t == "meta":
            # Frames-plane mailbox column from peer `frm`: one frame per
            # sender round, consumed one per local round (the dense
            # mailbox holds ONE message per (g, to, from) slot). Bounded
            # backlog drops OLDEST — raft's retransmission machinery
            # (heartbeats, probes) repairs exactly like a dropped packet.
            # `frm` comes from the unauthenticated handshake and becomes
            # an inbox column: a sender outside the peer slots, or one
            # claiming ours, would stop the round (IndexError) or write
            # another peer's column, so its frames are dropped.
            if not 0 <= frm < self.cfg.peers or frm == self.my_slot:
                if frm not in self._bad_meta_senders:
                    self._bad_meta_senders.add(frm)
                    log.warning("meta frames from host %d dropped: not a "
                                "peer slot of host %d", frm, self.my_slot)
                return
            q = self._meta_rx.get(frm)
            if q is None:
                q = self._meta_rx.setdefault(frm, deque(maxlen=16))
            q.append(blob)
            return
        if t == "pull":
            # Answer immediately from the payload store. Runs on the
            # transport rx thread while the engine thread may GC the
            # dict: snapshot each value with ONE .get per key (GIL-atomic)
            # so a concurrent delete skips that key instead of raising
            # out of the whole response.
            haves = []
            for w in header.get("wants", []):
                key = tuple(w)
                p = self.payloads.get(key)
                if p is not None:
                    haves.append((*key, p))
            if haves:
                # Tagged as a pull RESPONSE so the receiver's repair
                # counter stays exact (a late ordinary fan-out clearing a
                # _missing marker is not a pull repair).
                self.frames.send(frm, {"t": "pay", "pull": 1},
                                 _pack_payloads(haves))
            return
        self._rx.append((frm, header, blob))

    def _take_meta(self) -> List[Tuple[int, bytes]]:
        """This round's mailbox frames, (sender, frame). Normally one per
        sender round. When a backlog built up (transient stall on our
        side), up to 4 per sender — newer frames overwrite overlapping
        group rows (those rows are dropped packets; raft's heartbeat/
        probe machinery retransmits), so the queue recovers to fresh
        instead of serving permanently ~maxlen-round-stale mailboxes."""
        out = []
        for j, q in list(self._meta_rx.items()):
            for _ in range(4):
                try:
                    out.append((j, q.popleft()))
                except IndexError:
                    break
        return out

    def _cut_unpaid(self, idx: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """Cut each append among a peer's mailbox rows (`vals`, a copy,
        for groups `idx`) back to the entries before the first one whose
        payload this host lacks, and want that payload by pull; returns
        `vals`. A host then holds an entry only once it holds its
        payload, so an entry that commits can be applied from any host
        that holds it, whichever of them lives. The reference takes an
        append whole (etcd_tpu/server/hostengine.py:1126-1143): where a
        payload frame was lost (a full send queue drops its oldest, a
        reset connection the frame in flight) the followers held entries
        that only their leader could apply, and the leader's death then
        stopped the group's apply cursor there on every survivor. A
        leader's no-op, the first entry of its term, has no payload. An
        append below our commit index is ignored by the round anyway."""
        from etcd_tpu_torch.ops.state import (F_INDEX, F_LOGTERM, F_NENT,
                                              F_TYPE, M_APP, N_FIXED_FIELDS)
        rows = np.nonzero((vals[:, F_TYPE] == M_APP) & (vals[:, F_NENT] > 0)
                          & (vals[:, F_INDEX] >= self.l_commit[idx]))[0]
        now = time.time()
        for r in rows:
            g, prev = int(idx[r]), int(vals[r, F_INDEX])
            t_prev = int(vals[r, F_LOGTERM])
            for k in range(int(vals[r, F_NENT])):
                t = int(vals[r, N_FIXED_FIELDS + k])
                key = (g, prev + 1 + k, t)
                if t == t_prev and key not in self.payloads:
                    vals[r, F_NENT] = k
                    vals[r, N_FIXED_FIELDS + k:] = 0
                    self._missing.setdefault(key, now)
                    self.appends_cut += 1
                    break
                t_prev = t
        return vals

    def _drain_frames(self) -> None:
        G = self.cfg.groups
        while self._rx:
            try:
                frm, header, blob = self._rx.popleft()
            except IndexError:
                return
            # One malformed/hostile frame must never kill the engine loop
            # (this host would stop serving): validate, log, drop.
            try:
                t = header.get("t")
                if t == "prop":
                    g = int(header["g"])
                    if not 0 <= g < G:
                        raise ValueError(f"group {g} out of range")
                    hops = int(header.get("hops", 0))
                    if hops >= _MAX_HOPS:
                        log.warning("dropping proposal for group %d: hop "
                                    "limit (leadership view unsettled)", g)
                        continue
                    items = _unpack_items(blob)
                    with self._lock:
                        for rid, _ in items:
                            self._hops[rid] = hops
                        self._pending[g].extend(items)
                        self._dirty.add(g)
                elif t == "pay":
                    is_pull_resp = bool(header.get("pull"))
                    for g, i, tt, payload in _unpack_payloads(blob):
                        if not 0 <= g < G:
                            raise ValueError(f"group {g} out of range")
                        key = (g, i, tt)
                        if key not in self.payloads:
                            self.payloads[key] = payload
                            self._fresh_payloads.append((g, i, tt, payload))
                        if (self._missing.pop(key, None) is not None
                                and is_pull_resp):
                            self.payloads_pulled += 1
                elif t == "snap":
                    for g, a, t_s, lead, row, image in _unpack_snaps(
                            blob, self.cfg.window):
                        if not 0 <= g < G:
                            raise ValueError(f"group {g} out of range")
                        cur = self._pending_snaps.get(g)
                        if cur is None or (t_s, a) > (cur[1], cur[0]):
                            self._pending_snaps[g] = (a, t_s, lead, row,
                                                      image)
            except Exception:  # noqa: BLE001 — drop the frame, keep serving
                log.exception("bad frame from host %d dropped", frm)

    # ------------------------------------------------------------------
    # cross-host snapshot install (the rafthttp snapshot side-channel)
    # ------------------------------------------------------------------

    def _local(self, arr) -> np.ndarray:
        """This host's peer-slot column of a state tensor as numpy, shape
        (G, 1, ...): one device-to-host read (the whole block on the
        collective plane, a slice on the frames plane)."""
        if not self._frames_plane:
            return arr.cpu().numpy()
        my = self.my_slot
        return arr[:, my:my + 1].cpu().numpy()

    def _set_local(self, name: str, block: np.ndarray):
        """New tensor for state field `name` whose LOCAL column (our peer
        slot) is `block` — shape (G, 1, ...). Collective plane: the block
        itself, on the device. Frames plane: a clone of the current field
        with the column assigned (the field itself, which earlier states
        may still hold, is never written)."""
        arr = getattr(self.st, name)
        if not self._frames_plane:
            return self._torch.tensor(np.ascontiguousarray(block),
                                      dtype=arr.dtype, device=arr.device)
        arr = arr.clone()
        arr[:, self.my_slot] = self._torch.as_tensor(
            block[:, 0], dtype=arr.dtype, device=arr.device)
        return arr

    def _install_snaps(self) -> None:
        """Receive half of the cross-host MsgSnap flow (reference
        raft.go:671-713 restore; single-host twin _service_need_host):
        surgically move OUR column of each staged group to the shipped
        image — term/ring/last/commit jump to the install point, the store
        is recovered wholesale, and the apply cursor follows. Runs BEFORE
        the round's device step so the step already sees the new state; the
        same round's WAL record carries both the store image (rec.snaps)
        and, via the stale l_* mirrors, the column surgery — fsynced in
        phase 5 before anything is acked on top."""
        G, Pn, W = self.cfg.groups, self.cfg.peers, self.cfg.window
        st = self.st
        local = self._local
        term = local(st.term).copy()         # (G, 1)
        vote = local(st.vote).copy()
        commit = local(st.commit).copy()
        last = local(st.last_index).copy()
        ring = local(st.log_term).copy()     # (G, 1, W)
        state = local(st.state).copy()
        lead = local(st.lead).copy()
        elapsed = local(st.elapsed).copy()
        touched = False
        for g, (a, t_s, lead_slot, row, image) in \
                self._pending_snaps.items():
            # Stale or duplicate: we are not actually behind the image, or
            # the sender's term has been superseded — drop (the reference's
            # restore ignores snapshots at-or-below commit, raft.go:676).
            if a <= int(commit[g, 0]) or t_s < int(term[g, 0]):
                continue
            # Recover the store FIRST: a corrupt image (truncated frame, a
            # buggy peer) must reject this group's install wholesale, not
            # kill the engine loop with the column already surgered — the
            # malformed-frame invariant from _drain_frames extends here.
            s = new_store(namespaces=("/0", "/1"))
            try:
                s.recovery(image)
            except Exception:  # noqa: BLE001 — reject the image, keep going
                log.exception("host %d: rejecting corrupt snapshot image "
                              "g=%d index=%d from slot %d", self.my_slot,
                              g, a, lead_slot)
                continue
            if t_s > int(term[g, 0]):
                vote[g, 0] = 0
            term[g, 0] = t_s
            ring[g, 0, :] = row
            last[g, 0] = a
            commit[g, 0] = a
            state[g, 0] = 0
            lead[g, 0] = lead_slot + 1
            elapsed[g, 0] = 0
            self._stores[g] = s
            self.applied[g] = a
            # The apply cursor jumped: pending pulls for entries at or
            # below the install point can never be answered (they fell
            # below every window — that is WHY a snapshot was needed) and
            # would otherwise occupy the pull budget forever.
            for k in [k for k in self._missing if k[0] == g and k[1] <= a]:
                del self._missing[k]
            for k in [k for k in self._hist if k[0] == g and k[1] < a]:
                del self._hist[k]
            self._snap_recs.append((g, a, image))
            self.snaps_installed += 1
            touched = True
            log.info("host %d: installed snapshot g=%d index=%d term=%d "
                     "from slot %d", self.my_slot, g, a, t_s, lead_slot)
        self._pending_snaps.clear()
        if not touched:
            return
        # l_* mirrors deliberately stay PRE-surgery: phase 4's diff against
        # them journals the install's term/vote/commit/last/ring changes.
        self.st = st._replace(
            term=self._set_local("term", term),
            vote=self._set_local("vote", vote),
            commit=self._set_local("commit", commit),
            last_index=self._set_local("last_index", last),
            log_term=self._set_local("log_term", ring),
            state=self._set_local("state", state),
            lead=self._set_local("lead", lead),
            elapsed=self._set_local("elapsed", elapsed))

    def _send_snapshots(self, flagged: np.ndarray, st):
        """Leader half of the cross-host MsgSnap flow (reference
        raft.go:246-260 sendAppend->MsgSnap + the rafthttp pipeline
        side-channel, peer.go:250-252): for each flagged group we lead,
        ship (store image @ our apply cursor a, ring row masked above a,
        term/lead metadata) to every slot whose needed entries fell below
        our ring window, then optimistically probe at a+1. `match` is NOT
        advanced — quorum commit only ever rides real acks — so a lost
        frame or a dead receiver just re-fires need_snap after the
        holdoff: self-healing without a ReportSnapshot protocol. Returns
        the (possibly progress-surgered) state."""
        W = self.cfg.window
        Pn = self.cfg.peers
        now = time.time()
        local = self._local
        nxt = local(st.next).copy()          # (G, 1, P)
        by_host: Dict[int, List[Tuple[int, int, int, int, np.ndarray,
                                      bytes]]] = {}
        surgery = []
        budget = self.cfg.snaps_per_round
        for g in flagged:
            g = int(g)
            if budget <= 0:
                break
            if self.l_state[g] != _LEADER:
                continue
            a = int(self.applied[g])
            lastv = int(self.l_last[g])
            # The probe after install sends from a+1, whose previous-entry
            # term (index a) must still be in OUR ring: if our applier is
            # further behind than the window reaches back, retry next
            # holdoff once it catches up.
            if a < 1 or a <= lastv - W:
                continue
            row = image = None
            for f in range(Pn):
                if f == self.my_slot or budget <= 0:
                    continue
                if int(nxt[g, 0, f]) > lastv - W:
                    continue                   # reachable by appends
                if now - self._snap_sent.get((g, f), 0.0) \
                        < self.cfg.snap_interval:
                    continue
                if image is None:
                    image = self.store(g).save()
                    row = self.l_ring[g].copy()
                    for w in range(W):
                        if lastv - ((lastv - w) % W) > a:
                            row[w] = 0
                self._snap_sent[(g, f)] = now
                by_host.setdefault(f, []).append(
                    (g, a, int(self.l_term[g]), self.my_slot, row, image))
                surgery.append((g, f, a))
                budget -= 1
                self.snaps_sent += 1
        for f, snaps in by_host.items():
            self.frames.send(f, {"t": "snap"}, _pack_snaps(snaps))
        if not surgery:
            return st
        prs = local(st.pr_state).copy()      # (G, 1, P)
        pau = local(st.paused).copy()
        age = local(st.ack_age).copy()
        for g, f, a in surgery:
            nxt[g, 0, f] = a + 1
            prs[g, 0, f] = 0                 # PR_PROBE
            pau[g, 0, f] = False
            age[g, 0, f] = 0
        log.info("host %d: sent %d snapshot installs (%d groups flagged)",
                 self.my_slot, len(surgery), len(flagged))
        return st._replace(
            next=self._set_local("next", nxt),
            pr_state=self._set_local("pr_state", prs),
            paused=self._set_local("paused", pau),
            ack_age=self._set_local("ack_age", age))

    # ------------------------------------------------------------------
    # public API (same shape as MultiEngine where it makes sense)
    # ------------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"host-engine-{self.my_slot}")
        self._thread.start()

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=15)
        self._fail_parked_reads("engine stopped")
        self.frames.stop()
        self.wal.close()

    def store(self, g: int):
        s = self._stores.get(g)
        if s is None:
            with self._lock:
                s = self._stores.get(g)
                if s is None:
                    s = self._stores[g] = new_store(namespaces=("/0", "/1"))
        return s

    def leader_slot(self, g: int) -> int:
        if self.l_state[g] == _LEADER:
            return self.my_slot
        return int(self.l_lead[g]) - 1   # -1 when unknown

    def wait_leaders(self, timeout: float = 60.0, groups=None) -> bool:
        deadline = time.monotonic() + timeout
        gs = range(self.cfg.groups) if groups is None else groups
        while time.monotonic() < deadline:
            if all(self.leader_slot(g) >= 0 for g in gs):
                return True
            time.sleep(0.01)
        return False

    def tenant_active(self, g: int) -> bool:
        return 0 <= g < self.cfg.groups

    def tenants(self) -> List[int]:
        return list(range(self.cfg.groups))

    def create_tenant(self, *a, **kw):
        raise errors.EtcdError(errors.ECODE_NOT_FILE,
                               cause="tenant lifecycle is single-host-"
                                     "engine only (multi-host pool is "
                                     "fixed at boot)")

    remove_tenant = create_tenant

    def conf_change(self, *a, **kw):
        raise errors.EtcdError(errors.ECODE_NOT_FILE,
                               cause="per-group membership is the peers "
                                     "mesh axis in multi-host mode")

    @property
    def tenant_gen(self) -> np.ndarray:
        # Fixed pool: slots are never recycled, so every tenant stays at
        # lifecycle generation 0 (the TenantAPI cache key). Cached — this
        # sits on the per-request path.
        gen = getattr(self, "_tenant_gen0", None)
        if gen is None:
            gen = self._tenant_gen0 = np.zeros(self.cfg.groups, np.int64)
        return gen

    @property
    def h_commit(self) -> np.ndarray:
        return self.l_commit[:, None]

    @property
    def h_term(self) -> np.ndarray:
        return self.l_term[:, None]

    @property
    def h_mask(self) -> np.ndarray:
        return np.ones((self.cfg.groups, self.cfg.peers), bool)

    def status(self, g: int) -> dict:
        return {"group": g, "lead": self.leader_slot(g),
                "term": int(self.l_term[g]),
                "commit": int(self.l_commit[g]),
                "applied": int(self.applied[g]),
                "host": self.my_slot,
                "active_slots": list(range(self.cfg.peers))}

    def do(self, g: int, r: Request, timeout: Optional[float] = None) -> Any:
        """Serve one request against group g from THIS host (reads local;
        writes ride consensus and ack after LOCAL fsync+apply)."""
        if r.method == METHOD_GET:
            if r.quorum:
                if (not r.wait and not self._frames_plane
                        and self.l_state[g] == _LEADER):
                    # Zero-append read plane, collective plane only: the
                    # collective round is globally synchronous, so
                    # leadership confirmation needs no extra messages
                    # (see _confirm_reads). Frames-plane hosts and
                    # non-leader columns keep the QGET forward path.
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
        q = self.wait.register(r.id)
        payload = bytes([P_REQ]) + r.encode()
        with self._lock:
            self._pending[g].append((r.id, payload))
            self._dirty.add(g)
        import queue as _q
        t0 = time.perf_counter()
        metrics.propose_pending.inc()
        try:
            result = q.get(timeout=timeout or self.cfg.request_timeout)
        except _q.Empty:
            self.wait.cancel(r.id)
            metrics.propose_failed.inc()
            raise errors.EtcdError(errors.ECODE_RAFT_INTERNAL,
                                   cause="request timed out",
                                   index=int(self.applied[g]))
        finally:
            metrics.propose_pending.dec()
        metrics.propose_durations.observe(
            (time.perf_counter() - t0) * 1000.0)
        if isinstance(result, errors.EtcdError):
            raise result
        if type(result) is LazyWriteEvent:
            # Waiter woken with raw C descriptors: materialize the Event
            # here on the serving thread (see MultiEngine.do).
            return result.resolve()
        return result

    # ------------------------------------------------------------------
    # the read plane (collective plane; see MultiEngine._quorum_read)
    # ------------------------------------------------------------------

    def _quorum_read(self, g: int, r: Request,
                     timeout: Optional[float] = None) -> Any:
        """Linearizable GET without a log entry: park the read, confirm
        leadership at the next round's readback, serve from the local
        store once the apply cursor reaches the captured commit index.
        Quorum reads leave etcd_server_proposal_* (nothing is proposed)
        and meter the read_index_* families."""
        if r.id == 0:
            r = Request(**{**r.__dict__, "id": self.reqid.next()})
        q = self.wait.register(r.id)
        import queue as _q
        t0 = time.perf_counter()
        obs_mod.read_index_parked.inc()
        with self._lock:
            self._reads[g].append((r.id, r))
            self._read_dirty.add(g)
            self._reads_waiting += 1
        try:
            result = q.get(timeout=timeout or self.cfg.request_timeout)
        except _q.Empty:
            self.wait.cancel(r.id)
            obs_mod.read_index_failed.inc()
            raise errors.EtcdError(errors.ECODE_RAFT_INTERNAL,
                                   cause="quorum read timed out",
                                   index=int(self.applied[g]))
        finally:
            obs_mod.read_index_parked.dec()
        obs_mod.read_index_durations.observe(
            (time.perf_counter() - t0) * 1000.0)
        if isinstance(result, errors.EtcdError):
            raise result
        return result

    def _confirm_reads(self, read_take: Dict[int, int], state, term,
                       commit, last, ring) -> None:
        """Collective-plane ReadIndex confirmation, against the arrays
        just read back. Soundness: the collective round is globally
        synchronous and lossless (the mailbox transpose is one
        all-to-all inside the round), so a column still reading LEADER
        after round k proves no higher-term leader has committed
        anything through round k — its campaign traffic would have
        reached every column (including ours, flipping us to follower)
        at least one full round before its first possible own-term
        commit. The leader must additionally hold its own-term entry
        committed (the reference ReadIndex precondition, raft §8): a
        fresh leader's commit mirror may still lag writes the previous
        leader acked. Deposed columns FAIL their parked reads — the
        client retries through the forward path; nothing is ever served
        at a stale index."""
        W = self.cfg.window
        failed: List[Tuple[int, int]] = []
        confirmed = 0
        with self._lock:
            for g, take in read_take.items():
                dq = self._reads[g]
                take = min(take, len(dq))
                c = int(commit[g])
                own_term = (state[g] == _LEADER and c >= 1
                            and c > int(last[g]) - W
                            and int(ring[g, c % W]) == int(term[g]))
                if own_term:
                    confirmed += 1
                    for _ in range(take):
                        self._ripe[g].append(dq.popleft() + (c,))
                    if take:
                        self._ripe_dirty.add(g)
                        self._ripe_waiting += take
                        self._reads_waiting -= take
                elif state[g] != _LEADER:
                    for _ in range(take):
                        rid, _r = dq.popleft()
                        failed.append((rid, g))
                    self._reads_waiting -= take
                # else: leader, own-term entry not committed yet — the
                # parked reads retry at the next round's readback.
                if not dq:
                    self._read_dirty.discard(g)
        obs_mod.read_index_confirms.observe(confirmed)
        for rid, g in failed:
            self.wait.trigger(rid, errors.EtcdError(
                errors.ECODE_RAFT_INTERNAL,
                cause="leadership lost during quorum read",
                index=int(self.applied[g])))

    def _serve_ripe_reads(self) -> None:
        """Serve every ripe read whose group's apply cursor reached its
        read index (the in-round apply just ran, so this is usually the
        same round that confirmed)."""
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
        # Same read coalescing as MultiEngine._serve_ripe_reads: one
        # get per distinct (group, path, recursive, sorted) serves the
        # whole pass linearizably.
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
        if served:
            obs_mod.read_index_served.inc(len(served))

    def _fail_parked_reads(self, why: str) -> None:
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
        except Exception as e:  # noqa: BLE001
            if self._stop_ev.is_set() and self._comm is not None:
                # Stopping, and another rank left the collective first:
                # the round it broke was never journaled or acked.
                log.info("host-engine %d: collective closed while "
                         "stopping (%s)", self.my_slot, e)
                return
            self.failed = e
            self._stop_ev.set()
            log.exception("host-engine %d loop failed", self.my_slot)
            raise

    def run_round(self) -> None:
        t_round = time.perf_counter()
        torch = self._torch
        G, Pn, W, E = (self.cfg.groups, self.cfg.peers, self.cfg.window,
                       self.cfg.max_ents)
        B = self.cfg.batch_max

        # -- 1. frames in; stage local, forward remote --------------------
        # This round's mailbox frames are taken BEFORE the payload frames
        # are drained: a peer sends a round's payloads ahead of its meta
        # frame on one ordered stream (step 6), so the payloads of every
        # append taken here are drained below, where _cut_unpaid finds
        # them.
        metas = self._take_meta() if self._frames_plane else []
        self._drain_frames()
        if self._pending_snaps:
            self._install_snaps()
        cnt_local = np.zeros(G, np.int32)
        self._staged.clear()
        forwards: List[Tuple[int, int, List[Tuple[int, bytes]]]] = []
        with self._lock:
            for g in list(self._dirty):
                dq = self._pending[g]
                if not dq:
                    self._dirty.discard(g)
                    continue
                if self.l_state[g] == _LEADER:
                    ents: List[List[Tuple[int, bytes]]] = []
                    while dq and len(ents) < E:
                        cur: List[Tuple[int, bytes]] = []
                        nbytes = 0
                        while (dq and len(cur) < B
                               and nbytes < self.cfg.batch_bytes
                               and dq[0][1] and dq[0][1][0] == P_REQ):
                            nbytes += len(dq[0][1])
                            cur.append(dq.popleft())
                        if not cur:
                            dq.popleft()   # drop non-REQ junk defensively
                            continue
                        ents.append(cur)
                    if not dq:
                        self._dirty.discard(g)
                    if ents:
                        for e in ents:
                            for rid, _ in e:
                                self._hops.pop(rid, None)
                        self._staged[g] = ents
                        cnt_local[g] = len(ents)
                elif self.l_lead[g] > 0:
                    lead_host = int(self.l_lead[g]) - 1
                    items = list(dq)
                    dq.clear()
                    self._dirty.discard(g)
                    forwards.append((lead_host, g, items))
                # else: no known leader — leave queued, client may time out
        for lead_host, g, items in forwards:
            # Hop count = 1 past the furthest-travelled item in the batch
            # (items that originated here count 0); _drain_frames drops at
            # the limit, so crossed leadership views can't ping-pong
            # forever.
            hops = 1 + max((self._hops.pop(rid, 0) for rid, _ in items),
                           default=0)
            self.frames.send(lead_host, {"t": "prop", "g": g, "hops": hops},
                             _pack_items(items))

        # -- 1b. read plane: pin which parked quorum reads this round's
        # confirmation covers (reads parking after dispatch could
        # postdate writes acked above the commit index this round
        # captures — they wait for their own round; see
        # MultiEngine.run_round).
        read_take: Optional[Dict[int, int]] = None
        if self._reads_waiting:
            with self._lock:
                if self._reads_waiting:
                    read_take = {g: len(self._reads[g])
                                 for g in self._read_dirty
                                 if self._reads[g]}

        # -- 2. the consensus round: this column's block through the
        # collective comm, or the local full-(G, P) kernel with the
        # mailbox riding frames --------------------------------------------
        my = self.my_slot
        F = self.kcfg.fields
        dev = self.device
        routed_my = None
        if not self._frames_plane:
            cnt = torch.from_numpy(cnt_local[:, None].copy()).to(dev)
            st, self.inbox = self._step(self.kcfg, self.st, self.inbox, cnt,
                                        True, c0=my, comm=self._comm)
        else:
            # The inbox row this host receives, inbox[g, to=my, from]:
            # the only row frames fill (ghost columns never receive).
            inbox_my = np.zeros((G, Pn, F), np.int32)
            if self._self_loop is not None:
                inbox_my[:, my] = self._self_loop
            for j, blob in metas:
                try:
                    idx, vals = _unpack_meta(blob, F)
                except (ValueError, struct.error):
                    log.warning("bad meta frame from host %d dropped", j)
                    continue
                ok = idx < G
                inbox_my[idx[ok], j] = self._cut_unpaid(idx[ok], vals[ok])
            cnt = np.zeros((G, Pn), np.int32)
            cnt[:, my] = cnt_local
            inbox = torch.zeros((G, Pn, Pn, F), dtype=torch.int32,
                                device=dev)
            inbox[:, my] = torch.from_numpy(inbox_my).to(dev)
            st, inbox = self._step(self.kcfg, self.st, inbox,
                                   torch.from_numpy(cnt).to(dev), True)
            # Our column's sends to every peer column: routed inbox[g,
            # to, from] at from == my, read once. The rest of the routed
            # mailbox is ghost traffic and never leaves the device; the
            # buffer is dropped now (next round's inbox is rebuilt from
            # frames).
            routed_my = inbox[:, :, my, :].cpu().numpy()     # (G, P, F)
            self._self_loop = routed_my[:, my, :]
            inbox = None
        self.st = st

        # -- 3. read back OUR column --------------------------------------
        local = self._local
        term = local(st.term)[:, 0]
        vote = local(st.vote)[:, 0]
        commit = local(st.commit)[:, 0]
        state = local(st.state)[:, 0]
        last = local(st.last_index)[:, 0]
        lead = local(st.lead)[:, 0]
        ring = local(st.log_term)[:, 0, :]
        need_host = local(st.need_host)[:, 0]

        if need_host.any():
            from etcd_tpu_torch.ops.state import NH_SNAP, NH_VIOLATION
            viol = (need_host & NH_VIOLATION) != 0
            if viol.any():
                raise RuntimeError(
                    f"host {self.my_slot}: consensus safety violation in "
                    f"groups {np.nonzero(viol)[0][:8].tolist()}")
            # NH_SNAP: a target's needed entries fell below our ring
            # window — a peer host restarted with a stale or empty WAL, or
            # was away longer than the window covers. Ship store images + probe (leader side of MsgSnap).
            snap_g = np.nonzero((need_host & NH_SNAP) != 0)[0]
            if len(snap_g):
                st = self._send_snapshots(snap_g, st)
            # Consume the flags: the kernel only ORs NH_* bits, so without
            # a write-back one event would re-log every round forever and
            # mask later flags. Each host zeroes ITS column (purely
            # local data — mirrors the single-host
            # _service_need_host clearing). Re-fire is guaranteed while the
            # lag persists (the kernel recomputes need_snap every round).
            st = st._replace(need_host=self._set_local(
                "need_host", np.zeros((G, 1), np.int32)))
            self.st = st

        # -- 4. durable record for OUR column -----------------------------
        rec = RoundRecord(round_no=self.round_no)
        chg = ((term != self.l_term) | (vote != self.l_vote)
               | (commit != self.l_commit))
        gi = np.nonzero(chg)[0]
        rec.hs_g = gi.astype(np.uint32)
        rec.hs_p = np.full(len(gi), my, np.uint16)
        rec.hs_term = term[gi].astype(np.uint32)
        rec.hs_vote = vote[gi].astype(np.uint16)
        rec.hs_commit = commit[gi].astype(np.uint32)

        gi = np.nonzero(last != self.l_last)[0]
        rec.last_g = gi.astype(np.uint32)
        rec.last_p = np.full(len(gi), my, np.uint16)
        rec.last_v = last[gi].astype(np.uint32)

        gi, wi = np.nonzero(ring != self.l_ring)
        lastv = last[gi]
        absi = lastv - ((lastv - wi) % W)
        keep = absi >= 1
        rec.ring_g = gi[keep].astype(np.uint32)
        rec.ring_p = np.full(int(keep.sum()), my, np.uint16)
        rec.ring_i = absi[keep].astype(np.uint32)
        rec.ring_t = ring[gi[keep], wi[keep]].astype(np.uint32)

        # Admission for locally staged proposals.
        fresh_frames: List[Tuple[int, int, int, bytes]] = []
        requeue: List[Tuple[int, List[Tuple[int, bytes]]]] = []
        for g, ents in self._staged.items():
            admitted = 0
            if state[g] == _LEADER and term[g] == self.l_term[g]:
                admitted = int(last[g] - self.l_last[g])
            t = int(term[g])
            for j, items in enumerate(ents):
                if j < admitted:
                    i = int(self.l_last[g]) + 1 + j
                    payload = _pack_entry(items)
                    self.payloads[(g, i, t)] = payload
                    rec.entries.append((g, i, t, payload))
                    fresh_frames.append((g, i, t, payload))
                else:
                    requeue.append((g, [it for e in ents[j:] for it in e]))
                    break
        with self._lock:
            for g, rest in requeue:
                self._pending[g].extendleft(reversed(rest))
                self._dirty.add(g)
        # Payloads learned from peers this round are journaled too: an ack
        # we later issue from their application must survive OUR restart.
        rec.entries.extend(self._fresh_payloads)
        # Snapshot installs received this round: the store image + cursor
        # ride the same record (and fsync) as the column surgery's diffs.
        if self._snap_recs:
            rec.snaps = self._snap_recs
            self._snap_recs = []

        self.l_term, self.l_vote, self.l_commit = term, vote, commit
        self.l_state, self.l_last, self.l_ring = state, last, ring
        self.l_lead = lead

        # -- 4b. read plane: confirm the snapshotted reads against this
        # round's readback (ripens them at the captured commit index;
        # deposed columns fail theirs).
        if read_take:
            self._confirm_reads(read_take, state, term, commit, last,
                                ring)

        # -- 5. persist BEFORE the next dispatch (cross-host contract) ----
        if not rec.is_empty():
            self.wal.append(rec)
            self._recent_recs.append(rec)

        # -- 6. fan out fresh local admissions, AFTER the fsync above and
        # BEFORE this round's mailbox column (6b), which carries their
        # append. A peer's frames arrive in the order they were sent, so
        # a peer takes the append with its payloads in hand, and
        # _cut_unpaid has nothing to cut. In the other order (the
        # reference's, etcd_tpu/server/hostengine.py:1275-1303) every
        # append would be cut until a pull brought its payloads.
        if fresh_frames:
            blob = _pack_payloads(fresh_frames)
            if self._fault_rng is None:
                self.frames.broadcast({"t": "pay"}, blob)
            else:
                # Seeded per-peer drops: the receiver's apply cursor
                # stalls on the missing payload and repairs via PULL.
                for h in self.frames.peers:
                    if self._fault_rng.random() * 100 >= \
                            self.cfg.drop_pay_pct:
                        self.frames.send(h, {"t": "pay"}, blob)
                    else:
                        self.pay_frames_dropped += 1
        self._fresh_payloads = []

        # -- 6b. frames plane: ship this round's mailbox column AFTER the
        # fsync above — the persist-before-send contract (doc.go:31-39)
        # holds per-host exactly like the reference's Ready ordering —
        # and after the payloads its appends carry (6).
        # Sparse per-peer encoding: only groups with a live message.
        if routed_my is not None:
            for h in range(Pn):
                if h == my:
                    continue
                msgs = routed_my[:, h, :]
                idx = np.nonzero(msgs.any(axis=1))[0]
                if len(idx):
                    self.frames.send(h, {"t": "meta"},
                                     _pack_meta(idx, msgs[idx]))

        # -- 7. apply + ack locally ---------------------------------------
        self._apply_committed(trigger=True)
        if self._ripe_waiting:
            self._serve_ripe_reads()
        self._request_pulls()

        self.round_no += 1
        ms = (time.perf_counter() - t_round) * 1000.0
        self.round_ms_ewma = (ms if self.round_ms_ewma == 0.0 else
                              self.round_ms_ewma
                              + 0.05 * (ms - self.round_ms_ewma))
        if self.round_no % self.cfg.checkpoint_rounds == 0:
            self._checkpoint()
            self._gc_payloads()

    # ------------------------------------------------------------------
    # apply
    # ------------------------------------------------------------------

    def _apply_committed(self, trigger: bool, hist=None) -> None:
        W = self.cfg.window
        changed = np.nonzero(self.l_commit > self.applied)[0]
        now = time.time()
        for g in changed:
            g = int(g)
            lo, hi = int(self.applied[g]), int(self.l_commit[g])
            done = lo
            for i in range(lo + 1, hi + 1):
                t = 0
                if i > self.l_last[g] - W:
                    t = int(self.l_ring[g, i % W])
                if t == 0:
                    t = self._hist.get((g, i), 0)
                if t == 0 and hist is not None:
                    t = hist.get((g, i), 0)
                if t == 0:
                    log.error("host %d: no term for committed entry "
                              "g=%d i=%d", self.my_slot, g, i)
                    break
                key = (g, i, t)
                payload = self.payloads.get(key)
                if payload is None:
                    # Leader no-ops never ship payloads; real entries that
                    # haven't arrived yet stall the cursor until a pull
                    # repairs them. Heuristic: a no-op is index == the
                    # first entry of its term from OUR ring; safer to stall
                    # briefly and pull — peers answer no-op pulls with
                    # nothing, and _maybe_noop resolves them.
                    if self._maybe_noop(g, i, t):
                        done = i
                        continue
                    self._missing.setdefault(key, now)
                    # The stall can outlive the ring window (live traffic
                    # keeps moving last_index): remember every term of the
                    # committed span that is STILL resolvable now — plus
                    # i-1's, which _maybe_noop(i) will need — so the retry
                    # after the pull repairs the payload can never lose
                    # them (the jam the stale-disk test found). In the
                    # live path only the ring can resolve, so clamp the
                    # rescan to the window instead of walking a possibly
                    # huge backlog every stalled round.
                    if hist is not None:
                        start = max(i - 1, 1)
                    else:
                        start = max(i - 1, int(self.l_last[g]) - W + 1, 1)
                    for j in range(start, hi + 1):
                        if (g, j) not in self._hist:
                            tj = 0
                            if j > self.l_last[g] - W:
                                tj = int(self.l_ring[g, j % W])
                            if tj == 0 and hist is not None:
                                tj = hist.get((g, j), 0)
                            if tj:
                                self._hist[(g, j)] = tj
                    break
                if payload[0] == P_REQ:
                    r = Request.decode(payload[1:])
                    try:
                        result = self._apply_request(g, r)
                    except errors.EtcdError as err:
                        result = err
                    if trigger:
                        if r.method != METHOD_SYNC:
                            self.acked_requests += 1
                        self.wait.trigger(r.id, result)
                elif payload[0] == P_MULTI:
                    # Batched fast path (see MultiEngine._apply_committed):
                    # in multi-host mode MOST requests have no local waiter
                    # — the proposing host acks its client; the other N-1
                    # hosts apply the same entries purely for state — so
                    # runs of unconditional PUTs collapse into one
                    # GIL-atomic C call per run.
                    st = self.store(g)
                    many = getattr(st, "set_applied_many", None)
                    fp: List[str] = []
                    fv: List[str] = []
                    fneed: List[int] = []
                    frids: List[int] = []
                    is_reg = self.wait.is_registered
                    for blob in _unpack_multi(payload):
                        r = Request.decode(blob)
                        if (many is not None and r.method == METHOD_PUT
                                and not r.dir and not r.refresh
                                and r.prev_exist is None
                                and not r.prev_index and not r.prev_value
                                and r.expiration is None):
                            if is_reg(r.id):
                                # Locally-proposed waiter-held PUTs ride
                                # the batch: the waiter is woken with the
                                # raw descriptors (LazyWriteEvent; see
                                # MultiEngine._flush_many).
                                fneed.append(len(fp))
                                frids.append(r.id)
                            fp.append(r.path)
                            fv.append(r.val or "")
                            continue
                        if fp:
                            self._flush_many(st, fp, fv, fneed, frids,
                                             trigger)
                            fp, fv, fneed, frids = [], [], [], []
                        try:
                            result = self._apply_request(g, r)
                        except errors.EtcdError as err:
                            result = err
                        if trigger:
                            if r.method != METHOD_SYNC:
                                self.acked_requests += 1
                            self.wait.trigger(r.id, result)
                    if fp:
                        self._flush_many(st, fp, fv, fneed, frids,
                                         trigger)
                done = i
            self.applied[g] = done
            if self._hist:
                # Keep `done` itself: _maybe_noop(done + 1) reads its term.
                for j in range(lo + 1, done):
                    self._hist.pop((g, j), None)

    def _maybe_noop(self, g: int, i: int, t: int) -> bool:
        """True if entry (g, i, term t) is a leader no-op: it is the FIRST
        entry of term t in our log (leaders append exactly one payload-less
        entry, at the start of their term — kernel _append_noop_and_lead).
        The previous entry's term resolves from the ring, falling back to
        the retained-history map when it dropped below the window — a
        term-boundary no-op below the window otherwise reads as a missing
        payload and jams the apply cursor with unanswerable pulls (found
        by the stale-disk snapshot test)."""
        W = self.cfg.window
        if i == 1:
            return True
        prev_t = 0
        if i - 1 > self.l_last[g] - W:
            prev_t = int(self.l_ring[g, (i - 1) % W])
        if prev_t == 0:
            prev_t = self._hist.get((g, i - 1), 0)
        return prev_t != 0 and prev_t < t

    def _flush_many(self, st, fp: List[str], fv: List[str],
                    fneed: List[int], frids: List[int],
                    trigger: bool) -> None:
        """One batched run of plain-file PUTs; need-listed waiters are
        woken with raw descriptors (see MultiEngine._flush_many)."""
        if not fneed:
            st.set_applied_many(fp, fv)
            if trigger:
                self.acked_requests += len(fp)
            return
        now = st.clock()
        _, descs = st.set_applied_many(fp, fv, need=fneed)
        if trigger:
            self.acked_requests += len(fp)
            for (pos, nd, pd, idx), rid in zip(descs, frids):
                if nd is None:
                    code, cause = pd
                    res: Any = errors.EtcdError(code, cause=cause,
                                                index=idx)
                else:
                    res = LazyWriteEvent(nd, pd, idx, now)
                self.wait.trigger(rid, res)

    def _apply_request(self, g: int, r: Request):
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
                # see engine._apply_request: lazy-event fast path
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
            return None
        raise errors.EtcdError(errors.ECODE_INVALID_FORM,
                               cause=f"bad method {r.method}")

    def _request_pulls(self) -> None:
        if not self._missing:
            return
        now = time.time()
        if now - self._last_pull < self.cfg.pull_interval:
            return
        self._last_pull = now
        # A want at or below its group's applied index is moot: an entry
        # an append was cut at, which a later leader overwrote.
        for k in [k for k in self._missing if k[1] <= self.applied[k[0]]]:
            del self._missing[k]
        wants = [list(k) for k, t0 in self._missing.items()
                 if now - t0 >= self.cfg.pull_interval / 2]
        if wants:
            self.pulls_sent += 1
            self.frames.broadcast({"t": "pull", "wants": wants[:512]})

    # ------------------------------------------------------------------
    # checkpoint
    # ------------------------------------------------------------------

    def _checkpoint(self) -> None:
        import base64 as _b64
        state = {
            "round": self.round_no - 1,
            "term": np_b64(self.l_term), "vote": np_b64(self.l_vote),
            "commit": np_b64(self.l_commit), "last": np_b64(self.l_last),
            "ring": np_b64(self.l_ring),
            "applied": np_b64(self.applied),
            "stores": {str(g): s.save().decode()
                       for g, s in self._stores.items()},
            "payloads": [
                (g, i, t, _b64.b64encode(p).decode())
                for (g, i, t), p in self.payloads.items()
                if i > self.applied[g]],
            # Terms of committed-but-unapplied entries below the ring
            # window (see _hist): recs before this checkpoint get purged,
            # taking their ring diffs with them, so a stalled span's terms
            # must ride the checkpoint itself. >= applied, not >: the
            # no-op check for entry applied+1 reads applied's term, and
            # after the purge the checkpoint is its only source.
            "hist": [(g, i, t) for (g, i), t in self._hist.items()
                     if i >= self.applied[g]],
        }
        self.wal.save_checkpoint(self.round_no - 1, state)

    def _gc_payloads(self) -> None:
        """Drop applied payloads — EXCEPT the trailing ring window: a
        peer host that crashed before receiving a payload repairs it via
        PULL after restart, and OUR applied cursor says nothing about how
        far behind that peer's cursor is. Any index still resolvable from
        the device ring (i > last - W) must stay answerable; a peer
        lagging beyond the ring is the documented cross-host snapshot
        case, not a pull. (Dropping by local `applied` alone left a
        restarted peer's group stuck forever: it pulled an index nobody
        retained — found by the supervisor recovery test.)"""
        W = self.cfg.window
        dead = [k for k in self.payloads
                if k[1] <= self.applied[k[0]]
                and k[1] <= self.l_last[k[0]] - W]
        for k in dead:
            del self.payloads[k]
        # Snapshot-send holdoffs are only meaningful for ~snap_interval;
        # prune stale ones so a mass catch-up doesn't leave G*P tombstones.
        cutoff = time.time() - 60.0
        for k in [k for k, t0 in self._snap_sent.items() if t0 < cutoff]:
            del self._snap_sent[k]
        # Stale retained-term entries: the per-pass prune keeps each
        # pass's boundary entries, which fall below `applied` once later
        # passes move on — sweep them here (checkpoint cadence).
        for k in [k for k in self._hist
                  if k[1] < self.applied[k[0]]]:
            del self._hist[k]


# ---------------------------------------------------------------------------
# frame payload packing
# ---------------------------------------------------------------------------

def _pack_meta(idx: np.ndarray, vals: np.ndarray) -> bytes:
    """Sparse mailbox column frame: u32 count, then group indices (u32)
    and per-group message fields (i32 x F). Only groups carrying a live
    message are shipped — the quiescent steady state is a handful of
    heartbeat rows, not G."""
    return (struct.pack("<I", len(idx))
            + np.ascontiguousarray(idx.astype("<u4")).tobytes()
            + np.ascontiguousarray(vals.astype("<i4")).tobytes())


def _unpack_meta(blob: bytes, fields: int) -> Tuple[np.ndarray, np.ndarray]:
    (n,) = struct.unpack_from("<I", blob, 0)
    need = 4 + 4 * n + 4 * n * fields
    if len(blob) != need:
        raise ValueError(f"meta frame length {len(blob)} != {need}")
    idx = np.frombuffer(blob, "<u4", n, 4).astype(np.int64)
    vals = np.frombuffer(blob, "<i4", n * fields,
                         4 + 4 * n).reshape(n, fields)
    return idx, vals


def _pack_items(items: List[Tuple[int, bytes]]) -> bytes:
    out = [struct.pack("<I", len(items))]
    for rid, payload in items:
        out.append(struct.pack("<QI", rid, len(payload)))
        out.append(payload)
    return b"".join(out)


def _unpack_items(blob: bytes) -> List[Tuple[int, bytes]]:
    (n,) = struct.unpack_from("<I", blob, 0)
    off = 4
    out = []
    for _ in range(n):
        rid, ln = struct.unpack_from("<QI", blob, off)
        off += 12
        out.append((rid, blob[off:off + ln]))
        off += ln
    return out


def _pack_payloads(entries: List[Tuple[int, int, int, bytes]]) -> bytes:
    out = [struct.pack("<I", len(entries))]
    for g, i, t, payload in entries:
        out.append(struct.pack("<IIII", g, i, t, len(payload)))
        out.append(payload)
    return b"".join(out)


def _unpack_payloads(blob: bytes) -> List[Tuple[int, int, int, bytes]]:
    (n,) = struct.unpack_from("<I", blob, 0)
    off = 4
    out = []
    for _ in range(n):
        g, i, t, ln = struct.unpack_from("<IIII", blob, off)
        off += 16
        out.append((g, i, t, blob[off:off + ln]))
        off += ln
    return out


def _pack_snaps(snaps: List[Tuple[int, int, int, int, np.ndarray,
                                  bytes]]) -> bytes:
    """(g, install_index, term, lead_slot, ring_row[W], store_image)."""
    out = [struct.pack("<I", len(snaps))]
    for g, a, t, lead, row, image in snaps:
        out.append(struct.pack("<IIIH", g, a, t, lead))
        out.append(np.ascontiguousarray(row.astype("<i4")).tobytes())
        out.append(struct.pack("<I", len(image)))
        out.append(image)
    return b"".join(out)


def _unpack_snaps(blob: bytes, window: int
                  ) -> List[Tuple[int, int, int, int, np.ndarray, bytes]]:
    (n,) = struct.unpack_from("<I", blob, 0)
    off = 4
    out = []
    for _ in range(n):
        g, a, t, lead = struct.unpack_from("<IIIH", blob, off)
        off += 14
        row = np.frombuffer(blob, "<i4", count=window,
                            offset=off).astype(np.int32)
        off += 4 * window
        (ln,) = struct.unpack_from("<I", blob, off)
        off += 4
        if off + ln > len(blob):
            # A silently truncated store image must fail HERE, inside the
            # drain-time per-frame try, not later in the install path.
            raise ValueError(f"snap frame truncated: image needs {ln} "
                             f"bytes, {len(blob) - off} remain")
        out.append((g, a, t, lead, row, blob[off:off + ln]))
        off += ln
    return out
