"""EtcdServer: the server core wiring consensus to the state machine.

Behavioral equivalent of reference etcdserver/server.go + etcdserver/raft.go:
bootstrap decision tree (new vs restart), the propose→wait→apply pipeline
(Do server.go:519-576, apply server.go:729-820), membership ConfChanges with
validation (server.go:640-662,824-873), snapshot trigger every snap_count
applies (server.go:476-480,876-916), TTL expiry via replicated SYNC
(server.go:667-681), and self-attribute publish (server.go:688-715).

Re-designed for the TPU framework: ONE run-loop thread owns the Node and all
store mutations (the single-writer invariant the reference gets from
node.run/multiNode.run goroutines), fed by a queue that client threads
(HTTP handlers) and the transport post into. The Ready drain follows the
prescribed ordering contract (reference raft/doc.go:28-55): WAL fsync of
{HardState, Entries} BEFORE transport send, apply committed, then advance.
"""
from __future__ import annotations

import json
import logging
import os
import queue
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from etcd_tpu_torch import errors, raftpb
from etcd_tpu_torch.raftpb import (ConfChange, ConfChangeType, ConfState, Entry,
                             EntryType, Message, Snapshot,
                             SnapshotMetadata)
from etcd_tpu_torch.raft.core import Config, ProposalDroppedError
from etcd_tpu_torch.raft.node import Node, Peer
from etcd_tpu_torch.raft.storage import CompactedError, MemoryStorage
from etcd_tpu_torch.server import cluster as cl
from etcd_tpu_torch.server.cluster import Cluster, Member, STORE_KEYS_PREFIX
from etcd_tpu_torch.server.request import (METHOD_DELETE, METHOD_GET, METHOD_POST,
                                     METHOD_PUT, METHOD_QGET, METHOD_SYNC,
                                     METHOD_V3,
                                     Request)
from etcd_tpu_torch.server.stats import LeaderStats, ServerStats
from etcd_tpu_torch.server.storage import ServerStorage, read_wal
from etcd_tpu_torch.store.event import LazyWriteEvent
from etcd_tpu_torch.server.transport import Transporter
from etcd_tpu_torch.snap import Snapshotter
from etcd_tpu_torch.store import new_store
from etcd_tpu_torch.utils import idutil, metrics
from etcd_tpu_torch.utils.fileutil import touch_dir_all, purge_files
from etcd_tpu_torch.utils.wait import Wait
from etcd_tpu_torch.wal import WAL, WalSnapshot, wal_exists
from etcd_tpu_torch.wal import wal as wal_mod

log = logging.getLogger("etcd_tpu.server")

DEFAULT_SNAP_COUNT = 10000       # reference server.go:56
CATCH_UP_ENTRIES = 5000          # reference etcdserver/raft.go:38
MAX_WAL_FILES = 5                # reference -max-wals default
MAX_SNAP_FILES = 5

_MEMBER_ATTR_SUFFIX = "/attributes"

# Snapshot payload envelope carrying BOTH state machines. Legacy snapshots
# (and the reference's) are bare v2-store JSON — the magic disambiguates:
# JSON can never start with these bytes. v3's consistent index travels
# inside the sqlite image itself.
_SNAP_MAGIC = b"\x00etcdtpu-snap-v3\x00"
_SNAP_HDR = struct.Struct("<QQ")


def _encode_snap_data(v2: bytes, v3: bytes) -> bytes:
    return _SNAP_MAGIC + _SNAP_HDR.pack(len(v2), len(v3)) + v2 + v3


def _decode_snap_data(data: bytes):
    """-> (v2_json, v3_image_or_None)."""
    if not data.startswith(_SNAP_MAGIC):
        return data, None
    l2, l3 = _SNAP_HDR.unpack_from(data, len(_SNAP_MAGIC))
    off = len(_SNAP_MAGIC) + _SNAP_HDR.size
    return data[off:off + l2], data[off + l2:off + l2 + l3]


@dataclass
class ServerConfig:
    name: str
    data_dir: str
    initial_cluster: Dict[str, Sequence[str]] = field(default_factory=dict)
    cluster_token: str = "etcd-cluster"
    client_urls: Tuple[str, ...] = ()
    snap_count: int = DEFAULT_SNAP_COUNT
    tick_ms: int = 100               # heartbeat interval (reference TickMs)
    election_ticks: int = 10
    heartbeat_ticks: int = 1
    sync_ticks: int = 5              # SYNC every 500ms (reference server.go:300)
    wal_segment_size: int = wal_mod.SEGMENT_SIZE_BYTES
    request_timeout: float = 5.0
    catch_up_entries: int = CATCH_UP_ENTRIES
    # False = join an existing cluster: fetch membership + IDs from the
    # peers in initial_cluster instead of founding (reference
    # server.go:194-217 `!haveWAL && !cfg.NewCluster`).
    new_cluster: bool = True
    # Continuous cluster-version negotiation cadence (reference
    # monitorVersionInterval, server.go:933). Winning leadership forces an
    # immediate round, so the initial negotiation never waits on this.
    version_monitor_interval: float = 5.0
    # Disaster recovery: restart as a one-member cluster, rewriting
    # membership in the log (reference -force-new-cluster,
    # etcdserver/raft.go:266-315).
    force_new_cluster: bool = False

    @property
    def waldir(self) -> str:
        return os.path.join(self.data_dir, "member", "wal")

    @property
    def snapdir(self) -> str:
        return os.path.join(self.data_dir, "member", "snap")


class EtcdServer:
    """One consensus member. Drive with start()/stop(); serve client ops via
    do()/add_member()/remove_member(); feed peer traffic into process()."""

    def __init__(self, cfg: ServerConfig, transport: Transporter,
                 clock=time.time) -> None:
        self.cfg = cfg
        self.clock = clock
        self.transport = transport
        if hasattr(transport, "bind"):
            transport.bind(self)
        # Namespace dirs exist from boot and are write-protected (reference
        # server.go:173 store.New(StoreClusterPrefix, StoreKeysPrefix)).
        self.store = new_store(clock=clock,
                           namespaces=(cl.STORE_CLUSTER_PREFIX,
                                       STORE_KEYS_PREFIX))
        touch_dir_all(cfg.snapdir)
        self.snapshotter = Snapshotter(cfg.snapdir)
        self.raft_storage = MemoryStorage()
        # v3 MVCC preview keyspace (server/v3.py): replicated through the
        # same log; per-member sqlite backend under member/v3.
        from etcd_tpu_torch.server.v3 import V3Applier
        touch_dir_all(os.path.join(cfg.data_dir, "member", "v3"))
        self.v3 = V3Applier(
            os.path.join(cfg.data_dir, "member", "v3", "kv.db"))
        # Set when a LEGACY snapshot (no v3 image) installed past the v3
        # consistent index: the v3 keyspace has a gap and must not serve.
        self.v3_gapped = False
        self._applied = 0
        self._snapi = 0
        self.wait = Wait()
        self._inq: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._published = False
        self._removed_self = False
        # Set when an environmental apply failure killed the run loop: the
        # member must refuse all service (reads could see forked in-memory
        # state) until restarted — the process-level analogue of the
        # reference's panic-on-backend-error.
        self._fatal = False
        # Leader-local lease bookkeeping: lease_id -> (seq, clock time the
        # LEADER observed that seq). Replicated lease state carries no
        # clocks; only this member's clock decides expiry, re-seeded on
        # every leadership change (leases extend across elections, never
        # silently shorten). _lease_revoke_inflight dedups re-proposals.
        self._was_leader = False
        self._lease_seen: Dict[int, Tuple[int, float]] = {}
        self._lease_revoke_inflight: Dict[int, float] = {}
        self._sync_elapsed = 0
        self.lead_elected_ev = threading.Event()
        self._force_version_ev = threading.Event()  # reference forceVersionC
        self._version_thread: Optional[threading.Thread] = None

        # v0.4 data dirs auto-upgrade on boot (reference upgradeDataDir
        # chain, etcdserver/storage.go:111-132 + server.go:181-187).
        if not wal_exists(cfg.waldir):
            from etcd_tpu_torch.migrate import etcd4 as migrate4
            if migrate4.is_v04_data_dir(cfg.data_dir):
                migrate4.migrate_4_to_2(cfg.data_dir, cfg.name)

        if wal_exists(cfg.waldir):
            if cfg.force_new_cluster:
                self._restart_standalone()
            else:
                self._restart()
        elif cfg.new_cluster:
            self._bootstrap_new()
        else:
            self._bootstrap_join()
        self.reqid = idutil.Generator(self.id & 0xFFFF)
        self.stats = ServerStats(cfg.name, self.id, clock=clock)
        self.lstats = LeaderStats(self.id)

        # Wire known peers into the transport.
        for m in self.cluster.members():
            if m.id != self.id:
                self.transport.add_peer(m.id, m.peer_urls)

    # -- bootstrap ----------------------------------------------------------

    def _bootstrap_new(self) -> None:
        cfg = self.cfg
        self.cluster = Cluster.from_initial(self.store, cfg.initial_cluster,
                                            cfg.cluster_token)
        me = self.cluster.member_by_name(cfg.name)
        if me is None:
            raise ValueError(
                f"member {cfg.name!r} not in initial cluster "
                f"{sorted(cfg.initial_cluster)}")
        if cfg.client_urls:
            me = Member(me.id, me.name, me.peer_urls, tuple(cfg.client_urls))
        self.id = me.id
        metadata = json.dumps({"id": f"{self.id:x}",
                               "clusterId": f"{self.cluster.cluster_id:x}"}
                              ).encode()
        self.wal = WAL.create(cfg.waldir, metadata,
                              segment_size=cfg.wal_segment_size)
        self.storage = ServerStorage(self.wal, self.snapshotter)
        peers = [Peer(id=m.id, context=json.dumps(m.to_dict()).encode())
                 for m in self.cluster.members()]
        self.node = Node.start(
            Config(id=self.id, election_tick=cfg.election_ticks,
                   heartbeat_tick=cfg.heartbeat_ticks,
                   storage=self.raft_storage), peers)

    def _bootstrap_join(self) -> None:
        """Join a running cluster (reference server.go:194-217): the admin
        already proposed this member via the members API; fetch the live
        membership from the other peers, take over their IDs (matched by
        peer URLs), and start with an empty log — history replays from the
        leader (appends or a snapshot)."""
        cfg = self.cfg
        local = Cluster.from_initial(self.store, cfg.initial_cluster,
                                     cfg.cluster_token)
        me = local.member_by_name(cfg.name)
        if me is None:
            raise ValueError(
                f"member {cfg.name!r} not in initial cluster "
                f"{sorted(cfg.initial_cluster)}")
        remote_urls = [u for name, urls in cfg.initial_cluster.items()
                       if name != cfg.name for u in urls]
        cid, existing = cl.get_cluster_from_remote_peers(
            remote_urls,
            tls_context=getattr(self.transport, "tls_context", None))
        cl.validate_cluster_and_assign_ids(local, existing)
        local.cluster_id = cid
        self.cluster = local
        me = self.cluster.member_by_name(cfg.name)
        if cfg.client_urls:
            self.cluster._members[me.id] = Member(
                me.id, me.name, me.peer_urls, tuple(cfg.client_urls))
        self.id = me.id
        metadata = json.dumps({"id": f"{self.id:x}",
                               "clusterId": f"{cid:x}"}).encode()
        self.wal = WAL.create(cfg.waldir, metadata,
                              segment_size=cfg.wal_segment_size)
        self.storage = ServerStorage(self.wal, self.snapshotter)
        # No bootstrap peers: membership arrives from the log
        # (reference startNode(cfg, cl, nil)).
        self.node = Node.start(
            Config(id=self.id, election_tick=cfg.election_ticks,
                   heartbeat_tick=cfg.heartbeat_ticks,
                   storage=self.raft_storage), peers=[])

    def _recover_from_disk(self):
        """Shared restart preamble: snapshot → store/raft-storage recovery,
        cluster from store, WAL replay, identity from WAL metadata. Returns
        (snap, hard_state, entries)."""
        cfg = self.cfg
        snap = self.snapshotter.load_or_none()
        walsnap = WalSnapshot()
        if snap is not None:
            walsnap = WalSnapshot(index=snap.metadata.index,
                                  term=snap.metadata.term)
            v2, v3img = _decode_snap_data(snap.data)
            self.store.recovery(v2)
            # The local v3 backend is usually AT or PAST the snapshot (it
            # persists independently); only install the snapshot's image
            # when the backend is behind it (lost/stale db file) — WAL
            # replay then idempotently reapplies from the image forward.
            if self.v3.consistent_index < snap.metadata.index:
                self._install_v3_from_snap(v3img, snap.metadata.index)
            self.raft_storage.apply_snapshot(snap)
            self._applied = snap.metadata.index
            self._snapi = snap.metadata.index
        self.cluster = Cluster(self.store, cfg.cluster_token)
        self.cluster.recover()
        self.wal, metadata, hs, ents = read_wal(
            cfg.waldir, walsnap, segment_size=cfg.wal_segment_size)
        md = json.loads(metadata.decode())
        self.id = int(md["id"], 16)
        self.cluster.cluster_id = int(md["clusterId"], 16)
        return snap, hs, ents

    def _restart_standalone(self) -> None:
        """-force-new-cluster (reference restartAsStandaloneNode
        etcdserver/raft.go:266-315): drop uncommitted WAL entries, then
        append synthesized ConfChanges that remove every other member (and
        add self if absent) so the survivor forms a quorum of one."""
        cfg = self.cfg
        snap, hs, ents = self._recover_from_disk()

        # Discard uncommitted tail (raft.go:273-279).
        for i, e in enumerate(ents):
            if e.index > hs.commit:
                ents = ents[:i]
                break

        ids = self._member_ids_from_log(snap, ents)
        to_app = self._create_config_change_ents(
            ids, self.id, hs.term, hs.commit)
        ents = list(ents) + to_app
        self.wal.save(raftpb.HardState(), to_app)
        if ents:
            hs = raftpb.replace(hs, commit=ents[-1].index)

        self.storage = ServerStorage(self.wal, self.snapshotter)
        self.raft_storage.set_hard_state(hs)
        self.raft_storage.append(ents)
        self.node = Node.restart(
            Config(id=self.id, election_tick=cfg.election_ticks,
                   heartbeat_tick=cfg.heartbeat_ticks,
                   storage=self.raft_storage))

    @staticmethod
    def _member_ids_from_log(snap: Optional[Snapshot],
                             ents: Sequence[Entry]) -> List[int]:
        """Membership as of the last committed entry (reference getIDs
        etcdserver/raft.go:322-350)."""
        ids = set()
        if snap is not None:
            ids.update(snap.metadata.conf_state.nodes)
        for e in ents:
            if e.type != EntryType.CONF_CHANGE:
                continue
            cc = raftpb.decode_conf_change(e.data)
            if cc.type == ConfChangeType.ADD_NODE:
                ids.add(cc.node_id)
            elif cc.type == ConfChangeType.REMOVE_NODE:
                ids.discard(cc.node_id)
        return sorted(ids)

    def _create_config_change_ents(self, ids: List[int], self_id: int,
                                   term: int, index: int) -> List[Entry]:
        """Synthesized remove-everyone-else (+add-self) entries (reference
        createConfigChangeEnts etcdserver/raft.go:352-402)."""
        ents: List[Entry] = []
        nxt = index + 1
        found = False
        for mid in ids:
            if mid == self_id:
                found = True
                continue
            cc = ConfChange(type=ConfChangeType.REMOVE_NODE, node_id=mid)
            ents.append(Entry(type=EntryType.CONF_CHANGE, term=term,
                              index=nxt,
                              data=raftpb.encode_conf_change(cc)))
            nxt += 1
        if not found:
            me = self.cluster.member(self_id) or Member(
                self_id, self.cfg.name, ("http://localhost:2380",), ())
            cc = ConfChange(type=ConfChangeType.ADD_NODE, node_id=self_id,
                            context=json.dumps(me.to_dict()).encode())
            ents.append(Entry(type=EntryType.CONF_CHANGE, term=term,
                              index=nxt,
                              data=raftpb.encode_conf_change(cc)))
        return ents

    def _restart(self) -> None:
        cfg = self.cfg
        _, hs, ents = self._recover_from_disk()
        self.storage = ServerStorage(self.wal, self.snapshotter)
        self.raft_storage.set_hard_state(hs)
        self.raft_storage.append(ents)
        self.node = Node.restart(
            Config(id=self.id, election_tick=cfg.election_ticks,
                   heartbeat_tick=cfg.heartbeat_ticks,
                   storage=self.raft_storage))

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"etcd-{self.cfg.name}")
        self._thread.start()
        self._version_thread = threading.Thread(
            target=self._monitor_versions, daemon=True,
            name=f"etcd-{self.cfg.name}-vermon")
        self._version_thread.start()

    def stop(self) -> None:
        self._stop_ev.set()
        self._inq.put(("noop", None))
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.transport.stop()
        self.storage.close()
        self.v3.close()

    @property
    def stopped(self) -> bool:
        return self._stop_ev.is_set()

    # -- client API ---------------------------------------------------------

    def do(self, r: Request) -> Any:
        """Serve one request (reference Do server.go:519-576): local reads
        from the store; writes (and quorum reads) through consensus."""
        if self._fatal:
            raise errors.EtcdError(
                errors.ECODE_RAFT_INTERNAL,
                cause="member failed (fatal apply error); restart required")
        if r.method == METHOD_GET:
            if r.quorum:
                r = raftpb.replace(r, method=METHOD_QGET)
            elif r.wait:
                return self.store.watch(r.path, r.recursive, r.stream, r.since)
            else:
                return self.store.get(r.path, r.recursive, r.sorted)
        # (Serializable v3 ranges never reach do(): the gateway reads the
        # local kvstore directly; linearizable ones ride the log below and
        # V3Applier.apply serves them without a consistent-index write.)
        if r.method in (METHOD_PUT, METHOD_POST, METHOD_DELETE, METHOD_QGET,
                        METHOD_SYNC, METHOD_V3):
            if r.id == 0:
                r = raftpb.replace(r, id=self.reqid.next())
            q = self.wait.register(r.id)
            self._inq.put(("prop", (r.id, r.encode())))
            # Proposal metrics (reference server.go:523-527,573-575 +
            # etcdserver/metrics.go).
            metrics.propose_pending.inc()
            t0 = time.perf_counter()
            try:
                result = q.get(timeout=self.cfg.request_timeout)
            except queue.Empty:
                self.wait.cancel(r.id)
                metrics.propose_failed.inc()
                raise errors.EtcdError(errors.ECODE_RAFT_INTERNAL,
                                       cause="request timed out",
                                       index=self.store.current_index)
            finally:
                metrics.propose_pending.dec()
            # Only committed proposals feed the latency summary (the
            # reference observes after the successful wait; timeouts would
            # pin the quantiles at the deadline).
            metrics.propose_durations.observe(
                (time.perf_counter() - t0) * 1e3)
            if isinstance(result, errors.EtcdError):
                raise result
            if type(result) is LazyWriteEvent:
                # The apply loop woke us with raw C descriptors; build
                # the Event here, off the run-loop thread.
                return result.resolve()
            return result
        raise errors.EtcdError(errors.ECODE_INVALID_FORM,
                               cause=f"bad method {r.method}")

    def process(self, m: Message) -> None:
        """Inbound raft message from the transport (reference
        server.go:387-404): drop traffic from removed members."""
        if self._stop_ev.is_set() or self.cluster.is_id_removed(m.frm):
            return
        self._inq.put(("msg", m))

    def report_unreachable(self, pid: int) -> None:
        """Transport feedback: peer send failed → leader drops the peer to
        probe mode (reference server.go:399, raft.go:575-581). Thread-safe."""
        self._inq.put(("unreachable", pid))

    def report_snapshot(self, pid: int, ok: bool) -> None:
        """Transport feedback on a snapshot send (reference server.go:403)."""
        self._inq.put(("snap_status", (pid, ok)))

    # -- membership API (reference configure() server.go:640-662) -----------

    def add_member(self, m: Member) -> List[Member]:
        self.cluster.validate_conf_change("add", m.id, m.peer_urls)
        cc = ConfChange(id=self.reqid.next(), type=ConfChangeType.ADD_NODE,
                        node_id=m.id,
                        context=json.dumps(m.to_dict()).encode())
        return self._configure(cc)

    def remove_member(self, mid: int) -> List[Member]:
        self.cluster.validate_conf_change("remove", mid)
        cc = ConfChange(id=self.reqid.next(),
                        type=ConfChangeType.REMOVE_NODE, node_id=mid)
        return self._configure(cc)

    def update_member(self, m: Member) -> List[Member]:
        self.cluster.validate_conf_change("update", m.id, m.peer_urls)
        cc = ConfChange(id=self.reqid.next(),
                        type=ConfChangeType.UPDATE_NODE, node_id=m.id,
                        context=json.dumps(m.to_dict()).encode())
        return self._configure(cc)

    def _configure(self, cc: ConfChange) -> List[Member]:
        q = self.wait.register(cc.id)
        self._inq.put(("confchange", cc))
        try:
            result = q.get(timeout=self.cfg.request_timeout)
        except queue.Empty:
            self.wait.cancel(cc.id)
            raise errors.EtcdError(errors.ECODE_RAFT_INTERNAL,
                                   cause="conf change timed out")
        if isinstance(result, errors.EtcdError):
            raise result
        return result

    # -- introspection ------------------------------------------------------

    @property
    def leader_id(self) -> int:
        return self.node.raft.lead

    def is_leader(self) -> bool:
        return self.leader_id == self.id

    @property
    def applied_index(self) -> int:
        return self._applied

    @property
    def commit_index(self) -> int:
        return self.node.raft.raft_log.committed

    @property
    def term(self) -> int:
        return self.node.raft.term

    def raft_status(self) -> dict:
        """Live raft status JSON for /debug/vars (reference
        etcdserver/raft.go:60-66 expvar + raft/status.go:52-67). Served by
        the run-loop thread to avoid torn reads of live raft state."""
        q: "queue.Queue[dict]" = queue.Queue(maxsize=1)
        self._inq.put(("status", q))
        try:
            return q.get(timeout=self.cfg.request_timeout)
        except queue.Empty:
            return {"error": "status request timed out"}

    # -- run loop -----------------------------------------------------------

    def _run(self) -> None:
        tick_s = self.cfg.tick_ms / 1000.0
        next_tick = time.monotonic() + tick_s
        while not self._stop_ev.is_set():
            timeout = max(next_tick - time.monotonic(), 0.0)
            try:
                kind, payload = self._inq.get(timeout=timeout)
            except queue.Empty:
                kind, payload = "tick", None
            if self._stop_ev.is_set():
                break
            if kind == "tick" or time.monotonic() >= next_tick:
                now = time.monotonic()
                if now >= next_tick:
                    # One tick however late, as Go's time.Ticker drops the
                    # ticks a slow receiver missed (etcdserver/raft.go's
                    # ticker): after a stall longer than the election
                    # timeout, the heartbeats queued behind it are
                    # stepped before this member campaigns.
                    self.node.tick()
                    next_tick += tick_s * (1 + int((now - next_tick)
                                                   // tick_s))
                self._on_tick()
            if kind == "msg":
                try:
                    self.node.step(payload)
                except ProposalDroppedError:
                    # A proposal a peer forwarded here while this member
                    # knows no leader: dropped, as raft.go's stepFollower
                    # and stepCandidate drop it (the proposer's request
                    # times out), instead of ending this loop.
                    pass
            elif kind == "prop":
                rid, data = payload
                try:
                    self.node.propose(data)
                except ProposalDroppedError:
                    self.wait.trigger(rid, errors.EtcdError(
                        errors.ECODE_LEADER_ELECT, cause="no leader"))
            elif kind == "confchange":
                try:
                    self.node.propose_conf_change(payload)
                except ProposalDroppedError:
                    self.wait.trigger(payload.id, errors.EtcdError(
                        errors.ECODE_LEADER_ELECT, cause="no leader"))
            elif kind == "unreachable":
                # Through the node's report_* (node.go's ReportUnreachable
                # and ReportSnapshot): `node.step` drops a local message
                # from a peer, so a leader never left a snapshot whose
                # send failed and waited on that follower for good.
                self.node.report_unreachable(payload)
            elif kind == "snap_status":
                self.node.report_snapshot(*payload)
            elif kind == "status":
                # Introspection runs on the owning thread so it never tears
                # a mid-apply view (reference routes Status() through
                # node.run the same way, raft/node.go status channel).
                try:
                    payload.put(self.node.status().to_json())
                except Exception as e:
                    payload.put({"error": str(e)})
            self._process_ready()
            if self._removed_self:
                self._stop_ev.set()

    def cluster_version(self) -> str:
        """The negotiated cluster version served at /version. Continuously
        re-decided by the leader as the MIN of all members' server versions
        (reference monitorVersions server.go:933-973 +
        decideClusterVersion cluster_util.go:142-186)."""
        from etcd_tpu_torch import version as ver
        return self.cluster.version() or ver.MIN_CLUSTER_VERSION

    @staticmethod
    def _ver_tuple(v: str):
        return tuple(int(x) for x in v.split(".")[:3])

    def _get_versions(self) -> Dict[int, Optional[str]]:
        """Each member's server version via the peer transport (so TLS
        clusters negotiate over the same mutual-TLS channel); None when
        unreachable (reference getVersions cluster_util.go:118-137). Self
        answers locally."""
        from etcd_tpu_torch import version as ver
        out: Dict[int, Optional[str]] = {}
        for m in self.cluster.members():
            if m.id == self.id:
                out[m.id] = ver.VERSION
            else:
                out[m.id] = self.transport.member_version(m.id, m.peer_urls)
        return out

    def _decide_cluster_version(self) -> Optional[str]:
        """Min server version across members; None if any member's version
        is unknown (reference decideClusterVersion)."""
        vers = self._get_versions()
        decided = None
        for mid, v in vers.items():
            if v is None:
                return None
            try:
                vt = self._ver_tuple(v)
            except ValueError:
                return None
            if decided is None or vt < self._ver_tuple(decided):
                decided = v
        return decided

    def _monitor_versions(self) -> None:
        """reference monitorVersions server.go:933-973: every interval (or
        immediately on winning leadership), the leader re-decides the
        cluster version and proposes an update when it rises — so mixed-
        version clusters settle on the minimum and upgrades roll forward
        only once every member has upgraded."""
        from etcd_tpu_torch import version as ver
        while not self._stop_ev.is_set():
            self._force_version_ev.wait(self.cfg.version_monitor_interval)
            self._force_version_ev.clear()
            if self._stop_ev.is_set():
                return
            if not self.is_leader():
                continue
            v = self._decide_cluster_version()
            if v is not None:
                v = ".".join(str(x) for x in self._ver_tuple(v)[:2]) + ".0"
            cur = self.cluster.version()
            target = None
            if cur is None:
                # 1. decided version if possible, 2. min cluster version.
                target = v or ver.MIN_CLUSTER_VERSION
            elif v is not None and self._ver_tuple(cur) < self._ver_tuple(v):
                target = v
            if target is not None:
                r = Request(id=self.reqid.next(), method=METHOD_PUT,
                            path=cl.CLUSTER_VERSION_KEY, val=target)
                self._inq.put(("prop", (r.id, r.encode())))

    def _on_tick(self) -> None:
        if self.is_leader():
            self.stats.become_leader()
            if not self.lead_elected_ev.is_set():
                self._force_version_ev.set()   # negotiate immediately
            self.lead_elected_ev.set()
            if not self._was_leader:
                # Fresh leadership: base every lease deadline on THIS
                # clock, treating all as just-renewed (grace window).
                self._was_leader = True
                now = self.clock()
                self._lease_seen = {lid: (seq, now) for lid, seq in
                                    self.v3.lease_seqs().items()}
                self._lease_revoke_inflight.clear()
            self._sync_elapsed += 1
            if (self._sync_elapsed >= self.cfg.sync_ticks):
                self._sync_elapsed = 0
                if self.store.has_ttl_keys():
                    r = Request(id=self.reqid.next(), method=METHOD_SYNC,
                                time=self.clock())
                    try:
                        self.node.propose(r.encode())
                    except ProposalDroppedError:
                        pass
                # v3 lease expiry: the leader's clock decides, the log
                # enacts — the v3 analogue of the SYNC above. A lease is
                # expired when ITS SEQ has not changed for > ttl on this
                # leader's clock; the revoke carries that seq as a fence
                # so a concurrently-committed keepalive wins.
                self._check_lease_expiry()
        elif self.leader_id != raftpb.NO_LEADER:
            self._was_leader = False
            self.stats.become_follower(self.leader_id)
            self.lead_elected_ev.set()
        if not self._published and self.leader_id != raftpb.NO_LEADER:
            self._publish()

    def _check_lease_expiry(self) -> None:
        """Leader-only: compare each lease's renewal seq against the last
        observation on this clock; propose ONE fenced revoke per expiry
        (re-proposed only after a cool-off, in case the first is lost)."""
        now = self.clock()
        seqs = self.v3.lease_seqs()
        for lid in list(self._lease_seen):
            if lid not in seqs:
                self._lease_seen.pop(lid, None)
                self._lease_revoke_inflight.pop(lid, None)
        cooloff = max(1.0, 4 * self.cfg.sync_ticks * self.cfg.tick_ms
                      / 1000.0)
        for lid, seq in seqs.items():
            seen = self._lease_seen.get(lid)
            if seen is None or seen[0] != seq:
                self._lease_seen[lid] = (seq, now)   # new or renewed
                continue
            ttl = self.v3.lease_ttl(lid)
            if ttl is None or now - seen[1] <= ttl:
                continue
            last = self._lease_revoke_inflight.get(lid, 0.0)
            if now - last < cooloff:
                continue   # a revoke is already in flight
            self._lease_revoke_inflight[lid] = now
            r = Request(id=self.reqid.next(), method=METHOD_V3,
                        v3={"type": "lease_revoke", "lease_id": lid,
                            "seq": seq})
            try:
                self.node.propose(r.encode())
            except ProposalDroppedError:
                pass

    def _publish(self) -> None:
        """Propose our own attributes (reference publish server.go:688-715);
        retried on later ticks until the apply marks us published."""
        me = self.cluster.member(self.id)
        name = self.cfg.name
        curls = list(self.cfg.client_urls or
                     (me.client_urls if me else ()))
        r = Request(id=self.reqid.next(), method=METHOD_PUT,
                    path=(cl.member_store_key(self.id) + _MEMBER_ATTR_SUFFIX),
                    val=json.dumps({"name": name, "clientURLs": curls},
                                   sort_keys=True))
        try:
            self.node.propose(r.encode())
        except ProposalDroppedError:
            pass

    def _process_ready(self) -> None:
        while True:
            rd = self.node.ready()
            if rd is None:
                return
            # 1. Persist: snapshot file, then WAL {HardState, Entries} fsync
            #    (reference etcdserver/raft.go:139-160, contract doc.go:31-39).
            if not rd.snapshot.is_empty():
                self.storage.save_snap(rd.snapshot)
            self.storage.save(rd.hard_state, list(rd.entries))
            if not rd.snapshot.is_empty():
                self.raft_storage.apply_snapshot(rd.snapshot)
                self._recover_from_snapshot(rd.snapshot)
            if rd.entries:
                self.raft_storage.append(list(rd.entries))
            # 2. Send AFTER persist.
            self.transport.send(rd.messages)
            # 3. Apply committed entries, then acknowledge.
            self._apply_entries(rd.committed_entries)
            self.node.advance()
            self._maybe_snapshot()

    def _recover_from_snapshot(self, snap: Snapshot) -> None:
        """A MsgSnap overtook our log: reset BOTH state machines from the
        leader's snapshot (reference server.go:429-453; the v3 backend
        image rides the same payload)."""
        v2, v3img = _decode_snap_data(snap.data)
        self.store.recovery(v2)
        self._install_v3_from_snap(v3img, snap.metadata.index)
        self.cluster.recover()
        self._applied = snap.metadata.index
        self._snapi = snap.metadata.index
        for m in self.cluster.members():
            if m.id != self.id:
                self.transport.add_peer(m.id, m.peer_urls)

    def _install_v3_from_snap(self, v3img: Optional[bytes],
                              snap_index: int) -> None:
        if v3img is not None:
            self.v3.install_snapshot(v3img)
            self.v3_gapped = False
        elif snap_index > self.v3.consistent_index:
            # Legacy snapshot without a v3 image: entries in
            # (consistent_index, snap_index] are compacted away, so this
            # member's v3 keyspace has silently forked — REFUSE v3 service
            # (incl. serializable reads) instead of serving diverged data.
            self.v3_gapped = True
            log.error("snapshot at index %d outran the v3 backend "
                      "(consistent index %d) and carries no v3 image: "
                      "v3 service DISABLED on this member until resync",
                      snap_index, self.v3.consistent_index)

    def _apply_entries(self, ents: Sequence[Entry]) -> None:
        for e in ents:
            if e.index <= self._applied:
                continue
            if e.type == EntryType.NORMAL:
                self._apply_normal(e)
            elif e.type == EntryType.CONF_CHANGE:
                self._apply_conf_change(e)
            self._applied = e.index

    def _apply_normal(self, e: Entry) -> None:
        if not e.data:
            return  # leader's empty commit marker
        r = Request.decode(e.data)
        try:
            result = self._apply_request(r, e.index)
        except errors.EtcdError as err:
            result = err
        self.wait.trigger(r.id, result)

    def _apply_request(self, r: Request, index: int = 0):
        """Deterministic request→store mapping (reference applyRequest
        server.go:766-820). v3 ops carry the entry index so the v3
        consistent-index can make replay idempotent."""
        from etcd_tpu_torch.server.v3 import V3Error
        if r.method == METHOD_V3:
            try:
                return self.v3.apply(r.v3 or {}, index)
            except V3Error as e:
                return e   # deterministic; delivered to the waiter as-is
            except Exception:
                # Environmental failure (disk I/O, sqlite corruption): the
                # apply did NOT record its consistent index and nothing
                # committed (atomic hold), so crashing this member and
                # re-applying on restart is the consistent outcome — the
                # reference panics on backend errors for the same reason.
                # Deterministic data errors can't land here: validate_op
                # turns them into V3Errors on every member identically.
                log.exception("fatal: v3 apply failed at index %d; "
                              "member refuses service until restart", index)
                self._fatal = True
                raise
        st = self.store
        exp = r.expiration
        if r.method == METHOD_POST:
            return st.create(r.path, is_dir=r.dir, value=r.val, unique=True,
                             expire_time=exp)
        if r.method == METHOD_PUT:
            if r.refresh:
                # TTL-only move: value kept, watchers not notified
                # (reference apply_v2.go Put refresh path).
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
            # Publish path: keep the cluster view in sync (reference
            # storeMemberAttributeRegexp special case).
            if (r.path.startswith(cl.STORE_CLUSTER_PREFIX) and
                    r.path.endswith(_MEMBER_ATTR_SUFFIX)):
                mid = int(r.path.rsplit("/", 2)[1], 16)
                d = json.loads(r.val)
                self.cluster.update_member_attributes(
                    mid, d.get("name", ""), d.get("clientURLs", ()))
                if mid == self.id:
                    self._published = True
                return st.set(r.path, is_dir=r.dir, value=r.val,
                              expire_time=exp)
            if not r.dir and self.wait.is_registered(r.id):
                # Unconditional file PUT with a live waiter: hand back
                # raw descriptors and let the serving thread materialize
                # the Event (do()), keeping the run-loop thread's apply
                # slice minimal. Falls through for stores without the
                # native lazy path.
                lazy = getattr(st, "set_applied_lazy", None)
                if lazy is not None:
                    return lazy(r.path, r.val, exp)
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

    def _apply_conf_change(self, e: Entry) -> None:
        cc = raftpb.decode_conf_change(e.data)
        cs = self.node.apply_conf_change(cc)
        if cc.type == ConfChangeType.ADD_NODE:
            if cc.context:
                d = json.loads(cc.context.decode())
                m = Member(id=int(d["id"], 16) if isinstance(d["id"], str)
                           else d["id"],
                           name=d.get("name", ""),
                           peer_urls=tuple(d.get("peerURLs", ())),
                           client_urls=tuple(d.get("clientURLs", ())))
            else:
                m = Member(id=cc.node_id)
            self.cluster.add_member(m)
            if m.id != self.id:
                self.transport.add_peer(m.id, m.peer_urls)
        elif cc.type == ConfChangeType.REMOVE_NODE:
            self.cluster.remove_member(cc.node_id)
            if cc.node_id == self.id:
                self._removed_self = True
            else:
                self.transport.remove_peer(cc.node_id)
        elif cc.type == ConfChangeType.UPDATE_NODE:
            if cc.context:
                d = json.loads(cc.context.decode())
                self.cluster.update_member_raft_attributes(
                    cc.node_id, tuple(d.get("peerURLs", ())))
                if cc.node_id != self.id:
                    self.transport.update_peer(cc.node_id,
                                               d.get("peerURLs", ()))
        self.wait.trigger(cc.id, self.cluster.members())

    def _maybe_snapshot(self) -> None:
        """Snapshot + compact once enough entries applied (reference
        server.go:476-480,876-916)."""
        if self._applied - self._snapi <= self.cfg.snap_count:
            return
        # The snapshot advances the WAL-replay floor past every applied
        # entry, so the v3 backend's pending batch (data + consistent
        # index) must be durable FIRST — otherwise a crash inside the
        # batch interval loses v3 ops in (consistentIndex, snapshot] with
        # no replay to recover them.
        data = _encode_snap_data(self.store.save(),
                                 self.v3.snapshot_state())
        cs = ConfState(nodes=tuple(self.node.raft.nodes()))
        snap = self.raft_storage.create_snapshot(self._applied, cs, data)
        self.storage.save_snap(snap)
        self._snapi = self._applied
        compacti = self._snapi - self.cfg.catch_up_entries
        if compacti > self.raft_storage.first_index():
            try:
                self.raft_storage.compact(compacti)
            except CompactedError:
                pass
        purge_files(self.cfg.waldir, ".wal", MAX_WAL_FILES)
        purge_files(self.cfg.snapdir, ".snap", MAX_SNAP_FILES)
