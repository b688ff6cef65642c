"""Wire/durable protocol types for the consensus core.

Behavioral equivalent of the reference's raftpb schema
(etcd's raft/raftpb/raft.pb.go:71-245): the 12 message types, Entry,
Message, HardState, Snapshot{Metadata}, ConfState and ConfChange. Re-designed
as Python dataclasses with a compact, deterministic binary codec (used by the
WAL and the inter-host transport) instead of generated protobuf — the on-device
kernel never sees these objects, only dense integer tensors derived from them
(see etcd_tpu/ops/batch.py).
"""
from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Iterable, List, Optional, Tuple


class EntryType(enum.IntEnum):
    NORMAL = 0
    CONF_CHANGE = 1


class MessageType(enum.IntEnum):
    """Message vocabulary (reference raft.pb.go:71-82, same semantics).

    HUP/BEAT/UNREACHABLE/SNAP_STATUS are local (never cross the wire);
    *_RESP are responses (reference raft/util.go:49-57).
    """

    HUP = 0            # local: start election
    BEAT = 1           # local: leader heartbeat tick
    PROP = 2           # propose entries
    APP = 3            # append entries (replication)
    APP_RESP = 4
    VOTE = 5
    VOTE_RESP = 6
    SNAP = 7           # leader->follower snapshot install
    HEARTBEAT = 8
    HEARTBEAT_RESP = 9
    UNREACHABLE = 10   # local: transport reports peer unreachable
    SNAP_STATUS = 11   # local: transport reports snapshot send outcome


LOCAL_MESSAGES = frozenset(
    {MessageType.HUP, MessageType.BEAT, MessageType.UNREACHABLE,
     MessageType.SNAP_STATUS}
)

RESPONSE_MESSAGES = frozenset(
    {MessageType.APP_RESP, MessageType.VOTE_RESP, MessageType.HEARTBEAT_RESP,
     MessageType.UNREACHABLE}
)


def is_local_msg(t: MessageType) -> bool:
    return t in LOCAL_MESSAGES


def is_response_msg(t: MessageType) -> bool:
    return t in RESPONSE_MESSAGES


class ConfChangeType(enum.IntEnum):
    ADD_NODE = 0
    REMOVE_NODE = 1
    UPDATE_NODE = 2


class StateType(enum.IntEnum):
    """Role of a raft peer. Integer values are shared with the batched kernel."""

    FOLLOWER = 0
    CANDIDATE = 1
    LEADER = 2


NO_LEADER = 0  # sentinel node id meaning "no leader known" (ids are >= 1)
NO_LIMIT = (1 << 63) - 1


@dataclass(frozen=True)
class Entry:
    term: int = 0
    index: int = 0
    type: EntryType = EntryType.NORMAL
    data: bytes = b""

    @property
    def size(self) -> int:
        # Fixed metadata + payload; used for maxSizePerMsg-style chunking.
        return 24 + len(self.data)


@dataclass(frozen=True)
class ConfState:
    nodes: Tuple[int, ...] = ()


@dataclass(frozen=True)
class SnapshotMetadata:
    conf_state: ConfState = ConfState()
    index: int = 0
    term: int = 0


@dataclass(frozen=True)
class Snapshot:
    data: bytes = b""
    metadata: SnapshotMetadata = SnapshotMetadata()

    def is_empty(self) -> bool:
        return self.metadata.index == 0


@dataclass(frozen=True)
class Message:
    type: MessageType
    to: int = 0
    frm: int = 0
    term: int = 0       # 0 == local message (no term attached)
    log_term: int = 0   # term of the entry preceding `entries` (MsgApp)
    index: int = 0      # log index preceding `entries` (MsgApp) / match (resp)
    entries: Tuple[Entry, ...] = ()
    commit: int = 0
    snapshot: Snapshot = Snapshot()
    reject: bool = False
    reject_hint: int = 0


@dataclass(frozen=True)
class HardState:
    """Durable per-group state: must be fsynced before messages are sent
    (ordering contract, reference raft/doc.go:31-39)."""

    term: int = 0
    vote: int = 0
    commit: int = 0

    def is_empty(self) -> bool:
        return self == EMPTY_HARD_STATE


EMPTY_HARD_STATE = HardState()


@dataclass(frozen=True)
class SoftState:
    """Volatile state; safe to lose on restart."""

    lead: int = NO_LEADER
    raft_state: StateType = StateType.FOLLOWER


@dataclass(frozen=True)
class ConfChange:
    id: int = 0
    type: ConfChangeType = ConfChangeType.ADD_NODE
    node_id: int = 0
    context: bytes = b""


# ---------------------------------------------------------------------------
# Binary codec
#
# Deterministic fixed-layout framing (little-endian), shared by the WAL and
# the batched inter-host transport. Layout intentionally keeps all metadata
# fields at fixed offsets so a future C++ fast path can parse headers without
# branching.
# ---------------------------------------------------------------------------

_ENTRY_HDR = struct.Struct("<QQBI")  # term, index, type, len(data)
_HARD_STATE = struct.Struct("<QQQ")  # term, vote, commit
_MSG_HDR = struct.Struct("<BQQQQQQ?QI")  # type,to,frm,term,log_term,index,commit,reject,reject_hint,n_entries
_SNAP_HDR = struct.Struct("<QQI")    # index, term, n_nodes
_CONF_CHANGE = struct.Struct("<QBQI")  # id, type, node_id, len(context)


def encode_entry(e: Entry) -> bytes:
    return _ENTRY_HDR.pack(e.term, e.index, int(e.type), len(e.data)) + e.data


def decode_entry(buf: bytes, off: int = 0) -> Tuple[Entry, int]:
    term, index, typ, n = _ENTRY_HDR.unpack_from(buf, off)
    off += _ENTRY_HDR.size
    data = bytes(buf[off:off + n])
    if len(data) != n:
        raise ValueError("truncated entry payload")
    return Entry(term=term, index=index, type=EntryType(typ), data=data), off + n


def encode_hard_state(hs: HardState) -> bytes:
    return _HARD_STATE.pack(hs.term, hs.vote, hs.commit)


def decode_hard_state(buf: bytes) -> HardState:
    term, vote, commit = _HARD_STATE.unpack(buf)
    return HardState(term=term, vote=vote, commit=commit)


def encode_snapshot(s: Snapshot) -> bytes:
    md = s.metadata
    out = [_SNAP_HDR.pack(md.index, md.term, len(md.conf_state.nodes))]
    for n in md.conf_state.nodes:
        out.append(struct.pack("<Q", n))
    out.append(struct.pack("<I", len(s.data)))
    out.append(s.data)
    return b"".join(out)


def decode_snapshot(buf: bytes, off: int = 0) -> Tuple[Snapshot, int]:
    index, term, n_nodes = _SNAP_HDR.unpack_from(buf, off)
    off += _SNAP_HDR.size
    nodes = []
    for _ in range(n_nodes):
        (n,) = struct.unpack_from("<Q", buf, off)
        nodes.append(n)
        off += 8
    (dlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    data = bytes(buf[off:off + dlen])
    if len(data) != dlen:
        raise ValueError("truncated snapshot payload")
    snap = Snapshot(
        data=data,
        metadata=SnapshotMetadata(
            conf_state=ConfState(nodes=tuple(nodes)), index=index, term=term
        ),
    )
    return snap, off + dlen


def encode_message(m: Message) -> bytes:
    out = [
        _MSG_HDR.pack(int(m.type), m.to, m.frm, m.term, m.log_term, m.index,
                      m.commit, m.reject, m.reject_hint, len(m.entries))
    ]
    for e in m.entries:
        out.append(encode_entry(e))
    out.append(encode_snapshot(m.snapshot))
    return b"".join(out)


def decode_message(buf: bytes, off: int = 0) -> Tuple[Message, int]:
    (typ, to, frm, term, log_term, index, commit, reject, reject_hint,
     n_entries) = _MSG_HDR.unpack_from(buf, off)
    off += _MSG_HDR.size
    entries: List[Entry] = []
    for _ in range(n_entries):
        e, off = decode_entry(buf, off)
        entries.append(e)
    snap, off = decode_snapshot(buf, off)
    return (
        Message(type=MessageType(typ), to=to, frm=frm, term=term,
                log_term=log_term, index=index, entries=tuple(entries),
                commit=commit, snapshot=snap, reject=bool(reject),
                reject_hint=reject_hint),
        off,
    )


def encode_conf_change(cc: ConfChange) -> bytes:
    return _CONF_CHANGE.pack(cc.id, int(cc.type), cc.node_id, len(cc.context)) + cc.context


def decode_conf_change(buf: bytes) -> ConfChange:
    ccid, typ, node_id, n = _CONF_CHANGE.unpack_from(buf, 0)
    ctx = bytes(buf[_CONF_CHANGE.size:_CONF_CHANGE.size + n])
    if len(ctx) != n:
        raise ValueError("truncated conf change context")
    return ConfChange(id=ccid, type=ConfChangeType(typ), node_id=node_id, context=ctx)


def limit_size(entries: Iterable[Entry], max_size: int) -> Tuple[Entry, ...]:
    """Return the longest prefix of `entries` within max_size bytes, but always
    at least one entry (reference raft/util.go limitSize semantics)."""
    out: List[Entry] = []
    size = 0
    for e in entries:
        size += e.size
        if out and size > max_size:
            break
        out.append(e)
    return tuple(out)


def replace(obj, **kw):
    """dataclasses.replace re-export (keeps call sites terse)."""
    return _dc_replace(obj, **kw)
