"""Single-group run protocol: the Ready/Advance seam between the pure FSM and
the application's I/O.

Behavioral equivalent of reference raft/node.go:52-463, redesigned without
goroutines/channels: the Node is a synchronous driver — the host event loop
calls tick()/step()/propose(), then drains ready() and acknowledges with
advance(). The prescribed ordering contract (reference raft/doc.go:28-55)
is unchanged: persist HardState+Entries BEFORE sending Messages; apply
CommittedEntries; then advance().

This synchronous shape is exactly what the batched MultiNode engine
(etcd_tpu/server/engine.py) needs: one host thread owns all group state, and
"channels" become dense per-tick batches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from etcd_tpu_torch import raftpb
from etcd_tpu_torch.raftpb import (ConfChange, ConfChangeType, ConfState, Entry,
                             EntryType, HardState, EMPTY_HARD_STATE, Message,
                             MessageType, Snapshot, SoftState, StateType)
from etcd_tpu_torch.raft.core import Config, Raft
from etcd_tpu_torch.raft.progress import ProgressState


@dataclass
class Ready:
    """Everything the application must act on after stepping the FSM
    (reference node.go:52-80). Field order mirrors the required handling
    order."""

    soft_state: Optional[SoftState] = None
    hard_state: HardState = EMPTY_HARD_STATE
    entries: List[Entry] = field(default_factory=list)          # persist FIRST
    snapshot: Snapshot = Snapshot()                              # persist
    committed_entries: List[Entry] = field(default_factory=list)  # then apply
    messages: List[Message] = field(default_factory=list)        # send AFTER persist

    def contains_updates(self) -> bool:
        return (self.soft_state is not None
                or not self.hard_state.is_empty()
                or not self.snapshot.is_empty()
                or bool(self.entries)
                or bool(self.committed_entries)
                or bool(self.messages))


@dataclass(frozen=True)
class Peer:
    id: int
    context: bytes = b""


class SnapshotStatus:
    FINISH = True
    FAILURE = False


@dataclass
class Status:
    """Point-in-time introspection copy (reference raft/status.go:23-49)."""

    id: int
    hard_state: HardState
    soft_state: SoftState
    applied: int
    progress: Dict[int, Tuple[int, int, str]]  # id -> (match, next, state)

    def to_json(self) -> dict:
        d = {
            "id": f"{self.id:x}",
            "term": self.hard_state.term,
            "vote": f"{self.hard_state.vote:x}",
            "commit": self.hard_state.commit,
            "lead": f"{self.soft_state.lead:x}",
            "raftState": self.soft_state.raft_state.name,
            "progress": {},
        }
        if self.soft_state.raft_state == StateType.LEADER:
            d["progress"] = {
                f"{pid:x}": {"match": m, "next": n, "state": s}
                for pid, (m, n, s) in self.progress.items()
            }
        return d


class Node:
    """Synchronous wrapper turning the pure Raft core into a drivable unit."""

    def __init__(self, r: Raft) -> None:
        self._raft = r
        self._prev_soft = r.soft_state()
        self._prev_hard = EMPTY_HARD_STATE
        self._prev_last_unstable: Optional[Tuple[int, int]] = None  # (i, t)
        self._prev_snap_index = 0
        self._awaiting_advance = False
        self._prop_blocked = False  # local node removed from cluster

    # -- bootstrap -----------------------------------------------------------

    @staticmethod
    def start(c: Config, peers: Sequence[Peer]) -> "Node":
        """Fresh cluster bootstrap: synthesize committed ConfChangeAddNode
        entries at term 1 for the initial membership (reference
        node.go:145-180)."""
        r = Raft(c)
        r.become_follower(1, raftpb.NO_LEADER)
        for peer in peers:
            cc = ConfChange(type=ConfChangeType.ADD_NODE, node_id=peer.id,
                            context=peer.context)
            e = Entry(type=EntryType.CONF_CHANGE, term=1,
                      index=r.raft_log.last_index() + 1,
                      data=raftpb.encode_conf_change(cc))
            r.raft_log.append([e])
        r.raft_log.committed = r.raft_log.last_index()
        for peer in peers:
            r.add_node(peer.id)
        return Node(r)

    @staticmethod
    def restart(c: Config) -> "Node":
        """Restart from Storage (state recovered from WAL+snapshot); no peers
        argument — membership comes from the log (reference node.go:186-192)."""
        return Node(Raft(c))

    # -- inputs --------------------------------------------------------------

    def tick(self) -> None:
        self._raft.tick()

    def campaign(self) -> None:
        self._raft.step(Message(type=MessageType.HUP, frm=self._raft.id))

    def propose(self, data: bytes) -> None:
        if self._prop_blocked:
            from etcd_tpu_torch.raft.core import ProposalDroppedError
            raise ProposalDroppedError("local node removed from cluster")
        self.step(Message(type=MessageType.PROP, frm=self._raft.id,
                          entries=(Entry(data=data),)))

    def propose_conf_change(self, cc: ConfChange) -> None:
        if self._prop_blocked:
            from etcd_tpu_torch.raft.core import ProposalDroppedError
            raise ProposalDroppedError("local node removed from cluster")
        self.step(Message(type=MessageType.PROP, frm=self._raft.id,
                          entries=(Entry(type=EntryType.CONF_CHANGE,
                                         data=raftpb.encode_conf_change(cc)),)))

    def step(self, m: Message) -> None:
        # Ignore unexpected local messages arriving over the network; use
        # tick()/campaign()/report_*() for those (reference node.go:365-372).
        if raftpb.is_local_msg(m.type) and m.frm != self._raft.id:
            return
        if m.type in (MessageType.HUP, MessageType.BEAT):
            self._raft.step(m)
            return
        # Drop response messages from peers we don't know (reference
        # node.go:281-283).
        if raftpb.is_response_msg(m.type) and m.frm not in self._raft.prs:
            return
        self._raft.step(m)

    def report_unreachable(self, id: int) -> None:
        self._raft.step(Message(type=MessageType.UNREACHABLE, frm=id))

    def report_snapshot(self, id: int, ok: bool) -> None:
        self._raft.step(Message(type=MessageType.SNAP_STATUS, frm=id,
                                reject=not ok))

    def apply_conf_change(self, cc: ConfChange) -> ConfState:
        if cc.node_id == raftpb.NO_LEADER:
            self._raft.reset_pending_conf()
        elif cc.type == ConfChangeType.ADD_NODE:
            self._raft.add_node(cc.node_id)
        elif cc.type == ConfChangeType.REMOVE_NODE:
            if cc.node_id == self._raft.id:
                self._prop_blocked = True
            self._raft.remove_node(cc.node_id)
        elif cc.type == ConfChangeType.UPDATE_NODE:
            self._raft.reset_pending_conf()
        else:
            raise ValueError(f"unexpected conf change type {cc.type}")
        return ConfState(nodes=tuple(self._raft.nodes()))

    # -- Ready/Advance -------------------------------------------------------

    def has_ready(self) -> bool:
        if self._awaiting_advance:
            return False
        r = self._raft
        return (bool(r.msgs)
                or bool(r.raft_log.unstable.entries)
                or r.raft_log.unstable.snapshot is not None
                or r.raft_log.has_next_ents()
                or r.soft_state() != self._prev_soft
                or r.hard_state() != self._prev_hard)

    def ready(self) -> Optional[Ready]:
        """Drain the pending work batch; the caller must advance() before the
        next ready()."""
        if self._awaiting_advance:
            return None
        rd = self._new_ready()
        if not rd.contains_updates():
            return None
        if rd.soft_state is not None:
            self._prev_soft = rd.soft_state
        if rd.entries:
            last = rd.entries[-1]
            self._prev_last_unstable = (last.index, last.term)
        if not rd.hard_state.is_empty():
            self._prev_hard = rd.hard_state
        if not rd.snapshot.is_empty():
            self._prev_snap_index = rd.snapshot.metadata.index
        self._raft.msgs = []
        self._awaiting_advance = True
        return rd

    def advance(self) -> None:
        """Application finished persisting/applying the last Ready (reference
        node.go:330-337)."""
        if not self._awaiting_advance:
            return
        r = self._raft
        if self._prev_hard.commit != 0:
            r.raft_log.applied_to(self._prev_hard.commit)
        if self._prev_last_unstable is not None:
            r.raft_log.stable_to(*self._prev_last_unstable)
            self._prev_last_unstable = None
        r.raft_log.stable_snap_to(self._prev_snap_index)
        self._awaiting_advance = False

    def _new_ready(self) -> Ready:
        r = self._raft
        rd = Ready(
            entries=r.raft_log.unstable_entries(),
            committed_entries=r.raft_log.next_ents(),
            messages=list(r.msgs),
        )
        soft = r.soft_state()
        if soft != self._prev_soft:
            rd.soft_state = soft
        hard = r.hard_state()
        if hard != self._prev_hard:
            rd.hard_state = hard
        if r.raft_log.unstable.snapshot is not None:
            rd.snapshot = r.raft_log.unstable.snapshot
        return rd

    # -- introspection -------------------------------------------------------

    @property
    def raft(self) -> Raft:
        return self._raft

    def status(self) -> Status:
        r = self._raft
        return Status(
            id=r.id,
            hard_state=r.hard_state(),
            soft_state=r.soft_state(),
            applied=r.raft_log.applied,
            progress={pid: (pr.match, pr.next, pr.state.name)
                      for pid, pr in r.prs.items()},
        )
