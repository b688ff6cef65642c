"""The pure, deterministic, I/O-free Raft state machine (scalar reference).

Behavioral equivalent of reference raft/raft.go:125-771: leader election,
log replication, quorum commit, membership change, snapshot transfer
decisions. This scalar implementation is the *oracle* for the batched TPU
kernel (etcd_tpu/ops/kernel.py): both share integer state encodings and the
xorshift32 election-timeout PRNG, so a batched step over G groups must equal
G scalar steps bit-for-bit.

Design departures from the reference (deliberate, TPU-first):
- No goroutines/channels — the FSM is stepped synchronously; the run loop
  lives in etcd_tpu/raft/node.py.
- Randomized election timeout draws from a seedable xorshift32 stream
  (reference raft.go:765-771 uses math/rand seeded by node id) so that the
  dense (G,)-array PRNG in the kernel reproduces it exactly.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from etcd_tpu_torch import raftpb
from etcd_tpu_torch.raftpb import (Entry, EntryType, HardState, Message, MessageType,
                             NO_LEADER, Snapshot, SoftState, StateType)
from etcd_tpu_torch.raft.log import RaftLog
from etcd_tpu_torch.raft.progress import Progress, ProgressState
from etcd_tpu_torch.raft.storage import Storage


class ProposalDroppedError(Exception):
    """Proposal dropped (no leader, or removed from cluster)."""


def xorshift32(x: int) -> int:
    """One step of the 32-bit xorshift PRNG (Marsaglia 2003). Mirrored
    verbatim by the batched kernel on uint32 lanes."""
    x &= 0xFFFFFFFF
    x ^= (x << 13) & 0xFFFFFFFF
    x ^= x >> 17
    x ^= (x << 5) & 0xFFFFFFFF
    return x & 0xFFFFFFFF


def prng_seed(group: int, node: int) -> int:
    """Non-zero deterministic seed per (group, node)."""
    s = (group * 0x9E3779B9 + node * 0x85EBCA6B + 1) & 0xFFFFFFFF
    return s if s else 1


class Config:
    def __init__(self, id: int, election_tick: int, heartbeat_tick: int,
                 storage: Storage, peers: Sequence[int] = (),
                 applied: int = 0,
                 max_size_per_msg: int = raftpb.NO_LIMIT,
                 max_inflight_msgs: int = 256,
                 group: int = 0) -> None:
        self.id = id
        self.peers = tuple(peers)
        self.election_tick = election_tick
        self.heartbeat_tick = heartbeat_tick
        self.storage = storage
        self.applied = applied
        self.max_size_per_msg = max_size_per_msg
        self.max_inflight_msgs = max_inflight_msgs
        self.group = group

    def validate(self) -> None:
        if self.id == 0:
            raise ValueError("cannot use 0 as raft id")
        if self.heartbeat_tick <= 0:
            raise ValueError("heartbeat tick must be greater than 0")
        if self.election_tick <= self.heartbeat_tick:
            raise ValueError("election tick must be greater than heartbeat tick")
        if self.storage is None:
            raise ValueError("storage cannot be nil")
        if self.max_inflight_msgs <= 0:
            raise ValueError("max inflight messages must be greater than 0")


class Raft:
    def __init__(self, c: Config) -> None:
        c.validate()
        self.id = c.id
        self.group = c.group
        raft_log = RaftLog(c.storage)
        hs, cs = c.storage.initial_state()
        peers = c.peers
        if cs.nodes:
            if peers:
                raise ValueError(
                    "cannot specify both Config.peers and ConfState.nodes")
            peers = cs.nodes

        self.raft_log = raft_log
        self.max_msg_size = c.max_size_per_msg
        self.max_inflight = c.max_inflight_msgs
        self.prs: Dict[int, Progress] = {}
        self.election_timeout = c.election_tick
        self.heartbeat_timeout = c.heartbeat_tick

        # Durable (HardState) fields.
        self.term = 0
        self.vote = NO_LEADER

        # Volatile.
        self.lead = NO_LEADER
        self.state = StateType.FOLLOWER
        self.votes: Dict[int, bool] = {}
        self.msgs: List[Message] = []
        self.pending_conf = False
        self.elapsed = 0
        self._prng = prng_seed(c.group, c.id)

        self._step_fn: Callable[[Message], None] = self._step_follower
        self._tick_fn: Callable[[], None] = self.tick_election

        for p in peers:
            self.prs[p] = Progress(next=1, inflight_size=self.max_inflight)
        if not hs.is_empty():
            self.load_state(hs)
        if c.applied > 0:
            raft_log.applied_to(c.applied)
        self.become_follower(self.term, NO_LEADER)

    # -- introspection -------------------------------------------------------

    def has_leader(self) -> bool:
        return self.lead != NO_LEADER

    def soft_state(self) -> SoftState:
        return SoftState(lead=self.lead, raft_state=self.state)

    def hard_state(self) -> HardState:
        return HardState(term=self.term, vote=self.vote,
                         commit=self.raft_log.committed)

    def quorum(self) -> int:
        return len(self.prs) // 2 + 1

    def nodes(self) -> List[int]:
        return sorted(self.prs)

    # -- outbound messages ---------------------------------------------------

    def _send(self, m: Message) -> None:
        # MsgProp carries no term: proposals forward to the leader and are
        # treated as local (reference raft.go:227-236).
        term = m.term if m.type == MessageType.PROP else self.term
        self.msgs.append(raftpb.replace(m, frm=self.id, term=term))

    def send_append(self, to: int) -> None:
        pr = self.prs[to]
        if pr.is_paused():
            return
        next_idx = pr.next
        if next_idx < self.raft_log.first_index():
            # Follower is behind our compaction point: ship a snapshot.
            snapshot = self.raft_log.snapshot()
            if snapshot.is_empty():
                raise RuntimeError("need non-empty snapshot")
            self._send(Message(type=MessageType.SNAP, to=to, snapshot=snapshot))
            pr.become_snapshot(snapshot.metadata.index)
            return
        entries = tuple(self.raft_log.entries(next_idx, self.max_msg_size))
        m = Message(
            type=MessageType.APP, to=to, index=next_idx - 1,
            log_term=self.raft_log.term(next_idx - 1), entries=entries,
            commit=self.raft_log.committed)
        if entries:
            if pr.state == ProgressState.REPLICATE:
                last = entries[-1].index
                pr.optimistic_update(last)
                pr.ins.add(last)
            elif pr.state == ProgressState.PROBE:
                pr.pause()
            else:
                raise RuntimeError(f"sending append in state {pr.state}")
        self._send(m)

    def send_heartbeat(self, to: int) -> None:
        # Never forward the follower's commit past its match
        # (reference raft.go:285-299).
        commit = min(self.prs[to].match, self.raft_log.committed)
        self._send(Message(type=MessageType.HEARTBEAT, to=to, commit=commit))

    def bcast_append(self) -> None:
        for peer in self.prs:
            if peer != self.id:
                self.send_append(peer)

    def bcast_heartbeat(self) -> None:
        for peer in self.prs:
            if peer != self.id:
                self.send_heartbeat(peer)
                self.prs[peer].resume()

    # -- commit --------------------------------------------------------------

    def maybe_commit(self) -> bool:
        """Quorum commit: the q-th largest match index (reference
        raft.go:323-332). This sort-median is THE reduction the batched kernel
        turns into lax.top_k over the peers axis."""
        matches = sorted((pr.match for pr in self.prs.values()), reverse=True)
        mci = matches[self.quorum() - 1]
        return self.raft_log.maybe_commit(mci, self.term)

    # -- state transitions ---------------------------------------------------

    def reset(self, term: int) -> None:
        if self.term != term:
            self.term = term
            self.vote = NO_LEADER
        self.lead = NO_LEADER
        self.elapsed = 0
        self.votes = {}
        last = self.raft_log.last_index()
        for peer in self.prs:
            self.prs[peer] = Progress(next=last + 1,
                                      inflight_size=self.max_inflight)
            if peer == self.id:
                self.prs[peer].match = last
        self.pending_conf = False

    def append_entry(self, *es: Entry) -> None:
        li = self.raft_log.last_index()
        stamped = [raftpb.replace(e, term=self.term, index=li + 1 + i)
                   for i, e in enumerate(es)]
        self.raft_log.append(stamped)
        self.prs[self.id].maybe_update(self.raft_log.last_index())
        self.maybe_commit()

    def tick_election(self) -> None:
        if not self.promotable():
            self.elapsed = 0
            return
        self.elapsed += 1
        if self.is_election_timeout():
            self.elapsed = 0
            self.step(Message(type=MessageType.HUP, frm=self.id))

    def tick_heartbeat(self) -> None:
        self.elapsed += 1
        if self.elapsed >= self.heartbeat_timeout:
            self.elapsed = 0
            self.step(Message(type=MessageType.BEAT, frm=self.id))

    def tick(self) -> None:
        self._tick_fn()

    def become_follower(self, term: int, lead: int) -> None:
        self._step_fn = self._step_follower
        self.reset(term)
        self._tick_fn = self.tick_election
        self.lead = lead
        self.state = StateType.FOLLOWER

    def become_candidate(self) -> None:
        if self.state == StateType.LEADER:
            raise RuntimeError("invalid transition [leader -> candidate]")
        self._step_fn = self._step_candidate
        self.reset(self.term + 1)
        self._tick_fn = self.tick_election
        self.vote = self.id
        self.state = StateType.CANDIDATE

    def become_leader(self) -> None:
        if self.state == StateType.FOLLOWER:
            raise RuntimeError("invalid transition [follower -> leader]")
        self._step_fn = self._step_leader
        self.reset(self.term)
        self._tick_fn = self.tick_heartbeat
        self.lead = self.id
        self.state = StateType.LEADER
        for e in self.raft_log.entries(self.raft_log.committed + 1):
            if e.type != EntryType.CONF_CHANGE:
                continue
            if self.pending_conf:
                raise RuntimeError("unexpected double uncommitted config entry")
            self.pending_conf = True
        # Leader commits a no-op entry from its own term (paper §5.4.2).
        self.append_entry(Entry())

    def campaign(self) -> None:
        if not self.promotable():
            return  # removed from the cluster; a HUP must not crash us
        self.become_candidate()
        if self.quorum() == self.poll(self.id, True):
            self.become_leader()
            return
        for peer in self.prs:
            if peer == self.id:
                continue
            self._send(Message(type=MessageType.VOTE, to=peer,
                               index=self.raft_log.last_index(),
                               log_term=self.raft_log.last_term()))

    def poll(self, id: int, granted: bool) -> int:
        if id not in self.votes:
            self.votes[id] = granted
        return sum(1 for v in self.votes.values() if v)

    # -- the step function ---------------------------------------------------

    def step(self, m: Message) -> None:
        if m.type == MessageType.HUP:
            # A leader ignores HUP (its tick path never produces one; a no-op
            # here keeps the batched kernel branch-free on this edge).
            if self.state != StateType.LEADER:
                self.campaign()
            return

        if m.term == 0:
            pass  # local message
        elif m.term > self.term:
            # A vote request doesn't establish its sender as leader.
            lead = NO_LEADER if m.type == MessageType.VOTE else m.frm
            self.become_follower(m.term, lead)
        elif m.term < self.term:
            return  # stale — ignore

        self._step_fn(m)

    def _step_leader(self, m: Message) -> None:
        t = m.type
        if t == MessageType.BEAT:
            self.bcast_heartbeat()
            return
        if t == MessageType.PROP:
            if not m.entries:
                raise RuntimeError("stepped empty MsgProp")
            entries = list(m.entries)
            for i, e in enumerate(entries):
                if e.type == EntryType.CONF_CHANGE:
                    # Only one in-flight config change at a time: demote
                    # extras to empty normal entries (reference raft.go:504-511).
                    if self.pending_conf:
                        entries[i] = Entry(type=EntryType.NORMAL)
                    self.pending_conf = True
            self.append_entry(*entries)
            self.bcast_append()
            return
        if t == MessageType.VOTE:
            self._send(Message(type=MessageType.VOTE_RESP, to=m.frm, reject=True))
            return

        pr = self.prs.get(m.frm)
        if pr is None:
            return
        if t == MessageType.APP_RESP:
            if m.reject:
                if pr.maybe_decr_to(m.index, m.reject_hint):
                    if pr.state == ProgressState.REPLICATE:
                        pr.become_probe()
                    self.send_append(m.frm)
            else:
                old_paused = pr.is_paused()
                if pr.maybe_update(m.index):
                    if pr.state == ProgressState.PROBE:
                        pr.become_replicate()
                    elif (pr.state == ProgressState.SNAPSHOT
                          and pr.need_snapshot_abort()):
                        pr.become_probe()
                    elif pr.state == ProgressState.REPLICATE:
                        pr.ins.free_to(m.index)
                    if self.maybe_commit():
                        self.bcast_append()
                    elif old_paused:
                        # The ack unpaused this follower; send the delayed
                        # append now.
                        self.send_append(m.frm)
        elif t == MessageType.HEARTBEAT_RESP:
            if pr.state == ProgressState.REPLICATE and pr.ins.full():
                pr.ins.free_first_one()
            if pr.match < self.raft_log.last_index():
                self.send_append(m.frm)
        elif t == MessageType.SNAP_STATUS:
            if pr.state != ProgressState.SNAPSHOT:
                return
            if m.reject:
                pr.snapshot_failure()
            pr.become_probe()
            # Wait for the next MsgAppResp (success) or a heartbeat interval
            # (failure) before the next append (reference raft.go:559-574).
            pr.pause()
        elif t == MessageType.UNREACHABLE:
            # An optimistic in-flight MsgApp was probably lost.
            if pr.state == ProgressState.REPLICATE:
                pr.become_probe()

    def _step_candidate(self, m: Message) -> None:
        t = m.type
        if t == MessageType.PROP:
            raise ProposalDroppedError(f"no leader at term {self.term}")
        if t == MessageType.APP:
            self.become_follower(self.term, m.frm)
            self.handle_append_entries(m)
        elif t == MessageType.HEARTBEAT:
            self.become_follower(self.term, m.frm)
            self.handle_heartbeat(m)
        elif t == MessageType.SNAP:
            self.become_follower(m.term, m.frm)
            self.handle_snapshot(m)
        elif t == MessageType.VOTE:
            self._send(Message(type=MessageType.VOTE_RESP, to=m.frm, reject=True))
        elif t == MessageType.VOTE_RESP:
            granted = self.poll(m.frm, not m.reject)
            if granted == self.quorum():
                self.become_leader()
                self.bcast_append()
            elif len(self.votes) - granted == self.quorum():
                self.become_follower(self.term, NO_LEADER)

    def _step_follower(self, m: Message) -> None:
        t = m.type
        if t == MessageType.PROP:
            if self.lead == NO_LEADER:
                raise ProposalDroppedError(f"no leader at term {self.term}")
            self._send(raftpb.replace(m, to=self.lead))
        elif t == MessageType.APP:
            self.elapsed = 0
            self.lead = m.frm
            self.handle_append_entries(m)
        elif t == MessageType.HEARTBEAT:
            self.elapsed = 0
            self.lead = m.frm
            self.handle_heartbeat(m)
        elif t == MessageType.SNAP:
            self.elapsed = 0
            self.handle_snapshot(m)
        elif t == MessageType.VOTE:
            if ((self.vote in (NO_LEADER, m.frm))
                    and self.raft_log.is_up_to_date(m.index, m.log_term)):
                self.elapsed = 0
                self.vote = m.frm
                self._send(Message(type=MessageType.VOTE_RESP, to=m.frm))
            else:
                self._send(Message(type=MessageType.VOTE_RESP, to=m.frm,
                                   reject=True))

    # -- message handlers ----------------------------------------------------

    def handle_append_entries(self, m: Message) -> None:
        if m.index < self.raft_log.committed:
            self._send(Message(type=MessageType.APP_RESP, to=m.frm,
                               index=self.raft_log.committed))
            return
        lastnewi = self.raft_log.maybe_append(m.index, m.log_term, m.commit,
                                              m.entries)
        if lastnewi is not None:
            self._send(Message(type=MessageType.APP_RESP, to=m.frm,
                               index=lastnewi))
        else:
            self._send(Message(type=MessageType.APP_RESP, to=m.frm,
                               index=m.index, reject=True,
                               reject_hint=self.raft_log.last_index()))

    def handle_heartbeat(self, m: Message) -> None:
        self.raft_log.commit_to(m.commit)
        self._send(Message(type=MessageType.HEARTBEAT_RESP, to=m.frm))

    def handle_snapshot(self, m: Message) -> None:
        if self.restore(m.snapshot):
            self._send(Message(type=MessageType.APP_RESP, to=m.frm,
                               index=self.raft_log.last_index()))
        else:
            self._send(Message(type=MessageType.APP_RESP, to=m.frm,
                               index=self.raft_log.committed))

    def restore(self, s: Snapshot) -> bool:
        """Recover log + membership from a snapshot (reference
        raft.go:686-713)."""
        if s.metadata.index <= self.raft_log.committed:
            return False
        if self.raft_log.match_term(s.metadata.index, s.metadata.term):
            # Already have these entries; just fast-forward commit.
            self.raft_log.commit_to(s.metadata.index)
            return False
        self.raft_log.restore(s)
        self.prs = {}
        for n in s.metadata.conf_state.nodes:
            next_idx = self.raft_log.last_index() + 1
            match = next_idx - 1 if n == self.id else 0
            self.set_progress(n, match, next_idx)
        return True

    # -- membership ----------------------------------------------------------

    def promotable(self) -> bool:
        return self.id in self.prs

    def add_node(self, id: int) -> None:
        if id in self.prs:
            return  # bootstrap entries can be applied twice
        self.set_progress(id, 0, self.raft_log.last_index() + 1)
        self.pending_conf = False

    def remove_node(self, id: int) -> None:
        self.prs.pop(id, None)
        self.pending_conf = False
        if not self.prs:
            return
        # Quorum shrank: pending entries may now be committed (adopted from
        # the upstream fix after the reference snapshot; without it a removal
        # can stall commits until the next proposal).
        if self.state == StateType.LEADER and self.maybe_commit():
            self.bcast_append()

    def reset_pending_conf(self) -> None:
        self.pending_conf = False

    def set_progress(self, id: int, match: int, next: int) -> None:
        pr = Progress(next=next, match=match, inflight_size=self.max_inflight)
        self.prs[id] = pr

    def load_state(self, state: HardState) -> None:
        if (state.commit < self.raft_log.committed
                or state.commit > self.raft_log.last_index()):
            raise RuntimeError(
                f"hardstate commit {state.commit} out of range "
                f"[{self.raft_log.committed}, {self.raft_log.last_index()}]")
        self.raft_log.committed = state.commit
        self.term = state.term
        self.vote = state.vote

    # -- timers --------------------------------------------------------------

    def is_election_timeout(self) -> bool:
        """True when elapsed exceeds a randomized point in
        (election_timeout, 2*election_timeout - 1) — reference raft.go:765-771,
        with math/rand replaced by the kernel-mirrorable xorshift32 stream."""
        d = self.elapsed - self.election_timeout
        if d < 0:
            return False
        self._prng = xorshift32(self._prng)
        return d > self._prng % self.election_timeout
