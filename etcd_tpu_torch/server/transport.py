"""Peer-transport seam (reference rafthttp.Transporter / rafthttp.Raft
interface pair, rafthttp/transport.go:29-70).

The server speaks to peers only through `Transporter.send`; inbound messages
arrive via `RaftHandler.process`. This module ships the in-memory
implementation used by tests and single-host multi-member deployments —
non-blocking sends with drop-on-full + unreachable reporting, plus the
pause/drop/isolate fault knobs of the reference test doubles
(rafthttp/transport.go:235-249 Pausable, raft_test.go network fixture). The
HTTP implementation lives in etcd_tpu/transport/.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from etcd_tpu_torch.raftpb import Message, MessageType


class Transporter:
    """What the server core needs from any peer transport."""

    def send(self, msgs: Iterable[Message]) -> None:
        raise NotImplementedError

    def add_peer(self, mid: int, urls: Iterable[str]) -> None:
        pass

    def remove_peer(self, mid: int) -> None:
        pass

    def update_peer(self, mid: int, urls: Iterable[str]) -> None:
        pass

    def member_version(self, mid: int, peer_urls: Iterable[str]
                       ) -> Optional[str]:
        """The member's server version for cluster-version negotiation
        (reference getVersions cluster_util.go:118-137), or None when
        unreachable/unsupported."""
        return None

    def stop(self) -> None:
        pass


class InMemoryNetwork:
    """A hub connecting InMemoryTransports by member id, with fault
    injection: drop rates per edge, isolation, pausing."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._inboxes: Dict[int, "queue.Queue[Message]"] = {}
        self._dropped: Set[Tuple[int, int]] = set()   # (frm, to) edges cut
        self._isolated: Set[int] = set()
        self.delivered = 0
        self.dropped_count = 0

    def register(self, mid: int, inbox: "queue.Queue[Message]") -> None:
        with self._lock:
            self._inboxes[mid] = inbox

    def unregister(self, mid: int) -> None:
        with self._lock:
            self._inboxes.pop(mid, None)

    # -- fault knobs (reference rafttest/network.go, raft_test.go:1760-1837) --

    def cut(self, a: int, b: int) -> None:
        with self._lock:
            self._dropped.add((a, b))
            self._dropped.add((b, a))

    def heal(self, a: int = None, b: int = None) -> None:
        with self._lock:
            if a is None:
                self._dropped.clear()
                self._isolated.clear()
            else:
                self._dropped.discard((a, b))
                self._dropped.discard((b, a))

    def isolate(self, mid: int) -> None:
        with self._lock:
            self._isolated.add(mid)

    def unisolate(self, mid: int) -> None:
        with self._lock:
            self._isolated.discard(mid)

    def deliver(self, m: Message) -> bool:
        with self._lock:
            if (m.frm, m.to) in self._dropped:
                self.dropped_count += 1
                return False
            if m.frm in self._isolated or m.to in self._isolated:
                self.dropped_count += 1
                return False
            inbox = self._inboxes.get(m.to)
        if inbox is None:
            return False
        try:
            inbox.put_nowait(m)
        except queue.Full:
            self.dropped_count += 1
            return False
        self.delivered += 1
        return True


class InMemoryTransport(Transporter):
    """Per-member transport over an InMemoryNetwork. Mirrors rafthttp's
    liveness contract: sends never block; a failed send to a known peer
    reports unreachability back into the consensus core (reference
    rafthttp/peer.go:156-165)."""

    def __init__(self, net: InMemoryNetwork, mid: int,
                 report_unreachable: Optional[Callable[[int], None]] = None,
                 report_snapshot: Optional[Callable[[int, bool], None]] = None
                 ) -> None:
        self.net = net
        self.id = mid
        self._peers: Set[int] = set()
        self._paused = False
        self.report_unreachable = report_unreachable
        self.report_snapshot = report_snapshot

    def send(self, msgs: Iterable[Message]) -> None:
        for m in msgs:
            if m.to == 0 or self._paused:
                continue
            ok = self.net.deliver(m)
            is_snap = m.type == MessageType.SNAP
            if not ok:
                if self.report_unreachable is not None:
                    self.report_unreachable(m.to)
                if is_snap and self.report_snapshot is not None:
                    self.report_snapshot(m.to, False)
            elif is_snap and self.report_snapshot is not None:
                self.report_snapshot(m.to, True)

    def member_version(self, mid: int, peer_urls: Iterable[str]
                       ) -> Optional[str]:
        # All members of an in-memory cluster are this process: same code,
        # same version — reachable iff registered.
        if mid in self.net._inboxes:
            from etcd_tpu_torch import version as ver
            return ver.VERSION
        return None

    # Pausable (reference transport.go:235-249).
    def pause(self) -> None:
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def stop(self) -> None:
        self.net.unregister(self.id)
