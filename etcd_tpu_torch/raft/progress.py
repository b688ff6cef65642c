"""Per-follower replication flow control.

Behavioral equivalent of reference raft/progress.go:19-237: the
Probe/Replicate/Snapshot state machine, optimistic next-index, pause/resume,
and the in-flight append window. In the batched kernel these fields live as
dense (groups, peers) integer/boolean arrays (see etcd_tpu/ops/state.py);
values of ProgressState are shared between both representations.
"""
from __future__ import annotations

import enum
from typing import List


class ProgressState(enum.IntEnum):
    PROBE = 0      # send at most one append, await response (unsure of match)
    REPLICATE = 1  # optimistic pipeline, window-limited
    SNAPSHOT = 2   # follower needs a snapshot; appends paused


class Inflights:
    """Sliding window of in-flight append last-indices (reference
    progress.go:172-237). Bounded ring; `full` pauses replication."""

    def __init__(self, size: int) -> None:
        self.size = size
        self.buffer: List[int] = []

    def add(self, inflight: int) -> None:
        if self.full():
            raise RuntimeError("cannot add into a full inflights")
        self.buffer.append(inflight)

    def free_to(self, to: int) -> None:
        """Frees inflights <= to (acked by the follower)."""
        i = 0
        while i < len(self.buffer) and self.buffer[i] <= to:
            i += 1
        if i:
            del self.buffer[:i]

    def free_first_one(self) -> None:
        if self.buffer:
            del self.buffer[:1]

    def full(self) -> bool:
        return len(self.buffer) >= self.size

    def count(self) -> int:
        return len(self.buffer)

    def reset(self) -> None:
        self.buffer.clear()


class Progress:
    def __init__(self, next: int = 0, match: int = 0,
                 inflight_size: int = 256) -> None:
        self.match = match
        self.next = next
        self.state = ProgressState.PROBE
        self.paused = False                 # probe sent, awaiting response
        self.pending_snapshot = 0           # index of in-flight snapshot
        self.ins = Inflights(inflight_size)

    def __repr__(self) -> str:
        return (f"Progress(next={self.next}, match={self.match}, "
                f"state={self.state.name}, paused={self.paused}, "
                f"pending_snapshot={self.pending_snapshot})")

    def _reset_state(self, state: ProgressState) -> None:
        self.paused = False
        self.pending_snapshot = 0
        self.state = state
        self.ins.reset()

    def become_probe(self) -> None:
        # Leaving snapshot state: the follower has at least the snapshot's
        # entries, so probe from there (reference progress.go:76-87).
        if self.state == ProgressState.SNAPSHOT:
            pending = self.pending_snapshot
            self._reset_state(ProgressState.PROBE)
            self.next = max(self.match + 1, pending + 1)
        else:
            self._reset_state(ProgressState.PROBE)
            self.next = self.match + 1

    def become_replicate(self) -> None:
        self._reset_state(ProgressState.REPLICATE)
        self.next = self.match + 1

    def become_snapshot(self, snapshot_index: int) -> None:
        self._reset_state(ProgressState.SNAPSHOT)
        self.pending_snapshot = snapshot_index

    def maybe_update(self, n: int) -> bool:
        """A successful MsgAppResp at index n (reference progress.go:102-113).
        Returns True if match advanced."""
        updated = False
        if self.match < n:
            self.match = n
            updated = True
            self.resume()
        if self.next < n + 1:
            self.next = n + 1
        return updated

    def optimistic_update(self, n: int) -> None:
        self.next = n + 1

    def maybe_decr_to(self, rejected: int, last: int) -> bool:
        """A rejected MsgAppResp; back off next (reference progress.go:119-141).
        Returns False if the rejection is stale."""
        if self.state == ProgressState.REPLICATE:
            # Directly decrease next to match + 1.
            if rejected <= self.match:
                return False
            self.next = self.match + 1
            return True
        # Probe: the rejection must be for our outstanding probe at next-1.
        if self.next - 1 != rejected:
            return False
        self.next = min(rejected, last + 1)
        if self.next < 1:
            self.next = 1
        self.resume()
        return True

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def is_paused(self) -> bool:
        """Whether the leader should hold off sending appends (reference
        progress.go:147-158)."""
        if self.state == ProgressState.PROBE:
            return self.paused
        if self.state == ProgressState.REPLICATE:
            return self.ins.full()
        return True  # SNAPSHOT

    def snapshot_failure(self) -> None:
        self.pending_snapshot = 0

    def need_snapshot_abort(self) -> bool:
        """Snapshot no longer needed once match covers it (reference
        progress.go:163-167)."""
        return (self.state == ProgressState.SNAPSHOT
                and self.match >= self.pending_snapshot)
