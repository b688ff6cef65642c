"""The raft log: committed/applied cursors over a merged view of the unstable
in-memory tail and the stable Storage.

Behavioral equivalent of reference raft/log.go:24-301 and
raft/log_unstable.go:23-137: maybe_append with conflict detection and
truncation, next_ents (committed-but-unapplied window), stable_to cursors,
bounded slice reads. The batched TPU kernel mirrors a fixed-width window of
this structure on device (term ring per group); this host copy is the source
of truth and the oracle for kernel equivalence tests.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from etcd_tpu_torch import raftpb
from etcd_tpu_torch.raftpb import Entry, Snapshot
from etcd_tpu_torch.raft.storage import (CompactedError, Storage, UnavailableError)


class Unstable:
    """The not-yet-persisted tail: maybe a snapshot being installed, plus
    entries starting at `offset` (all with index >= offset)."""

    def __init__(self, offset: int) -> None:
        self.snapshot: Optional[Snapshot] = None
        self.entries: List[Entry] = []
        self.offset = offset

    def maybe_first_index(self) -> Optional[int]:
        if self.snapshot is not None:
            return self.snapshot.metadata.index + 1
        return None

    def maybe_last_index(self) -> Optional[int]:
        if self.entries:
            return self.offset + len(self.entries) - 1
        if self.snapshot is not None:
            return self.snapshot.metadata.index
        return None

    def maybe_term(self, i: int) -> Optional[int]:
        if i < self.offset:
            if (self.snapshot is not None
                    and self.snapshot.metadata.index == i):
                return self.snapshot.metadata.term
            return None
        last = self.maybe_last_index()
        if last is None or i > last:
            return None
        return self.entries[i - self.offset].term

    def stable_to(self, i: int, t: int) -> None:
        gt = self.maybe_term(i)
        if gt is None:
            return
        # Only shrink if the persisted (i, term) still matches our unstable
        # tail — a conflicting truncate may have replaced it.
        if gt == t and i >= self.offset:
            self.entries = self.entries[i + 1 - self.offset:]
            self.offset = i + 1

    def stable_snap_to(self, i: int) -> None:
        if self.snapshot is not None and self.snapshot.metadata.index == i:
            self.snapshot = None

    def restore(self, s: Snapshot) -> None:
        self.offset = s.metadata.index + 1
        self.entries = []
        self.snapshot = s

    def truncate_and_append(self, ents: Sequence[Entry]) -> None:
        after = ents[0].index
        if after == self.offset + len(self.entries):
            self.entries.extend(ents)
        elif after <= self.offset:
            # Replace the whole unstable tail.
            self.offset = after
            self.entries = list(ents)
        else:
            # Truncate to after-1, then append.
            self.entries = self.entries[:after - self.offset]
            self.entries.extend(ents)

    def slice(self, lo: int, hi: int) -> List[Entry]:
        self._check_out_of_bounds(lo, hi)
        return self.entries[lo - self.offset:hi - self.offset]

    def _check_out_of_bounds(self, lo: int, hi: int) -> None:
        if lo > hi:
            raise ValueError(f"invalid unstable slice {lo} > {hi}")
        upper = self.offset + len(self.entries)
        if lo < self.offset or hi > upper:
            raise ValueError(
                f"unstable slice[{lo},{hi}) out of bound [{self.offset},{upper}]")


class RaftLog:
    def __init__(self, storage: Storage) -> None:
        self.storage = storage
        first = storage.first_index()
        last = storage.last_index()
        self.unstable = Unstable(offset=last + 1)
        self.committed = first - 1
        self.applied = first - 1

    def __repr__(self) -> str:
        return (f"RaftLog(committed={self.committed}, applied={self.applied}, "
                f"unstable.offset={self.unstable.offset}, "
                f"len(unstable)={len(self.unstable.entries)})")

    # -- append path ---------------------------------------------------------

    def maybe_append(self, index: int, log_term: int, committed: int,
                     ents: Sequence[Entry]) -> Optional[int]:
        """Follower append rule: if (index, log_term) matches our log, resolve
        conflicts, append what's new, and advance commit. Returns the index of
        the last new entry, or None on mismatch (reference log.go:72-96)."""
        if not self.match_term(index, log_term):
            return None
        lastnewi = index + len(ents)
        ci = self.find_conflict(ents)
        if ci == 0:
            pass  # no new entries, all duplicates
        elif ci <= self.committed:
            raise RuntimeError(
                f"entry {ci} conflicts with committed entry [committed="
                f"{self.committed}]")
        else:
            offset = index + 1
            self.append(ents[ci - offset:])
        self.commit_to(min(committed, lastnewi))
        return lastnewi

    def append(self, ents: Sequence[Entry]) -> int:
        if not ents:
            return self.last_index()
        after = ents[0].index - 1
        if after < self.committed:
            raise RuntimeError(
                f"after({after}) is out of range [committed({self.committed})]")
        self.unstable.truncate_and_append(ents)
        return self.last_index()

    def find_conflict(self, ents: Sequence[Entry]) -> int:
        """First index whose term mismatches ours (0 if none conflict and none
        are new); reference log.go:98-123."""
        for e in ents:
            if not self.match_term(e.index, e.term):
                if e.index <= self.last_index():
                    pass  # conflict with existing entry — caller truncates
                return e.index
        return 0

    # -- read path -----------------------------------------------------------

    def unstable_entries(self) -> List[Entry]:
        return list(self.unstable.entries)

    def next_ents(self, max_size: int = raftpb.NO_LIMIT) -> List[Entry]:
        """Committed-but-unapplied entries (what the state machine applies
        next); reference log.go:135-141."""
        off = max(self.applied + 1, self.first_index())
        if self.committed + 1 > off:
            return list(self.slice(off, self.committed + 1, max_size))
        return []

    def has_next_ents(self) -> bool:
        off = max(self.applied + 1, self.first_index())
        return self.committed + 1 > off

    def snapshot(self) -> Snapshot:
        if self.unstable.snapshot is not None:
            return self.unstable.snapshot
        return self.storage.snapshot()

    def first_index(self) -> int:
        i = self.unstable.maybe_first_index()
        if i is not None:
            return i
        return self.storage.first_index()

    def last_index(self) -> int:
        i = self.unstable.maybe_last_index()
        if i is not None:
            return i
        return self.storage.last_index()

    # -- cursors -------------------------------------------------------------

    def commit_to(self, tocommit: int) -> None:
        if self.committed < tocommit:
            if self.last_index() < tocommit:
                raise RuntimeError(
                    f"tocommit({tocommit}) is out of range "
                    f"[lastIndex({self.last_index()})]")
            self.committed = tocommit

    def applied_to(self, i: int) -> None:
        if i == 0:
            return
        if self.committed < i or i < self.applied:
            raise RuntimeError(
                f"applied({i}) is out of range [prevApplied({self.applied}), "
                f"committed({self.committed})]")
        self.applied = i

    def stable_to(self, i: int, t: int) -> None:
        self.unstable.stable_to(i, t)

    def stable_snap_to(self, i: int) -> None:
        self.unstable.stable_snap_to(i)

    # -- terms ---------------------------------------------------------------

    def last_term(self) -> int:
        return self.term(self.last_index())

    def term(self, i: int) -> int:
        """Term of entry i; 0 if outside the valid window [dummy, last]
        (reference log.go term()); raises CompactedError if storage compacted
        it away mid-query."""
        dummy = self.first_index() - 1
        if i < dummy or i > self.last_index():
            return 0
        t = self.unstable.maybe_term(i)
        if t is not None:
            return t
        return self.storage.term(i)

    def term_or_zero(self, i: int) -> int:
        try:
            return self.term(i)
        except (CompactedError, UnavailableError):
            return 0

    def match_term(self, i: int, term: int) -> bool:
        try:
            return self.term(i) == term
        except (CompactedError, UnavailableError):
            return False

    def is_up_to_date(self, lasti: int, term: int) -> bool:
        """Vote rule: candidate's log is at least as up-to-date as ours
        (reference log.go:216-218; Raft paper §5.4.1)."""
        return term > self.last_term() or (
            term == self.last_term() and lasti >= self.last_index())

    def maybe_commit(self, max_index: int, term: int) -> bool:
        if max_index > self.committed and self.term_or_zero(max_index) == term:
            self.commit_to(max_index)
            return True
        return False

    # -- slices --------------------------------------------------------------

    def entries(self, i: int, max_size: int = raftpb.NO_LIMIT) -> List[Entry]:
        if i > self.last_index():
            return []
        return list(self.slice(i, self.last_index() + 1, max_size))

    def all_entries(self) -> List[Entry]:
        try:
            return self.entries(self.first_index())
        except CompactedError:
            return self.all_entries()  # racing compaction; retry

    def slice(self, lo: int, hi: int, max_size: int = raftpb.NO_LIMIT) -> Tuple[Entry, ...]:
        self._must_check_out_of_bounds(lo, hi)
        if lo == hi:
            return ()
        ents: List[Entry] = []
        if lo < self.unstable.offset:
            stored = self.storage.entries(lo, min(hi, self.unstable.offset), max_size)
            # Short read from storage means size limit hit — stop there.
            if len(stored) < min(hi, self.unstable.offset) - lo:
                return tuple(stored)
            ents.extend(stored)
        if hi > self.unstable.offset:
            ents.extend(self.unstable.slice(max(lo, self.unstable.offset), hi))
        return raftpb.limit_size(ents, max_size)

    def _must_check_out_of_bounds(self, lo: int, hi: int) -> None:
        if lo > hi:
            raise ValueError(f"invalid slice {lo} > {hi}")
        fi = self.first_index()
        if lo < fi:
            raise CompactedError(lo)
        if hi > self.last_index() + 1:
            raise ValueError(
                f"slice[{lo},{hi}) out of bound [{fi},{self.last_index()}]")

    def restore(self, s: Snapshot) -> None:
        self.committed = s.metadata.index
        self.unstable.restore(s)
