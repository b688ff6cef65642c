"""Stable-log storage interface used by the consensus core.

Behavioral equivalent of reference raft/storage.go:40-249: a read-only view of
the persisted log (InitialState/Entries/Term/LastIndex/FirstIndex/Snapshot)
plus the in-memory implementation with Append/Compact/CreateSnapshot/
ApplySnapshot and the Compacted/SnapOutOfDate/Unavailable sentinels.

In the TPU framework the host keeps one MemoryStorage-equivalent *window* per
group (entries beyond the on-device term window spill here), so this module is
deliberately free of any device concern.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

from etcd_tpu_torch import raftpb
from etcd_tpu_torch.raftpb import ConfState, Entry, HardState, Snapshot, SnapshotMetadata


class CompactedError(Exception):
    """Requested index predates the last snapshot/compaction."""


class SnapOutOfDateError(Exception):
    """Requested snapshot index is older than the existing snapshot."""


class UnavailableError(Exception):
    """Requested entries are not yet available in storage."""


class Storage:
    """Read interface the core uses for the stable portion of the log."""

    def initial_state(self) -> Tuple[HardState, ConfState]:
        raise NotImplementedError

    def entries(self, lo: int, hi: int, max_size: int = raftpb.NO_LIMIT) -> Tuple[Entry, ...]:
        raise NotImplementedError

    def term(self, i: int) -> int:
        raise NotImplementedError

    def last_index(self) -> int:
        raise NotImplementedError

    def first_index(self) -> int:
        raise NotImplementedError

    def snapshot(self) -> Snapshot:
        raise NotImplementedError


class MemoryStorage(Storage):
    """In-RAM log window backed by a list, with a dummy entry at offset 0
    holding the term of the last compacted index (so ents[0].index is the
    compaction watermark, mirroring the reference's layout invariant)."""

    def __init__(self, entries: Sequence[Entry] = (),
                 hard_state: HardState = HardState(),
                 snapshot: Snapshot = Snapshot()) -> None:
        self._mu = threading.Lock()
        self._hard_state = hard_state
        self._snapshot = snapshot
        self._ents: List[Entry] = [Entry(term=snapshot.metadata.term,
                                         index=snapshot.metadata.index)]
        self._ents.extend(entries)

    # -- Storage interface ---------------------------------------------------

    def initial_state(self) -> Tuple[HardState, ConfState]:
        with self._mu:
            return self._hard_state, self._snapshot.metadata.conf_state

    def set_hard_state(self, hs: HardState) -> None:
        with self._mu:
            self._hard_state = hs

    def entries(self, lo: int, hi: int, max_size: int = raftpb.NO_LIMIT) -> Tuple[Entry, ...]:
        with self._mu:
            offset = self._ents[0].index
            if lo <= offset:
                raise CompactedError(lo)
            if hi > self._last_index() + 1:
                raise ValueError(f"entries hi {hi} out of bound {self._last_index()}")
            if len(self._ents) == 1:  # only the dummy entry
                raise UnavailableError(lo)
            ents = self._ents[lo - offset:hi - offset]
            return raftpb.limit_size(ents, max_size)

    def term(self, i: int) -> int:
        with self._mu:
            offset = self._ents[0].index
            if i < offset:
                raise CompactedError(i)
            if i - offset >= len(self._ents):
                raise UnavailableError(i)
            return self._ents[i - offset].term

    def last_index(self) -> int:
        with self._mu:
            return self._last_index()

    def _last_index(self) -> int:
        return self._ents[0].index + len(self._ents) - 1

    def first_index(self) -> int:
        with self._mu:
            return self._ents[0].index + 1

    def snapshot(self) -> Snapshot:
        with self._mu:
            return self._snapshot

    # -- Write side ----------------------------------------------------------

    def apply_snapshot(self, snap: Snapshot) -> None:
        with self._mu:
            if self._snapshot.metadata.index >= snap.metadata.index:
                raise SnapOutOfDateError(snap.metadata.index)
            self._snapshot = snap
            self._ents = [Entry(term=snap.metadata.term, index=snap.metadata.index)]

    def create_snapshot(self, i: int, cs: Optional[ConfState], data: bytes) -> Snapshot:
        with self._mu:
            if i <= self._snapshot.metadata.index:
                raise SnapOutOfDateError(i)
            offset = self._ents[0].index
            if i > self._last_index():
                raise ValueError(f"snapshot {i} past last index {self._last_index()}")
            md = SnapshotMetadata(
                index=i,
                term=self._ents[i - offset].term,
                conf_state=cs if cs is not None else self._snapshot.metadata.conf_state,
            )
            self._snapshot = Snapshot(data=data, metadata=md)
            return self._snapshot

    def compact(self, compact_index: int) -> None:
        """Discard entries <= compact_index; the app must ensure it does not
        compact past applied."""
        with self._mu:
            offset = self._ents[0].index
            if compact_index <= offset:
                raise CompactedError(compact_index)
            if compact_index > self._last_index():
                raise ValueError(
                    f"compact {compact_index} out of bound {self._last_index()}")
            # New dummy entry carries the term at the compaction watermark.
            i = compact_index - offset
            self._ents = ([Entry(index=self._ents[i].index, term=self._ents[i].term)]
                          + self._ents[i + 1:])

    def append(self, entries: Sequence[Entry]) -> None:
        if not entries:
            return
        with self._mu:
            first = self._ents[0].index + 1
            last = entries[0].index + len(entries) - 1
            if last < first:
                return  # entirely compacted away
            if first > entries[0].index:
                entries = entries[first - entries[0].index:]
            offset = entries[0].index - self._ents[0].index
            if offset > len(self._ents):
                raise ValueError(f"missing log entry [last: {self._last_index()}, "
                                 f"append at: {entries[0].index}]")
            # Truncate any conflicting suffix, then append.
            self._ents = self._ents[:offset]
            self._ents.extend(entries)
