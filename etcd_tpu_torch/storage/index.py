"""In-memory revision index: key → generations of revisions.

Behavioral equivalent of reference storage/{index,key_index}.go: each key
holds a list of *generations* — one life of the key from creation to
tombstone; `get(at_rev)` walks the generation alive at `at_rev` for the
last revision ≤ at_rev; `tombstone` closes the current generation;
`compact(at_rev)` drops revisions ≤ at_rev, keeping the one revision each
surviving key needs to answer reads at the compaction boundary
(key_index.go:69-110); a fully-compacted-away key leaves the index.

The reference keeps keys in a google/btree; the ordered structure here is a
plain dict plus a bisect-maintained sorted key list — same O(log n)
seek + linear scan for ranges.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Set, Tuple

from etcd_tpu_torch.storage.revision import Revision


class RevisionNotFoundError(Exception):
    pass


class Generation:
    __slots__ = ("ver", "created", "revs")

    def __init__(self) -> None:
        self.ver = 0                      # total puts in this generation
        self.created: Optional[Revision] = None   # first rev, survives compact
        self.revs: List[Revision] = []

    @property
    def empty(self) -> bool:
        return not self.revs


class KeyIndex:
    __slots__ = ("key", "mod_rev", "generations")

    def __init__(self, key: bytes) -> None:
        self.key = key
        self.mod_rev = 0
        self.generations: List[Generation] = []

    def put(self, main: int, sub: int) -> None:
        if main < self.mod_rev:
            raise ValueError(
                f"put with smaller revision {main} < {self.mod_rev}")
        if not self.generations:
            self.generations.append(Generation())
        g = self.generations[-1]
        if g.created is None:
            g.created = Revision(main, sub)
        g.revs.append(Revision(main, sub))
        g.ver += 1
        self.mod_rev = main

    def tombstone(self, main: int, sub: int) -> None:
        if self.empty:
            raise ValueError("tombstone on empty keyIndex")
        self.put(main, sub)
        self.generations.append(Generation())

    def get(self, at_rev: int) -> Tuple[Revision, Revision, int]:
        """Returns (rev, created_rev, version) of the key at at_rev
        (reference key_index.go get; created/version extend it for
        KeyValue metadata)."""
        g = self._find_generation(at_rev)
        if g is None or g.empty:
            raise RevisionNotFoundError(self.key)
        # last revision with main <= at_rev
        n = -1
        for i, r in enumerate(g.revs):
            if r.main > at_rev:
                break
            n = i
        if n == -1:
            raise RevisionNotFoundError(self.key)
        # version counts from the generation's birth; compaction may have
        # truncated the front of revs, so derive it from the running total
        # (g.ver) rather than the list position.
        version = g.ver - (len(g.revs) - 1 - n)
        return g.revs[n], g.created or g.revs[0], version

    def live_meta(self) -> Optional[Tuple[Revision, int]]:
        """(created, version) of the OPEN generation — i.e. the key as it
        exists now, including same-transaction puts; None when the key is
        absent or its latest generation was closed by a tombstone. This is
        what a put must consult for create_rev/version: a key re-created
        after a delete starts a fresh generation at version 1."""
        if not self.generations:
            return None
        g = self.generations[-1]
        if g.empty or g.created is None:
            return None
        return g.created, g.ver

    @property
    def empty(self) -> bool:
        return (len(self.generations) == 0 or
                (len(self.generations) == 1 and self.generations[0].empty))

    def _find_generation(self, rev: int,
                         include_dead: bool = False) -> Optional[Generation]:
        """Generation alive at `rev` (reference key_index.go findGeneration):
        a non-last generation whose tombstone ≤ rev means the key is DEAD at
        rev — reads must not surface it. `include_dead` keeps the old raw
        walk for compact(), which must still locate dead generations in
        order to drop them."""
        last = len(self.generations) - 1
        for i in range(last, -1, -1):
            g = self.generations[i]
            if g.empty:
                continue
            if not include_dead and i != last and g.revs[-1].main <= rev:
                return None
            if g.revs[0].main <= rev:
                return g
        return None

    def compact(self, at_rev: int, available: Set[Revision]) -> None:
        """Drop revisions ≤ at_rev (reference key_index.go compact)."""
        g = self._find_generation(at_rev, include_dead=True)
        if g is None:
            return
        gi = self.generations.index(g)
        if not g.empty:
            # Keep only the NEWEST revision ≤ at_rev — the one future reads
            # above the boundary may still need (reference key_index.go
            # compact walks descending, so f fires once).
            n = -1
            for i, r in enumerate(g.revs):
                if r.main <= at_rev:
                    n = i
                else:
                    break
            if n != -1:
                available.add(g.revs[n])
                g.revs = g.revs[n:]
            # a generation reduced to its tombstone (and not the live one)
            # is dead entirely
            if len(g.revs) == 1 and gi != len(self.generations) - 1:
                available.discard(g.revs[0])
                gi += 1
        self.generations = self.generations[gi:]


class TreeIndex:
    """Ordered key → KeyIndex map (reference storage/index.go treeIndex)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._map: Dict[bytes, KeyIndex] = {}
        self._sorted: List[bytes] = []

    def put(self, key: bytes, rev: Revision) -> None:
        with self._lock:
            ki = self._map.get(key)
            if ki is None:
                ki = KeyIndex(key)
                self._map[key] = ki
                bisect.insort(self._sorted, key)
            ki.put(rev.main, rev.sub)

    def tombstone(self, key: bytes, rev: Revision) -> None:
        with self._lock:
            ki = self._map.get(key)
            if ki is None:
                raise RevisionNotFoundError(key)
            ki.tombstone(rev.main, rev.sub)

    def get(self, key: bytes, at_rev: int) -> Tuple[Revision, Revision, int]:
        with self._lock:
            ki = self._map.get(key)
            if ki is None:
                raise RevisionNotFoundError(key)
            return ki.get(at_rev)

    def live_meta(self, key: bytes) -> Optional[Tuple[Revision, int]]:
        with self._lock:
            ki = self._map.get(key)
            if ki is None:
                return None
            return ki.live_meta()

    def range(self, key: bytes, end: Optional[bytes], at_rev: int
              ) -> Tuple[List[bytes], List[Revision]]:
        """end None → point lookup; end b"\\x00" → every key >= `key` (the
        etcd whole-keyspace sentinel); else half-open [key, end)
        (reference index.go Range + etcd's RangeEnd convention)."""
        with self._lock:
            if end is None:
                try:
                    rev, _, _ = self.get(key, at_rev)
                except RevisionNotFoundError:
                    return [], []
                return [key], [rev]
            unbounded = end == b"\x00"
            keys: List[bytes] = []
            revs: List[Revision] = []
            i = bisect.bisect_left(self._sorted, key)
            while i < len(self._sorted) and (unbounded
                                             or self._sorted[i] < end):
                k = self._sorted[i]
                try:
                    rev, _, _ = self._map[k].get(at_rev)
                except RevisionNotFoundError:
                    i += 1
                    continue
                keys.append(k)
                revs.append(rev)
                i += 1
            return keys, revs

    def compact(self, rev: int) -> Set[Revision]:
        """Returns the set of revisions ≤ rev that must be KEPT in the
        backend (reference index.go Compact)."""
        available: Set[Revision] = set()
        with self._lock:
            dead: List[bytes] = []
            for k in self._sorted:
                ki = self._map[k]
                ki.compact(rev, available)
                if ki.empty:
                    dead.append(k)
            if dead:
                for k in dead:
                    del self._map[k]
                # one O(n) rebuild instead of per-key O(n) removes
                self._sorted = [k for k in self._sorted if k in self._map]
        return available

    def equal(self, other: "TreeIndex") -> bool:
        with self._lock:
            return self._sorted == other._sorted
