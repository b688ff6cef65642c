"""WAL + Snapshotter composite (reference etcdserver/storage.go:34-132).

Save = WAL append+fsync of {HardState, Entries}. SaveSnap = snapshot file +
WAL snapshot marker + release of obsolete WAL locks, in that order. read_wal
replays with ONE auto-repair attempt on a torn tail (reference
storage.go:75-107).
"""
from __future__ import annotations

import os
from typing import List, Tuple

from etcd_tpu_torch import raftpb
from etcd_tpu_torch.raftpb import Entry, HardState, Snapshot
from etcd_tpu_torch.snap import Snapshotter
from etcd_tpu_torch.wal import WAL, UnexpectedEOF, WalSnapshot
from etcd_tpu_torch.wal import wal as wal_mod


class ServerStorage:
    def __init__(self, w: WAL, ss: Snapshotter) -> None:
        self.wal = w
        self.snapshotter = ss

    def save(self, st: HardState, ents: List[Entry]) -> None:
        self.wal.save(st, ents)

    def save_snap(self, snap: Snapshot) -> None:
        """Durable snapshot: WAL marker first (so replay knows the horizon),
        then the snapshot file, then unlock superseded segments (reference
        storage.go:55-73)."""
        ws = WalSnapshot(index=snap.metadata.index, term=snap.metadata.term)
        self.wal.save_snapshot(ws)
        self.snapshotter.save_snap(snap)
        self.wal.release_lock_to(snap.metadata.index)

    def close(self) -> None:
        self.wal.close()


def read_wal(waldir: str, snap: WalSnapshot,
             segment_size: int = wal_mod.SEGMENT_SIZE_BYTES
             ) -> Tuple[WAL, bytes, HardState, List[Entry]]:
    """Open + replay the WAL from `snap`, auto-repairing a torn tail once
    (reference storage.go:75-107 readWAL)."""
    repaired = False
    while True:
        w = WAL.open(waldir, snap, segment_size=segment_size)
        try:
            metadata, st, ents = w.read_all()
            return w, metadata, st, ents
        except UnexpectedEOF:
            w.close()
            if repaired or not wal_mod.repair(waldir):
                raise
            repaired = True
