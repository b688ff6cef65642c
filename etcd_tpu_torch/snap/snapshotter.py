"""Snapshot files: the durable state-machine checkpoints.

Behavioral equivalent of reference snap/snapshotter.go:59-180: one file per
snapshot named %016x-%016x.snap (term-index, so lexical order == logical
order), payload wrapped in a CRC envelope (reference snappb), Load() walks
newest-first and quarantines unreadable files by renaming them .broken.

File layout (little-endian): crc:u32 len:u64 body[len], where body is the
raftpb snapshot encoding (etcd_tpu/raftpb.py encode_snapshot).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

import time

from etcd_tpu_torch import raftpb
from etcd_tpu_torch.raftpb import Snapshot
from etcd_tpu_torch.utils import fileutil, metrics

_ENVELOPE = struct.Struct("<IQ")  # crc, len


class NoSnapshotError(Exception):
    """No usable snapshot file found (reference ErrNoSnapshot)."""


def snap_name(term: int, index: int) -> str:
    return f"{term:016x}-{index:016x}.snap"


def parse_snap_name(name: str) -> Tuple[int, int]:
    if not name.endswith(".snap"):
        raise ValueError(f"bad snapshot name {name!r}")
    term_s, _, idx_s = name[:-5].partition("-")
    return int(term_s, 16), int(idx_s, 16)


class Snapshotter:
    def __init__(self, dirname: str) -> None:
        self.dir = dirname
        fileutil.touch_dir_all(dirname)

    def save_snap(self, snapshot: Snapshot) -> None:
        """Persist one snapshot durably: tmp write + rename + dir fsync
        (reference snapshotter.go:59-82)."""
        if snapshot.is_empty():
            return
        t0 = time.perf_counter()
        try:
            self._save(snapshot)
        finally:
            metrics.snap_save_durations.observe(
                (time.perf_counter() - t0) * 1e6)

    def _save(self, snapshot: Snapshot) -> None:
        md = snapshot.metadata
        name = snap_name(md.term, md.index)
        body = raftpb.encode_snapshot(snapshot)
        crc = zlib.crc32(body)
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "wb") as f:
            os.fchmod(f.fileno(), fileutil.PRIVATE_FILE_MODE)
            f.write(_ENVELOPE.pack(crc, len(body)))
            f.write(body)
            f.flush()
            fileutil.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.dir, name))
        fileutil.fsync_dir(self.dir)

    def load(self) -> Snapshot:
        """Newest loadable snapshot; corrupt files are renamed .broken and
        skipped (reference snapshotter.go:84-143,175-180)."""
        for name in self.snap_names():
            snap = self._read(name)
            if snap is not None:
                return snap
        raise NoSnapshotError(f"no usable snapshot in {self.dir}")

    def load_or_none(self) -> Optional[Snapshot]:
        try:
            return self.load()
        except NoSnapshotError:
            return None

    def snap_names(self) -> List[str]:
        """Valid .snap file names, newest first."""
        names = []
        for n in fileutil.read_dir(self.dir):
            if n.endswith(".snap"):
                try:
                    parse_snap_name(n)
                except ValueError:
                    continue
                names.append(n)
        # Sort by (index, term) so the newest log position wins even across
        # term changes; hex zero-padding makes this a numeric order.
        names.sort(key=lambda n: (parse_snap_name(n)[1], parse_snap_name(n)[0]),
                   reverse=True)
        return names

    def _read(self, name: str) -> Optional[Snapshot]:
        path = os.path.join(self.dir, name)
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                hdr = f.read(_ENVELOPE.size)
                crc, n = _ENVELOPE.unpack(hdr)
                if n > size - _ENVELOPE.size:
                    raise ValueError("length field exceeds file size")
                body = f.read(n)
                if len(body) != n or zlib.crc32(body) != crc:
                    raise ValueError("crc/length mismatch")
                snap, _ = raftpb.decode_snapshot(body)
                if snap.is_empty():
                    raise ValueError("empty snapshot body")
                return snap
        except (OSError, ValueError, struct.error):
            self._quarantine(path)
            return None

    @staticmethod
    def _quarantine(path: str) -> None:
        try:
            os.rename(path, path + ".broken")
        except OSError:
            pass
