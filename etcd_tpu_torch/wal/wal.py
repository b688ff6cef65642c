"""Write-ahead log: segmented, CRC-chained, fsync-on-save.

Behavioral equivalent of the reference wal/ package (wal/wal.go:37-487,
wal/encoder.go, wal/decoder.go, wal/repair.go): record types
{METADATA, ENTRY, STATE, CRC, SNAPSHOT}, a rolling CRC carried across segment
cuts, 64MB segment rotation, exclusive flocks on live segments with
release-up-to retention, and a one-shot torn-tail repair. Re-designed for the
TPU framework's synchronous host loop: no goroutines — Save() is called from
the Ready-drain step BEFORE messages are sent (ordering contract, reference
raft/doc.go:31-39), and batches many groups' records per fsync.

Record framing (little-endian, fixed 16-byte header then payload):
    type:u32  crc:u32  len:u64  data[len]
crc is the rolling zlib.crc32 of every payload byte written to the log so
far INCLUDING this record's (seeded by the previous segment via the CRC
record) — a mid-file flip is detected at the first bad record, like the
reference's Castagnoli chain (wal/wal.go:60, walpb/record.go:23).
"""
from __future__ import annotations

import os
import struct
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

from etcd_tpu_torch import raftpb
from etcd_tpu_torch.raftpb import Entry, HardState, EMPTY_HARD_STATE
from etcd_tpu_torch.utils import fileutil, metrics

# Record types (reference wal/wal.go:37-42).
METADATA_TYPE = 1
ENTRY_TYPE = 2
STATE_TYPE = 3
CRC_TYPE = 4
SNAPSHOT_TYPE = 5

SEGMENT_SIZE_BYTES = 64 * 1024 * 1024  # reference wal/wal.go:49

_REC_HDR = struct.Struct("<IIQ")  # type, crc, len
_WAL_SNAP = struct.Struct("<QQ")  # index, term (reference walpb.Snapshot)


class CorruptError(Exception):
    """CRC mismatch or malformed record (reference ErrCRCMismatch)."""

    def __init__(self, path: str, offset: int, why: str) -> None:
        super().__init__(f"wal: corrupt record in {path} at {offset}: {why}")
        self.path = path
        self.offset = offset


class UnexpectedEOF(Exception):
    """Torn tail: the file ends inside a record."""

    def __init__(self, path: str, offset: int) -> None:
        super().__init__(f"wal: unexpected EOF in {path} at {offset}")
        self.path = path
        self.offset = offset


class SnapshotNotFoundError(Exception):
    """ReadAll did not see the snapshot record it was asked to start from
    (reference ErrSnapshotNotFound)."""


@dataclass(frozen=True)
class WalSnapshot:
    """Snapshot *marker* in the WAL (just index+term, not the payload —
    reference walpb.Record SNAPSHOT type)."""

    index: int = 0
    term: int = 0

    def encode(self) -> bytes:
        return _WAL_SNAP.pack(self.index, self.term)

    @staticmethod
    def decode(b: bytes) -> "WalSnapshot":
        i, t = _WAL_SNAP.unpack(b)
        return WalSnapshot(index=i, term=t)


def wal_name(seq: int, index: int) -> str:
    return f"{seq:016x}-{index:016x}.wal"


def parse_wal_name(name: str) -> Tuple[int, int]:
    if not name.endswith(".wal"):
        raise ValueError(f"bad wal name {name!r}")
    seq_s, _, idx_s = name[:-4].partition("-")
    return int(seq_s, 16), int(idx_s, 16)


def wal_exists(dirname: str) -> bool:
    if not os.path.isdir(dirname):
        return False
    return any(n.endswith(".wal") for n in os.listdir(dirname))


def _scan_names(dirname: str) -> List[str]:
    """Valid .wal names in the dir, sorted; skips unparseable strays
    (reference readWALNames) and verifies the seq chain is contiguous
    (reference wal.go searchIndex/isValidSeq)."""
    names = []
    for n in fileutil.read_dir(dirname):
        if not n.endswith(".wal"):
            continue
        try:
            parse_wal_name(n)
        except ValueError:
            continue  # stray file (editor backup etc.) — ignore
        names.append(n)
    last_seq = None
    for n in names:
        seq, _ = parse_wal_name(n)
        if last_seq is not None and seq != last_seq + 1:
            raise CorruptError(os.path.join(dirname, n), 0,
                               f"wal file seq gap ({last_seq} -> {seq})")
        last_seq = seq
    return names


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------

class _Encoder:
    def __init__(self, fobj, prev_crc: int) -> None:
        self.f = fobj
        self.crc = prev_crc

    def encode(self, rtype: int, data: bytes) -> None:
        # One call through the native codec when built (./build); the
        # Python fallback is byte-identical.
        from etcd_tpu_torch import native
        buf, self.crc = native.encode_records([(rtype, data)], self.crc)
        self.f.write(buf)

    def encode_crc_record(self) -> None:
        """Carry the rolling crc into a fresh segment: a CRC record's crc
        field IS the seed (it covers no payload bytes)."""
        self.f.write(_REC_HDR.pack(CRC_TYPE, self.crc, 0))

    def flush(self) -> None:
        self.f.flush()


@dataclass
class _Record:
    type: int
    crc: int
    data: bytes


class _Decoder:
    """Sequential record reader across segment files, verifying the crc
    chain (reference wal/decoder.go:46-74)."""

    def __init__(self, paths: List[str]) -> None:
        self.paths = paths
        self.fi = 0
        self.f = open(paths[0], "rb") if paths else None
        self.crc = 0
        self.nread = 0           # records consumed so far
        self.last_valid_off = 0  # within current file

    def close(self) -> None:
        if self.f:
            self.f.close()
            self.f = None

    @property
    def path(self) -> str:
        return self.paths[self.fi]

    def decode(self) -> Optional[_Record]:
        """Next record, or None at clean end of the last file. Raises
        UnexpectedEOF / CorruptError on torn or corrupt data."""
        if self.f is None:
            return None
        off = self.f.tell()
        hdr = self.f.read(_REC_HDR.size)
        if len(hdr) == 0:
            # Clean end of this file; move to the next.
            if self.fi + 1 < len(self.paths):
                self.f.close()
                self.fi += 1
                self.f = open(self.paths[self.fi], "rb")
                self.last_valid_off = 0
                return self.decode()
            return None
        if len(hdr) < _REC_HDR.size:
            raise UnexpectedEOF(self.path, off)
        rtype, crc, n = _REC_HDR.unpack(hdr)
        if rtype == 0:
            # A zeroed header is what a torn (pre-allocated / partially
            # synced) tail looks like — repairable, unlike real corruption.
            raise UnexpectedEOF(self.path, off)
        if rtype > SNAPSHOT_TYPE or n > (1 << 40):
            raise CorruptError(self.path, off, f"bad record header type={rtype}")
        data = self.f.read(n)
        if len(data) < n:
            raise UnexpectedEOF(self.path, off)
        if rtype == CRC_TYPE:
            # Segment-boundary seed. If we already consumed records, the seed
            # must CONTINUE the running chain (reference decoder.go checks
            # rec.Crc == d.crc) — a mismatch means a prior segment lost bytes.
            if self.nread > 0 and crc != self.crc:
                raise CorruptError(self.path, off, "crc chain broken")
            self.crc = crc
        else:
            self.crc = zlib.crc32(data, self.crc)
            if self.crc != crc:
                raise CorruptError(self.path, off, "crc mismatch")
        self.nread += 1
        self.last_valid_off = self.f.tell()
        return _Record(type=rtype, crc=crc, data=data)


# ---------------------------------------------------------------------------
# WAL
# ---------------------------------------------------------------------------

class WAL:
    """A durable, segmented record log. One instance per data dir; the live
    tail segment holds an exclusive flock."""

    def __init__(self, dirname: str, metadata: bytes,
                 segment_size: int = SEGMENT_SIZE_BYTES) -> None:
        self.dir = dirname
        self.metadata = metadata
        self.segment_size = segment_size
        self.start = WalSnapshot()
        self.state: HardState = EMPTY_HARD_STATE
        self.enti = 0                       # index of last entry saved
        self._locks: List[fileutil.LockedFile] = []  # oldest..newest
        self._names: List[str] = []
        self._enc: Optional[_Encoder] = None
        self._tail = None                    # append file object
        self.fsync_count = 0

    # -- lifecycle -----------------------------------------------------------

    @staticmethod
    def create(dirname: str, metadata: bytes = b"",
               segment_size: int = SEGMENT_SIZE_BYTES) -> "WAL":
        """Initialize a fresh WAL dir with segment 0-0 (reference
        wal.go:87-135: tmp dir + rename for atomicity)."""
        if wal_exists(dirname):
            raise FileExistsError(f"wal already exists in {dirname}")
        tmp = dirname.rstrip("/") + ".tmp"
        if os.path.isdir(tmp):
            import shutil
            shutil.rmtree(tmp)
        fileutil.create_dir_all(tmp)
        name = wal_name(0, 0)
        f = open(os.path.join(tmp, name), "wb")
        os.fchmod(f.fileno(), fileutil.PRIVATE_FILE_MODE)
        w = WAL(dirname, metadata, segment_size)
        w._tail = f
        w._enc = _Encoder(f, 0)
        w._enc.encode_crc_record()
        w._enc.encode(METADATA_TYPE, metadata)
        w._save_snapshot_record(WalSnapshot())
        w._names = [name]
        f.flush()
        fileutil.fsync(f.fileno())
        fileutil.fsync_dir(tmp)  # make the segment's dir entry durable
        os.rename(tmp, dirname)
        fileutil.fsync_dir(os.path.dirname(dirname.rstrip("/")) or ".")
        # Reopen at the final path and take the lock.
        f.close()
        w._tail = open(os.path.join(dirname, name), "r+b")
        w._tail.seek(0, os.SEEK_END)
        w._enc = _Encoder(w._tail, w._enc.crc)
        w._locks = [fileutil.LockedFile(os.path.join(dirname, name))]
        return w

    @staticmethod
    def open(dirname: str, snap: WalSnapshot = WalSnapshot(), *,
             write: bool = True,
             segment_size: int = SEGMENT_SIZE_BYTES) -> "WAL":
        """Open for reading from `snap` onward; with write=True, flock every
        segment from the one containing snap.index (reference
        wal.go:137-217 Open/OpenNotInUse/openAtIndex)."""
        names = _scan_names(dirname)
        if not names:
            raise FileNotFoundError(f"no wal files in {dirname}")
        # Last file whose first index <= snap.index; if even the oldest
        # segment starts past the snapshot, the region was purged (reference
        # wal.go searchIndex "file not found").
        if parse_wal_name(names[0])[1] > snap.index:
            raise FileNotFoundError(
                f"wal: segment covering index {snap.index} not found in "
                f"{dirname} (purged?)")
        namei = 0
        for i, n in enumerate(names):
            _, idx = parse_wal_name(n)
            if idx <= snap.index:
                namei = i
        names = names[namei:]
        w = WAL(dirname, b"", segment_size)
        w.start = snap
        w._names = names
        if write:
            try:
                for n in names:
                    w._locks.append(
                        fileutil.LockedFile(os.path.join(dirname, n)))
            except BaseException:
                for l in w._locks:
                    l.close()
                raise
        return w

    def close(self) -> None:
        if self._tail is not None:
            self._tail.flush()
            fileutil.fsync(self._tail.fileno())
            self._tail.close()
            self._tail = None
        for l in self._locks:
            l.close()
        self._locks = []

    def __enter__(self) -> "WAL":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- replay --------------------------------------------------------------

    def read_all(self) -> Tuple[bytes, HardState, List[Entry]]:
        """Replay records from the start snapshot marker: returns (metadata,
        last HardState, entries with index > snap.index). Raises
        UnexpectedEOF/CorruptError on a torn tail (caller may repair() once
        — reference etcdserver/storage.go:75-107) and SnapshotNotFoundError
        if the start marker never appears (reference wal.go:220-290)."""
        paths = [os.path.join(self.dir, n) for n in self._names]
        dec = _Decoder(paths)
        metadata = b""
        state = EMPTY_HARD_STATE
        ents: List[Entry] = []
        match = self.start.index == 0  # index 0 needs no marker
        try:
            while True:
                rec = dec.decode()
                if rec is None:
                    break
                if rec.type == ENTRY_TYPE:
                    e, _ = raftpb.decode_entry(rec.data)
                    if e.index > self.start.index:
                        # Overwrite semantics: a re-written index truncates
                        # the in-memory tail first (reference wal.go:239-243).
                        keep = e.index - self.start.index - 1
                        ents = ents[:keep]
                        ents.append(e)
                    self.enti = e.index
                elif rec.type == STATE_TYPE:
                    state = raftpb.decode_hard_state(rec.data)
                elif rec.type == METADATA_TYPE:
                    if metadata and rec.data != metadata:
                        raise CorruptError(dec.path, 0,
                                           "inconsistent metadata records")
                    metadata = rec.data
                elif rec.type == SNAPSHOT_TYPE:
                    s = WalSnapshot.decode(rec.data)
                    if s.index == self.start.index:
                        if s.term != self.start.term:
                            raise CorruptError(dec.path, 0,
                                               "snapshot term mismatch")
                        match = True
                # CRC records are consumed inside the decoder.
        finally:
            dec.close()
        if not match:
            raise SnapshotNotFoundError(
                f"wal: snapshot marker {self.start} not found")
        self.metadata = metadata
        self.state = state

        # Writable WAL: position the encoder at the end of the last segment.
        if self._locks and self._tail is None:
            last = os.path.join(self.dir, self._names[-1])
            self._tail = open(last, "r+b")
            self._tail.seek(0, os.SEEK_END)
            self._enc = _Encoder(self._tail, dec.crc)
        return metadata, state, ents

    # -- append --------------------------------------------------------------

    def _ensure_writable(self) -> None:
        if self._enc is None:
            raise RuntimeError("wal: not open for writing (call read_all "
                               "first on an opened WAL)")

    def save(self, st: HardState, ents: List[Entry]) -> None:
        """Append entries + state; fsync only when durability demands it —
        entries appended or term/vote changed. A commit-only HardState
        advance is recorded but NOT synced, since commit is recoverable
        (reference wal.go:459-487 Save + raft MustSync rule)."""
        self._ensure_writable()
        state_changed = not st.is_empty() and st != self.state
        if not ents and not state_changed:
            return
        must_sync = bool(ents) or (not st.is_empty() and
                                   (st.term != self.state.term or
                                    st.vote != self.state.vote))
        for e in ents:
            self._enc.encode(ENTRY_TYPE, raftpb.encode_entry(e))
            self.enti = e.index
        if state_changed:
            self._enc.encode(STATE_TYPE, raftpb.encode_hard_state(st))
            self.state = st
        self._enc.flush()
        if must_sync:
            t0 = time.perf_counter()
            fileutil.fsync(self._tail.fileno())
            metrics.wal_fsync_durations.observe(
                (time.perf_counter() - t0) * 1e6)
            self.fsync_count += 1
        if ents:
            metrics.wal_last_index_saved.set(self.enti)
        if self._tail.tell() >= self.segment_size:
            self._cut()

    def save_snapshot(self, snap: WalSnapshot) -> None:
        """Record a snapshot marker so future opens can skip earlier records
        (reference wal.go:443-457)."""
        self._ensure_writable()
        self._save_snapshot_record(snap)
        self._enc.flush()
        fileutil.fsync(self._tail.fileno())
        self.fsync_count += 1
        if self.start.index < snap.index:
            self.start = snap

    def _save_snapshot_record(self, snap: WalSnapshot) -> None:
        self._enc.encode(SNAPSHOT_TYPE, snap.encode())
        if self.enti < snap.index:
            self.enti = snap.index

    def _cut(self) -> None:
        """Close the current segment and open seq+1 starting at enti+1,
        re-seeding the crc chain and re-writing metadata+state so each
        segment is self-describing (reference wal.go:292-361)."""
        self._tail.flush()
        fileutil.fsync(self._tail.fileno())
        seq, _ = parse_wal_name(self._names[-1])
        name = wal_name(seq + 1, self.enti + 1)
        path = os.path.join(self.dir, name)
        f = open(path, "w+b")
        os.fchmod(f.fileno(), fileutil.PRIVATE_FILE_MODE)
        prev_crc = self._enc.crc
        self._tail.close()
        self._tail = f
        self._enc = _Encoder(f, prev_crc)
        self._enc.encode_crc_record()
        self._enc.encode(METADATA_TYPE, self.metadata)
        if not self.state.is_empty():
            self._enc.encode(STATE_TYPE, raftpb.encode_hard_state(self.state))
        self._enc.flush()
        fileutil.fsync(f.fileno())
        fileutil.fsync_dir(self.dir)
        self._names.append(name)
        self._locks.append(fileutil.LockedFile(path))

    # -- retention -----------------------------------------------------------

    def release_lock_to(self, index: int) -> None:
        """Unlock segments entirely below `index`, keeping the one that
        contains it — they become purgeable (reference wal.go:379-415)."""
        if not self._locks:
            return
        smaller = 0
        for i, n in enumerate(self._names):
            _, idx = parse_wal_name(n)
            if idx < index:
                smaller = i
        # Keep the segment containing `index` (the one before the first
        # segment whose start exceeds it).
        for l in self._locks[:smaller]:
            l.close()
        self._locks = self._locks[smaller:]
        self._names = self._names[smaller:]


def repair(dirname: str) -> bool:
    """One-shot torn-tail repair: decode until the error, truncate the bad
    file there (backing up the original as .broken). Repairable = a torn
    record (UnexpectedEOF) in the LAST file only; CRC corruption, and damage
    to any non-last segment, are not (reference wal/repair.go:29-94 repairs
    zero-length/torn tail records only) — truncating mid-chain would leave a
    silent index gap over committed entries."""
    names = _scan_names(dirname)
    if not names:
        return False
    paths = [os.path.join(dirname, n) for n in names]
    dec = _Decoder(paths)
    try:
        while True:
            if dec.decode() is None:
                return True  # nothing to repair
    except UnexpectedEOF as e:
        if e.path != paths[-1]:
            return False
        bad_path, good_off = e.path, dec.last_valid_off
    except CorruptError:
        return False
    finally:
        dec.close()
    import shutil
    shutil.copyfile(bad_path, bad_path + ".broken")
    with open(bad_path, "r+b") as f:
        f.truncate(good_off)
        fileutil.fsync(f.fileno())
    fileutil.fsync_dir(dirname)
    return True
