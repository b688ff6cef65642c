"""Durability for the batched MultiNode engine: a segmented record log of
per-round state DELTAS plus periodic full checkpoints.

The reference persists one WAL per member (wal/wal.go) because one process
hosts one consensus instance. The engine hosts G groups x P slots in one
process, so durability batches ALL groups' changes from one kernel round
into ONE record and ONE fsync — the round is the natural commit unit (the
moral upgrade of the reference's batched Save, wal/wal.go:459-487).

Round-record payload (little-endian, numpy-packed column arrays):
    u32 round
    hs    deltas: n * (g:u32, p:u16, term:u32, vote:u16, commit:u32)
    last  deltas: n * (g:u32, p:u16, last:u32)
    ring  deltas: n * (g:u32, p:u16, index:u32, term:u32)
    entry payloads: n * (g:u32, index:u32, term:u32, len:u32, bytes)
    conf  changes: n * (g:u32, slot:u16, op:u8)

Framing per record: type:u32 crc:u32 len:u64 payload — crc is the rolling
zlib.crc32 over all payloads in the segment (seeded by the CRC record at the
segment head), the same mid-file-flip detection scheme as etcd_tpu/wal/wal.py
(reference wal/wal.go:60). A torn tail (crash mid-append) truncates replay at
the last whole, checksummed record; the engine then appends into a NEW
segment, never rewriting history.

Checkpoints are full-state JSON files written atomically (tmp+rename+fsync);
segments strictly older than the newest checkpoint's round are purged after
the checkpoint lands (reference snapshot-then-ReleaseLockTo sequencing,
etcdserver/storage.go:55-73).
"""
from __future__ import annotations

import base64
import json
import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from etcd_tpu_torch.utils.fileutil import fsync_dir, touch_dir_all
from etcd_tpu_torch.utils import metrics

_HDR = struct.Struct("<IIQ")  # type, crc, len

REC_CRC = 1       # segment head: payload = u32 seed crc
REC_ROUND = 2     # one kernel round's deltas

CONF_ADD = 0
CONF_REMOVE = 1

_U32 = np.dtype("<u4")
_U16 = np.dtype("<u2")
_U8 = np.dtype("u1")


def _seg_name(seq: int, round_no: int) -> str:
    return f"engine-{seq:016x}-{round_no:016x}.wal"


def _parse_seg(name: str) -> Tuple[int, int]:
    stem = name[len("engine-"):-len(".wal")]
    a, b = stem.split("-")
    return int(a, 16), int(b, 16)


def _ckpt_name(round_no: int) -> str:
    return f"checkpoint-{round_no:016x}.json"


@dataclass
class RoundRecord:
    """One kernel round's durable deltas."""

    round_no: int
    # Columns (1-D numpy arrays, equal length per section):
    hs_g: np.ndarray = field(default_factory=lambda: np.empty(0, _U32))
    hs_p: np.ndarray = field(default_factory=lambda: np.empty(0, _U16))
    hs_term: np.ndarray = field(default_factory=lambda: np.empty(0, _U32))
    hs_vote: np.ndarray = field(default_factory=lambda: np.empty(0, _U16))
    hs_commit: np.ndarray = field(default_factory=lambda: np.empty(0, _U32))
    last_g: np.ndarray = field(default_factory=lambda: np.empty(0, _U32))
    last_p: np.ndarray = field(default_factory=lambda: np.empty(0, _U16))
    last_v: np.ndarray = field(default_factory=lambda: np.empty(0, _U32))
    ring_g: np.ndarray = field(default_factory=lambda: np.empty(0, _U32))
    ring_p: np.ndarray = field(default_factory=lambda: np.empty(0, _U16))
    ring_i: np.ndarray = field(default_factory=lambda: np.empty(0, _U32))
    ring_t: np.ndarray = field(default_factory=lambda: np.empty(0, _U32))
    # (g, index, term, payload) proposals admitted this round:
    entries: List[Tuple[int, int, int, bytes]] = field(default_factory=list)
    # (g, slot, op) membership bit flips applied this round:
    confs: List[Tuple[int, int, int]] = field(default_factory=list)
    # (g, applied_index, store_blob) cross-host snapshot installs received
    # this round (hostengine): the store jumps wholesale to the blob's state
    # at applied_index. The same round's hs/ring/last diffs carry the
    # install's column surgery (mirrors are kept stale through it), so this
    # section records only what the diffs cannot: the state-machine image
    # and the apply cursor. Replayed FIRST within the record.
    snaps: List[Tuple[int, int, bytes]] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not (len(self.hs_g) or len(self.last_g) or len(self.ring_g)
                    or self.entries or self.confs or self.snaps)

    def encode(self) -> bytes:
        out = [struct.pack("<I", self.round_no)]

        def cols(*arrs):
            n = len(arrs[0])
            out.append(struct.pack("<I", n))
            for a in arrs:
                out.append(np.ascontiguousarray(a).tobytes())

        cols(self.hs_g.astype(_U32), self.hs_p.astype(_U16),
             self.hs_term.astype(_U32), self.hs_vote.astype(_U16),
             self.hs_commit.astype(_U32))
        cols(self.last_g.astype(_U32), self.last_p.astype(_U16),
             self.last_v.astype(_U32))
        cols(self.ring_g.astype(_U32), self.ring_p.astype(_U16),
             self.ring_i.astype(_U32), self.ring_t.astype(_U32))
        out.append(struct.pack("<I", len(self.entries)))
        for g, i, t, payload in self.entries:
            out.append(struct.pack("<IIII", g, i, t, len(payload)))
            out.append(payload)
        out.append(struct.pack("<I", len(self.confs)))
        for g, slot, op in self.confs:
            out.append(struct.pack("<IHB", g, slot, op))
        # Trailing section, appended only when used: records written before
        # snapshots existed simply end here, and decode treats the missing
        # section as empty (same forward-compat trick a protobuf field
        # addition gives the reference's walpb).
        if self.snaps:
            out.append(struct.pack("<I", len(self.snaps)))
            for g, a, blob in self.snaps:
                out.append(struct.pack("<III", g, a, len(blob)))
                out.append(blob)
        return b"".join(out)

    @staticmethod
    def decode(b: bytes) -> "RoundRecord":
        off = 0

        def u32():
            nonlocal off
            (v,) = struct.unpack_from("<I", b, off)
            off += 4
            return v

        rec = RoundRecord(round_no=u32())

        def cols(dtypes):
            nonlocal off
            n = u32()
            outs = []
            for dt in dtypes:
                nbytes = n * dt.itemsize
                outs.append(np.frombuffer(b, dt, count=n, offset=off).copy())
                off += nbytes
            return outs

        (rec.hs_g, rec.hs_p, rec.hs_term, rec.hs_vote,
         rec.hs_commit) = cols([_U32, _U16, _U32, _U16, _U32])
        rec.last_g, rec.last_p, rec.last_v = cols([_U32, _U16, _U32])
        rec.ring_g, rec.ring_p, rec.ring_i, rec.ring_t = cols(
            [_U32, _U16, _U32, _U32])
        n_ents = u32()
        for _ in range(n_ents):
            g, i, t, ln = struct.unpack_from("<IIII", b, off)
            off += 16
            rec.entries.append((g, i, t, b[off:off + ln]))
            off += ln
        n_confs = u32()
        for _ in range(n_confs):
            g, slot, op = struct.unpack_from("<IHB", b, off)
            off += 7
            rec.confs.append((g, slot, op))
        if off < len(b):
            n_snaps = u32()
            for _ in range(n_snaps):
                g, a, ln = struct.unpack_from("<III", b, off)
                off += 12
                rec.snaps.append((g, a, b[off:off + ln]))
                off += ln
        return rec


class EngineWAL:
    """Append-only segmented log of RoundRecords + checkpoint management."""

    def __init__(self, dirname: str,
                 segment_size: int = 64 * 1024 * 1024,
                 fsync: bool = True) -> None:
        touch_dir_all(dirname)
        self.dir = dirname
        self.segment_size = segment_size
        self.fsync = fsync
        self._f = None
        self._crc = 0
        self._seq = -1
        # Highest round_no held in a WHOLE, checksummed record of this
        # stream (the stream's durable tail), maintained by replay() and
        # the write side. -1 until either has seen a record. The sharded
        # writer (walwriter.WALWriter) takes the min over its streams'
        # tails as the consistent replay boundary.
        self.last_round = -1
        self._pending_round = -1  # appended but not yet sync()ed

    # -- write side ---------------------------------------------------------

    def _open_segment(self, round_no: int) -> None:
        if self._f is not None:
            self._f.close()
        self._seq += 1
        path = os.path.join(self.dir, _seg_name(self._seq, round_no))
        self._f = open(path, "ab")
        self._write(REC_CRC, struct.pack("<I", self._crc))

    def _write(self, rtype: int, payload: bytes) -> None:
        from etcd_tpu_torch import native
        buf, self._crc = native.encode_records([(rtype, payload)], self._crc)
        self._f.write(buf)

    def append_nosync(self, rec: RoundRecord) -> None:
        """Append one round record WITHOUT flushing or fsyncing — the
        group-commit half of the writer compartment: a batch of these
        followed by one sync() makes one fsync cover every queued round
        (the generalization of the reference's batched Save,
        wal/wal.go:459-487). The record is NOT durable until sync()."""
        if self._f is None:
            self._open_segment(rec.round_no)
        self._write(REC_ROUND, rec.encode())
        self._pending_round = max(self._pending_round, rec.round_no)

    def sync(self) -> None:
        """Flush + (optionally) fsync everything appended so far, then
        rotate if the segment is over size. After this returns, every
        append_nosync'd record is durable and last_round reflects it.
        Feeds the reference wal/metrics.go series (fsync latency in µs,
        last index saved — here: last round) alongside the engine's own
        per-shard histograms in walwriter.py."""
        if self._f is None:
            return
        t0 = time.perf_counter()
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        metrics.wal_fsync_durations.observe(
            (time.perf_counter() - t0) * 1e6)
        if self._pending_round >= 0:
            self.last_round = max(self.last_round, self._pending_round)
            self._pending_round = -1
            metrics.wal_last_index_saved.set(self.last_round)
        if self._f.tell() >= self.segment_size:
            self._open_segment(self.last_round + 1)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())

    def append(self, rec: RoundRecord) -> None:
        """Append + (optionally) fsync one round record. MUST complete before
        the next kernel round consumes this round's messages (the batched
        persist-before-send contract, reference raft/doc.go:31-39)."""
        self.append_nosync(rec)
        self.sync()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    # -- read side ----------------------------------------------------------

    def _segments(self) -> List[str]:
        names = [n for n in os.listdir(self.dir)
                 if n.startswith("engine-") and n.endswith(".wal")]
        return sorted(names, key=_parse_seg)

    def replay(self, after_round: int = -1) -> Iterator[RoundRecord]:
        """Yield whole, checksummed round records with round_no > after_round.
        Stops cleanly at a torn tail. Also positions the writer: appends go
        to a FRESH segment after the last good record."""
        from etcd_tpu_torch import native
        max_seq = -1
        for name in self._segments():
            seq, _ = _parse_seg(name)
            max_seq = max(max_seq, seq)
            path = os.path.join(self.dir, name)
            with open(path, "rb") as f:
                data = f.read()
            # Head CRC record seeds the chain (its payload IS the seed, and
            # it chains over itself like every record).
            if len(data) < _HDR.size:
                continue
            rtype, rcrc, ln = _HDR.unpack_from(data, 0)
            if (rtype != REC_CRC or _HDR.size + ln > len(data)):
                continue  # segment without a valid CRC head: corrupt
            payload = data[_HDR.size:_HDR.size + ln]
            (seed,) = struct.unpack("<I", payload)
            crc = zlib.crc32(payload, seed) & 0xFFFFFFFF
            if crc != rcrc:
                continue
            # Verified batch scan of the remainder (C when built).
            recs, crc, _ = native.scan_records(data[_HDR.size + ln:], crc)
            for rt, pl in recs:
                if rt == REC_ROUND:
                    rec = RoundRecord.decode(pl)
                    # Tail tracking covers EVERY whole record, filtered or
                    # not: a stream whose records all predate the filter
                    # is still complete through its tail.
                    self.last_round = max(self.last_round, rec.round_no)
                    if rec.round_no > after_round:
                        yield rec
            self._crc = crc
        self._seq = max_seq

    def cut_after(self, round_no: int) -> int:
        """Physically drop every whole record with round > round_no and
        position the appender at the cut. Returns the number of round
        records dropped.

        This is how the sharded writer reassembles a consistent boundary:
        a crash between the per-range streams' parallel fsyncs leaves
        some streams with whole, checksummed records whose batch never
        became durable on every sibling stream — those rounds were never
        acked (acks gate on the min-over-streams watermark), but they
        MUST NOT survive on disk, or the next crash-restart would replay
        them alongside reused round numbers carrying different content.
        Call after replay() (which positions _seq past every segment)."""
        dropped = 0
        cutting = False
        for name in self._segments():
            path = os.path.join(self.dir, name)
            with open(path, "rb") as f:
                data = f.read()
            # Walk frames exactly like replay: chain the rolling CRC and
            # stop at the first torn/corrupt frame.
            off, crc, cut_off, good_crc = 0, 0, None, None
            while off + _HDR.size <= len(data):
                rtype, rcrc, ln = _HDR.unpack_from(data, off)
                if off + _HDR.size + ln > len(data):
                    break
                payload = data[off + _HDR.size:off + _HDR.size + ln]
                if off == 0:
                    if rtype != REC_CRC:
                        break
                    (seed,) = struct.unpack("<I", payload)
                    crc = zlib.crc32(payload, seed) & 0xFFFFFFFF
                else:
                    crc = zlib.crc32(payload, crc) & 0xFFFFFFFF
                if crc != rcrc:
                    break
                if cut_off is None and rtype == REC_ROUND:
                    (r,) = struct.unpack_from("<I", payload, 0)
                    if r > round_no:
                        cut_off = off   # rounds are append-monotonic:
                        # everything from here on is beyond the boundary
                if cut_off is not None:
                    if rtype == REC_ROUND:
                        dropped += 1
                else:
                    good_crc = crc
                off += _HDR.size + ln
            if cutting:
                os.unlink(path)
                continue
            if cut_off is not None:
                if good_crc is None:
                    # Even the CRC head fell beyond the cut (impossible:
                    # the head is not a round record) — drop the segment.
                    os.unlink(path)
                else:
                    with open(path, "r+b") as f:
                        f.truncate(cut_off)
                        f.flush()
                        os.fsync(f.fileno())
                    self._crc = good_crc
                cutting = True
        if cutting:
            fsync_dir(self.dir)
            self.last_round = min(self.last_round, round_no)
        return dropped

    # -- checkpoints --------------------------------------------------------

    def save_checkpoint(self, round_no: int, state: dict) -> int:
        """Atomically persist a full engine checkpoint, then purge segments
        that predate it (every record they hold is round <= round_no).
        Returns the fallback round segment retention serves — the sharded
        writer purges its per-range streams against the same value."""
        path = os.path.join(self.dir, _ckpt_name(round_no))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(self.dir)
        # Keep the newest older checkpoint as a fallback; purge the rest.
        ckpts = sorted(n for n in os.listdir(self.dir)
                       if n.startswith("checkpoint-") and n.endswith(".json"))
        for name in ckpts[:-2]:
            os.unlink(os.path.join(self.dir, name))
        ckpts = ckpts[-2:]
        # Segment retention must serve the OLDEST retained checkpoint: if
        # the newest one is later unreadable, load_checkpoint falls back to
        # the previous one and needs every round after ITS round — purging
        # up to the newest would silently lose that span.
        fallback_round = int(ckpts[0][len("checkpoint-"):-len(".json")], 16)
        self.purge_segments(fallback_round)
        return fallback_round

    def purge_segments(self, fallback_round: int) -> None:
        """Drop segments every record of which is round <= fallback_round
        (covered by a retained checkpoint). A segment is droppable iff the
        NEXT segment's first round says so — the newest segment always
        stays (it is the append target)."""
        segs = self._segments()
        for i, name in enumerate(segs[:-1]):
            _, nxt_round = _parse_seg(segs[i + 1])
            if nxt_round <= fallback_round + 1:
                os.unlink(os.path.join(self.dir, name))

    def load_checkpoint(self) -> Tuple[int, Optional[dict]]:
        """Newest parseable checkpoint as (round_no, state); (-1, None) if
        none. A corrupt newest checkpoint falls back to the previous one
        (reference snap.Load newest-first with .broken quarantine,
        snap/snapshotter.go:84-143)."""
        ckpts = sorted((n for n in os.listdir(self.dir)
                        if n.startswith("checkpoint-")
                        and n.endswith(".json")), reverse=True)
        for name in ckpts:
            path = os.path.join(self.dir, name)
            try:
                with open(path) as f:
                    state = json.load(f)
                return int(name[len("checkpoint-"):-len(".json")], 16), state
            except (ValueError, OSError):
                os.replace(path, path + ".broken")
        return -1, None


def load_terms(dirname: str, groups: int) -> np.ndarray:
    """Final per-group term recorded in one host's engine WAL dir
    (checkpoint base + round-record replay; terms are monotonic, so the
    final value is also the max). The degraded-restart supervisor takes the
    elementwise max of every SURVIVOR's result as the term floor for a host
    restarting with an empty data dir: any vote the dead host ever cast in
    a term above that floor can only have been a vote for itself (a
    candidate's own term is persisted wherever it campaigns), so granting
    fresh votes at floor+1 and up can never double-count toward a quorum
    the old vote already joined."""
    terms = np.zeros(groups, np.int32)
    wal = EngineWAL(dirname)
    try:
        ckpt_round, ckpt = wal.load_checkpoint()
        if ckpt is not None:
            terms = b64_np(ckpt["term"]).astype(np.int32).copy()
        # Streams: the root dir plus any per-range shard streams a
        # sharded writer (walwriter.WALWriter) left behind. Terms are
        # monotonic per group, so the elementwise max across streams IS
        # the final value — no merged round ordering needed, and records
        # beyond the crash boundary only ever raise the floor (safe:
        # this host really did persist that term).
        dirs = [dirname] + [os.path.join(dirname, n)
                            for n in sorted(os.listdir(dirname))
                            if n.startswith("wal-shard-")
                            and os.path.isdir(os.path.join(dirname, n))]
        for d in dirs:
            w = wal if d == dirname else EngineWAL(d)
            try:
                for rec in w.replay(after_round=ckpt_round):
                    for g, t in zip(rec.hs_g, rec.hs_term):
                        if g < groups:
                            terms[g] = max(terms[g], t)
            finally:
                if w is not wal:
                    w.close()
    finally:
        wal.close()
    return terms


def np_b64(a: np.ndarray) -> dict:
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": base64.b64encode(np.ascontiguousarray(a).tobytes()
                                     ).decode()}


def b64_np(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["data"]),
                         np.dtype(d["dtype"])).reshape(d["shape"]).copy()
