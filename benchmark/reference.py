"""The plain reference that decides `correct`: what the served writes must
have left behind, worked out again from the generated writes, the WAL
bytes on disk, the fsyncs the process made, and the consensus state read
back from the device.

It imports nothing of the program. Its inputs are plain data:

- `writes`: the generated writes in submission order (tenant, key path,
  value) with each one's request id, its ack time and what the ack said
  (key, value, modified index), or None where no ack came;
- the WAL directory the run wrote, decoded here from its documented byte
  format (framing `type:u32 crc:u32 len:u64 payload` with a rolling
  zlib CRC; round records of column deltas and entry payloads; an entry's
  payload a tagged etcd v2 request in canonical JSON, or a count-prefixed
  batch of them);
- the fsync calls of the run: (file inode, file size when the call began,
  time it returned);
- the final stores' answers for every key written;
- the device state's (G, P) term, role, commit, last index, peer mask and
  (G, P, W) ring of entry terms.

Three layers are held to their guarantees:

1. apply/store: every acked write's answer is the one a sequential etcd v2
   store gives for that tenant's writes in submission order, and each
   touched key's final value and modified index are its last write's;
2. consensus: every acked write's entry (group, index, term) is held at
   that term by a quorum of the group's live slots and lies at or below
   the leader's commit index;
3. WAL: every acked write lies in a whole, checksummed record, and an
   fsync of that file, begun with the record's bytes already written,
   returned before the ack.

Each number compared is a count of writes that break a guarantee; every
limit is 0.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

# Byte format of the engine WAL.
_HDR = struct.Struct("<IIQ")
REC_CRC = 1
REC_ROUND = 2
# Entry payload tags.
TAG_REQ = 0x00
TAG_MULTI = 0x02
LEADER = 2

# The numbers compared, in the order they are printed; each limit is 0.
CHECKS = ("unacked", "ack_mismatch", "store_mismatch", "not_in_wal",
          "ack_before_fsync", "below_quorum", "above_commit")


@dataclass
class Writes:
    """The generated writes in submission order and what their clients
    saw: per write its tenant and key number, the request id the engine
    gave it, the time its ack came (NaN where none came) and what the ack
    said (key, value, modified index). `path(key)` and `value(j)` give
    the write's key path and value."""
    tenant: np.ndarray                   # int64 (N,)
    key: np.ndarray                      # int64 (N,)
    rid: np.ndarray                      # int64 (N,)
    t_ack: np.ndarray                    # float64 (N,), perf_counter s
    ack_index: np.ndarray                # int64 (N,)
    ack_key: list                        # str or None, (N,)
    ack_value: list                      # str or None, (N,)
    path: Callable[[int], str]
    value: Callable[[int], str]


@dataclass
class Entry:
    """Where a request id lies in the WAL."""
    group: int
    index: int
    term: int
    inode: int
    end: int                             # byte offset where its record ends


@dataclass
class DeviceState:
    term: np.ndarray                     # (G, P)
    state: np.ndarray                    # (G, P)
    commit: np.ndarray                   # (G, P)
    last: np.ndarray                     # (G, P)
    ring: np.ndarray                     # (G, P, W): entry i at i % W
    mask: np.ndarray                     # (G, P) bool


@dataclass
class WalScan:
    entries: Dict[int, List[Entry]] = field(default_factory=dict)
    # (g, i) -> the term of the last entry the WAL journals at index i of
    # group g: the term the log holds there unless a later leader
    # overwrote it (which it would journal too).
    last_term: Dict[Tuple[int, int], int] = field(default_factory=dict)


def _frames(data: bytes) -> Iterator[Tuple[int, bytes, int]]:
    """(type, payload, end offset) of each whole, checksummed frame; stops
    at the first torn or corrupt one."""
    off, crc = 0, None
    while off + _HDR.size <= len(data):
        rtype, rcrc, ln = _HDR.unpack_from(data, off)
        end = off + _HDR.size + ln
        if end > len(data):
            return
        payload = data[off + _HDR.size:end]
        if crc is None:
            if rtype != REC_CRC or ln != 4:
                return
            crc = struct.unpack("<I", payload)[0]
        crc = zlib.crc32(payload, crc) & 0xFFFFFFFF
        if crc != rcrc:
            return
        yield rtype, payload, end
        off = end


def _request_ids(payload: bytes) -> List[int]:
    """Request ids carried by one entry payload."""
    if not payload:
        return []
    tag = payload[0]
    if tag == TAG_REQ:
        return [int(json.loads(payload[1:])["id"])]
    if tag == TAG_MULTI:
        (n,) = struct.unpack_from("<I", payload, 1)
        off, out = 5, []
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", payload, off)
            off += 4
            out.append(int(json.loads(payload[off:off + ln])["id"]))
            off += ln
        return out
    return []


def _round_record(payload: bytes, inode: int, end: int,
                  scan: WalScan) -> None:
    off = 4                                           # u32 round
    # Column sections: hard state (g u32, p u16, term u32, vote u16,
    # commit u32), last index (g u32, p u16, last u32), ring writes
    # (g u32, p u16, index u32, term u32).
    for width in (16, 10, 14):
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4 + n * width
    (n,) = struct.unpack_from("<I", payload, off)     # entries
    off += 4
    for _ in range(n):
        g, i, t, ln = struct.unpack_from("<IIII", payload, off)
        off += 16
        scan.last_term[(g, i)] = t
        for rid in _request_ids(payload[off:off + ln]):
            scan.entries.setdefault(rid, []).append(
                Entry(g, i, t, inode, end))
        off += ln


def scan_wal(data_dir: str) -> WalScan:
    """Every whole record of every WAL stream under `data_dir`, streams in
    name order and records in file order (round order within a stream)."""
    scan = WalScan()
    streams = [data_dir] + sorted(
        os.path.join(data_dir, n) for n in os.listdir(data_dir)
        if n.startswith("wal-shard-"))
    for d in streams:
        segs = sorted(n for n in os.listdir(d)
                      if n.startswith("engine-") and n.endswith(".wal"))
        for name in segs:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                data = f.read()
            inode = os.stat(path).st_ino
            for rtype, payload, end in _frames(data):
                if rtype == REC_ROUND:
                    _round_record(payload, inode, end, scan)
    return scan


def holders(e: Entry, scan: WalScan, dev: DeviceState) -> int:
    """Live slots of group e.group whose log holds entry (index, term).

    Inside a slot's ring window (last - W, last] the device ring says so
    directly. Below it, Raft's log matching decides: a slot whose ring
    agrees with the leader's at an index j >= e.index, inside both
    windows, holds the leader's prefix through j; the leader holds
    (index, term) where the WAL's last entry journaled at that index has
    that term (a later leader's overwrite is journaled too)."""
    g, i, t = e.group, e.index, e.term
    W = dev.ring.shape[2]
    live = np.nonzero(dev.mask[g])[0]
    lead = [p for p in live if dev.state[g, p] == LEADER]
    L = max(lead, key=lambda p: dev.term[g, p]) if lead else None
    n = 0
    for p in live:
        last = int(dev.last[g, p])
        if i > last:
            continue
        if i > last - W:
            n += int(dev.ring[g, p, i % W]) == t
            continue
        if L is None or scan.last_term.get((g, i)) != t:
            continue
        last_l = int(dev.last[g, L])
        j = min(last, last_l)
        if j >= i and j > max(last, last_l) - W \
                and dev.ring[g, p, j % W] == dev.ring[g, L, j % W]:
            n += 1
    return n


def synced_by(fsyncs: Dict[int, List[Tuple[int, float]]], inode: int,
              end: int) -> Optional[float]:
    """When the first fsync of `inode` that covered byte `end` returned."""
    for size, t_done in fsyncs.get(inode, ()):
        if size >= end:
            return t_done
    return None


def expected_index(tenant: np.ndarray) -> np.ndarray:
    """The modified index a sequential etcd v2 store gives each write when
    every tenant's writes apply in submission order: every set raises the
    tenant's index by one, so write j's index is its rank among its
    tenant's writes, from 1."""
    order = np.argsort(tenant, kind="stable")
    ts = tenant[order]
    starts = np.r_[0, np.nonzero(np.diff(ts))[0] + 1]
    run_start = np.repeat(starts, np.diff(np.r_[starts, len(ts)]))
    k = np.empty(len(tenant), np.int64)
    k[order] = np.arange(len(ts)) - run_start + 1
    return k


def last_writes(w: Writes) -> np.ndarray:
    """Index of the last write to each (tenant, key) written."""
    code = w.tenant * (int(w.key.max()) + 1 if len(w.key) else 1) + w.key
    _, first_rev = np.unique(code[::-1], return_index=True)
    return len(code) - 1 - first_rev


def check(w: Writes, scan: WalScan,
          fsyncs: Dict[int, List[Tuple[int, float]]],
          read_key, dev: DeviceState, quorum: int) -> Dict[str, int]:
    """The counts of CHECKS. `read_key(tenant, path)` returns the store's
    (value, modified index) or None; `fsyncs` maps an inode to its
    (size, time) calls in order."""
    out = dict.fromkeys(CHECKS, 0)
    want = expected_index(w.tenant)
    acked = ~np.isnan(w.t_ack)
    out["unacked"] = int((~acked).sum())
    for j in np.nonzero(acked)[0]:
        j = int(j)
        if (w.ack_key[j], w.ack_value[j], int(w.ack_index[j])) != (
                w.path(int(w.key[j])), w.value(j), int(want[j])):
            out["ack_mismatch"] += 1
        ents = scan.entries.get(int(w.rid[j]))
        if not ents:
            out["not_in_wal"] += 1
            continue
        t_ack = float(w.t_ack[j])
        if not any((t := synced_by(fsyncs, e.inode, e.end)) is not None
                   and t <= t_ack for e in ents):
            out["ack_before_fsync"] += 1
        held_best, committed = 0, False
        for e in ents:
            g = e.group
            held_best = max(held_best, holders(e, scan, dev))
            lead = [p for p in np.nonzero(dev.mask[g])[0]
                    if dev.state[g, p] == LEADER]
            if lead:
                top = max(lead, key=lambda p: dev.term[g, p])
                committed |= int(dev.commit[g, top]) >= e.index
        if held_best < quorum:
            out["below_quorum"] += 1
        if not committed:
            out["above_commit"] += 1
    for j in last_writes(w):
        j = int(j)
        g, path = int(w.tenant[j]), w.path(int(w.key[j]))
        if read_key(g, path) != (w.value(j), int(want[j])):
            out["store_mismatch"] += 1
    return out
