"""The v3 MVCC key-value store (flat keyspace, revisioned history).

Behavioral equivalent of reference storage/kvstore.go +
kvstore_compaction.go, the embryonic v3 backend matching
Documentation/rfc/v3api.md: every mutation gets a (main, sub) revision;
values live in the backend's "key" bucket under the 17-byte revision key;
the in-memory TreeIndex maps user keys to their revision history; reads at
any uncompacted revision; deletions are tombstones; Compact(rev) drops
history ≤ rev in the index, then scrubs the backend in paced batches on a
background thread (kvstore_compaction.go). Txn* methods give one writer a
multi-op transaction: sub revisions count ops inside it and the main
revision bumps once at TxnEnd (kvstore.go:81-104).

Beyond the reference's sketch: KeyValue carries create_rev/mod_rev/version
(its proto declares them but the sketch never fills them), and restore()
rebuilds the index by scanning the backend so the store survives restarts.
"""
from __future__ import annotations

import contextlib
import json
import logging
import struct
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

from etcd_tpu_torch.storage.backend import Backend
from etcd_tpu_torch.storage.index import RevisionNotFoundError, TreeIndex
from etcd_tpu_torch.storage.revision import Revision, bytes_to_rev, rev_to_bytes

log = logging.getLogger("storage")

KEY_BUCKET = b"key"
META_BUCKET = b"meta"
SCHEDULED_COMPACT_KEY = b"scheduledCompactRev"   # kvstore.go:19
FINISHED_COMPACT_KEY = b"finishedCompactRev"     # kvstore.go:20

PUT, DELETE = 0, 1


class CompactedError(Exception):
    """reference ErrCompacted kvstore.go:23."""


class TxnIDMismatchError(Exception):
    """reference ErrTnxIDMismatch kvstore.go:22."""


class KeyValue(NamedTuple):
    key: bytes
    value: bytes
    create_rev: int = 0
    mod_rev: int = 0
    version: int = 0


def _encode_event(etype: int, kv: KeyValue) -> bytes:
    """Compact length-prefixed binary (storagepb.Event analogue)."""
    return (struct.pack(">BQQQI", etype, kv.create_rev, kv.mod_rev,
                        kv.version, len(kv.key)) + kv.key + kv.value)


def _decode_event(b: bytes) -> Tuple[int, KeyValue]:
    etype, crev, mrev, ver, klen = struct.unpack(">BQQQI", b[:29])
    key = b[29:29 + klen]
    value = b[29 + klen:]
    return etype, KeyValue(key, value, crev, mrev, ver)


class KVStore:
    """One MVCC keyspace over a Backend file."""

    def __init__(self, path: str,
                 batch_interval: float = None,
                 batch_limit: int = None,
                 compaction_batch: int = 10000,
                 compaction_pause: float = 0.1) -> None:
        kw = {}
        if batch_interval is not None:
            kw["batch_interval"] = batch_interval
        if batch_limit is not None:
            kw["batch_limit"] = batch_limit
        self.b = Backend(path, **kw)
        self.kvindex = TreeIndex()
        self._mu = threading.RLock()        # kvstore.go store.mu
        self.current_rev = Revision(0, 0)
        self.compact_main_rev = -1
        self._txn_lock = threading.Lock()
        self._txn_id = 0
        self._txn_counter = 0
        self.compaction_batch = compaction_batch
        self.compaction_pause = compaction_pause
        self._compact_threads = []

        with self.b.batch_tx as tx:
            tx.unsafe_create_bucket(KEY_BUCKET)
            tx.unsafe_create_bucket(META_BUCKET)
        self.b.force_commit()
        self.restore()

    @contextlib.contextmanager
    def atomic(self):
        """A multi-op atomic unit: holds the store mutex AND the backend
        batch-tx (commits deferred), so everything inside lands in one
        sqlite commit and no reader interleaves. Lock order is
        _mu -> batch_tx — the same order every read/write path uses
        (txn_begin takes _mu, then the op takes batch_tx) — so this cannot
        invert against a concurrent serializable reader."""
        with self._mu:
            with self.b.batch_tx.hold() as tx:
                yield tx

    # -- single-op API (reference kvstore.go:56-79) -------------------------

    def put(self, key: bytes, value: bytes) -> int:
        tid = self.txn_begin()
        try:
            self._put(key, value, self.current_rev.main + 1)
        finally:
            self.txn_end(tid)
        return self.current_rev.main

    def range(self, key: bytes, end: Optional[bytes] = None, limit: int = 0,
              range_rev: int = 0) -> Tuple[List[KeyValue], int]:
        tid = self.txn_begin()
        try:
            return self._range_keys(key, end, limit, range_rev)
        finally:
            self.txn_end(tid)

    def count(self, key: bytes, end: Optional[bytes] = None,
              range_rev: int = 0) -> int:
        """Number of live keys in [key, end) at the revision — answered
        entirely from the in-memory index (the index never surfaces
        tombstoned generations), so counting a huge range costs no backend
        reads or value decodes."""
        with self._mu:
            if range_rev <= 0:
                rev = self.current_rev.main
                if self.current_rev.sub > 0:
                    rev += 1
            else:
                rev = range_rev
            if rev <= self.compact_main_rev:
                raise CompactedError(rev)
            _, revpairs = self.kvindex.range(key, end, rev)
            return len(revpairs)

    def delete_range(self, key: bytes, end: Optional[bytes] = None
                     ) -> Tuple[int, int]:
        tid = self.txn_begin()
        try:
            n = self._delete_range(key, end, self.current_rev.main + 1)
        finally:
            self.txn_end(tid)
        return n, self.current_rev.main

    # -- txn API (reference kvstore.go:81-139) ------------------------------

    def txn_begin(self) -> int:
        self._mu.acquire()
        self.current_rev = Revision(self.current_rev.main, 0)
        with self._txn_lock:
            self._txn_counter += 1
            self._txn_id = self._txn_counter
            return self._txn_id

    def txn_end(self, txn_id: int) -> None:
        with self._txn_lock:
            if txn_id != self._txn_id:
                raise TxnIDMismatchError(txn_id)
        main, sub = self.current_rev
        if sub != 0:
            main += 1
        self.current_rev = Revision(main, 0)
        self._mu.release()

    def txn_range(self, txn_id: int, key: bytes, end: Optional[bytes] = None,
                  limit: int = 0, range_rev: int = 0
                  ) -> Tuple[List[KeyValue], int]:
        with self._txn_lock:
            if txn_id != self._txn_id:
                raise TxnIDMismatchError(txn_id)
        return self._range_keys(key, end, limit, range_rev)

    def txn_put(self, txn_id: int, key: bytes, value: bytes) -> int:
        with self._txn_lock:
            if txn_id != self._txn_id:
                raise TxnIDMismatchError(txn_id)
        self._put(key, value, self.current_rev.main + 1)
        return self.current_rev.main + 1

    def txn_delete_range(self, txn_id: int, key: bytes,
                         end: Optional[bytes] = None) -> Tuple[int, int]:
        with self._txn_lock:
            if txn_id != self._txn_id:
                raise TxnIDMismatchError(txn_id)
        n = self._delete_range(key, end, self.current_rev.main + 1)
        rev = 0
        if n != 0 or self.current_rev.sub != 0:
            rev = self.current_rev.main + 1
        return n, rev

    # -- compaction (kvstore.go:141-163 + kvstore_compaction.go) ------------

    def compact(self, rev: int) -> threading.Thread:
        with self._mu:
            if rev <= self.compact_main_rev:
                raise CompactedError(rev)
            if rev > self.current_rev.main:
                raise ValueError(f"revision {rev} is in the future")
            self.compact_main_rev = rev
            with self.b.batch_tx as tx:
                tx.unsafe_put(META_BUCKET, SCHEDULED_COMPACT_KEY,
                              rev_to_bytes(Revision(rev, 0)))
            keep = self.kvindex.compact(rev)
        t = threading.Thread(target=self._scheduled_compaction,
                             args=(rev, keep), daemon=True,
                             name="storage-compact")
        self._compact_threads.append(t)
        t.start()
        return t

    def _scheduled_compaction(self, compact_rev: int, keep) -> None:
        """Scrub backend revisions ≤ compact_rev not in `keep`, in paced
        batches (reference kvstore_compaction.go:8-41)."""
        import sqlite3
        end = struct.pack(">Q", compact_rev + 1)
        last = bytes(17)
        while True:
            try:
                finished, last = self._compaction_step(compact_rev, keep,
                                                       end, last)
            except sqlite3.ProgrammingError:
                return  # backend closed; restore() resumes next open
            if finished:
                return
            time.sleep(self.compaction_pause)

    def _compaction_step(self, compact_rev, keep, end, last):
        """One scrub batch; returns (finished, next_last)."""
        with self.b.batch_tx as tx:
            keys, _ = tx.unsafe_range(KEY_BUCKET, last, end,
                                      self.compaction_batch)
            rev = None
            for kb in keys:
                if len(kb) != 17:
                    continue
                rev = bytes_to_rev(kb)
                if rev not in keep:
                    tx.unsafe_delete(KEY_BUCKET, kb)
            if not keys:
                tx.unsafe_put(META_BUCKET, FINISHED_COMPACT_KEY,
                              rev_to_bytes(Revision(compact_rev, 0)))
                log.info("storage: finished compaction at %d", compact_rev)
                return True, last
            if rev is None:
                return True, last
            return False, rev_to_bytes(Revision(rev.main, rev.sub + 1))

    # -- internals ----------------------------------------------------------

    def _range_keys(self, key: bytes, end: Optional[bytes], limit: int,
                    range_rev: int) -> Tuple[List[KeyValue], int]:
        if range_rev <= 0:
            rev = self.current_rev.main
            if self.current_rev.sub > 0:
                rev += 1
        else:
            rev = range_rev
        if rev <= self.compact_main_rev:
            raise CompactedError(rev)

        _, revpairs = self.kvindex.range(key, end, rev)
        kvs: List[KeyValue] = []
        if not revpairs:
            return kvs, rev
        if limit > 0:
            revpairs = revpairs[:limit]
        with self.b.batch_tx as tx:
            for rp in revpairs:
                _, vs = tx.unsafe_range(KEY_BUCKET, rev_to_bytes(rp))
                if len(vs) != 1:
                    raise RuntimeError(
                        f"storage: range cannot find rev {rp}")
                etype, kv = _decode_event(vs[0])
                if etype == PUT:
                    kvs.append(kv)
        return kvs, rev

    def _put(self, key: bytes, value: bytes, rev: int) -> None:
        sub = self.current_rev.sub
        # Metadata comes from the OPEN generation so that (a) a second put
        # of the same key inside one txn sees the first (same main rev), and
        # (b) a put after a tombstone restarts at version 1.
        meta = self.kvindex.live_meta(key)
        if meta is not None:
            created, ver = meta
            create_rev = created.main
            version = ver + 1
        else:
            create_rev = rev
            version = 1
        kv = KeyValue(key, value, create_rev, rev, version)
        with self.b.batch_tx as tx:
            tx.unsafe_put(KEY_BUCKET, rev_to_bytes(Revision(rev, sub)),
                          _encode_event(PUT, kv))
        self.kvindex.put(key, Revision(rev, sub))
        self.current_rev = Revision(self.current_rev.main, sub + 1)

    def _delete_range(self, key: bytes, end: Optional[bytes],
                      rev: int) -> int:
        rrev = rev
        if self.current_rev.sub > 0:
            rrev += 1
        keys, _ = self.kvindex.range(key, end, rrev)
        n = 0
        for k in keys:
            if self._delete(k, rev):
                n += 1
        return n

    def _delete(self, key: bytes, main_rev: int) -> bool:
        grev = main_rev
        if self.current_rev.sub > 0:
            grev += 1
        try:
            # Dead keys (tombstone ≤ grev) never surface from the index
            # (reference key_index.go findGeneration), so a double delete
            # lands here and is a no-op.
            self.kvindex.get(key, grev)
        except RevisionNotFoundError:
            return False
        sub = self.current_rev.sub
        kv = KeyValue(key, b"", 0, main_rev, 0)  # tombstone: version resets
        with self.b.batch_tx as tx:
            tx.unsafe_put(KEY_BUCKET, rev_to_bytes(Revision(main_rev, sub)),
                          _encode_event(DELETE, kv))
        self.kvindex.tombstone(key, Revision(main_rev, sub))
        self.current_rev = Revision(self.current_rev.main, sub + 1)
        return True

    # -- recovery -----------------------------------------------------------

    def restore(self) -> None:
        """Rebuild index + current revision by scanning the backend, and
        resume a compaction whose scrub didn't finish (goes beyond the
        reference sketch, which has no restart story yet)."""
        with self._mu:
            scheduled = -1
            with self.b.batch_tx as tx:
                _, vs = tx.unsafe_range(META_BUCKET, FINISHED_COMPACT_KEY)
                if vs:
                    self.compact_main_rev = bytes_to_rev(vs[0]).main
                _, vs = tx.unsafe_range(META_BUCKET, SCHEDULED_COMPACT_KEY)
                if vs:
                    scheduled = bytes_to_rev(vs[0]).main
                keys, vals = tx.unsafe_range(
                    KEY_BUCKET, bytes(17),
                    struct.pack(">Q", 2 ** 63 - 1) + b"_" + bytes(8))
            main = 0
            for kb, vb in zip(keys, vals):
                if len(kb) != 17:
                    continue
                rev = bytes_to_rev(kb)
                etype, kv = _decode_event(vb)
                if etype == PUT:
                    self.kvindex.put(kv.key, rev)
                    # A kept record carries its pre-compaction metadata;
                    # seed the rebuilt generation so create_rev/version
                    # stay continuous across restart.
                    if kv.version > 1:
                        ki = self.kvindex._map.get(kv.key)
                        if ki is not None and ki.generations:
                            g = ki.generations[-1]
                            if g.ver < kv.version:
                                g.ver = kv.version
                                g.created = Revision(kv.create_rev, 0)
                else:
                    try:
                        self.kvindex.tombstone(kv.key, rev)
                    except RevisionNotFoundError:
                        # tombstone whose puts were all compacted away
                        pass
                main = max(main, rev.main)
            # The last used main revision is at least the compaction
            # boundary even if every record ≤ it was scrubbed.
            self.current_rev = Revision(
                max(main, self.compact_main_rev, scheduled), 0)
            if scheduled > self.compact_main_rev:
                # Crash mid-scrub: redo the compaction from the schedule
                # marker (deletes are idempotent).
                log.info("storage: resuming interrupted compaction at %d",
                         scheduled)
                self.compact_main_rev = scheduled
                keep = self.kvindex.compact(scheduled)
                t = threading.Thread(target=self._scheduled_compaction,
                                     args=(scheduled, keep), daemon=True,
                                     name="storage-compact-resume")
                self._compact_threads.append(t)
                t.start()

    def close(self) -> None:
        # Let in-flight scrubs finish before the backend goes away; an
        # unfinished scrub is resumed on the next open either way.
        for t in self._compact_threads:
            t.join(timeout=10)
        self.b.close()
