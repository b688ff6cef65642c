"""Disk backend for the v3 MVCC store.

Behavioral equivalent of reference storage/backend/{backend,batch_tx}.go,
which wraps boltdb: named buckets of ordered byte keys, a single write
"batch transaction" that accumulates puts/deletes and commits either every
``batch_interval`` (100ms there) via a background thread or after
``batch_limit`` operations (10000 there), plus ForceCommit.

The bolt analogue here is stdlib **sqlite3**: one table per bucket with a
BLOB primary key (sqlite's B-tree gives the same ordered-range scans), one
writer connection guarded by the tx lock, commits batched exactly like the
reference. Readers go through the same batch tx (reference semantics — the
embryonic v3 has no read-only snapshot txs yet).
"""
from __future__ import annotations

import contextlib
import os
import sqlite3
import threading
from typing import Dict, List, Optional, Tuple

DEFAULT_BATCH_INTERVAL = 0.1     # reference kvstore.go:16
DEFAULT_BATCH_LIMIT = 10000      # reference kvstore.go:15


def _table(bucket: bytes) -> str:
    # bucket names are code-controlled identifiers ("key", "meta")
    name = bucket.decode()
    if not name.isidentifier():
        raise ValueError(f"invalid bucket name {bucket!r}")
    return f"bucket_{name}"


class BatchTx:
    """The single write transaction; take .lock around Unsafe* calls
    (reference batch_tx.go). The lock is re-entrant so a caller can hold()
    it across several Unsafe* groups to make them one atomic commit unit."""

    def __init__(self, backend: "Backend") -> None:
        self.lock = threading.RLock()
        self._b = backend
        self._pending = 0
        self._hold = 0

    def __enter__(self):
        self.lock.acquire()
        return self

    def __exit__(self, *exc):
        self.lock.release()

    @contextlib.contextmanager
    def hold(self):
        """Atomic section: while held, nothing can commit — not the timer
        (blocked on the re-entrant lock) and not the batch-limit flush
        (suppressed) — so every write inside lands in ONE sqlite commit.
        Used by the v3 apply path to bind a mutation to its consistent
        index: committing one without the other would double-apply on
        replay."""
        self.lock.acquire()
        self._hold += 1
        try:
            yield self
        finally:
            self._hold -= 1
            self.lock.release()

    def unsafe_create_bucket(self, bucket: bytes) -> None:
        self._b._conn.execute(
            f"CREATE TABLE IF NOT EXISTS {_table(bucket)} "
            f"(k BLOB PRIMARY KEY, v BLOB) WITHOUT ROWID")

    def unsafe_put(self, bucket: bytes, key: bytes, value: bytes) -> None:
        self._b._conn.execute(
            f"INSERT OR REPLACE INTO {_table(bucket)} VALUES (?, ?)",
            (key, value))
        self._pending += 1
        if self._pending > self._b.batch_limit and not self._hold:
            self._commit()

    def unsafe_delete(self, bucket: bytes, key: bytes) -> None:
        self._b._conn.execute(
            f"DELETE FROM {_table(bucket)} WHERE k = ?", (key,))
        self._pending += 1
        if self._pending > self._b.batch_limit and not self._hold:
            self._commit()

    def unsafe_range(self, bucket: bytes, key: bytes,
                     end_key: Optional[bytes] = None, limit: int = 0
                     ) -> Tuple[List[bytes], List[bytes]]:
        """Point get (end_key None) or half-open scan [key, end_key)
        (reference batch_tx.go UnsafeRange)."""
        t = _table(bucket)
        if end_key is None:
            row = self._b._conn.execute(
                f"SELECT k, v FROM {t} WHERE k = ?", (key,)).fetchone()
            return ([row[0]], [row[1]]) if row else ([], [])
        q = f"SELECT k, v FROM {t} WHERE k >= ? AND k < ? ORDER BY k"
        args: tuple = (key, end_key)
        if limit > 0:
            q += " LIMIT ?"
            args += (limit,)
        rows = self._b._conn.execute(q, args).fetchall()
        return [r[0] for r in rows], [r[1] for r in rows]

    def commit(self) -> None:
        with self.lock:
            self._commit()

    def _commit(self) -> None:
        self._b._conn.commit()
        self._pending = 0


class Backend:
    def __init__(self, path: str,
                 batch_interval: float = DEFAULT_BATCH_INTERVAL,
                 batch_limit: int = DEFAULT_BATCH_LIMIT) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     isolation_level="DEFERRED")
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self.batch_limit = batch_limit
        self.batch_interval = batch_interval
        self.batch_tx = BatchTx(self)
        self._closed = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="storage-backend")
        self._thread.start()

    def _run(self) -> None:
        # periodic commit loop (reference backend.go:58-73)
        while not self._stop.wait(self.batch_interval):
            try:
                self.batch_tx.commit()
            except sqlite3.ProgrammingError:
                return  # closed under us

    def force_commit(self) -> None:
        self.batch_tx.commit()

    def rollback(self) -> None:
        """Discard the un-committed batch (everything since the last
        commit). Used on environmental apply failures: the alternative —
        letting the timer commit a half-applied transaction after the
        apply thread died — would make the partial state durable and fork
        the member from its peers; discarding it is equivalent to a crash
        at the last commit boundary, which WAL replay covers."""
        with self.batch_tx.lock:
            self._conn.rollback()
            self.batch_tx._pending = 0

    def close(self) -> None:
        """Idempotent: callers (e.g. EtcdServer.stop) may run twice — a
        restart test stops the old member, then its fixture stops again.
        The closed connection object is kept so racing users still get
        sqlite3.ProgrammingError (which the commit/scrub loops catch)."""
        self._stop.set()
        self._thread.join(timeout=5)
        with self.batch_tx.lock:
            if self._closed:
                return
            self._closed = True
            self._conn.commit()
            self._conn.close()
