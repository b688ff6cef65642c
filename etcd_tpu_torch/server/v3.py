"""v3 ops through consensus: the serving half of the v3 MVCC preview.

The reference at this vintage ships the v3 RFC (Documentation/rfc/v3api.md,
v3api.proto: Range/Put/DeleteRange/Txn/Compact) and the embryonic storage/
package, but never wires them into etcdserver. This module closes that gap
the way etcd later did: every v3 mutation is a consensus entry, applied
deterministically to a per-member KVStore, with a **consistent index**
recorded transactionally alongside each apply so WAL replay after a crash
never double-applies (double-apply would fork the revision sequence between
members — the exact bug etcd v3's consistentIndex exists to prevent).

Snapshot catch-up: the member snapshot is a COMPOSITE of the v2 store and
the v3 image (server.py:66-75), so a follower that falls behind the
compacted log receives the v3 keyspace with the install and resumes from
the snapshot's consistent index (tests/test_v3_api.py
test_v3_survives_snapshot_catchup). The reference has no v3 serving at
all, so there is no behavior to diverge from.

Op / response shapes follow the RFC proto messages with the etcd JSON
gateway convention: `key`/`value`/`range_end` are base64 strings.
"""
from __future__ import annotations

import base64
import struct
from typing import Any, Dict, List, Optional

from etcd_tpu_torch.storage import CompactedError, KVStore
from etcd_tpu_torch.storage.kvstore import META_BUCKET

CONSISTENT_INDEX_KEY = b"consistentIndex"
LEASE_BUCKET = b"lease"

# Compare targets / results (v3api.proto Compare).
_TARGETS = ("VERSION", "CREATE", "MOD", "VALUE")
_RESULTS = ("EQUAL", "GREATER", "LESS")


def b64e(b: bytes) -> str:
    return base64.b64encode(b).decode()


def b64d(s: str) -> bytes:
    return base64.b64decode(s)


class V3Error(Exception):
    """Maps to an HTTP error payload at the gateway."""

    def __init__(self, code: int, msg: str) -> None:
        super().__init__(msg)
        self.code = code
        self.msg = msg


def _need_b64(op: Dict[str, Any], field: str, required: bool) -> None:
    v = op.get(field)
    if v is None:
        if required:
            raise V3Error(3, f"missing required field {field!r}")
        return
    if not isinstance(v, str):
        raise V3Error(3, f"field {field!r} must be a base64 string")
    try:
        base64.b64decode(v, validate=True)
    except Exception:
        raise V3Error(3, f"field {field!r} is not valid base64")


def _need_int(op: Dict[str, Any], field: str) -> None:
    v = op.get(field)
    if v is None:
        return
    if isinstance(v, bool) or not isinstance(v, int):
        raise V3Error(3, f"field {field!r} must be an integer")


def _need_uint64(op: Dict[str, Any], field: str) -> None:
    """Bounded int: a replicated id outside uint64 would make the 8-byte
    persistence key raise struct.error during APPLY on every member — a
    poison-pill entry. Reject at validation (gateway AND apply)."""
    _need_int(op, field)
    v = op.get(field)
    if v is not None and not 0 <= v < 1 << 64:
        raise V3Error(3, f"field {field!r} must fit in uint64")


def validate_op(op: Dict[str, Any]) -> None:
    """Structural validation of a v3 op. Runs at the GATEWAY (so malformed
    requests are rejected before they enter the consensus log) and again at
    apply time (so a replicated op can never throw a decode error out of
    the apply thread — it is a pure function of the op dict, hence
    deterministic across members and replays)."""
    t = op.get("type")
    if t in ("put",):
        _need_b64(op, "key", required=True)
        _need_b64(op, "value", required=False)
    elif t in ("range", "deleterange"):
        _need_b64(op, "key", required=True)
        _need_b64(op, "range_end", required=False)
        _need_int(op, "limit")
        _need_int(op, "revision")
    elif t == "compact":
        _need_int(op, "revision")
    elif t == "lease_create":
        _need_int(op, "ttl")
        _need_uint64(op, "lease_id")
        if int(op.get("ttl", 0)) <= 0:
            raise V3Error(3, "lease ttl must be > 0")
    elif t == "lease_revoke":
        _need_uint64(op, "lease_id")
        _need_int(op, "seq")
    elif t == "lease_attach":
        _need_uint64(op, "lease_id")
        _need_b64(op, "key", required=True)
    elif t == "lease_keepalive":
        _need_uint64(op, "lease_id")
    elif t == "lease_txn":
        req = op.get("request")
        if not isinstance(req, dict):
            raise V3Error(3, "lease_txn needs a 'request' TxnRequest")
        validate_op({**req, "type": "txn"})
        for branch in ("success", "failure"):
            for a in _need_list(op, branch):
                if not isinstance(a, dict):
                    raise V3Error(3, "attach entries must be objects")
                _need_int(a, "lease_id")
                _need_b64(a, "key", required=True)
    elif t == "txn":
        for c in _need_list(op, "compare"):
            if not isinstance(c, dict):
                raise V3Error(3, "compare entries must be objects")
            if c.get("target", "VALUE") not in _TARGETS or \
                    c.get("result", "EQUAL") not in _RESULTS:
                raise V3Error(3, f"bad compare {c!r}")
            _need_b64(c, "key", required=True)
            _need_b64(c, "value", required=False)
            for f in ("version", "create_revision", "mod_revision"):
                _need_int(c, f)
        for branch in ("success", "failure"):
            for r in _need_list(op, branch):
                if not isinstance(r, dict) or len(r) != 1:
                    raise V3Error(
                        3, "txn requests must hold exactly one of "
                           "request_put/request_range/request_delete_range")
                kind, p = next(iter(r.items()))
                if kind == "request_put":
                    validate_op({**p, "type": "put"})
                elif kind == "request_range":
                    validate_op({**p, "type": "range"})
                elif kind == "request_delete_range":
                    validate_op({**p, "type": "deleterange"})
                else:
                    raise V3Error(3, f"unknown txn request {kind!r}")
    else:
        raise V3Error(3, f"unknown v3 op type {t!r}")


def _need_list(op: Dict[str, Any], field: str) -> List[Any]:
    v = op.get(field, [])
    if not isinstance(v, list):
        raise V3Error(3, f"field {field!r} must be a list")
    return v


class V3Watcher:
    """One watch stream over [key, range_end) from a start revision.
    Events arrive as (revision, [event_dict]) batches in revision order.
    A watcher whose consumer stalls past the queue bound is CANCELLED
    (etcd closes slow watchers rather than buffer without bound)."""

    QUEUE_BOUND = 1024

    def __init__(self, hub: "V3Applier", key: bytes,
                 end: Optional[bytes]) -> None:
        import queue as _q
        self._hub = hub
        self.key = key
        self.end = end
        self.q: "_q.Queue" = _q.Queue(maxsize=self.QUEUE_BOUND)
        self.cancelled = False

    def matches(self, k: bytes) -> bool:
        if self.end is None:
            return k == self.key
        if self.end == b"\x00":   # etcd whole-keyspace sentinel
            return k >= self.key
        return self.key <= k < self.end

    def next_batch(self, timeout: float = 0.5):
        import queue as _q
        try:
            return self.q.get(timeout=timeout)
        except _q.Empty:
            return None

    def remove(self) -> None:
        self._hub._remove_watcher(self)


class V3Applier:
    """Deterministic v3 op application over one member's KVStore."""

    def __init__(self, path: str) -> None:
        import threading
        self._path = path
        self.kv = KVStore(path)
        # Watch hub (the RFC's WatchRange): _published_rev is the fence
        # between historical replay (read from the backend) and live
        # publishes — a watcher registering mid-apply must not see the
        # in-flight revision twice or miss it.
        self._watch_lock = threading.Lock()
        self._watchers: List[V3Watcher] = []
        # Leases (RFC LeaseCreate/Revoke/Attach/KeepAlive): replicated
        # state carries NO clocks — only a renewal sequence number bumped
        # by create/keepalive. The leader alone maps seq transitions to
        # its own clock and proposes seq-FENCED revokes (the v2 SYNC
        # pattern, reference server.go:667-681): a keepalive that commits
        # after the expiry check bumps the seq, so the stale revoke
        # no-ops deterministically on every member. Cross-member clock
        # skew cannot enter the protocol; leadership changes re-base all
        # deadlines on the new leader's clock (leases extend, never
        # silently shorten — etcd's behavior).
        self._lease_lock = threading.Lock()
        self._load_from_backend()

    def _load_from_backend(self) -> None:
        """(Re)load backend-derived state: consistent index, publish fence,
        lease records. Called at boot and after a snapshot install."""
        import json as _json
        self.consistent_index = 0
        with self.kv.b.batch_tx as tx:
            _, vs = tx.unsafe_range(META_BUCKET, CONSISTENT_INDEX_KEY)
        if vs:
            self.consistent_index = struct.unpack(">Q", vs[0])[0]
        self._published_rev = self.kv.current_rev.main
        with self._lease_lock:
            self.leases = {}
            with self.kv.b.batch_tx as tx:
                tx.unsafe_create_bucket(LEASE_BUCKET)
                lkeys, lvals = tx.unsafe_range(LEASE_BUCKET, b"",
                                               b"\xff" * 9)
            for kb, vb in zip(lkeys, lvals):
                self.leases[struct.unpack(">Q", kb)[0]] = _json.loads(vb)

    # -- snapshot integration (closes the v2-snapshot/v3-keyspace hole) ----

    def snapshot_state(self) -> bytes:
        """A point-in-time image of the ENTIRE v3 backend (sqlite
        serialization after force-committing the pending batch) — embedded
        in the member snapshot so a follower that catches up via
        snapshot-install receives the v3 keyspace at exactly the snapshot
        index (consistent index included: it lives inside the image)."""
        self.kv.b.force_commit()
        with self.kv.b.batch_tx.lock:
            return self.kv.b._conn.serialize()

    def install_snapshot(self, blob: bytes) -> None:
        """Replace this member's whole v3 backend with the leader's image:
        close, atomically swap the db file (dropping sqlite sidecars),
        reopen, rebuild the in-memory index and meta. Open watchers keep
        their registration; their next events come from the installed
        state's revision sequence (mirroring the v2 store's watcher
        behavior across Recovery)."""
        import os
        self.kv.close()
        for suf in ("-wal", "-shm"):
            try:
                os.unlink(self._path + suf)
            except FileNotFoundError:
                pass
        tmp = self._path + ".install"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)
        self.kv = KVStore(self._path)
        self._load_from_backend()

    def close(self) -> None:
        self.kv.close()

    # -- watch (RFC WatchRange) --------------------------------------------

    def watch(self, key: bytes, end: Optional[bytes], start_rev: int = 0):
        """Register a watcher. Returns (watcher, replay): replay is None,
        or a lazy generator over the historical (start_rev-1, fence]
        events the CALLER must stream before consuming the queue.

        The fence (_published_rev at registration) splits history from
        live: live events land in the queue, history is read lazily from
        the backend in chunks OUTSIDE the lock — replaying under the lock
        (or into the bounded queue before a consumer exists) would block
        the apply thread's _publish, stalling consensus on this member."""
        w = V3Watcher(self, key, end)
        with self._watch_lock:
            if start_rev > 0 and start_rev <= self.kv.compact_main_rev:
                raise V3Error(11, f"required revision {start_rev} has "
                                  "been compacted")
            fence = self._published_rev
            self._watchers.append(w)
        if start_rev <= 0:
            return w, None

        def replay():
            for rev, evs in self._events_between(start_rev - 1, fence):
                # A compaction landing MID-replay scrubs rows ahead of the
                # cursor; silently yielding the gap-ridden remainder would
                # look like a complete history. Cancel like etcd does
                # (watch canceled with the compact revision).
                if start_rev <= self.kv.compact_main_rev:
                    raise V3Error(11, "watch replay overtaken by "
                                      "compaction; re-watch from a live "
                                      "revision")
                mine = [ev for ev in evs
                        if w.matches(b64d(ev["kv"]["key"]))]
                if mine:
                    yield rev, mine
        return w, replay()

    def _remove_watcher(self, w: V3Watcher) -> None:
        with self._watch_lock:
            if w in self._watchers:
                self._watchers.remove(w)

    def _events_between(self, lo: int, hi: int, chunk: int = 4096):
        """Decoded events grouped by main revision in (lo, hi] — read
        from the backend's revision-ordered key bucket (the WAL of the
        MVCC store) in `chunk`-row pages, so a long historical span never
        loads into memory at once or holds the batch-tx lock for its
        whole length. Yields (rev, [event_dict]) in order."""
        if hi <= lo:
            return
        from etcd_tpu_torch.storage.kvstore import DELETE as EV_DELETE
        from etcd_tpu_torch.storage.kvstore import KEY_BUCKET, _decode_event
        from etcd_tpu_torch.storage.revision import (Revision, bytes_to_rev,
                                               rev_to_bytes)
        cursor = rev_to_bytes(Revision(lo + 1, 0))
        end = rev_to_bytes(Revision(hi + 1, 0))
        cur_rev, batch = None, []
        while True:
            with self.kv.b.batch_tx as tx:
                keys, vals = tx.unsafe_range(KEY_BUCKET, cursor, end,
                                             limit=chunk)
            for kb, vb in zip(keys, vals):
                if len(kb) != 17:
                    continue
                rev = bytes_to_rev(kb)
                etype, kv = _decode_event(vb)
                ev = {"type": "DELETE" if etype == EV_DELETE else "PUT",
                      "kv": self._kv_json(kv)}
                if rev.main != cur_rev:
                    if batch:
                        yield cur_rev, batch
                    cur_rev, batch = rev.main, []
                batch.append(ev)
            if len(keys) < chunk:
                break
            last = bytes_to_rev(keys[-1])
            cursor = rev_to_bytes(Revision(last.main, last.sub + 1))
        if batch:
            yield cur_rev, batch

    def _publish(self, lo: int, hi: int) -> None:
        """Fan out the events a just-finished apply produced in (lo, hi]."""
        import queue as _q
        with self._watch_lock:
            if self._watchers:   # no watchers: skip the backend re-read
                dead = []
                for rev, evs in self._events_between(lo, hi):
                    for w in self._watchers:
                        mine = [e for e in evs
                                if w.matches(b64d(e["kv"]["key"]))]
                        if mine:
                            try:
                                w.q.put_nowait((rev, mine))
                            except _q.Full:
                                # Consumer stalled past the bound: cancel
                                # the watcher instead of buffering forever
                                # (its stream loop sees `cancelled`).
                                w.cancelled = True
                                dead.append(w)
                for w in dead:
                    if w in self._watchers:
                        self._watchers.remove(w)
            self._published_rev = max(self._published_rev, hi)

    # -- reads (serializable; linearizable reads ride apply()) --------------

    def range(self, op: Dict[str, Any]) -> Dict[str, Any]:
        key = b64d(op.get("key", ""))
        end = b64d(op["range_end"]) if op.get("range_end") else None
        limit = int(op.get("limit", 0))
        rev = int(op.get("revision", 0))
        try:
            kvs, cur = self.kv.range(key, end, limit=limit, range_rev=rev)
            # `count` is the TOTAL matching the range (ignoring limit) and
            # `more` only true when keys were actually truncated (etcd
            # gateway semantics). The total comes from the in-memory index
            # (no backend value reads), and only when the limit bound.
            total = (self.kv.count(key, end, range_rev=cur)
                     if limit and len(kvs) == limit else len(kvs))
        except CompactedError as e:
            raise V3Error(11, f"required revision {e.args[0]} has been "
                              "compacted")
        return {
            "header": {"revision": cur},
            "kvs": [self._kv_json(kv) for kv in kvs],
            "count": total,
            "more": total > len(kvs),
        }

    @staticmethod
    def _kv_json(kv) -> Dict[str, Any]:
        return {"key": b64e(kv.key), "value": b64e(kv.value),
                "create_revision": kv.create_rev,
                "mod_revision": kv.mod_rev, "version": kv.version}

    # -- the replicated apply ----------------------------------------------

    def apply(self, op: Dict[str, Any], index: int) -> Dict[str, Any]:
        """Apply one committed v3 op at raft entry `index`. Idempotent:
        entries at or below the consistent index were already applied in a
        previous life and are skipped (reference-future consistentIndex
        semantics).

        The whole apply runs inside batch_tx.hold(): the mutation and the
        consistent-index record land in ONE sqlite commit, so a crash can
        never persist one without the other (a split would double-apply on
        replay and fork the revision sequence between members)."""
        if index <= self.consistent_index:
            return {"skipped": True, "header":
                    {"revision": self.kv.current_rev.main}}
        validate_op(op)       # deterministic; malformed ops error, don't
        #                       kill the apply thread
        if op.get("type") == "range":
            # Read-only: replaying a range is harmless, so it needs no
            # consistent-index record — recording one would turn every
            # linearizable read into a durable write on every member.
            return self.range(op)
        rev0 = self.kv.current_rev.main
        with self.kv.atomic() as tx:
            try:
                result = self._dispatch(op)
            except V3Error:
                # Deterministic outcome (a pure function of op + store
                # state): every member and every replay resolves it
                # identically, so the index advances. No mutation has
                # executed when a V3Error is raised (all checks precede
                # writes; txn requests are pre-validated).
                self._record_index(tx, index)
                raise
            except Exception:
                # Environmental (disk I/O, corruption): discard the whole
                # un-committed batch so the timer can't durably commit a
                # half-applied op after the apply thread dies, skip the
                # index record, and let the caller crash the member —
                # restart replays the entry from the last commit boundary.
                self.kv.b.rollback()
                raise
            if self.kv.current_rev.main > rev0:
                self._detach_deleted(rev0, self.kv.current_rev.main)
            self._record_index(tx, index)
        rev1 = self.kv.current_rev.main
        if rev1 > rev0:
            self._publish(rev0, rev1)
        return result

    def _record_index(self, tx, index: int) -> None:
        self.consistent_index = index
        tx.unsafe_put(META_BUCKET, CONSISTENT_INDEX_KEY,
                      struct.pack(">Q", index))

    def _dispatch(self, op: Dict[str, Any]) -> Dict[str, Any]:
        t = op.get("type")
        if t == "put":
            rev = self.kv.put(b64d(op["key"]), b64d(op.get("value", "")))
            return {"header": {"revision": rev}}
        if t == "deleterange":
            end = b64d(op["range_end"]) if op.get("range_end") else None
            n, rev = self.kv.delete_range(b64d(op["key"]), end)
            return {"header": {"revision": rev}, "deleted": n}
        if t == "compact":
            rev = int(op.get("revision", 0))
            try:
                self.kv.compact(rev)
            except CompactedError:
                raise V3Error(11, f"revision {rev} has been compacted")
            except ValueError as e:
                raise V3Error(3, str(e))
            return {"header": {"revision": self.kv.current_rev.main}}
        if t == "txn":
            return self._apply_txn(op)
        if t == "lease_txn":
            return self._apply_lease_txn(op)
        if t.startswith("lease_"):
            return self._apply_lease(t, op)
        raise V3Error(3, f"unknown v3 op type {t!r}")

    def _apply_lease_txn(self, op: Dict[str, Any]) -> Dict[str, Any]:
        """RFC LeaseTnx: a Tnx plus success/failure LeaseAttachRequest
        lists; the winning branch's attaches execute with the txn. Every
        referenced lease is checked BEFORE the txn runs so a bad attach
        cannot abort a txn that already mutated (all-or-nothing)."""
        with self._lease_lock:
            for branch in ("success", "failure"):
                for a in op.get(branch, []):
                    lid = int(a.get("lease_id", 0))
                    if lid not in self.leases:
                        raise V3Error(5, f"lease {lid:x} not found")
        txn_resp = self._apply_txn(op["request"])
        attaches = op.get("success" if txn_resp["succeeded"] else "failure",
                          [])
        attach_responses = []
        for a in attaches:
            attach_responses.append(
                self._apply_lease("lease_attach",
                                  {"lease_id": int(a["lease_id"]),
                                   "key": a["key"]}))
        return {"header": self._hdr(), "response": txn_resp,
                "attach_responses": attach_responses}

    # -- leases -------------------------------------------------------------

    def _persist_lease(self, lid: int, rec: Optional[dict]) -> None:
        import json as _json
        with self.kv.b.batch_tx as tx:
            if rec is None:
                tx.unsafe_delete(LEASE_BUCKET, struct.pack(">Q", lid))
            else:
                tx.unsafe_put(LEASE_BUCKET, struct.pack(">Q", lid),
                              _json.dumps(rec).encode())

    def _apply_lease(self, t: str, op: Dict[str, Any]) -> Dict[str, Any]:
        lid = int(op.get("lease_id", 0))
        with self._lease_lock:
            if t == "lease_create":
                if lid in self.leases:
                    raise V3Error(3, f"lease {lid:x} already exists")
                rec = {"ttl": int(op["ttl"]), "seq": 0, "keys": []}
                self.leases[lid] = rec
                self._persist_lease(lid, rec)
                return {"header": self._hdr(), "lease_id": lid,
                        "ttl": rec["ttl"], "seq": 0}
            rec = self.leases.get(lid)
            if rec is None:
                raise V3Error(5, f"lease {lid:x} not found")
            if t == "lease_keepalive":
                rec["seq"] += 1
                self._persist_lease(lid, rec)
                return {"header": self._hdr(), "lease_id": lid,
                        "ttl": rec["ttl"], "seq": rec["seq"]}
            if t == "lease_attach":
                # Canonicalize at the boundary: b64decode(validate=True)
                # accepts non-canonical encodings (nonzero trailing bits,
                # e.g. 'YR==' == b'a'), and _detach_deleted compares
                # against canonically re-encoded event keys — a verbatim
                # non-canonical attach would never detach on delete, and a
                # later revoke would delete an unrelated re-created key.
                k64 = b64e(b64d(op["key"]))
                if k64 not in rec["keys"]:
                    rec["keys"].append(k64)
                self._persist_lease(lid, rec)
                return {"header": self._hdr(), "lease_id": lid}
            # lease_revoke. The seq fence: an expiry-driven revoke carries
            # the seq the leader observed; a keepalive that committed in
            # between bumped it, so the stale revoke must NOT fire (the
            # client already got a successful renewal ack).
            if "seq" in op and int(op["seq"]) != rec["seq"]:
                return {"header": self._hdr(), "lease_id": lid,
                        "renewed": True}
            # Delete every attached key at ONE revision, then drop the
            # lease (RFC: "All keys attached to the lease will be expired
            # and deleted").
            tid = self.kv.txn_begin()
            try:
                for k64 in rec["keys"]:
                    self.kv.txn_delete_range(tid, b64d(k64))
            finally:
                self.kv.txn_end(tid)
            del self.leases[lid]
            self._persist_lease(lid, None)
            return {"header": self._hdr(), "lease_id": lid}

    def _hdr(self) -> Dict[str, int]:
        return {"revision": self.kv.current_rev.main}

    def lease_seqs(self) -> Dict[int, int]:
        """Snapshot of (lease_id -> renewal seq) for the leader's expiry
        monitor."""
        with self._lease_lock:
            return {lid: rec["seq"] for lid, rec in self.leases.items()}

    def lease_ttl(self, lid: int) -> Optional[int]:
        with self._lease_lock:
            rec = self.leases.get(lid)
            return None if rec is None else rec["ttl"]

    def _detach_deleted(self, lo: int, hi: int) -> None:
        """Detach keys deleted in (lo, hi] from every lease: a later
        revoke must not delete an unrelated key re-created under the same
        name (etcd detaches on delete for the same reason). Runs inside
        the apply's atomic block so the lease-record updates land in the
        same commit."""
        with self._lease_lock:
            if not any(rec["keys"] for rec in self.leases.values()):
                return
            deleted = set()
            for _, evs in self._events_between(lo, hi):
                for ev in evs:
                    if ev["type"] == "DELETE":
                        deleted.add(ev["kv"]["key"])
            if not deleted:
                return
            for lid, rec in self.leases.items():
                kept = [k for k in rec["keys"] if k not in deleted]
                if len(kept) != len(rec["keys"]):
                    rec["keys"] = kept
                    self._persist_lease(lid, rec)

    # -- txn ----------------------------------------------------------------

    def _apply_txn(self, op: Dict[str, Any]) -> Dict[str, Any]:
        succeeded = all(self._check(c) for c in op.get("compare", []))
        reqs: List[Dict[str, Any]] = op.get(
            "success" if succeeded else "failure", [])
        # Atomicity: errors must not abort a txn after it mutated (etcd
        # txns are all-or-nothing). validate_op covers structure pre-txn;
        # EXPLICIT compacted range revisions are checked here because they
        # can fail even after a mutation ran. The remaining case — a
        # head-revision (rr==0) range on a head-compacted store — is safe
        # to catch mid-loop: it can only fire while sub==0, i.e. before
        # ANY mutation executed (a mutation bumps sub, which pushes the
        # resolved read revision past the compaction boundary), so
        # aborting there is atomic and deterministic.
        for r in reqs:
            if "request_range" in r:
                rr = int(r["request_range"].get("revision", 0))
                if 0 < rr <= self.kv.compact_main_rev:
                    raise V3Error(11, f"required revision {rr} has been "
                                      "compacted")
        tid = self.kv.txn_begin()
        responses = []
        try:
            for r in reqs:
                if "request_put" in r:
                    p = r["request_put"]
                    rev = self.kv.txn_put(tid, b64d(p["key"]),
                                          b64d(p.get("value", "")))
                    responses.append(
                        {"response_put": {"header": {"revision": rev}}})
                elif "request_delete_range" in r:
                    p = r["request_delete_range"]
                    end = (b64d(p["range_end"])
                           if p.get("range_end") else None)
                    n, rev = self.kv.txn_delete_range(tid, b64d(p["key"]),
                                                      end)
                    responses.append({"response_delete_range":
                                      {"header": {"revision": rev},
                                       "deleted": n}})
                elif "request_range" in r:
                    p = r["request_range"]
                    end = (b64d(p["range_end"])
                           if p.get("range_end") else None)
                    lim = int(p.get("limit", 0))
                    try:
                        kvs, cur = self.kv.txn_range(
                            tid, b64d(p["key"]), end, limit=lim,
                            range_rev=int(p.get("revision", 0)))
                        total = (self.kv.count(b64d(p["key"]), end,
                                               range_rev=cur)
                                 if lim and len(kvs) == lim else len(kvs))
                    except CompactedError:
                        # Head-compacted store: only reachable with sub==0
                        # (nothing mutated yet — see precheck comment), so
                        # this abort is atomic.
                        raise V3Error(11, "required revision has been "
                                          "compacted")
                    responses.append({"response_range": {
                        "header": {"revision": cur},
                        "kvs": [self._kv_json(kv) for kv in kvs],
                        "count": total,
                        "more": total > len(kvs)}})
                else:
                    raise V3Error(3, f"unknown txn request {r!r}")
        finally:
            self.kv.txn_end(tid)
        return {"header": {"revision": self.kv.current_rev.main},
                "succeeded": succeeded, "responses": responses}

    def _check(self, c: Dict[str, Any]) -> bool:
        target = c.get("target", "VALUE")
        result = c.get("result", "EQUAL")
        if target not in _TARGETS or result not in _RESULTS:
            raise V3Error(3, f"bad compare {c!r}")
        try:
            kvs, _ = self.kv.range(b64d(c["key"]))
        except CompactedError:
            # Head-compacted store: the compare itself reads at a
            # compacted revision. Deterministic -> a V3Error, never an
            # apply-thread fatal.
            raise V3Error(11, "required revision has been compacted")
        if target == "VALUE":
            have: Any = kvs[0].value if kvs else b""
            want: Any = b64d(c.get("value", ""))
        else:
            have = {"VERSION": kvs[0].version if kvs else 0,
                    "CREATE": kvs[0].create_rev if kvs else 0,
                    "MOD": kvs[0].mod_rev if kvs else 0}[target]
            want = int(c.get({"VERSION": "version",
                              "CREATE": "create_revision",
                              "MOD": "mod_revision"}[target], 0))
        if result == "EQUAL":
            return have == want
        if result == "GREATER":
            return have > want
        return have < want
