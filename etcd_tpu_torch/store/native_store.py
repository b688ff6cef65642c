"""NativeStore: the v2 store backed by the C node-tree core.

Drop-in replacement for `store.Store` on the multi-tenant engine's apply
hot path (reference store/store.go:66-677): the tree, TTL heap, op stats
AND the event-history ring live in `etcd_tpu.native.storecore` (one C
call per op, atomic under the GIL), while watcher registration/fan-out
stays in the unchanged Python `WatcherHub`. The C ring retains the
descriptor tuples every mutation already builds, so `watch ?waitIndex=`
scans replay history without the store ever materializing Event objects
for writes nobody is waiting on — that is what `set_applied` (the engine
apply loop's entry point) exploits. Semantics are pinned by running the
full Python-store test matrix against this class plus a randomized
differential test (tests/test_native_store.py).

Why the split: profiling the engine apply loop showed ~13 µs/request
in-situ spent in the Python store (tree-walk dict churn, dataclass
allocs, lock/stat overhead, cache misses across thousands of tenant
stores); the C core cuts the per-op tree work to <1 µs and the facade
only pays for Event objects when the API contract actually needs them.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, List, Optional

from etcd_tpu_torch.store import event as ev
from etcd_tpu_torch.store.event import Event, LazyWriteEvent, NodeExtern, ttl_of
from etcd_tpu_torch.store.store import Stats, normalize
from etcd_tpu_torch.store.watcher import Watcher, WatcherHub

from etcd_tpu_torch.native.storecore import Core  # type: ignore

# Action strings indexed by the C core's ACT_* codes.
_ACTIONS = (ev.SET, ev.CREATE, ev.UPDATE, ev.COMPARE_AND_SWAP, ev.DELETE,
            ev.COMPARE_AND_DELETE, ev.EXPIRE)


def _norm(p: str) -> str:
    """normalize() with a fast path for already-canonical paths (the apply
    loop's keys are normalized at parse time; full posixpath.normpath costs
    ~1 µs — a third of the native op budget)."""
    if (p and p[0] == "/" and (len(p) == 1 or p[-1] != "/")
            and "//" not in p and "/./" not in p and "/../" not in p
            and not p.endswith("/.") and not p.endswith("/..")):
        return p
    return normalize(p)


def _extern(d, now: float) -> NodeExtern:
    """desc 6-tuple -> NodeExtern (no children)."""
    key, value, is_dir, created, modified, exp = d
    return NodeExtern(key, value, is_dir, None, created, modified, exp,
                      ttl_of(exp, now))


def _extern_tree(t, now: float) -> NodeExtern:
    """get() 7-tuple -> NodeExtern with materialized children."""
    key, value, is_dir, created, modified, exp, kids = t
    ex = NodeExtern(key, value, is_dir, None, created, modified, exp,
                    ttl_of(exp, now))
    if kids is not None:
        ex.nodes = [_extern_tree(k, now) for k in kids]
    return ex


def _ring_event(rec) -> Event:
    """C ring record -> Event (same shape the Python store retained)."""
    action, nd, pd, idx, now = rec
    act = _ACTIONS[action]
    node = _extern(nd, now)
    return Event(act, node=node,
                 prev_node=None if pd is None else _extern(pd, now),
                 etcd_index=idx)


class _CHistory:
    """EventHistory facade over the C ring (scan/bounds only: records are
    appended inside the C mutation ops)."""

    def __init__(self, core, capacity: int) -> None:
        self._core = core
        self.capacity = capacity

    @property
    def start_index(self) -> int:
        return self._core.ring_bounds()[0]

    @property
    def last_index(self) -> int:
        return self._core.ring_bounds()[1]

    def __len__(self) -> int:
        return self._core.ring_bounds()[2]

    def scan(self, key: str, recursive: bool, since: int):
        rec = self._core.scan(key, recursive, since)
        return None if rec is None else _ring_event(rec)


class _NativeHub(WatcherHub):
    """WatcherHub whose history lives in the C ring: the record was
    appended by the C op itself, so the history hook is a no-op and
    `notify` inherits only the ancestor-walk fan-out."""

    def __init__(self, core, history_capacity: int) -> None:
        super().__init__(history_capacity)
        self.event_history = _CHistory(core, history_capacity)

    def _record(self, e: Event) -> Event:
        return e

    def quiet(self) -> bool:
        """True iff no watcher is registered, read under the hub lock.
        Callers use this AFTER the C mutation: a watch() in progress
        either completes registration first (we see it and notify) or
        starts its history scan after our ring append (it replays the
        event) — either way nothing is lost. An unlocked count read
        could interleave between a watcher's scan and its registration
        and drop the event forever."""
        with self._lock:
            return self.count == 0


class _NativeStats(Stats):
    """Stats view over the C counters; `watchers` stays Python-side."""

    def __init__(self, core) -> None:
        self._core = core
        self.watchers = 0

    def __getattr__(self, name: str):
        try:
            i = Stats.FIELDS.index(name)
        except ValueError:
            raise AttributeError(name) from None
        return self._core.stats()[i]

    def inc(self, field: str) -> None:  # used by tests / aux paths only
        i = Stats.FIELDS.index(field)
        vals = list(self._core.stats())
        vals[i] += 1
        self._core.set_stats(tuple(vals))

    def to_dict(self) -> dict:
        vals = self._core.stats()
        d = dict(zip(Stats.FIELDS, vals))
        d["watchers"] = self.watchers
        return d


class NativeStore:
    """Same public surface as `store.Store` (reference store.Store iface
    store/store.go:40-64); see module docstring for the C/Python split."""

    def __init__(self, history_capacity: int = ev.DEFAULT_HISTORY_CAPACITY,
                 clock: Callable[[], float] = time.time,
                 namespaces: tuple = ()) -> None:
        self.clock = clock
        self.namespaces = tuple(namespaces)
        self._core = Core(namespaces=self.namespaces,
                          history_capacity=history_capacity)
        self.watcher_hub = _NativeHub(self._core, history_capacity)
        self.stats = _NativeStats(self._core)
        # compound (multi-C-call) ops only; single ops are GIL-atomic
        self._biglock = threading.RLock()

    # -- index ---------------------------------------------------------------

    @property
    def current_index(self) -> int:
        return self._core.index

    @current_index.setter
    def current_index(self, v: int) -> None:
        self._core.index = v

    # -- reads ---------------------------------------------------------------

    def get(self, node_path: str, recursive: bool = False,
            want_sorted: bool = False) -> Event:
        t, idx = self._core.get(_norm(node_path), recursive, want_sorted)
        return Event(ev.GET, node=_extern_tree(t, self.clock()),
                     etcd_index=idx)

    def watch(self, key: str, recursive: bool = False, stream: bool = False,
              since_index: int = 0) -> Watcher:
        key = _norm(key)
        w = self.watcher_hub.watch(key, recursive, stream, since_index,
                                   self._core.index)
        self.stats.watchers = self.watcher_hub.count
        return w

    # -- the engine apply fast path ------------------------------------------

    def set_applied(self, node_path: str, value: str,
                    expire_time: Optional[float],
                    need_event: bool) -> Optional[Event]:
        """PUT-set on the apply loop: history is recorded by the C op
        either way; the Event (2 NodeExterns + dataclass churn) is built
        only when a waiter needs the result or a watcher needs the
        fan-out. Returns None when skipped. Mutate FIRST, decide after:
        the skip check must not race watch registration (see
        _NativeHub.quiet)."""
        now = self.clock()
        nd, pd, idx = self._core.set(_norm(node_path), False, value,
                                     expire_time, now)
        hub = self.watcher_hub
        if not need_event and hub.quiet():
            return None
        e = Event(ev.SET, node=_extern(nd, now),
                  prev_node=None if pd is None else _extern(pd, now),
                  etcd_index=idx)
        hub.notify(e)
        return e

    def set_applied_lazy(self, node_path: str, value: str,
                         expire_time: Optional[float]):
        """set_applied for a WAITER-HELD plain PUT: same C mutation and
        ring append, but when no watcher is live the waiter gets the raw
        descriptors wrapped in a LazyWriteEvent — the Event/NodeExtern
        churn moves onto the HTTP thread that resolves it (do()). With a
        live watcher the Event is built here anyway (fan-out needs it)
        and returned directly; callers treat both shapes uniformly."""
        now = self.clock()
        nd, pd, idx = self._core.set(_norm(node_path), False, value,
                                     expire_time, now)
        hub = self.watcher_hub
        if hub.quiet():
            return LazyWriteEvent(nd, pd, idx, now)
        e = Event(ev.SET, node=_extern(nd, now),
                  prev_node=None if pd is None else _extern(pd, now),
                  etcd_index=idx)
        hub.notify(e)
        return e

    def set_applied_many(self, paths: List[str], values: List[str],
                         need: Optional[List[int]] = None):
        """Batched plain-file PUTs for the engine apply loop: ONE
        GIL-atomic C call applies the whole batch (per-op etcd errors fail
        that op exactly like the scalar call — stats counted, index
        unmoved — and the batch continues). History is recorded per op in
        the C ring. Callers guarantee no waiter needs a per-op result
        (those requests take set_applied).

        Watchers: if any is live BEFORE the mutation, the C call collects
        per-op records and every event is notified from them in order —
        O(n), and immune to a batch larger than the history ring evicting
        its own earliest records. A watcher that registers in the window
        between the check and the GIL-atomic C call is caught by the
        post-check and notified from the ring; if that same oversized
        batch already evicted part of its own span from the ring, a live
        stream watcher could otherwise miss the evicted events with no
        signal (the reference notifies per-op, so a registered watcher
        never misses; its 401 EventIndexCleared only covers NEW waitIndex
        registrations, store/event_history.go) — so in that corner the
        hub is cleared: every raced watcher wakes with the
        WATCHER_CLEARED sentinel and re-registers, and a stale waitIndex
        then gets the honest 401.

        `need`, when given, lists batch positions whose callers hold a
        waiter: the C call returns a desc entry per listed position —
        `(pos, nd, pd|None, index)` for an applied op, or
        `(pos, None, (code, cause), index_at_failure)` for a per-op etcd
        failure — and the return becomes `(applied, descs)` so the
        applier can wake each waiter with raw descriptors instead of a
        materialized Event. Without `need`, returns the number applied
        (unchanged contract)."""
        now = self.clock()
        hub = self.watcher_hub
        want_recs = not hub.quiet()
        # Inline canonical-path fast check: one "//" scan + one "." scan
        # (no dots rules out every "." / ".." segment form at once)
        # instead of a _norm() call per request — the call alone was
        # ~35% of this method's time at deep-queue load (1 M calls/s).
        norm = _norm
        first, last, failed, recs, descs = self._core.set_many(
            [p if (p and p[0] == "/" and p[-1] != "/" and "//" not in p
                   and "." not in p) else norm(p) for p in paths],
            values, now, want_recs, need)
        applied = len(paths) - failed
        if last < first:
            return applied if need is None else (applied, descs)
        if recs is not None:
            if not hub.quiet():
                for nd, pd, idx in recs:
                    hub.notify(Event(
                        ev.SET, node=_extern(nd, now),
                        prev_node=None if pd is None else _extern(pd, now),
                        etcd_index=idx))
        elif not hub.quiet():
            # Registration raced the atomic batch; replay what the ring
            # still holds (single pass over the clamped span).
            lo = max(first, self._core.ring_bounds()[0])
            if lo > first:
                # The batch evicted part of its own span: a stream
                # watcher that registered mid-batch would silently skip
                # the evicted events. Resync instead of lying: wake every
                # watcher with the cleared sentinel (store Recovery
                # semantics); re-registration with a stale waitIndex gets
                # 401 EventIndexCleared from the next scan.
                hub.clear()
                return applied if need is None else (applied, descs)
            scan = hub.event_history.scan
            for i in range(lo, last + 1):
                e = scan("/", True, i)
                if e is not None and e.etcd_index <= last:
                    hub.notify(e)
        return applied if need is None else (applied, descs)

    # -- mutations -----------------------------------------------------------

    def set(self, node_path: str, is_dir: bool = False, value: str = "",
            expire_time: Optional[float] = None) -> Event:
        now = self.clock()
        nd, pd, idx = self._core.set(_norm(node_path), is_dir, value,
                                     expire_time, now)
        e = Event(ev.SET, node=_extern(nd, now),
                  prev_node=None if pd is None else _extern(pd, now),
                  etcd_index=idx)
        self.watcher_hub.notify(e)
        return e

    def create(self, node_path: str, is_dir: bool = False,
               value: str = "", unique: bool = False,
               expire_time: Optional[float] = None) -> Event:
        path = _norm(node_path)
        if unique:
            # in-order key named by the creation index (CreateInOrder)
            path = f"{path.rstrip('/') or ''}/{self._core.index + 1:020d}"
        now = self.clock()
        nd, _, idx = self._core.create(path, is_dir, value, expire_time,
                                       now)
        e = Event(ev.CREATE, node=_extern(nd, now), etcd_index=idx)
        self.watcher_hub.notify(e)
        return e

    def update(self, node_path: str, value: Optional[str] = None,
               expire_time: Optional[float] = None,
               refresh: bool = False) -> Event:
        now = self.clock()
        nd, pd, idx = self._core.update(_norm(node_path), value, refresh,
                                        expire_time, now)
        e = Event(ev.UPDATE, node=_extern(nd, now),
                  prev_node=_extern(pd, now), etcd_index=idx)
        if not refresh:  # refresh moves only the TTL: watchers stay silent
            self.watcher_hub.notify(e)
        return e

    def compare_and_swap(self, node_path: str, prev_value: str,
                         prev_index: int, value: str,
                         expire_time: Optional[float] = None) -> Event:
        now = self.clock()
        nd, pd, idx = self._core.cas(_norm(node_path), prev_value,
                                     prev_index or 0, value, expire_time,
                                     now)
        e = Event(ev.COMPARE_AND_SWAP, node=_extern(nd, now),
                  prev_node=_extern(pd, now), etcd_index=idx)
        self.watcher_hub.notify(e)
        return e

    def delete(self, node_path: str, is_dir: bool = False,
               recursive: bool = False) -> Event:
        hub = self.watcher_hub
        now = self.clock()
        # removed paths are ALWAYS collected: deciding by a pre-mutation
        # watcher-count read races watch registration (a watcher on a
        # child path registered mid-delete would miss its deleted=True
        # force-notify with no ring record to replay it). Deletes are
        # rare next to sets; the collection cost is acceptable.
        (nd, pd, idx), removed = self._core.delete(
            _norm(node_path), is_dir, recursive, True, now)
        key, _, was_dir, created, modified, _ = nd
        node_ex = NodeExtern(key=key, dir=was_dir, created_index=created,
                             modified_index=modified)
        e = Event(ev.DELETE, node=node_ex, prev_node=_extern(pd, now))
        e.etcd_index = idx
        if not hub.quiet():
            # per-removed-node force-notify (watcher_hub notifyWatchers
            # deleted=True); dedup in Watcher handles the double walk
            for path in removed:
                hub.notify_with_path(e, path, True)
        hub.notify(e)
        return e

    def compare_and_delete(self, node_path: str, prev_value: str,
                           prev_index: int) -> Event:
        now = self.clock()
        nd, pd, idx = self._core.cad(_norm(node_path), prev_value,
                                     prev_index or 0, now)
        key, _, _, created, modified, _ = nd
        node_ex = NodeExtern(key=key, created_index=created,
                             modified_index=modified)
        e = Event(ev.COMPARE_AND_DELETE, node=node_ex,
                  prev_node=_extern(pd, now))
        e.etcd_index = idx
        self.watcher_hub.notify(e)
        return e

    def delete_expired_keys(self, cutoff: float) -> List[Event]:
        out: List[Event] = []
        hub = self.watcher_hub
        for nd, pd, removed, idx in self._core.expire_keys(cutoff):
            key, _, was_dir, created, modified, _ = nd
            node_ex = NodeExtern(key=key, dir=was_dir, created_index=created,
                                 modified_index=modified)
            e = Event(ev.EXPIRE, node=node_ex,
                      prev_node=_extern(pd, cutoff), etcd_index=idx)
            if not hub.quiet():  # post-mutation check (see delete())
                for path in removed:
                    hub.notify_with_path(e, path, True)
            hub.notify(e)
            out.append(e)
        return out

    # -- persistence ---------------------------------------------------------

    def save(self) -> bytes:
        with self._biglock:
            return json.dumps({
                "version": 2,
                "currentIndex": self._core.index,
                "root": _json_of(self._core.dump()),
                "stats": self.stats.to_dict(),
            }).encode()

    def clone(self) -> "NativeStore":
        with self._biglock:
            s = NativeStore(self.watcher_hub.event_history.capacity,
                            self.clock, namespaces=self.namespaces)
            s._core = self._core.clone()
            s.stats = _NativeStats(s._core)
            s.watcher_hub = _NativeHub(
                s._core, self.watcher_hub.event_history.capacity)
            return s

    def recovery(self, data: bytes) -> None:
        d = json.loads(data.decode())
        with self._biglock:
            self._core.load(_tuple_of(d["root"]))
            self._core.index = d["currentIndex"]
            vals = [0] * len(Stats.FIELDS)
            for k, v in d.get("stats", {}).items():
                if k in Stats.FIELDS:
                    vals[Stats.FIELDS.index(k)] = v
            self._core.set_stats(tuple(vals))
            self.watcher_hub.clear()

    def has_ttl_keys(self) -> bool:
        return self._core.next_expiration() is not None

    def next_expiration(self) -> Optional[float]:
        return self._core.next_expiration()

    def json_stats(self) -> dict:
        self.stats.watchers = self.watcher_hub.count
        return self.stats.to_dict()


def _json_of(t) -> dict:
    """dump() 7-tuple -> the snapshot JSON shape (node.py to_json —
    identical key order so save() bytes match the Python store's)."""
    key, value, is_dir, created, modified, exp, kids = t
    d: dict = {"path": key, "createdIndex": created,
               "modifiedIndex": modified}
    if exp is not None:
        d["expireTime"] = exp
    if is_dir:
        d["dir"] = True
        d["children"] = [_json_of(k) for k in kids]
    else:
        d["value"] = value or ""
    return d


def _tuple_of(d: dict):
    """snapshot JSON node -> load() 7-tuple."""
    is_dir = bool(d.get("dir"))
    kids = (tuple(_tuple_of(c) for c in d.get("children", []))
            if is_dir else None)
    return (d["path"], None if is_dir else (d.get("value") or ""),
            is_dir, d["createdIndex"], d["modifiedIndex"],
            d.get("expireTime"), kids)
