"""Events and the bounded event history ring.

Behavioral equivalent of reference store/event.go:28-33, store/node_extern.go
and store/event_history.go:26-105: the external node representation
(NodeExtern) that the HTTP API serializes, the Event{action, node, prevNode}
triple, and a 1000-event ring that lets watchers resume from a recent index
(`since`) without holding per-watcher buffers.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import List, Optional

from etcd_tpu_torch import errors

# Actions (reference store/event.go:19-27).
GET = "get"
CREATE = "create"
SET = "set"
UPDATE = "update"
DELETE = "delete"
COMPARE_AND_SWAP = "compareAndSwap"
COMPARE_AND_DELETE = "compareAndDelete"
EXPIRE = "expire"

DEFAULT_HISTORY_CAPACITY = 1000  # reference store/store.go:79


def format_expiration(ts: float) -> str:
    """RFC3339Nano-style UTC timestamp, matching the reference's JSON."""
    dt = datetime.fromtimestamp(ts, tz=timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"


@dataclass(slots=True)
class NodeExtern:
    """External (API-facing) view of a store node (reference
    store/node_extern.go:26-38). `value` is None for dirs; `nodes` is None
    unless the dir's children were materialized."""

    key: str = ""
    value: Optional[str] = None
    dir: bool = False
    nodes: Optional[List["NodeExtern"]] = None
    created_index: int = 0
    modified_index: int = 0
    expiration: Optional[float] = None  # absolute unix seconds
    ttl: int = 0                        # remaining seconds, rounded up

    def to_dict(self) -> dict:
        d: dict = {"key": self.key}
        if self.dir:
            d["dir"] = True
        if self.value is not None:
            d["value"] = self.value
        if self.expiration is not None:
            d["expiration"] = format_expiration(self.expiration)
            d["ttl"] = self.ttl
        if self.nodes is not None:
            d["nodes"] = [n.to_dict() for n in self.nodes]
        d["modifiedIndex"] = self.modified_index
        d["createdIndex"] = self.created_index
        return d


@dataclass
class Event:
    action: str
    node: Optional[NodeExtern] = None
    prev_node: Optional[NodeExtern] = None
    etcd_index: int = 0  # X-Etcd-Index at response time (not in the body)

    @property
    def index(self) -> int:
        return self.node.modified_index if self.node else 0

    def to_dict(self) -> dict:
        d: dict = {"action": self.action}
        if self.node is not None:
            d["node"] = self.node.to_dict()
        if self.prev_node is not None:
            d["prevNode"] = self.prev_node.to_dict()
        return d


class LazyWriteEvent:
    """Raw C write descriptors standing in for a materialized Event on the
    applier → waiter handoff. The applier records only the descriptor
    6-tuples the native store already built; the HTTP thread that consumes
    the waiter's result calls resolve() to pay for the NodeExtern/Event
    churn — moving ~40% of the per-ack Python work off the (serialized)
    apply stage onto the (parallel) serving threads. Only plain-file SETs
    take this path, so `action` is fixed."""

    __slots__ = ("nd", "pd", "etcd_index", "now")
    action = SET

    def __init__(self, nd, pd, etcd_index: int, now: float) -> None:
        self.nd = nd
        self.pd = pd
        self.etcd_index = etcd_index
        self.now = now

    def _extern(self, d) -> NodeExtern:
        key, value, is_dir, created, modified, exp = d
        return NodeExtern(key, value, is_dir, None, created, modified, exp,
                          ttl_of(exp, self.now))

    def resolve(self) -> Event:
        return Event(SET, node=self._extern(self.nd),
                     prev_node=(None if self.pd is None
                                else self._extern(self.pd)),
                     etcd_index=self.etcd_index)


class EventHistory:
    """Fixed-capacity ring of past events, scanned by watchers that join
    with a `since` index (reference store/event_history.go)."""

    def __init__(self, capacity: int = DEFAULT_HISTORY_CAPACITY) -> None:
        self.capacity = capacity
        # deque(maxlen): a full ring evicts in O(1) — list.pop(0) was a
        # 1000-element memmove on EVERY apply once warm (profiled as the
        # single hottest line of the engine apply path).
        self.events: deque = deque(maxlen=capacity)
        self.start_index = 0  # index of the oldest retained event
        self.last_index = 0

    def add(self, e: Event) -> Event:
        self.events.append(e)
        self.start_index = self.events[0].index
        self.last_index = e.index
        return e

    def scan(self, key: str, recursive: bool, since: int) -> Optional[Event]:
        """First event at index >= since touching `key` (or its subtree if
        recursive). Raises EventIndexCleared (401) when `since` predates the
        retained window (reference event_history.go:58-105)."""
        if not self.events:
            if since > 0:
                return None
            return None
        if since < self.start_index:
            raise errors.EtcdError(
                errors.ECODE_EVENT_INDEX_CLEARED,
                cause=(f"the requested history has been cleared "
                       f"[{self.start_index}/{since}]"),
                index=self.last_index)
        for e in self.events:
            if e.index < since:
                continue
            ekey = e.node.key if e.node else ""
            if ekey == key:
                return e
            if recursive and ekey.startswith(key.rstrip("/") + "/"):
                return e
        return None

    def clone(self) -> "EventHistory":
        eh = EventHistory(self.capacity)
        eh.events = deque(self.events, maxlen=self.capacity)
        eh.start_index = self.start_index
        eh.last_index = self.last_index
        return eh


def ttl_of(expiration: Optional[float], now: float) -> int:
    """Remaining TTL in whole seconds, rounding up (reference
    node_extern.go loadInternalNode: Sub/Second + 1)."""
    if expiration is None:
        return 0
    return max(int(math.ceil(expiration - now)), 0)
