"""The propose→apply rendezvous registry (reference pkg/wait/wait.go:21-58).

A proposer registers a request id and blocks on the returned queue; the apply
loop triggers the id with the result once the entry commits and applies.
Thread-safe: proposers are HTTP handler threads, the trigger side is the
single run-loop thread.
"""
from __future__ import annotations

import queue
from typing import Any, Dict, Optional


class Wait:
    """Lock-free on the hot path: CPython dict setdefault/pop are
    GIL-atomic, and trigger() sits on the apply loop's per-request path
    (profiled), so the registry rides the GIL instead of a Lock."""

    def __init__(self) -> None:
        self._waiters: Dict[int, "queue.Queue[Any]"] = {}

    def register(self, wid: int) -> "queue.Queue[Any]":
        q: "queue.Queue[Any]" = queue.Queue(maxsize=1)
        if self._waiters.setdefault(wid, q) is not q:
            raise ValueError(f"duplicate wait id {wid:x}")
        return q

    def trigger(self, wid: int, value: Any) -> bool:
        q = self._waiters.pop(wid, None)
        if q is None:
            return False
        q.put(value)
        return True

    def is_registered(self, wid: int) -> bool:
        return wid in self._waiters

    def cancel(self, wid: int) -> None:
        self._waiters.pop(wid, None)
