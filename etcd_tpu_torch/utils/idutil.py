"""Cluster-unique request id generation (reference pkg/idutil/id.go:44-76).

Layout: [2 bytes member id suffix][5 bytes timestamp ms][1 byte counter
low bits] — ids from different members never collide, and one member's ids
are strictly increasing.
"""
from __future__ import annotations

import threading
import time


class Generator:
    def __init__(self, member_id: int, now_ms: int = None) -> None:
        self._lock = threading.Lock()
        prefix = (member_id & 0xFFFF) << 48
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        suffix = (now_ms & ((1 << 40) - 1)) << 8
        self._id = prefix | suffix

    def next(self) -> int:
        with self._lock:
            self._id += 1
            return self._id
