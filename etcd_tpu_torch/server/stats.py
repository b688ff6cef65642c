"""Server / leader statistics served under /v2/stats/*.

Behavioral equivalent of reference etcdserver/stats/: ServerStats with
send/recv package+bandwidth rates over a sliding window of recent requests
(stats/queue.go:33-41 statsQueue), and LeaderStats tracking per-follower
append latency mean/stddev and success/fail counts (stats/leader.go:68-123).
Thread-safe: the transport and the run loop both report into these.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple

_QUEUE_CAP = 200  # reference stats/queue.go queueCapacity


class _RateQueue:
    """Ring of (timestamp, size) samples; rate = totals / time-span
    (reference statsQueue.Rate)."""

    def __init__(self) -> None:
        self._items: List[Tuple[float, int]] = []

    def insert(self, size: int, now: float) -> None:
        self._items.append((now, size))
        if len(self._items) > _QUEUE_CAP:
            self._items.pop(0)

    def rate(self, now: float) -> Tuple[float, float]:
        """(packages/sec, bytes/sec) over the retained window; zero once the
        newest sample is over a minute old (reference queue.go:62-74)."""
        if not self._items:
            return 0.0, 0.0
        first, last = self._items[0][0], self._items[-1][0]
        if now - last > 60.0:
            return 0.0, 0.0
        span = last - first
        if span <= 0:
            return 0.0, 0.0
        n = len(self._items)
        total = sum(sz for _, sz in self._items)
        return n / span, total / span


class ServerStats:
    """Payload of /v2/stats/self (reference stats/server.go)."""

    def __init__(self, name: str, mid: int, clock=time.time) -> None:
        self._lock = threading.Lock()
        self.name = name
        self.id = mid
        self.clock = clock
        self.state = "StateFollower"
        self.start_time = clock()
        self.leader = 0
        self.leader_start = 0.0
        self.recv_append_cnt = 0
        self.send_append_cnt = 0
        self._recvq = _RateQueue()
        self._sendq = _RateQueue()

    def become_leader(self) -> None:
        with self._lock:
            if self.state != "StateLeader":
                self.state = "StateLeader"
                self.leader = self.id
                self.leader_start = self.clock()

    def become_follower(self, leader: int) -> None:
        with self._lock:
            self.state = "StateFollower"
            if leader != self.leader:
                self.leader = leader
                self.leader_start = self.clock()

    def recv_append_req(self, leader: int, size: int) -> None:
        with self._lock:
            self.state = "StateFollower"
            if leader != self.leader:
                self.leader = leader
                self.leader_start = self.clock()
            self.recv_append_cnt += 1
            self._recvq.insert(size, self.clock())

    def send_append_req(self, size: int) -> None:
        with self._lock:
            self.send_append_cnt += 1
            self._sendq.insert(size, self.clock())

    def to_dict(self) -> dict:
        from etcd_tpu_torch.store.event import format_expiration
        with self._lock:
            now = self.clock()
            rpkg, rbw = self._recvq.rate(now)
            spkg, sbw = self._sendq.rate(now)
            d = {
                "name": self.name,
                "id": f"{self.id:x}",
                "state": self.state,
                "startTime": format_expiration(self.start_time),
                "leaderInfo": {
                    "leader": f"{self.leader:x}",
                    "uptime": f"{now - self.leader_start:.6f}s"
                              if self.leader_start else "0s",
                    "startTime": format_expiration(self.leader_start)
                                 if self.leader_start else
                                 format_expiration(self.start_time),
                },
                "recvAppendRequestCnt": self.recv_append_cnt,
                "sendAppendRequestCnt": self.send_append_cnt,
            }
            if rpkg:
                d["recvPkgRate"] = rpkg
                d["recvBandwidthRate"] = rbw
            if spkg:
                d["sendPkgRate"] = spkg
                d["sendBandwidthRate"] = sbw
            return d


class _FollowerStats:
    """Latency + counts for one follower (reference stats/leader.go:68-123);
    streaming mean/stddev via Welford-style accumulation."""

    def __init__(self) -> None:
        self.success = 0
        self.fail = 0
        self.current = 0.0
        self.minimum = math.inf
        self.maximum = 0.0
        self._sum = 0.0
        self._sq_sum = 0.0

    def succ(self, ms: float) -> None:
        self.success += 1
        self.current = ms
        self.minimum = min(self.minimum, ms)
        self.maximum = max(self.maximum, ms)
        self._sum += ms
        self._sq_sum += ms * ms

    def failed(self) -> None:
        self.fail += 1

    def to_dict(self) -> dict:
        n = self.success
        avg = self._sum / n if n else 0.0
        var = self._sq_sum / n - avg * avg if n else 0.0
        return {
            "latency": {
                "current": self.current,
                "average": avg,
                "standardDeviation": math.sqrt(max(var, 0.0)),
                "minimum": 0.0 if self.minimum is math.inf else self.minimum,
                "maximum": self.maximum,
            },
            "counts": {"fail": self.fail, "success": self.success},
        }


class LeaderStats:
    """Payload of /v2/stats/leader (reference stats/leader.go)."""

    def __init__(self, mid: int) -> None:
        self._lock = threading.Lock()
        self.id = mid
        self._followers: Dict[int, _FollowerStats] = {}

    def follower(self, fid: int) -> _FollowerStats:
        with self._lock:
            fs = self._followers.get(fid)
            if fs is None:
                fs = self._followers[fid] = _FollowerStats()
            return fs

    def succ(self, fid: int, ms: float) -> None:
        with self._lock:
            fs = self._followers.setdefault(fid, _FollowerStats())
            fs.succ(ms)

    def failed(self, fid: int) -> None:
        with self._lock:
            fs = self._followers.setdefault(fid, _FollowerStats())
            fs.failed()

    def remove(self, fid: int) -> None:
        with self._lock:
            self._followers.pop(fid, None)

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "leader": f"{self.id:x}",
                "followers": {f"{fid:x}": fs.to_dict()
                              for fid, fs in self._followers.items()},
            }
