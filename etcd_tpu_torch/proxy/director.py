"""Endpoint set management for the stateless proxy mode.

Behavioral equivalent of reference proxy/director.go: a background refresh
loop re-queries the cluster for client URLs every ``refresh_interval``
(30s there, director.go:31), a failed endpoint is quarantined for
``failure_wait`` (5s, director.go:28) before being reconsidered, and the
endpoint list is shuffled on refresh so connections don't pile onto one
member (director.go:69-73).
"""
from __future__ import annotations

import random
import threading
from typing import Callable, List, Sequence


class Endpoint:
    def __init__(self, url: str, failure_wait: float) -> None:
        self.url = url.rstrip("/")
        self._failure_wait = failure_wait
        self._lock = threading.Lock()
        self._available = True

    @property
    def available(self) -> bool:
        with self._lock:
            return self._available

    def failed(self) -> None:
        """Quarantine this endpoint; a timer restores it (director.go:107-135)."""
        with self._lock:
            if not self._available:
                return
            self._available = False
        t = threading.Timer(self._failure_wait, self._restore)
        t.daemon = True
        t.start()

    def _restore(self) -> None:
        with self._lock:
            self._available = True


class Director:
    """Maintains the live endpoint list from a ``urls_func`` snapshot."""

    def __init__(self, urls_func: Callable[[], Sequence[str]],
                 refresh_interval: float = 30.0,
                 failure_wait: float = 5.0) -> None:
        self._uf = urls_func
        self._failure_wait = failure_wait
        self._refresh_interval = refresh_interval
        self._lock = threading.Lock()
        self._eps: List[Endpoint] = []
        self._stop = threading.Event()
        self.refresh()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="proxy-director")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._refresh_interval):
            try:
                self.refresh()
            except Exception:
                pass

    def refresh(self) -> None:
        urls = list(self._uf() or ())
        eps = [Endpoint(u, self._failure_wait) for u in urls]
        random.shuffle(eps)
        with self._lock:
            self._eps = eps

    def endpoints(self) -> List[Endpoint]:
        with self._lock:
            return [ep for ep in self._eps if ep.available]

    def stop(self) -> None:
        self._stop.set()


# The proxy's subdirectory inside a data dir; etcdmain's DIR_PROXY and
# every cluster-file path derive from this single definition.
PROXY_DIR_NAME = "proxy"


def write_cluster_file(data_dir: str, peer_urls) -> str:
    """Atomically persist the proxy's endpoint view at
    <data_dir>/proxy/cluster — THE schema ProxyServer boots from and
    refreshes (single owner of the file format; the standby migration
    writes through here too). Returns the file path."""
    import json
    import os
    proxy_dir = os.path.join(data_dir, PROXY_DIR_NAME)
    os.makedirs(proxy_dir, exist_ok=True)
    path = os.path.join(proxy_dir, "cluster")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"PeerURLs": list(peer_urls)}, f)
    os.replace(tmp, path)
    return path
