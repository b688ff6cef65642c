"""Watchers and the watcher hub (reference store/watcher.go,
store/watcher_hub.go:33-165).

Re-designed for the synchronous apply loop + threaded HTTP frontend: a
Watcher owns a thread-safe queue the HTTP handler blocks on (the reference's
one-slot event channel), and the hub fans mutations out along the key's
ancestor chain. Non-stream watchers detach after the first event; stream
watchers stay registered.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

from etcd_tpu_torch import errors
from etcd_tpu_torch.store.event import Event, EventHistory


def _is_hidden(watch_path: str, key_path: str) -> bool:
    """True if `key_path` has a hidden component strictly below `watch_path`
    (reference watcher_hub.go isHidden): such events are invisible to
    recursive watchers above, but an exact watcher on the hidden key fires."""
    if len(watch_path) > len(key_path):
        return False
    after = "/" + key_path[len(watch_path):].lstrip("/")
    return "/_" in after


class Watcher:
    def __init__(self, hub: "WatcherHub", path: str, recursive: bool,
                 stream: bool, since_index: int) -> None:
        self._hub = hub
        self.path = path
        self.recursive = recursive
        self.stream = stream
        self.since_index = since_index
        self.removed = False
        self._q: "queue.Queue[Optional[Event]]" = queue.Queue()
        self._last_index = -1  # dedup guard for the delete double-walk

    def next_event(self, timeout: Optional[float] = None) -> Optional[Event]:
        """Block until the next event (None on timeout or after remove())."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _notify(self, e: Event, original_path: bool, deleted: bool) -> bool:
        """Deliver if this watcher cares (reference watcher.go:36-61):
        recursive watchers take the subtree, exact watchers their own path,
        and a deleted dir force-notifies watchers beneath it. Returns True
        if the (non-stream) watcher is now spent."""
        if not (self.recursive or original_path or deleted):
            return False
        if e.index < self.since_index:
            return False
        if e.index == self._last_index:
            return False  # already delivered via the other walk
        self._last_index = e.index
        self._q.put(e)
        return not self.stream

    def remove(self) -> None:
        self._hub.remove(self)
        self._q.put(None)  # wake any blocked reader


class WatcherHub:
    def __init__(self, history_capacity: int = 1000) -> None:
        self._lock = threading.Lock()
        self._watchers: Dict[str, List[Watcher]] = {}
        self.event_history = EventHistory(history_capacity)
        self.count = 0  # live watcher count (reference atomic count)

    def watch(self, key: str, recursive: bool, stream: bool,
              since_index: int, current_index: int) -> Watcher:
        """Register a watcher; if `since_index` falls inside the history
        window and a matching event already happened, deliver it immediately
        (reference watcher_hub.go:55-109)."""
        w = Watcher(self, key, recursive, stream, since_index)
        w.start_index = current_index  # X-Etcd-Index for the watch response
        with self._lock:
            if since_index > 0:
                e = self.event_history.scan(key, recursive, since_index)
                if e is not None:
                    e.etcd_index = current_index
                    w._last_index = e.index
                    w._q.put(e)
                    if not stream:
                        return w  # spent before registration
            self._watchers.setdefault(key, []).append(w)
            self.count += 1
        return w

    def remove(self, w: Watcher) -> None:
        with self._lock:
            self._remove_locked(w)

    def _remove_locked(self, w: Watcher) -> None:
        if w.removed:
            return
        lst = self._watchers.get(w.path)
        if lst and w in lst:
            lst.remove(w)
            if not lst:
                del self._watchers[w.path]
            self.count -= 1
        w.removed = True

    def _record(self, e: Event) -> Event:
        """History hook: the native store's hub overrides this to a no-op
        (its C core appends the ring record inside the mutation op)."""
        return self.event_history.add(e)

    def notify(self, e: Event) -> None:
        """Record the event and fire watchers along the ancestor chain
        (reference watcher_hub.go:111-133)."""
        with self._lock:
            e = self._record(e)
            if self.count == 0:
                # History is recorded either way (wait-index queries need
                # it); with no watchers registered, skip the ancestor
                # walk — it's pure overhead on every apply (profiled at
                # ~20% of a multi-tenant engine apply).
                return
            key = e.node.key if e.node else "/"
            segments = [s for s in key.split("/") if s]
            curr = "/"
            self._notify_watchers_locked(e, curr, deleted=False)
            for seg in segments:  # "/a", "/a/b", ...
                curr = curr.rstrip("/") + "/" + seg
                self._notify_watchers_locked(e, curr, deleted=False)

    def notify_with_path(self, e: Event, path: str, deleted: bool) -> None:
        """Force-notify watchers at `path` (used for each node removed by a
        recursive delete — reference watcher_hub.go notifyWatchers(deleted))."""
        with self._lock:
            self._notify_watchers_locked(e, path, deleted)

    def _notify_watchers_locked(self, e: Event, node_path: str,
                                deleted: bool) -> None:
        lst = self._watchers.get(node_path)
        if not lst:
            return
        key = e.node.key if e.node else "/"
        for w in list(lst):
            original = key == node_path
            if not (original or not _is_hidden(node_path, key)):
                continue
            if w._notify(e, original, deleted):
                self._remove_locked(w)

    def clear(self) -> None:
        """Drop all watchers (store Recovery): each pending reader is woken
        with a WATCHER_CLEARED sentinel (reference ECODE 400 semantics)."""
        with self._lock:
            for lst in list(self._watchers.values()):
                for w in list(lst):
                    self._remove_locked(w)
                    w._q.put(None)
            self._watchers = {}
