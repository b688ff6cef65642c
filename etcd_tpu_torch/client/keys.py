"""Typed v2 keys API.

Behavioral equivalent of reference client/keys.go: KeysAPI with
Get/Set/Create/CreateInOrder/Update/Delete and option structs collapsed to
keyword arguments, a Response{action, node, prevNode, index} triple, and a
Watcher whose next() re-issues the long-poll with waitIndex advancing past
each event (keys.go:401-424 httpWatcher.Next), recovering from 401
index-cleared by jumping to the current X-Etcd-Index.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence
from urllib.parse import quote, urlencode

from etcd_tpu_torch.client.client import Client, ClientError


class KeysError(ClientError):
    """An etcd API error body {errorCode, message, cause, index}."""

    def __init__(self, d: dict, status: int) -> None:
        self.code = d.get("errorCode", 0)
        self.message = d.get("message", "")
        self.cause = d.get("cause", "")
        self.index = d.get("index", 0)
        self.status = status
        super().__init__(f"{self.code}: {self.message} ({self.cause})")


class Node:
    def __init__(self, d: dict) -> None:
        self.key = d.get("key", "")
        self.value = d.get("value")
        self.dir = d.get("dir", False)
        self.created_index = d.get("createdIndex", 0)
        self.modified_index = d.get("modifiedIndex", 0)
        self.expiration = d.get("expiration")
        self.ttl = d.get("ttl", 0)
        self.nodes = [Node(n) for n in d.get("nodes") or []]

    def __repr__(self) -> str:
        return f"Node(key={self.key!r}, value={self.value!r})"


class Response:
    def __init__(self, d: dict, headers: dict) -> None:
        self.action = d.get("action", "")
        self.node = Node(d["node"]) if d.get("node") else None
        self.prev_node = Node(d["prevNode"]) if d.get("prevNode") else None
        self.index = int(headers.get("X-Etcd-Index", 0) or 0)
        self.raft_index = int(headers.get("X-Raft-Index", 0) or 0)
        self.raft_term = int(headers.get("X-Raft-Term", 0) or 0)


_FORM_HDR = {"Content-Type": "application/x-www-form-urlencoded"}


class KeysAPI:
    def __init__(self, client: Client, prefix: str = "/v2/keys") -> None:
        """prefix="" talks to services exposing the keyspace at the root,
        e.g. the public discovery service (reference keys.go
        NewKeysAPIWithPrefix, discovery.go:101)."""
        self.client = client
        self.prefix = prefix

    # -- plumbing -----------------------------------------------------------

    def _key_path(self, key: str) -> str:
        return self.prefix + quote("/" + key.strip("/"))

    def _call(self, method: str, key: str, params: dict,
              form: Optional[dict] = None,
              timeout: Optional[float] = None) -> Response:
        params = {k: v for k, v in params.items() if v not in (None, "")}
        path = self._key_path(key)
        if params:
            path += "?" + urlencode(params)
        body = urlencode(form).encode() if form else None
        resp = self.client.do(method, path, body,
                              _FORM_HDR if body else None, timeout=timeout)
        d = resp.json()
        if resp.status >= 400 or (isinstance(d, dict) and "errorCode" in d):
            raise KeysError(d if isinstance(d, dict) else {}, resp.status)
        return Response(d or {}, resp.headers)

    @staticmethod
    def _b(v: Optional[bool]) -> Optional[str]:
        return None if v is None else ("true" if v else "false")

    # -- API (reference keys.go:93-121) -------------------------------------

    def get(self, key: str, recursive: bool = False, sorted: bool = False,
            quorum: bool = False) -> Response:
        return self._call("GET", key, {
            "recursive": self._b(recursive) if recursive else None,
            "sorted": self._b(sorted) if sorted else None,
            "quorum": self._b(quorum) if quorum else None})

    def set(self, key: str, value: Optional[str] = None, ttl: int = 0,
            prev_value: str = "", prev_index: int = 0,
            prev_exist: Optional[bool] = None, dir: bool = False,
            refresh: bool = False) -> Response:
        params = {"prevValue": prev_value or None,
                  "prevIndex": prev_index or None,
                  "prevExist": self._b(prev_exist),
                  "dir": self._b(dir) if dir else None,
                  "refresh": self._b(refresh) if refresh else None}
        form = {}
        if value is not None:
            form["value"] = value
        if ttl:
            form["ttl"] = str(ttl)
        return self._call("PUT", key, params, form or None)

    def create(self, key: str, value: str, ttl: int = 0) -> Response:
        return self.set(key, value, ttl=ttl, prev_exist=False)

    def create_in_order(self, dir_key: str, value: str,
                        ttl: int = 0) -> Response:
        form = {"value": value}
        if ttl:
            form["ttl"] = str(ttl)
        return self._call("POST", dir_key, {}, form)

    def update(self, key: str, value: str, ttl: int = 0) -> Response:
        return self.set(key, value, ttl=ttl, prev_exist=True)

    def delete(self, key: str, recursive: bool = False, dir: bool = False,
               prev_value: str = "", prev_index: int = 0) -> Response:
        return self._call("DELETE", key, {
            "recursive": self._b(recursive) if recursive else None,
            "dir": self._b(dir) if dir else None,
            "prevValue": prev_value or None,
            "prevIndex": prev_index or None})

    def watcher(self, key: str, after_index: int = 0,
                recursive: bool = False) -> "Watcher":
        return Watcher(self, key, after_index, recursive)


class Watcher:
    """Repeated long-poll watcher (reference keys.go httpWatcher)."""

    def __init__(self, api: KeysAPI, key: str, after_index: int,
                 recursive: bool) -> None:
        self.api = api
        self.key = key
        self.recursive = recursive
        self.next_wait = after_index + 1 if after_index else 0

    def next(self, timeout: Optional[float] = None) -> Response:
        """Block until the next event. timeout=None blocks indefinitely,
        re-issuing the long-poll whenever a quiet period outlives the HTTP
        read timeout (reference httpWatcher.Next retry loop)."""
        import time as _time
        deadline = None if timeout is None else _time.time() + timeout
        while True:
            if deadline is None:
                per_req = 60.0
            else:
                per_req = deadline - _time.time()
                if per_req <= 0:
                    raise ClientError("watch timed out")
            try:
                r = self.api._call("GET", self.key, {
                    "wait": "true",
                    "recursive": KeysAPI._b(self.recursive)
                                 if self.recursive else None,
                    "waitIndex": self.next_wait or None},
                    timeout=per_req)
            except KeysError as e:
                if e.code == 401:  # history window outran us: jump forward
                    self.next_wait = e.index + 1
                    continue
                raise
            except ClientError:
                # Idle long-poll outlived the read timeout — re-issue with
                # the same waitIndex; nothing is lost (history ring).
                if deadline is not None and _time.time() >= deadline:
                    raise
                _time.sleep(0.1)  # don't spin if the cluster is down
                continue
            if r.node is None:  # empty answer (server shutdown / broken poll)
                continue
            self.next_wait = r.node.modified_index + 1
            return r
