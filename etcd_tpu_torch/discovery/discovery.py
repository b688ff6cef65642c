"""Cluster bootstrap via an etcd-compatible discovery service.

Behavioral equivalent of reference discovery/discovery.go: the discovery
URL is ``http://host[:port]/<token>``; the service exposes a v2 keyspace at
its root where ``/<token>/_config/size`` holds the intended cluster size
(checkCluster discovery.go:184-230), each member self-registers by creating
``/<token>/<member-id-hex>`` = "name=peerURL[,name=peerURL]"
(createSelf discovery.go:165-181), members beyond the size slots get
FullClusterError (discovery.go:219-224), and everyone watches the token dir
until ``size`` registrations exist (waitNodes discovery.go:277-308), then
joins them into an initial-cluster string (nodesToCluster discovery.go:314).
Connection timeouts retry with exponential backoff (discovery.go:232-239).
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from etcd_tpu_torch.client import Client, ClientError, KeysAPI, KeysError
from etcd_tpu_torch.errors import ECODE_KEY_NOT_FOUND, ECODE_NODE_EXIST
from etcd_tpu_torch.server.cluster import compute_member_id

log = logging.getLogger("discovery")


class DiscoveryError(Exception):
    pass


class InvalidURLError(DiscoveryError):
    pass


class SizeNotFoundError(DiscoveryError):
    pass


class BadSizeKeyError(DiscoveryError):
    pass


class DuplicateIDError(DiscoveryError):
    pass


class FullClusterError(DiscoveryError):
    pass


class TooManyRetriesError(DiscoveryError):
    pass


class _Discovery:
    def __init__(self, durl: str, self_id: int, proxy_url: str = "",
                 max_retries: int = 16,
                 backoff_base: float = 1.0) -> None:
        u = urlsplit(durl)
        if not u.scheme or not u.path.strip("/"):
            raise InvalidURLError(f"invalid discovery URL {durl!r}")
        self.token = u.path.strip("/")
        self.id = self_id
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.retries = 0
        endpoint = f"{u.scheme}://{u.netloc}"
        # proxy_url routes traffic through an HTTP proxy (reference
        # newProxyFunc discovery.go:75-93 → http.Transport.Proxy).
        self.kapi = KeysAPI(Client([endpoint], timeout=5.0, proxy=proxy_url),
                            prefix="")

    # -- retry/backoff (discovery.go:232-239) ------------------------------

    def _backoff(self, step: str) -> None:
        self.retries += 1
        if self.retries > self.max_retries:
            raise TooManyRetriesError(f"discovery: too many retries ({step})")
        # Exponential, capped at 32x base so a long outage fails in minutes
        # rather than sleeping for hours on the last doublings.
        wait = self.backoff_base * min(2 ** self.retries, 32)
        log.info("discovery: during %s connection timed out, retrying in %.0fs",
                 step, wait)
        time.sleep(wait)

    def _self_key(self) -> str:
        return f"{self.token}/{self.id:x}"

    # -- protocol ----------------------------------------------------------

    def check_cluster(self) -> Tuple[List, int, int]:
        """Returns (sorted registration nodes, size, current etcd index)."""
        while True:
            try:
                resp = self.kapi.get(f"{self.token}/_config/size")
            except KeysError as e:
                if e.code == ECODE_KEY_NOT_FOUND:
                    raise SizeNotFoundError("discovery: size key not found")
                raise
            except ClientError:
                self._backoff("cluster status check")
                continue
            try:
                size = int(resp.node.value)
            except (TypeError, ValueError):
                raise BadSizeKeyError("discovery: size key is bad")

            try:
                resp = self.kapi.get(self.token)
            except ClientError:
                self._backoff("cluster status check")
                continue
            nodes = [n for n in (resp.node.nodes if resp.node else [])
                     if n.key.rsplit("/", 1)[-1] != "_config"]
            nodes.sort(key=lambda n: n.created_index)

            # A member is admitted iff its slot is within the first `size`
            # registrations (discovery.go:213-224).
            self_base = self._self_key().rsplit("/", 1)[-1]
            for i, n in enumerate(nodes):
                if n.key.rsplit("/", 1)[-1] == self_base:
                    break
                if i >= size - 1:
                    raise FullClusterError("discovery: cluster is full")
            return nodes, size, resp.index

    def create_self(self, contents: str) -> None:
        try:
            resp = self.kapi.create(self._self_key(), contents)
        except KeysError as e:
            if e.code == ECODE_NODE_EXIST:
                raise DuplicateIDError("discovery: found duplicate id")
            raise
        # Observe our own registration before proceeding
        # (discovery.go:176-180).
        w = self.kapi.watcher(self._self_key(),
                              after_index=resp.node.created_index - 1)
        w.next(timeout=30.0)

    def wait_nodes(self, nodes: List, size: int, index: int) -> List:
        nodes = nodes[:size]
        w = self.kapi.watcher(self.token, after_index=index, recursive=True)
        all_nodes = list(nodes)
        seen = {n.key for n in all_nodes}
        while len(all_nodes) < size:
            log.info("discovery: found %d peer(s), waiting for %d more",
                     len(all_nodes), size - len(all_nodes))
            try:
                resp = w.next()
            except ClientError:
                self._backoff("waiting for other nodes")
                nodes, size, index = self.check_cluster()
                return self.wait_nodes(nodes, size, index)
            n = resp.node
            if n and n.key not in seen and n.key.rsplit("/", 1)[-1] != "_config":
                seen.add(n.key)
                all_nodes.append(n)
        all_nodes.sort(key=lambda n: n.created_index)
        return all_nodes[:size]

    def join(self, contents: str) -> str:
        self.check_cluster()
        self.create_self(contents)
        nodes, size, index = self.check_cluster()
        return nodes_to_cluster(self.wait_nodes(nodes, size, index))

    def get(self) -> str:
        try:
            nodes, size, index = self.check_cluster()
        except FullClusterError:
            # A proxy/latecomer just takes the full member set
            # (discovery.go:167-170).
            nodes, size, index = self._nodes_even_if_full()
            return nodes_to_cluster(nodes[:size])
        return nodes_to_cluster(self.wait_nodes(nodes, size, index))

    def _nodes_even_if_full(self) -> Tuple[List, int, int]:
        resp = self.kapi.get(f"{self.token}/_config/size")
        size = int(resp.node.value)
        resp = self.kapi.get(self.token)
        nodes = [n for n in (resp.node.nodes if resp.node else [])
                 if n.key.rsplit("/", 1)[-1] != "_config"]
        nodes.sort(key=lambda n: n.created_index)
        return nodes, size, resp.index


def nodes_to_cluster(nodes: Sequence) -> str:
    return ",".join(n.value for n in nodes if n.value)


def join_cluster(durl: str, name: str, peer_urls: Sequence[str],
                 proxy_url: str = "", self_id: Optional[int] = None,
                 max_retries: int = 16) -> str:
    """Register with the discovery service and wait for the full cluster;
    returns an initial-cluster string (reference JoinCluster
    discovery.go:53-59, called from etcdserver/server.go:224-238)."""
    if self_id is None:
        self_id = compute_member_id(peer_urls, durl)
    contents = ",".join(f"{name}={u}" for u in peer_urls)
    d = _Discovery(durl, self_id, proxy_url, max_retries=max_retries)
    return d.join(contents)


def get_cluster(durl: str, proxy_url: str = "",
                max_retries: int = 16) -> str:
    """Fetch the bootstrapped cluster without registering — proxy bootstrap
    (reference GetCluster discovery.go:63-69)."""
    d = _Discovery(durl, 0, proxy_url, max_retries=max_retries)
    return d.get()
