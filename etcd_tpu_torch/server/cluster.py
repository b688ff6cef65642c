"""Cluster membership registry, stored INSIDE the replicated v2 store.

Behavioral equivalent of reference etcdserver/cluster.go:208-288,
member.go:38-55: members live under /0/members/<idhex> (raftAttributes =
consensus-relevant peer URLs; attributes = name + client URLs, published
later via consensus), removed ids leave tombstones so stale peers are
rejected forever. Because membership lives in the store, snapshots carry it
automatically and recovery rebuilds it for free.
"""
from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

from etcd_tpu_torch import errors
from etcd_tpu_torch.store import Store

STORE_CLUSTER_PREFIX = "/0"          # reference server.go:60
STORE_KEYS_PREFIX = "/1"
_MEMBERS = STORE_CLUSTER_PREFIX + "/members"
_REMOVED = STORE_CLUSTER_PREFIX + "/removed_members"
CLUSTER_VERSION_KEY = STORE_CLUSTER_PREFIX + "/version"


def compute_member_id(peer_urls: Sequence[str], cluster_token: str = "") -> int:
    """Deterministic member id from sorted peer URLs + bootstrap token
    (reference member.go NewMember sha1 scheme)."""
    b = ",".join(sorted(peer_urls)) + "|" + cluster_token
    return int.from_bytes(hashlib.sha1(b.encode()).digest()[:8], "big")


def compute_cluster_id(member_ids: Sequence[int]) -> int:
    """Cluster id = hash of the sorted founding member ids (reference
    cluster.go:208-217 genID)."""
    b = b"".join(i.to_bytes(8, "big") for i in sorted(member_ids))
    return int.from_bytes(hashlib.sha1(b).digest()[:8], "big")


@dataclass(frozen=True)
class Member:
    id: int
    name: str = ""
    peer_urls: Tuple[str, ...] = ()     # raftAttributes (consensus-critical)
    client_urls: Tuple[str, ...] = ()   # attributes (published post-boot)

    @staticmethod
    def new(name: str, peer_urls: Sequence[str],
            client_urls: Sequence[str] = (), cluster_token: str = "") -> "Member":
        return Member(id=compute_member_id(peer_urls, cluster_token),
                      name=name, peer_urls=tuple(peer_urls),
                      client_urls=tuple(client_urls))

    def raft_attributes_json(self) -> str:
        return json.dumps({"peerURLs": list(self.peer_urls)}, sort_keys=True)

    def attributes_json(self) -> str:
        return json.dumps({"name": self.name,
                           "clientURLs": list(self.client_urls)},
                          sort_keys=True)

    def to_dict(self) -> dict:
        return {
            "id": f"{self.id:x}",
            "name": self.name,
            "peerURLs": list(self.peer_urls),
            "clientURLs": list(self.client_urls),
        }


def member_store_key(mid: int) -> str:
    return f"{_MEMBERS}/{mid:x}"


class Cluster:
    """The live membership view. All mutations happen from the apply loop
    (single writer); reads come from anywhere."""

    def __init__(self, store: Store, token: str = "etcd-cluster") -> None:
        self._lock = threading.Lock()
        self.store = store
        self.token = token
        self.cluster_id = 0
        self._members: Dict[int, Member] = {}
        self._removed: Set[int] = set()

    # -- bootstrap -----------------------------------------------------------

    @staticmethod
    def from_initial(store: Store, initial: Dict[str, Sequence[str]],
                     token: str = "etcd-cluster") -> "Cluster":
        """Build the founding membership from an initial-cluster map
        {name: [peer_urls]} (reference NewClusterFromString)."""
        c = Cluster(store, token)
        ids = []
        for name, urls in sorted(initial.items()):
            m = Member.new(name, urls, cluster_token=token)
            c._members[m.id] = m
            ids.append(m.id)
        c.cluster_id = compute_cluster_id(ids)
        return c

    def recover(self) -> None:
        """Rebuild the in-memory view from the store after snapshot recovery
        (reference cluster.go membersFromStore)."""
        with self._lock:
            self._members = {}
            self._removed = set()
            try:
                e = self.store.get(_MEMBERS, recursive=True)
            except errors.EtcdError:
                return
            for n in e.node.nodes or []:
                mid = int(n.key.rsplit("/", 1)[1], 16)
                m = Member(id=mid)
                for leaf in n.nodes or []:
                    d = json.loads(leaf.value or "{}")
                    if leaf.key.endswith("/raftAttributes"):
                        m = replace(m, peer_urls=tuple(d.get("peerURLs", ())))
                    elif leaf.key.endswith("/attributes"):
                        m = replace(m, name=d.get("name", ""),
                                    client_urls=tuple(d.get("clientURLs", ())))
                self._members[mid] = m
            try:
                e = self.store.get(_REMOVED)
                for n in e.node.nodes or []:
                    self._removed.add(int(n.key.rsplit("/", 1)[1], 16))
            except errors.EtcdError:
                pass

    # -- reads ---------------------------------------------------------------

    def members(self) -> List[Member]:
        with self._lock:
            return sorted(self._members.values(), key=lambda m: m.id)

    def member(self, mid: int) -> Optional[Member]:
        with self._lock:
            return self._members.get(mid)

    def member_by_name(self, name: str) -> Optional[Member]:
        with self._lock:
            for m in self._members.values():
                if m.name == name:
                    return m
            return None

    def member_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._members)

    def is_id_removed(self, mid: int) -> bool:
        with self._lock:
            return mid in self._removed

    def client_urls(self) -> List[str]:
        with self._lock:
            out: List[str] = []
            for m in self._members.values():
                out.extend(m.client_urls)
            return sorted(out)

    def peer_urls(self) -> List[str]:
        with self._lock:
            out: List[str] = []
            for m in self._members.values():
                out.extend(m.peer_urls)
            return sorted(out)

    # -- validation (pre-propose) -------------------------------------------

    def version(self) -> Optional[str]:
        """The decided cluster version, stored replicated at /0/version
        (reference cluster.go Version / monitorVersions)."""
        try:
            e = self.store.get(CLUSTER_VERSION_KEY)
        except errors.EtcdError:
            return None
        return e.node.value if e.node else None

    def validate_conf_change(self, cc_type: str, mid: int,
                             peer_urls: Sequence[str] = ()) -> None:
        """Reject impossible membership changes before proposing (reference
        cluster.go:229-288 ValidateConfigurationChange)."""
        with self._lock:
            if mid in self._removed:
                raise errors.EtcdError(errors.ECODE_INVALID_FORM,
                                       cause=f"member {mid:x} was removed")
            if cc_type == "add":
                if mid in self._members:
                    raise errors.EtcdError(errors.ECODE_NODE_EXIST,
                                           cause=f"member {mid:x} exists")
                self._check_url_clash(peer_urls, exclude=None)
            elif cc_type == "remove":
                if mid not in self._members:
                    raise errors.EtcdError(errors.ECODE_KEY_NOT_FOUND,
                                           cause=f"member {mid:x} not found")
            elif cc_type == "update":
                if mid not in self._members:
                    raise errors.EtcdError(errors.ECODE_KEY_NOT_FOUND,
                                           cause=f"member {mid:x} not found")
                self._check_url_clash(peer_urls, exclude=mid)
            else:
                raise ValueError(f"bad conf change type {cc_type}")

    def _check_url_clash(self, urls: Sequence[str],
                         exclude: Optional[int]) -> None:
        taken = set()
        for m in self._members.values():
            if m.id == exclude:
                continue
            taken.update(m.peer_urls)
        for u in urls:
            if u in taken:
                raise errors.EtcdError(errors.ECODE_NODE_EXIST,
                                       cause=f"peer URL {u} already used")

    # -- apply-side mutations (single writer: the apply loop) ---------------

    def add_member(self, m: Member) -> None:
        """Apply an AddNode: record raftAttributes in the store (reference
        cluster.go AddMember)."""
        with self._lock:
            try:
                self.store.create(member_store_key(m.id) + "/raftAttributes",
                                  value=m.raft_attributes_json())
            except errors.EtcdError as e:
                if e.code != errors.ECODE_NODE_EXIST:  # replay after recovery
                    raise
            if m.name or m.client_urls:
                try:
                    self.store.create(member_store_key(m.id) + "/attributes",
                                      value=m.attributes_json())
                except errors.EtcdError as e:
                    if e.code != errors.ECODE_NODE_EXIST:
                        raise
            self._members[m.id] = m

    def remove_member(self, mid: int) -> None:
        """Apply a RemoveNode: delete from the store, add tombstone
        (reference cluster.go RemoveMember)."""
        with self._lock:
            try:
                self.store.delete(member_store_key(mid), recursive=True)
            except errors.EtcdError:
                pass
            try:
                self.store.create(f"{_REMOVED}/{mid:x}", value="removed")
            except errors.EtcdError:
                pass
            self._members.pop(mid, None)
            self._removed.add(mid)

    def update_member_attributes(self, mid: int, name: str,
                                 client_urls: Sequence[str]) -> None:
        """Apply a published attributes update (reference
        server.go:820 applyRequest PUT on attributes key)."""
        with self._lock:
            m = self._members.get(mid)
            if m is None:
                return
            self._members[mid] = replace(m, name=name,
                                         client_urls=tuple(client_urls))

    def update_member_raft_attributes(self, mid: int,
                                      peer_urls: Sequence[str]) -> None:
        with self._lock:
            m = self._members.get(mid)
            if m is None:
                return
            nm = replace(m, peer_urls=tuple(peer_urls))
            try:
                self.store.set(member_store_key(mid) + "/raftAttributes",
                               value=nm.raft_attributes_json())
            except errors.EtcdError:
                pass
            self._members[mid] = nm


# -- remote bootstrap helpers (reference etcdserver/cluster_util.go) ----------

def get_cluster_from_remote_peers(peer_urls: Sequence[str],
                                  timeout: float = 2.0, tls_context=None
                                  ) -> Tuple[int, List[Member]]:
    """GET /members from each peer URL until one answers; returns
    (cluster_id, members) — the joiner's view of the existing cluster
    (reference GetClusterFromRemotePeers cluster_util.go:54-98).
    tls_context secures https:// peers (joining a mutual-TLS cluster
    requires the same peer cert the raft transport presents)."""
    from etcd_tpu_torch.utils.tlsutil import open_conn

    for base in peer_urls:
        try:
            conn = open_conn(base, timeout, tls_context)
            try:
                conn.request("GET", "/members")
                resp = conn.getresponse()
                if resp.status != 200:
                    continue
                cid_hex = resp.getheader("X-Etcd-Cluster-ID") or "0"
                data = json.loads(resp.read().decode())
            finally:
                conn.close()
        except (OSError, ValueError):
            continue
        members = [Member(id=int(m["id"], 16), name=m.get("name", ""),
                          peer_urls=tuple(m.get("peerURLs", ())),
                          client_urls=tuple(m.get("clientURLs", ())))
                   for m in data.get("members", [])]
        if members:
            return int(cid_hex, 16), members
    raise RuntimeError(
        f"cannot fetch cluster info from peer urls {list(peer_urls)}")


def validate_cluster_and_assign_ids(local: "Cluster",
                                    existing: List[Member]) -> None:
    """Match the locally-configured membership (-initial-cluster) against
    the running cluster's member list by sorted peer URLs, and take over the
    existing IDs (reference ValidateClusterAndAssignIDs
    cluster_util.go:103-140). Raises on any mismatch."""
    ems = sorted(existing, key=lambda m: sorted(m.peer_urls))
    lms = sorted(local.members(), key=lambda m: sorted(m.peer_urls))
    if len(ems) != len(lms):
        raise ValueError(
            f"member count is unequal: local {len(lms)} vs existing "
            f"{len(ems)}")
    for em, lm in zip(ems, lms):
        if sorted(em.peer_urls) != sorted(lm.peer_urls):
            raise ValueError(
                f"unmatched member while checking PeerURLs: local "
                f"{sorted(lm.peer_urls)} vs existing {sorted(em.peer_urls)}")
    with local._lock:
        local._members = {em.id: replace(lm, id=em.id)
                          for em, lm in zip(ems, lms)}
