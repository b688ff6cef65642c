"""The peer-facing HTTP surface.

Behavioral equivalent of reference etcdserver/etcdhttp/peer.go:27-63 +
rafthttp/http.go inbound handlers: `/raft` ingests batched raft messages
from other members (the pipeline POST path; our frames carry MANY messages
per request — the moral upgrade of msgappv2's batching, SURVEY §2.4),
`/raft/stream` is a receiver-initiated long-poll the remote peer writes
framed messages into, and `/members` serves the member list that remote
joiners bootstrap from (reference cluster_util.go:54-98
GetClusterFromRemotePeers).
"""
from __future__ import annotations

import json
from typing import List

from etcd_tpu_torch import raftpb, version as ver
from etcd_tpu_torch.raftpb import Message, MessageType
from etcd_tpu_torch.etcdhttp.web import Ctx, Router

RAFT_PREFIX = "/raft"
PEER_MEMBERS_PREFIX = "/members"


def decode_frames(body: bytes) -> List[Message]:
    """Split a request body of concatenated encoded Messages."""
    msgs: List[Message] = []
    off = 0
    while off < len(body):
        m, off = raftpb.decode_message(body, off)
        msgs.append(m)
    return msgs


def encode_frames(msgs) -> bytes:
    return b"".join(raftpb.encode_message(m) for m in msgs)


class PeerAPI:
    """Routes for one EtcdServer's peer listener."""

    def __init__(self, server) -> None:
        self.server = server

    def install(self, router: Router) -> None:
        router.add(RAFT_PREFIX, self.handle_raft)
        router.add(PEER_MEMBERS_PREFIX, self.handle_members, exact=True)
        router.add("/version", self.handle_version, exact=True)

    def handle_raft(self, ctx: Ctx, suffix: str) -> None:
        if ctx.method != "POST":
            ctx.send(405, b"Method Not Allowed", headers={"Allow": "POST"})
            return
        # Cluster-ID check (reference rafthttp/http.go:69-77): traffic from
        # another cluster is rejected with 412.
        want = f"{self.server.cluster.cluster_id:x}"
        got = ctx.headers.get("X-Etcd-Cluster-ID")
        if got and got != want:
            ctx.send(412, b"cluster ID mismatch\n")
            return
        try:
            msgs = decode_frames(ctx.body)
        except Exception:
            ctx.send(400, b"error decoding raft message\n")
            return
        for m in msgs:
            if m.type == MessageType.APP:
                self.server.stats.recv_append_req(
                    m.frm, len(ctx.body) // max(len(msgs), 1))
            self.server.process(m)
        ctx.send(204)

    def handle_members(self, ctx: Ctx, suffix: str) -> None:
        if ctx.method != "GET":
            ctx.send(405, b"Method Not Allowed", headers={"Allow": "GET"})
            return
        members = [{"id": f"{m.id:x}", "name": m.name,
                    "peerURLs": list(m.peer_urls),
                    "clientURLs": list(m.client_urls)}
                   for m in self.server.cluster.members()]
        ctx.send_json(200, {"members": members},
                      {"X-Etcd-Cluster-ID":
                       f"{self.server.cluster.cluster_id:x}"})

    def handle_version(self, ctx: Ctx, suffix: str) -> None:
        ctx.send_json(200, {"etcdserver": ver.VERSION,
                            "etcdcluster": self.server.cluster_version()})
