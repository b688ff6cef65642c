"""HTTP gateway for the v3 KV preview (reference Documentation/rfc/
v3api.md + v3api.proto Range/Put/DeleteRange/Txn/Compact rpcs, served the
etcd JSON-gateway way: POST with a JSON body, bytes fields base64).

    POST /v3/kv/range        RangeRequest   -> RangeResponse
    POST /v3/kv/put          PutRequest     -> PutResponse
    POST /v3/kv/deleterange  DeleteRangeRequest -> DeleteRangeResponse
    POST /v3/kv/txn          TxnRequest     -> TxnResponse
    POST /v3/kv/compact      CompactionRequest -> CompactionResponse
    POST /v3/watch           WatchRange     -> chunked stream of
                             {"result": {header, events}} JSON lines
                             (created confirmation first; start_revision
                             replays history)
    POST /v3/lease/grant     LeaseCreateRequest -> {lease_id, ttl}
    POST /v3/lease/revoke    LeaseRevokeRequest -> header (attached keys
                             deleted at one revision)
    POST /v3/lease/attach    LeaseAttachRequest -> header
    POST /v3/lease/keepalive LeaseKeepAliveRequest -> {lease_id, ttl}
                             (single-shot POST; expiry is enacted by the
                             leader as a replicated revoke)
    POST /v3/lease/txn       LeaseTnxRequest {request, success, failure}
                             -> {header, response, attach_responses}

Every rpc the RFC declares is served.

Mutations (and linearizable ranges) ride the member's consensus log as
METHOD_V3 requests; serializable ranges (`"serializable": true`) read the
local kvstore directly.
"""
from __future__ import annotations

import json

from etcd_tpu_torch import errors
from etcd_tpu_torch.etcdhttp.web import Ctx, Router
from etcd_tpu_torch.server.request import METHOD_V3, Request
from etcd_tpu_torch.server.v3 import V3Error, validate_op

V3_PREFIX = "/v3"


class V3API:
    def __init__(self, server, security=None) -> None:
        self.server = server
        self.security = security

    def install(self, router: Router) -> None:
        router.add(V3_PREFIX + "/", self.handle)

    def handle(self, ctx: Ctx, suffix: str) -> None:
        if ctx.method != "POST":
            ctx.send(405, b"Method Not Allowed", headers={"Allow": "POST"})
            return
        if getattr(self.server, "_fatal", False):
            # Serializable reads bypass do(); refuse them too — the
            # in-memory index may have forked from the rolled-back backend.
            self._err(ctx, 500, 13,
                      "member failed (fatal apply error); restart required")
            return
        if getattr(self.server, "v3_gapped", False):
            # A legacy snapshot (no v3 image) outran this member's v3
            # backend: its keyspace has a hole and would serve forked
            # data — refuse everything, including serializable reads.
            self._err(ctx, 503, 14,
                      "v3 keyspace gapped by snapshot install; member "
                      "resync required")
            return
        # v2 auth has no v3 user model, so when security is enabled the
        # whole v3 preview surface requires root credentials — the same
        # listener must not offer an unauthenticated write path (the
        # admin-ops rule, reference client_security.go hasRootAccess).
        if self.security is not None and not self.security.has_root_access(
                ctx):
            ctx.send(401, b'{"error": "Insufficient credentials", '
                          b'"code": 16}\n', "application/json",
                     {"WWW-Authenticate": 'Basic realm="etcd"'})
            return
        try:
            body = json.loads(ctx.body.decode() or "{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._err(ctx, 400, 3, f"bad request body: {e}")
            return
        if suffix == "watch":
            self._handle_watch(ctx, body)
            return
        route = {
            "kv/range": "range", "kv/put": "put",
            "kv/deleterange": "deleterange", "kv/txn": "txn",
            "kv/compact": "compact",
            "lease/grant": "lease_create", "lease/create": "lease_create",
            "lease/revoke": "lease_revoke",
            "lease/attach": "lease_attach",
            "lease/keepalive": "lease_keepalive",
            "lease/txn": "lease_txn",
        }.get(suffix)
        if route is None:
            self._err(ctx, 404, 3, f"unknown v3 path {suffix!r}")
            return
        op = dict(body)
        op["type"] = route
        # Lease ops carry no clocks at all (expiry is judged purely on the
        # leader's clock against renewal-seq transitions); the gateway
        # only assigns a fresh id when the client didn't pick one, and
        # strips any client-supplied revoke fence (explicit revokes are
        # unconditional; only the leader's expiry monitor fences).
        if route == "lease_create" and not op.get("lease_id"):
            op["lease_id"] = self.server.reqid.next()
        elif route == "lease_revoke":
            op.pop("seq", None)
        try:
            # Reject malformed ops HERE — nothing unvalidated may enter
            # the consensus log (apply re-validates; defense in depth).
            validate_op(op)
            if route == "range" and body.get("serializable"):
                result = self.server.v3.range(op)
            else:
                if route == "range":
                    op["linearizable"] = True
                result = self.server.do(Request(method=METHOD_V3, v3=op))
        except V3Error as e:
            self._v3err(ctx, e)
            return
        except errors.EtcdError as e:
            self._err(ctx, e.status_code, 13, e.message)
            return
        except (KeyError, ValueError, TypeError) as e:
            self._err(ctx, 400, 3, f"bad v3 request: {e}")
            return
        if isinstance(result, V3Error):   # deterministic apply-side error
            self._v3err(ctx, result)
            return
        ctx.send_json(200, result)

    def _handle_watch(self, ctx: Ctx, body: dict) -> None:
        """Streamed WatchRange (RFC v3api.proto WatchRange rpc): a chunked
        response of JSON lines — first a created confirmation, then one
        {"result": {header, events}} line per committed revision touching
        the range. start_revision replays history first (compacted ->
        error), exactly like etcd's watch."""
        import base64
        from etcd_tpu_torch.server.v3 import V3Error as _V3E
        from etcd_tpu_torch.server.v3 import validate_op

        try:
            validate_op({**{k: body.get(k) for k in
                            ("key", "range_end", "limit")},
                         "type": "range",
                         "revision": body.get("start_revision")})
            key = base64.b64decode(body["key"])
            end = (base64.b64decode(body["range_end"])
                   if body.get("range_end") else None)
            start = int(body.get("start_revision") or 0)
            w, replay = self.server.v3.watch(key, end, start)
        except _V3E as e:
            self._v3err(ctx, e)
            return
        try:
            ctx.begin_stream(200, "application/json")
            created = {"result": {
                "header": {"revision": self.server.v3.kv.current_rev.main},
                "created": True}}
            if not ctx.write_chunk(json.dumps(created).encode() + b"\n"):
                return
            # Historical replay streams straight from the backend (lazy,
            # chunked) before the live queue takes over at the fence. A
            # compaction overtaking the replay cancels the watch (etcd's
            # behavior) rather than delivering a gap-ridden history.
            try:
                for rev, events in (replay or ()):
                    line = json.dumps({"result": {
                        "header": {"revision": rev},
                        "events": events}}).encode() + b"\n"
                    if not ctx.write_chunk(line):
                        return
            except _V3E as e:
                ctx.write_chunk(json.dumps(
                    {"result": {"canceled": True,
                                "reason": e.msg}}).encode() + b"\n")
                ctx.end_stream()
                return
            while True:
                batch = w.next_batch(timeout=0.5)
                if batch is not None:
                    rev, events = batch
                    line = json.dumps({"result": {
                        "header": {"revision": rev},
                        "events": events}}).encode() + b"\n"
                    if not ctx.write_chunk(line):
                        return
                elif w.cancelled:
                    # Slow consumer: the hub dropped this watcher rather
                    # than buffer without bound (etcd cancels, clients
                    # re-watch from their last seen revision).
                    ctx.write_chunk(json.dumps(
                        {"result": {"canceled": True,
                                    "reason": "watcher queue overflow"}}
                    ).encode() + b"\n")
                    ctx.end_stream()
                    return
                elif ctx.client_gone() or self.server.stopped or \
                        getattr(self.server, "_fatal", False):
                    ctx.end_stream()
                    return
        finally:
            w.remove()

    def _v3err(self, ctx: Ctx, e: V3Error) -> None:
        # grpc code 11 = OutOfRange (compacted), 3 = InvalidArgument.
        status = {11: 400, 3: 400, 12: 501}.get(e.code, 400)
        self._err(ctx, status, e.code, e.msg)

    def _err(self, ctx: Ctx, status: int, code: int, msg: str) -> None:
        ctx.send_json(status, {"error": msg, "code": code})
