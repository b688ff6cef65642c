"""Coalescing ingress tier: manufacture batch depth from shallow clients.

Every headline engine number is measured from deep per-tenant queues,
but a million-user deployment is the opposite shape: tens of thousands
of SHALLOW clients, each issuing depth-1 writes, TTL refreshes and
watches. "Scaling Replicated State Machines with Compartmentalization"
(PAPERS.md) names the fix — a stateless proxy/batcher role in front of
the ordering core — and ROADMAP item 2 scopes it for this engine. This
module is that role:

  * An EVENT-DRIVEN front (one epoll loop, not thread-per-connection)
    holds tens of thousands of client sockets at a few fds' and one
    thread's cost — the whole point; a threaded front would burn the
    same GIL the direct path does and manufacture nothing.

  * A per-tenant COALESCING LANE buffers writes inside an adaptive
    window and ships each flush upstream over a PERSISTENT BINARY
    CHANNEL (server/batchframe.py: one 101-upgraded socket per lane,
    length-prefixed frames, the slot payload packed by ONE
    walcodec.pack_multi call) feeding MultiEngine.submit_many -> the
    existing P_MULTI multi-request log-entry packing, so WAL format and
    replay are untouched. The channel PIPELINES: up to
    IngressConfig.flush_window flushes ride the wire at once, demuxed
    by flush id — the engine's staging queue never drains to zero
    between flushes, which is what lets the tier track the engine's
    deep-queue capacity instead of its round-trip latency. The window
    never sleeps: it closes on request count (flush_max_requests), on
    bytes (flush_max_bytes), or the moment a pipeline slot frees while
    the buffer is non-empty (the "drain" reason) — group commit's
    natural-batching policy at the tier above the engine. Upstreams
    that refuse the handshake (a router that only rewrites
    /tenants/{t}/batch) fall back per lane to the round-10 JSON POST
    path; channel re-establishment is paced by capped exponential
    backoff.

  * The PER-REQUEST HOT LOOP is native when built (ingresscore.c): one
    GIL-releasing C pass scans a connection's read buffer into request
    tuples, and each flush's fan-back materializes all N client
    responses in one formatter call — the pure-Python reference path
    remains the automatic fallback (etcd_ingress_native_enabled says
    which is serving).

  * Acks/errors DEMULTIPLEX back to each waiting client only after the
    upstream ack: the ingress holds no durable state and never
    acknowledges ahead of the engine's fsync-gated ack, so SIGKILLing
    an ingress process can lose in-flight (unacked) writes but never an
    acked one (tests/test_ingress.py proves it across a real SIGKILL).

  * A WATCH FAN-OUT HUB multiplexes N downstream watchers of the same
    (tenant, key, recursive) onto ONE upstream watch stream, with a
    small replay ring so late long-polls with a waitIndex inside the
    ring are served without another upstream round trip. A waitIndex
    OLDER than the ring's coverage forwards upstream verbatim on a
    dedicated proxy — history replays (or 401s EventIndexCleared)
    exactly as on the direct path, never silently skipped.

  * Quorum GETs forward to the PR 9 read plane upstream; with
    read_lease_ms > 0 the ingress downgrades them to plain local GETs
    while a lease holds — any upstream quorum-confirmed ack (every
    batch ack is one: a committed write proves the leader's quorum)
    within the window renews it. Same clock-bound contract as
    EngineConfig.read_lease_ms; off by default.

Run one per core (scripts/ingress_serve.py) in front of an engine or a
pool_serve.py router — the router rewrites /tenants/{t}/batch through
the same tenant mapping as every other per-tenant path, so ingress and
process sharding compose unchanged.
"""
from __future__ import annotations

import http.client
import json
import logging
import os
import posixpath
import selectors
import socket
import threading
import time
import urllib.parse
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from etcd_tpu_torch import native
from etcd_tpu_torch.server import batchframe, obs

log = logging.getLogger("etcd_tpu.ingress")

_MAX_HEADER = 64 * 1024
_MAX_BODY = 4 * 1024 * 1024
_MAX_WBUF = 8 * 1024 * 1024   # slow-client cap: close past this backlog
_RING_CAP = 256          # hub replay ring (events per upstream stream)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclass
class IngressConfig:
    upstream: str                      # "http://host:port" (engine or router)
    host: str = "127.0.0.1"
    port: int = 0
    flush_max_requests: int = 1024     # window closes on count...
    flush_max_bytes: int = 1 << 20     # ...or on encoded bytes...
    max_inflight: int = 1              # ...or when an inflight slot frees.
    # max_inflight=1 keeps per-client FIFO strict even for pipelined
    # writes (batches commit in flush order); depth-1 clients are
    # order-safe at any setting because they never overlap their own
    # writes. (JSON-path slot count; the binary channel's depth is
    # flush_window.)
    flush_window: int = 4              # pipelined flushes per lane on the
    #                                    binary channel; per-client FIFO
    #                                    holds at any depth because the
    #                                    busy gate allows one outstanding
    #                                    request per connection, and
    #                                    frames submit to engine staging
    #                                    in channel order.
    upstream_mode: str = "auto"        # "auto" | "frame" | "json"
    use_native: bool = True            # ingresscore.c hot loop when built
    read_lease_ms: int = 0
    request_timeout: float = 30.0


def _upstream_addr(url: str) -> Tuple[str, int]:
    u = urllib.parse.urlsplit(url if "//" in url else "//" + url)
    return u.hostname or "127.0.0.1", int(u.port or 2379)


# ---------------------------------------------------------------------------
# HTTP plumbing (loop side)
# ---------------------------------------------------------------------------

class _Conn:
    """One downstream client connection's loop-side state."""

    __slots__ = ("sock", "rbuf", "wbuf", "closing", "streaming",
                 "want_write", "open", "busy", "subs", "fwd",
                 "pending", "perr")

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.closing = False       # close after wbuf drains
        self.streaming = False     # chunked watch stream in progress
        self.want_write = False
        self.open = True
        self.busy = False          # a response is owed; pause parsing
        self.subs: list = []       # hub subscriptions (for close cleanup)
        self.fwd: list = []        # upstream conns of dedicated watch
        #                            proxies; severed on close to unblock
        #                            their reader threads
        self.pending: deque = deque()  # scanned-but-undispatched requests
        self.perr = 0              # scanner error latched behind pending


def _response(status: int, body: bytes,
              ctype: str = "application/json",
              extra: Optional[Dict[str, str]] = None,
              close: bool = False) -> bytes:
    reason = {200: "OK", 201: "Created", 400: "Bad Request",
              404: "Not Found", 405: "Method Not Allowed",
              408: "Request Timeout", 500: "Internal Server Error",
              503: "Service Unavailable"}.get(status, "OK")
    h = [f"HTTP/1.1 {status} {reason}",
         f"Content-Type: {ctype}",
         f"Content-Length: {len(body)}"]
    for k, v in (extra or {}).items():
        h.append(f"{k}: {v}")
    if close:
        h.append("Connection: close")
    return ("\r\n".join(h) + "\r\n\r\n").encode() + body


def _json_response(status: int, obj,
                   extra: Optional[Dict[str, str]] = None) -> bytes:
    return _response(status, json.dumps(obj).encode() + b"\n",
                     extra=extra)


def _chunk(data: bytes) -> bytes:
    return f"{len(data):x}\r\n".encode() + data + b"\r\n"


def _err_body(cause: str) -> bytes:
    """Client-facing body of a whole-flush upstream failure."""
    return json.dumps({"errorCode": 300, "message": "Raft Internal Error",
                       "cause": cause}).encode() + b"\n"


# ---------------------------------------------------------------------------
# the coalescing lane (one per tenant)
# ---------------------------------------------------------------------------

class _PendingWrite:
    __slots__ = ("conn", "item", "size", "t0")

    def __init__(self, conn: _Conn, item: dict, size: int) -> None:
        self.conn = conn
        self.item = item
        self.size = size
        self.t0 = time.perf_counter()


class _Channel:
    """One lane's persistent binary upstream channel (batchframe).

    Flushes PIPELINE: send_flush registers the batch under a fresh flush
    id and writes one request frame without waiting; the reader thread
    demultiplexes response frames back to their batches in any order.
    A send/read failure SEVERS the channel: every registered (in-flight)
    flush fans back a 503 and nothing is ever re-sent — a flush the
    upstream may have read MAY have committed, and re-sending it would
    double-apply POSTs and break CAS chains. The clients that never got
    an ack own the retry, exactly as with a direct engine."""

    __slots__ = ("lane", "sock", "rfile", "lock", "inflight", "next_id",
                 "alive", "born", "reader")

    def __init__(self, lane: "_Lane", sock: socket.socket, rfile) -> None:
        self.lane = lane
        self.sock = sock
        self.rfile = rfile
        self.lock = threading.Lock()
        self.inflight: Dict[int, List[_PendingWrite]] = {}
        self.next_id = 1
        self.alive = True
        self.born = time.monotonic()
        self.reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"ingress-chan{lane.tenant}")
        self.reader.start()

    def window_used(self) -> int:
        with self.lock:
            return len(self.inflight)

    def send_flush(self, batch: List[_PendingWrite], auth_json: bytes,
                   payload: bytes) -> bool:
        """Register + send one flush. False = channel already dead and
        the CALLER still owns the batch. True = the channel owns it: the
        reader acks it or sever() 503s it."""
        err: Optional[Exception] = None
        with self.lock:
            if not self.alive:
                return False
            fid = self.next_id
            self.next_id += 1
            self.inflight[fid] = batch
            try:
                # Send under the lock: concurrent flushers' frame bytes
                # must never interleave on the wire.
                self.sock.sendall(batchframe.pack_request_frame(
                    fid, auth_json, payload))
            except OSError as e:
                err = e
        if err is not None:
            self.sever(err)
        else:
            obs.ingress_upstream_frames.labels("sent").inc()
        return True

    def _read_loop(self) -> None:
        lane = self.lane
        try:
            while True:
                frame = batchframe.read_response_frame(self.rfile)
                if frame is None:
                    raise OSError("upstream closed batchframe channel")
                fid, slots, error = frame
                obs.ingress_upstream_frames.labels("recv").inc()
                with self.lock:
                    batch = self.inflight.pop(fid, None)
                if batch is None:
                    continue       # already failed over in sever()
                if slots is None:
                    status, body = error
                    lane.fan_error(batch, status, bytes(body))
                elif len(slots) != len(batch):
                    lane.fan_error(batch, 503, _err_body(
                        "upstream batchframe slot count mismatch"))
                else:
                    lane.fan_acks(batch, slots)
                lane.window_notify()
        except Exception as e:  # noqa: BLE001 — sever fans back per client
            self.sever(e)
        finally:
            # Only this (the reader) thread closes the fds: other
            # threads sever via shutdown so a blocked read unblocks with
            # EOF instead of racing a close-and-reuse under it.
            try:
                self.rfile.close()
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass

    def sever(self, err: Exception) -> None:
        """Mark the channel dead and 503 EXACTLY the in-flight flushes
        (never a retry). Idempotent; callable from any thread."""
        with self.lock:
            was_alive, self.alive = self.alive, False
            pending, self.inflight = self.inflight, {}
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        if pending:
            obs.ingress_upstream_severed.inc(len(pending))
            body = _err_body(f"ingress upstream channel severed: {err}")
            for batch in pending.values():
                self.lane.fan_error(batch, 503, body)
        if was_alive:
            self.lane.channel_down(self)


class _Lane:
    """Per-tenant coalescing window + its flusher thread(s).

    The flusher never sleeps on a timer: it waits on the condition until
    the buffer is non-empty AND a pipeline slot is free (flush_window on
    the binary channel, max_inflight on the JSON fallback), takes up to
    the caps, and ships the batch. On the channel the ship is
    FIRE-AND-FORGET — the flusher loops straight back to building the
    next window while up to flush_window flushes ride the wire, so
    upstream round-trip latency stops being the lane's clock; acks
    demultiplex on the channel's reader thread. On the JSON path the
    POST is synchronous and upstream latency IS the adaptive window,
    exactly the round-10 behavior."""

    def __init__(self, ing: "Ingress", tenant: int) -> None:
        self.ing = ing
        self.tenant = tenant
        self.buf: deque = deque()
        self.bytes = 0
        self.cv = threading.Condition()
        self.inflight = 0
        self.stopped = False
        self.lease_until = 0.0       # monotonic; quorum-read lease
        cfg = ing.cfg
        self.mode = cfg.upstream_mode     # "auto" | "frame" | "json";
        #                                   auto flips to json per lane
        #                                   when the upstream 4xxes the
        #                                   batchframe handshake
        self.chan: Optional[_Channel] = None
        self._connect_lock = threading.Lock()
        self._backoff = 0.0          # capped exponential reconnect pace
        self._next_connect = 0.0     # monotonic gate for the next dial
        self._had_channel = False
        self.threads = [
            threading.Thread(target=self._flusher, daemon=True,
                             name=f"ingress-lane{tenant}-{i}")
            for i in range(max(1, cfg.max_inflight))]
        for t in self.threads:
            t.start()

    def enqueue(self, pw: _PendingWrite) -> None:
        with self.cv:
            self.buf.append(pw)
            self.bytes += pw.size
            self.cv.notify()

    def stop(self) -> None:
        with self.cv:
            self.stopped = True
            self.cv.notify_all()
            chan = self.chan
        if chan is not None:
            chan.sever(RuntimeError("ingress stopping"))

    def window_notify(self) -> None:
        """A pipeline slot freed (channel reader finished a flush)."""
        with self.cv:
            self.cv.notify_all()

    def channel_down(self, chan: "_Channel") -> None:
        """The channel severed: pace the re-dial. A channel that lived a
        while earns a fresh (minimal) backoff; a flapping one doubles it
        up to the cap."""
        with self.cv:
            if self.chan is chan:
                self.chan = None
            now = time.monotonic()
            if now - chan.born > 2.0:
                self._backoff = 0.0
            self._backoff = min(2.0, self._backoff * 2 or 0.05)
            self._next_connect = now + self._backoff
            self.cv.notify_all()

    def _take(self) -> Tuple[List[_PendingWrite], str]:
        """Called under cv with a non-empty buffer and a free slot."""
        cfg = self.ing.cfg
        if len(self.buf) >= cfg.flush_max_requests:
            reason = "count"
        elif self.bytes >= cfg.flush_max_bytes:
            reason = "bytes"
        else:
            reason = "drain"
        batch, nbytes = [], 0
        while (self.buf and len(batch) < cfg.flush_max_requests
               and nbytes < cfg.flush_max_bytes):
            pw = self.buf.popleft()
            batch.append(pw)
            nbytes += pw.size
        self.bytes -= nbytes
        return batch, reason

    def _ready(self) -> bool:
        """cv predicate: non-empty buffer AND a free upstream slot.
        On the channel a slot is a flush_window pipeline slot (hard cap:
        a tripped threshold waits for a slot rather than overrunning the
        window); on the JSON path thresholds may overrun max_inflight
        exactly as in round 10."""
        if not self.buf:
            return False
        cfg = self.ing.cfg
        if self.mode != "json":
            chan = self.chan
            if chan is None or not chan.alive:
                return True      # dial (or backoff-503) proceeds
            return chan.window_used() < cfg.flush_window
        if self.inflight < cfg.max_inflight:
            return True
        return (len(self.buf) >= cfg.flush_max_requests
                or self.bytes >= cfg.flush_max_bytes)

    def _flusher(self) -> None:
        upstream: Optional[http.client.HTTPConnection] = None
        host, port = _upstream_addr(self.ing.cfg.upstream)
        while True:
            with self.cv:
                while not self.stopped and not self._ready():
                    self.cv.wait(0.5)
                if self.stopped:
                    return
                batch, reason = self._take()
                self.inflight += 1
            obs.ingress_inflight.inc()
            obs.ingress_flush_reason.labels(reason).inc()
            obs.ingress_batch.observe(len(batch))
            # Exactly ONE fan_acks/fan_error happens per batch (that is
            # where ingress_inflight decrements): immediately below on
            # the failure paths, on the channel's reader thread for a
            # pipelined flush, inline for a JSON POST.
            try:
                if self.mode != "json":
                    chan = self._ensure_channel(host, port)
                    if self.mode == "json":
                        # auto-fallback flipped during this dial
                        upstream = self._flush_json(upstream, host, port,
                                                    batch)
                    elif chan is None:
                        self.fan_error(batch, 503, _err_body(
                            "ingress upstream channel unavailable: "
                            "reconnect backoff"))
                    elif not chan.send_flush(
                            batch, *self._encode_frame(batch)):
                        self.fan_error(batch, 503, _err_body(
                            "ingress upstream channel severed"))
                else:
                    upstream = self._flush_json(upstream, host, port,
                                                batch)
            finally:
                with self.cv:
                    self.inflight -= 1
                    self.cv.notify_all()

    def _ensure_channel(self, host: str,
                        port: int) -> Optional[_Channel]:
        """Return the live channel, (re)dialing under capped exponential
        backoff; None while backing off or unreachable. In auto mode a
        non-101 handshake (an upstream that routes /batch but not
        /batchframe) flips this lane to the JSON path permanently."""
        with self._connect_lock:
            chan = self.chan
            if chan is not None and chan.alive:
                return chan
            now = time.monotonic()
            if now < self._next_connect:
                return None
            if self._had_channel or self._backoff:
                obs.ingress_upstream_reconnects.inc()
            sock = rfile = None
            try:
                sock = socket.create_connection(
                    (host, port), timeout=self.ing.cfg.request_timeout)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.sendall(batchframe.handshake_request(
                    self.tenant, f"{host}:{port}"))
                rfile = sock.makefile("rb")
                status = batchframe.read_handshake_status(rfile)
            except OSError as e:
                for f in (rfile, sock):
                    try:
                        if f is not None:
                            f.close()
                    except OSError:
                        pass
                self._backoff = min(2.0, self._backoff * 2 or 0.05)
                self._next_connect = now + self._backoff
                log.warning("lane %d: batchframe dial failed (%s); "
                            "next try in %.2fs", self.tenant, e,
                            self._backoff)
                return None
            if status != 101:
                for f in (rfile, sock):
                    try:
                        f.close()
                    except OSError:
                        pass
                if self.mode == "auto":
                    self.mode = "json"
                    obs.ingress_upstream_fallbacks.inc()
                    log.info("lane %d: upstream has no batchframe "
                             "endpoint (handshake status %d); using the "
                             "JSON batch path", self.tenant, status)
                    return None
                self._backoff = min(2.0, self._backoff * 2 or 0.05)
                self._next_connect = now + self._backoff
                return None
            sock.settimeout(None)    # the reader blocks on acks forever
            self._had_channel = True
            self.chan = _Channel(self, sock, rfile)
            return self.chan

    def _encode_frame(self, batch: List[_PendingWrite]
                      ) -> Tuple[bytes, bytes]:
        """(auth_json, payload) of one request frame. Items ride as the
        same JSON dicts the /batch route takes (TTLs must resolve
        against the ENGINE clock; rids are assigned engine-side); the
        whole flush packs in ONE pack_multi call."""
        auth_json = b""
        if any("auth" in pw.item for pw in batch):
            auth_json = json.dumps(
                [pw.item.get("auth") for pw in batch]).encode()
        payload = native.pack_multi(
            [(0, b"\x00" + json.dumps(pw.item).encode())
             for pw in batch], batchframe.P_MULTI)
        return auth_json, payload

    def fan_acks(self, batch: List[_PendingWrite],
                 slots: List[Tuple[int, bytes]]) -> None:
        """Upstream acked (durable: results release after the engine
        round's fsync) — only NOW may any client see its ack. One
        formatter call materializes the whole flush's responses."""
        lease_s = self.ing.cfg.read_lease_ms / 1000.0
        if lease_s > 0:
            self.lease_until = time.monotonic() + lease_s
        now = time.perf_counter()
        outs = self.ing.fmt_responses(
            [(status, bytes(body)) for status, body in slots])
        sends = []
        for pw, (status, _body), out in zip(batch, slots, outs):
            obs.ingress_ack_ms.observe((now - pw.t0) * 1000.0)
            if status >= 400:
                obs.ingress_errors.inc()
            else:
                obs.ingress_acked.inc()
            sends.append((pw.conn, out))
        self.ing.post_send_many(sends)
        obs.ingress_inflight.dec()

    def fan_error(self, batch: List[_PendingWrite], status: int,
                  body: bytes) -> None:
        """Whole-flush failure: one formatted response, every rider."""
        out = self.ing.fmt_responses([(status, body)])[0]
        obs.ingress_errors.inc(len(batch))
        self.ing.post_send_many([(pw.conn, out) for pw in batch])
        obs.ingress_inflight.dec()

    def _flush_json(self, upstream, host, port,
                    batch: List[_PendingWrite]):
        """Round-10 fallback: one window -> ONE JSON POST
        /tenants/{t}/batch -> per-client fan-back. Returns the (possibly
        re-opened) upstream connection. Never raises and never retries:
        a batch that died after the upstream read its request MAY have
        committed, and re-sending it would double-apply POSTs and break
        CAS chains. The client that never got an ack owns the retry,
        exactly as with a direct engine."""
        if upstream is None and time.monotonic() < self._next_connect:
            self.fan_error(batch, 503, _err_body(
                "ingress upstream unavailable: reconnect backoff"))
            return None
        body = json.dumps(
            {"reqs": [pw.item for pw in batch]}).encode()
        path = f"/tenants/{self.tenant}/batch"
        try:
            if upstream is None:
                if self._backoff:
                    obs.ingress_upstream_reconnects.inc()
                upstream = http.client.HTTPConnection(
                    host, port, timeout=self.ing.cfg.request_timeout)
            upstream.request("POST", path, body=body,
                             headers={"Content-Type": "application/json"})
            resp = upstream.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise OSError(f"upstream batch status {resp.status}")
            results = json.loads(data)["results"]
            if len(results) != len(batch):
                raise OSError("upstream batch result count mismatch")
        except Exception as e:  # noqa: BLE001 — fans back per client
            try:
                if upstream is not None:
                    upstream.close()
            except OSError:
                pass
            self._backoff = min(2.0, self._backoff * 2 or 0.05)
            self._next_connect = time.monotonic() + self._backoff
            self.fan_error(batch, 503, _err_body(
                f"ingress upstream flush failed: {e}"))
            return None
        self._backoff = 0.0
        slots = []
        for res in results:
            if "error" in res:
                slots.append((res.get("status", 500),
                              json.dumps(res["error"]).encode() + b"\n"))
            else:
                slots.append((res.get("status", 200),
                              json.dumps(res["event"]).encode() + b"\n"))
        self.fan_acks(batch, slots)
        return upstream


# ---------------------------------------------------------------------------
# watch fan-out hub
# ---------------------------------------------------------------------------

class _HubSub:
    __slots__ = ("conn", "stream", "since")

    def __init__(self, conn: _Conn, stream: bool, since: int) -> None:
        self.conn = conn
        self.stream = stream
        self.since = since


class _HubStream:
    """One upstream watch stream fanned out to N downstream watchers."""

    def __init__(self, hub: "_Hub", key: tuple) -> None:
        self.hub = hub
        self.key = key                     # (tenant, path, recursive)
        self.subs: List[_HubSub] = []
        self.ring: deque = deque(maxlen=_RING_CAP)   # (index, bytes)
        self.stopped = False
        self.sock: Optional[socket.socket] = None
        self.thread = threading.Thread(
            target=self._reader, daemon=True,
            name=f"ingress-hub-{key[0]}{key[1]}")

    def _reader(self) -> None:
        ing = self.hub.ing
        host, port = _upstream_addr(ing.cfg.upstream)
        t, path, rec = self.key
        q = f"wait=true&stream=true&recursive={'true' if rec else 'false'}"
        conn = http.client.HTTPConnection(host, port, timeout=None)
        try:
            conn.request(
                "GET", f"/tenants/{t}/v2/keys{path}?{q}")
            self.sock = conn.sock
            resp = conn.getresponse()
            if resp.status != 200:
                raise OSError(f"upstream watch status {resp.status}")
            while not self.stopped:
                line = resp.readline()
                if not line:
                    raise OSError("upstream watch stream closed")
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                self._deliver(ev, line + b"\n")
        except Exception as e:  # noqa: BLE001 — fail every sub, not the tier
            if not self.stopped:
                log.warning("hub stream %s died: %s", self.key, e)
            self.hub.drop_stream(self, e)
        finally:
            # Only this thread may close the connection: other threads
            # sever it via sock.shutdown (see _close_stream).
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def _deliver(self, ev: dict, raw: bytes) -> None:
        idx = int(ev.get("node", {}).get("modifiedIndex", 0) or 0)
        ing = self.hub.ing
        with self.hub.lock:
            self.ring.append((idx, raw))
            subs, self.subs = self.subs, []
            keep = []
            delivered = 0
            for s in subs:
                if not s.conn.open:
                    continue
                if s.since and idx and idx < s.since:
                    keep.append(s)
                    continue
                delivered += 1
                if s.stream:
                    ing.post_send(s.conn, _chunk(raw))
                    keep.append(s)
                else:
                    ing.post_send(s.conn, _response(
                        200, raw, extra={"X-Etcd-Index": str(idx)}))
                    try:
                        s.conn.subs.remove((self, s))
                    except ValueError:
                        pass
            self.subs = keep + self.subs
            if not self.subs and not self.stopped:
                # Last long-poll served: drop the upstream stream too,
                # or every once-watched key leaks a connection forever.
                self.hub._close_stream(self)
            if delivered:
                obs.ingress_hub_deliveries.inc(delivered)
                obs.ingress_hub_watchers.set(self.hub.watcher_count())


class _Hub:
    def __init__(self, ing: "Ingress") -> None:
        self.ing = ing
        self.lock = threading.Lock()
        self.streams: Dict[tuple, _HubStream] = {}

    def watcher_count(self) -> int:
        return sum(len(st.subs) for st in self.streams.values())

    def subscribe(self, conn: _Conn, tenant: int, path: str,
                  recursive: bool, stream: bool, since: int) -> bool:
        """Attach a downstream watcher; serve from the replay ring when
        its waitIndex is already covered (no upstream round trip).

        Returns False when `since` predates the ring's coverage: the
        ring only holds events seen since this hub stream opened, so
        serving an older waitIndex from it would silently skip history
        that direct etcd replays (or 401s EventIndexCleared on). The
        caller must forward such watches upstream verbatim instead."""
        key = (tenant, path, recursive)
        with self.lock:
            st = self.streams.get(key)
            if since and not (st is not None and st.ring
                              and st.ring[0][0]
                              and st.ring[0][0] <= since):
                return False
            if st is None:
                st = self.streams[key] = _HubStream(self, key)
                st.thread.start()
                obs.ingress_hub_streams.set(len(self.streams))
            if stream:
                # Headers first, BEFORE the sub registers — a live
                # delivery racing in from the reader thread must never
                # beat the status line onto the wire.
                self.ing.post_send(conn, (
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Transfer-Encoding: chunked\r\n\r\n"))
            if since:
                ready = [(i, raw) for i, raw in st.ring if i >= since]
                if ready:
                    if not stream:
                        i, raw = ready[0]
                        self.ing.post_send(conn, _response(
                            200, raw, extra={"X-Etcd-Index": str(i)}))
                        if not st.subs:
                            self._close_stream(st)
                        return
                    for _i, raw in ready:
                        self.ing.post_send(conn, _chunk(raw))
                    since = 0    # caught up; go live below
            sub = _HubSub(conn, stream, since)
            st.subs.append(sub)
            conn.subs.append((st, sub))
            obs.ingress_hub_watchers.set(self.watcher_count())
            return True

    def unsubscribe_conn(self, conn: _Conn) -> None:
        with self.lock:
            for st, sub in conn.subs:
                try:
                    st.subs.remove(sub)
                except ValueError:
                    pass
                if not st.subs:
                    self._close_stream(st)
            conn.subs.clear()
            obs.ingress_hub_watchers.set(self.watcher_count())

    def _close_stream(self, st: _HubStream) -> None:
        st.stopped = True
        self.streams.pop(st.key, None)
        obs.ingress_hub_streams.set(len(self.streams))
        try:
            if st.sock is not None:
                # shutdown, not close: close() leaves a reader already
                # blocked in recv blocked forever (and frees the fd for
                # reuse under it); shutdown unblocks it with EOF and the
                # reader thread closes its own connection on exit.
                st.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def drop_stream(self, st: _HubStream, err: Exception) -> None:
        """Upstream stream died: fail every subscriber loudly (a silent
        hub would turn a dead upstream into watchers that never fire)."""
        with self.lock:
            if self.streams.get(st.key) is st:
                self.streams.pop(st.key, None)
                obs.ingress_hub_streams.set(len(self.streams))
            subs, st.subs = st.subs, []
            for s in subs:
                if not s.conn.open:
                    continue
                if s.stream:
                    self.ing.post_send(s.conn, b"0\r\n\r\n",
                                       close_after=True)
                else:
                    self.ing.post_send(s.conn, _json_response(
                        503, {"errorCode": 300,
                              "message": "Raft Internal Error",
                              "cause": f"ingress upstream watch died: "
                                       f"{err}"}))
                try:
                    s.conn.subs.remove((st, s))
                except ValueError:
                    pass
            obs.ingress_hub_watchers.set(self.watcher_count())

    def stop(self) -> None:
        with self.lock:
            for st in list(self.streams.values()):
                self._close_stream(st)


# ---------------------------------------------------------------------------
# the ingress server
# ---------------------------------------------------------------------------

class Ingress:
    """The event-driven front + lanes + hub + upstream GET forwarders."""

    def __init__(self, cfg: IngressConfig) -> None:
        self.cfg = cfg
        self.use_native = cfg.use_native and native.HAVE_NATIVE_INGRESS
        self._scan = (native.scan_requests if self.use_native
                      else native._py_scan_requests)
        self._fmt = (native.format_responses if self.use_native
                     else native._py_format_responses)
        obs.ingress_native_enabled.set(1.0 if self.use_native else 0.0)
        self.lanes: Dict[int, _Lane] = {}
        self._lanes_lock = threading.Lock()
        self.hub = _Hub(self)
        self.sel = selectors.DefaultSelector()
        self._posted: deque = deque()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._stop = threading.Event()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((cfg.host, cfg.port))
        self._lsock.listen(4096)
        self._lsock.setblocking(False)
        self.port = self._lsock.getsockname()[1]
        self._thread: Optional[threading.Thread] = None
        # Small pool for upstream GET forwarding (reads must not block
        # the loop; they are not coalescable and just proxy through).
        self._fetchq: deque = deque()
        self._fetch_cv = threading.Condition()
        self._fetchers = [
            threading.Thread(target=self._fetcher, daemon=True,
                             name=f"ingress-fetch{i}") for i in range(4)]

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.sel.register(self._lsock, selectors.EVENT_READ, "accept")
        self.sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        for t in self._fetchers:
            t.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ingress-loop")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        self.hub.stop()
        with self._lanes_lock:
            for lane in self.lanes.values():
                lane.stop()
        with self._fetch_cv:
            self._fetch_cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)

    @property
    def url(self) -> str:
        return f"http://{self.cfg.host}:{self.port}"

    # -- cross-thread completion hand-off -----------------------------------

    def post_send(self, conn: _Conn, data: bytes,
                  close_after: bool = False) -> None:
        """Queue bytes for a client from ANY thread; the loop owns every
        socket write (no per-connection locks, no interleaved sends)."""
        self._posted.append((conn, data, close_after))
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def post_send_many(self, sends: List[Tuple[_Conn, bytes]]) -> None:
        """post_send for a whole flush's fan-back: one wake byte, not N."""
        self._posted.extend((conn, data, False) for conn, data in sends)
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def fmt_responses(self, slots: List[Tuple[int, bytes]]) -> List[bytes]:
        """Materialize final HTTP responses for (status, body) slots —
        one ingresscore call per flush when the extension is built."""
        if self.use_native:
            obs.ingress_native_formatted.inc(len(slots))
        return self._fmt(slots)

    # -- the loop ------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            for key, mask in self.sel.select(timeout=0.5):
                tag = key.data
                # One connection's failure (malformed input, handler
                # bug) must never escape and freeze the loop — it owns
                # every other connection on this ingress.
                try:
                    if tag == "accept":
                        self._accept()
                    elif tag == "wake":
                        try:
                            self._wake_r.recv(65536)
                        except OSError:
                            pass
                    else:
                        conn: _Conn = tag
                        if mask & selectors.EVENT_READ:
                            self._readable(conn)
                        if conn.open and (mask & selectors.EVENT_WRITE):
                            self._flush_wbuf(conn)
                except Exception:  # noqa: BLE001 — close one conn, not all
                    log.exception("ingress loop: connection handler failed")
                    if isinstance(tag, _Conn):
                        self._close(tag)
            self._drain_posted()
        # teardown
        for key in list(self.sel.get_map().values()):
            if isinstance(key.data, _Conn):
                self._close(key.data)
        try:
            self.sel.unregister(self._lsock)
            self.sel.unregister(self._wake_r)
        except (KeyError, ValueError):
            pass
        self._lsock.close()
        self._wake_r.close()
        self._wake_w.close()
        self.sel.close()

    def _drain_posted(self) -> None:
        while self._posted:
            conn, data, close_after = self._posted.popleft()
            if not conn.open:
                continue
            try:
                conn.busy = False
                conn.wbuf += data
                if close_after:
                    conn.closing = True
                    conn.streaming = False   # the stream just ended
                self._flush_wbuf(conn)
                # A pipelined request may already be buffered.
                if conn.open and not conn.busy and not conn.streaming:
                    self._parse(conn)
            except Exception:  # noqa: BLE001 — close one conn, not all
                log.exception("ingress loop: posted-send handling failed")
                self._close(conn)

    def _accept(self) -> None:
        for _ in range(256):
            try:
                s, _addr = self._lsock.accept()
            except (BlockingIOError, OSError):
                return
            s.setblocking(False)
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(s)
            self.sel.register(s, selectors.EVENT_READ, conn)

    def _close(self, conn: _Conn) -> None:
        if not conn.open:
            return
        conn.open = False
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn.subs:
            self.hub.unsubscribe_conn(conn)
        for up in list(conn.fwd):
            # Sever any dedicated watch proxy's upstream socket so its
            # blocked readline unblocks and the thread exits. shutdown,
            # NOT close: close() neither unblocks a reader already in
            # recv nor is HTTPConnection.close() safe here — it grabs
            # the response buffer's lock the blocked reader holds, which
            # would deadlock this (the loop) thread. The proxy thread
            # closes its own connection on the way out.
            try:
                if up.sock is not None:
                    up.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        conn.fwd.clear()

    def _readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            self._close(conn)
            return
        conn.rbuf += data
        if not conn.busy and not conn.streaming:
            self._parse(conn)

    def _flush_wbuf(self, conn: _Conn) -> None:
        try:
            while conn.wbuf:
                n = conn.sock.send(conn.wbuf)
                if n <= 0:
                    break
                del conn.wbuf[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(conn)
            return
        if len(conn.wbuf) > _MAX_WBUF:
            # Backpressure: a stalled reader (slow watcher on a busy
            # key) must not grow ingress memory without bound — drop it.
            obs.ingress_slow_clients.inc()
            self._close(conn)
            return
        events = selectors.EVENT_READ
        if conn.wbuf:
            events |= selectors.EVENT_WRITE
        elif conn.closing and not conn.streaming:
            # A streaming watcher that asked Connection: close still
            # holds the stream open until it ends (0-chunk or hangup).
            self._close(conn)
            return
        try:
            self.sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError):
            pass

    # -- HTTP parse + dispatch ----------------------------------------------

    def _parse(self, conn: _Conn) -> None:
        """Drain complete pipelined requests off the read buffer — ONE
        scanner pass (ingresscore.c when built) emits every complete
        request at once; dispatch then pops them as the busy gate
        allows (≤1 outstanding request per connection)."""
        while conn.open and not conn.busy and not conn.streaming:
            if not conn.pending:
                if conn.perr:
                    self._scan_error(conn)
                    return
                if not conn.rbuf:
                    return
                reqs, consumed, err = self._scan(conn.rbuf)
                if consumed:
                    del conn.rbuf[:consumed]
                if reqs and self.use_native:
                    obs.ingress_native_scanned.inc(len(reqs))
                conn.pending.extend(reqs)
                conn.perr = err
                if not conn.pending:
                    if err:
                        self._scan_error(conn)
                    return
            (method, target, ctype, auth, close,
             body) = conn.pending.popleft()
            if close:
                conn.closing = True
            headers: Dict[str, str] = {}
            if ctype is not None:
                headers["content-type"] = ctype
            if auth is not None:
                headers["authorization"] = auth
            conn.busy = True
            try:
                self._dispatch(conn, method, target, headers, body)
            except Exception as e:  # noqa: BLE001 — client-controlled input
                # must never escape to the loop: 400 this connection only.
                log.warning("ingress dispatch failed for %s %s: %s",
                            method, target, e)
                if conn.open:
                    conn.busy = False
                    self._bad_request(conn, f"bad request: {e}")
                return

    def _scan_error(self, conn: _Conn) -> None:
        """A scanner error surfaced behind the already-emitted requests:
        act on it only once those have dispatched (here)."""
        err, conn.perr = conn.perr, 0
        if err == native.ING_EBADLINE:
            self._close(conn)
            return
        self._bad_request(conn, {
            native.ING_EBADLEN: "malformed Content-Length",
            native.ING_EBODY: "body too large",
            native.ING_EHEADERS: "headers too large",
        }.get(err, "bad request"))

    def _bad_request(self, conn: _Conn, msg: str) -> None:
        """400 + close THIS connection; the loop keeps serving the rest."""
        conn.rbuf.clear()       # never re-parse the poisoned bytes
        conn.pending.clear()
        conn.perr = 0
        conn.wbuf += _json_response(400, {"message": msg})
        conn.closing = True
        self._flush_wbuf(conn)

    def _reply(self, conn: _Conn, data: bytes) -> None:
        """Loop-thread synchronous reply to the CURRENT request."""
        conn.busy = False
        conn.wbuf += data
        self._flush_wbuf(conn)

    def _dispatch(self, conn: _Conn, method: str, target: str,
                  headers: Dict[str, str], body: bytes) -> None:
        path, _, query = target.partition("?")
        params = urllib.parse.parse_qs(query, keep_blank_values=True)
        if body and headers.get("content-type", "").startswith(
                "application/x-www-form-urlencoded"):
            for k, v in urllib.parse.parse_qs(
                    body.decode("latin-1"),
                    keep_blank_values=True).items():
                params[k] = v

        def p(name: str, default: str = "") -> str:
            v = params.get(name)
            return v[0] if v else default

        if path == "/health":
            self._reply(conn, _json_response(200, {"health": "true"}))
            return
        if path == "/metrics":
            self._reply(conn, self._metrics_response())
            return
        parts = path.split("/", 3)
        if len(parts) >= 3 and parts[1] == "tenants" and parts[2]:
            try:
                tenant = int(parts[2])
            except ValueError:
                self._reply(conn, _json_response(
                    404, {"message": f"no such tenant {parts[2]!r}"}))
                return
            rest = "/" + (parts[3] if len(parts) > 3 else "")
            if rest.startswith("/v2/keys"):
                key = rest[len("/v2/keys"):] or "/"
                key = posixpath.normpath("/" + key.lstrip("/"))
                if method in ("PUT", "POST", "DELETE"):
                    self._handle_write(conn, tenant, method, key, p,
                                       headers)
                    return
                if method == "GET":
                    if p("wait") == "true":
                        try:
                            since = int(p("waitIndex") or 0)
                        except ValueError:
                            self._reply(conn, _json_response(400, {
                                "errorCode": 203,
                                "message": "The given index in POST "
                                           "form is not a number"}))
                            return
                        recursive = p("recursive") == "true"
                        stream = p("stream") == "true"
                        if self.hub.subscribe(conn, tenant, key,
                                              recursive, stream, since):
                            if stream:
                                conn.streaming = True
                            return
                        # waitIndex predates the hub ring's coverage:
                        # forward upstream verbatim so history replay /
                        # 401 EventIndexCleared keep direct semantics.
                        if stream:
                            conn.streaming = True
                        self._forward_watch(conn, tenant, key, recursive,
                                            stream, since)
                        return
                    self._forward(conn, tenant, method, target,
                                  headers=headers)
                    return
        # Everything else (status, stats, engine surfaces) proxies
        # through unchanged — the ingress is transparent for them.
        self._forward(conn, None, method, target, body=body,
                      headers=headers)

    def _handle_write(self, conn: _Conn, tenant: int, method: str,
                      key: str, p, headers: Dict[str, str]) -> None:
        item = {"method": method, "path": key}
        if p("value"):
            item["value"] = p("value")
        if p("recursive") == "true":
            item["recursive"] = True
        auth = headers.get("authorization")
        if auth:
            # Batches share ONE upstream connection for many clients:
            # each slot carries its own client's credentials so the
            # engine's per-tenant security evaluates the real identity,
            # not the ingress's anonymous upstream socket.
            item["auth"] = auth
        if p("ttl"):
            try:
                item["ttl"] = int(p("ttl"))
            except ValueError:
                self._reply(conn, _json_response(400, {
                    "errorCode": 202,
                    "message": "The given TTL in POST form is not a "
                               "number"}))
                return
        if p("dir") == "true":
            item["dir"] = True
        if p("refresh") == "true":
            item["refresh"] = True
        if p("prevValue"):
            item["prevValue"] = p("prevValue")
        if p("prevIndex"):
            try:
                item["prevIndex"] = int(p("prevIndex"))
            except ValueError:
                self._reply(conn, _json_response(400, {
                    "errorCode": 203,
                    "message": "The given index in POST form is not a "
                               "number"}))
                return
        if p("prevExist"):
            item["prevExist"] = p("prevExist") == "true"
        size = sum(len(k) + len(str(v)) + 8 for k, v in item.items())
        self.lane(tenant).enqueue(_PendingWrite(conn, item, size))

    def lane(self, tenant: int) -> _Lane:
        lane = self.lanes.get(tenant)
        if lane is None:
            with self._lanes_lock:
                lane = self.lanes.get(tenant)
                if lane is None:
                    lane = self.lanes[tenant] = _Lane(self, tenant)
        return lane

    def _metrics_response(self) -> bytes:
        from etcd_tpu_torch.utils.metrics import REGISTRY, fd_usage
        used, limit = fd_usage()
        extra = (
            "# HELP process_open_fds Number of open file descriptors.\n"
            "# TYPE process_open_fds gauge\n"
            f"process_open_fds {float(used)}\n"
            "# HELP process_max_fds Maximum number of open file "
            "descriptors.\n"
            "# TYPE process_max_fds gauge\n"
            f"process_max_fds {float(limit)}\n")
        return _response(200, (REGISTRY.expose() + extra).encode(),
                         ctype="text/plain; version=0.0.4")

    # -- upstream GET / passthrough forwarding --------------------------------

    def _forward(self, conn: _Conn, tenant: Optional[int], method: str,
                 target: str, body: bytes = b"",
                 headers: Optional[Dict[str, str]] = None) -> None:
        """Proxy a non-coalescable request upstream on a fetcher thread,
        carrying the client's Authorization/Content-Type (identity must
        survive the proxy hop or per-user ACLs break). Quorum GETs may
        be downgraded to local GETs under the lane's read lease (renewed
        by every upstream batch ack — a committed write proves the
        leader held quorum at ack time)."""
        if (tenant is not None and "quorum=true" in target
                and self.cfg.read_lease_ms > 0):
            lane = self.lane(tenant)
            if time.monotonic() < lane.lease_until:
                target = target.replace("quorum=true", "quorum=false")
                obs.ingress_lease_reads.inc()
        fwd_headers = {}
        for k in ("authorization", "content-type"):
            v = (headers or {}).get(k)
            if v:
                fwd_headers[k.title()] = v
        with self._fetch_cv:
            self._fetchq.append((conn, tenant, method, target, body,
                                 fwd_headers))
            self._fetch_cv.notify()

    def _forward_watch(self, conn: _Conn, tenant: int, path: str,
                       recursive: bool, stream: bool, since: int) -> None:
        """A watch whose waitIndex the hub ring cannot cover gets its own
        upstream connection on a dedicated thread (NOT the fetcher pool:
        an unfired watch blocks until its event, and a handful of these
        would starve every plain GET). Upstream then replays from event
        history, answers 401 EventIndexCleared, or blocks — exactly the
        direct-path semantics the ring cannot reproduce."""
        q = (f"wait=true&waitIndex={since}"
             f"&recursive={'true' if recursive else 'false'}")
        if stream:
            q += "&stream=true"
        target = f"/tenants/{tenant}/v2/keys{path}?{q}"
        threading.Thread(target=self._watch_proxy,
                         args=(conn, target, stream), daemon=True,
                         name="ingress-watch-fwd").start()

    def _watch_proxy(self, conn: _Conn, target: str, stream: bool) -> None:
        host, port = _upstream_addr(self.cfg.upstream)
        up = http.client.HTTPConnection(host, port, timeout=None)
        conn.fwd.append(up)      # _close severs this to unblock us
        sent_headers = False
        try:
            up.request("GET", target)
            resp = up.getresponse()
            if not stream or resp.status != 200:
                data = resp.read()
                hdrs = {k: v for k, v in resp.getheaders()
                        if k.lower().startswith("x-etcd")
                        or k.lower().startswith("x-raft")}
                ctype = resp.getheader("Content-Type", "application/json")
                self.post_send(conn, _response(resp.status, data,
                                               ctype=ctype, extra=hdrs),
                               close_after=stream)
                return
            self.post_send(conn, (
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: application/json\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n"))
            sent_headers = True
            while conn.open:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if line:
                    self.post_send(conn, _chunk(line + b"\n"))
            if conn.open:
                self.post_send(conn, b"0\r\n\r\n", close_after=True)
        except Exception as e:  # noqa: BLE001 — fail this conn only
            if conn.open and sent_headers:
                self.post_send(conn, b"0\r\n\r\n", close_after=True)
            elif conn.open:
                self.post_send(conn, _json_response(503, {
                    "errorCode": 300, "message": "Raft Internal Error",
                    "cause": f"ingress upstream watch failed: {e}"}))
        finally:
            try:
                up.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
            try:
                conn.fwd.remove(up)
            except ValueError:
                pass

    def _fetcher(self) -> None:
        upstream: Optional[http.client.HTTPConnection] = None
        host, port = _upstream_addr(self.cfg.upstream)
        while True:
            with self._fetch_cv:
                while not self._fetchq and not self._stop.is_set():
                    self._fetch_cv.wait(0.5)
                if self._stop.is_set():
                    return
                conn, tenant, method, target, body, fwd_headers = \
                    self._fetchq.popleft()
            if not conn.open:
                continue
            try:
                if upstream is None:
                    upstream = http.client.HTTPConnection(
                        host, port, timeout=self.cfg.request_timeout)
                upstream.request(method, target, body=body or None,
                                 headers=fwd_headers)
                resp = upstream.getresponse()
                data = resp.read()
                hdrs = {k: v for k, v in resp.getheaders()
                        if k.lower().startswith("x-etcd")
                        or k.lower().startswith("x-raft")}
                ctype = resp.getheader("Content-Type",
                                       "application/json")
                if (tenant is not None and resp.status == 200
                        and "quorum=true" in target
                        and self.cfg.read_lease_ms > 0):
                    # A served quorum read is itself a leadership proof.
                    self.lane(tenant).lease_until = (
                        time.monotonic()
                        + self.cfg.read_lease_ms / 1000.0)
                self.post_send(conn, _response(resp.status, data,
                                               ctype=ctype, extra=hdrs))
            except Exception as e:  # noqa: BLE001 — per-request fan-back
                try:
                    if upstream is not None:
                        upstream.close()
                except OSError:
                    pass
                upstream = None
                self.post_send(conn, _json_response(503, {
                    "errorCode": 300, "message": "Raft Internal Error",
                    "cause": f"ingress upstream fetch failed: {e}"}))


# ---------------------------------------------------------------------------
# CLI: one ingress process (scripts/ingress_serve.py runs N of these)
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import signal

    ap = argparse.ArgumentParser(
        description="coalescing ingress tier (one process)")
    ap.add_argument("--upstream", required=True,
                    help="engine front or pool router base URL")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--flush-max-requests", type=int, default=1024)
    ap.add_argument("--flush-max-bytes", type=int, default=1 << 20)
    ap.add_argument("--max-inflight", type=int, default=1)
    ap.add_argument("--flush-window", type=int, default=4,
                    help="pipelined flushes per lane on the binary "
                         "upstream channel")
    ap.add_argument("--upstream-mode", default="auto",
                    choices=("auto", "frame", "json"),
                    help="binary batchframe channel, JSON POSTs, or "
                         "auto-detect per lane")
    ap.add_argument("--no-native", action="store_true",
                    help="force the pure-Python request scan / response "
                         "format hot loop")
    ap.add_argument("--read-lease-ms", type=int, default=0)
    args = ap.parse_args(argv)
    ing = Ingress(IngressConfig(
        upstream=args.upstream, host=args.host, port=args.port,
        flush_max_requests=args.flush_max_requests,
        flush_max_bytes=args.flush_max_bytes,
        max_inflight=args.max_inflight,
        flush_window=args.flush_window,
        upstream_mode=args.upstream_mode,
        use_native=(not args.no_native
                    and os.environ.get("ETCD_INGRESS_NO_NATIVE") != "1"),
        read_lease_ms=args.read_lease_ms))
    ing.start()
    print(json.dumps({"port": ing.port, "pid": os.getpid(),
                      "upstream": args.upstream}), flush=True)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    signal.signal(signal.SIGINT, lambda *_: done.set())
    done.wait()
    ing.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main(sys.argv[1:]))
