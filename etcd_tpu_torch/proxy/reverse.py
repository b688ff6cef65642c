"""The request-forwarding half of proxy mode.

Behavioral equivalent of reference proxy/reverse.go + proxy.go: buffer the
client request body once, strip single-hop headers (reverse.go:24-44), try
each available endpoint in director order — marking an endpoint failed and
moving on when the dial/send errors (reverse.go:113-127) — and relay the
first successful response. 503 when zero endpoints are available
(reverse.go:84-91), 502 when every endpoint fails (reverse.go:131-137).

Like the reference (whose proxy transport has no response deadline and
cancels the upstream request when the client goes away,
reverse.go:93-108), a dial gets a short timeout but the response read is
unbounded — v2 watch long-polls park here until the member answers — and a
watchdog cancels the upstream socket once the downstream client
disconnects. Chunked upstream responses (stream watches) are re-chunked
through instead of buffered.

``readonly`` wraps a handler to reject non-GETs with 501 (proxy.go:48-63).
"""
from __future__ import annotations

import http.client
import json
import socket
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple
from urllib.parse import urlsplit

from etcd_tpu_torch.etcdhttp.web import Ctx
from etcd_tpu_torch.proxy.director import Director

# RFC 2616 hop-by-hop headers the reference strips (reverse.go:24-35).
SINGLE_HOP_HEADERS = {"connection", "keep-alive", "proxy-authenticate",
                      "proxy-authorization", "te", "trailers",
                      "transfer-encoding", "upgrade"}


def _clean_headers(src) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for k, v in src.items():
        if k.lower() not in SINGLE_HOP_HEADERS and k.lower() != "host":
            out[k] = v
    return out


class ReverseProxy:
    """Install as a catch-all route: ``router.add("/", proxy.handle)``."""

    def __init__(self, director: Director, dial_timeout: float = 5.0,
                 tls_context=None) -> None:
        self.director = director
        self.dial_timeout = dial_timeout
        # ssl context for https:// upstream endpoints (reference startProxy
        # wires the client TLSInfo into the outbound transport).
        self.tls_context = tls_context

    def handle(self, ctx: Ctx, suffix: str) -> None:
        endpoints = self.director.endpoints()
        if not endpoints:
            ctx.send_json(503, {"message":
                                "proxy: zero endpoints currently available"})
            return

        headers = _clean_headers(ctx.headers)
        # X-Forwarded-For chain (reverse.go maybeSetForwardedFor).
        client_ip = ctx.remote_addr().rsplit(":", 1)[0]
        prior = headers.get("X-Forwarded-For")
        headers["X-Forwarded-For"] = (f"{prior}, {client_ip}" if prior
                                      else client_ip)

        # Original request target including the query string.
        target = ctx._h.path

        for ep in endpoints:
            conn = self._dial_and_send(ep.url, ctx.method, target, ctx.body,
                                       headers)
            if conn is None:
                # Dial/send failure: this member is down — quarantine and
                # fail over (reverse.go:119-126).
                ep.failed()
                continue
            self._relay(ctx, conn)
            return

        ctx.send_json(502, {"message":
                            f"proxy: unable to get response from "
                            f"{len(endpoints)} endpoint(s)"})

    def _dial_and_send(self, base: str, method: str, target: str,
                       body: bytes, headers: Dict[str, str]
                       ) -> Optional[http.client.HTTPConnection]:
        from etcd_tpu_torch.utils.tlsutil import open_conn
        conn = open_conn(base, self.dial_timeout, self.tls_context)
        try:
            conn.connect()
            # Dial succeeded — lift the deadline so long-polls can park.
            conn.sock.settimeout(None)
            conn.request(method, target, body=body or None, headers=headers)
            return conn
        except OSError:
            conn.close()
            return None

    def _relay(self, ctx: Ctx, conn: http.client.HTTPConnection) -> None:
        """Wait for the upstream response (unbounded — watch long-polls),
        then relay it; chunked responses stream through. A watchdog severs
        the upstream socket when the downstream client disconnects (the
        CloseNotify/CancelRequest pair of reverse.go:93-108)."""
        done = threading.Event()

        def watchdog() -> None:
            while not done.wait(2.0):
                if ctx.client_gone():
                    try:
                        conn.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    conn.close()
                    return

        t = threading.Thread(target=watchdog, daemon=True,
                             name="proxy-watchdog")
        t.start()
        try:
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException):
            # Watchdog cancel or upstream died mid-response: nothing useful
            # to relay; the endpoint already answered the dial, so no
            # quarantine.
            done.set()
            conn.close()
            return

        rheaders = dict(resp.getheaders())
        passthrough = {k: v for k, v in rheaders.items()
                       if k.lower() not in SINGLE_HOP_HEADERS and
                       k.lower() not in ("content-type", "content-length")}
        ctype = rheaders.get("Content-Type", "text/plain")
        try:
            if resp.chunked:
                ctx.begin_stream(resp.status, ctype, passthrough)
                while True:
                    chunk = resp.read(4096)
                    if not chunk:
                        ctx.end_stream()
                        return
                    if not ctx.write_chunk(chunk):
                        return
            else:
                ctx.send(resp.status, resp.read(), ctype, passthrough)
        except (OSError, http.client.HTTPException):
            pass
        finally:
            done.set()
            conn.close()


def readonly(handler: Callable[[Ctx, str], None]) -> Callable[[Ctx, str], None]:
    """Reject mutating methods with 501 (reference proxy.go:54-63)."""
    def wrapped(ctx: Ctx, suffix: str) -> None:
        if ctx.method != "GET":
            ctx.send(501)
            return
        handler(ctx, suffix)
    return wrapped


def fetch_cluster_urls(peer_urls: Iterable[str], timeout: float = 2.0,
                       tls_context=None) -> Tuple[List[str], List[str]]:
    """GET /members from each peer until one answers; return
    (client_urls, peer_urls) of the cluster — the proxy's view-refresh
    primitive (reference cluster_util.go:54-98 GetClusterFromRemotePeers,
    used by etcdmain/etcd.go:288-323 startProxy's urls func)."""
    from etcd_tpu_torch.utils.tlsutil import open_conn
    for base in peer_urls:
        try:
            conn = open_conn(base, timeout, tls_context)
            try:
                conn.request("GET", "/members")
                resp = conn.getresponse()
                if resp.status != 200:
                    continue
                data = json.loads(resp.read().decode())
            finally:
                conn.close()
        except (OSError, ValueError):
            continue
        members = data.get("members", [])
        curls = [c for m in members for c in m.get("clientURLs", [])]
        purls = [p for m in members for p in m.get("peerURLs", [])]
        if purls:
            return curls, purls
    return [], []
