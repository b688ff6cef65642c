"""HTTP peer transport — the distributed communication backend.

Behavioral equivalent of reference rafthttp/ (transport.go, peer.go,
pipeline.go): per-peer channels with the liveness contract the consensus
core depends on — sends NEVER block the raft run loop (bounded queue,
drop-on-full + ReportUnreachable, peer.go:156-165); per-peer ordering is
preserved (one sender thread per peer); huge MsgSnap rides a dedicated
side-channel whose outcome is reported back as ReportSnapshot
(peer.go:250-252); multiple endpoint URLs fail over (urlpick.go); Pausable
for fault-injection tests (transport.go:235-249).

Re-designed for this framework: instead of the reference's three channel
classes (msgApp stream / message stream / 4-way POST pipeline) each sender
drains its queue into ONE batched POST per flush — many messages per frame,
amortizing the HTTP round trip the way msgappv2 amortizes encoding
(msgappv2.go:29-63). Latency of successful APP batches feeds LeaderStats.
"""
from __future__ import annotations

import http.client
import queue
import threading
import time
from typing import Dict, Iterable, List, Optional
from urllib.parse import urlsplit

from etcd_tpu_torch.raftpb import Message, MessageType
from etcd_tpu_torch.etcdhttp.peer import RAFT_PREFIX, encode_frames
from etcd_tpu_torch.server.transport import Transporter
from etcd_tpu_torch.utils import metrics

# Reference pipeline.go:36-43: connPerPipeline=4, pipelineBufSize=64.
SEND_QUEUE_CAP = 4 * 64
SNAP_QUEUE_CAP = 4
_BATCH_MAX = 128          # messages drained into one POST
_RETRY_INTERVAL = 0.05    # back-off after a failed POST


class _Conn:
    """One keep-alive HTTP(S) connection to a peer URL."""

    def __init__(self, url: str, timeout: float, tls_context=None) -> None:
        u = urlsplit(url)
        self.host = u.hostname or "localhost"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.https = u.scheme == "https"
        self.tls_context = tls_context
        self.timeout = timeout
        self._c: Optional[http.client.HTTPConnection] = None

    def post(self, path: str, body: bytes, headers: Dict[str, str]) -> int:
        if self._c is None:
            if self.https:
                self._c = http.client.HTTPSConnection(
                    self.host, self.port, timeout=self.timeout,
                    context=self.tls_context)
            else:
                self._c = http.client.HTTPConnection(self.host, self.port,
                                                     timeout=self.timeout)
        try:
            self._c.request("POST", path, body=body, headers=headers)
            resp = self._c.getresponse()
            resp.read()
            return resp.status
        except Exception:
            self.close()
            raise

    def close(self) -> None:
        if self._c is not None:
            try:
                self._c.close()
            except Exception:
                pass
            self._c = None


class _Peer:
    """Sender side for one remote member (reference peer.go:87-190)."""

    def __init__(self, t: "HttpTransport", pid: int,
                 urls: Iterable[str]) -> None:
        self.t = t
        self.id = pid
        self.urls: List[str] = list(urls)
        self._url_idx = 0
        self.q: "queue.Queue[Message]" = queue.Queue(maxsize=SEND_QUEUE_CAP)
        self.snap_q: "queue.Queue[Message]" = queue.Queue(maxsize=SNAP_QUEUE_CAP)
        self._stop = threading.Event()
        self.active = False
        self._threads = [
            threading.Thread(target=self._send_loop, daemon=True,
                             name=f"rafthttp-send-{pid:x}"),
            threading.Thread(target=self._snap_loop, daemon=True,
                             name=f"rafthttp-snap-{pid:x}"),
        ]
        self._conn = _Conn(self.urls[0], t.dial_timeout, t.tls_context)
        self._snap_conn = _Conn(self.urls[0], t.snap_timeout, t.tls_context)
        for th in self._threads:
            th.start()

    # -- raft-facing side (runs on the raft loop thread; must not block) ----

    def send(self, m: Message) -> None:
        if m.type == MessageType.SNAP:
            try:
                self.snap_q.put_nowait(m)
            except queue.Full:
                self.t._report_snapshot(self.id, ok=False)
            return
        try:
            self.q.put_nowait(m)
        except queue.Full:
            # Reference peer.go:156-165: full buffer == congested/down link.
            self.t._report_unreachable(self.id)

    def update_urls(self, urls: Iterable[str]) -> None:
        urls = list(urls)
        if urls:
            self.urls = urls
            self._url_idx = 0

    def stop(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=1)
        self._conn.close()
        self._snap_conn.close()

    # -- wire side ----------------------------------------------------------

    def _pick_url(self) -> str:
        return self.urls[self._url_idx % len(self.urls)]

    def _rotate_url(self) -> None:
        self._url_idx = (self._url_idx + 1) % max(len(self.urls), 1)
        self._conn = _Conn(self._pick_url(), self.t.dial_timeout,
                           self.t.tls_context)

    def _send_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            while len(batch) < _BATCH_MAX:
                try:
                    batch.append(self.q.get_nowait())
                except queue.Empty:
                    break
            if self.t.paused:
                continue  # dropped, like the reference's Pausable
            body = encode_frames(batch)
            t0 = time.time()
            try:
                status = self._conn.post(RAFT_PREFIX, body,
                                         self.t._headers())
            except Exception:
                status = -1
            ms = (time.time() - t0) * 1000.0
            has_app = any(m.type == MessageType.APP for m in batch)
            if status in (200, 204):
                self.active = True
                if has_app:
                    self.t._app_sent(self.id, ms, len(body))
            else:
                self.active = False
                self._rotate_url()
                if has_app:
                    self.t._app_failed(self.id)
                self.t._report_unreachable(self.id)
                time.sleep(_RETRY_INTERVAL)

    def _snap_loop(self) -> None:
        while not self._stop.is_set():
            try:
                m = self.snap_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if self.t.paused:
                self.t._report_snapshot(self.id, ok=False)
                continue
            try:
                status = self._snap_conn.post(RAFT_PREFIX,
                                              encode_frames([m]),
                                              self.t._headers())
            except Exception:
                status = -1
            ok = status in (200, 204)
            if not ok:
                self._snap_conn = _Conn(self._pick_url(), self.t.snap_timeout,
                                        self.t.tls_context)
            self.t._report_snapshot(self.id, ok)


class HttpTransport(Transporter):
    """rafthttp.Transporter equivalent over HTTP POSTs. Bind to the server
    (for feedback + stats) via bind(); EtcdServer does this automatically."""

    def __init__(self, dial_timeout: float = 1.0,
                 snap_timeout: float = 30.0, tls_context=None) -> None:
        self.dial_timeout = dial_timeout
        self.snap_timeout = snap_timeout
        # ssl.SSLContext for https:// peer URLs (reference peer TLS,
        # pkg/transport.NewTransport + etcdmain/etcd.go:133-160).
        self.tls_context = tls_context
        self._peers: Dict[int, _Peer] = {}
        self._remotes: Dict[int, _Peer] = {}  # catch-up-only (remote.go)
        self._lock = threading.Lock()
        self.paused = False
        self._server = None

    def bind(self, server) -> None:
        self._server = server

    def member_version(self, mid: int, peer_urls: Iterable[str]):
        """GET /version from the member's peer listener with THIS
        transport's TLS context — a TLS-secured cluster must negotiate its
        version over the same mutual-TLS channel its raft traffic uses
        (reference getVersions uses the peer transport,
        cluster_util.go:118-137)."""
        import json as _json
        import ssl as _ssl
        import urllib.request
        for u in peer_urls:
            if not u.startswith(("http://", "https://")):
                continue
            try:
                with urllib.request.urlopen(
                        u.rstrip("/") + "/version", timeout=0.5,
                        context=self.tls_context if u.startswith("https://")
                        else None) as resp:
                    return _json.loads(resp.read()).get("etcdserver")
            except Exception:
                continue
        return None

    # -- Transporter ---------------------------------------------------------

    def send(self, msgs: Iterable[Message]) -> None:
        for m in msgs:
            if m.to == 0:
                continue
            with self._lock:
                p = self._peers.get(m.to) or self._remotes.get(m.to)
            if p is None:
                continue
            p.send(m)

    def add_peer(self, mid: int, urls: Iterable[str]) -> None:
        with self._lock:
            # Promote a catch-up remote to a full peer (reference
            # transport.go AddPeer removes the remote entry).
            old_remote = self._remotes.pop(mid, None)
            if mid in self._peers:
                self._peers[mid].update_urls(urls)
            else:
                self._peers[mid] = _Peer(self, mid, urls)
        if old_remote is not None:
            old_remote.stop()

    def add_remote(self, mid: int, urls: Iterable[str]) -> None:
        """A non-member we still replicate to while it catches up
        (reference rafthttp/remote.go)."""
        with self._lock:
            if mid in self._peers or mid in self._remotes:
                return
            self._remotes[mid] = _Peer(self, mid, urls)

    def remove_peer(self, mid: int) -> None:
        with self._lock:
            p = self._peers.pop(mid, None)
            r = self._remotes.pop(mid, None)
        for x in (p, r):
            if x is not None:
                x.stop()
        if self._server is not None:
            self._server.lstats.remove(mid)

    def update_peer(self, mid: int, urls: Iterable[str]) -> None:
        with self._lock:
            p = self._peers.get(mid)
        if p is not None:
            p.update_urls(urls)

    def stop(self) -> None:
        with self._lock:
            peers = list(self._peers.values()) + list(self._remotes.values())
            self._peers.clear()
            self._remotes.clear()
        for p in peers:
            p.stop()

    # -- fault injection (reference Pausable transport.go:235-249) ----------

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def active_since(self, mid: int) -> bool:
        with self._lock:
            p = self._peers.get(mid)
        return p.active if p is not None else False

    # -- feedback into the consensus core ------------------------------------

    def _headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/octet-stream"}
        if self._server is not None:
            h["X-Etcd-Cluster-ID"] = f"{self._server.cluster.cluster_id:x}"
            h["X-Server-From"] = f"{self._server.id:x}"
        return h

    def _report_unreachable(self, pid: int) -> None:
        if self._server is not None:
            self._server.report_unreachable(pid)

    def _report_snapshot(self, pid: int, ok: bool) -> None:
        if self._server is not None:
            self._server.report_snapshot(pid, ok)

    def _app_sent(self, pid: int, ms: float, nbytes: int) -> None:
        if self._server is not None:
            self._server.lstats.succ(pid, ms)
            self._server.stats.send_append_req(nbytes)
        metrics.msg_sent_latency.labels(
            "pipeline", f"{pid:x}", "MsgApp").observe(ms * 1e3)

    def _app_failed(self, pid: int) -> None:
        if self._server is not None:
            self._server.lstats.failed(pid)
        metrics.msg_sent_failed.labels("pipeline", f"{pid:x}",
                                       "MsgApp").inc()
