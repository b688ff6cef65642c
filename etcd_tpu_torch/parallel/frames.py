"""Batched DCN frame transport between engine hosts.

This is the host-to-host control plane of the multi-host MultiEngine
(server/hostengine.py): the consensus HOT path (votes, appends, acks,
commit metadata) rides the kernel's all_to_all collective over the mesh
peers axis and never touches this module — what remains is exactly what
the reference moves over rafthttp (rafthttp/transport.go:36-70):

  PROPOSE   client requests forwarded to the leader slot's host
  PAYLOAD   entry payloads fanned out by the admitting host (each host
            applies every group's store, like a reference member)
  PULL/RESP payload catch-up after drops or restarts

Transport semantics mirror the reference's peer transport (peer.go:87-190):
one ordered stream per peer pair, nonblocking sends into a bounded queue
with DROP on overflow plus a report_unreachable callback (peer.go:156-165;
the protocol retries via timeouts/pulls), background reconnect. Framing is
length-prefixed: u32 header-length + JSON header + u32 blob-length + blob.
"""
from __future__ import annotations

import itertools
import json
import logging
import socket
import struct
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

log = logging.getLogger("etcd_tpu.frames")

_HDR = struct.Struct("<II")  # json length, blob length
_MAX_QUEUE = 4096


class FrameTransport:
    """Frames between N engine hosts on a static peer map."""

    def __init__(self, host_id: int, listen_addr: Tuple[str, int],
                 peers: Dict[int, Tuple[str, int]],
                 on_frame: Callable[[int, dict, bytes], None],
                 report_unreachable: Optional[Callable[[int], None]] = None
                 ) -> None:
        self.host_id = host_id
        self.peers = {int(h): tuple(a) for h, a in peers.items()
                      if int(h) != host_id}
        self.on_frame = on_frame
        self.report_unreachable = report_unreachable or (lambda h: None)
        # Partition injection (the reference's iptables isolation,
        # pkg/netutil/isolate_linux.go:23-44 / etcd-tester failure.go
        # isolate classes): host ids here are ALIVE BUT UNREACHABLE —
        # outgoing frames to them are dropped at enqueue and incoming
        # frames from them are dropped at delivery, both directions,
        # while the processes keep running. Tests/chaos flip this set.
        self.blocked: set = set()
        self.blocked_dropped = 0
        self._stop = threading.Event()
        self._qs: Dict[int, deque] = {h: deque(maxlen=_MAX_QUEUE)
                                      for h in self.peers}
        self._evs: Dict[int, threading.Event] = {h: threading.Event()
                                                 for h in self.peers}
        # Enqueue order: each queued frame's first field.
        self._seq = itertools.count()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(listen_addr)
        self._srv.listen(16)
        self.addr = self._srv.getsockname()
        self._threads = [threading.Thread(target=self._accept_loop,
                                          daemon=True, name="frames-accept")]
        for h in self.peers:
            self._threads.append(threading.Thread(
                target=self._send_loop, args=(h,), daemon=True,
                name=f"frames-send-{h}"))
        for t in self._threads:
            t.start()

    # -- send side ----------------------------------------------------------

    def send(self, to: int, header: dict, blob: bytes = b"") -> None:
        """Nonblocking: enqueue or drop-oldest (bounded queue). Loss is
        legal — PROPOSE loss surfaces as a client timeout, PAYLOAD loss is
        repaired by PULL."""
        if to in self.blocked:
            self.blocked_dropped += 1
            return
        q = self._qs.get(to)
        if q is None:
            return
        if len(q) == q.maxlen:
            self.report_unreachable(to)
        q.append((next(self._seq), header, blob))
        self._evs[to].set()

    def broadcast(self, header: dict, blob: bytes = b"") -> None:
        for h in self.peers:
            self.send(h, header, blob)

    def _send_loop(self, h: int) -> None:
        sock = None
        addr = self.peers[h]
        while not self._stop.is_set():
            if sock is None:
                began = next(self._seq)
                try:
                    sock = socket.create_connection(addr, timeout=2.0)
                    sock.sendall(struct.pack("<I", self.host_id))
                except OSError:
                    sock = None
                    self.report_unreachable(h)
                    # Drop what piled up while unreachable; the protocol
                    # heals via pulls/timeouts (reference drop-on-full).
                    # A frame queued since the attempt began waits for
                    # the next one: the peer may be listening by then.
                    q = self._qs[h]
                    while q and q[0][0] < began:
                        q.popleft()
                    if self._stop.wait(0.2):
                        return
                    continue
            ev = self._evs[h]
            if not self._qs[h]:
                ev.wait(0.1)
                ev.clear()
                continue
            try:
                _, header, blob = self._qs[h].popleft()
            except IndexError:
                continue
            try:
                hj = json.dumps(header).encode()
                sock.sendall(_HDR.pack(len(hj), len(blob)) + hj + blob)
            except OSError:
                try:
                    sock.close()
                finally:
                    sock = None
                self.report_unreachable(h)
        if sock is not None:
            sock.close()

    # -- receive side -------------------------------------------------------

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._recv_loop, args=(conn,),
                             daemon=True, name="frames-recv").start()
        self._srv.close()

    def _recv_all(self, conn: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return buf

    def _recv_loop(self, conn: socket.socket) -> None:
        conn.settimeout(None)
        hello = self._recv_all(conn, 4)
        if hello is None:
            conn.close()
            return
        (frm,) = struct.unpack("<I", hello)
        while not self._stop.is_set():
            hdr = self._recv_all(conn, _HDR.size)
            if hdr is None:
                break
            hlen, blen = _HDR.unpack(hdr)
            hj = self._recv_all(conn, hlen)
            blob = self._recv_all(conn, blen) if blen else b""
            if hj is None or (blen and blob is None):
                break
            if frm in self.blocked:
                self.blocked_dropped += 1
                continue     # partition injection: read, never deliver
            try:
                self.on_frame(frm, json.loads(hj.decode()), blob or b"")
            except Exception:  # noqa: BLE001 — a bad frame must not kill rx
                log.exception("frame handler failed (from host %d)", frm)
        conn.close()

    def stop(self) -> None:
        self._stop.set()
        for ev in self._evs.values():
            ev.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2)


def wait_peers(tr: FrameTransport, probe_interval: float = 0.1,
               timeout: float = 30.0) -> bool:
    """Best-effort wait until every peer accepts connections (boot
    barrier convenience for launchers/tests)."""
    deadline = time.time() + timeout
    missing = dict(tr.peers)
    while missing and time.time() < deadline:
        for h, addr in list(missing.items()):
            try:
                s = socket.create_connection(addr, timeout=1.0)
                s.close()
                del missing[h]
            except OSError:
                pass
        if missing:
            time.sleep(probe_interval)
    return not missing
