"""Binary upstream framing between the ingress tier and the engine.

The round-10 ingress shipped every coalesced flush as a JSON POST to
/tenants/{t}/batch over a one-request-at-a-time http.client connection:
encode the whole window as a JSON array, wait for the full response,
decode it, repeat. That hop was the serial clock of the tier — the
engine idled between flushes and every byte crossed two JSON codecs.

This module defines the replacement: a persistent per-lane channel that
HANDSHAKES as HTTP (one POST /tenants/{t}/batchframe answered with
101 Switching Protocols, so it traverses the same listener, router and
auth surface as every other tenant path) and then speaks length-prefixed
binary frames both ways, WINDOWED — up to IngressConfig.flush_window
request frames may be in flight before the first response frame returns,
demultiplexed by flush id.

Wire format (all integers little-endian):

  request frame (ingress -> engine):
      u32  frame_len          bytes after this field
      u64  flush_id           channel-unique; echoes in the response
      u32  auth_len           0 when no slot carries credentials
      .... auth_json          JSON list[str|null], one per slot
      .... payload            P_MULTI blob: 0x02, u32 count,
                              (u32 len, item JSON)* — packed by ONE
                              walcodec.pack_multi call; the engine
                              unpacks it with the same struct walk the
                              WAL replay path uses (engine._unpack_multi)

  response frame (engine -> ingress):
      u32  frame_len
      u64  flush_id
      u32  count              0xFFFFFFFF = frame-level error, then ONE
                              (u32 status, u32 len, body) follows and
                              every rider of the flush receives it
      then count * (u32 status, u32 len, body) — body is the FINAL
      client-facing HTTP response body for that slot, pre-serialized by
      the engine so the ingress fan-back does zero per-request JSON work

The slot payload is the item-dict JSON of the /batch route (NOT an
encoded Request): TTLs must resolve against the ENGINE's clock and
request ids are assigned engine-side, exactly as on the JSON path — the
frame saves the outer array codec, the per-flush connection churn and
the response assembly, not the per-slot schema.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

UPGRADE_NAME = "etcd-batchframe"
FRAME_ERROR = 0xFFFFFFFF
MAX_FRAME = 64 * 1024 * 1024     # allocation cap; flushes are ~1 MB
# Mirror of server/engine.P_MULTI (the payload tag of a multi-request
# log entry) so the ingress process can pack frames without importing
# the engine; tests/test_do_many.py pins the equality.
P_MULTI = 0x02

_U32 = struct.Struct("<I")
_HDR = struct.Struct("<QI")      # flush_id, auth_len | count
_SLOT = struct.Struct("<II")     # status, body_len


# ---------------------------------------------------------------------------
# handshake
# ---------------------------------------------------------------------------

def handshake_request(tenant: int, host: str) -> bytes:
    return (f"POST /tenants/{tenant}/batchframe HTTP/1.1\r\n"
            f"Host: {host}\r\n"
            f"Upgrade: {UPGRADE_NAME}\r\n"
            f"Connection: Upgrade\r\n"
            f"Content-Length: 0\r\n\r\n").encode()


def handshake_response() -> bytes:
    return (f"HTTP/1.1 101 Switching Protocols\r\n"
            f"Upgrade: {UPGRADE_NAME}\r\n"
            f"Connection: Upgrade\r\n\r\n").encode()


def read_handshake_status(rfile) -> int:
    """Read the engine's handshake reply head; returns the HTTP status
    (101 = channel open; anything else = endpoint absent/refused, the
    caller falls back to the JSON path). Raises OSError on EOF."""
    status = None
    while True:
        line = rfile.readline(8192)
        if not line:
            raise OSError("upstream closed during batchframe handshake")
        if status is None:
            parts = line.split(None, 2)
            if len(parts) < 2 or not parts[1].isdigit():
                raise OSError(f"bad handshake status line {line!r}")
            status = int(parts[1])
        if line in (b"\r\n", b"\n"):
            return status


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def pack_request_frame(flush_id: int, auth_json: bytes,
                       payload: bytes) -> bytes:
    body = _HDR.pack(flush_id, len(auth_json))
    return (_U32.pack(len(body) + len(auth_json) + len(payload))
            + body + auth_json + payload)


def pack_response_frame(flush_id: int,
                        slots: List[Tuple[int, bytes]]) -> bytes:
    parts = [_HDR.pack(flush_id, len(slots))]
    for status, body in slots:
        parts.append(_SLOT.pack(status, len(body)))
        parts.append(body)
    blob = b"".join(parts)
    return _U32.pack(len(blob)) + blob


def pack_error_frame(flush_id: int, status: int, body: bytes) -> bytes:
    blob = (_HDR.pack(flush_id, FRAME_ERROR)
            + _SLOT.pack(status, len(body)) + body)
    return _U32.pack(len(blob)) + blob


def _read_exact(rfile, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    out = b""
    while len(out) < n:
        chunk = rfile.read(n - len(out))
        if not chunk:
            if not out:
                return None
            raise OSError("truncated batchframe")
        out += chunk
    return out


def read_request_frame(rfile) -> Optional[Tuple[int, bytes, bytes]]:
    """-> (flush_id, auth_json, payload) or None on clean EOF."""
    hdr = _read_exact(rfile, 4)
    if hdr is None:
        return None
    (ln,) = _U32.unpack(hdr)
    if ln > MAX_FRAME or ln < _HDR.size:
        raise OSError(f"bad batchframe length {ln}")
    blob = _read_exact(rfile, ln)
    if blob is None or len(blob) != ln:
        raise OSError("truncated batchframe")
    flush_id, auth_len = _HDR.unpack_from(blob, 0)
    off = _HDR.size
    if auth_len > ln - off:
        raise OSError("bad batchframe auth length")
    auth_json = blob[off:off + auth_len]
    return flush_id, auth_json, blob[off + auth_len:]


def read_response_frame(rfile
                        ) -> Optional[Tuple[int, Optional[list], tuple]]:
    """-> (flush_id, slots, error) or None on clean EOF; exactly one of
    slots ([(status, body)]) / error ((status, body)) is set."""
    hdr = _read_exact(rfile, 4)
    if hdr is None:
        return None
    (ln,) = _U32.unpack(hdr)
    if ln > MAX_FRAME or ln < _HDR.size:
        raise OSError(f"bad batchframe length {ln}")
    blob = _read_exact(rfile, ln)
    if blob is None or len(blob) != ln:
        raise OSError("truncated batchframe")
    flush_id, count = _HDR.unpack_from(blob, 0)
    off = _HDR.size
    if count == FRAME_ERROR:
        status, blen = _SLOT.unpack_from(blob, off)
        off += _SLOT.size
        return flush_id, None, (status, blob[off:off + blen])
    slots = []
    for _ in range(count):
        if off + _SLOT.size > ln:
            raise OSError("truncated batchframe slot")
        status, blen = _SLOT.unpack_from(blob, off)
        off += _SLOT.size
        if off + blen > ln:
            raise OSError("truncated batchframe slot body")
        slots.append((status, blob[off:off + blen]))
        off += blen
    return flush_id, slots, ()
