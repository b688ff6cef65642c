"""TLS plumbing for listeners, the peer transport, clients and the proxy.

Behavioral equivalent of reference pkg/transport (listener.go:28-,
transport.go): a TLSInfo {cert, key, trusted CA, client-cert-auth} that can
mint a server-side or client-side context. Python's ssl module replaces Go's
crypto/tls; the same files and the same verification semantics apply:

- server: presents cert/key; with `client_cert_auth` (or a CA given for the
  peer listener) it REQUIRES and verifies client certificates against the CA
  (reference ClientConfig/ServerConfig split, listener.go:200-233).
- client: verifies the server against the CA; presents cert/key when given
  (mutual TLS between peers, reference transport.go NewTransport).
"""
from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TLSInfo:
    cert_file: str = ""
    key_file: str = ""
    ca_file: str = ""          # trusted CA for verifying the other side
    client_cert_auth: bool = False

    def empty(self) -> bool:
        return not (self.cert_file or self.key_file or self.ca_file)

    def server_context(self) -> ssl.SSLContext:
        """Context for a listening socket (reference ServerConfig
        listener.go:213-233)."""
        if not (self.cert_file and self.key_file):
            raise ValueError(
                "TLS listener requires both cert_file and key_file "
                f"(got cert={self.cert_file!r} key={self.key_file!r})")
        if self.client_cert_auth and not self.ca_file:
            raise ValueError("client_cert_auth requires ca_file")
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        if self.ca_file:
            # A trusted CA on a listener ALWAYS requires and verifies
            # client certificates (reference listener.go:222-228: CAFile
            # implies tls.RequireAndVerifyClientCert) — CERT_OPTIONAL would
            # silently admit unauthenticated peers.
            ctx.load_verify_locations(self.ca_file)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def client_context(self) -> ssl.SSLContext:
        """Context for dialing out (reference ClientConfig
        listener.go:200-211)."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if self.ca_file:
            ctx.load_verify_locations(self.ca_file)
            ctx.check_hostname = False  # peers dial IPs; CA pinning is the gate
        else:
            # No CA: encrypted but unauthenticated (reference
            # InsecureSkipVerify when trusted CA absent).
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if self.cert_file and self.key_file:
            ctx.load_cert_chain(self.cert_file, self.key_file)
        return ctx


def client_context_or_none(info: Optional["TLSInfo"]) -> Optional[ssl.SSLContext]:
    if info is None or info.empty():
        return None
    return info.client_context()


def open_conn(url: str, timeout: float, tls_context=None):
    """http.client connection for `url`, TLS-aware: HTTPSConnection with
    the given context for https://, plain HTTPConnection otherwise. The
    single construction point for every outbound TLS-capable dialer
    (peer /members fetches, proxy upstream relay)."""
    import http.client
    from urllib.parse import urlsplit

    u = urlsplit(url)
    if u.scheme == "https":
        return http.client.HTTPSConnection(u.hostname, u.port,
                                           timeout=timeout,
                                           context=tls_context)
    return http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
