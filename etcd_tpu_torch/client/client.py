"""Multi-endpoint HTTP client core.

Behavioral equivalent of reference client/client.go:112-244: a list of
endpoints tried in order until one answers (httpClusterClient.Do), with
Sync() refreshing the endpoint list from /v2/members and a pinned endpoint
moved to front on success. Transport is stdlib urllib — the SDK talks only
the public HTTP API, never server internals.
"""
from __future__ import annotations

import json
import random
import threading
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple


class ClientError(Exception):
    pass


class ClusterError(ClientError):
    """All endpoints failed (reference client.go ClusterError)."""

    def __init__(self, errors_: List[Exception]) -> None:
        self.errors = errors_
        super().__init__(
            "; ".join(f"{type(e).__name__}: {e}" for e in errors_)
            or "no endpoints")


class HttpResponse:
    def __init__(self, status: int, headers: Dict[str, str],
                 body: bytes) -> None:
        self.status = status
        self.headers = headers
        self.body = body

    def json(self):
        return json.loads(self.body) if self.body else None


class Client:
    """A cluster-aware HTTP client; thread-safe."""

    def __init__(self, endpoints: Sequence[str], timeout: float = 5.0,
                 username: str = "", password: str = "",
                 proxy: str = "", tls=None) -> None:
        """proxy: optional HTTP proxy URL all requests are routed through
        (reference discovery newProxyFunc + http.Transport.Proxy).
        tls: a utils.tlsutil.TLSInfo (or ready ssl.SSLContext) for
        https:// endpoints — CA verification + optional client cert
        (reference client TLS flags, etcdmain/config.go:166-180)."""
        if not endpoints:
            raise ValueError("at least one endpoint required")
        self._lock = threading.Lock()
        self._endpoints = [e.rstrip("/") for e in endpoints]
        self.timeout = timeout
        self.username = username
        self.password = password
        if proxy and "://" not in proxy:
            proxy = "http://" + proxy
        self.proxy = proxy
        import ssl as _ssl
        if tls is None or isinstance(tls, _ssl.SSLContext):
            self.tls_context = tls
        else:
            from etcd_tpu_torch.utils.tlsutil import client_context_or_none
            self.tls_context = client_context_or_none(tls)

    @property
    def endpoints(self) -> List[str]:
        with self._lock:
            return list(self._endpoints)

    def set_endpoints(self, endpoints: Sequence[str]) -> None:
        with self._lock:
            if endpoints:
                self._endpoints = [e.rstrip("/") for e in endpoints]

    def sync(self) -> None:
        """Refresh endpoints from the cluster itself (reference
        client.go:179-215 Sync)."""
        resp = self.do("GET", "/v2/members")
        if resp.status != 200:
            raise ClientError(f"sync failed: HTTP {resp.status}")
        eps: List[str] = []
        for m in resp.json().get("members", []):
            eps.extend(m.get("clientURLs") or [])
        self.set_endpoints(eps)

    # -- request plumbing ---------------------------------------------------

    def _request_one(self, endpoint: str, method: str, path: str,
                     body: Optional[bytes], headers: Dict[str, str],
                     timeout: float) -> HttpResponse:
        r = urllib.request.Request(endpoint + path, data=body,
                                   method=method, headers=headers)
        if self.proxy:
            from urllib.parse import urlsplit
            pu = urlsplit(self.proxy)
            host = pu.hostname + (f":{pu.port}" if pu.port else "")
            r.set_proxy(host, urlsplit(endpoint).scheme or "http")
            if pu.username:
                import base64
                cred = base64.b64encode(
                    f"{pu.username}:{pu.password or ''}".encode()).decode()
                r.add_header("Proxy-Authorization", f"Basic {cred}")
        if self.username:
            import base64
            cred = base64.b64encode(
                f"{self.username}:{self.password}".encode()).decode()
            r.add_header("Authorization", f"Basic {cred}")
        try:
            with urllib.request.urlopen(r, timeout=timeout,
                                        context=self.tls_context) as resp:
                return HttpResponse(resp.status, dict(resp.headers),
                                    resp.read())
        except urllib.error.HTTPError as e:
            return HttpResponse(e.code, dict(e.headers), e.read())

    def do(self, method: str, path: str, body: Optional[bytes] = None,
           headers: Optional[Dict[str, str]] = None,
           timeout: Optional[float] = None) -> HttpResponse:
        """Try every endpoint in order; first HTTP answer wins. 5xx answers
        rotate to the next endpoint too (reference httpClusterClient.Do
        retries on network error and 50x)."""
        headers = dict(headers or {})
        timeout = self.timeout if timeout is None else timeout
        failures: List[Exception] = []
        last: Optional[HttpResponse] = None
        for ep in self.endpoints:
            try:
                resp = self._request_one(ep, method, path, body, headers,
                                         timeout)
            except Exception as e:
                failures.append(e)
                continue
            if resp.status >= 500:
                last = resp
                continue
            self._pin(ep)
            return resp
        if last is not None:
            return last
        raise ClusterError(failures)

    def _pin(self, endpoint: str) -> None:
        with self._lock:
            if self._endpoints and self._endpoints[0] != endpoint and \
                    endpoint in self._endpoints:
                self._endpoints.remove(endpoint)
                self._endpoints.insert(0, endpoint)
