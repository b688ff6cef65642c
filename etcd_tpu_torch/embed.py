"""Run a full etcd-tpu member (or proxy) in-process.

The assembly the reference does in etcdmain/etcd.go:127-231 startEtcd:
build the peer transport, the EtcdServer, and the peer + client HTTP
listeners, wired together. Used by the `etcdmain` CLI entry point, the
integration test tier (§4 T4) and the functional chaos tester.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple
from urllib.parse import urlsplit

from etcd_tpu_torch.etcdhttp.client import ClientAPI
from etcd_tpu_torch.etcdhttp.peer import PeerAPI
from etcd_tpu_torch.etcdhttp.web import HttpServer, Router
from etcd_tpu_torch.rafthttp import HttpTransport
from etcd_tpu_torch.server.server import EtcdServer, ServerConfig


def _listen_addr(url: str) -> Tuple[str, int]:
    u = urlsplit(url)
    return u.hostname or "127.0.0.1", u.port or 0


@dataclass
class EtcdConfig:
    """The subset of etcdmain flags an embedded member needs
    (reference etcdmain/config.go:139-208)."""
    name: str
    data_dir: str
    initial_cluster: Dict[str, Sequence[str]]
    listen_peer_urls: Sequence[str] = ()
    listen_client_urls: Sequence[str] = ()
    advertise_client_urls: Sequence[str] = ()
    cluster_token: str = "etcd-cluster"
    snap_count: int = 10000
    catch_up_entries: int = 5000   # log kept behind a snapshot (raft.go:38)
    tick_ms: int = 100
    election_ticks: int = 10
    request_timeout: float = 5.0
    initial_cluster_state: str = "new"   # "new" | "existing" (join)
    force_new_cluster: bool = False
    cors: Sequence[str] = ()             # client-listener CORS origins
    # TLS (reference etcdmain/etcd.go:133-180 listener setup +
    # pkg/transport): client_tls secures the client listeners; peer_tls
    # secures BOTH the peer listeners and the outgoing peer transport
    # (mutual TLS when its ca_file/client_cert_auth are set).
    client_tls: object = None            # Optional[tlsutil.TLSInfo]
    peer_tls: object = None              # Optional[tlsutil.TLSInfo]


class Etcd:
    """One running member: EtcdServer + peer listener + client listener(s)."""

    def __init__(self, cfg: EtcdConfig) -> None:
        if cfg.initial_cluster_state not in ("new", "existing"):
            raise ValueError(
                f"initial_cluster_state must be 'new' or 'existing', got "
                f"{cfg.initial_cluster_state!r}")
        self.cfg = cfg
        peer_urls = (tuple(cfg.listen_peer_urls) or
                     tuple(cfg.initial_cluster.get(cfg.name, ())))
        if not peer_urls:
            raise ValueError(f"no peer URLs for member {cfg.name!r}")
        client_urls = tuple(cfg.listen_client_urls)

        scfg = ServerConfig(
            name=cfg.name, data_dir=cfg.data_dir,
            initial_cluster={k: tuple(v)
                             for k, v in cfg.initial_cluster.items()},
            cluster_token=cfg.cluster_token,
            client_urls=tuple(cfg.advertise_client_urls) or client_urls,
            snap_count=cfg.snap_count, tick_ms=cfg.tick_ms,
            catch_up_entries=cfg.catch_up_entries,
            election_ticks=cfg.election_ticks,
            request_timeout=cfg.request_timeout,
            new_cluster=cfg.initial_cluster_state != "existing",
            force_new_cluster=cfg.force_new_cluster)

        peer_tls = cfg.peer_tls if (cfg.peer_tls is not None
                                    and not cfg.peer_tls.empty()) else None
        client_tls = cfg.client_tls if (cfg.client_tls is not None
                                        and not cfg.client_tls.empty()) \
            else None
        self.transport = HttpTransport(
            tls_context=peer_tls.client_context() if peer_tls else None)
        self.server = EtcdServer(scfg, self.transport)

        # Peer listener(s) — one per peer URL (reference etcd.go:133-160).
        self.peer_http = []
        papi = PeerAPI(self.server)
        for url in peer_urls:
            router = Router()
            papi.install(router)
            host, port = _listen_addr(url)
            self.peer_http.append(HttpServer(
                host, port, router,
                tls_context=peer_tls.server_context() if peer_tls else None))

        # Client listener(s) (reference etcd.go:163-180,211-229), with the
        # v2 security gate + /v2/security routes wired in.
        from etcd_tpu_torch.etcdhttp.client_security import SecurityHandler
        self.client_http = []
        from etcd_tpu_torch.etcdhttp.v3 import V3API
        self.security = SecurityHandler(self.server)
        self.client_api = ClientAPI(self.server, security=self.security)
        self.v3_api = V3API(self.server, security=self.security)
        for url in client_urls:
            router = Router()
            self.client_api.install(router)
            self.security.install(router)
            self.v3_api.install(router)
            host, port = _listen_addr(url)
            # CORS wraps only the CLIENT mux (reference etcd.go:218-229).
            self.client_http.append(
                HttpServer(host, port, router,
                           cors=set(cfg.cors) if cfg.cors else None,
                           tls_context=(client_tls.server_context()
                                        if client_tls else None)))

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for h in self.peer_http + self.client_http:
            h.start()
        self.server.start()

    def stop(self) -> None:
        self.server.stop()
        for h in self.peer_http + self.client_http:
            h.stop()

    def wait_leader(self, timeout: float = 10.0) -> bool:
        return self.server.lead_elected_ev.wait(timeout)

    @property
    def client_urls(self) -> Tuple[str, ...]:
        return tuple(h.url for h in self.client_http)

    @property
    def peer_urls(self) -> Tuple[str, ...]:
        return tuple(h.url for h in self.peer_http)
