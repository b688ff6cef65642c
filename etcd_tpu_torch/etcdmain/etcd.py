"""Process entry for `etcd-tpu` (python -m etcd_tpu_torch).

Behavioral equivalent of reference etcdmain/etcd.go Main(): parse
flags/env, default the data dir from the member name (etcd.go:96-99),
identify whether the data dir was previously a member, a proxy or an
engine (identifyDataDirOrDie etcd.go:376-404) and start the matching
mode; discovery full-cluster errors fall back to proxy mode when
configured (etcd.go:99-107):

- member mode (the default): one member of a static `--initial-cluster`
  running one Raft group (`start_etcd`, reference startEtcd
  etcd.go:127-231), or of one bootstrapped through a discovery registry
  (`--discovery` URL or `--discovery-srv` domain). It is the reference's
  scalar host path, as in the JAX package: the Raft core, WAL, store and
  transports are host Python and C, so this mode creates no tensor and
  no CUDA context and needs no card;
- proxy mode (`--proxy on|readonly`, or a data dir that was a proxy's):
  stateless fan-out to the cluster's members (`ProxyServer`), host code
  too;
- engine mode (`--engine-groups G`): G tenant groups from one
  `MultiEngine` on the device `--engine-device` names (the card unless
  asked for the CPU), or with `--engine-mesh-peers-axis N` on a
  ("groups", "peers") mesh of every visible card (parallel/mesh.py).
"""
from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
from typing import List, Optional, Sequence

from etcd_tpu_torch.embed import Etcd, EtcdConfig, _listen_addr
from etcd_tpu_torch.etcdhttp.web import HttpServer, Router
from etcd_tpu_torch.utils.tlsutil import TLSInfo
from etcd_tpu_torch.etcdmain.config import (ConfigError, MainConfig,
                                            parse_args)
from etcd_tpu_torch.proxy import (Director, ReverseProxy, fetch_cluster_urls,
                                  readonly, write_cluster_file)
from etcd_tpu_torch.proxy.director import PROXY_DIR_NAME

log = logging.getLogger("etcdmain")

DIR_MEMBER, DIR_PROXY, DIR_ENGINE, DIR_EMPTY = ("member", PROXY_DIR_NAME,
                                                "engine", "empty")


def identify_data_dir(dir_: str) -> str:
    """Which mode this data dir was used for (reference etcd.go:376-404;
    engine/ is this framework's multi-tenant mode)."""
    try:
        names = os.listdir(dir_)
    except FileNotFoundError:
        return DIR_EMPTY
    present = [d for d in (DIR_MEMBER, DIR_PROXY, DIR_ENGINE)
               if d in names]
    if len(present) > 1:
        raise ConfigError(
            f"invalid datadir: {' and '.join(present)} directories both "
            "exist")
    return present[0] if present else DIR_EMPTY


def start_etcd(cfg: MainConfig) -> Etcd:
    """Launch a consensus member (reference startEtcd etcd.go:127-231)."""
    initial_cluster = dict(cfg.initial_cluster)
    token = cfg.initial_cluster_token
    if cfg.discovery or cfg.discovery_srv:
        from etcd_tpu_torch.discovery import (join_cluster, srv_cluster)
        if not os.path.isdir(os.path.join(cfg.data_dir, "member")):
            if cfg.discovery:
                s = join_cluster(cfg.discovery, cfg.name,
                                 cfg.initial_advertise_peer_urls,
                                 proxy_url=cfg.discovery_proxy)
            else:
                s = srv_cluster(cfg.discovery_srv, cfg.name,
                                cfg.initial_advertise_peer_urls)
            from etcd_tpu_torch.etcdmain.config import parse_initial_cluster
            initial_cluster = parse_initial_cluster(s)
            token = cfg.discovery or cfg.discovery_srv

    ecfg = EtcdConfig(
        name=cfg.name,
        data_dir=cfg.data_dir,
        initial_cluster=initial_cluster,
        listen_peer_urls=cfg.listen_peer_urls,
        listen_client_urls=cfg.listen_client_urls,
        advertise_client_urls=cfg.advertise_client_urls,
        cluster_token=token,
        snap_count=cfg.snapshot_count,
        tick_ms=cfg.heartbeat_interval,
        election_ticks=cfg.election_ticks,
        initial_cluster_state=cfg.initial_cluster_state,
        force_new_cluster=cfg.force_new_cluster,
        cors=cfg.cors,
        client_tls=TLSInfo(cert_file=cfg.cert_file, key_file=cfg.key_file,
                           ca_file=cfg.ca_file,
                           client_cert_auth=cfg.client_cert_auth),
        peer_tls=TLSInfo(cert_file=cfg.peer_cert_file,
                         key_file=cfg.peer_key_file,
                         ca_file=cfg.peer_ca_file,
                         client_cert_auth=cfg.peer_client_cert_auth),
    )
    e = Etcd(ecfg)
    e.start()
    log.info("etcd-tpu member %s listening: client=%s peer=%s",
             cfg.name, e.client_urls, e.peer_urls)
    return e


def _engine_mesh(cfg: MainConfig):
    """The ("groups", "peers") mesh of -engine-mesh-peers-axis over every
    visible card (the CPU, as one device, under -engine-device cpu), with
    flag-level refusals rather than an error from deep in the sharding."""
    import torch
    from etcd_tpu_torch.parallel.mesh import make_mesh
    if cfg.engine_device.startswith("cuda"):
        n = torch.cuda.device_count()
        if n == 0:
            raise ConfigError(
                f"-engine-device {cfg.engine_device} but no CUDA device is "
                "available; pass --engine-device cpu to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [torch.device(cfg.engine_device)]
    n = len(devices)
    pa = cfg.engine_mesh_peers_axis
    if n % pa != 0:
        raise ConfigError(
            f"-engine-mesh-peers-axis {pa} does not divide the "
            f"{n} visible devices")
    if cfg.engine_peers % pa != 0:
        raise ConfigError(
            f"-engine-peers {cfg.engine_peers} must be divisible "
            f"by -engine-mesh-peers-axis {pa}")
    if cfg.engine_groups % (n // pa) != 0:
        raise ConfigError(
            f"-engine-groups {cfg.engine_groups} must be "
            f"divisible by the groups mesh axis ({n // pa} = "
            f"{n} devices / peers-axis {pa})")
    return make_mesh(devices, peers_axis=pa)


class EngineServer:
    """Multi-tenant engine mode: G consensus groups served from one
    batched kernel at /tenants/{g}/v2/keys (docs/deployment.md §2)."""

    def __init__(self, cfg: MainConfig) -> None:
        from etcd_tpu_torch.etcdhttp.tenants import EngineHttp
        from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine

        mesh = None
        if cfg.engine_mesh_peers_axis > 0:
            mesh = _engine_mesh(cfg)
            log.info("engine: sharding over mesh %s",
                     dict(zip(mesh.axis_names, mesh.shape)))
        self.engine = MultiEngine(EngineConfig(
            groups=cfg.engine_groups, peers=cfg.engine_peers,
            window=cfg.engine_window,
            data_dir=os.path.join(cfg.data_dir, DIR_ENGINE),
            round_interval=cfg.engine_interval_ms / 1000.0,
            applier_shards=cfg.engine_applier_shards,
            wal_shards=cfg.engine_wal_shards,
            device=cfg.engine_device, mesh=mesh))
        client_tls = TLSInfo(cert_file=cfg.cert_file, key_file=cfg.key_file,
                             ca_file=cfg.ca_file,
                             client_cert_auth=cfg.client_cert_auth)
        self.http = []
        for url in cfg.listen_client_urls:
            host, port = _listen_addr(url)
            self.http.append(EngineHttp(
                self.engine, host, port,
                cors=set(cfg.cors) if cfg.cors else None,
                tls_context=(client_tls.server_context()
                             if not client_tls.empty() else None)))

    @property
    def client_urls(self):
        return [h.url for h in self.http]

    def start(self) -> None:
        for h in self.http:
            h.start()
        self.engine.start()
        log.info("engine: %d tenant groups x %d peers on %s listening on "
                 "%s", self.engine.cfg.groups, self.engine.cfg.peers,
                 self.engine.device, self.client_urls)

    def stop(self) -> None:
        self.engine.stop()
        for h in self.http:
            h.stop()


class ProxyServer:
    """Proxy mode: stateless fan-out to cluster members, endpoint view
    persisted in <data-dir>/proxy/cluster (reference startProxy
    etcdmain/etcd.go:234-335)."""

    def __init__(self, cfg: MainConfig) -> None:
        self.cfg = cfg
        proxy_dir = os.path.join(cfg.data_dir, DIR_PROXY)
        os.makedirs(proxy_dir, exist_ok=True)
        self._clusterfile = os.path.join(proxy_dir, "cluster")

        if os.path.exists(self._clusterfile):
            with open(self._clusterfile) as f:
                self._peer_urls = json.load(f)["PeerURLs"]
            log.info("proxy: using peer urls %s from cluster file",
                     self._peer_urls)
        else:
            self._peer_urls = [u for urls in cfg.initial_cluster.values()
                               for u in urls]
            if cfg.discovery:
                from etcd_tpu_torch.discovery import get_cluster
                from etcd_tpu_torch.etcdmain.config import (
                    parse_initial_cluster)
                s = get_cluster(cfg.discovery, proxy_url=cfg.discovery_proxy)
                self._peer_urls = [u for urls in
                                   parse_initial_cluster(s).values()
                                   for u in urls]

        # The proxy honors the same TLS + CORS flags as a member: the
        # client TLSInfo secures its listener AND its outbound transport to
        # the cluster (reference startProxy, etcdmain/etcd.go:234-335);
        # the peer TLSInfo authenticates the /members refresh against
        # mutual-TLS peer listeners.
        client_tls = TLSInfo(cert_file=cfg.cert_file, key_file=cfg.key_file,
                             ca_file=cfg.ca_file,
                             client_cert_auth=cfg.client_cert_auth)
        peer_tls = TLSInfo(cert_file=cfg.peer_cert_file,
                           key_file=cfg.peer_key_file,
                           ca_file=cfg.peer_ca_file,
                           client_cert_auth=cfg.peer_client_cert_auth)
        self._out_ctx = (client_tls.client_context()
                         if not client_tls.empty() else None)
        self._peer_ctx = (peer_tls.client_context()
                          if not peer_tls.empty() else None)
        self.director = Director(self._refresh_urls)
        rp = ReverseProxy(self.director, tls_context=self._out_ctx)
        handler = readonly(rp.handle) if cfg.is_readonly_proxy else rp.handle
        self.http: List[HttpServer] = []
        for url in cfg.listen_client_urls:
            host, port = _listen_addr(url)
            router = Router()
            router.add("/", handler)
            self.http.append(HttpServer(
                host, port, router,
                cors=set(cfg.cors) if cfg.cors else None,
                tls_context=(client_tls.server_context()
                             if not client_tls.empty() else None)))

    def _refresh_urls(self) -> List[str]:
        client_urls, peer_urls = fetch_cluster_urls(
            self._peer_urls, tls_context=self._peer_ctx)
        if peer_urls:
            self._peer_urls = peer_urls
            write_cluster_file(self.cfg.data_dir, peer_urls)
        return client_urls

    @property
    def client_urls(self) -> List[str]:
        return [h.url for h in self.http]

    def start(self) -> None:
        for h in self.http:
            h.start()
        log.info("proxy: listening on %s", self.client_urls)

    def stop(self) -> None:
        self.director.stop()
        for h in self.http:
            h.stop()


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s: %(message)s")
    try:
        cfg = parse_args(sys.argv[1:] if argv is None else argv)
    except ConfigError as e:
        print(f"error verifying flags, {e}. See 'etcd-tpu --help'.",
              file=sys.stderr)
        return 1
    if cfg.debug:
        logging.getLogger().setLevel(logging.DEBUG)

    if not cfg.data_dir:
        cfg.data_dir = f"{cfg.name}.etcd"
        log.info("no data-dir provided, using default data-dir ./%s",
                 cfg.data_dir)

    try:
        which = identify_data_dir(cfg.data_dir)
    except ConfigError as e:
        print(str(e), file=sys.stderr)
        return 1
    if which != DIR_EMPTY:
        log.info("already initialized as %s before, starting as etcd %s...",
                 which, which)

    if cfg.is_proxy and which == DIR_MEMBER:
        # Refuse rather than plant a proxy/ dir beside member/ — that would
        # make the data dir permanently unidentifiable.
        print(f"cannot start as proxy: data dir {cfg.data_dir} was "
              f"previously initialized as a member", file=sys.stderr)
        return 1
    if cfg.is_engine != (which == DIR_ENGINE) and which != DIR_EMPTY:
        requested = ("engine" if cfg.is_engine
                     else "proxy" if cfg.is_proxy else "member")
        print(f"cannot start as {requested}: data dir {cfg.data_dir} was "
              f"previously initialized as {which}", file=sys.stderr)
        return 1
    stop_ev = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop_ev.set())
        except ValueError:
            pass  # not the main thread (tests)

    if not cfg.is_engine:
        runner = None
        should_proxy = cfg.is_proxy or which == DIR_PROXY
        if not should_proxy:
            try:
                runner = start_etcd(cfg)
            except Exception as e:
                from etcd_tpu_torch.discovery import FullClusterError
                if (isinstance(e, FullClusterError) and
                        cfg.should_fallback_to_proxy):
                    log.info("discovery cluster full, falling back to proxy")
                    should_proxy = True
                else:
                    print(str(e), file=sys.stderr)
                    return 1
        if should_proxy:
            runner = ProxyServer(cfg)
            runner.start()
        try:
            stop_ev.wait()
        finally:
            runner.stop()
        return 0

    try:
        runner = EngineServer(cfg)
    except (ConfigError, ValueError, RuntimeError) as e:
        # Flag/geometry-level refusals, and a device that is absent or
        # not a device (MultiEngine refuses before it touches the data
        # dir), answer like other config errors, not with a traceback.
        print(str(e), file=sys.stderr)
        return 1
    runner.start()
    try:
        stop_ev.wait()
    finally:
        runner.stop()
        from etcd_tpu_torch.ops.ring_resolve import ring_resolve
        log.info("engine: stopped after %d rounds on %s; ring_resolve "
                 "launches by instantiation %s", runner.engine.round_no,
                 runner.engine.device,
                 json.dumps(ring_resolve.launches_by_variant,
                            sort_keys=True))
    return 0
