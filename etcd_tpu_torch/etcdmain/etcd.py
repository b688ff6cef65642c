"""Process entry for `etcd-tpu` (python -m etcd_tpu_torch): the engine mode.

Behavioral equivalent of reference etcdmain/etcd.go Main() for the
multi-tenant engine: parse flags/env, default the data dir from the
member name (etcd.go:96-99), identify whether the data dir was
previously a member, a proxy or an engine (identifyDataDirOrDie
etcd.go:376-404) and serve G tenant groups from one `MultiEngine` on
the device `--engine-device` names (the card unless asked for the CPU),
or with `--engine-mesh-peers-axis N` on a ("groups", "peers") mesh of
every visible card (parallel/mesh.py).

The member and proxy modes of the JAX package's CLI belong to the
single-group server and the proxy, which this package does not have
yet; asked for either, `main` says so and returns 1.
"""
from __future__ import annotations

import logging
import os
import signal
import sys
import threading
from typing import Optional, Sequence, Tuple
from urllib.parse import urlsplit

from etcd_tpu_torch.utils.tlsutil import TLSInfo
from etcd_tpu_torch.etcdmain.config import (ConfigError, MainConfig,
                                            parse_args)

log = logging.getLogger("etcdmain")

DIR_MEMBER, DIR_PROXY, DIR_ENGINE, DIR_EMPTY = ("member", "proxy",
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


def _listen_addr(url: str) -> Tuple[str, int]:
    u = urlsplit(url)
    return u.hostname or "127.0.0.1", u.port or 0


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

    if cfg.is_engine != (which == DIR_ENGINE) and which != DIR_EMPTY:
        requested = ("engine" if cfg.is_engine
                     else "proxy" if cfg.is_proxy else "member")
        print(f"cannot start as {requested}: data dir {cfg.data_dir} was "
              f"previously initialized as {which}", file=sys.stderr)
        return 1
    if not cfg.is_engine:
        mode, item = (("proxy", "A10") if cfg.is_proxy or which == DIR_PROXY
                      else ("member", "A9"))
        print(f"cannot start as {mode}: the {mode} mode is not in the "
              f"PyTorch port yet (ROADMAP {item}); use --engine-groups",
              file=sys.stderr)
        return 1

    stop_ev = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop_ev.set())
        except ValueError:
            pass  # not the main thread (tests)

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
    return 0
