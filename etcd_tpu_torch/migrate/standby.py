"""v0.4 standby-info conversion (reference migrate/standby.go).

A v0.4 "standby" was a non-voting node that tracked the cluster through a
`standby_info` JSON file and could be promoted later; v2 dropped the
concept in favor of the stateless PROXY. The conversion therefore reads
the v0.4 file and produces what a v2 proxy needs to start in its place:
the member map for `--initial-cluster` and the `<data-dir>/proxy/cluster`
endpoint file the ProxyServer boots from (etcdmain/etcd.py ProxyServer).

File format (reference StandbyInfo4, migrate/standby.go:24-37):
    {"Running": bool, "SyncInterval": float,
     "Cluster": [{"name", "state", "clientURL", "peerURL"}, ...]}
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List

STANDBY_INFO_NAME = "standby_info"


@dataclass
class Machine:
    """One registry entry (reference MachineMessage)."""

    name: str = ""
    state: str = ""
    client_url: str = ""
    peer_url: str = ""


@dataclass
class StandbyInfo:
    running: bool = False
    sync_interval: float = 0.0
    cluster: List[Machine] = field(default_factory=list)

    def client_urls(self) -> List[str]:
        """reference StandbyInfo4.ClientURLs (standby.go:38-44)."""
        return [m.client_url for m in self.cluster]

    def peer_urls(self) -> List[str]:
        return [m.peer_url for m in self.cluster]

    def initial_cluster(self) -> str:
        """name=peerURL comma list (reference InitialCluster,
        standby.go:46-57)."""
        return ",".join(f"{m.name}={m.peer_url}" for m in self.cluster)


def decode_standby_info(path: str) -> StandbyInfo:
    """reference DecodeStandbyInfo4FromFile (standby.go:59-70)."""
    with open(path) as f:
        d = json.load(f)
    return StandbyInfo(
        running=bool(d.get("Running", False)),
        sync_interval=float(d.get("SyncInterval", 0.0)),
        cluster=[Machine(name=m.get("name", ""), state=m.get("state", ""),
                         client_url=m.get("clientURL", ""),
                         peer_url=m.get("peerURL", ""))
                 for m in d.get("Cluster") or []])


def standby_to_proxy(src_dir: str, dst_data_dir: str) -> StandbyInfo:
    """Convert a v0.4 standby data dir into a bootable v2 PROXY data dir:
    reads `<src>/standby_info` and writes `<dst>/proxy/cluster` (the
    ProxyServer's persisted endpoint view), so
    `etcd --proxy on --data-dir <dst>` resumes exactly where the standby
    stood. Returns the decoded info (initial_cluster()/client_urls() feed
    flags or tooling)."""
    from etcd_tpu_torch.proxy import write_cluster_file
    info = decode_standby_info(os.path.join(src_dir, STANDBY_INFO_NAME))
    write_cluster_file(dst_data_dir, info.peer_urls())
    return info
