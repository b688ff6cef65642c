"""DNS SRV bootstrap (reference discovery/srv.go SRVGetCluster).

Looks up ``_etcd-server-ssl._tcp.<domain>`` (https peers) and
``_etcd-server._tcp.<domain>`` (http peers); each SRV target becomes one
initial-cluster entry, named ``name`` when the target matches one of our
advertised peer URLs and a running ordinal otherwise (srv.go:55-77).

The standard library has no SRV resolver, so the lookup function is
pluggable: pass ``lookup`` (service, proto, domain) -> [(target, port)],
or install dnspython. Zero-egress test environments inject a fake.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

log = logging.getLogger("discovery")

LookupSRV = Callable[[str, str, str], List[Tuple[str, int]]]


def _default_lookup(service: str, proto: str, domain: str
                    ) -> List[Tuple[str, int]]:
    try:
        import dns.resolver  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "SRV discovery needs a DNS resolver; install dnspython or pass "
            "an explicit lookup function") from e
    answers = dns.resolver.resolve(f"_{service}._{proto}.{domain}", "SRV")
    return [(str(r.target).rstrip("."), r.port) for r in answers]


def srv_cluster(domain: str, name: str, apurls: Sequence[str],
                lookup: Optional[LookupSRV] = None) -> str:
    """Return an initial-cluster string discovered from DNS SRV records."""
    lookup = lookup or _default_lookup
    self_hostports = set()
    for u in apurls:
        parts = urlsplit(u)
        self_hostports.add((parts.hostname, parts.port))

    entries: List[str] = []
    temp_name = 0

    def collect(service: str, scheme: str) -> bool:
        nonlocal temp_name
        try:
            addrs = lookup(service, "tcp", domain)
        except Exception as e:
            log.info("discovery: SRV lookup %s failed: %s", service, e)
            return False
        for target, port in addrs:
            n = name if (target, port) in self_hostports else str(temp_name)
            if n != name:
                temp_name += 1
            entries.append(f"{n}={scheme}://{target}:{port}")
            log.info("discovery: got bootstrap from DNS for %s at "
                     "%s://%s:%d", service, scheme, target, port)
        return True

    ok_ssl = collect("etcd-server-ssl", "https")
    ok = collect("etcd-server", "http")
    if not (ok_ssl or ok) or not entries:
        raise RuntimeError(
            f"discovery: no SRV records for cluster bootstrap under "
            f"{domain!r}")
    return ",".join(entries)
