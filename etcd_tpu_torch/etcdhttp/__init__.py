"""HTTP API surface (reference etcdserver/etcdhttp/).

`client` serves the public API (/v2/keys, /v2/members, /v2/stats, /version,
/health); `tenants` serves it per tenant group of the engine; `web` is the
shared threaded-HTTP routing core.

Unlike the JAX package's `etcdhttp`, this one does not export `PeerAPI`:
`peer.py` serves the other members of a single-group cluster, and the
single-group server is not in this package yet (ROADMAP A9).
"""
from etcd_tpu_torch.etcdhttp.web import HttpServer  # noqa: F401
from etcd_tpu_torch.etcdhttp.client import ClientAPI  # noqa: F401
