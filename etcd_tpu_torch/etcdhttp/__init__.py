"""HTTP API surface (reference etcdserver/etcdhttp/).

`client` serves the public API (/v2/keys, /v2/members, /v2/stats, /version,
/health); `peer` serves other members (/raft message ingest, /members
bootstrap listing); `web` is the shared threaded-HTTP routing core.
"""
from etcd_tpu_torch.etcdhttp.web import HttpServer  # noqa: F401
from etcd_tpu_torch.etcdhttp.client import ClientAPI  # noqa: F401
from etcd_tpu_torch.etcdhttp.peer import PeerAPI  # noqa: F401
