"""Client SDK (reference client/): multi-endpoint failover HTTP client,
typed KeysAPI / MembersAPI, and discovery helpers."""
from etcd_tpu_torch.client.client import Client, ClientError, ClusterError  # noqa: F401
from etcd_tpu_torch.client.keys import KeysAPI, KeysError, Node, Response, Watcher  # noqa: F401
from etcd_tpu_torch.client.members import MembersAPI  # noqa: F401
