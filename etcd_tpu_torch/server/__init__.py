from etcd_tpu_torch.server.request import Request
from etcd_tpu_torch.server.cluster import Cluster, Member
from etcd_tpu_torch.server.server import EtcdServer, ServerConfig

__all__ = ["Request", "Cluster", "Member", "EtcdServer", "ServerConfig"]
