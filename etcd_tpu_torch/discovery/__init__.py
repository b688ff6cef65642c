from etcd_tpu_torch.discovery.discovery import (BadSizeKeyError, DiscoveryError,
                                          DuplicateIDError, FullClusterError,
                                          SizeNotFoundError, get_cluster,
                                          join_cluster)
from etcd_tpu_torch.discovery.srv import srv_cluster

__all__ = ["DiscoveryError", "DuplicateIDError", "FullClusterError",
           "SizeNotFoundError", "BadSizeKeyError", "join_cluster",
           "get_cluster", "srv_cluster"]
