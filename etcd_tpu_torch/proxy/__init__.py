from etcd_tpu_torch.proxy.director import Director, Endpoint, write_cluster_file
from etcd_tpu_torch.proxy.reverse import (ReverseProxy, fetch_cluster_urls,
                                    readonly)

__all__ = ["Director", "Endpoint", "ReverseProxy", "fetch_cluster_urls",
           "readonly", "write_cluster_file"]
