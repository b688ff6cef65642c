from etcd_tpu_torch.rafthttp.transport import HttpTransport  # noqa: F401
