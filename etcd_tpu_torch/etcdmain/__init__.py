from etcd_tpu_torch.etcdmain.config import MainConfig, ConfigError, parse_args
from etcd_tpu_torch.etcdmain.etcd import main

__all__ = ["MainConfig", "ConfigError", "parse_args", "main"]
