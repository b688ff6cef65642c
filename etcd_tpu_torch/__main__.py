"""`python -m etcd_tpu_torch` — the `etcd` binary equivalent (reference main.go)."""
import sys

from etcd_tpu_torch.etcdmain import main

if __name__ == "__main__":
    sys.exit(main())
