from etcd_tpu_torch.wal.wal import (WAL, CorruptError, UnexpectedEOF, WalSnapshot,
                              repair, wal_exists, wal_name, parse_wal_name)

__all__ = ["WAL", "CorruptError", "UnexpectedEOF", "WalSnapshot", "repair",
           "wal_exists", "wal_name", "parse_wal_name"]
