from etcd_tpu_torch.storage.revision import Revision, rev_to_bytes, bytes_to_rev
from etcd_tpu_torch.storage.backend import Backend
from etcd_tpu_torch.storage.index import TreeIndex, KeyIndex, RevisionNotFoundError
from etcd_tpu_torch.storage.kvstore import (KVStore, KeyValue, CompactedError,
                                      TxnIDMismatchError)

__all__ = ["Revision", "rev_to_bytes", "bytes_to_rev", "Backend",
           "TreeIndex", "KeyIndex", "RevisionNotFoundError", "KVStore",
           "KeyValue", "CompactedError", "TxnIDMismatchError"]
