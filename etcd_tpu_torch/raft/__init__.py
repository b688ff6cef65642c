"""Consensus core: pure scalar Raft FSM (the oracle), log, progress,
storage, and the synchronous Node/Ready driver."""

from etcd_tpu_torch.raft.core import Config, Raft, ProposalDroppedError
from etcd_tpu_torch.raft.log import RaftLog, Unstable
from etcd_tpu_torch.raft.node import Node, Peer, Ready, Status
from etcd_tpu_torch.raft.progress import Inflights, Progress, ProgressState
from etcd_tpu_torch.raft.storage import (CompactedError, MemoryStorage,
                                   SnapOutOfDateError, Storage,
                                   UnavailableError)

__all__ = [
    "Config", "Raft", "ProposalDroppedError", "RaftLog", "Unstable", "Node",
    "Peer", "Ready", "Status", "Inflights", "Progress", "ProgressState",
    "CompactedError", "MemoryStorage", "SnapOutOfDateError", "Storage",
    "UnavailableError",
]
