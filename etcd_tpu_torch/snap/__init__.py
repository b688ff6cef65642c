from etcd_tpu_torch.snap.snapshotter import (NoSnapshotError, Snapshotter,
                                       snap_name, parse_snap_name)

__all__ = ["Snapshotter", "NoSnapshotError", "snap_name", "parse_snap_name"]
