"""Version constants and data-dir version detection.

Behavioral equivalent of reference version/version.go:26-88: the server
version string served at /version, the minimum cluster version this server
can join (rolling-upgrade gate, consumed by cluster version negotiation),
and sniffing what kind of data dir a path holds.
"""
from __future__ import annotations

import os

VERSION = "2.1.0"
SERVER_NAME = "etcd-tpu"
# Oldest cluster version a member at VERSION may serve in
# (reference version.go:27).
MIN_CLUSTER_VERSION = "2.0.0"

DATA_DIR_2_0 = "2.0"        # member/{wal,snap} layout
DATA_DIR_EMPTY = "empty"
DATA_DIR_UNKNOWN = "unknown"


def detect_data_dir(path: str) -> str:
    """Classify a data dir (reference version.go DetectDataDir:35-88)."""
    if not os.path.isdir(path):
        return DATA_DIR_EMPTY
    names = os.listdir(path)
    if not names:
        return DATA_DIR_EMPTY
    if "member" in names:
        return DATA_DIR_2_0
    return DATA_DIR_UNKNOWN


def parse(v: str) -> tuple:
    """'2.1.0' -> (2, 1, 0); tolerant of suffixes after '-'."""
    core = v.split("-", 1)[0]
    parts = core.split(".")
    return tuple(int(p) for p in parts[:3])


def minor_of(v: str) -> tuple:
    maj, mnr = parse(v)[:2]
    return (maj, mnr)
