"""MVCC revisions: a (main, sub) pair per mutation within a transaction.

Behavioral equivalent of reference storage/reversion.go: 17-byte big-endian
encoding `main | '_' | sub` so byte order == revision order in the backend's
key bucket.
"""
from __future__ import annotations

import struct
from typing import NamedTuple


class Revision(NamedTuple):
    main: int = 0
    sub: int = 0


def rev_to_bytes(rev: Revision) -> bytes:
    return struct.pack(">Q", rev.main) + b"_" + struct.pack(">Q", rev.sub)


def bytes_to_rev(b: bytes) -> Revision:
    return Revision(struct.unpack(">Q", b[0:8])[0],
                    struct.unpack(">Q", b[9:17])[0])
