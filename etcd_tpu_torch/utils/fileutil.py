"""Filesystem helpers shared by the durability layer.

Behavioral equivalent of reference pkg/fileutil (dir perms, exclusive file
locks pkg/fileutil/lock_unix.go, retention loop pkg/fileutil/purge.go),
re-designed for a synchronous Python host loop: PurgeKeeper is drained
explicitly by the server's housekeeping tick instead of running a goroutine.
"""
from __future__ import annotations

import errno
import fcntl
import os
from typing import List, Optional

PRIVATE_DIR_MODE = 0o700
PRIVATE_FILE_MODE = 0o600


class LockError(OSError):
    """Another process holds the lock (reference fileutil.ErrLocked)."""


class LockedFile:
    """A file opened with an exclusive (non-blocking) flock, as the reference
    takes on every live WAL segment (pkg/fileutil/lock_unix.go)."""

    def __init__(self, path: str, flags: int = os.O_RDWR,
                 mode: int = PRIVATE_FILE_MODE) -> None:
        self.path = path
        self.fd = os.open(path, flags, mode)
        try:
            fcntl.flock(self.fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError as e:
            os.close(self.fd)
            if e.errno in (errno.EAGAIN, errno.EACCES, errno.EWOULDBLOCK):
                raise LockError(e.errno, f"file already locked: {path}")
            raise

    def close(self) -> None:
        if self.fd >= 0:
            try:
                fcntl.flock(self.fd, fcntl.LOCK_UN)
            finally:
                os.close(self.fd)
                self.fd = -1

    def __enter__(self) -> "LockedFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def is_dir_writable(d: str) -> bool:
    probe = os.path.join(d, ".touch")
    try:
        with open(probe, "w"):
            pass
        os.remove(probe)
        return True
    except OSError:
        return False


def create_dir_all(d: str) -> None:
    """mkdir -p, then insist it is empty (reference fileutil.CreateDirAll)."""
    touch_dir_all(d)
    if os.listdir(d):
        raise OSError(f"expected {d!r} to be empty, got {os.listdir(d)!r}")


def touch_dir_all(d: str) -> None:
    os.makedirs(d, mode=PRIVATE_DIR_MODE, exist_ok=True)
    if not is_dir_writable(d):
        raise OSError(f"directory {d!r} is not writable")


def read_dir(d: str) -> List[str]:
    """Sorted directory listing (reference fileutil.ReadDir)."""
    return sorted(os.listdir(d))


def fsync(fd: int) -> None:
    os.fsync(fd)


def fsync_dir(d: str) -> None:
    """Durably record directory entries (new/renamed files)."""
    dfd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def purge_files(dirname: str, suffix: str, keep: int) -> List[str]:
    """Remove the oldest `suffix` files beyond the newest `keep`, skipping any
    that are still flock-held (reference pkg/fileutil/purge.go semantics,
    invoked from the server's housekeeping tick rather than a goroutine).
    Returns the paths removed."""
    names = [n for n in read_dir(dirname) if n.endswith(suffix)]
    removed: List[str] = []
    while len(names) > keep:
        victim = os.path.join(dirname, names.pop(0))
        try:
            lock = LockedFile(victim)
        except LockError:
            break  # oldest is in use; newer ones are too
        except FileNotFoundError:
            continue
        try:
            os.remove(victim)
            removed.append(victim)
        finally:
            lock.close()
    return removed
