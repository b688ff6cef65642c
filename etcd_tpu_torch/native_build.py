"""Build the package's C extensions with `cc` at first use.

`native/{walcodec,ingresscore,storecore}.c` compile with the flags of
the repo's `./build` (`cc -O2 -Wall -shared -fPIC -I<Python include>`),
each into `<checkout>/.native_build/<name>-<hash>/`, keyed by a hash of
the source, the flags and the interpreter's EXT_SUFFIX. The library is
then placed (by `os.replace`) at `native/<name><EXT_SUFFIX>`, where the
loaders of `native/__init__.py` and `store/__init__.py` import it, and
replaced whenever its hash changes. Processes that import the package at
once share one build: a file lock serialises the builders, and every
file is written under a temporary name and renamed.

Without a C compiler or `Python.h` one line goes to stderr and the
Python codecs and store serve (the installed libraries, which can no
longer be proven current, are removed). A source that fails to compile
raises. This module imports no torch: the ingress process imports the
package too.
"""
from __future__ import annotations

import fcntl
import filecmp
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

NAMES = ("walcodec", "ingresscore", "storecore")
NATIVE = Path(__file__).resolve().parent / "native"
BUILD_ROOT = Path(__file__).resolve().parents[1] / ".native_build"
CFLAGS = ["-O2", "-Wall", "-shared", "-fPIC"]
EXT = sysconfig.get_config_var("EXT_SUFFIX") or ".so"


def library_path(name: str) -> Path:
    """Where `native/<name>.c` builds to (the hash covers source, flags
    and EXT_SUFFIX)."""
    src = (NATIVE / f"{name}.c").read_bytes()
    key = hashlib.sha256(src + " ".join(CFLAGS).encode() + EXT.encode())
    return BUILD_ROOT / f"{name}-{key.hexdigest()[:16]}" / f"{name}{EXT}"


def installed_path(name: str) -> Path:
    return NATIVE / f"{name}{EXT}"


def _current(name: str) -> bool:
    built, inst = library_path(name), installed_path(name)
    return (built.exists() and inst.exists()
            and filecmp.cmp(built, inst, shallow=False))


def _missing_toolchain():
    """Why the C cannot be built here, or None."""
    if shutil.which("cc") is None:
        return "no C compiler (cc) on PATH"
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        return f"no Python.h in {include}"
    return None


def _compile(names) -> None:
    """One `cc` per source, all started together; raise on a failure."""
    include = sysconfig.get_paths()["include"]
    jobs = []
    for name in names:
        so = library_path(name)
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{name}.{os.getpid()}.tmp{EXT}")
        cmd = ["cc", *CFLAGS, f"-I{include}", str(NATIVE / f"{name}.c"),
               "-o", str(tmp)]
        jobs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    failed = []
    for name, so, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"cc failed for {name}.c:\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def _install(name: str) -> None:
    tmp = NATIVE / f"{name}.{os.getpid()}.tmp{EXT}"
    shutil.copyfile(library_path(name), tmp)
    os.replace(tmp, installed_path(name))


def ensure() -> bool:
    """Build and install every library that is not current; True when
    all are, False when this machine cannot build them (the Python
    fallbacks then serve)."""
    if all(_current(n) for n in NAMES):
        return True
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stale = [n for n in NAMES if not _current(n)]
        if not stale:
            return True
        unbuilt = [n for n in stale if not library_path(n).exists()]
        why = _missing_toolchain() if unbuilt else None
        if why is None:
            _compile(unbuilt)
        for n in stale:
            if library_path(n).exists():
                _install(n)
            else:
                installed_path(n).unlink(missing_ok=True)
    if why is not None:
        print(f"etcd_tpu_torch: {why}; not built: {', '.join(unbuilt)} "
              f"(the Python fallbacks serve)", file=sys.stderr)
        return False
    return True
