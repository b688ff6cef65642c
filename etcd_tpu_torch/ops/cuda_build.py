"""Build the package's CUDA sources with nvcc at first use and load them.

Each `csrc/<name>.cu` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for `sm_90a`,
into `<checkout>/.cuda_build/<name>-<hash>/`, keyed by a hash of the
source and the flags. A failed build raises. `ptxas_report` compiles a
source once more, apart from the cached library, to read what ptxas
says of each kernel (registers, shared memory, spills).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / ".cuda_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to (the hash covers source + flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_ROOT / f"{name}-{key[:16]}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built."""
    so = library_path(name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def ptxas_report(name: str) -> list:
    """The `ptxas info` lines of `-Xptxas -v` for `csrc/<name>.cu`, from a
    build made for this report alone (the cached library keeps its
    flags)."""
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as d:
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
               os.path.join(d, f"lib{name}.so"), str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    return [line.split(":", 1)[1].strip() for line in res.stderr.splitlines()
            if line.startswith("ptxas info")]
