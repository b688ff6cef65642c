"""The windowed ring-term resolve: a hand-written CUDA kernel and its plain
PyTorch version.

`ring_resolve(ring, idx, last)` maps absolute entry indices to the terms
held in each (group, slot) row's log ring, 0 where the index is < 1 or
outside the row's window (last - W, last]. It is the round's
`_terms_at_many` (ops/kernel.py), called once per sender slot in the
full message pass and once per hop in the quiet message pass and in send
assembly.

CUDA tensors launch `csrc/ring_resolve.cu` (built by nvcc at first use,
bound with ctypes) or raise; CPU tensors take `ring_resolve_ref`. The
wrapper counts its launches in `ring_resolve.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from etcd_tpu_torch.ops import cuda_build


def ring_resolve_ref(ring: torch.Tensor, idx: torch.Tensor,
                     last: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather + where.

    ring: (G, P, W) int32; idx: (G, P, *T) int32; last: (G, P) int32.
    Returns idx-shaped int32 terms."""
    G, P, W = ring.shape
    flat = idx.reshape(G, P, -1)
    t = torch.gather(ring, 2, torch.remainder(flat, W).long())
    lst = last[..., None]
    valid = (flat > lst - W) & (flat <= lst) & (flat >= 1)
    return torch.where(valid, t, 0).reshape(idx.shape)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("ring_resolve")
    fn = lib.ring_resolve_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(ring: torch.Tensor, idx: torch.Tensor, last: torch.Tensor):
    if ring.ndim != 3 or tuple(last.shape) != tuple(ring.shape[:2]) \
            or tuple(idx.shape[:2]) != tuple(ring.shape[:2]):
        raise ValueError(f"ring_resolve: shapes ring {tuple(ring.shape)}, "
                         f"idx {tuple(idx.shape)}, last {tuple(last.shape)}")
    for name, t in (("ring", ring), ("idx", idx), ("last", last)):
        if t.dtype != torch.int32:
            raise TypeError(f"ring_resolve: {name} is {t.dtype}, not int32")
        if t.device != idx.device:
            raise ValueError(f"ring_resolve: {name} on {t.device}, "
                             f"idx on {idx.device}")
        if not t.is_contiguous():
            raise ValueError(f"ring_resolve: {name} is not contiguous")


def ring_resolve(ring: torch.Tensor, idx: torch.Tensor,
                 last: torch.Tensor) -> torch.Tensor:
    """Windowed resolve on the tensors' device: the CUDA kernel for CUDA
    tensors, `ring_resolve_ref` for CPU tensors."""
    _check(ring, idx, last)
    if idx.device.type == "cpu":
        return ring_resolve_ref(ring, idx, last)
    if idx.device.type != "cuda":
        raise ValueError(f"ring_resolve: no kernel for {idx.device}")
    G, P, W = ring.shape
    out = torch.empty_like(idx)
    if out.numel() == 0:
        return out
    rows = G * P
    te = idx.numel() // rows
    lib = _lib()
    with torch.cuda.device(idx.device):
        err = lib.ring_resolve_launch(
            ring.data_ptr(), idx.data_ptr(), last.data_ptr(),
            out.data_ptr(), rows, te, W,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_resolve: CUDA launch failed (error {err})")
    ring_resolve.launches += 1
    return out


ring_resolve.launches = 0
