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
launch geometry is `launch_plan`, a pure function. The wrapper counts
its launches in `ring_resolve.launches` and, per instantiation of the
kernel, in `ring_resolve.launches_by_variant` (under a lock: the cells
of an in-process device mesh call it from their own threads). `launch_floor` takes the
wrapper's whole path with an empty kernel in place of the resolve.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from etcd_tpu_torch.ops import cuda_build

# The kernel's layout, as the .cu defines it (kThreads, kBarrierBytes,
# kStages, enum Variant); `_lib` checks these against the built library.
THREADS = 256                   # threads per block
BARRIER_BYTES = 16              # one 8-byte mbarrier per stage
STAGES = 2                      # tiles in flight per block
VARIANTS = ("generic", "te4", "te5")   # index = the .cu's Variant
_VARIANT_ID = {v: i for i, v in enumerate(VARIANTS)}
EMPTY = 3                       # kEmpty: an empty kernel, the launch floor
LAYOUT = (THREADS, BARRIER_BYTES, STAGES, *range(len(VARIANTS)), EMPTY)

MAX_THREADS_PER_SM = 2048
SMEM_LIMIT = 227 * 1024         # shared memory one block may take
TILE_ROWS = 256                 # rows per tile where shared memory allows
GENERIC_SMEM = 96 * 1024        # the generic kernel's shared-memory cap


class LaunchPlan(NamedTuple):
    variant: str      # "te4", "te5" or "generic"
    tile_rows: int    # rows per tile; a multiple of 4
    tiles: int        # ceil(rows / tile_rows)
    grid: int         # persistent blocks, all resident at once
    smem: int         # dynamic shared memory per block, bytes
    wmask: int        # W - 1 where W is a power of two, else -1 (use %)


def stage_shape(te: int) -> tuple:
    """(variant, tile_rows, smem) for TE elements per row: STAGES buffers
    of tile_rows idx rows and last words, after the barriers."""
    variant = {4: "te4", 5: "te5"}.get(te, "generic")
    cap = SMEM_LIMIT if variant != "generic" else GENERIC_SMEM
    per_row = STAGES * (te + 1) * 4
    tile_rows = min(TILE_ROWS, (cap - BARRIER_BYTES) // per_row // 4 * 4)
    if tile_rows < 4:
        raise ValueError(f"ring_resolve: {te} elements per row do not fit "
                         "a tile in shared memory")
    return variant, tile_rows, BARRIER_BYTES + tile_rows * per_row


def launch_plan(rows: int, te: int, w: int, sms: int,
                occupancy: int) -> LaunchPlan:
    """Launch geometry for R=rows rows of TE=te indices into W=w rings on
    a card of `sms` SMs holding `occupancy` blocks of this plan's shared
    memory per SM. Tiles start on multiples of 4 rows; the grid never
    exceeds the blocks the card holds at once. The kernel's offsets are
    32-bit, so idx and ring must hold fewer than 2**31 elements."""
    if rows * te >= 2 ** 31 or rows * w >= 2 ** 31:
        raise ValueError("ring_resolve: offsets need more than 31 bits")
    variant, tile_rows, _ = stage_shape(te)
    tile_rows = min(tile_rows, -(-rows // 4) * 4)
    tiles = -(-rows // tile_rows)
    per_sm = max(1, min(occupancy, MAX_THREADS_PER_SM // THREADS))
    grid = max(1, min(tiles, sms * per_sm))
    wmask = w - 1 if w & (w - 1) == 0 else -1
    return LaunchPlan(variant, tile_rows, tiles, grid,
                      BARRIER_BYTES + tile_rows * STAGES * (te + 1) * 4,
                      wmask)


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


@functools.lru_cache(maxsize=None)
def _lib():
    """The launcher, the occupancy query and the raw-stream getter,
    resolved once; raises if the library's layout is not the plan's."""
    lib = cuda_build.load("ring_resolve")
    got = (ctypes.c_int * len(LAYOUT))()
    lib.ring_resolve_layout.restype = ctypes.c_int
    n = lib.ring_resolve_layout(got, len(LAYOUT))
    if tuple(got[:n]) != LAYOUT:
        raise RuntimeError(f"ring_resolve: the kernel's layout "
                           f"{tuple(got[:n])} is not the plan's {LAYOUT}")
    launch = lib.ring_resolve_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    occ = lib.ring_resolve_occupancy
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw if raw is not None else (
        lambda d: torch.cuda.current_stream(d).cuda_stream)
    return launch, occ, stream


def device_plan(rows: int, te: int, w: int, device: int) -> LaunchPlan:
    """launch_plan with this card's SM count and the kernel's occupancy
    at the plan's shared memory."""
    _, occ, _ = _lib()
    variant, _, smem = stage_shape(te)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = ctypes.c_int(0)
    err = occ(_VARIANT_ID[variant], smem, device, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ring_resolve: occupancy query failed "
                           f"(error {err})")
    return launch_plan(rows, te, w, sms, blocks.value)


@functools.lru_cache(maxsize=256)
def _words(rows: int, te: int, w: int, device: int, empty: bool) -> tuple:
    """(instantiation, the launcher's packed int arguments) per shape and
    card, planned once; `empty` launches the empty kernel instead."""
    plan = device_plan(rows, te, w, device)
    v = EMPTY if empty else _VARIANT_ID[plan.variant]
    return plan.variant, (ctypes.c_int * 9)(
        v, rows, te, w, plan.wmask, plan.tile_rows, plan.tiles, plan.grid,
        plan.smem)


_I32 = torch.int32
_tls = threading.local()    # each thread's packed pointer arguments
_count_lock = threading.Lock()


def _check(ring: torch.Tensor, idx: torch.Tensor, last: torch.Tensor):
    rs, xs, ls = ring.shape, idx.shape, last.shape
    if len(rs) != 3 or len(ls) != 2 or len(xs) < 2 or ls[0] != rs[0] \
            or ls[1] != rs[1] or xs[0] != rs[0] or xs[1] != rs[1]:
        raise ValueError(f"ring_resolve: shapes ring {tuple(rs)}, "
                         f"idx {tuple(xs)}, last {tuple(ls)}")
    if ring.dtype is not _I32 or idx.dtype is not _I32 \
            or last.dtype is not _I32:
        name, t = next((n, t) for n, t in (("ring", ring), ("idx", idx),
                                            ("last", last))
                       if t.dtype is not _I32)
        raise TypeError(f"ring_resolve: {name} is {t.dtype}, not int32")
    dev = idx.device
    if ring.device != dev or last.device != dev:
        t, name = (ring, "ring") if ring.device != dev else (last, "last")
        raise ValueError(f"ring_resolve: {name} on {t.device}, "
                         f"idx on {dev}")
    if not (ring.is_contiguous() and idx.is_contiguous()
            and last.is_contiguous()):
        name = next(n for n, t in (("ring", ring), ("idx", idx),
                                   ("last", last)) if not t.is_contiguous())
        raise ValueError(f"ring_resolve: {name} is not contiguous")


def _launch(ring: torch.Tensor, idx: torch.Tensor, last: torch.Tensor,
            out: torch.Tensor, words: ctypes.Array) -> None:
    """Launch the packed plan `words` on idx's card and current stream;
    raise if the launch is refused."""
    launch, _, stream = _lib()
    ptrs = getattr(_tls, "ptrs", None)
    if ptrs is None:
        ptrs = _tls.ptrs = (ctypes.c_int64 * 6)()
    dev = idx.get_device()
    ptrs[0] = ring.data_ptr()
    ptrs[1] = idx.data_ptr()
    ptrs[2] = last.data_ptr()
    ptrs[3] = out.data_ptr()
    ptrs[4] = stream(dev)
    ptrs[5] = dev
    err = launch(words, ptrs)
    if err != 0:
        raise RuntimeError(f"ring_resolve: CUDA launch failed (error {err})")


def _resolve(ring: torch.Tensor, idx: torch.Tensor, last: torch.Tensor,
             empty: bool) -> torch.Tensor:
    _check(ring, idx, last)
    if not idx.is_cuda:
        if idx.device.type == "cpu" and not empty:
            return ring_resolve_ref(ring, idx, last)
        raise ValueError(f"ring_resolve: no kernel for {idx.device}")
    out = torch.empty_like(idx)
    n = out.numel()
    if n == 0:
        return out
    G, P, W = ring.shape
    variant, words = _words(G * P, n // (G * P), W, idx.get_device(), empty)
    _launch(ring, idx, last, out, words)
    if not empty:
        with _count_lock:       # the cells of a device mesh are threads
            ring_resolve.launches += 1
            ring_resolve.launches_by_variant[variant] += 1
    return out


def ring_resolve(ring: torch.Tensor, idx: torch.Tensor,
                 last: torch.Tensor) -> torch.Tensor:
    """Windowed resolve on the tensors' device: the CUDA kernel for CUDA
    tensors, `ring_resolve_ref` for CPU tensors."""
    return _resolve(ring, idx, last, False)


def launch_floor(ring: torch.Tensor, idx: torch.Tensor,
                 last: torch.Tensor) -> torch.Tensor:
    """`ring_resolve`'s whole path on CUDA tensors, checks, plan and
    output included, launching an empty kernel of the same grid in place
    of the resolve: the floor that launching puts under the kernel. The
    output is left unwritten, and no launch is counted."""
    return _resolve(ring, idx, last, True)


ring_resolve.launches = 0
ring_resolve.launches_by_variant = dict.fromkeys(VARIANTS, 0)
