"""The round's quiescent hop as hand-written CUDA passes
(`csrc/quiet_hop.cu`), around the hop's two `ring_resolve` launches.

`fused_hop(cfg, st, inbox, prop_count, prop_slot, tick, force_hb,
drop_mask)` computes exactly what ops/kernel.py's quiet hop computes
(`_step_body` with quiet=True, `route_local`, then the drop mask): the
new state and the routed inbox. `quiet_flag` is `_quiet_pred` as one
reduction pass, a (1,) int32 device flag. The round takes them through
`selects`: CUDA tensors, no comm (the block holds every column), a
`prop_slot`, `resolve is ring_resolve`, P <= 8, W in {8, 16}, E <= 8;
every other hop stays on PyTorch.

The passes: `msgs` (ack_age, tick, the message phase; writes the
conflict scan's indices), `ring_resolve` at TE = E, `commit` (conflict
write, commits, admission, quorum commit, send plan; writes prev =
next - 1), `ring_resolve` at TE = P, `route` (the outbox straight into
the routed inbox). The wrapper checks every tensor and raises before
any launch on one the passes do not take; it allocates the outputs and
scratch, and launches on the current stream; `launches` counts the
passes launched, by name. The fields the quiet hop never changes (term,
vote, state, prng, votes, peer_mask) are the input's own tensors in the
result; inputs are never written.

`Lib` names a build: `cuda_lib()` the card's; a host build of the same
source (the CPU tests compile it with the host's C++ compiler) runs the
same row functions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, NamedTuple

import torch

from etcd_tpu_torch.ops import cuda_build
from etcd_tpu_torch.ops.ring_resolve import ring_resolve
from etcd_tpu_torch.ops.state import GroupState, KernelConfig, N_FIXED_FIELDS

MAX_P, MAX_E, MAX_W = 8, 8, 16
WINDOWS = (8, 16)
THREADS = 128                  # threads a block of `msgs` and `route` aims at
SMEM_CAP = 48 * 1024           # their shared memory, without an opt-in
KERNELS = ("pred", "msgs", "commit", "route")     # index = the .cu's Kernel
# The .cu's Word and Ptr enums, in order.
_WORDS = ("G", "P", "W", "E", "heartbeat", "election", "flow_window", "tick",
          "force_hb", "groups_per_block", "has_drop")
_PTRS = ("inbox", "term", "state", "elapsed", "lead", "commit",
         "last_index", "need_host", "peer_mask", "log_term", "match", "next",
         "pr_state", "paused", "ack_age", "prop_count", "prop_slot", "drop",
         "o_elapsed", "o_lead", "o_commit", "o_last_index", "o_need_host",
         "o_log_term", "o_match", "o_next", "o_pr_state", "o_paused",
         "o_ack_age", "o_inbox",
         "idx_j", "my_t", "prev", "prev_t", "sel", "resp", "hb_fire", "plan",
         "flag", "stream", "device")
LAYOUT = (len(_WORDS), len(_PTRS), MAX_P, MAX_E, MAX_W, THREADS,
          *range(len(KERNELS)))
_SLOT = {n: i for i, n in enumerate(_PTRS)}
_KERNEL = {n: i for i, n in enumerate(KERNELS)}
I32 = torch.int32


class Lib(NamedTuple):
    """A build of `csrc/quiet_hop.cu`: its launcher, the device type of
    the tensors it takes, the resolve it runs between its passes and the
    stream handle of a device index (0 on the host)."""
    launch: Callable
    device_type: str
    resolve: Callable
    stream: Callable


def bind(lib: ctypes.CDLL, device_type: str, resolve: Callable,
         stream: Callable) -> Lib:
    """A Lib of a loaded library; raises if its layout is not LAYOUT."""
    got = (ctypes.c_int * len(LAYOUT))()
    lib.quiet_hop_layout.restype = ctypes.c_int
    n = lib.quiet_hop_layout(got, len(LAYOUT))
    if tuple(got[:n]) != LAYOUT:
        raise RuntimeError(f"quiet_hop: the kernel's layout "
                           f"{tuple(got[:n])} is not the wrapper's {LAYOUT}")
    launch = lib.quiet_hop_launch
    launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    return Lib(launch, device_type, resolve, stream)


@functools.lru_cache(maxsize=None)
def cuda_lib() -> Lib:
    """The card's build, compiled by nvcc at first use."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw if raw is not None else (
        lambda d: torch.cuda.current_stream(d).cuda_stream)
    return bind(cuda_build.load("quiet_hop"), "cuda", ring_resolve, stream)


def selects(device_type: str, comm, prop_slot, resolve, peers: int,
            window: int, max_ents: int) -> bool:
    """Whether a hop takes the fused passes: CUDA tensors, a block that
    holds every column (no comm), a prop_slot (not the per-slot
    admission), the CUDA resolve, and a shape the passes take."""
    return (device_type == "cuda" and comm is None
            and prop_slot is not None and resolve is ring_resolve
            and shape_ok(peers, window, max_ents))


def shape_ok(peers: int, window: int, max_ents: int) -> bool:
    """The shapes the passes take (their registers hold P, E and W)."""
    return 1 <= peers <= MAX_P and window in WINDOWS and 1 <= max_ents <= MAX_E


def fusable(cfg: KernelConfig, st: GroupState, prop_slot, resolve,
            comm) -> bool:
    """`selects` for this hop's state."""
    return selects(st.term.device.type, comm, prop_slot, resolve,
                   st.term.shape[1], st.log_term.shape[2], cfg.max_ents)


def groups_per_block(peers: int, fields: int) -> int:
    """Groups a block of `msgs` and `route` owns: about THREADS threads
    (one a row), their mailboxes within SMEM_CAP of shared memory."""
    return max(1, min(THREADS // peers,
                      SMEM_CAP // (4 * peers * peers * fields)))


_tls = threading.local()     # each thread's packed arguments
# Passes launched, by KERNELS name (under a lock: the cells of a device
# mesh are threads); bumped after each launch the build accepted.
launches = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()


def _check(device_type: str, cfg: KernelConfig, st: GroupState,
           inbox: torch.Tensor, extra: dict) -> tuple:
    """(G, P, W, device index) after checking every tensor a pass reads:
    device, dtype, shape and contiguity; raises on the first it does not
    take, before any launch."""
    G, P = st.term.shape
    W, E = st.log_term.shape[-1], cfg.max_ents
    if not shape_ok(P, W, E):
        raise ValueError(f"quiet_hop: no pass for P={P}, W={W}, E={E}")
    want = {"inbox": (inbox, (G, P, P, N_FIXED_FIELDS + E), I32)}
    for name in ("term", "state", "elapsed", "lead", "commit", "last_index",
                 "need_host"):
        want[name] = (getattr(st, name), (G, P), I32)
    want["peer_mask"] = (st.peer_mask, (G, P), torch.bool)
    want["log_term"] = (st.log_term, (G, P, W), I32)
    for name in ("match", "next", "pr_state", "ack_age"):
        want[name] = (getattr(st, name), (G, P, P), I32)
    want["paused"] = (st.paused, (G, P, P), torch.bool)
    for name, t in extra.items():
        want[name] = (t, (G, P, P, 1) if name == "drop" else (G,), I32)
    dev = inbox.device
    for name, (t, shape, dtype) in want.items():
        if t.device.type != device_type or t.device != dev:
            raise ValueError(f"quiet_hop: {name} on {t.device}, not on "
                             f"the build's {device_type} beside the "
                             f"inbox ({dev})")
        if t.dtype is not dtype:
            raise TypeError(f"quiet_hop: {name} is {t.dtype}, not {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"quiet_hop: {name} has shape "
                             f"{tuple(t.shape)}, not {shape}")
        if not t.is_contiguous():
            raise ValueError(f"quiet_hop: {name} is not contiguous")
    return G, P, W, (dev.index or 0) if dev.type == "cuda" else 0


def _launch(lib: Lib, kernel: str, cfg: KernelConfig, dims: tuple,
            tick: bool, force_hb: bool, has_drop: bool, tensors: dict):
    """One pass: pack the words and the pointers of `tensors` (by _PTRS
    name; the others null) and launch; raise if it is refused."""
    G, P, W, dev = dims
    words = getattr(_tls, "words", None)
    if words is None:
        words = _tls.words = (ctypes.c_int * len(_WORDS))()
        _tls.ptrs = (ctypes.c_int64 * len(_PTRS))()
    ptrs = _tls.ptrs
    words[:] = [G, P, W, cfg.max_ents, cfg.heartbeat_tick,
                cfg.election_tick, cfg.effective_flow_window, int(tick),
                int(force_hb), groups_per_block(P, cfg.fields),
                int(has_drop)]
    for i in range(len(_PTRS)):
        ptrs[i] = 0
    for name, t in tensors.items():
        ptrs[_SLOT[name]] = t.data_ptr()
    ptrs[_SLOT["stream"]] = lib.stream(dev)
    ptrs[_SLOT["device"]] = dev
    err = lib.launch(_KERNEL[kernel], words, ptrs)
    if err != 0:
        raise RuntimeError(f"quiet_hop: {kernel} launch failed "
                           f"(error {err})")
    with _count_lock:
        launches[kernel] += 1


def _state_tensors(st: GroupState, inbox: torch.Tensor) -> dict:
    return {"inbox": inbox, "term": st.term, "state": st.state,
            "elapsed": st.elapsed, "lead": st.lead, "commit": st.commit,
            "last_index": st.last_index, "need_host": st.need_host,
            "peer_mask": st.peer_mask, "log_term": st.log_term,
            "match": st.match, "next": st.next, "pr_state": st.pr_state,
            "paused": st.paused, "ack_age": st.ack_age}


def quiet_flag(cfg: KernelConfig, st: GroupState, inbox: torch.Tensor,
               tick: bool, lib: Lib = None) -> torch.Tensor:
    """`kernel._quiet_pred` as one pass: a (1,) int32 tensor, 1 where no
    group's hop can need the sequential message phases."""
    dims = _check(lib.device_type if lib else "cuda", cfg, st, inbox, {})
    lib = lib or cuda_lib()
    flag = torch.ones(1, dtype=I32, device=inbox.device)
    _launch(lib, "pred", cfg, dims, tick, False, False,
            dict(_state_tensors(st, inbox), flag=flag))
    return flag


def fused_hop(cfg: KernelConfig, st: GroupState, inbox: torch.Tensor,
              prop_count: torch.Tensor, prop_slot: torch.Tensor, tick: bool,
              force_hb: bool = False, drop_mask=None, lib: Lib = None):
    """The quiet hop and its routing: (state, routed inbox), exactly
    ops/kernel.py's `_step_body(quiet=True)` then `route_local`, times
    `drop_mask` when one is given. The caller has seen `quiet_flag` set.
    A drop mask that is not a contiguous (G, P, P, 1) int32 tensor is
    applied by PyTorch after the passes."""
    fuse_drop = (drop_mask is not None and drop_mask.dtype is I32
                 and drop_mask.is_contiguous()
                 and tuple(drop_mask.shape) == (*inbox.shape[:3], 1))
    extra = {"prop_count": prop_count, "prop_slot": prop_slot}
    if fuse_drop:
        extra["drop"] = drop_mask
    dims = _check(lib.device_type if lib else "cuda", cfg, st, inbox, extra)
    lib = lib or cuda_lib()
    G, P, W, _ = dims
    E = cfg.max_ents

    def new(*shape, dtype=I32):
        return torch.empty(shape, dtype=dtype, device=inbox.device)

    out = {"o_elapsed": new(G, P), "o_lead": new(G, P),
           "o_commit": new(G, P), "o_last_index": new(G, P),
           "o_need_host": new(G, P), "o_log_term": new(G, P, W),
           "o_match": new(G, P, P), "o_next": new(G, P, P),
           "o_pr_state": new(G, P, P),
           "o_paused": new(G, P, P, dtype=torch.bool),
           "o_ack_age": new(G, P, P), "o_inbox": torch.empty_like(inbox)}
    scratch = {"idx_j": new(G, P, E), "prev": new(G, P, P),
               "sel": new(G, P), "resp": new(G, P, 4),
               "hb_fire": new(G, P), "plan": new(G, P, 2)}
    args = dict(_state_tensors(st, inbox), **extra, **out, **scratch)

    def run(kernel):
        _launch(lib, kernel, cfg, dims, tick, force_hb, fuse_drop, args)

    run("msgs")
    args["my_t"] = lib.resolve(st.log_term, scratch["idx_j"], st.last_index)
    run("commit")
    args["prev_t"] = lib.resolve(out["o_log_term"], scratch["prev"],
                                 out["o_last_index"])
    run("route")
    new_st = st._replace(
        elapsed=out["o_elapsed"], lead=out["o_lead"],
        commit=out["o_commit"], last_index=out["o_last_index"],
        need_host=out["o_need_host"], log_term=out["o_log_term"],
        match=out["o_match"], next=out["o_next"],
        pr_state=out["o_pr_state"], paused=out["o_paused"],
        ack_age=out["o_ack_age"])
    routed = out["o_inbox"]
    if drop_mask is not None and not fuse_drop:
        routed = routed * drop_mask
    return new_st, routed

