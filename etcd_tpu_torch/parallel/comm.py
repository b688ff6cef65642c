"""The cross-shard operations of the sharded round, behind one interface.

In the JAX package XLA inserts the collectives a sharded round needs. The
port's round runs once per mesh cell on its own block (ops/kernel.py with
`c0` and a comm) and names every point where a cell needs data of another
cell. There are four:

- `all_to_all(send)`: send (Pc, ...) holds one chunk per peers cell of
  this groups row; returns (Pc, ...) where chunk j is what cell j sent to
  this one. The per-hop message route.
- `sum_peers(x)`: the elementwise sum of `x` over the peers cells of this
  groups row (per-group sums over peers).
- `gather_peers(x)`: the (Gb, Pb, ...) blocks of this groups row joined
  along dim 1 in column order: (Gb, P, ...) (where JAX takes an argmax or
  reads another column).
- `any(flag)`: a Python bool that is true on every cell of the mesh when
  `flag` is true on one (the quiescence vote, which all cells must take
  the same way, as JAX's one `lax.cond` does).

A cell never computes another cell's columns: it only ever receives their
messages, sums and flags.

Two implementations:

- `LocalComm`: the cells of an in-process mesh, one thread each, in
  lockstep (`run_cells`). Every operation is a rendezvous of all cells at
  one barrier, and between two operations the cells compute one at a
  time; cells on one CUDA device share its default stream, so their
  kernels run one after another.
- `ProcessComm`: one process per peers column on `torch.distributed` (a
  (1, P) mesh across processes). The gloo backend moves CUDA tensors
  through pinned host memory: the send buffer is copied to the host, the
  collective runs on host tensors, and the result is copied back to the
  card. NCCL takes CUDA tensors as they are, and needs one card per rank.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List

import torch


class CommStats:
    """Calls and wall seconds per operation, as one cell sees them."""

    def __init__(self) -> None:
        self.ops: dict = {}

    def add(self, op: str, seconds: float) -> None:
        n, s = self.ops.get(op, (0, 0.0))
        self.ops[op] = (n + 1, s + seconds)

    def as_dict(self) -> dict:
        return {op: {"calls": n, "seconds": s}
                for op, (n, s) in sorted(self.ops.items())}


class _Rendezvous:
    """Shared slots and one barrier for the cells of an in-process mesh,
    and the turn: one cell at a time computes between two comm calls.
    The cells' ops would take turns at the interpreter lock anyway (and
    on one card at its launch queue); taking them a whole stretch at a
    time spares a handoff between threads at every op."""

    def __init__(self, shape) -> None:
        self.shape = shape
        self.slots: List[list] = [[None] * shape[1] for _ in range(shape[0])]
        self.barrier = threading.Barrier(shape[0] * shape[1])
        self.turn = threading.Lock()


class LocalComm:
    """Cell (gi, pi) of an in-process mesh run by `run_cells`."""

    def __init__(self, rv: _Rendezvous, gi: int, pi: int,
                 device: torch.device, stats=None) -> None:
        self._rv, self.gi, self.rank, self.device = rv, gi, pi, device
        self.peers = rv.shape[1]
        self.stats = stats

    def _exchange(self, op: str, value) -> List[list]:
        """Every cell's `value`, as a (groups, peers) grid of lists."""
        t0 = time.perf_counter()
        rv = self._rv
        rv.slots[self.gi][self.rank] = value
        rv.turn.release()
        try:
            rv.barrier.wait()
            got = [row[:] for row in rv.slots]
            rv.barrier.wait()      # no cell writes a slot before all read
        finally:
            rv.turn.acquire()
        if self.stats is not None:
            self.stats.add(op, time.perf_counter() - t0)
        return got

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        row = self._exchange("all_to_all", send)[self.gi]
        return torch.stack([row[j][self.rank].to(self.device)
                            for j in range(self.peers)])

    def sum_peers(self, x: torch.Tensor) -> torch.Tensor:
        row = self._exchange("sum_peers", x)[self.gi]
        return torch.stack([t.to(self.device) for t in row]).sum(
            dim=0, dtype=x.dtype)

    def gather_peers(self, x: torch.Tensor) -> torch.Tensor:
        row = self._exchange("gather_peers", x)[self.gi]
        return torch.cat([t.to(self.device) for t in row], dim=1)

    def any(self, flag) -> bool:
        flag = bool(flag)          # the cell's one device sync per vote
        return any(v for row in self._exchange("any", flag) for v in row)


def run_cells(mesh, fn: Callable, stats=None) -> List[list]:
    """Run fn(gi, pi, comm) for every cell of `mesh`, one thread per cell,
    each with its `LocalComm`; returns the (groups, peers) grid of
    results. Cell (0, 0) records its comm calls into `stats`, if given. The threads are the mesh's own and live as long as it does
    (a thread keeps its CUDA device and its CPU thread pool); two callers
    of one mesh take turns. A cell that raises breaks the barrier, so the
    others stop at their next operation; the first error is raised
    here."""
    pool, lock = _cell_pool(mesh)
    rv = _Rendezvous(mesh.shape)
    out = [[None] * mesh.shape[1] for _ in range(mesh.shape[0])]
    errors: list = []

    def cell(gi, pi):
        dev = mesh.devices[gi][pi]
        rv.turn.acquire()
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)   # the current card is per thread
            out[gi][pi] = fn(gi, pi, LocalComm(
                rv, gi, pi, dev, stats if (gi, pi) == (0, 0) else None))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            rv.barrier.abort()
        finally:
            rv.turn.release()

    with lock:
        futs = [pool.submit(cell, gi, pi) for gi, pi in mesh.cells()]
        for f in futs:
            f.result()
    if errors:
        first = next((e for e in errors
                      if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0])
        raise first
    return out


_pools_lock = threading.Lock()


def _cell_pool(mesh):
    """The mesh's worker threads (one per cell) and the lock that gives
    one caller at a time all of them."""
    with _pools_lock:
        got = getattr(mesh, "_cell_pool", None)
        if got is None:
            from concurrent.futures import ThreadPoolExecutor
            got = (ThreadPoolExecutor(max_workers=mesh.size,
                                      thread_name_prefix="mesh-cell"),
                   threading.Lock())
            mesh._cell_pool = got
        return got


class ProcessComm:
    """One peers column per process on a `torch.distributed` process
    group (world size = the number of peers cells; rank = this column)."""

    def __init__(self, group=None) -> None:
        import torch.distributed as dist
        self._dist, self._group = dist, group
        self.rank = dist.get_rank(group)
        self.peers = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        # gloo: CUDA tensors go through pinned host memory (see module).
        self.stages_through_host = self.backend == "gloo"
        self.stats = CommStats()

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """A fresh contiguous tensor the backend takes: pinned host
        memory for a CUDA tensor on gloo, else a clone."""
        if self.stages_through_host and x.is_cuda:
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x)
            return buf
        return x.clone(memory_format=torch.contiguous_format)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        s = self._wire(send)
        r = torch.empty_like(s)
        self._dist.all_to_all_single(r, s, group=self._group)
        r = r.to(send.device)
        self.stats.add("all_to_all", time.perf_counter() - t0)
        return r

    def sum_peers(self, x: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        t = self._wire(x)
        self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM,
                              group=self._group)
        t = t.to(x.device)
        self.stats.add("sum_peers", time.perf_counter() - t0)
        return t

    def gather_peers(self, x: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        t = self._wire(x)
        parts = [torch.empty_like(t) for _ in range(self.peers)]
        self._dist.all_gather(parts, t, group=self._group)
        out = torch.cat(parts, dim=1).to(x.device)
        self.stats.add("gather_peers", time.perf_counter() - t0)
        return out

    def any(self, flag) -> bool:
        t0 = time.perf_counter()
        dev = "cuda" if self.backend == "nccl" else "cpu"
        t = torch.tensor([1 if bool(flag) else 0], dtype=torch.int32,
                         device=dev)
        self._dist.all_reduce(t, op=self._dist.ReduceOp.MAX,
                              group=self._group)
        out = bool(t.item())
        self.stats.add("any", time.perf_counter() - t0)
        return out
