"""Mesh and sharding layout for the batched consensus round, in PyTorch.

The counterpart of the JAX package's `parallel/mesh.py`. The round's two
parallel axes map onto a 2-D grid of devices:

- "groups": independent Raft groups. A cell holds a contiguous block of
  groups; blocks never exchange anything.
- "peers": the peer slots of each group. A cell holds a contiguous block
  of peer columns, and the per-hop message routing (outbox[g, from, to]
  -> inbox[g, to, from]) becomes an all-to-all between the cells of one
  groups row (parallel/comm.py).

JAX keeps one global array per field and lets XLA place the shards and
insert the collectives. Eager PyTorch has neither, so a sharded field
here is a `Sharded`: one tensor per cell, each on its cell's device, and
the round runs once per cell on its own block (ops/kernel.py with `c0`
and a comm). A device list may repeat a device (["cpu"] * 8,
["cuda:0"] * 4): cells on one device are separate tensors all the same.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from etcd_tpu_torch.ops.state import GroupState
from etcd_tpu_torch.parallel.comm import run_cells

AXES = ("groups", "peers")
# Layout of one field: the mesh axis each leading dim is split over
# (None = whole in every cell), as JAX's PartitionSpec.
GP = ("groups", "peers")
GPX = ("groups", "peers", None)


class Mesh:
    """A ("groups", "peers") grid of torch devices."""

    def __init__(self, devices: Sequence[Sequence]) -> None:
        self.devices = [[torch.device(d) for d in row] for row in devices]
        if not self.devices or len({len(r) for r in self.devices}) != 1:
            raise ValueError("a mesh needs equal, non-empty rows of devices")
        self.axis_names = AXES
        self.shape = (len(self.devices), len(self.devices[0]))

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def cells(self):
        """Every (gi, pi) cell, row by row."""
        return [(gi, pi) for gi in range(self.shape[0])
                for pi in range(self.shape[1])]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={self.devices})"


def make_mesh(devices=None, peers_axis: int = 1) -> Mesh:
    """A ("groups", "peers") mesh over `devices` (default: every visible
    CUDA device); peers_axis devices are dedicated to the replication
    axis (1 = all devices on the groups axis)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices (e.g. ['cpu'] * 8) to build a CPU "
                               "mesh")
    devices = list(devices)
    n = len(devices)
    if n % peers_axis != 0:
        raise ValueError(f"{n} devices not divisible by peers_axis={peers_axis}")
    rows = n // peers_axis
    return Mesh([devices[r * peers_axis:(r + 1) * peers_axis]
                 for r in range(rows)])


def state_sharding(mesh: Mesh) -> GroupState:
    """The layout of every GroupState field: split on its leading group
    axis and its first peer axis; the target-peer axis and the log window
    stay whole within a cell."""
    return GroupState(
        term=GP, vote=GP, commit=GP, lead=GP, state=GP, elapsed=GP,
        prng=GP, log_term=GPX, last_index=GP,
        match=GPX, next=GPX, pr_state=GPX, paused=GPX, ack_age=GPX,
        votes=GPX, peer_mask=GP, need_host=GP)


def mailbox_sharding(mesh: Mesh) -> tuple:
    """The layout of inbox/outbox (G, P, P, F): groups and the first peer
    axis split. Routing (swapping the two peer axes) is then an
    all-to-all over the "peers" axis of the mesh."""
    return ("groups", "peers", None, None)


def _bounds(n: int, parts: int, what: str) -> List[tuple]:
    if n % parts != 0:
        raise ValueError(f"{what} of size {n} not divisible by the mesh "
                         f"axis of size {parts}")
    b = n // parts
    return [(i * b, (i + 1) * b) for i in range(parts)]


class Sharded:
    """One logical tensor laid out over a mesh: `blocks[gi][pi]` is cell
    (gi, pi)'s block, on that cell's device. Dims named in `spec` are
    split over their mesh axis; the rest are whole in every cell."""

    def __init__(self, mesh: Mesh, blocks, spec: tuple) -> None:
        self.mesh = mesh
        self.blocks = blocks
        self.spec = spec

    @classmethod
    def split(cls, mesh: Mesh, x: torch.Tensor, spec: tuple) -> "Sharded":
        """Place a whole tensor onto the mesh (a copy per cell)."""
        ng, npr = mesh.shape
        gb = _bounds(x.shape[0], ng, "groups") if spec[0] else [(0, None)] * ng
        pb = (_bounds(x.shape[1], npr, "peers") if len(spec) > 1 and spec[1]
              else [(0, None)] * npr)
        blocks = [[x[g0:g1, p0:p1].to(mesh.devices[gi][pi]).clone(
                   memory_format=torch.contiguous_format)
                   for pi, (p0, p1) in enumerate(pb)]
                  for gi, (g0, g1) in enumerate(gb)]
        return cls(mesh, blocks, spec)

    def whole(self, device="cpu") -> torch.Tensor:
        """The logical tensor, joined into a fresh tensor on `device`."""
        split_p = len(self.spec) > 1 and self.spec[1]
        rows = [torch.cat([b.to(device) for b in
                           (row if split_p else row[:1])],
                          dim=1 if split_p else 0)
                for row in self.blocks]
        return torch.cat(rows if self.spec[0] else rows[:1], dim=0)

    def to(self, device, copy: bool = False) -> torch.Tensor:
        """`whole` under the name tensors use, so host readers take a
        Sharded as they take a tensor."""
        return self.whole(device)

    @property
    def shape(self) -> torch.Size:
        b = self.blocks[0][0]
        ng, npr = self.mesh.shape
        dims = list(b.shape)
        if self.spec[0]:
            dims[0] *= ng
        if len(self.spec) > 1 and self.spec[1]:
            dims[1] *= npr
        return torch.Size(dims)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0][0].dtype

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"mesh={self.mesh.shape}, spec={self.spec})")


def shard_state(st: GroupState, mesh: Mesh) -> GroupState:
    """Place a whole GroupState onto the mesh: a GroupState of Sharded
    fields in `state_sharding`'s layout (fields already sharded pass
    through)."""
    sh = state_sharding(mesh)
    return GroupState(**{
        name: (x if isinstance(x, Sharded)
               else Sharded.split(mesh, x, getattr(sh, name)))
        for name, x in st._asdict().items()})


def unshard_state(st: GroupState, device="cpu") -> GroupState:
    """The whole GroupState of a sharded one, joined on `device`."""
    return GroupState(**{name: x.whole(device)
                         for name, x in st._asdict().items()})


def shard_mailbox(mb: torch.Tensor, mesh: Mesh) -> Sharded:
    """Place a whole (G, P, P, F) inbox/outbox onto the mesh."""
    return Sharded.split(mesh, mb, mailbox_sharding(mesh))


def unshard_mailbox(mb: Sharded, device="cpu") -> torch.Tensor:
    return mb.whole(device)


def cell_state(st: GroupState, gi: int, pi: int) -> GroupState:
    """Cell (gi, pi)'s block of a sharded GroupState."""
    return GroupState(*(x.blocks[gi][pi] for x in st))


def state_block(st: GroupState, g0: int, g1: Optional[int], p0: int,
                p1: Optional[int]) -> GroupState:
    """A contiguous copy of rows [g0, g1) and peer columns [p0, p1) of a
    whole GroupState: what one cell of a mesh holds (a process of the
    collective plane keeps its own column this way)."""
    return GroupState(*(x[g0:g1, p0:p1].clone(
        memory_format=torch.contiguous_format) for x in st))


def mesh_round(fn, cfg, st: GroupState, inbox: Sharded, prop, prop_slot,
               tick: bool, drop_mask=None, hops: int = 1, stats=None):
    """One round of `fn` (kernel.step_routed_auto, step_routed_read_auto,
    or step_routed_slots_auto when prop_slot is None) over the mesh that
    holds `st` and `inbox`: every cell runs `fn` on its block in its own
    thread with a LocalComm (parallel/comm.py), all in lockstep.

    prop (the proposal counts) and prop_slot are whole (G,) tensors (prop
    is the whole (G, P) cnt_gp for the slots round) and drop_mask a whole (G, P_to, P_from,
    1)-broadcastable mask; each cell takes its slices. `stats` (a
    comm.CommStats) records cell (0, 0)'s comm calls. Returns the round's
    outputs with state and inbox sharded as they came and any per-group
    outputs (the read plane's) whole on the first cell's device."""
    mesh = inbox.mesh
    ng, npr = mesh.shape
    G, P = prop.shape[0], cfg.peers
    Gb, Pb = G // ng, P // npr
    if drop_mask is not None:
        drop_mask = torch.as_tensor(drop_mask)
        drop_mask = drop_mask.expand(G, P, P, drop_mask.shape[-1])

    def cell(gi, pi, comm):
        dev = mesh.devices[gi][pi]
        g0, c0 = gi * Gb, pi * Pb
        dm = (None if drop_mask is None else
              drop_mask[g0:g0 + Gb, c0:c0 + Pb].to(dev))
        blk = cell_state(st, gi, pi)
        mb = inbox.blocks[gi][pi]
        if prop_slot is None:
            return fn(cfg, blk, mb, prop[g0:g0 + Gb, c0:c0 + Pb].to(dev),
                      tick, dm, hops, c0=c0, comm=comm)
        return fn(cfg, blk, mb, prop[g0:g0 + Gb].to(dev),
                  prop_slot[g0:g0 + Gb].to(dev), tick, dm, hops, c0=c0,
                  comm=comm)

    out = run_cells(mesh, cell, stats)
    sh = state_sharding(mesh)
    new_st = GroupState(*(
        Sharded(mesh, [[out[gi][pi][0][k] for pi in range(npr)]
                       for gi in range(ng)], sh[k])
        for k in range(len(GroupState._fields))))
    new_inbox = Sharded(mesh, [[out[gi][pi][1] for pi in range(npr)]
                               for gi in range(ng)], inbox.spec)
    first = mesh.devices[0][0]
    rest = tuple(torch.cat([out[gi][0][k].to(first) for gi in range(ng)])
                 for k in range(2, len(out[0][0])))
    return (new_st, new_inbox) + rest
