"""Dense struct-of-arrays state for the batched consensus round, in PyTorch.

The counterpart of the JAX package's `ops/state.py`: G groups × P peer
slots held as a `GroupState` NamedTuple of tensors on one device. Layout
conventions are the JAX package's, so the two exchange state through
`state_to_numpy` / `state_from_numpy` and a data dir written by either
engine restores in the other:

- Arrays are shaped (G, P, ...) — group axis first, peer-slot axis second.
- Peer slots are 0-based; `vote`/`lead` store slot+1 with 0 = none.
- The on-device log is a fixed ring of entry TERMS addressed by absolute
  index modulo WINDOW (entry i lives at slot i % W); payloads stay on the
  host.
- All state is int32 (bool for `paused`/`peer_mask`), except the
  xorshift32 PRNG lanes: torch has no left shift for uint32, so `prng`
  carries each uint32 lane in an int64 masked to 32 bits. The numpy
  converters write uint32 back, so trajectories and checkpoints stay
  bit-identical to the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Roles.
FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

# Progress states; SNAPSHOT transfers are host-side.
PR_PROBE, PR_REPLICATE = 0, 1

# Kernel message types (dense codes; NONE=0 means empty slot).
M_NONE, M_APP, M_APP_RESP, M_VOTE, M_VOTE_RESP, M_HB, M_HB_RESP = range(7)

# need_host bitmask values (see GroupState.need_host).
NH_SNAP = 1        # lagging peer: entries fell below the device ring window
NH_VIOLATION = 2   # conflict at/below commit: a protocol violation

# Message field offsets in the last axis of inbox/outbox arrays.
F_TYPE, F_TERM, F_INDEX, F_LOGTERM, F_COMMIT, F_REJECT, F_HINT, F_NENT = range(8)
N_FIXED_FIELDS = 8

U32 = 0xFFFFFFFF


class KernelConfig(NamedTuple):
    """Static parameters of the batched round."""

    groups: int            # G
    peers: int             # P: padded peer-slot count (>= max group size)
    window: int = 16       # W: on-device log ring length
    max_ents: int = 4      # E: max entries per append message
    election_tick: int = 10
    heartbeat_tick: int = 1
    # Max un-acked entries per follower before replication pauses; 0 =
    # window//2, so the pause engages before a silent follower's needed
    # entries can fall off the ring.
    flow_window: int = 0

    @property
    def fields(self) -> int:
        return N_FIXED_FIELDS + self.max_ents

    @property
    def effective_flow_window(self) -> int:
        return self.flow_window if self.flow_window > 0 else self.window // 2


class GroupState(NamedTuple):
    """SoA consensus state. Shapes: G=groups, P=peer slots, W=window."""

    term: torch.Tensor          # (G, P) int32
    vote: torch.Tensor          # (G, P) int32, slot+1, 0 = none
    commit: torch.Tensor        # (G, P) int32
    lead: torch.Tensor          # (G, P) int32, slot+1, 0 = none
    state: torch.Tensor         # (G, P) int32 in {FOLLOWER, CANDIDATE, LEADER}
    elapsed: torch.Tensor       # (G, P) int32
    prng: torch.Tensor          # (G, P) int64 holding uint32 xorshift32 lanes
    log_term: torch.Tensor      # (G, P, W) int32; entry i at slot i % W
    last_index: torch.Tensor    # (G, P) int32
    match: torch.Tensor         # (G, P, P) int32
    next: torch.Tensor          # (G, P, P) int32
    pr_state: torch.Tensor      # (G, P, P) int32 in {PR_PROBE, PR_REPLICATE}
    paused: torch.Tensor        # (G, P, P) bool
    ack_age: torch.Tensor       # (G, P, P) int32 rounds since last append ack
    votes: torch.Tensor         # (G, P, P) int32 0 unknown/1 granted/2 rejected
    peer_mask: torch.Tensor     # (G, P) bool: which peer slots are live
    need_host: torch.Tensor     # (G, P) int32 bitmask of NH_*


def _seed(groups: int, peers: int) -> np.ndarray:
    """Per-(group, slot) xorshift32 seeds, identical to the JAX package's
    (and its scalar oracle's prng_seed(group, node_id=slot+1))."""
    g = np.arange(groups, dtype=np.uint64)[:, None]
    p = np.arange(1, peers + 1, dtype=np.uint64)[None, :]
    s = (g * np.uint64(0x9E3779B9) + p * np.uint64(0x85EBCA6B) + np.uint64(1))
    s = (s & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    s[s == 0] = 1
    return s


def init_state(cfg: KernelConfig, n_peers=None, stagger: bool = False,
               device="cuda") -> GroupState:
    """Fresh-boot state on `device`: every instance a follower at term 0
    with an empty log. `n_peers` may be an int or a (G,) array.

    `stagger=True` pre-ages exactly one instance per group (slot g mod n)
    past its election timeout so it campaigns on the first tick and wins
    uncontested a few rounds later."""
    G, P = cfg.groups, cfg.peers
    if n_peers is None:
        n_peers = P
    n_peers_np = np.broadcast_to(np.asarray(n_peers, np.int32), (G,))
    mask0 = np.arange(P, dtype=np.int32)[None, :] < n_peers_np[:, None]
    elapsed0 = np.zeros((G, P), np.int32)
    if stagger:
        g = np.arange(G)
        # Groups with n_peers == 0 are unprovisioned pool slots.
        slot = (g % np.maximum(n_peers_np, 1)).astype(np.int64)
        elapsed0[g, slot] = np.where(n_peers_np > 0,
                                     2 * cfg.election_tick, 0)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return GroupState(
        term=zeros(G, P),
        vote=zeros(G, P),
        commit=zeros(G, P),
        lead=zeros(G, P),
        state=zeros(G, P),
        elapsed=torch.as_tensor(elapsed0, device=device),
        prng=torch.as_tensor(_seed(G, P).astype(np.int64), device=device),
        log_term=zeros(G, P, cfg.window),
        last_index=zeros(G, P),
        match=zeros(G, P, P),
        next=torch.ones((G, P, P), dtype=torch.int32, device=device),
        pr_state=zeros(G, P, P),
        paused=zeros(G, P, P, dtype=torch.bool),
        ack_age=zeros(G, P, P),
        votes=zeros(G, P, P),
        peer_mask=torch.as_tensor(mask0, device=device),
        need_host=zeros(G, P),
    )


def state_from_numpy(d, device) -> GroupState:
    """A GroupState on `device` from a mapping of numpy arrays in the JAX
    package's dtypes (uint32 `prng`), e.g. `jax_state._asdict()` after
    np.asarray on each field."""
    out = {}
    for name in GroupState._fields:
        a = np.asarray(d[name])
        if name == "prng":
            a = a.astype(np.uint32).astype(np.int64)
        out[name] = torch.tensor(a, device=device)
    return GroupState(**out)


def state_to_numpy(st: GroupState) -> dict:
    """Field name -> numpy array in the JAX package's dtypes."""
    out = {}
    for name, t in st._asdict().items():
        a = t.detach().cpu().numpy()
        out[name] = a.astype(np.uint32) if name == "prng" else a
    return out


def active_mask(st: GroupState) -> torch.Tensor:
    """(G, P) bool: which peer slots exist."""
    return st.peer_mask


def quorum(st: GroupState) -> torch.Tensor:
    """(G,) int32: n//2 + 1."""
    return st.peer_mask.sum(dim=1, dtype=torch.int32) // 2 + 1


def ring_lookup(ring: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """ring[..., W] indexed at slot[..., K] -> [..., K], broadcasting the
    leading axes (a plain gather; slots must lie in [0, W))."""
    shape = torch.broadcast_shapes(ring.shape[:-1], slot.shape[:-1])
    ring_b = ring.expand(*shape, ring.shape[-1])
    slot_b = slot.expand(*shape, slot.shape[-1])
    return torch.gather(ring_b, -1, slot_b.long())


def term_at(st: GroupState, cfg: KernelConfig,
            index: torch.Tensor) -> torch.Tensor:
    """Term of entry `index` per instance; 0 for index 0 and for indices
    outside the device window. index: (G, P). Returns (G, P) int32."""
    slot = torch.remainder(index, cfg.window)
    t = ring_lookup(st.log_term, slot[..., None])[..., 0]
    in_win = (index > st.last_index - cfg.window) & (index <= st.last_index)
    valid = in_win & (index >= 1)
    return torch.where(valid, t, 0)


def in_window(st: GroupState, cfg: KernelConfig,
              index: torch.Tensor) -> torch.Tensor:
    """bool mask: entry `index` is resolvable on device (or is index 0).
    `index` may be (G, P) or carry extra trailing axes."""
    last = st.last_index
    while last.ndim < index.ndim:
        last = last[..., None]
    return ((index > last - cfg.window) & (index <= last)) | (index == 0)


def xorshift32(x: torch.Tensor) -> torch.Tensor:
    """Marsaglia xorshift32 on int64-carried uint32 lanes, bit-identical
    to the JAX package's uint32 version."""
    x = x ^ ((x << 13) & U32)
    x = x ^ (x >> 17)
    x = x ^ ((x << 5) & U32)
    return x
