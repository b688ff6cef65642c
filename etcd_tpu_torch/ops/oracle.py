"""The batched round held against the scalar Raft.

`kernel.step` advances G groups × P peer slots at once; the oracle is one
scalar `raft.core.Raft` per (group, slot), built with the group's real
index, so its randomised election timeout is the kernel's for the same
(g, slot). Both consume the same inbox every round: the kernel's routed
outbox after fault injection (drops, delays, a forced leader partition).
The scalar's own sends are discarded: the comparison is of state, not of
message streams.

Mirroring rules (the kernel's phase order, `kernel.step`'s docstring):
- the scalar ticks first, then steps slot-q messages for q = 0..P-1,
  then proposals;
- proposals are clamped with the kernel's admission rule
  (min(req, max_ents, window//2 - uncommitted tail)) computed from scalar
  state, which equals the kernel's by induction.

Compared after every round, per mirrored instance: term, vote, state,
lead, commit, last index, and the entry terms in the ring window (at and
above commit exactly; below it a slot stranded by a shrinking truncation
may read 0, never a wrong term). `need_host` must never fire: the
proposal throttle keeps every schedule inside the window.

Two drivers share the mirror:
- `run_equivalence`: the schedules of the JAX package's equivalence
  tests, drawn on the host from numpy's RandomState(seed), every group
  mirrored;
- `run_sampled`: the faults drawn on the round's device from a
  torch.Generator, and a sample of groups mirrored; only their faulted
  inbox and state come to the host each round.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from etcd_tpu_torch.ops import kernel
from etcd_tpu_torch.ops.ring_resolve import TILE_ROWS, ring_resolve
from etcd_tpu_torch.ops.state import (F_COMMIT, F_HINT, F_INDEX, F_LOGTERM,
                                      F_NENT, F_REJECT, F_TERM, F_TYPE,
                                      KernelConfig, LEADER, N_FIXED_FIELDS,
                                      init_state)
from etcd_tpu_torch.raft.core import (Config as ScalarConfig,
                                      ProposalDroppedError, Raft)
from etcd_tpu_torch.raft.storage import MemoryStorage
from etcd_tpu_torch.raftpb import Entry, Message, MessageType

# kernel message code -> scalar MessageType
_MSG_TYPE = {
    1: MessageType.APP,
    2: MessageType.APP_RESP,
    3: MessageType.VOTE,
    4: MessageType.VOTE_RESP,
    5: MessageType.HEARTBEAT,
    6: MessageType.HEARTBEAT_RESP,
}

# The state fields the mirror compares, as (G, P) or (G, P, W) arrays.
COMPARED = ("term", "vote", "state", "lead", "commit", "last_index",
            "log_term")


def _expect(ok, *what) -> None:
    """An equality the oracle holds; raises even under `python -O`."""
    if not ok:
        raise AssertionError(what)


def dense_to_message(fields, to_slot: int, frm_slot: int):
    """One dense mailbox slot as a scalar raftpb.Message (None if empty)."""
    mtype = int(fields[F_TYPE])
    if mtype == 0:
        return None
    n = int(fields[F_NENT])
    base = int(fields[F_INDEX])
    ents = tuple(Entry(term=int(fields[N_FIXED_FIELDS + j]),
                       index=base + 1 + j) for j in range(n))
    return Message(
        type=_MSG_TYPE[mtype], to=to_slot + 1, frm=frm_slot + 1,
        term=int(fields[F_TERM]), log_term=int(fields[F_LOGTERM]),
        index=base, entries=ents, commit=int(fields[F_COMMIT]),
        reject=bool(fields[F_REJECT]), reject_hint=int(fields[F_HINT]))


def snapshot(st, rows=None) -> Dict[str, np.ndarray]:
    """The compared fields of `st` on the host, for the groups `rows`
    (a long tensor of group indices on st's device; all groups if None)."""
    pick = (lambda x: x) if rows is None else (lambda x: x[rows])
    return {f: pick(getattr(st, f)).cpu().numpy() for f in COMPARED}


class Mirror:
    """Scalar Raft instances mirroring the groups `groups` (all of the
    config's groups by default) of one kernel state. Row i of every array
    the mirror takes or compares is group groups[i].

    n_peers < cfg.peers exercises the kernel's padded peer slots: only
    the first n_peers slots are live on both sides (inactive slots must
    stay inert zeros)."""

    def __init__(self, cfg: KernelConfig, groups: Optional[Sequence[int]] = None,
                 n_peers: Optional[int] = None):
        self.cfg = cfg
        self.groups = (list(range(cfg.groups)) if groups is None
                       else [int(g) for g in groups])
        self.n_peers = cfg.peers if n_peers is None else n_peers
        self.rafts = {}
        for i, g in enumerate(self.groups):
            for p in range(self.n_peers):
                self.rafts[(i, p)] = Raft(ScalarConfig(
                    id=p + 1, peers=list(range(1, self.n_peers + 1)),
                    election_tick=cfg.election_tick,
                    heartbeat_tick=cfg.heartbeat_tick,
                    storage=MemoryStorage(), group=g))

    def run_round(self, inbox_np, prop_count, prop_slot, tick=True) -> None:
        """One round on the mirrored rows: inbox_np (S, P, P, F),
        prop_count and prop_slot (S,)."""
        cfg = self.cfg
        # The kernel's admission throttle reads the round-start commit: a
        # leader's commit never moves during the message phase (MsgApp and
        # MsgHB commit updates are masked to non-leaders), while the
        # scalar advances committed eagerly inside stepLeader.
        commit0 = {k: r.raft_log.committed for k, r in self.rafts.items()}
        if tick:
            for r in self.rafts.values():
                r.tick()
        # Messages in kernel order: sender slot 0..P-1 across all rows.
        for q in range(cfg.peers):
            for (i, p), r in self.rafts.items():
                m = dense_to_message(inbox_np[i, p, q], p, q)
                if m is not None:
                    r.step(m)
        for i in range(len(self.groups)):
            req = int(prop_count[i])
            if req == 0:
                continue
            key = (i, int(prop_slot[i]))
            r = self.rafts[key]
            tail = r.raft_log.last_index() - commit0[key]
            cnt = min(req, cfg.max_ents, max(0, cfg.window // 2 - tail))
            if cnt <= 0 or int(r.state) != LEADER:
                continue
            try:
                r.step(Message(type=MessageType.PROP, frm=r.id,
                               entries=tuple(Entry() for _ in range(cnt))))
            except ProposalDroppedError:
                pass
        for r in self.rafts.values():
            r.msgs.clear()

    def assert_equal(self, snap: Dict[str, np.ndarray], round_i: int) -> None:
        """snap: `snapshot` of the kernel state at the mirrored rows."""
        cfg = self.cfg
        term, vote, state = snap["term"], snap["vote"], snap["state"]
        lead, commit = snap["lead"], snap["commit"]
        last, ring = snap["last_index"], snap["log_term"]
        if self.n_peers < cfg.peers:
            for arr, nm in ((term, "term"), (state, "state"),
                            (commit, "commit"), (last, "last")):
                _expect(not arr[:, self.n_peers:].any(), round_i, nm,
                        "inactive slot moved")
        for (i, p), r in self.rafts.items():
            where = f"round {round_i} g={self.groups[i]} p={p}"
            _expect(term[i, p] == r.term, where, "term", term[i, p], r.term)
            _expect(vote[i, p] == r.vote, where, "vote", vote[i, p], r.vote)
            _expect(state[i, p] == int(r.state), where, "state",
                    state[i, p], int(r.state))
            _expect(lead[i, p] == r.lead, where, "lead", lead[i, p], r.lead)
            _expect(commit[i, p] == r.raft_log.committed, where, "commit",
                    commit[i, p], r.raft_log.committed)
            _expect(last[i, p] == r.raft_log.last_index(), where, "last",
                    last[i, p], r.raft_log.last_index())
            lo = max(1, last[i, p] - cfg.window + 1)
            for idx in range(lo, last[i, p] + 1):
                kt = ring[i, p, idx % cfg.window]
                stt = r.raft_log.term(idx)
                if idx >= commit[i, p]:
                    _expect(kt == stt, where, "logterm", idx, kt, stt)
                else:
                    _expect(kt in (stt, 0), where, "logterm<commit", idx,
                            kt, stt)


def run_equivalence(seed, groups=5, peers=3, window=32, max_ents=3,
                    rounds=140, drop_p=0.2, delay_p=0.1, prop_p=0.6,
                    partition_every=45, partition_len=12,
                    min_live_groups=None, n_peers=None, tick_p=1.0,
                    resolve=ring_resolve,
                    on_round: Optional[Callable] = None, device="cuda"):
    """One schedule of the JAX package's equivalence tests, every group
    mirrored: the same numpy draws in the same order, so a seed gives the
    same faults, proposals and ticks as there. The round runs on `device`
    (on the card `resolve` launches the CUDA kernel); the draws and the
    scalar Raft stay on the host. Returns the final state.

    min_live_groups: how many groups must have committed something at
    the end (default groups-1). n_peers: live slots out of `peers`.
    tick_p: the chance that a round advances the logical clock.
    on_round(i, faulted, pc, ps, tick, st): called after round i's step
    with its numpy inputs and the kernel's new state."""
    cfg = KernelConfig(groups=groups, peers=peers, window=window,
                       max_ents=max_ents)
    dev = torch.device(device)
    st = init_state(cfg, n_peers=n_peers, device=dev)
    mirror = Mirror(cfg, n_peers=n_peers)
    rng = np.random.RandomState(seed)
    G, P, F = groups, peers, cfg.fields
    inbox = np.zeros((G, P, P, F), np.int32)
    delayed = []          # (deliver_round, g, to, frm, fields)
    partitioned = -1      # slot partitioned in ALL groups (leader churn)
    gidx = np.arange(G)

    for i in range(rounds):
        if i % partition_every == partition_every - 1:
            states = st.state.cpu().numpy()
            partitioned = int((states == LEADER).argmax(axis=1)[0])
            part_until = i + partition_len
        if partitioned >= 0 and i >= part_until:
            partitioned = -1

        faulted = inbox.copy()
        drop = rng.rand(G, P, P) < drop_p
        delay = (~drop) & (rng.rand(G, P, P) < delay_p)
        if partitioned >= 0:
            faulted[:, partitioned, :] = 0
            faulted[:, :, partitioned] = 0
        for g, to, frm in zip(*np.nonzero(delay)):
            if faulted[g, to, frm, F_TYPE] != 0:
                delayed.append((i + 1 + rng.randint(1, 4), g, to, frm,
                                faulted[g, to, frm].copy()))
                faulted[g, to, frm] = 0
        faulted[drop] = 0
        still = []
        for (due, g, to, frm, fields) in delayed:
            if due > i:
                still.append((due, g, to, frm, fields))
            elif faulted[g, to, frm, F_TYPE] == 0 and \
                    not (partitioned >= 0 and partitioned in (to, frm)):
                faulted[g, to, frm] = fields
        delayed = still

        states = st.state.cpu().numpy()
        has_lead = (states == LEADER).any(axis=1)
        slots = (states == LEADER).argmax(axis=1)
        match = st.match.cpu().numpy()
        lastv = st.last_index.cpu().numpy()
        lead_last = lastv[gidx, slots]
        lead_match = match[gidx, slots].copy()
        lead_match[gidx, slots] = lead_last
        if n_peers is not None and n_peers < peers:
            lead_match[:, n_peers:] = lead_last[:, None]
        worst_gap = lead_last - lead_match.min(axis=1)
        room_ok = worst_gap <= window - 4 * max_ents
        want = rng.rand(G) < prop_p
        pc = np.where(has_lead & want & room_ok,
                      rng.randint(1, max_ents + 1, G), 0).astype(np.int32)
        ps = np.where(has_lead, slots, 0).astype(np.int32)

        tick = True if tick_p >= 1.0 else bool(rng.rand() < tick_p)
        st, outbox = kernel.step(
            cfg, st, torch.from_numpy(faulted).to(dev),
            torch.from_numpy(pc).to(dev), torch.from_numpy(ps).to(dev),
            tick, resolve=resolve)
        mirror.run_round(faulted, pc, ps, tick=tick)

        _expect(not bool(st.need_host.any()), "need_host at round", i)
        mirror.assert_equal(snapshot(st), i)
        if on_round is not None:
            on_round(i, faulted, pc, ps, tick, st)
        inbox = kernel.route_local(outbox).cpu().numpy()
    floor = groups - 1 if min_live_groups is None else min_live_groups
    commit = st.commit.amax(dim=1).cpu().numpy()
    _expect((commit > 0).sum() >= floor, "too few groups committed", commit)
    return st


def sample_groups(groups: int, peers: int, n: int = 128,
                  seed: int = 0) -> list:
    """At least n group indices: group 0, the last group, the groups
    whose rows (g * peers + p) straddle a TILE_ROWS-row tile edge of
    `ring_resolve`'s launch plan (up to n - 2 of them, spread over the
    whole range), and random groups to make up n."""
    rows = groups * peers
    straddle = sorted({e // peers for e in range(TILE_ROWS, rows, TILE_ROWS)
                       if e % peers})
    if len(straddle) > n - 2:
        pick = np.linspace(0, len(straddle) - 1, n - 2).round().astype(int)
        straddle = [straddle[k] for k in sorted(set(pick))]
    chosen = {0, groups - 1, *straddle}
    rng = np.random.RandomState(seed)
    while len(chosen) < min(n, groups):
        chosen.add(int(rng.randint(groups)))
    return sorted(chosen)


def run_sampled(cfg: KernelConfig, seed: int, rounds: int, drop_p=0.2,
                delay_p=0.1, prop_p=0.6, partition_every=45,
                partition_len=12, device="cuda", twin_resolve=None) -> dict:
    """A schedule at full width: `kernel.step` with `ring_resolve`, its
    faults drawn on `device` from a torch.Generator seeded with `seed`,
    the groups of `sample_groups` mirrored by the scalar Raft after every
    round, and `need_host` checked on all groups. The fault model is
    `run_equivalence`'s: drops; delays (a held message is delivered 2-4
    rounds after the one it was sent for, into an empty slot only, else
    it is lost); every `partition_every` rounds, group 0's leader slot
    cut off in every group for `partition_len` rounds; proposals only
    while the leader's worst follower gap is <= window - 4 * max_ents.

    twin_resolve: step a second state with this resolve on the same
    inputs, and require its state and outbox equal after every round.
    At the end, more than half of the groups must have committed.
    Returns the run's numbers."""
    G, P, F = cfg.groups, cfg.peers, cfg.fields
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sample = sample_groups(G, P)
    rows = torch.tensor(sample, dtype=torch.long, device=dev)
    mirror = Mirror(cfg, groups=sample)
    st = init_state(cfg, device=dev)
    twin = (None if twin_resolve is None
            else type(st)(*(x.clone() for x in st)))
    inbox = torch.zeros((G, P, P, F), dtype=torch.int32, device=dev)
    held = torch.zeros((5, G, P, P, F), dtype=torch.int32, device=dev)
    slot_ar = torch.arange(P, device=dev)
    g_ar = torch.arange(G, device=dev)
    partitioned, part_until = -1, 0
    t_kernel = t_mirror = 0.0
    by0 = dict(ring_resolve.launches_by_variant)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    for i in range(rounds):
        if i % partition_every == partition_every - 1:
            partitioned = int(kernel._first_true(st.state[0] == LEADER))
            part_until = i + partition_len
        if partitioned >= 0 and i >= part_until:
            partitioned = -1
        cut = torch.zeros((P, P), dtype=torch.bool, device=dev)
        if partitioned >= 0:
            cut = (slot_ar[:, None] == partitioned) | (
                slot_ar[None, :] == partitioned)

        drop = rand(G, P, P) < drop_p
        delay = ~drop & (rand(G, P, P) < delay_p)
        hold_for = torch.randint(1, 4, (G, P, P), generator=gen, device=dev)
        faulted = torch.where(cut[None, :, :, None], 0, inbox)
        delay &= faulted[..., F_TYPE] != 0
        for k in (1, 2, 3):
            buf = held[(i + 1 + k) % 5]
            put = delay & (hold_for == k) & (buf[..., F_TYPE] == 0)
            buf.copy_(torch.where(put[..., None], faulted, buf))
        faulted = torch.where((delay | drop)[..., None], 0, faulted)
        due = held[i % 5]
        land = (due[..., F_TYPE] != 0) & (faulted[..., F_TYPE] == 0) & ~cut
        faulted = torch.where(land[..., None], due, faulted)
        due.zero_()

        lead_m = st.state == LEADER
        has_lead = lead_m.any(dim=1)
        slots = kernel._first_true(lead_m, dim=1).long()
        lead_last = st.last_index[g_ar, slots]
        lead_match = st.match[g_ar, slots].clone()
        lead_match[g_ar, slots] = lead_last
        worst_gap = lead_last - lead_match.amin(dim=1)
        room_ok = worst_gap <= cfg.window - 4 * cfg.max_ents
        want = rand(G) < prop_p
        cnt = torch.randint(1, cfg.max_ents + 1, (G,), generator=gen,
                            device=dev)
        pc = torch.where(has_lead & want & room_ok, cnt, 0).to(torch.int32)
        ps = torch.where(has_lead, slots, 0).to(torch.int32)

        _sync(dev)
        t1 = time.perf_counter()
        st, outbox = kernel.step(cfg, st, faulted, pc, ps, True)
        _sync(dev)
        t_kernel += time.perf_counter() - t1
        if twin is not None:
            twin, outbox_t = kernel.step(cfg, twin, faulted, pc, ps, True,
                                         resolve=twin_resolve)
            _expect(all(torch.equal(a, b) for a, b in zip(st, twin))
                    and torch.equal(outbox, outbox_t), "round", i,
                    "state or outbox differs under", twin_resolve.__name__)
        _expect(not bool(st.need_host.any()), "need_host at round", i)
        t1 = time.perf_counter()
        mirror.run_round(faulted[rows].cpu().numpy(), pc[rows].cpu().numpy(),
                         ps[rows].cpu().numpy())
        mirror.assert_equal(snapshot(st, rows), i)
        t_mirror += time.perf_counter() - t1
        inbox = kernel.route_local(outbox)
    committed = int((st.commit.amax(dim=1) > 0).sum())
    _expect(2 * committed > G, "groups committed", committed, "of", G)
    return {"groups": G, "rounds": rounds, "sampled_groups": len(sample),
            "ms_per_round": t_kernel / rounds * 1e3,
            "mirror_ms_per_round": t_mirror / rounds * 1e3,
            "groups_committed": committed,
            "launches_by_variant": {
                k: ring_resolve.launches_by_variant[k] - by0[k]
                for k in by0},
            "twin": None if twin is None else twin_resolve.__name__}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
