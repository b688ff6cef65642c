"""tests/test_kernel.py's cases, mirrored by hand on the port's round
(etcd_tpu_torch.ops.kernel on the CPU, with the plain ring resolve).

The JAX tests build jnp arrays and step `kernel.step` with them, so they
cannot rerun on the port as they are; each mirror below keeps its JAX
test's name, sizes, seeds, rounds and assertions, with jnp replaced by
torch tensors on device="cpu": elections everywhere, the no-op commit,
single-peer groups, proposals and their replication, commit by
heartbeat, staggered elections, the flow window under partition, one
leader per term and a committed prefix that never changes under chaos,
election timing equal to the port's scalar Raft (`raft/core.py`, a
verbatim copy), lost appends retransmitted, and the corrupt-commit
violation flag."""
import numpy as np
import torch

from etcd_tpu_torch.ops import kernel
from etcd_tpu_torch.ops.state import (F_TYPE, FOLLOWER, LEADER, M_APP,
                                      NH_VIOLATION, PR_REPLICATE,
                                      KernelConfig, init_state)
from etcd_tpu_torch.raft.core import Config as ScalarConfig, Raft
from etcd_tpu_torch.raft.storage import MemoryStorage

I32 = torch.int32


def make(groups=4, peers=3, **kw):
    cfg = KernelConfig(groups=groups, peers=peers, **kw)
    return cfg, init_state(cfg, device="cpu")


def empty_inbox(cfg):
    return torch.zeros((cfg.groups, cfg.peers, cfg.peers, cfg.fields),
                       dtype=I32)


def ints(x):
    return torch.as_tensor(np.asarray(x), dtype=I32)


def leader_slot(st):
    """(G,) leader slot per group, -1 if none."""
    is_l = np.asarray(st.state == LEADER)
    has = is_l.any(axis=1)
    return np.where(has, is_l.argmax(axis=1), -1)


def run_rounds(cfg, st, rounds, inbox=None, props=None, drop=None,
               tick=True):
    if inbox is None:
        inbox = empty_inbox(cfg)
    zero_props = torch.zeros(cfg.groups, dtype=I32)
    for r in range(rounds):
        if props is not None:
            pc, ps = props(r, st)
        else:
            pc, ps = zero_props, zero_props
        st, outbox = kernel.step(cfg, st, inbox, pc, ps, tick)
        inbox = kernel.route_local(outbox)
        if drop is not None:
            inbox = drop(r, inbox)
    return st, inbox


def random_drop(cfg, rng, p):
    def drop(r, inbox):
        mask = rng.rand(cfg.groups, cfg.peers, cfg.peers) < p
        return torch.where(torch.from_numpy(mask)[..., None], 0, inbox)
    return drop


def test_election_happens_everywhere():
    cfg, st = make(groups=8, peers=3)
    st, _ = run_rounds(cfg, st, 60)
    slots = leader_slot(st)
    assert (slots >= 0).all(), f"groups without leader: {np.where(slots < 0)}"
    n_leaders = np.asarray(st.state == LEADER).sum(axis=1)
    assert (n_leaders == 1).all()
    lead = np.asarray(st.lead)
    for g in range(cfg.groups):
        ldr = slots[g] + 1
        assert set(lead[g]) == {ldr}, (g, lead[g])


def test_noop_commits_in_quiescent_group():
    cfg, st = make(groups=4, peers=3)
    st, _ = run_rounds(cfg, st, 120)
    commit = np.asarray(st.commit)
    last = np.asarray(st.last_index)
    assert (commit >= 1).all(), commit
    assert (last >= 1).all(), last


def test_single_peer_group_instant_leader():
    cfg, st = make(groups=2, peers=3)
    st = st._replace(peer_mask=torch.tensor([[True, False, False],
                                             [True, True, True]]))
    st, _ = run_rounds(cfg, st, 25)
    assert np.asarray(st.state)[0, 0] == LEADER
    assert (np.asarray(st.state)[0, 1:] == FOLLOWER).all()
    assert (np.asarray(st.term)[0, 1:] == 0).all()


def test_proposals_commit_and_replicate():
    cfg, st = make(groups=4, peers=3)
    st, inbox = run_rounds(cfg, st, 60)
    slots = leader_slot(st)
    assert (slots >= 0).all()
    base_commit = np.asarray(st.commit)[np.arange(cfg.groups), slots].copy()

    def props(r, cur):
        if r == 0:
            return torch.full((cfg.groups,), 2, dtype=I32), ints(slots)
        return (torch.zeros(cfg.groups, dtype=I32),
                torch.zeros(cfg.groups, dtype=I32))

    st, _ = run_rounds(cfg, st, 6, inbox=inbox, props=props, tick=False)
    commit = np.asarray(st.commit)
    for g in range(cfg.groups):
        assert commit[g, slots[g]] >= base_commit[g] + 2, (
            g, commit[g], base_commit[g])
        for p in range(cfg.peers):
            assert np.asarray(st.last_index)[g, p] >= base_commit[g] + 2


def test_commit_propagates_to_followers_via_heartbeat():
    cfg, st = make(groups=2, peers=3)
    st, inbox = run_rounds(cfg, st, 60)
    slots = leader_slot(st)

    def props(r, cur):
        if r == 0:
            return torch.ones(cfg.groups, dtype=I32), ints(slots)
        return (torch.zeros(cfg.groups, dtype=I32),
                torch.zeros(cfg.groups, dtype=I32))

    st, _ = run_rounds(cfg, st, 10, inbox=inbox, props=props, tick=True)
    commit = np.asarray(st.commit)
    lead_commit = commit[np.arange(cfg.groups), slots]
    for g in range(cfg.groups):
        for p in range(cfg.peers):
            assert commit[g, p] == lead_commit[g], (g, p, commit[g])


def test_staggered_init_elects_in_three_rounds():
    cfg = KernelConfig(groups=16, peers=5)
    st = init_state(cfg, stagger=True, device="cpu")
    st, _ = run_rounds(cfg, st, 3)
    n_leaders = np.asarray(st.state == LEADER).sum(axis=1)
    assert (n_leaders == 1).all()
    slots = leader_slot(st)
    assert (slots == np.arange(16) % 5).all()


def test_flow_window_pauses_replication_to_partitioned_follower():
    cfg = KernelConfig(groups=2, peers=3, window=8, max_ents=2)
    assert cfg.effective_flow_window == 4
    st = init_state(cfg, stagger=True, device="cpu")
    st, inbox = run_rounds(cfg, st, 6)
    slots = leader_slot(st)
    assert (slots >= 0).all()
    g = np.arange(cfg.groups)
    dead = (slots + 1) % cfg.peers
    assert (np.asarray(st.pr_state)[g, slots, dead] == PR_REPLICATE).all()

    def drop(r, inbox):
        arr = inbox.numpy().copy()
        arr[g, dead] = 0
        arr[g, :, dead] = 0
        return torch.from_numpy(arr)

    def props(r, cur):
        return torch.full((cfg.groups,), cfg.max_ents, dtype=I32), ints(slots)

    st, _ = run_rounds(cfg, st, 12, inbox=inbox, props=props, drop=drop)
    nxt = np.asarray(st.next)[g, slots, dead]
    match = np.asarray(st.match)[g, slots, dead]
    unacked = nxt - 1 - match
    assert (unacked <= cfg.effective_flow_window).all(), unacked
    assert (unacked == cfg.effective_flow_window).all(), (
        "pause engaged early", unacked)
    commit = np.asarray(st.commit)[g, slots]
    assert (commit >= 10).all(), commit


def test_leader_unique_per_term_under_chaos():
    cfg, st = make(groups=6, peers=5)
    rng = np.random.RandomState(7)
    leaders_by_term = {}
    drop = random_drop(cfg, rng, 0.3)
    inbox = None
    for chunk in range(30):
        st, inbox = run_rounds(cfg, st, 5, inbox=inbox, drop=drop)
        state = np.asarray(st.state)
        term = np.asarray(st.term)
        for g in range(cfg.groups):
            for p in range(cfg.peers):
                if state[g, p] == LEADER:
                    key = (g, term[g, p])
                    assert leaders_by_term.setdefault(key, p) == p, (
                        f"two leaders in group {g} term {term[g, p]}")


def test_committed_prefix_never_changes_under_chaos():
    cfg, st = make(groups=4, peers=3, window=16, max_ents=2)
    rng = np.random.RandomState(11)
    committed = {}
    drop = random_drop(cfg, rng, 0.25)

    def props(r, cur):
        slots = leader_slot(cur)
        cnt = np.where((slots >= 0) & (rng.rand(cfg.groups) < 0.5), 1, 0)
        return ints(cnt), ints(np.maximum(slots, 0))

    inbox = None
    for chunk in range(40):
        st, inbox = run_rounds(cfg, st, 3, inbox=inbox, drop=drop,
                               props=props)
        commit = np.asarray(st.commit)
        last = np.asarray(st.last_index)
        log_term = np.asarray(st.log_term)
        for g in range(cfg.groups):
            for p in range(cfg.peers):
                c = commit[g, p]
                lo = max(1, last[g, p] - cfg.window + 1)
                for i in range(lo, c + 1):
                    t = log_term[g, p, i % cfg.window]
                    prev = committed.setdefault((g, i), t)
                    assert prev == t, (
                        f"committed entry changed: group {g} index {i}: "
                        f"{prev} -> {t}")
        assert not np.asarray(st.need_host).any()


def test_election_timing_matches_scalar_oracle():
    """No message delivery: campaign ticks bit-identical to the port's
    scalar Raft (same xorshift32 streams, same draw points)."""
    G, P = 3, 3
    cfg, st = make(groups=G, peers=P)
    scalars = {}
    for g in range(G):
        for p in range(P):
            scalars[(g, p)] = Raft(ScalarConfig(
                id=p + 1, peers=list(range(1, P + 1)),
                election_tick=cfg.election_tick,
                heartbeat_tick=cfg.heartbeat_tick,
                storage=MemoryStorage(), group=g))

    inbox = empty_inbox(cfg)
    zero = torch.zeros(G, dtype=I32)
    for step_i in range(40):
        st, outbox = kernel.step(cfg, st, inbox, zero, zero, True)
        for (g, p), r in scalars.items():
            r.tick()
            r.msgs.clear()
        term = np.asarray(st.term)
        state = np.asarray(st.state)
        for (g, p), r in scalars.items():
            assert term[g, p] == r.term, (step_i, g, p, term[g, p], r.term)
            assert state[g, p] == int(r.state), (step_i, g, p)


def test_step_is_jit_stable():
    """The JAX test asserts one trace serves repeated calls; eager
    PyTorch has no trace, and the mirror asserts what remains: the step
    runs twice, the second time on the first's routed outbox."""
    cfg, st = make(groups=2, peers=3)
    inbox = empty_inbox(cfg)
    zero = torch.zeros(cfg.groups, dtype=I32)
    st, out = kernel.step(cfg, st, inbox, zero, zero, True)
    st, out2 = kernel.step(cfg, st, kernel.route_local(out), zero, zero,
                           True)
    assert out2.shape == (cfg.groups, cfg.peers, cfg.peers, cfg.fields)


def test_lost_appends_retransmitted_via_heartbeat_resp():
    cfg = KernelConfig(groups=2, peers=3, window=16, max_ents=2,
                       heartbeat_tick=2)
    st = init_state(cfg, stagger=True, device="cpu")
    st, inbox = run_rounds(cfg, st, 8)
    slots = leader_slot(st)
    assert (slots >= 0).all()
    g = np.arange(cfg.groups)
    victim = (slots + 1) % cfg.peers

    def drop_apps(r, inbox):
        arr = inbox.numpy().copy()
        is_app = arr[g, victim, :, F_TYPE] == M_APP
        arr[g, victim, :, :] = np.where(is_app[..., None], 0,
                                        arr[g, victim, :, :])
        return torch.from_numpy(arr)

    def props(r, cur):
        return torch.full((cfg.groups,), 2, dtype=I32), ints(slots)

    st, inbox = run_rounds(cfg, st, 3, inbox=inbox, props=props,
                           drop=drop_apps)
    last = np.asarray(st.last_index)[g, slots]
    match_v = np.asarray(st.match)[g, slots, victim]
    assert (match_v < last).all(), "victim should be behind"

    st, inbox = run_rounds(cfg, st, 25, inbox=inbox)
    match_v = np.asarray(st.match)[g, slots, victim]
    last = np.asarray(st.last_index)[g, slots]
    assert (match_v == last).all(), (
        "victim not caught up after heal", match_v, last)
    commit = np.asarray(st.commit)[g, victim]
    assert (commit == last).all(), (commit, last)


def test_corrupt_commit_flags_violation():
    cfg, st = make(groups=2, peers=3)
    st, _ = run_rounds(cfg, st, 60)
    assert (leader_slot(st) >= 0).all()
    assert not np.asarray(st.need_host).any()
    bad_commit = np.asarray(st.commit).copy()
    slot = 0 if leader_slot(st)[1] != 0 else 1
    bad_commit[1, slot] = int(np.asarray(st.last_index)[1, slot]) + 7
    st = st._replace(commit=torch.from_numpy(bad_commit))
    st, _ = run_rounds(cfg, st, 1)
    nh = np.asarray(st.need_host)
    assert nh[1, slot] & NH_VIOLATION, nh
    assert not (nh[0] & NH_VIOLATION).any(), nh
