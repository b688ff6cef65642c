"""tests/test_quiet_path.py's cases, mirrored by hand on the port's round
(etcd_tpu_torch.ops.kernel on the CPU, with the plain ring resolve).

Each mirror keeps its JAX test's sizes, seed, rounds, partitions and
assertions, with jnp replaced by torch tensors: the port's auto path
(`_quiet_pred` selecting the one-pass message phase) must equal its
full path, hops=H must equal H chained single hops, a proposal must
commit within one hops=3 round, and the slots round's auto path must
equal the full slots round chained hop by hop. Each mirror also steps
the JAX package's round on the same inputs and requires the port's
trajectory to equal JAX's after every round: every state field and the
routed inbox, exactly."""
import numpy as np
import torch

import jax.numpy as jnp

from etcd_tpu.ops import kernel as jk
from etcd_tpu.ops import state as js
from etcd_tpu_torch.ops import kernel
from etcd_tpu_torch.ops.state import (LEADER, KernelConfig, init_state,
                                      state_from_numpy, state_to_numpy)

I32 = torch.int32


def _assert_same(sa, sb, ia, ib, r):
    fa, fb = state_to_numpy(sa), state_to_numpy(sb)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), \
            f"round {r}: field {k} diverged\n{fa[k]}\n{fb[k]}"
    assert torch.equal(ia, ib), f"round {r}: inbox diverged"


def _assert_jax(st_j, st_t, in_j, in_t, r):
    """The port's state and inbox equal JAX's, field by field."""
    ft = state_to_numpy(st_t)
    for k, v in st_j._asdict().items():
        v = np.asarray(v)
        assert v.dtype == ft[k].dtype and np.array_equal(v, ft[k]), \
            f"round {r}: field {k} differs from JAX\n{v}\n{ft[k]}"
    if in_j is not None:
        assert np.array_equal(np.asarray(in_j), in_t.numpy()), \
            f"round {r}: inbox differs from JAX"


def _jcfg(cfg):
    return js.KernelConfig(**cfg._asdict())


def _both(cfg):
    """One staggered boot state for the port (torch, CPU) and JAX."""
    st_j = js.init_state(_jcfg(cfg), stagger=True)
    st_t = state_from_numpy({k: np.asarray(v)
                             for k, v in st_j._asdict().items()}, "cpu")
    _assert_jax(st_j, st_t, None, None, "boot")
    return st_j, st_t


def test_auto_matches_full_trajectory():
    G, P = 8, 5
    cfg = KernelConfig(groups=G, peers=P, window=8, max_ents=2,
                       election_tick=10, heartbeat_tick=3)
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(7)

    st_j, st_f = _both(cfg)
    st_a = init_state(cfg, stagger=True, device="cpu")
    in_f = torch.zeros((G, P, P, cfg.fields), dtype=I32)
    in_a = torch.zeros((G, P, P, cfg.fields), dtype=I32)
    in_j = jnp.zeros((G, P, P, cfg.fields), jnp.int32)

    quiet_rounds = 0
    drop = None
    for r in range(260):
        if r == 120 or r == 145:
            state = np.asarray(st_f.state)
            lead3 = int((state[3] == LEADER).argmax())
            m_to = np.ones((G, P, 1, 1), np.int32)
            m_from = np.ones((G, 1, P, 1), np.int32)
            if r == 120:
                m_to[3, lead3] = 0
                m_from[3, 0, lead3] = 0
                drop = m_to * m_from
            else:
                drop = None

        state = np.asarray(st_f.state)
        has_lead = (state == LEADER).any(axis=1)
        slots = (state == LEADER).argmax(axis=1).astype(np.int32)
        pc = ((rng.integers(0, cfg.max_ents + 1, size=G) * has_lead)
              .astype(np.int32) if r % 3 else np.zeros(G, np.int32))

        quiet_rounds += bool(kernel._quiet_pred(
            st_f, cfg, in_f, st_f.peer_mask, True))

        st_f, in_f = kernel.step_routed(cfg, st_f, in_f,
                                        torch.from_numpy(pc),
                                        torch.from_numpy(slots), True)
        st_a, in_a = kernel.step_routed_auto(cfg, st_a, in_a,
                                             torch.from_numpy(pc),
                                             torch.from_numpy(slots), True)
        st_j, in_j = jk.step_routed_auto(jcfg, st_j, in_j, jnp.asarray(pc),
                                         jnp.asarray(slots),
                                         jnp.asarray(True))
        if drop is not None:
            in_f = in_f * torch.from_numpy(drop)
            in_a = in_a * torch.from_numpy(drop)
            in_j = in_j * jnp.asarray(drop)
        _assert_same(st_f, st_a, in_f, in_a, r)
        _assert_jax(st_j, st_a, in_j, in_a, r)

    commit = np.asarray(st_f.commit)
    assert (commit.max(axis=1) > 10).all(), commit
    assert quiet_rounds > 100, quiet_rounds
    assert quiet_rounds < 260, quiet_rounds


def test_multihop_equals_chained_single_hops():
    G, P, H = 6, 5, 3
    cfg = KernelConfig(groups=G, peers=P, window=8, max_ents=2,
                       election_tick=10, heartbeat_tick=3)
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(11)

    st_j, st_m = _both(cfg)
    st_s = init_state(cfg, stagger=True, device="cpu")
    in_m = torch.zeros((G, P, P, cfg.fields), dtype=I32)
    in_s = torch.zeros((G, P, P, cfg.fields), dtype=I32)
    in_j = jnp.zeros((G, P, P, cfg.fields), jnp.int32)
    zero = torch.zeros(G, dtype=I32)

    drop = None
    for r in range(80):
        if r == 30:
            m_to = np.ones((G, P, 1, 1), np.int32)
            m_from = np.ones((G, 1, P, 1), np.int32)
            m_to[2, 1] = 0
            m_from[2, 0, 1] = 0
            drop = m_to * m_from
        if r == 55:
            drop = None

        state = np.asarray(st_s.state)
        has_lead = (state == LEADER).any(axis=1)
        slots = (state == LEADER).argmax(axis=1).astype(np.int32)
        pc = ((rng.integers(0, cfg.max_ents + 1, size=G) * has_lead)
              .astype(np.int32) if r % 2 else np.zeros(G, np.int32))
        drop_t = None if drop is None else torch.from_numpy(drop)

        st_m, in_m = kernel.step_routed_auto(cfg, st_m, in_m,
                                             torch.from_numpy(pc),
                                             torch.from_numpy(slots), True,
                                             drop_t, H)
        st_j, in_j = jk.step_routed_auto(
            jcfg, st_j, in_j, jnp.asarray(pc), jnp.asarray(slots),
            jnp.asarray(True), None if drop is None else jnp.asarray(drop),
            H)
        for h in range(H):
            st_s, in_s = kernel.step_routed_auto(
                cfg, st_s, in_s, torch.from_numpy(pc) if h == 0 else zero,
                torch.from_numpy(slots), h == 0)
            if drop_t is not None:
                in_s = in_s * drop_t
        _assert_same(st_m, st_s, in_m, in_s, r)
        _assert_jax(st_j, st_m, in_j, in_m, r)

    commit = np.asarray(st_m.commit)
    assert (commit.max(axis=1) > 10).all(), commit


def test_multihop_commits_proposal_in_one_round():
    G, P = 4, 5
    cfg = KernelConfig(groups=G, peers=P, window=8, max_ents=2,
                       election_tick=10, heartbeat_tick=3)
    jcfg = _jcfg(cfg)
    st_j, st = _both(cfg)
    inbox = torch.zeros((G, P, P, cfg.fields), dtype=I32)
    in_j = jnp.zeros((G, P, P, cfg.fields), jnp.int32)
    zero = torch.zeros(G, dtype=I32)
    for r in range(6):
        st, inbox = kernel.step_routed_auto(cfg, st, inbox, zero, zero,
                                            True, None, 3)
        st_j, in_j = jk.step_routed_auto(
            jcfg, st_j, in_j, jnp.zeros(G, jnp.int32),
            jnp.zeros(G, jnp.int32), jnp.asarray(True), None, 3)
        _assert_jax(st_j, st, in_j, inbox, r)
    state = np.asarray(st.state)
    assert ((state == LEADER).sum(axis=1) == 1).all()
    slots = (state == LEADER).argmax(axis=1).astype(np.int32)
    commit0 = np.asarray(st.commit).max(axis=1)
    st, inbox = kernel.step_routed_auto(cfg, st, inbox,
                                        torch.full((G,), 2, dtype=I32),
                                        torch.from_numpy(slots), True,
                                        None, 3)
    st_j, in_j = jk.step_routed_auto(
        jcfg, st_j, in_j, jnp.full(G, 2, jnp.int32), jnp.asarray(slots),
        jnp.asarray(True), None, 3)
    _assert_jax(st_j, st, in_j, inbox, "proposal")
    commit1 = np.asarray(st.commit).max(axis=1)
    assert (commit1 >= commit0 + 2).all(), (commit0, commit1)


def test_slots_auto_matches_full_slots_kernel():
    G, P, H = 6, 3, 3
    cfg = KernelConfig(groups=G, peers=P, window=8, max_ents=2,
                       election_tick=10, heartbeat_tick=3)
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(13)

    st_j, st_a = _both(cfg)
    st_f = init_state(cfg, stagger=True, device="cpu")
    in_a = torch.zeros((G, P, P, cfg.fields), dtype=I32)
    in_f = torch.zeros((G, P, P, cfg.fields), dtype=I32)
    in_j = jnp.zeros((G, P, P, cfg.fields), jnp.int32)
    zero_gp = torch.zeros((G, P), dtype=I32)

    for r in range(60):
        state = np.asarray(st_f.state)
        cnt = np.zeros((G, P), np.int32)
        lead = (state == LEADER)
        cnt[lead] = rng.integers(0, cfg.max_ents + 1,
                                 size=int(lead.sum()))
        cnt_t = torch.from_numpy(cnt)

        st_a, in_a = kernel.step_routed_slots_auto(
            cfg, st_a, in_a, cnt_t, True, None, H)
        st_j, in_j = jk.step_routed_slots_auto(
            jcfg, st_j, in_j, jnp.asarray(cnt), jnp.asarray(True), None, H)
        for h in range(H):
            st_f, in_f = kernel.step_routed_slots(
                cfg, st_f, in_f, cnt_t if h == 0 else zero_gp, h == 0)
        _assert_same(st_a, st_f, in_a, in_f, r)
        _assert_jax(st_j, st_a, in_j, in_a, r)

    commit = np.asarray(st_a.commit)
    assert (commit.max(axis=1) > 5).all(), commit
