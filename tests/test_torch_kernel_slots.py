"""The multi-host engine's slots round (etcd_tpu_torch.ops.kernel
.step_routed_slots_auto, on the CPU with the plain ring resolve) against
the JAX package's, round by round.

Both sides start from one numpy state and take the same seeded inputs:
per-slot proposal counts (G, P) with counts at leader slots and also at
non-leader slots (where nothing may be admitted), a tick most rounds,
random message drops where asked, and a window in which the leaders of
some groups are partitioned away. After every round every state field
(values and dtypes) and the routed inbox must be exactly equal:
everything is integer arithmetic, so the tolerance is zero."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from etcd_tpu.ops import kernel as jk
from etcd_tpu.ops import state as js
from etcd_tpu_torch.ops import kernel as tk
from etcd_tpu_torch.ops import state as ts

ROUNDS = 60
PART_LO, PART_HI = 20, 34


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _assert_state_equal(st_j, st_t, where):
    a = _np_state(st_j)
    b = ts.state_to_numpy(st_t)
    for name in js.GroupState._fields:
        assert a[name].dtype == b[name].dtype, (where, name)
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{where}: {name}")


def _cnt_gp(cfg, rng, r, lead):
    """(G, P) counts: up to max_ents+1 at every leader slot, and at one
    random non-leader slot of a third of the groups."""
    G, P = cfg.groups, cfg.peers
    cnt = rng.randint(0, cfg.max_ents + 2, (G, P)) * lead
    stray = rng.randint(0, P, G)
    hit = (rng.rand(G) < 0.34) & ~lead[np.arange(G), stray]
    cnt[np.arange(G)[hit], stray[hit]] = rng.randint(1, cfg.max_ents + 2,
                                                     int(hit.sum()))
    return (cnt * (r >= 4)).astype(np.int32)


def _drive(cfg, hops, drops, seed, rounds=ROUNDS):
    G, P = cfg.groups, cfg.peers
    st_j = js.init_state(cfg, stagger=True)
    st_t = ts.state_from_numpy(_np_state(st_j), "cpu")
    _assert_state_equal(st_j, st_t, "boot")
    inbox_j = jnp.zeros((G, P, P, cfg.fields), jnp.int32)
    inbox_t = torch.zeros((G, P, P, cfg.fields), dtype=torch.int32)
    rng = np.random.RandomState(seed)
    part = {}
    stray_seen = leader_seen = 0
    for r in range(rounds):
        st_np = _np_state(st_j)
        lead = (st_np["state"] == js.LEADER) & st_np["peer_mask"]
        if r == PART_LO:
            part = {g: int(lead[g].argmax()) for g in range(min(8, G))
                    if lead[g].any()}
        cnt = _cnt_gp(cfg, rng, r, lead)
        stray_seen += int((cnt * ~lead).sum())
        leader_seen += int((cnt * lead).sum())
        tick = bool(rng.rand() < 0.85)
        mask = None
        if drops:
            mask = (rng.rand(G, P, P, 1) >= 0.05).astype(np.int32)
            if PART_LO <= r < PART_HI:
                for g, s in part.items():
                    mask[g, s, :, 0] = 0
                    mask[g, :, s, 0] = 0
        st_j, inbox_j = jk.step_routed_slots_auto(
            cfg, st_j, inbox_j, jnp.asarray(cnt), jnp.asarray(tick),
            None if mask is None else jnp.asarray(mask), hops)
        st_t, inbox_t = tk.step_routed_slots_auto(
            cfg, st_t, inbox_t, torch.from_numpy(cnt), tick,
            None if mask is None else torch.from_numpy(mask), hops)
        where = f"round {r} (hops={hops}, drops={drops})"
        _assert_state_equal(st_j, st_t, where)
        assert inbox_t.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(inbox_j), inbox_t.numpy(),
                                      err_msg=f"{where}: inbox")
    # The inputs really exercised both admission cases.
    assert stray_seen > 0 and leader_seen > 0
    return _np_state(st_j)


@pytest.mark.parametrize("drops", [False, True], ids=["clean", "drops"])
@pytest.mark.parametrize("hops", [1, 3])
@pytest.mark.parametrize("peers", [3, 5])
def test_slots_round_matches_jax(peers, hops, drops):
    cfg = js.KernelConfig(groups=64, peers=peers, window=16, max_ents=8)
    st = _drive(cfg, hops, drops, seed=100 * peers + 10 * hops + drops)
    # The trajectory went through elections and commits.
    assert (st["commit"].max(axis=1) > 0).all()


def test_non_leader_counts_admit_nothing():
    """Counts at follower and candidate slots leave their logs as they
    were; at leader slots they append (bounded by max_ents and by half
    the window)."""
    cfg = ts.KernelConfig(groups=16, peers=3, window=16, max_ents=8)
    st = ts.init_state(cfg, stagger=True, device="cpu")
    inbox = torch.zeros((16, 3, 3, cfg.fields), dtype=torch.int32)
    zero = torch.zeros((16, 3), dtype=torch.int32)
    for _ in range(8):
        st, inbox = tk.step_routed_slots_auto(cfg, st, inbox, zero, True)
    lead = (st.state == ts.LEADER) & st.peer_mask
    assert bool(lead.any(dim=1).all())
    before = st.last_index.clone()
    cnt = torch.full((16, 3), 20, dtype=torch.int32)
    st2, _ = tk.step_routed_slots_auto(cfg, st, inbox, cnt, False)
    grown = st2.last_index - before
    assert bool((grown[~lead] == 0).all())
    assert bool((grown[lead] == cfg.max_ents).all())


def test_full_path_slots_matches_jax():
    """The always-full `step_routed_slots` (no fast path, no hops)."""
    cfg = js.KernelConfig(groups=24, peers=3, window=16, max_ents=8)
    G, P = cfg.groups, cfg.peers
    st_j = js.init_state(cfg, stagger=True)
    st_t = ts.state_from_numpy(_np_state(st_j), "cpu")
    inbox_j = jnp.zeros((G, P, P, cfg.fields), jnp.int32)
    inbox_t = torch.zeros((G, P, P, cfg.fields), dtype=torch.int32)
    rng = np.random.RandomState(7)
    for r in range(20):
        st_np = _np_state(st_j)
        lead = (st_np["state"] == js.LEADER) & st_np["peer_mask"]
        cnt = _cnt_gp(cfg, rng, r, lead)
        st_j, inbox_j = jk.step_routed_slots(cfg, st_j, inbox_j,
                                             jnp.asarray(cnt),
                                             jnp.asarray(True))
        st_t, inbox_t = tk.step_routed_slots(cfg, st_t, inbox_t,
                                             torch.from_numpy(cnt), True)
        _assert_state_equal(st_j, st_t, f"round {r}")
        np.testing.assert_array_equal(np.asarray(inbox_j), inbox_t.numpy())
