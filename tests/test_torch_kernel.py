"""The PyTorch round (etcd_tpu_torch.ops.kernel, on the CPU with the plain
ring resolve) against the JAX package's round, round by round.

Both sides start from one numpy state and take the same seeded inputs:
proposals at the current leaders, a tick most rounds, random message
drops and a window in which the leaders of some groups are partitioned
away (elections, demotions, ring overwrites). After every round every
state field (values and dtypes), the routed inbox, the compact flags and
need-host bit, and the read plane's confirmed/read_commit must be
exactly equal: everything is integer arithmetic."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from etcd_tpu.ops import kernel as jk
from etcd_tpu.ops import state as js
from etcd_tpu_torch.ops import kernel as tk
from etcd_tpu_torch.ops import state as ts

ROUNDS = 40
PART_LO, PART_HI = 14, 26


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def _assert_state_equal(st_j, st_t, where):
    a = _np_state(st_j)
    b = ts.state_to_numpy(st_t)
    for name in js.GroupState._fields:
        assert a[name].dtype == b[name].dtype, (where, name)
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{where}: {name}")


def _inputs(cfg, rng, r, st_np, part):
    G, P = cfg.groups, cfg.peers
    lead = st_np["state"] == js.LEADER
    prop_slot = lead.argmax(axis=1).astype(np.int32)
    prop_count = (rng.randint(0, cfg.max_ents + 2, G) * (r >= 4)
                  ).astype(np.int32)
    tick = bool(rng.rand() < 0.85)
    mask = (rng.rand(G, P, P, 1) >= 0.05).astype(np.int32)
    if PART_LO <= r < PART_HI:
        for g, s in part.items():
            mask[g, s, :, 0] = 0
            mask[g, :, s, 0] = 0
    return prop_count, prop_slot, tick, mask


def _drive(cfg, hops, variants, seed):
    """Run ROUNDS rounds through both packages, cycling through
    `variants` (names of the routed round functions) round by round."""
    G, P = cfg.groups, cfg.peers
    st_j = js.init_state(cfg, stagger=True)
    st_t = ts.state_from_numpy(_np_state(st_j), "cpu")
    _assert_state_equal(st_j, st_t, "boot")
    inbox_j = jnp.zeros((G, P, P, cfg.fields), jnp.int32)
    inbox_t = torch.zeros((G, P, P, cfg.fields), dtype=torch.int32)
    rng = np.random.RandomState(seed)
    part = {}
    for r in range(ROUNDS):
        st_np = _np_state(st_j)
        if r == PART_LO:
            lead = st_np["state"] == js.LEADER
            part = {g: int(lead[g].argmax()) for g in range(min(6, G))
                    if lead[g].any()}
        pc, ps, tick, mask = _inputs(cfg, rng, r, st_np, part)
        name = variants[r % len(variants)]
        args_j = (cfg, st_j, inbox_j, jnp.asarray(pc), jnp.asarray(ps),
                  jnp.asarray(tick), jnp.asarray(mask), hops)
        args_t = (cfg, st_t, inbox_t, torch.from_numpy(pc),
                  torch.from_numpy(ps), tick, torch.from_numpy(mask), hops)
        out_j = getattr(jk, name)(*args_j)
        out_t = getattr(tk, name)(*args_t)
        st_j, inbox_j, st_t, inbox_t = out_j[0], out_j[1], out_t[0], out_t[1]
        where = f"round {r} ({name}, hops={hops})"
        _assert_state_equal(st_j, st_t, where)
        np.testing.assert_array_equal(np.asarray(inbox_j), inbox_t.numpy(),
                                      err_msg=f"{where}: inbox")
        assert inbox_t.dtype == torch.int32
        for x_j, x_t, what in zip(out_j[2:], out_t[2:], ("flags/confirmed",
                                                        "any_nh/read_commit")):
            x_j, x_t = np.asarray(x_j), x_t.numpy()
            assert x_j.dtype == x_t.dtype, (where, what)
            np.testing.assert_array_equal(x_j, x_t, err_msg=f"{where}: {what}")
    return _np_state(st_j)


@pytest.mark.parametrize("hops", [1, 3])
@pytest.mark.parametrize("variant", ["step_routed_auto", "step_routed_compact",
                                     "step_routed_read_auto"])
def test_round_matches_jax(variant, hops):
    cfg = js.KernelConfig(groups=24, peers=3, window=8, max_ents=2)
    st = _drive(cfg, hops, [variant], seed=hops)
    # The trajectory really went through elections and commits.
    assert (st["commit"].max(axis=1) > 0).all()


def test_mixed_variants_engine_shape():
    """The engine's shape family (P=5, W=16, E=4) at hops=3, alternating
    the compact and read rounds as the engine does."""
    cfg = js.KernelConfig(groups=8, peers=5, window=16, max_ents=4,
                          heartbeat_tick=3)
    st = _drive(cfg, 3, ["step_routed_compact", "step_routed_compact",
                         "step_routed_read_auto"], seed=11)
    assert (st["commit"].max(axis=1) > 0).all()


def test_step_routed_full_path_matches_jax():
    """The always-full `step_routed` (no fast path, no hops)."""
    cfg = js.KernelConfig(groups=24, peers=3, window=8, max_ents=2)
    G, P = cfg.groups, cfg.peers
    st_j = js.init_state(cfg, stagger=True)
    st_t = ts.state_from_numpy(_np_state(st_j), "cpu")
    inbox_j = jnp.zeros((G, P, P, cfg.fields), jnp.int32)
    inbox_t = torch.zeros((G, P, P, cfg.fields), dtype=torch.int32)
    rng = np.random.RandomState(5)
    for r in range(20):
        pc, ps, tick, _ = _inputs(cfg, rng, r, _np_state(st_j), {})
        st_j, inbox_j = jk.step_routed(cfg, st_j, inbox_j, jnp.asarray(pc),
                                       jnp.asarray(ps), jnp.asarray(tick))
        st_t, inbox_t = tk.step_routed(cfg, st_t, inbox_t,
                                       torch.from_numpy(pc),
                                       torch.from_numpy(ps), tick)
        _assert_state_equal(st_j, st_t, f"round {r}")
        np.testing.assert_array_equal(np.asarray(inbox_j), inbox_t.numpy())


def test_round_does_not_write_its_inputs():
    """The engine diffs against the pre-round state it still holds."""
    cfg = ts.KernelConfig(groups=6, peers=3, window=8, max_ents=2)
    st = ts.init_state(cfg, stagger=True, device="cpu")
    inbox = torch.zeros((6, 3, 3, cfg.fields), dtype=torch.int32)
    pc = torch.full((6,), 2, dtype=torch.int32)
    ps = torch.zeros(6, dtype=torch.int32)
    for _ in range(6):
        before = ts.state_to_numpy(st)
        inbox0 = inbox.clone()
        st2, inbox2, _, _ = tk.step_routed_compact(cfg, st, inbox, pc, ps,
                                                   True, None, 3)
        for k, v in ts.state_to_numpy(st).items():
            np.testing.assert_array_equal(v, before[k], err_msg=k)
        assert torch.equal(inbox, inbox0)
        st, inbox = st2, inbox2


def test_step_variant_is_a_lookup():
    """The JAX package's step_variant names, and only those."""
    assert tk.step_variant("step_routed_compact") is tk.step_routed_compact
    assert tk.step_variant("step_routed_slots_auto") \
        is tk.step_routed_slots_auto
    with pytest.raises(KeyError):
        tk.step_variant("step_routed_slots")
