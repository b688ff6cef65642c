"""The port's sharded round against the JAX package's unsharded round.

The same seeded schedule (proposals, a tick, 25% message drops cut after
every hop) goes through the JAX package's single-device round and through
the port's in-process mesh (etcd_tpu_torch.parallel.mesh.mesh_round: one
thread per cell, each cell stepping its own block of groups and peer
columns, routing by all-to-all between the cells of a groups row). After
every round every state field, the routed inbox and (for the read round)
`confirmed` and `read_commit` must be exactly equal: the round is integer
arithmetic, so the tolerance is zero.

Layouts on ["cpu"] * 8, as tests/test_sharded_equivalence.py: groups8
(8 x 1, groups axis only), g4xp2 (4 x 2, both axes), 1xP (1 x P, peers
axis only, on P of the devices)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from etcd_tpu.ops import kernel as jk
from etcd_tpu.ops import state as js
from etcd_tpu.parallel import mesh as jmesh
from etcd_tpu_torch.ops import kernel as tk
from etcd_tpu_torch.ops import state as ts
from etcd_tpu_torch.parallel import mesh as tmesh

G, P, W, E = 8, 4, 16, 3
ROUNDS = 60
LAYOUTS = {"groups8": (8, 1), "g4xp2": (8, 2), "1xP": (P, P)}
ROUNDS_UNDER_TEST = [("auto", 1), ("auto", 3), ("read", 3), ("slots", 1)]


def _mesh(layout):
    n, peers_axis = LAYOUTS[layout]
    return tmesh.make_mesh(["cpu"] * n, peers_axis=peers_axis)


def _assert_equal(st_j, st_t, where):
    a = {k: np.asarray(v) for k, v in st_j._asdict().items()}
    b = ts.state_to_numpy(tmesh.unshard_state(st_t))
    for name in js.GroupState._fields:
        assert a[name].dtype == b[name].dtype, (where, name)
        np.testing.assert_array_equal(a[name], b[name],
                                      err_msg=f"{where}: {name}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("variant,hops", ROUNDS_UNDER_TEST,
                         ids=[f"{v}-hops{h}" for v, h in ROUNDS_UNDER_TEST])
def test_mesh_round_is_bit_identical_to_jax(variant, hops, layout):
    cfg = js.KernelConfig(groups=G, peers=P, window=W, max_ents=E)
    tcfg = ts.KernelConfig(groups=G, peers=P, window=W, max_ents=E)
    mesh = _mesh(layout)
    st_j = js.init_state(cfg, stagger=True)
    st_t = tmesh.shard_state(ts.state_from_numpy(
        {k: np.asarray(v) for k, v in st_j._asdict().items()}, "cpu"), mesh)
    inbox_j = jnp.zeros((G, P, P, cfg.fields), jnp.int32)
    inbox_t = tmesh.shard_mailbox(
        torch.zeros((G, P, P, cfg.fields), dtype=torch.int32), mesh)
    fn = {"auto": tk.step_routed_auto, "read": tk.step_routed_read_auto,
          "slots": tk.step_routed_slots_auto}[variant]
    rng = np.random.RandomState(9)
    confirmed_seen = 0
    for i in range(ROUNDS):
        drop = (1 - (rng.rand(G, P, P) < 0.25)[..., None]).astype(np.int32)
        tick = jnp.asarray(True)
        if variant == "slots":
            cnt = rng.randint(0, E + 1, (G, P)).astype(np.int32)
            st_j, inbox_j = jk.step_routed_slots_auto(
                cfg, st_j, inbox_j, jnp.asarray(cnt), tick,
                jnp.asarray(drop), hops)
            st_t, inbox_t = tmesh.mesh_round(
                fn, tcfg, st_t, inbox_t, torch.from_numpy(cnt), None, True,
                torch.from_numpy(drop), hops)
        else:
            pc = rng.randint(0, E + 1, G).astype(np.int32)
            ps = rng.randint(0, P, G).astype(np.int32)
            args_j = (cfg, st_j, inbox_j, jnp.asarray(pc), jnp.asarray(ps),
                      tick, jnp.asarray(drop), hops)
            args_t = (fn, tcfg, st_t, inbox_t, torch.from_numpy(pc),
                      torch.from_numpy(ps), True, torch.from_numpy(drop),
                      hops)
            if variant == "auto":
                st_j, inbox_j = jk.step_routed_auto(*args_j)
                st_t, inbox_t = tmesh.mesh_round(*args_t)
            else:
                st_j, inbox_j, conf_j, rc_j = jk.step_routed_read_auto(
                    *args_j)
                st_t, inbox_t, conf_t, rc_t = tmesh.mesh_round(*args_t)
                np.testing.assert_array_equal(
                    np.asarray(conf_j), conf_t.numpy(),
                    err_msg=f"round {i}: confirmed")
                np.testing.assert_array_equal(
                    np.asarray(rc_j), rc_t.numpy(),
                    err_msg=f"round {i}: read_commit")
                confirmed_seen += int(np.asarray(conf_j).sum())
        _assert_equal(st_j, st_t, f"round {i}")
        np.testing.assert_array_equal(np.asarray(inbox_j),
                                      tmesh.unshard_mailbox(inbox_t).numpy(),
                                      err_msg=f"round {i}: routed inbox")
    assert np.asarray(st_j.commit).max() > 0
    if variant == "read":
        assert confirmed_seen > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_shard_unshard_round_trip(layout):
    mesh = _mesh(layout)
    rng = np.random.RandomState(3)
    cfg = js.KernelConfig(groups=G, peers=P, window=W, max_ents=E)
    ref = {k: np.asarray(v) for k, v in
           js.init_state(cfg, stagger=True)._asdict().items()}
    for k, a in ref.items():       # every field random, in its dtype
        hi = 2 if a.dtype == bool else 1 << 30
        ref[k] = rng.randint(0, hi, a.shape).astype(a.dtype)
    st = tmesh.shard_state(ts.state_from_numpy(ref, "cpu"), mesh)
    ng, npr = mesh.shape
    for name in js.GroupState._fields:
        x = getattr(st, name)
        assert tuple(x.shape) == ref[name].shape, name
        blk = x.blocks[ng - 1][npr - 1]
        assert blk.shape[:2] == (G // ng, P // npr), name
        assert blk.shape[2:] == ref[name].shape[2:], name
        assert blk.is_contiguous(), name
    back = ts.state_to_numpy(tmesh.unshard_state(st))
    for name in js.GroupState._fields:
        np.testing.assert_array_equal(back[name], ref[name], err_msg=name)
    mb = rng.randint(0, 1 << 30, (G, P, P, 12)).astype(np.int32)
    sh = tmesh.shard_mailbox(torch.from_numpy(mb), mesh)
    assert sh.blocks[0][0].shape == (G // ng, P // npr, P, 12)
    np.testing.assert_array_equal(tmesh.unshard_mailbox(sh).numpy(), mb)


def test_divisibility_errors_match_jax():
    import jax
    with pytest.raises(ValueError) as ej:
        jmesh.make_mesh(jax.devices()[:8], peers_axis=3)
    with pytest.raises(ValueError) as et:
        tmesh.make_mesh(["cpu"] * 8, peers_axis=3)
    assert str(et.value) == str(ej.value)
    # A field whose axis does not divide over the mesh is refused too.
    mesh = tmesh.make_mesh(["cpu"] * 6, peers_axis=2)      # 3 x 2
    cfg = ts.KernelConfig(groups=8, peers=4)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_state(ts.init_state(cfg, device="cpu"), mesh)
