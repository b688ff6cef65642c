"""The port's consensus state (etcd_tpu_torch.ops.state) against the JAX
package's (etcd_tpu.ops.state): boot state, the xorshift32 lanes and the
numpy converters, exactly and with the JAX package's dtypes."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from etcd_tpu.ops import state as js
from etcd_tpu_torch.ops import state as ts


def _np_state(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.mark.parametrize("stagger", [False, True])
@pytest.mark.parametrize("G,P,n_peers", [
    (1, 1, None),
    (7, 3, None),
    (12, 5, 3),
    (9, 5, "mixed"),       # per-group sizes, unprovisioned groups included
    (16, 7, None),
])
def test_init_state_matches_jax(G, P, n_peers, stagger):
    if n_peers == "mixed":
        n_peers = np.array([5, 0, 3, 1, 0, 5, 4, 2, 3], np.int32)
    cfg = js.KernelConfig(groups=G, peers=P, window=8, max_ents=2)
    want = _np_state(js.init_state(cfg, n_peers=n_peers, stagger=stagger))
    got = ts.state_to_numpy(ts.init_state(cfg, n_peers=n_peers,
                                          stagger=stagger, device="cpu"))
    assert set(want) == set(got)
    for name in js.GroupState._fields:
        assert want[name].dtype == got[name].dtype, name
        np.testing.assert_array_equal(want[name], got[name], err_msg=name)


def test_xorshift32_matches_jax_for_10k_steps():
    """10^4 steps on the seeded lanes, every step and its election draw
    (the unsigned lane modulo election_tick) equal."""
    steps, tick = 10_000, 10
    seeds = js._seed(16, 5)

    def body(x, _):
        x = js.xorshift32(x)
        return x, (x, (x % jnp.uint32(tick)).astype(jnp.int32))

    _, (want, want_draw) = jax.lax.scan(body, jnp.asarray(seeds), None,
                                        length=steps)
    want, want_draw = np.asarray(want), np.asarray(want_draw)
    x = torch.from_numpy(seeds.astype(np.int64))
    for i in range(steps):
        x = ts.xorshift32(x)
        if i % 997 == 0 or i == steps - 1:
            np.testing.assert_array_equal(x.numpy().astype(np.uint32),
                                          want[i], err_msg=f"step {i}")
            np.testing.assert_array_equal(
                torch.remainder(x, tick).numpy().astype(np.int32),
                want_draw[i], err_msg=f"draw {i}")
    # The lanes stay inside 32 bits and reach the upper half.
    assert int(x.max()) <= 0xFFFFFFFF and (want[-1] >= 2 ** 31).any()


def test_numpy_round_trip_keeps_values_and_dtypes():
    cfg = js.KernelConfig(groups=6, peers=5, window=16, max_ents=4)
    rng = np.random.RandomState(3)
    d = _np_state(js.init_state(cfg, stagger=True))
    d["prng"] = rng.randint(0, 2 ** 32, d["prng"].shape,
                            dtype=np.uint64).astype(np.uint32)
    d["log_term"] = rng.randint(0, 9, d["log_term"].shape).astype(np.int32)
    d["paused"] = rng.rand(*d["paused"].shape) < 0.5
    st = ts.state_from_numpy(d, "cpu")
    assert st.prng.dtype == torch.int64 and st.term.dtype == torch.int32
    assert st.paused.dtype == torch.bool
    back = ts.state_to_numpy(st)
    for name in js.GroupState._fields:
        assert back[name].dtype == d[name].dtype, name
        np.testing.assert_array_equal(back[name], d[name], err_msg=name)
    # The converted state is a copy: writing it leaves the source alone.
    st.term.fill_(7)
    assert (d["term"] == 0).all()


def _random_state(cfg, seed):
    rng = np.random.RandomState(seed)
    d = _np_state(js.init_state(cfg, stagger=True))
    d["log_term"] = rng.randint(1, 9, d["log_term"].shape).astype(np.int32)
    d["last_index"] = rng.randint(0, 3 * cfg.window,
                                  d["last_index"].shape).astype(np.int32)
    d["peer_mask"] = rng.rand(*d["peer_mask"].shape) < 0.7
    return d, rng


@pytest.mark.parametrize("seed", [0, 1])
def test_helpers_match_jax(seed):
    """quorum, term_at, in_window and ring_lookup on a random state."""
    cfg = js.KernelConfig(groups=10, peers=5, window=8, max_ents=2)
    d, rng = _random_state(cfg, seed)
    st_j = js.GroupState(**{k: jnp.asarray(v) for k, v in d.items()})
    st_t = ts.state_from_numpy(d, "cpu")
    np.testing.assert_array_equal(np.asarray(js.quorum(st_j)),
                                  ts.quorum(st_t).numpy())
    assert ts.quorum(st_t).dtype == torch.int32
    idx = rng.randint(-3, 3 * cfg.window + 3, (10, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(js.term_at(st_j, cfg, jnp.asarray(idx))),
        ts.term_at(st_t, cfg, torch.from_numpy(idx)).numpy())
    idx3 = rng.randint(-3, 3 * cfg.window + 3, (10, 5, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(js.in_window(st_j, cfg, jnp.asarray(idx3))),
        ts.in_window(st_t, cfg, torch.from_numpy(idx3)).numpy())
    slot = rng.randint(0, cfg.window, (10, 5, 5, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(js.ring_lookup(st_j.log_term[:, :, None, :],
                                  jnp.asarray(slot))),
        ts.ring_lookup(st_t.log_term[:, :, None, :],
                       torch.from_numpy(slot)).numpy())
