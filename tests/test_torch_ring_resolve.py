"""The windowed ring resolve of the port (etcd_tpu_torch.ops.ring_resolve)
against the JAX package's Pallas kernel (interpret mode on the CPU) and a
straightforward numpy model. Exact: everything is int32.

On the CPU the wrapper takes the plain version; the CUDA kernel itself is
held against the plain version on the card by chip_smoke.py."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from etcd_tpu.ops import kernel as jk
from etcd_tpu.ops import state as js
from etcd_tpu.ops.pallas_kernels import ring_resolve as pallas_resolve
from etcd_tpu_torch.ops import kernel as tk
from etcd_tpu_torch.ops import state as ts
from etcd_tpu_torch.ops.ring_resolve import ring_resolve, ring_resolve_ref


def _model(ring, idx, last, W):
    """Numpy model of the windowed resolve, element by element."""
    G, P = ring.shape[:2]
    out = np.zeros(idx.shape, np.int32)
    flat = idx.reshape(G, P, -1)
    res = out.reshape(G, P, -1)
    for g in range(G):
        for p in range(P):
            for j, i in enumerate(flat[g, p]):
                i = int(i)
                if i >= 1 and last[g, p] - W < i <= last[g, p]:
                    res[g, p, j] = ring[g, p, i % W]
    return out


def _inputs(G, P, W, trailing, seed):
    rng = np.random.RandomState(seed)
    ring = rng.randint(1, 9, (G, P, W)).astype(np.int32)
    last = rng.randint(0, 3 * W, (G, P)).astype(np.int32)
    idx = rng.randint(-2 * W, 3 * W + 2, (G, P) + trailing).astype(np.int32)
    # Plant every case in the first rows: negative, zero, below the
    # window, its top, above last; the rest is random.
    last.flat[2] = W + 5
    flat = idx.reshape(G * P, -1)
    for row, off in enumerate((-W - 3, None, -W, 0, 1)):
        flat[row, 0] = 0 if off is None else last.flat[row] + off
    flat[0, 0] = -3
    lst = last.reshape(G, P, *([1] * len(trailing)))
    assert (idx < 0).any() and (idx == 0).any()
    assert ((idx >= 1) & (idx <= lst - W)).any()
    assert ((idx > lst - W) & (idx <= lst) & (idx >= 1)).any()
    assert (idx > lst).any()
    return ring, idx, last


@pytest.mark.parametrize("trailing", [(4,), (5,), (5, 4), ()],
                         ids=["E", "P", "PxE", "empty"])
def test_ref_matches_pallas_and_model(trailing):
    G, P, W = 6, 5, 16
    ring, idx, last = _inputs(G, P, W, trailing, seed=len(trailing) + 1)
    want = _model(ring, idx, last, W)
    pallas = np.asarray(pallas_resolve(jnp.asarray(ring), jnp.asarray(idx),
                                       jnp.asarray(last), block_rows=8,
                                       interpret=True))
    np.testing.assert_array_equal(pallas, want)
    got = ring_resolve_ref(torch.from_numpy(ring), torch.from_numpy(idx),
                           torch.from_numpy(last))
    assert got.dtype == torch.int32 and tuple(got.shape) == idx.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("W", [8, 16])
def test_wrapper_on_cpu_takes_the_plain_version(W):
    ring, idx, last = _inputs(4, 3, W, (3,), seed=W)
    before = ring_resolve.launches
    got = ring_resolve(torch.from_numpy(ring), torch.from_numpy(idx),
                       torch.from_numpy(last))
    np.testing.assert_array_equal(got.numpy(), _model(ring, idx, last, W))
    assert ring_resolve.launches == before      # no kernel launched


def test_matches_the_jax_rounds_terms_at_many():
    """Against the JAX round's own resolve (`_terms_at_many`) on a state."""
    cfg = js.KernelConfig(groups=5, peers=3, window=8, max_ents=2)
    ring, idx, last = _inputs(5, 3, 8, (3,), seed=9)
    d = {k: np.asarray(v) for k, v in js.init_state(cfg)._asdict().items()}
    d["log_term"], d["last_index"] = ring, last
    st_j = js.GroupState(**{k: jnp.asarray(v) for k, v in d.items()})
    st_t = ts.state_from_numpy(d, "cpu")
    want = np.asarray(jk._terms_at_many(st_j, cfg, jnp.asarray(idx)))
    got = tk._terms_at_many(st_t, cfg, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_its_inputs():
    ring, idx, last = (torch.from_numpy(a)
                       for a in _inputs(4, 3, 8, (2,), seed=0))
    with pytest.raises(TypeError):
        ring_resolve(ring.long(), idx, last)
    with pytest.raises(TypeError):
        ring_resolve(ring, idx, last.long())
    with pytest.raises(ValueError):
        ring_resolve(ring, idx[:3], last)
    with pytest.raises(ValueError):
        ring_resolve(ring, idx, last[:, :2])
    with pytest.raises(ValueError):
        ring_resolve(ring, idx.transpose(0, 1).contiguous()
                     .transpose(0, 1), last)
