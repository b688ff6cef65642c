"""The generator repeats exactly for a seed, differs across seeds, and
gives every seed the same amount of work."""
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import traffic

H = Path(__file__).resolve().parents[1]
CFG = json.loads((H / "configs" / "mt100k-r5.json").read_text())
SEEDS = (0, 1, 2 ** 31 + 17, 3_000_000_123)


def mix(name):
    return json.loads((H / "traffic" / f"{name}.json").read_text())


def same(a, b):
    return (np.array_equal(a.t_due, b.t_due)
            and np.array_equal(a.tenant, b.tenant)
            and np.array_equal(a.key, b.key)
            and [a.value(j) for j in range(0, len(a.t_due), 997)]
            == [b.value(j) for j in range(0, len(b.t_due), 997)])


@pytest.mark.parametrize("name", ["steady", "lag5"])
@pytest.mark.parametrize("seed", SEEDS)
def test_repeats_for_a_seed(name, seed):
    assert same(traffic.plan(CFG, mix(name), seed, 2.0),
                traffic.plan(CFG, mix(name), seed, 2.0))


@pytest.mark.parametrize("name", ["steady", "lag5"])
def test_differs_across_seeds_with_equal_work(name):
    plans = [traffic.plan(CFG, mix(name), s, 2.0) for s in SEEDS]
    for i, a in enumerate(plans):
        assert len(a.t_due) == len(plans[0].t_due)
        assert a.warmup == plans[0].warmup
        for b in plans[i + 1:]:
            assert not same(a, b)


def test_shape_of_a_plan():
    m = mix("steady")
    p = traffic.plan(CFG, m, 5, 4.0)
    n_w = int(m["rate_per_s"] * m["warmup_s"])
    assert p.warmup == n_w and len(p.t_due) == n_w + 4 * m["rate_per_s"]
    assert np.all(np.diff(p.t_due[n_w:]) >= 0)
    assert p.t_due[n_w:].max() < 4.0 and p.tenant.max() < CFG["groups"]
    assert p.key.max() < CFG["keys_per_tenant"]
    vals = {p.value(j) for j in range(0, len(p.t_due), 101)}
    assert len(vals) == len(range(0, len(p.t_due), 101))
    assert all(len(v) == CFG["value_bytes"] for v in vals)


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_mask_cuts_one_follower_of_five_percent(seed):
    G, P = 2000, 5
    cfg = dict(CFG, groups=G)
    lead = np.random.default_rng(seed).integers(0, P, G)
    mask, groups = traffic.fault_mask(cfg, mix("lag5"), seed, lead)
    again, groups2 = traffic.fault_mask(cfg, mix("lag5"), seed, lead)
    assert np.array_equal(mask, again) and np.array_equal(groups, groups2)
    assert len(groups) == G // 20 and mask.shape == (G, P, P, 1)
    cut = (mask[..., 0] == 0)
    assert cut.any(axis=(1, 2)).sum() == len(groups)
    for g in groups[:20]:
        rows = np.nonzero(cut[g].all(axis=1))[0]
        assert len(rows) == 1 and rows[0] != lead[g]
    assert traffic.fault_mask(cfg, mix("steady"), seed, lead)[0] is None
