"""The one general traffic generator: a traffic mix's parameters (a JSON
file under `traffic/`) and a configuration's sizes, turned into the
writes of one run from its seed.

Every seed gives the same amount of work: a fixed count of arrivals,
rate times seconds, placed as the order statistics of uniform times over
the window (a Poisson process conditioned on its count), with tenants,
keys and values drawn from the seed. Warm-up traffic has the same shape
and rate and comes first.

Parameters of a mix:
- `rate_per_s`: open-loop arrival rate, writes per second;
- `warmup_s`: seconds of the same traffic before the window;
- `tenants`: "uniform", or "zipf" (Zipf(1.1) popularity, shuffled);
- `faults`: `{"cut_follower_share": f}` cuts one follower, or
  `{"cut_leader_share": f}` the leader, of a seeded share f of the
  tenants off for the whole run (set before warm-up).

The fault masks and the Zipf weights are copies of the program's bench
generators (`lag_mask`, `churn_mask`, `zipf_rates`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_ALPHABET = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)
_POOL_BYTES = 1 << 16


@dataclass
class Plan:
    """Writes of one run, warm-up first: due time (seconds from the start
    of its phase), tenant, key number; values come from `value(j)`."""
    t_due: np.ndarray          # float64 (N,)
    tenant: np.ndarray         # int64 (N,)
    key: np.ndarray            # int64 (N,)
    warmup: int                # the first `warmup` writes are warm-up
    value_bytes: int
    pool: bytes
    offsets: np.ndarray        # int64 (N,)

    def value(self, j: int) -> str:
        # The write's number makes every value distinct.
        head = f"{j:08x}"
        o = int(self.offsets[j])
        return head + self.pool[o:o + self.value_bytes - len(head)].decode()

    @staticmethod
    def path(key: int) -> str:
        return f"/1/k{key:02d}"


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def zipf_rates(rng, G, max_ents):
    """Per-group client-write arrival rates, Zipf(1.1)-skewed, scaled so
    the AGGREGATE offered load equals the uniform scenario's
    (G * max_ents writes/round): same total load, skewed placement."""
    w = 1.0 / np.arange(1, G + 1, dtype=np.float64) ** 1.1
    rng.shuffle(w)
    return w * (G * max_ents) / w.sum()


def lag_mask(rng, G, P, slots_np, share=0.05):
    """Fully partition one non-leader slot in a share of groups (5%:
    BASELINE config 4). Returns the (G, P, P, 1) int32 keep-mask and the
    lagged groups."""
    lag_groups = rng.choice(G, size=max(1, int(G * share)), replace=False)
    mask_to = np.ones((G, P, 1, 1), np.int32)
    mask_from = np.ones((G, 1, P, 1), np.int32)
    lag_slot = (slots_np[lag_groups] + 1) % P
    mask_to[lag_groups, lag_slot] = 0
    mask_from[lag_groups, 0, lag_slot] = 0
    return mask_to * mask_from, lag_groups


def churn_mask(rng, G, P, slots_np, share=0.1):
    """Partition the LEADER of a share of groups (10%: BASELINE config 5):
    those groups must re-elect among the remaining peers while the rest
    keep committing. Returns the keep-mask and the churned groups."""
    churned = rng.choice(G, size=max(1, int(G * share)), replace=False)
    mask_to = np.ones((G, P, 1, 1), np.int32)
    mask_from = np.ones((G, 1, P, 1), np.int32)
    mask_to[churned, slots_np[churned]] = 0
    mask_from[churned, 0, slots_np[churned]] = 0
    return mask_to * mask_from, churned


def _tenants(rng, mix: dict, G: int, n: int) -> np.ndarray:
    kind = mix.get("tenants", "uniform")
    if kind == "uniform":
        return rng.integers(0, G, n)
    if kind == "zipf":
        w = zipf_rates(rng, G, 1)
        return rng.choice(G, size=n, p=w / w.sum())
    raise ValueError(f"unknown tenant distribution {kind!r}")


def plan(config: dict, mix: dict, seed: int, seconds: float) -> Plan:
    """The writes of one run: warm-up, then `seconds` of the window."""
    G = int(config["groups"])
    rate = float(mix["rate_per_s"])
    n_w = int(round(rate * float(mix.get("warmup_s", 0))))
    n = int(round(rate * seconds))
    r = _rng(seed, 1)
    t = np.concatenate([np.sort(r.uniform(0, n_w / rate, n_w)),
                        np.sort(r.uniform(0, seconds, n))])
    tenant = _tenants(_rng(seed, 2), mix, G, n_w + n)
    key = _rng(seed, 3).integers(0, int(config["keys_per_tenant"]), n_w + n)
    vb = int(config["value_bytes"])
    r = _rng(seed, 4)
    pool = _ALPHABET[r.integers(0, len(_ALPHABET), _POOL_BYTES)].tobytes()
    offsets = r.integers(0, _POOL_BYTES - vb, n_w + n)
    return Plan(t, tenant.astype(np.int64), key.astype(np.int64), n_w, vb,
                pool, offsets)


def fault_mask(config: dict, mix: dict, seed: int, leader_slots: np.ndarray):
    """The (G, P, P, 1) keep-mask of the mix's faults and the groups it
    touches, or (None, empty) for a mix without faults."""
    faults = mix.get("faults", {})
    G, P = int(config["groups"]), int(config["peers"])
    if faults.get("cut_follower_share"):
        return lag_mask(_rng(seed, 5), G, P, leader_slots,
                        float(faults["cut_follower_share"]))
    if faults.get("cut_leader_share"):
        return churn_mask(_rng(seed, 5), G, P, leader_slots,
                          float(faults["cut_leader_share"]))
    return None, np.empty(0, np.int64)
