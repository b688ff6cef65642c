"""tests/test_engine_compact.py's cases on the port's MultiEngine, on the
CPU (`on_the_port(..., cpu=True)`): compact readback (`gather_rows` of
the rows the round flagged) must write the same WAL records, hold the
same mirrors and stores and ack the same requests as full readback,
through elections, a leader-partition window and the cap-1 fallback;
and a restart must replay to the same mirrors and stores.

The schedule `_drive` sets the engine's drop mask from a jnp array; it
is mirrored here with a torch tensor, the same seed, rounds, traffic and
partition. The two tests run as they are."""
import random

import numpy as np
import torch

from port_tests import on_the_port

_cmp = on_the_port("test_engine_compact", cpu=True)
G, P, W, E = _cmp.G, _cmp.P, _cmp.W, _cmp.E
ROUNDS, CHURN_AT, HEAL_AT = _cmp.ROUNDS, _cmp.CHURN_AT, _cmp.HEAL_AT
EngineConfig, MultiEngine, Request = (_cmp.EngineConfig, _cmp.MultiEngine,
                                      _cmp.Request)


def _drive(data_dir: str, compact: bool, cap: int = 0):
    """tests/test_engine_compact.py::_drive with the drop mask a torch
    tensor: seeded enqueues, the leaders of the first 6 groups cut from
    CHURN_AT to HEAL_AT, no wall-clock dependence."""
    eng = MultiEngine(EngineConfig(
        groups=G, peers=P, data_dir=data_dir, window=W, max_ents=E,
        fsync=False, stagger=True, sync_interval=0.0,
        compact_readback=compact, compact_cap=cap,
        checkpoint_rounds=1 << 30, pipeline_applies=False))

    class _Seq:  # idutil embeds wall time; payload bytes must be equal
        def __init__(self):
            self.i = 0

        def next(self):
            self.i += 1
            return self.i

    eng.reqid = _Seq()
    rng = random.Random(7)
    for r in range(ROUNDS):
        for _ in range(rng.randrange(0, 10)):
            g = rng.randrange(G)
            rid = eng.reqid.next()
            rq = Request(method="PUT", path=f"/k{rng.randrange(4)}",
                         val=f"v{r}", id=rid)
            with eng._lock:
                eng._pending[g].append(
                    (rid, bytes([0]) + rq.encode(), rq))
                eng._dirty.add(g)
        if r == CHURN_AT:
            mask = np.ones((G, P, P, 1), np.int32)
            lead = (np.where(eng.h_mask, eng.h_state, 0) == 2)
            for g in range(6):
                if lead[g].any():
                    s = int(lead[g].argmax())
                    mask[g, s, :, 0] = 0
                    mask[g, :, s, 0] = 0
            eng.drop_mask = torch.from_numpy(mask)
        elif r == HEAL_AT:
            eng.drop_mask = None
        eng.run_round()
    return eng


_cmp._drive = _drive

test_compact_equals_full = _cmp.test_compact_equals_full
test_compact_restart_replays_identically = \
    _cmp.test_compact_restart_replays_identically
