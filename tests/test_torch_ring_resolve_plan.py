"""The launch geometry of the port's ring_resolve kernel
(etcd_tpu_torch.ops.ring_resolve.launch_plan), checked on the CPU: the
kernel itself runs only on the card, where chip_smoke.py holds every
instantiation against the plain version."""
import os
import re

import pytest

import torch

from etcd_tpu_torch.ops import ring_resolve as rr

SMS = 132          # H100 SXM
OCCUPANCY = 16     # more than the card holds: the plan must clamp it


def _tile_rows(plan, rows, t):
    return min(plan.tile_rows, rows - t * plan.tile_rows)


@pytest.mark.parametrize("W", [8, 16])
@pytest.mark.parametrize("te", [1, 4, 5, 20])
@pytest.mark.parametrize("rows", [1, 3, 4, 511, 512, 513, 500_000])
def test_launch_plan(rows, te, W):
    plan = rr.launch_plan(rows, te, W, SMS, OCCUPANCY)
    # The instantiation: TE 4 and 5 are specialised, the rest generic.
    assert plan.variant == {4: "te4", 5: "te5"}.get(te, "generic")
    assert plan.variant in rr.VARIANTS
    assert plan.wmask == W - 1          # W is a power of two here
    # Tiles of whole rows, starting on multiples of 4, cover every row once.
    assert plan.tile_rows % 4 == 0 and plan.tile_rows >= 4
    assert plan.tiles == -(-rows // plan.tile_rows)
    seen = []
    for t in range(plan.tiles):
        start, n = t * plan.tile_rows, _tile_rows(plan, rows, t)
        assert start % 4 == 0 and n >= 1
        if t < plan.tiles - 1:
            assert n == plan.tile_rows
            assert (n * te * 4) % 16 == 0 and (n * 4) % 16 == 0
        seen.append((start, n))
    assert sum(n for _, n in seen) == rows
    assert all(a + n == b for (a, n), (b, _) in zip(seen, seen[1:]))
    # The persistent walk b, b + grid, ... gives every tile to one block.
    walked = [t for b in range(plan.grid)
              for t in range(b, plan.tiles, plan.grid)]
    assert sorted(walked) == list(range(plan.tiles))
    # The stages' idx rows and last words fit one block's shared memory.
    assert plan.smem == (rr.BARRIER_BYTES
                         + rr.STAGES * plan.tile_rows * (te + 1) * 4)
    assert plan.smem <= rr.SMEM_LIMIT <= 227 * 1024
    # All blocks resident at once, never more than 2,048 threads per SM.
    assert 1 <= plan.grid <= plan.tiles
    assert plan.grid * rr.THREADS <= SMS * 2048


@pytest.mark.parametrize("W,wmask", [(8, 7), (16, 15), (12, -1), (1, 0)])
def test_launch_plan_slot_rule(W, wmask):
    """A power-of-two W takes the slot with a mask, any other with %."""
    assert rr.launch_plan(1000, 5, W, SMS, 8).wmask == wmask


def test_launch_plan_grid_follows_occupancy():
    plan = rr.launch_plan(500_000, 5, 16, SMS, 3)
    assert plan.grid == SMS * 3
    assert rr.launch_plan(500_000, 5, 16, SMS, 0).grid == SMS


def test_launch_plan_refuses_rows_wider_than_shared_memory():
    with pytest.raises(ValueError):
        rr.launch_plan(16, 20_000, 16, SMS, 1)


@pytest.mark.parametrize("rows,te,W", [(2 ** 29, 4, 16), (2 ** 28, 5, 8),
                                       (2 ** 27, 5, 16)])
def test_launch_plan_refuses_offsets_past_31_bits(rows, te, W):
    with pytest.raises(ValueError):
        rr.launch_plan(rows, te, W, SMS, 8)


def test_wrapper_raises_for_a_device_without_a_kernel():
    """Neither a CPU tensor nor a CUDA one: no kernel, no plain fallback."""
    ring = torch.zeros((2, 3, 8), dtype=torch.int32, device="meta")
    idx = torch.zeros((2, 3, 4), dtype=torch.int32, device="meta")
    last = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    before = dict(rr.ring_resolve.launches_by_variant)
    with pytest.raises(ValueError):
        rr.ring_resolve(ring, idx, last)
    assert rr.ring_resolve.launches_by_variant == before


def test_plan_layout_is_the_kernels():
    """The constants the plan assumes are the ones the .cu compiles with
    (the loaded library is checked again against `LAYOUT` on the card)."""
    src = open(os.path.join(os.path.dirname(rr.__file__), "csrc",
                            "ring_resolve.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    enum = dict(re.findall(r"(k\w+) = (\d+)",
                           re.search(r"enum Variant \{([^}]*)\}", src)[1]))
    assert const("kThreads") == rr.THREADS
    assert const("kStages") == rr.STAGES
    assert const("kBarrierBytes") == rr.BARRIER_BYTES == 8 * rr.STAGES
    assert rr.BARRIER_BYTES % 16 == 0      # the stages stay TMA-aligned
    assert [int(enum[k]) for k in ("kGeneric", "kTe4", "kTe5", "kEmpty")] \
        == [*range(len(rr.VARIANTS)), rr.EMPTY]
    assert rr.LAYOUT == (rr.THREADS, rr.BARRIER_BYTES, rr.STAGES,
                         *range(len(rr.VARIANTS)), rr.EMPTY)


def test_launch_floor_needs_the_card():
    """The empty-kernel floor has no plain version: a CPU tensor raises."""
    ring = torch.zeros((2, 3, 8), dtype=torch.int32)
    idx = torch.zeros((2, 3, 4), dtype=torch.int32)
    last = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        rr.launch_floor(ring, idx, last)
