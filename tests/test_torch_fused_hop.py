"""The round's fused quiet hop (etcd_tpu_torch/ops/quiet_hop.py and
csrc/quiet_hop.cu) on the CPU:

- the selection rule: which hops take the fused passes (CUDA tensors, no
  comm, a prop_slot, the CUDA resolve, P <= 8, W in {8, 16}, E <= 8);
- `kernel.hop_counts` and the engine's `phase_s["hop.*"]` counts: no
  fused hop here, quiet plus full equal to the hops run;
- the wrapper's refusals, raised before any launch;
- the .cu compiled for the host by the C++ compiler (the same row
  functions and staging the card runs), held exactly equal to the
  PyTorch quiet hop on random quiescent states, its predicate pass to
  `_quiet_pred`, and a lockstep of engine rounds;
- `fused_hop_share`'s reader.

The card's build is held against the PyTorch hop by chip_smoke.py's
phase quiet_hop.
"""
import importlib.util
import os
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
from etcd_tpu_torch.ops import kernel, quiet_hop
from etcd_tpu_torch.ops.ring_resolve import ring_resolve, ring_resolve_ref
from etcd_tpu_torch.ops.state import (GroupState, KernelConfig, LEADER,
                                      init_state, state_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMM = object()        # any comm: a block of a mesh or a collective rank


# ---------------------------------------------------------------------------
# The selection rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device, comm, slot, resolve, shape, fused", [
    ("cuda", None, 0, ring_resolve, (5, 16, 4), True),
    ("cuda", None, 0, ring_resolve, (7, 16, 4), True),
    ("cuda", None, 0, ring_resolve, (8, 8, 8), True),
    ("cuda", None, 0, ring_resolve, (1, 16, 1), True),
    ("cpu", None, 0, ring_resolve, (5, 16, 4), False),
    ("cuda", COMM, 0, ring_resolve, (5, 16, 4), False),
    ("cuda", None, None, ring_resolve, (5, 16, 4), False),
    ("cuda", None, 0, ring_resolve_ref, (5, 16, 4), False),
    ("cuda", None, 0, ring_resolve, (9, 16, 4), False),
    ("cuda", None, 0, ring_resolve, (5, 32, 4), False),
    ("cuda", None, 0, ring_resolve, (5, 12, 4), False),
    ("cuda", None, 0, ring_resolve, (5, 16, 9), False),
], ids=["r5", "r7", "widest", "one_slot", "cpu", "comm", "slots_admission",
        "plain_resolve", "p9", "w32", "w12", "e9"])
def test_selection_rule(device, comm, slot, resolve, shape, fused):
    assert quiet_hop.selects(device, comm, slot, resolve, *shape) is fused


def test_cpu_state_is_not_fused():
    cfg = KernelConfig(groups=4, peers=5)
    st = init_state(cfg, device="cpu")
    assert not quiet_hop.fusable(cfg, st, torch.zeros(4, dtype=torch.int32),
                                 ring_resolve, None)


@pytest.mark.parametrize("peers, fields", [(1, 9), (3, 16), (5, 12),
                                           (7, 12), (8, 12), (8, 16)])
def test_block_plan_fits_shared_memory(peers, fields):
    gpb = quiet_hop.groups_per_block(peers, fields)
    assert gpb >= 1
    assert gpb * peers <= quiet_hop.THREADS
    assert 4 * gpb * peers * peers * fields <= quiet_hop.SMEM_CAP


# ---------------------------------------------------------------------------
# hop_counts and the engine's hop.* counts
# ---------------------------------------------------------------------------

def test_hop_counts_on_the_cpu():
    cfg = KernelConfig(groups=16, peers=3, window=16, max_ents=4)
    st = init_state(cfg, stagger=True, device="cpu")
    inbox = torch.zeros((16, 3, 3, cfg.fields), dtype=torch.int32)
    pc = torch.zeros(16, dtype=torch.int32)
    h0 = dict(kernel.hop_counts)
    for _ in range(12):
        st, inbox = kernel.step_routed_auto(cfg, st, inbox, pc, pc, True,
                                            None, 3)
    d = {k: kernel.hop_counts[k] - h0[k] for k in h0}
    assert d["fused"] == 0
    assert d["quiet"] + d["full"] == 36
    assert d["quiet"] > 0 and d["full"] > 0   # elections, then quiet


def test_engine_counts_hops_in_phase_s(monkeypatch):
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    monkeypatch.delenv("ETCD_TPU_OBS", raising=False)
    with tempfile.TemporaryDirectory() as d:
        eng = MultiEngine(EngineConfig(
            groups=8, peers=3, data_dir=d, window=8, max_ents=2, hops=3,
            device="cpu", checkpoint_rounds=1 << 30))
        try:
            ph0, r0 = dict(eng.phase_s), eng.round_no
            for _ in range(20):
                eng.run_round()
            ph, rounds = dict(eng.phase_s), eng.round_no - r0
        finally:
            eng.stop()
    n = {k: ph.get(f"hop.{k}", 0.0) - ph0.get(f"hop.{k}", 0.0)
         for k in ("fused", "quiet", "full")}
    assert rounds == 20
    assert n["fused"] == 0
    assert n["quiet"] + n["full"] == 3 * rounds
    assert _reader("fused_hop_share")({"phase_s": ph}) == 0.0


# ---------------------------------------------------------------------------
# The wrapper's refusals
# ---------------------------------------------------------------------------

def _case(seed=0, groups=6, peers=5, window=16, max_ents=4, tick=True):
    cfg = KernelConfig(groups=groups, peers=peers, window=window,
                       max_ents=max_ents, heartbeat_tick=3)
    st_np, ib, pc, ps, drop = chip_smoke.quiet_inputs(
        np.random.RandomState(seed), groups, peers, window, max_ents, tick)
    return (cfg, state_from_numpy(st_np, "cpu"), *(torch.from_numpy(a) for a
                                                    in (ib, pc, ps, drop)))


class _NoLaunch:
    """A build that fails the test if any pass is launched."""
    def __init__(self):
        self.calls = 0

    def __call__(self, *a):
        self.calls += 1
        raise AssertionError("a pass was launched")


def _fake_lib():
    return quiet_hop.Lib(_NoLaunch(), "cpu", ring_resolve_ref, lambda d: 0)


def test_cpu_tensors_refused_by_the_card_build():
    cfg, st, ib, pc, ps, _ = _case()
    with pytest.raises(ValueError, match="not on the build's cuda"):
        quiet_hop.fused_hop(cfg, st, ib, pc, ps, True)
    with pytest.raises(ValueError, match="not on the build's cuda"):
        quiet_hop.quiet_flag(cfg, st, ib, True)


@pytest.mark.parametrize("fault", ["noncontiguous_match", "int64_commit",
                                   "int64_prop_count", "int8_paused",
                                   "noncontiguous_inbox", "wrong_fields",
                                   "p9"])
def test_refusals_before_any_launch(fault):
    cfg, st, ib, pc, ps, _ = _case()
    if fault == "noncontiguous_match":
        st = st._replace(match=st.match.transpose(1, 2))
        err = ValueError
    elif fault == "int64_commit":
        st = st._replace(commit=st.commit.long())
        err = TypeError
    elif fault == "int64_prop_count":
        pc = pc.long()
        err = TypeError
    elif fault == "int8_paused":
        st = st._replace(paused=st.paused.to(torch.int8))
        err = TypeError
    elif fault == "noncontiguous_inbox":
        ib = ib.transpose(1, 2)
        err = ValueError
    elif fault == "wrong_fields":
        ib = ib[..., :-1].contiguous()
        err = ValueError
    else:
        cfg, st, ib, pc, ps, _ = _case(peers=9)
        err = ValueError
    lib = _fake_lib()
    n0 = dict(quiet_hop.launches)
    with pytest.raises(err):
        quiet_hop.fused_hop(cfg, st, ib, pc, ps, True, lib=lib)
    assert lib.launch.calls == 0
    assert quiet_hop.launches == n0


# ---------------------------------------------------------------------------
# The .cu built for the host against the PyTorch hop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib():
    """csrc/quiet_hop.cu compiled by the host's C++ compiler."""
    import ctypes
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a C++ compiler builds the host version of quiet_hop.cu"
    src = os.path.join(ROOT, "etcd_tpu_torch", "ops", "csrc", "quiet_hop.cu")
    with tempfile.TemporaryDirectory() as d:
        so = os.path.join(d, "libquiet_hop_host.so")
        subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-Wall",
                        "-Werror", "-shared", "-fPIC", "-o", so, src],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(so)
    return quiet_hop.bind(lib, "cpu", ring_resolve_ref, lambda d: 0)


def _pytorch_hop(cfg, st, ib, pc, ps, tick, force_hb, drop):
    s, out = kernel._step_body(cfg, st, ib, pc, ps, tick, quiet=True,
                               force_hb=force_hb, resolve=ring_resolve_ref)
    routed = kernel.route_local(out)
    return s, routed if drop is None else routed * drop


def _differ(a, b):
    st_a, ib_a = a
    st_b, ib_b = b
    bad = [n for n, x, y in zip(GroupState._fields, st_a, st_b)
           if not torch.equal(x, y)]
    return bad + ([] if torch.equal(ib_a, ib_b) else ["inbox"])


@pytest.mark.parametrize("groups, peers, window, max_ents", [
    (300, 5, 16, 4), (300, 7, 16, 4), (200, 5, 16, 8), (8, 3, 16, 8),
    (250, 5, 8, 2), (150, 8, 16, 8), (97, 7, 16, 4), (40, 1, 16, 1),
    (60, 2, 8, 5)], ids=lambda v: str(v))
def test_host_build_equals_pytorch_hop(host_lib, groups, peers, window,
                                       max_ents):
    for seed, (tick, force_hb, with_drop) in enumerate(
            [(True, False, True), (False, False, False), (True, True, False),
             (False, True, True)]):
        cfg, st, ib, pc, ps, drop = _case(seed, groups, peers, window,
                                          max_ents)
        dm = drop if with_drop else None
        assert bool(kernel._quiet_pred(st, cfg, ib, st.peer_mask, tick))
        assert int(quiet_hop.quiet_flag(cfg, st, ib, tick,
                                        lib=host_lib)) == 1
        got = quiet_hop.fused_hop(cfg, st, ib, pc, ps, tick, force_hb, dm,
                                  lib=host_lib)
        want = _pytorch_hop(cfg, st, ib, pc, ps, tick, force_hb, dm)
        assert _differ(got, want) == [], (tick, force_hb, with_drop)
        # The fields the hop never changes are the input's own tensors;
        # the input is left as it was.
        for name in ("term", "vote", "state", "prng", "votes", "peer_mask"):
            assert getattr(got[0], name) is getattr(st, name)
        assert _differ((st, ib), _case(seed, groups, peers, window,
                                       max_ents)[1:3]) == []


def test_launches_counted_by_pass(host_lib):
    """Each pass is counted once it is launched: the predicate by
    quiet_flag, the three others once a fused hop; a launch the build
    refuses is not counted."""
    cfg, st, ib, pc, ps, _ = _case(1, 20, 5)
    n0 = dict(quiet_hop.launches)
    quiet_hop.quiet_flag(cfg, st, ib, True, lib=host_lib)
    for _ in range(2):
        quiet_hop.fused_hop(cfg, st, ib, pc, ps, True, lib=host_lib)
    d = {k: quiet_hop.launches[k] - n0[k] for k in n0}
    assert d == {"pred": 1, "msgs": 2, "commit": 2, "route": 2}

    def refused(*a):
        return 1
    lib = quiet_hop.Lib(refused, "cpu", ring_resolve_ref, lambda d: 0)
    n1 = dict(quiet_hop.launches)
    with pytest.raises(RuntimeError, match="pred launch failed"):
        quiet_hop.quiet_flag(cfg, st, ib, True, lib=lib)
    assert quiet_hop.launches == n1


def test_host_build_takes_every_branch(host_lib):
    """The random states reach the hop's rare branches: a conflict that
    truncates, NH_SNAP and NH_VIOLATION, rejects, appends, heartbeats."""
    cfg, st, ib, pc, ps, _ = _case(3, 2000, 5)
    s, routed = quiet_hop.fused_hop(cfg, st, ib, pc, ps, True, lib=host_lib)
    assert int((s.last_index < st.last_index).sum()) > 0
    assert int(((s.need_host & 1) != 0).sum()) > 0
    assert int(((s.need_host & 2) != 0).sum()) > 0
    kinds = routed[..., 0]
    for mtype in (1, 2, 5, 6):
        assert int((kinds == mtype).sum()) > 0, mtype
    assert int(((kinds == 2) & (routed[..., 5] != 0)).sum()) > 0


@pytest.mark.parametrize("way", range(6))
def test_host_predicate_pass_equals_quiet_pred(host_lib, way):
    cfg, st, ib, _, _, _ = _case(way, 64, 5)
    st_np = {k: v.numpy().copy() for k, v in st._asdict().items()}
    ib = ib.clone()
    g, p = 17, way % 5
    if way == 0:
        st_np["need_host"][g, p] = 2
    elif way == 1:
        st_np["state"][g, p], st_np["peer_mask"][g, p] = 1, True
    elif way == 2:
        ib[g, p, 1, 0] = 4
    elif way == 3:
        ib[g, p, 1, :2] = torch.tensor([6, 77])
    elif way == 4:
        st_np["state"][g, :], st_np["peer_mask"][g, :] = LEADER, True
    else:
        st_np["state"][g, p], st_np["peer_mask"][g, p] = 0, True
        st_np["elapsed"][g, p] = cfg.election_tick - 1
    st_np["prng"] = st_np["prng"].astype(np.uint32)
    st2 = state_from_numpy(st_np, "cpu")
    for tick in (True, False):
        want = bool(kernel._quiet_pred(st2, cfg, ib, st2.peer_mask, tick))
        got = int(quiet_hop.quiet_flag(cfg, st2, ib, tick, lib=host_lib))
        assert bool(got) == want
        assert not want or (way == 5 and not tick)


def test_host_build_rounds_in_lockstep(host_lib, monkeypatch):
    """step_routed_compact rounds (hops=3) with the fused passes selected
    on the CPU, in lockstep with the PyTorch hop: equal after every
    round, every hop of the steady state fused."""
    real_fusable = quiet_hop.fusable

    def fusable(cfg, st, prop_slot, resolve, comm):
        return real_fusable(cfg, st, prop_slot, resolve, comm) or (
            resolve is ring_resolve and quiet_hop.selects(
                "cuda", comm, prop_slot, resolve, st.term.shape[1],
                st.log_term.shape[2], cfg.max_ents))
    flag, hop = quiet_hop.quiet_flag, quiet_hop.fused_hop
    monkeypatch.setattr(quiet_hop, "fusable", fusable)
    monkeypatch.setattr(quiet_hop, "quiet_flag",
                        lambda *a: flag(*a, lib=host_lib))
    monkeypatch.setattr(quiet_hop, "fused_hop",
                        lambda *a: hop(*a, lib=host_lib))
    cfg = KernelConfig(groups=48, peers=5, window=16, max_ents=4,
                       heartbeat_tick=3)
    st_f = st_p = init_state(cfg, stagger=True, device="cpu")
    ib_f = ib_p = torch.zeros((48, 5, 5, cfg.fields), dtype=torch.int32)
    steady = dict.fromkeys(kernel.hop_counts, 0)
    for r in range(30):
        lead = (st_f.state == LEADER) & st_f.peer_mask
        pc = torch.where(lead.any(dim=1), 4, 0).to(torch.int32)
        ps = kernel._first_true(lead, dim=1)
        h0 = dict(kernel.hop_counts)
        out_f = kernel.step_routed_compact(cfg, st_f, ib_f, pc, ps, True,
                                           None, 3)
        if r >= 15:
            for k in steady:
                steady[k] += kernel.hop_counts[k] - h0[k]
        out_p = kernel.step_routed_compact(cfg, st_p, ib_p, pc, ps, True,
                                           None, 3, resolve=ring_resolve_ref)
        (st_f, ib_f), (st_p, ib_p) = out_f[:2], out_p[:2]
        assert _differ((st_f, ib_f), (st_p, ib_p)) == [], r
        assert all(torch.equal(a, b) for a, b in zip(out_f[2:], out_p[2:]))
    assert steady == {"fused": 45, "quiet": 0, "full": 0}
    assert int(st_f.commit.amax(dim=1).sum()) > 0


# ---------------------------------------------------------------------------
# fused_hop_share
# ---------------------------------------------------------------------------

def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "fused_hop_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", ["fused_hop_share", "fused_hop_share.rate"])
@pytest.mark.parametrize("counts, share", [
    ((150, 0, 0), 100.0), ((27, 2, 1), 90.0), ((0, 0, 150), 0.0),
    ((0, 120, 30), 0.0), ((0, 0, 0), None), (None, None)],
    ids=["all_fused", "mixed", "full_path", "pytorch_quiet", "no_hops",
         "no_counter"])
def test_fused_hop_share_reader(name, counts, share):
    ph = {"dispatch": 0.5, "readback": 0.02}
    if counts is not None:
        ph.update({f"hop.{k}": float(n) for k, n in
                   zip(("fused", "quiet", "full"), counts)})
    o = {"phase_s": ph, "rounds": 50}
    got = _reader(name)(o)
    assert got == (None if share is None else pytest.approx(share))
    # The `.rate` twin reads as its base on the same observations.
    assert got == _reader("fused_hop_share")(o)
