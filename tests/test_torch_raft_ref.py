"""etcd's own Raft unit suite on the port's scalar Raft, on the CPU:
tests/test_raft_core.py (etcd's raft_test.go: elections, log
replication, commit rules, progress and flow control, conf changes,
snapshots), tests/test_raft_node.py (the Node Ready/Advance protocol)
and tests/test_raft_safety.py (seeded chaos: drops, duplicates and
partitions, the safety invariants after every delivery).

Each module runs compiled against the port (tests/port_tests.py,
`on_the_port`): its `etcd_tpu` imports become `etcd_tpu_torch`, and its
`from tests.raft_fixtures import ...` takes the port's copy of the
fixtures module (`helpers=("raft_fixtures",)`), so the networks and
rafts the fixtures build are the port's `raftpb`, `raft.core` and
`raft.storage`. Every test of the three modules is taken into this
namespace, at its own sizes and seeds. This is the scalar Raft that
`ops/oracle.py` and chip_smoke.py's raft_oracle phase hold the card's
round against."""
import etcd_tpu_torch.raft.core as port_core
import etcd_tpu_torch.raft.node as port_node
import etcd_tpu_torch.raftpb as port_raftpb
import etcd_tpu_torch.raft.storage as port_storage
from port_tests import on_the_port

MODULES = {name: on_the_port(name, helpers=("raft_fixtures",))
           for name in ("test_raft_core", "test_raft_node",
                        "test_raft_safety")}

TAKEN = {}
for _name, _mod in MODULES.items():
    for _test in [n for n in vars(_mod) if n.startswith("test_")]:
        assert _test not in globals(), _test
        globals()[_test] = getattr(_mod, _test)
        TAKEN.setdefault(_name, []).append(_test)


def test_every_raft_test_is_taken():
    """Every test function of the three JAX modules is rerun here."""
    import ast
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    for name, taken in TAKEN.items():
        with open(os.path.join(here, name + ".py")) as f:
            tree = ast.parse(f.read())
        want = [n.name for n in tree.body
                if isinstance(n, ast.FunctionDef)
                and n.name.startswith("test_")]
        assert taken == want, name
    assert sum(map(len, TAKEN.values())) == 39 + 9 + 2


def test_the_raft_reruns_build_the_ports_modules():
    core, node, safety = MODULES.values()
    assert core.Raft is port_core.Raft
    assert core.MemoryStorage is port_storage.MemoryStorage
    assert core.raftpb is port_raftpb
    assert node.Node is port_node.Node
    assert safety.Raft is port_core.Raft
    # The fixtures the reruns call are the port's copy of the module.
    for mod in (core, safety):
        fixtures = mod.new_test_raft.__globals__
        assert fixtures["__name__"] == "raft_fixtures__on_the_port"
        assert fixtures["Raft"] is port_core.Raft
        assert fixtures["MemoryStorage"] is port_storage.MemoryStorage
        assert fixtures["raftpb"] is port_raftpb
        r = mod.new_test_raft(1, [1, 2, 3], 10, 1)
        assert type(r) is port_core.Raft
        assert type(r.raft_log.storage) is port_storage.MemoryStorage
    assert core.Network.__module__ == "raft_fixtures__on_the_port"
