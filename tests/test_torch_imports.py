"""The port stands alone: etcd_tpu_torch imports torch, never jax and
nothing of the JAX package; its host modules are the JAX package's,
verbatim apart from import lines; its entry points default to the card."""
import ast
import os
import re
import subprocess
import sys
import tempfile

import pytest

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "etcd_tpu_torch")

VERBATIM = ["errors.py", "utils/wait.py", "utils/idutil.py",
            "utils/fileutil.py", "utils/metrics.py", "native/__init__.py",
            "store/__init__.py", "store/event.py", "store/node.py",
            "store/watcher.py", "store/store.py", "server/request.py",
            "server/obs.py", "server/enginewal.py", "server/walwriter.py",
            "version.py", "utils/tlsutil.py", "server/cluster.py",
            "etcdhttp/web.py", "etcdhttp/client.py",
            "etcdhttp/client_security.py", "server/batchframe.py",
            "etcdhttp/tenants.py", "server/ingress.py",
            "store/native_store.py",
            "tools/etcd_top.py", "raftpb.py", "raft/storage.py",
            "raft/progress.py", "raft/log.py", "raft/core.py",
            "raft/node.py", "raft/__init__.py", "wal/wal.py",
            "wal/__init__.py", "snap/snapshotter.py", "snap/__init__.py",
            "server/stats.py", "server/storage.py", "server/transport.py",
            "storage/revision.py", "storage/backend.py", "storage/index.py",
            "storage/kvstore.py", "storage/__init__.py", "server/v3.py",
            "migrate/etcd4.py", "migrate/standby.py", "migrate/__init__.py",
            "server/__init__.py", "etcdhttp/peer.py",
            "etcdhttp/v3.py", "etcdhttp/__init__.py",
            "rafthttp/transport.py", "rafthttp/__init__.py", "embed.py",
            "client/__init__.py", "client/client.py", "client/keys.py",
            "client/members.py", "etcdctl/__init__.py", "etcdctl/main.py",
            "proxy/__init__.py", "proxy/director.py", "proxy/reverse.py",
            "discovery/__init__.py", "discovery/discovery.py",
            "discovery/srv.py"]
# Where a copy's source is not at the same path under etcd_tpu/.
SOURCES = {"tools/etcd_top.py": "scripts/etcd_top.py"}
# Docstring lines (1-based) a copy rewords: raftpb.py names etcd's raftpb
# schema by the project, where its source gives a checkout's file path.
REWORDED = {"raftpb.py": {4}}
NATIVE_C = ["native/walcodec.c", "native/ingresscore.c",
            "native/storecore.c"]
TOOLS = ["pool_serve", "ingress_serve", "scale_curve", "profile_engine",
         "etcd_top", "tsan_check", "dump_logs", "functional_tester",
         "latency_hops", "soak", "multihost_bench", "frames_kill_loop"]
# The tools that run rounds on a device: "cuda" unless asked for the CPU.
CARD_TOOLS = {"latency_hops": (["64"], "--device cpu", {}),
              "soak": (["kernel", "1"], "--device cpu", {}),
              "multihost_bench": ([], "MHB_DEVICE=cpu",
                                  {"MHB_OUT": "unused.json"}),
              "frames_kill_loop": ([], "--device cpu", {}),
              "bench": ([], "BENCH_PLATFORM=cpu", {})}
# A card tool's module where it is not etcd_tpu_torch.tools.<name>.
CARD_TOOL_MODULES = {"bench": "etcd_tpu_torch.bench"}

_IMPORT_LINE = re.compile(r"^(\s*(?:from|import)\s+)etcd_tpu_torch\b")


def _is_forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "etcd_tpu" or name.startswith("etcd_tpu."))


def test_engine_import_loads_no_jax_and_no_jax_package():
    code = ("import sys\n"
            "import etcd_tpu_torch.server.engine, etcd_tpu_torch.ops.kernel\n"
            "import etcd_tpu_torch.server.hostengine\n"
            "import etcd_tpu_torch.tools.multihost_engine\n"
            "import etcd_tpu_torch.tools.multihost_supervisor\n"
            + "".join(f"import etcd_tpu_torch.tools.{t}\n" for t in TOOLS)
            + "import etcd_tpu_torch.store.native_store\n"
            "import etcd_tpu_torch.embed, etcd_tpu_torch.server.server\n"
            "import etcd_tpu_torch.etcdmain.etcd, etcd_tpu_torch.ops.oracle\n"
            "import etcd_tpu_torch.bench\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert "etcd_tpu_torch.server.engine" in out
    assert "etcd_tpu_torch.server.hostengine" in out
    assert "etcd_tpu_torch.tools.multihost_supervisor" in out
    assert all(f"etcd_tpu_torch.tools.{t}" in out for t in TOOLS)
    assert "etcd_tpu_torch.native.storecore" in out
    assert "etcd_tpu_torch.server.server" in out
    assert "etcd_tpu_torch.raft.core" in out
    assert "etcd_tpu_torch.etcdmain.etcd" in out
    assert "etcd_tpu_torch.bench" in out
    assert "torch" in out
    assert [m for m in out if _is_forbidden(m)] == []


def _py_files():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_file_imports_jax_or_the_jax_package():
    """Static check of every import statement, lazy ones included."""
    bad = []
    for path in _py_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if _is_forbidden(n)]
    assert bad == []


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_a_verbatim_copy(rel):
    ours = open(os.path.join(PKG, rel)).read().splitlines()
    source = SOURCES.get(rel, os.path.join("etcd_tpu", rel))
    theirs = open(os.path.join(ROOT, source)).read().splitlines()
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs), 1):
        if a != b and i not in REWORDED.get(rel, ()):
            assert _IMPORT_LINE.sub(r"\1etcd_tpu", a) == b, f"{rel}:{i}"


@pytest.mark.parametrize("rel", NATIVE_C)
def test_native_source_is_its_source_under_the_rename(rel):
    """Each C file is the JAX package's with `etcd_tpu` renamed
    `etcd_tpu_torch`, and nothing else: undoing the rename gives the
    source back byte for byte."""
    ours = open(os.path.join(PKG, rel), "rb").read()
    theirs = open(os.path.join(ROOT, "etcd_tpu", rel), "rb").read()
    assert b"etcd_tpu_torch" not in theirs
    assert ours.replace(b"etcd_tpu_torch", b"etcd_tpu") == theirs
    assert re.sub(rb"\betcd_tpu\b", b"etcd_tpu_torch", theirs) == ours


_C_COMMENT = re.compile(r"/\*.*?\*/|//[^\n]*", re.S)
_C_STRING = re.compile(r'"(?:[^"\\\n]|\\.)*"')


@pytest.mark.parametrize("rel", NATIVE_C)
def test_no_native_string_names_the_jax_package(rel):
    """No string literal of the port's C names `etcd_tpu.`: the C imports
    the port's errors module (the class the port's HTTP front catches)
    and names its type under the port."""
    code = _C_COMMENT.sub("", open(os.path.join(PKG, rel)).read())
    strings = _C_STRING.findall(code)
    assert strings
    assert [s for s in strings if re.search(r"\betcd_tpu\.", s)] == []
    if rel.endswith("storecore.c"):
        assert '"etcd_tpu_torch.errors"' in strings
        assert '"etcd_tpu_torch.native.storecore.Core"' in strings


def test_cli_config_differs_only_by_the_engine_device():
    """etcdmain/config.py is the JAX package's, apart from import lines,
    plus the `engine_device` field and its `--engine-device` flag row."""
    ours = open(os.path.join(PKG, "etcdmain/config.py")).read().splitlines()
    theirs = open(os.path.join(ROOT, "etcd_tpu", "etcdmain/config.py")
                  ).read().splitlines()
    added = [ln for ln in ours if _IMPORT_LINE.sub(r"\1etcd_tpu", ln)
             not in theirs]
    assert [_IMPORT_LINE.sub(r"\1etcd_tpu", ln) for ln in ours
            if ln not in added] == theirs
    assert added == [
        "    # Where the engine's consensus state lives and its rounds run",
        "    # (engine.EngineConfig.device): \"cuda\" (the card) or \"cpu\".",
        "    engine_device: str = \"cuda\"",
        "    (\"engine-device\", str, \"cuda\",",
        "     \"Torch device the engine runs on: cuda (the card; refuses to "
        "start \"",
        "     \"without one) or cpu\"),",
    ]
    from etcd_tpu_torch.etcdmain import parse_args
    assert parse_args(["--engine-groups", "4"], env={}).engine_device \
        == "cuda"
    assert parse_args(["--engine-groups", "4"], env={
        "ETCD_ENGINE_DEVICE": "cpu"}).engine_device == "cpu"
    assert parse_args(["--engine-groups", "4", "--engine-device", "cpu"],
                      env={"ETCD_ENGINE_DEVICE": "cuda"}
                      ).engine_device == "cpu"


def test_member_server_differs_only_by_the_dropped_proposal_guard():
    """server/server.py is the JAX package's, apart from import lines,
    plus three repairs of its run loop: a peer's forwarded proposal that
    raft drops (no leader here) no longer ends the loop; a late tick
    fires once, where its source fires every tick a stall missed, back
    to back (`etcd_tpu/server/server.py:557-559`), so that a stall
    longer than the election timeout made the member campaign ahead of
    the heartbeats queued behind it; and the transport's
    report_unreachable and report_snapshot reach the raft core through
    the node's report methods, where its source queues them as messages
    that `node.step` drops (`etcd_tpu/server/server.py:466-474`; the
    import of MessageType goes with them). tests/test_torch_server.py
    holds the three behaviours."""
    import difflib
    rel = "server/server.py"
    ours = [_IMPORT_LINE.sub(r"\1etcd_tpu", ln)
            for ln in open(os.path.join(PKG, rel)).read().splitlines()]
    theirs = open(os.path.join(ROOT, "etcd_tpu", rel)).read().splitlines()
    diff = [ln for ln in difflib.unified_diff(theirs, ours, lineterm="",
                                              n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    assert diff == [
        "-                             EntryType, Message, MessageType, "
        "Snapshot,",
        "+                             EntryType, Message, Snapshot,",
        "-        self._inq.put((\"msg\", Message(type=MessageType.UNREACHABLE, "
        "frm=pid)))",
        "+        self._inq.put((\"unreachable\", pid))",
        "-        self._inq.put((\"msg\", Message(type=MessageType.SNAP_STATUS, "
        "frm=pid,",
        "-                                      reject=not ok)))",
        "+        self._inq.put((\"snap_status\", (pid, ok)))",
        "-                while time.monotonic() >= next_tick:",
        "+                now = time.monotonic()",
        "+                if now >= next_tick:",
        "+                    # One tick however late, as Go's time.Ticker "
        "drops the",
        "+                    # ticks a slow receiver missed "
        "(etcdserver/raft.go's",
        "+                    # ticker): after a stall longer than the "
        "election",
        "+                    # timeout, the heartbeats queued behind it are",
        "+                    # stepped before this member campaigns.",
        "-                    next_tick += tick_s",
        "+                    next_tick += tick_s * (1 + int((now - next_tick)",
        "+                                                   // tick_s))",
        "-                self.node.step(payload)",
        "+                try:",
        "+                    self.node.step(payload)",
        "+                except ProposalDroppedError:",
        "+                    # A proposal a peer forwarded here while this "
        "member",
        "+                    # knows no leader: dropped, as raft.go's "
        "stepFollower",
        "+                    # and stepCandidate drop it (the proposer's "
        "request",
        "+                    # times out), instead of ending this loop.",
        "+                    pass",
        "+            elif kind == \"unreachable\":",
        "+                # Through the node's report_* (node.go's "
        "ReportUnreachable",
        "+                # and ReportSnapshot): `node.step` drops a local "
        "message",
        "+                # from a peer, so a leader never left a snapshot whose",
        "+                # send failed and waited on that follower for good.",
        "+                self.node.report_unreachable(payload)",
        "+            elif kind == \"snap_status\":",
        "+                self.node.report_snapshot(*payload)",
    ]


def test_dump_logs_differs_only_by_usage_and_batched_entries():
    """tools/dump_logs.py is the JAX package's, apart from import lines,
    with two departures: its usage lines name the port's module, and
    `dump_engine` decodes the engine's batched entries (P_MULTI), where
    its source prints "?" for them (tests/test_torch_etcd_tools.py holds
    the behaviour)."""
    import difflib
    rel = "tools/dump_logs.py"
    ours = [_IMPORT_LINE.sub(r"\1etcd_tpu", ln).replace(
        "python -m etcd_tpu_torch.tools.", "python -m etcd_tpu.tools.")
        for ln in open(os.path.join(PKG, rel)).read().splitlines()]
    theirs = open(os.path.join(ROOT, "etcd_tpu", rel)).read().splitlines()
    assert sum("python -m etcd_tpu.tools.dump_logs" in ln
               for ln in theirs) == 3
    diff = [ln for ln in difflib.unified_diff(theirs, ours, lineterm="",
                                              n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    assert diff == [
        "+import struct",
        "+    from etcd_tpu.server.engine import P_MULTI, _unpack_multi",
        "+            elif payload[:1] == bytes([P_MULTI]):",
        "+                # A batched entry (coalesced writes): each of its",
        "+                # Requests, in order.",
        "+                try:",
        "+                    rs = [Request.decode(b) for b in "
        "_unpack_multi(payload)]",
        "+                    kind = f\"multi[{len(rs)}]\"",
        "+                    body = \", \".join(f\"{r.method} {r.path}\" "
        "for r in rs)",
        "+                except (ValueError, struct.error):",
        "+                    kind = \"multi<bad>\"",
    ]


def test_security_differs_only_by_the_verify_cache():
    """server/security.py is the JAX package's, apart from import lines,
    with one departure: `check_password` caches only successful
    verifications and evicts its oldest entry when full, where its
    source caches failures too and clears the whole cache (a spray of
    wrong passwords flushed the legitimate users' entries;
    tests/test_torch_security_ref.py holds the behaviour). A lock guards
    the evict-and-insert: the HTTP handlers' threads call it at once."""
    import difflib
    rel = "server/security.py"
    ours = [_IMPORT_LINE.sub(r"\1etcd_tpu", ln)
            for ln in open(os.path.join(PKG, rel)).read().splitlines()]
    theirs = open(os.path.join(ROOT, "etcd_tpu", rel)).read().splitlines()
    diff = [ln for ln in difflib.unified_diff(theirs, ours, lineterm="",
                                              n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    assert diff == [
        "+import threading",
        "-# Bounded; cleared wholesale when full.",
        "+# Only successful verifications are cached, and a full cache "
        "evicts its",
        "+# oldest entry: a spray of wrong passwords adds no entry, so it "
        "cannot",
        "+# flush the legitimate users' entries (each wrong guess still "
        "pays the",
        "+# full PBKDF2).",
        "+_VERIFY_LOCK = threading.Lock()   # handler threads evict and "
        "insert",
        "-        hit = _VERIFY_CACHE.get(ck)",
        "-        if hit is not None:",
        "-            return hit",
        "+        if ck in _VERIFY_CACHE:",
        "+            return True",
        "-        if len(_VERIFY_CACHE) >= _VERIFY_CACHE_MAX:",
        "-            _VERIFY_CACHE.clear()",
        "-        _VERIFY_CACHE[ck] = ok",
        "+        if ok:",
        "+            with _VERIFY_LOCK:",
        "+                if len(_VERIFY_CACHE) >= _VERIFY_CACHE_MAX:",
        "+                    _VERIFY_CACHE.pop(next(iter(_VERIFY_CACHE)), "
        "None)",
        "+                _VERIFY_CACHE[ck] = True",
    ]


def test_frames_differs_only_by_the_reconnect_repair():
    """parallel/frames.py is the JAX package's, apart from import lines,
    with one departure: a refused connect drops only the frames queued
    before that attempt began, where its source clears the whole queue
    (`etcd_tpu/parallel/frames.py:111`) and so also loses a frame queued
    while the attempt ran, though the peer listens by then. Each queued
    frame carries its enqueue order for that
    (tests/test_torch_frames_ref.py holds the behaviour)."""
    import difflib
    rel = "parallel/frames.py"
    ours = [_IMPORT_LINE.sub(r"\1etcd_tpu", ln)
            for ln in open(os.path.join(PKG, rel)).read().splitlines()]
    theirs = open(os.path.join(ROOT, "etcd_tpu", rel)).read().splitlines()
    diff = [ln for ln in difflib.unified_diff(theirs, ours, lineterm="",
                                              n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    assert diff == [
        "+import itertools",
        "+        # Enqueue order: each queued frame's first field.",
        "+        self._seq = itertools.count()",
        "-        q.append((header, blob))",
        "+        q.append((next(self._seq), header, blob))",
        "+                began = next(self._seq)",
        "-                    self._qs[h].clear()",
        "+                    # A frame queued since the attempt began waits for",
        "+                    # the next one: the peer may be listening by then.",
        "+                    q = self._qs[h]",
        "+                    while q and q[0][0] < began:",
        "+                        q.popleft()",
        "-                header, blob = self._qs[h].popleft()",
        "+                _, header, blob = self._qs[h].popleft()",
    ]


def test_functional_tester_differs_only_by_the_members_it_spawns():
    """tools/functional_tester.py is the JAX package's, apart from import
    lines, and the member command it spawns: `python -m etcd_tpu_torch`,
    the port's members, where its source spawns the JAX package's
    (tests/test_torch_chaos.py holds the behaviour)."""
    rel = "tools/functional_tester.py"
    ours = open(os.path.join(PKG, rel)).read().splitlines()
    theirs = open(os.path.join(ROOT, "etcd_tpu", rel)).read().splitlines()
    assert len(ours) == len(theirs)
    differ = [i for i, (a, b) in enumerate(zip(ours, theirs), 1)
              if _IMPORT_LINE.sub(r"\1etcd_tpu", a) != b]
    assert differ == [95]
    assert theirs[94] == \
        '            [sys.executable, "-m", "etcd_tpu"] + self._args(),'
    assert ours[94] == \
        '            [sys.executable, "-m", "etcd_tpu_torch"] + self._args(),'


def test_ingress_import_loads_no_torch_and_no_jax():
    """The ingress tier runs in its own light process: importing it pulls
    in neither torch nor jax nor anything of the JAX package."""
    code = ("import sys\n"
            "import etcd_tpu_torch.server.ingress\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert "etcd_tpu_torch.server.ingress" in out
    assert [m for m in out if _is_forbidden(m) or m == "torch"
            or m.startswith("torch.")] == []


def test_member_mode_loads_no_torch_and_no_jax():
    """The member and proxy modes are the scalar host path: the CLI's
    entry and everything a member or a proxy runs (embed, EtcdServer,
    raft, WAL, snap, the peer transport, the v2 and v3 APIs and the v0.4
    upgrade, the last three imported lazily by `embed.Etcd` and
    `EtcdServer`; the proxy; discovery, imported lazily by `start_etcd`),
    and the client tools (the SDK and etcdctl) import neither torch nor
    jax nor anything of the JAX package, so none of them creates a CUDA
    context."""
    code = ("import sys\n"
            "import etcd_tpu_torch.__main__, etcd_tpu_torch.etcdmain.etcd\n"
            "import etcd_tpu_torch.embed, etcd_tpu_torch.etcdhttp.v3\n"
            "import etcd_tpu_torch.etcdhttp.client_security\n"
            "import etcd_tpu_torch.migrate, etcd_tpu_torch.discovery\n"
            "import etcd_tpu_torch.etcdctl.main, etcd_tpu_torch.client\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    for mod in ("embed", "server.server", "raft.core", "wal.wal",
                "snap.snapshotter", "rafthttp.transport", "etcdhttp.peer",
                "etcdhttp.v3", "storage.kvstore", "migrate.etcd4",
                "proxy.reverse", "proxy.director", "discovery.discovery",
                "discovery.srv", "etcdctl.main", "client.keys",
                "client.members"):
        assert f"etcd_tpu_torch.{mod}" in out, mod
    assert [m for m in out if _is_forbidden(m) or m == "torch"
            or m.startswith("torch.")] == []


def test_engine_defaults_to_the_card():
    from etcd_tpu_torch.server.engine import EngineConfig, MultiEngine
    with tempfile.TemporaryDirectory() as d:
        cfg = EngineConfig(groups=2, peers=3, data_dir=d)
        assert cfg.device == "cuda"
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiEngine(cfg)
        # Refused before touching the data dir.
        assert os.listdir(d) == []


def test_state_defaults_to_the_card():
    from etcd_tpu_torch.ops.state import KernelConfig, init_state
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        init_state(KernelConfig(groups=2, peers=3))


def test_oracle_schedules_default_to_the_card():
    """run_equivalence and run_sampled run their rounds on "cuda" unless
    the caller passes device="cpu" (test_torch_raft_oracle.py does)."""
    import inspect

    from etcd_tpu_torch.ops import oracle
    for fn in (oracle.run_equivalence, oracle.run_sampled):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        oracle.run_equivalence(seed=1, rounds=1)


def test_host_engine_and_launcher_default_to_the_card():
    """HostEngineConfig.device and the launcher's MHE_DEVICE default to
    "cuda", and the data plane to "collective" (as in the JAX package);
    without a card the engine refuses before the data dir. A collective
    HostEngine on the CPU constructs on a one-rank gloo process group,
    holding its own column only. The card tools' entry points default to
    "cuda" too (their command lines: test_card_tools_exit_1_without_a_card)."""
    import inspect
    import socket

    from etcd_tpu_torch.tools import latency_hops, soak
    for fn in (latency_hops.measure, soak.soak_kernel, soak.soak_engine,
               soak.soak_hostengine):
        assert inspect.signature(fn).parameters["device"].default == "cuda"

    import torch.distributed as dist
    from etcd_tpu_torch import errors
    from etcd_tpu_torch.server.hostengine import HostEngine, HostEngineConfig
    with tempfile.TemporaryDirectory() as d:
        cfg = HostEngineConfig(groups=2, peers=3, data_dir=d, host_id=0,
                               frame_listen=("127.0.0.1", 0))
        assert cfg.device == "cuda"
        assert cfg.data_plane == "collective"
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HostEngine(cfg)
        assert os.listdir(d) == []
        # Without a process group the collective plane refuses too.
        with pytest.raises(RuntimeError, match="torch.distributed"):
            HostEngine(HostEngineConfig(
                groups=2, peers=1, data_dir=d, host_id=0,
                frame_listen=("127.0.0.1", 0), device="cpu"))
        assert os.listdir(d) == []
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
        try:
            eng = HostEngine(HostEngineConfig(
                groups=2, peers=1, data_dir=d, host_id=0,
                frame_listen=("127.0.0.1", 0), device="cpu"))
            try:
                assert eng._comm.peers == 1 and eng._comm.backend == "gloo"
                assert tuple(eng.st.term.shape) == (2, 1)
                assert tuple(eng.st.match.shape) == (2, 1, 1)
                assert tuple(eng.inbox.shape) == (2, 1, 1, eng.kcfg.fields)
                # Membership is the peers axis: refused on this plane too.
                with pytest.raises(errors.EtcdError):
                    eng.conf_change(0, "add", 1)
            finally:
                eng.stop()
        finally:
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as d:
        # The launcher, MHE_DEVICE unset: refused, no traceback, no dir.
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "MHE_DEVICE")}
        env.update(MHE_RANK="0", MHE_NHOSTS="1", MHE_DATA=d,
                   MHE_HTTP_PORTS="0", MHE_FRAME_PORTS="0")
        res = subprocess.run(
            [sys.executable, "-m", "etcd_tpu_torch.tools.multihost_engine"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 1, res
        assert "no CUDA device" in res.stderr
        assert "Traceback" not in res.stderr
        assert os.listdir(d) == []


@pytest.mark.parametrize("tool", sorted(CARD_TOOLS))
def test_card_tools_exit_1_without_a_card(tool, tmp_path):
    """latency_hops, soak, multihost_bench and the bench run on the card
    unless the caller asks for the CPU; without a card they exit 1 with a
    message saying how to ask, and no traceback: none goes on on the CPU
    by itself (tests/test_torch_etcd_tools.py and test_torch_bench.py run
    them on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    args, how, env = CARD_TOOLS[tool]
    full = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "MHB_DEVICE", "BENCH_PLATFORM")}
    full.update({k: str(tmp_path / v) for k, v in env.items()})
    module = CARD_TOOL_MODULES.get(tool, f"etcd_tpu_torch.tools.{tool}")
    res = subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=ROOT, env=full, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res
    assert "no CUDA device" in res.stderr and how in res.stderr
    assert "Traceback" not in res.stderr and res.stdout == ""
    assert os.listdir(tmp_path) == []


def test_the_cpu_binding_of_reruns_leaves_the_defaults_on_the_card(
        tmp_path):
    """tests/port_tests.py's `on_the_port(name, cpu=True)`: a rerun
    module's engines run on the CPU, from an import at its top and from
    one inside a function (test_observability.py's eng_http fixture
    imports EngineConfig so); the port's own classes still default
    to "cuda", and the environment gets no device variable. The rename
    reaches indented import lines and only import lines."""
    import dataclasses

    import port_tests
    from etcd_tpu_torch.server import engine, hostengine
    src = ("import etcd_tpu.server\n"
           "def f():\n"
           "    from etcd_tpu.server.engine import EngineConfig\n"
           "    import etcd_tpu.errors\n"
           "s = 'etcd_tpu.native.storecore'\n")
    out = port_tests._IMPORT_LINE.sub(r"\1etcd_tpu_torch", src)
    assert out == src.replace("import etcd_tpu.", "import etcd_tpu_torch.") \
        .replace("from etcd_tpu.", "from etcd_tpu_torch.")
    assert "'etcd_tpu.native.storecore'" in out

    env0 = dict(os.environ)
    obs = port_tests.on_the_port("test_observability", cpu=True)
    eng = port_tests.on_the_port("test_engine", cpu=True)
    cfg = eng.make_cfg(tmp_path / "e")
    assert cfg.device == "cpu" and isinstance(cfg, engine.EngineConfig)
    assert dataclasses.replace(cfg, groups=2).device == "cpu"
    ns = {"__builtins__": obs.__builtins__}
    exec("def fixture():\n"
         "    from etcd_tpu_torch.server.engine import EngineConfig\n"
         "    from etcd_tpu_torch.server.hostengine import "
         "HostEngineConfig\n"
         "    return EngineConfig, HostEngineConfig\n", ns)
    E, H = ns["fixture"]()
    assert E(groups=2, peers=3, data_dir="d").device == "cpu"
    listen = ("127.0.0.1", 0)
    assert H(groups=2, peers=3, data_dir="d", host_id=0,
             frame_listen=listen).device == "cpu"
    m = eng.MultiEngine(cfg)
    try:
        assert m.device.type == "cpu" and m.st.term.device.type == "cpu"
    finally:
        m.stop()
    assert engine.EngineConfig(groups=2, peers=3, data_dir="d").device \
        == "cuda"
    assert hostengine.HostEngineConfig(groups=2, peers=3, data_dir="d",
                                       host_id=0, frame_listen=listen
                                       ).device == "cuda"
    assert os.environ == env0 and "MHE_DEVICE" not in os.environ
    child = obs.subprocess.Popen(
        [sys.executable, "-c", "import os; print(os.environ['MHE_DEVICE'],"
         " os.environ['ETCD_ENGINE_DEVICE'])"],
        stdout=subprocess.PIPE, text=True)
    assert child.communicate(timeout=60)[0].split() == ["cpu", "cpu"]
