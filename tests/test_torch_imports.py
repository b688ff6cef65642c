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
            "server/security.py", "etcdhttp/web.py", "etcdhttp/client.py",
            "etcdhttp/client_security.py", "server/batchframe.py",
            "etcdhttp/tenants.py", "server/ingress.py",
            "parallel/frames.py"]

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
            "print('\\n'.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert "etcd_tpu_torch.server.engine" in out
    assert "etcd_tpu_torch.server.hostengine" in out
    assert "etcd_tpu_torch.tools.multihost_supervisor" in out
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
    theirs = open(os.path.join(ROOT, "etcd_tpu", rel)).read().splitlines()
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs), 1):
        if a != b:
            assert _IMPORT_LINE.sub(r"\1etcd_tpu", a) == b, f"{rel}:{i}"


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


def test_host_engine_and_launcher_default_to_the_card():
    """HostEngineConfig.device and the launcher's MHE_DEVICE default to
    "cuda", and the data plane to "collective" (as in the JAX package);
    without a card the engine refuses before the data dir. A collective
    HostEngine on the CPU constructs on a one-rank gloo process group,
    holding its own column only."""
    import socket

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
