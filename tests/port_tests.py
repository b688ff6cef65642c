"""A test module of the JAX package, loaded against the port; and
`loads_torch(pid)`, whether a process of the port mapped torch.

`on_the_port("test_server")` compiles tests/test_server.py with every
import line's `etcd_tpu` renamed `etcd_tpu_torch` (the rename that
tests/test_torch_imports.py allows between a verbatim copy and its
source; indented imports inside functions and fixtures too) and returns
it as a new module. Its tests, classes and fixtures then run on the
port's modules; a `test_torch_*.py` file takes the ones it reruns into
its own namespace, where pytest collects them. The source file is not
touched.

`on_the_port(name, cpu=True)` also binds the module to the CPU, without
touching the port's defaults (`EngineConfig.device`,
`HostEngineConfig.device` and the launchers stay "cuda"):
- every `from etcd_tpu_torch.server.engine import ...` (or
  `.hostengine`) that the module's code runs, at its top or inside a
  test or fixture, gets `EngineConfig` / `HostEngineConfig` as a
  subclass whose `device` defaults to "cpu" (`CPU_CONFIGS`);
- `subprocess.Popen` in its namespace gives every child it starts
  `MHE_DEVICE=cpu` (the multi-host launcher and supervisor) and
  `ETCD_ENGINE_DEVICE=cpu` (the CLI's `--engine-device`), unless the
  test set them.
A child that builds an engine from source text is the mirror's to bind
(tests/test_torch_observability_ref.py does).

`on_the_port(name, helpers=("raft_fixtures",))` also gives the module
the port's copy of each named helper module of tests/: its
`from tests.raft_fixtures import ...` (or `from raft_fixtures import
...`) lines import `on_the_port("raft_fixtures")` instead, so the
fixtures it builds are the port's too. The JAX package's own import of
the helper is not touched."""
import builtins
import dataclasses
import importlib
import os
import re
import subprocess as _subprocess
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
_IMPORT_LINE = re.compile(r"^(\s*(?:from|import)\s+)etcd_tpu\b", re.M)

# module -> the config class whose device a CPU-bound rerun defaults to
# "cpu".
CPU_CONFIGS = {"etcd_tpu_torch.server.engine": "EngineConfig",
               "etcd_tpu_torch.server.hostengine": "HostEngineConfig"}
CHILD_ENV = {"MHE_DEVICE": "cpu", "ETCD_ENGINE_DEVICE": "cpu"}


def _cpu_config(cls):
    return dataclasses.dataclass(type(cls.__name__, (cls,), {
        "__annotations__": {"device": str}, "device": "cpu",
        "__module__": cls.__module__, "__qualname__": cls.__qualname__}))


_views: dict = {}


def cpu_view(modname: str) -> types.ModuleType:
    """The port module `modname` as a CPU-bound rerun sees it: the real
    module's attributes, with its config class defaulting to "cpu"."""
    if modname not in _views:
        real = importlib.import_module(modname)
        view = types.ModuleType(modname)
        view.__dict__.update(real.__dict__)
        cls = CPU_CONFIGS[modname]
        setattr(view, cls, _cpu_config(getattr(real, cls)))
        _views[modname] = view
    return _views[modname]


def _cpu_import(name, globals=None, locals=None, fromlist=(), level=0):
    mod = builtins.__import__(name, globals, locals, fromlist, level)
    if level == 0 and fromlist and name in CPU_CONFIGS:
        return cpu_view(name)
    return mod


class _CpuSubprocess(types.ModuleType):
    """`subprocess` whose Popen puts CHILD_ENV in every child's
    environment, unless the caller set the variable."""

    def __init__(self):
        super().__init__("subprocess")
        self.__dict__.update(_subprocess.__dict__)

        def Popen(*a, env=None, **kw):
            env = dict(os.environ if env is None else env)
            for k, v in CHILD_ENV.items():
                env.setdefault(k, v)
            return _subprocess.Popen(*a, env=env, **kw)

        self.Popen = Popen


def on_the_port(name: str, cpu: bool = False,
                helpers: tuple = ()) -> types.ModuleType:
    path = os.path.join(HERE, name + ".py")
    with open(path) as f:
        src = _IMPORT_LINE.sub(r"\1etcd_tpu_torch", f.read())
    for h in helpers:
        port_h = on_the_port(h, cpu=cpu).__name__
        src = re.sub(rf"^(\s*from\s+)(?:tests\.)?{h}(\s+import\b)",
                     rf"\g<1>{port_h}\2", src, flags=re.M)
    mod = types.ModuleType(f"{name}__on_the_port")
    mod.__file__ = path
    if cpu:
        mod.__builtins__ = dict(builtins.__dict__, __import__=_cpu_import)
    sys.modules[mod.__name__] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    if cpu and "subprocess" in mod.__dict__:
        mod.subprocess = _CpuSubprocess()
    return mod


def loads_torch(pid) -> bool:
    """Whether process pid has torch's shared libraries mapped (a member,
    proxy or client process of the port must not)."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in ln for ln in f)
