"""A test module of the JAX package, loaded against the port; and
`loads_torch(pid)`, whether a process of the port mapped torch.

`on_the_port("test_server")` compiles tests/test_server.py with every
import line's `etcd_tpu` renamed `etcd_tpu_torch` (the rename that
tests/test_torch_imports.py allows between a verbatim copy and its
source) and returns it as a new module. Its tests, classes and fixtures
then run on the port's modules; a `test_torch_*.py` file takes the ones
it reruns into its own namespace, where pytest collects them. The
source file is not touched."""
import os
import re
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
_IMPORT_LINE = re.compile(r"^(\s*(?:from|import)\s+)etcd_tpu\b", re.M)


def on_the_port(name: str) -> types.ModuleType:
    path = os.path.join(HERE, name + ".py")
    with open(path) as f:
        src = _IMPORT_LINE.sub(r"\1etcd_tpu_torch", f.read())
    mod = types.ModuleType(f"{name}__on_the_port")
    mod.__file__ = path
    sys.modules[mod.__name__] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def loads_torch(pid) -> bool:
    """Whether process pid has torch's shared libraries mapped (a member,
    proxy or client process of the port must not)."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in ln for ln in f)
