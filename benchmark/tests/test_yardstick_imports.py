"""No module of the harness imports JAX, Flax or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: the program's name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

H = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "etcd_tpu"}
PROGRAM = "etcd_tpu_torch"


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in H.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(H)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_check_compares_whole_names():
    from benchmark import run
    assert "etcd_tpu" in run.FORBIDDEN and PROGRAM not in run.FORBIDDEN
    assert run.forbidden_modules() == [] or all(
        m.split(".")[0] in run.FORBIDDEN for m in run.forbidden_modules())


@pytest.mark.parametrize("name", ["reference.py", "traffic.py", "peaks.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert PROGRAM not in top_level_imports(H / name)
    if name == "reference.py":
        assert top_level_imports(H / name) <= {
            "__future__", "json", "os", "struct", "zlib", "dataclasses",
            "typing", "numpy"}
