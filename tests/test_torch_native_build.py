"""The port's C builds at first use (etcd_tpu_torch/native_build.py):
importing the package compiles native/*.c with cc into .native_build/
and places each library where the loaders import it. Checked on copies
of the package in a temporary directory: a changed source rebuilds,
four processes doing the first import at once load one library, a
source that does not compile raises, and with PATH emptied the Python
fallbacks load with one warning. In this checkout the three flags are
True without ./build."""
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("walcodec", "ingresscore", "storecore")

# Prints the three flags and, for each library, the inode it mapped.
PROBE = """
import json, os, sys
import etcd_tpu_torch.native as n, etcd_tpu_torch.store as s
mapped = {}
for line in open("/proc/self/maps"):
    path = line.split()[-1]
    for name in %r:
        if os.path.basename(path).startswith(name + ".") \\
                and path.endswith(".so"):
            mapped[name] = int(line.split()[4])
print(json.dumps({"flags": [n.HAVE_NATIVE, n.HAVE_NATIVE_INGRESS,
                            s.HAVE_NATIVE_STORE], "mapped": mapped}))
""" % (NAMES,)


def _copy(tmp_path):
    """The package alone, without built libraries, under tmp_path."""
    shutil.copytree(os.path.join(ROOT, "etcd_tpu_torch"),
                    tmp_path / "etcd_tpu_torch",
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    return tmp_path


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(kw)
    return env


def _probe(root, env=None):
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=root,
                         env=env or _env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout), res.stderr


def _installed(root, name):
    ext = sysconfig.get_config_var("EXT_SUFFIX")
    return root / "etcd_tpu_torch" / "native" / f"{name}{ext}"


def test_the_flags_are_true_here_without_build():
    import etcd_tpu_torch.native as n
    import etcd_tpu_torch.store as s
    from etcd_tpu_torch import native_build
    assert n.HAVE_NATIVE and n.HAVE_NATIVE_INGRESS and s.HAVE_NATIVE_STORE
    for name in NAMES:
        assert native_build.library_path(name).exists()
        assert native_build._current(name)


def test_a_changed_source_rebuilds(tmp_path):
    root = _copy(tmp_path)
    out, err = _probe(root)
    assert out["flags"] == [True] * 3 and err == ""
    builds = sorted(os.listdir(root / ".native_build"))
    first = _installed(root, "walcodec").read_bytes()
    src = root / "etcd_tpu_torch" / "native" / "walcodec.c"
    src.write_text(src.read_text() + "\nint walcodec_rebuilt = 1;\n")
    out, err = _probe(root)
    assert out["flags"] == [True] * 3 and err == ""
    after = sorted(os.listdir(root / ".native_build"))
    new = set(after) - set(builds)
    assert len(new) == 1 and new.pop().startswith("walcodec-")
    second = _installed(root, "walcodec").read_bytes()
    assert second != first and b"walcodec_rebuilt" in second
    for name in ("ingresscore", "storecore"):
        assert [b for b in after if b.startswith(name)] == \
            [b for b in builds if b.startswith(name)]


def test_four_processes_at_first_import_load_one_library(tmp_path):
    root = _copy(tmp_path)
    go = root / "go"
    code = (f"import os, time\n"
            f"while not os.path.exists({str(go)!r}): time.sleep(0.005)\n"
            + PROBE)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root,
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    time.sleep(1.0)               # every process waits at the line
    go.touch()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0 and err == "", err
        outs.append(json.loads(out))
    assert all(o["flags"] == [True] * 3 for o in outs)
    assert len(outs[0]["mapped"]) == 3
    assert all(o["mapped"] == outs[0]["mapped"] for o in outs), outs
    for name in NAMES:
        inode = os.stat(_installed(root, name)).st_ino
        assert outs[0]["mapped"][name] == inode
        assert len([b for b in os.listdir(root / ".native_build")
                    if b.startswith(name + "-")]) == 1
    left = [f for d, _, fs in os.walk(root) for f in fs if ".tmp" in f]
    assert left == []


def test_a_source_that_does_not_compile_raises(tmp_path):
    root = _copy(tmp_path)
    src = root / "etcd_tpu_torch" / "native" / "ingresscore.c"
    src.write_text(src.read_text() + "\nthis is not C;\n")
    res = subprocess.run([sys.executable, "-c", "import etcd_tpu_torch"],
                         cwd=root, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "RuntimeError: cc failed for ingresscore.c" in res.stderr


def test_without_a_compiler_the_fallbacks_load_with_one_warning(tmp_path):
    root = _copy(tmp_path)
    out, err = _probe(root, _env(PATH=""))
    assert out == {"flags": [False] * 3, "mapped": {}}
    lines = err.strip().splitlines()
    assert len(lines) == 1 and "no C compiler (cc) on PATH" in lines[0]
    assert not any(_installed(root, n).exists() for n in NAMES)
    # Once built, the libraries load with PATH emptied, and silently.
    _probe(root)
    out, err = _probe(root, _env(PATH=""))
    assert out["flags"] == [True] * 3 and err == ""


@pytest.mark.parametrize("what", ["flags", "suffix"])
def test_the_build_key_covers_the_flags_and_the_suffix(monkeypatch, what):
    """A library is keyed by its source (test_a_changed_source_rebuilds),
    the compiler flags and the interpreter's extension suffix: changing
    either gives every library another build directory."""
    from etcd_tpu_torch import native_build
    before = {n: native_build.library_path(n) for n in NAMES}
    if what == "flags":
        monkeypatch.setattr(native_build, "CFLAGS",
                            native_build.CFLAGS + ["-g"])
    else:
        monkeypatch.setattr(native_build, "EXT",
                            ".cpython-313-x86_64-linux-gnu.so")
    for name in NAMES:
        after = native_build.library_path(name)
        assert after.parent != before[name].parent
        assert after.parent.name.startswith(name + "-")
