"""The harness exits non-zero, printing nothing on standard output, where
there is no card, and in a directory that holds only BENCHMARK.json and
the harness."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["-m", "benchmark.run", "--workload", "mt100k-r5.steady", "--seed",
        "2147483659", "--seconds", "1", "--trace", "0"]


def run_in(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_no_card_no_result():
    p = run_in(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_in(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_rate_and_control_are_options_off_by_default():
    from benchmark import run
    a = run.parse(ARGS[2:])
    assert a.rate is None and not a.control
    a = run.parse(ARGS[2:] + ["--rate", "800", "--control"])
    assert a.rate == 800.0 and a.control
