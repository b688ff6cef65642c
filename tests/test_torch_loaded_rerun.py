"""tests/loaded_rerun.py, the loop that reruns node ids beside busy
processes: it counts every run and each node id's outcomes exactly."""
import json
import subprocess
import sys

import loaded_rerun


def test_the_loop_counts_each_runs_outcomes(tmp_path):
    (tmp_path / "test_x.py").write_text(
        "def test_ok():\n    pass\n\n\ndef test_bad():\n    assert 0\n")
    lines = []
    got = loaded_rerun.run(["test_x.py"], root=str(tmp_path), rounds=2,
                           copies=2, busy=1, emit=lines.append)
    assert got == {"runs": 4, "runs_failed": 4,
                   "by_test": {"test_x.py::test_bad": {"FAILED": 4},
                               "test_x.py::test_ok": {"PASSED": 4}}}
    runs = [json.loads(line) for line in lines]
    assert sorted((r["round"], r["copy"]) for r in runs) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["rc"] == 1 for r in runs)
    assert all(r["why"]["test_x.py::test_bad"].startswith("assert 0")
               for r in runs)


def test_the_cli_exits_0_when_every_run_passes(tmp_path):
    (tmp_path / "test_y.py").write_text("def test_ok():\n    pass\n")
    p = subprocess.run(
        [sys.executable, loaded_rerun.__file__, "test_y.py", "--root",
         str(tmp_path), "--rounds", "1", "--copies", "2", "--busy", "0"],
        capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    summary = json.loads(p.stdout.splitlines()[-1])
    assert summary == {"runs": 2, "runs_failed": 0,
                       "by_test": {"test_y.py::test_ok": {"PASSED": 2}}}
