"""BENCHMARK.json parses to the contract, every name it holds is found as
a file, and a cell, configuration, mix and metric are added by files and
entries alone."""
import json
import shutil
from pathlib import Path

import numpy as np

from benchmark import manifest, traffic

ROOT = Path(__file__).resolve().parents[2]


def doc():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_limits():
    d = doc()
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= d["run_seconds"] <= 51
    assert 1 <= len(d["paths"]) <= 16 and len(d["command"]) <= 32
    runs = 2 + 14 * 24
    assert runs * (d["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in d["paths"]))
        assert any(w["config"] == c["name"] for w in d["workloads"])
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in e2e
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in d["end_to_end"] + d["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_text_fields_fit():
    d = doc()
    texts = ([c["source"] for c in d["configs"]]
             + [c["why"] for c in d["configs"]]
             + [w["why"] for w in d["workloads"]]
             + [m["layer"] for m in d["per_layer"]] + d["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_every_name_is_found():
    man = manifest.Manifest(ROOT)
    for cell in man.cells.values():
        assert man.config(cell)["name"] == cell.config
        assert "rate_per_s" in man.traffic(cell)
        for trace in (False, True):
            for m in man.metrics_of(cell, trace):
                assert callable(man.reader(m.name))


def test_configs_state_their_guarantees():
    man = manifest.Manifest(ROOT)
    for cell in man.cells.values():
        cfg = man.config(cell)
        assert cfg["fsync"] is True
        assert cfg["quorum"] == cfg["peers"] // 2 + 1
        assert {"ack", "read_back"} <= set(cfg["guarantees"])


def test_malformed_name_is_refused(tmp_path):
    d = doc()
    d["workloads"][0]["name"] = "bad name"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))
    try:
        manifest.Manifest(tmp_path)
    except ValueError as e:
        assert "bad name" in str(e)
    else:
        raise AssertionError("a name with a space was accepted")


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A later change adds a configuration, a mix, a metric and a cell on
    four chips without editing a file that is there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    h = tmp_path / "benchmark"
    cfg = json.loads((h / "configs" / "mt100k-r5.json").read_text())
    cfg.update(name="mt10k-r5", groups=10000)
    (h / "configs" / "mt10k-r5.json").write_text(json.dumps(cfg))
    (h / "traffic" / "zipf.json").write_text(json.dumps(
        {"rate_per_s": 500, "warmup_s": 1, "tenants": "zipf",
         "faults": {"cut_leader_share": 0.1}}))
    (h / "metrics" / "acked_total.py").write_text(
        "def read(obs):\n    return float(obs['acked_in_window'])\n")
    d = doc()
    d["configs"].append({"name": "mt10k-r5", "source": "BASELINE.json "
                         "config 3", "file": "benchmark/configs/"
                         "mt10k-r5.json", "reduced": ["groups"],
                         "why": "Zipf tenants"})
    d["workloads"].append({"name": "mt10k-r5.zipf", "config": "mt10k-r5",
                           "traffic": "zipf", "chips": 4, "why": "skew"})
    d["per_layer"].append({"name": "acked_total", "unit": "writes",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine round loop",
                           "moves": "acked_writes_per_s",
                           "workloads": ["mt10k-r5.zipf"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(d))
    man = manifest.Manifest(tmp_path)
    cell = man.cell("mt10k-r5.zipf")
    assert cell.chips == 4
    names = [m.name for m in man.metrics_of(cell, True)]
    assert "acked_total" in names
    steady = man.cell("mt100k-r5.steady")
    assert "acked_total" not in [m.name for m in man.metrics_of(steady,
                                                                True)]
    p = traffic.plan(man.config(cell), man.traffic(cell), 3, 2.0)
    assert len(p.t_due) == 1500 and p.tenant.max() < 10000
    # The heaviest tenant of a Zipf mix draws far more than a uniform one.
    assert np.bincount(p.tenant).max() > 20
    assert man.reader("acked_total")({"acked_in_window": 7}) == 7.0
    lead = np.zeros(10000, np.int64)
    mask, cut = traffic.fault_mask(man.config(cell), man.traffic(cell), 3,
                                   lead)
    assert len(cut) == 1000 and (mask[cut, 0, :, 0] == 0).all()


def test_every_cell_reports_what_its_metrics_move():
    """Each cell reports `setup_s`, another end-to-end metric and a
    per-layer one, and every per-layer metric of a cell moves an
    end-to-end metric that the cell reports."""
    man = manifest.Manifest(ROOT)
    moves = {m["name"]: m["moves"] for m in doc()["per_layer"]}
    for cell in man.cells.values():
        e2e = {m.name for m in man.metrics_of(cell, False)}
        layer = [m.name for m in man.metrics_of(cell, True)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, cell.name
        for name in layer:
            assert moves[name] in e2e, (cell.name, name)
