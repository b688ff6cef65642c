"""`BENCHMARK.json` and the files it names, found by name:

- a configuration: the `file` its entry gives (under `benchmark/configs/`);
- a traffic mix: `benchmark/traffic/<traffic>.json`;
- a metric, end to end or per layer: its reader
  `benchmark/metrics/<name>.py`, whose `read(obs)` returns the number, or
  None where the run holds nothing for it to read.

A cell, a configuration, a mix or a metric is added by adding files and
entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
HARNESS = "benchmark"


@dataclass
class Metric:
    name: str
    unit: str
    end_to_end: bool
    workloads: Optional[List[str]]

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    config: str
    traffic: str
    chips: int


class Manifest:
    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.cells = {w["name"]: Cell(w["name"], w["config"], w["traffic"],
                                      int(w["chips"]))
                      for w in self.doc["workloads"]}
        self.metrics = [
            Metric(m["name"], m["unit"], e2e, m.get("workloads"))
            for key, e2e in (("end_to_end", True), ("per_layer", False))
            for m in self.doc[key]]
        self._check_names()

    def _check_names(self) -> None:
        names = (list(self.configs) + list(self.cells)
                 + [m.name for m in self.metrics]
                 + [c.traffic for c in self.cells.values()]
                 + [k for c in self.configs.values() for k in c["reduced"]])
        bad = [n for n in names if not NAME.match(n)]
        bad += [m.unit for m in self.metrics if not UNIT.match(m.unit)]
        if bad:
            raise ValueError(f"BENCHMARK.json: malformed names {bad}")
        for c in self.cells.values():
            if c.config not in self.configs:
                raise ValueError(f"cell {c.name}: no configuration "
                                 f"{c.config!r}")

    def cell(self, name: str) -> Cell:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(self.cells)})")
        return self.cells[name]

    def config(self, cell: Cell) -> dict:
        return json.loads(
            (self.root / self.configs[cell.config]["file"]).read_text())

    def traffic(self, cell: Cell) -> dict:
        return json.loads((self.root / HARNESS / "traffic"
                           / f"{cell.traffic}.json").read_text())

    def metrics_of(self, cell: Cell, trace: bool) -> List[Metric]:
        """The end-to-end metrics of the cell (trace off) or its
        per-layer ones (trace on)."""
        return [m for m in self.metrics
                if m.end_to_end != trace and m.applies(cell.name)]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = self.root / HARNESS / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"{HARNESS}_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def read_metrics(self, cell: Cell, trace: bool,
                     obs: dict) -> Dict[str, dict]:
        out = {}
        for m in self.metrics_of(cell, trace):
            v = self.reader(m.name)(obs)
            if v is not None:
                out[m.name] = {"value": v, "unit": m.unit}
        return out
