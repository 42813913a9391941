"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics.  Everything else is a file of its own under ``benchmark/``:

- ``configs/<config>.json``: a configuration (the path ``BENCHMARK.json``
  gives), with its game's plain reference in ``reference/<game>.py`` and
  its bytes in ``roofline/<game>.py``;
- ``traffic/<traffic>.json``: a traffic mix, the parameters that
  ``traffic.py``'s one generator reads;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

So a cell, a configuration or a metric is added as new files and new
entries, and no existing file changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    @property
    def game(self) -> str:
        return self.config["game"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, root)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file of its own (metric readers have dots in their
    names, so they are loaded by path, not imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(cell: Cell, metric: str) -> ModuleType:
    return load_module(cell.root / "benchmark" / "metrics" / f"{metric}.py",
                       f"benchmark_metric_{metric.replace('.', '_')}")


def game_module(cell: Cell, kind: str) -> ModuleType:
    """``reference/<game>.py`` or ``roofline/<game>.py`` of the cell's game."""
    return importlib.import_module(f"benchmark.{kind}.{cell.game}")
