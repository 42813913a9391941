"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, configurations
and metrics.  Everything else is a file of its own under ``benchmark/``:

- ``configs/<config>.json``: a configuration (the path ``BENCHMARK.json``
  gives), with its game's plain reference in ``reference/<game>.py`` and
  its bytes in ``roofline/<game>.py``;
- ``traffic/<traffic>.json``: a traffic mix, the parameters that
  ``traffic.py``'s one generator reads, and any keys its entry reads;
- ``entries/<entry>.py``: the session entry a mix names (``entry``), which
  drives the program's session kind and checks it;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

So a cell, a configuration, a session kind or a metric is added as new
files and new entries, and no existing file changes.

**The entry's contract.**  ``entries/<entry>.py`` defines ``Entry``, which
``program.entry`` loads by path from the cell's root and builds as
``Entry(config, traffic, start, device, advance)``: the configuration, the
raw traffic mix (every key, those the generator reads and those only this
entry reads), the start as int32 numpy leaves, the device, and the step
that replaces the game's ``advance`` (None: the game's own; the control and
the faults of ``variants.py`` plug in there).  It provides:

- ``call(rows) -> bool``: one closed-loop call on the call's ``(n, B, P)``
  input rows (``Traffic.call_inputs``), returning once its result is on the
  host; False where the program reported a failure;
- ``launch(rows)`` and ``read() -> bool``: ``call`` split at its read;
- ``warmup_calls``: the calls set-up makes so that nothing is built or
  captured in the window;
- ``sessions`` (B) and ``game`` (the configuration's game, whose lone
  advances the traced run times);
- ``resim_frames(calls) -> int``: the frames a window of ``calls`` calls
  resimulates, which ``resim_frames_per_s`` divides by the window's wall
  seconds.  It is fixed by the traffic and the configuration (SyncTest:
  B × d × ``ticks_per_call`` × calls), or it is a count of the program's
  that the entry's own check holds against the plain reference.  A count
  the program reports and nothing checks is not admissible: an entry whose
  rollbacks vary in depth with the network counts its frames so, checked;
- ``limits`` ({name: limit}) and ``check(reference, traffic, calls) ->
  {name: count}``: after the window, the program freed but for what it
  produced, the plain reference (``reference``, the game's module) run on
  the generator's inputs (``traffic``) over every call made, and each
  named count computed from the program's output and the reference's;
  ``check.verdict`` holds each to its limit;
- ``close()``: frees the program's device memory.
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
