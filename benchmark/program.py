"""The system under test, found by name: a configuration's game and a
traffic mix's session entry.

A configuration names its game's class (``program.class``, a dotted path
into the port, and ``program.kwargs``); ``make_game`` builds it.  A traffic
mix's ``entry`` names a module, ``entries/<entry>.py`` under the cell's
root, whose ``Entry`` drives the port's session and checks what it produced
(the contract is in ``spec.py``); ``entry`` loads it.  This module and the
entries are the only modules of the benchmark that import the program
(``ggrs_tpu_torch``), but for the ``altered`` fault of ``variants.py``,
which replaces the port's digest.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional

import numpy as np

# imported with the harness, so the port loads before run.py makes the CUDA
# context, inside set-up's ``imports`` phase, whichever entry a cell names
import ggrs_tpu_torch  # noqa: F401
from benchmark import spec


def make_game(config: dict) -> Any:
    module, _, name = config["program"]["class"].rpartition(".")
    return getattr(importlib.import_module(module), name)(**config["program"].get("kwargs", {}))


def entry(cell: spec.Cell, traffic: dict, start: Dict[str, np.ndarray], device: str,
          advance: Optional[Callable] = None) -> Any:
    """The cell's session entry on ``device``, built from its configuration,
    the raw traffic mix ``traffic``, the start and the step that replaces the
    game's ``advance`` (None: the game's own)."""
    name = traffic["entry"]
    path = cell.root / "benchmark" / "entries" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"entry {name!r}: no file benchmark/entries/{name}.py")
    module = spec.load_module(path, f"benchmark_entry_{name}")
    return module.Entry(cell.config, traffic, start, device, advance)
