"""On the card: one short run of each cell reads correct, and the control
reads not correct at a size a test run holds.  Skipped without a card."""

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness, spec, variants
from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                          "--seed", str(2**31 + 17), "--seconds", "2"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("name,sessions", [
    (n, None if spec.load_cell(n).traffic["entry"] == "single" else 256) for n in CELLS])
def test_control_reads_not_correct(card, name, sessions):
    cell = spec.load_cell(name)
    with variants.variant("control", cell) as step:
        line, _ = harness.run_cell(cell, 23, 1.0, False, card, time.perf_counter(),
                                   sessions=sessions, advance=step)
    assert line["correct"] is False
