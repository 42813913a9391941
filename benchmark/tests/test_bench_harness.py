"""The harness on the CPU at small sizes: the result line's keys, the traced
run's readers, the control and the faults reading false, the SyncTest
entries' frame count, a cell added as a new entry, a session entry added as
a new file, and ``run.py``'s refusals."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness, spec, variants
from benchmark.tests.conftest import ROOT

# every cell of BENCHMARK.json, a batch cut to 4 sessions on the CPU
CELLS = [(w["name"], None if spec.load_cell(w["name"]).traffic["entry"] == "single" else 4)
         for w in spec.load_benchmark()["workloads"]]
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _run(name, sessions, traced=False, advance=None, seed=2**31 + 5, root=spec.ROOT):
    cell = spec.load_cell(name, root)
    return harness.run_cell(cell, seed, 0.3, traced, "cpu", time.perf_counter(),
                            sessions=sessions, advance=advance)


@pytest.mark.parametrize("name,sessions", CELLS, ids=[c[0] for c in CELLS])
def test_result_line_has_the_contracts_keys(name, sessions):
    line, lines = _run(name, sessions)
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in spec.load_cell(name).end_to_end}
    assert "setup_s" in line["metrics"] and len(line["metrics"]) == 3
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert lines[-1] == "check correct true"
    assert all(f"check {k} " in "\n".join(lines) for k in line["checks"])
    json.dumps(line)


@pytest.mark.parametrize("name,sessions", CELLS, ids=[c[0] for c in CELLS])
def test_traced_run_reads_the_split_pass(name, sessions):
    line, _ = _run(name, sessions, traced=True)
    assert line["correct"] is True
    # the CPU trace has no device operation: only the untraced split pass is read
    (enqueue,) = line["metrics"]
    assert enqueue.startswith("session.enqueue_us_per_tick")
    assert line["metrics"][enqueue]["value"] > 0
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


FAULTS = [(n, s, v) for n, s in CELLS for v in variants.NAMES if not (v == "half" and s is None)]


@pytest.mark.parametrize("name,sessions,variant", FAULTS,
                         ids=[f"{n}-{v}" for n, _, v in FAULTS])
def test_control_and_faults_read_not_correct(name, sessions, variant):
    cell = spec.load_cell(name)
    with variants.variant(variant, cell) as step:
        line, lines = _run(name, sessions, advance=step)
    assert line["correct"] is False
    assert lines[-1] == "check correct false"
    off = {k for k, v in line["checks"].items() if v["value"] > v["limit"]}
    assert off


def test_a_cell_is_a_new_entry(tmp_path):
    """``boxgame2-d8-b64``: an existing configuration under a new traffic
    mix, added as one new file and one new entry in BENCHMARK.json (and its
    name in the per-layer metrics' lists); no existing file of the
    benchmark changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    mix = dict(json.loads((ROOT / "benchmark" / "traffic" / "closed-b1.json").read_text()),
               entry="batched", sessions=64)
    (tmp_path / "benchmark" / "traffic" / "closed-b64.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "boxgame2-d8-b64", "config": "boxgame2-d8",
                               "traffic": "closed-b64", "chips": 1, "why": "a small host"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "boxgame2-d8-b1769472" in m.get("workloads", ()):
            m["workloads"].append("boxgame2-d8-b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "benchmark").rglob("*.py")}
    line, _ = _run("boxgame2-d8-b64", None, root=tmp_path)
    assert line["correct"] is True
    assert line["metrics"]["resim_frames_per_s"]["value"] > 0
    traced, _ = _run("boxgame2-d8-b64", None, traced=True, root=tmp_path)
    assert "session.enqueue_us_per_tick" in traced["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("name,sessions", CELLS, ids=[c[0] for c in CELLS])
def test_synctest_entries_count_b_d_ticks(name, sessions, n):
    """Every SyncTest tick rolls back d frames in each of B sessions, at one
    tick a call and at eight (a dispatch-ahead mix)."""
    cell = spec.load_cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, ticks_per_call=n))
    run = harness.Run(cell, 2**31 + 9, "cpu", sessions, None, [])
    b, d = run.traffic.sessions, cell.config["check_distance"]
    assert run.program.sessions == b == (sessions or cell.traffic["sessions"])
    for calls in (0, 1, 7, 3061):
        assert run.program.resim_frames(calls) == b * d * n * calls
    run.program.close()


# a batched SyncTest entry of another name: it reads a key of its own in
# its mix, counts the frames of part of the batch, and adds a check count
NEW_ENTRY = '''"""Entry ``batched_part``: the batched entry, its frames counted over
``counted_sessions`` of its sessions, its check adding the sessions whose
frame counter is not the ticks run."""

import torch

from benchmark.entries import batched


class Entry(batched.Entry):
    limits = dict(batched.Entry.limits, frame_rows_off=0)

    def __init__(self, config, traffic, start, device, advance=None):
        super().__init__(config, traffic, start, device, advance)
        self.counted = int(traffic["counted_sessions"])

    def resim_frames(self, calls):
        return self.counted * self.check_distance * self.ticks_per_call * calls

    def check(self, reference, traffic, calls):
        frames = self.sess.carry["frame"].to("cpu", torch.int64)
        off = int((frames != calls * self.ticks_per_call).sum())
        return dict(super().check(reference, traffic, calls), frame_rows_off=off)
'''


def test_an_entry_is_a_new_file(tmp_path, monkeypatch):
    """``boxgame2-d8-part``: a session entry of its own, added as a new
    module under ``entries/``, a new traffic mix carrying a key only that
    entry reads, and one new workload in BENCHMARK.json (and its name in the
    metrics' lists); the run finds the entry by name in its own checkout,
    reports its check counts and divides its frame count by the window, and
    no existing file of the benchmark changes."""
    copy = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", copy, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    (copy / "entries" / "batched_part.py").write_text(NEW_ENTRY)
    mix = dict(json.loads((ROOT / "benchmark" / "traffic" / "closed-b1.json").read_text()),
               entry="batched_part", sessions=8, counted_sessions=3)
    (copy / "traffic" / "closed-part.json").write_text(json.dumps(mix))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "boxgame2-d8-part", "config": "boxgame2-d8",
                               "traffic": "closed-part", "chips": 1, "why": "a new entry"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "boxgame2-d8-b1769472" in m.get("workloads", ()):
            m["workloads"].append("boxgame2-d8-part")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "benchmark").rglob("*.py")}
    windows = []
    real_window = harness.Run.window

    def window(run, seconds):
        times, window_s = real_window(run, seconds)
        windows.append(window_s)
        return times, window_s

    monkeypatch.setattr(harness.Run, "window", window)
    line, lines = _run("boxgame2-d8-part", None, root=tmp_path)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == {"live_rows_off", "ring_rows_off", "digest_rows_off",
                                   "frame_rows_off"}
    assert line["checks"]["frame_rows_off"] == {"value": 0, "limit": 0}
    assert "check frame_rows_off 0 limit 0" in lines
    rate = line["metrics"]["resim_frames_per_s"]["value"]
    assert rate == pytest.approx(3 * 8 * line["attempted"] / windows[0], rel=1e-12)
    traced, _ = _run("boxgame2-d8-part", None, traced=True, root=tmp_path)
    assert traced["correct"] is True and "frame_rows_off" in traced["checks"]
    assert "session.enqueue_us_per_tick" in traced["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())
    assert not (ROOT / "benchmark" / "entries" / "batched_part.py").exists()
    added = {p.relative_to(copy) for p in copy.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts and not (ROOT / "benchmark" / p.relative_to(copy)).exists()}
    assert added == {Path("entries/batched_part.py"), Path("traffic/closed-part.json")}


def _command(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(["--workload", "boxgame2-d8-b1", "--seed", "1", "--seconds", "1"], ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_run_fails_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _command(["--workload", "boxgame2-d8-b1", "--seed", "1", "--seconds", "1"], tmp_path)
    assert out.returncode != 0 and out.stdout == ""
