"""The SyncTest tick's tracing, pinned on the CPU.

- Both entries (``BatchedSessions.run_ticks``, ``DeviceSyncTestSession.
  run_ticks``) emit one ``ggrs:tick`` span tree: ``upload``, ``warmup`` or
  ``replay``, the batch's ``reduce``, and ``read`` inside the tick with
  ``check=True`` or on its own in a later ``verify()``.
- An eager ``steady_body`` emits its seven ``ggrs:layer.*`` spans in the
  layers' order (the test's name is older: the tick had nine before its
  window was advanced into its ring slots).
- ``trace_span`` enters no ``record_function`` while no profiler runs.
- ``GraphSet``: a capture that takes marks keeps one mark node a ``layer``,
  disabled; ``Graph.replay`` enables them under a profiler and disables
  them after it (or holds them as ``pin_marks`` says), one call a mark and
  only on a change; the registry counts captures and replays by program.
  The capture and the marks' CUDA calls are stand-ins here; the card's
  own are ``tests/test_torch_layer_marks_card.py``.
- No span of the names the tree replaced is left in the port.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ggrs_tpu_torch import BatchedSessions, BoxGame, DeviceSyncTestSession, build_replay_programs
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.ops import graphs as graphs_mod
from ggrs_tpu_torch.ops import marks as layer_marks
from ggrs_tpu_torch.ops.replay import build_scrub_program
from ggrs_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parent.parent
D = 3
ORDER = ["advance", "digest", "ring", "compare", "advance", "digest", "ring"]


def _session(entry):
    game = BoxGame(2)
    if entry == "single":
        return DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                     check_distance=D, device="cpu")
    return BatchedSessions(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                           batch_size=3, check_distance=D, max_prediction=D, device="cpu")


def _tick(entry, t):
    rng = np.random.default_rng(t)
    shape = (1, 2) if entry == "single" else (3, 1, 2)
    return rng.integers(0, 16, size=shape).astype(np.uint8)


def _spans(prof, prefix="ggrs:"):
    """(name, start, end) of the profiler's ``ggrs:`` ranges, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(prefix)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _tree(spans):
    """Each ``ggrs:tick`` with its ``ggrs:tick.*`` children, and the
    ``ggrs:tick.*`` spans outside any tick."""
    ticks, alone = [], []
    for name, s, e in spans:
        if name == "ggrs:tick":
            ticks.append((s, e, []))
        elif name.startswith("ggrs:tick."):
            parent = [t for t in ticks if t[0] <= s and e <= t[1]]
            (parent[-1][2] if parent else alone).append(name[len("ggrs:tick."):])
    return [kids for _, _, kids in ticks], alone


@pytest.mark.parametrize("entry", ["single", "batched"])
def test_both_entries_emit_one_tick_tree(entry):
    sess = _session(entry)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.run_ticks(_tick(entry, 0), check=True)  # a warmup tick
        for t in range(1, D + 2):
            sess.run_ticks(_tick(entry, t), check=True)
    ticks, alone = _tree(_spans(prof))
    reduce = [] if entry == "single" else ["reduce"]
    assert ticks[0] == ["upload", "warmup", *reduce, "read"]
    assert ticks[-1] == ["upload", "replay", *reduce, "read"]
    assert alone == []


@pytest.mark.parametrize("entry", ["single", "batched"])
def test_a_deferred_check_reads_outside_the_tick(entry):
    sess = _session(entry)
    for t in range(D + 2):
        sess.run_ticks(_tick(entry, t), check=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.run_ticks(_tick(entry, 99), check=False)
        sess.verify()
    ticks, alone = _tree(_spans(prof))
    reduce = [] if entry == "single" else ["reduce"]
    assert ticks == [["upload", "replay", *reduce]]
    assert alone == ["read"]


def test_eager_steady_body_emits_the_nine_layers_in_order():
    game = BoxGame(2)
    progs = build_replay_programs(game.advance, ring_length=D + 1, check_distance=D)
    carry = progs.init_carry(game.init_state_np(), np.zeros(2, np.uint8), batch_size=2,
                             device="cpu")
    progs.run_warmup(carry, torch.zeros((2, D + 1, 2), dtype=torch.uint8), 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        progs.steady_body(carry, D + 1)
    layers = [name[len("ggrs:layer."):] for name, _, _ in _spans(prof, "ggrs:layer.")]
    assert layers == ORDER
    assert [n for n, _, _ in _spans(prof) if not n.startswith("ggrs:layer.")] == []


def test_trace_span_enters_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert not tracing.profiling()
    with tracing.trace_span("ggrs:tick"), tracing.layer("ring"):
        pass
    assert tracing.trace_span("a") is tracing.trace_span("b")  # one shared no-op
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.trace_span("ggrs:tick"), tracing.layer("compare"):
            pass
    assert entered == ["ggrs:tick", "ggrs:layer.compare"]


def test_layer_refuses_a_name_it_has_no_mark_for():
    with pytest.raises(ValueError, match="not one of"):
        tracing.layer("network")


class _Recorded:
    """A stand-in for a captured graph: replaying runs nothing."""

    def __init__(self):
        self.replayed = 0

    def raw_cuda_graph_exec(self):
        return 0xE8EC

    def replay(self):
        self.replayed += 1


@pytest.fixture
def stand_in(monkeypatch):
    """The capture and the marks' CUDA calls, replaced: the body runs
    once, eagerly, as a capture runs its Python; each mark launched gets a
    node number; ``calls`` records every (node, on) asked for."""
    state = {"launched": [], "calls": []}

    def record(graphs, body):
        body()
        return _Recorded()

    def launch(name, device):
        state["launched"].append(name)
        return 1000 + len(state["launched"])

    monkeypatch.setattr(graphs_mod, "_record", record)
    monkeypatch.setattr(layer_marks, "launch", launch)
    monkeypatch.setattr(layer_marks, "prime", lambda device: None)
    monkeypatch.setattr(layer_marks, "set_enabled",
                        lambda exec_handle, node, on: state["calls"].append((node, on)))
    return state


def _marked_tick_graph():
    game = BoxGame(2)
    progs = build_replay_programs(game.advance, ring_length=D + 1, check_distance=D)
    carry = progs.init_carry(game.init_state_np(), np.zeros(2, np.uint8), batch_size=2,
                             device="cpu")
    progs.run_warmup(carry, torch.zeros((2, D + 1, 2), dtype=torch.uint8), 0)
    graphs = graphs_mod.GraphSet(torch.device("cpu"), "replay", marks=True)
    return graphs, graphs.capture(lambda: progs.steady_body(carry, D + 1))


def test_a_marked_capture_keeps_a_disabled_mark_a_layer(stand_in):
    _, graph = _marked_tick_graph()
    assert stand_in["launched"] == ORDER
    assert graph.marks == tuple(range(1001, 1001 + len(ORDER)))
    assert stand_in["calls"] == [(n, False) for n in graph.marks]
    assert not graph.marks_on


def test_replays_flip_the_marks_only_when_the_profiler_does(stand_in):
    graphs, graph = _marked_tick_graph()
    calls = stand_in["calls"]
    calls.clear()
    graph.replay()
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        graph.replay()
        assert calls == [(n, True) for n in graph.marks] and graph.marks_on
        graph.replay()
        assert len(calls) == len(ORDER)
    graph.replay()
    assert calls[len(ORDER):] == [(n, False) for n in graph.marks] and not graph.marks_on
    graphs.pin_marks = True
    calls.clear()
    graph.replay()
    graph.replay()
    assert calls == [(n, True) for n in graph.marks]
    assert graph.graph.replayed == 6 and graphs.replays == 6


def test_a_capture_without_marks_launches_none(stand_in):
    graphs = graphs_mod.GraphSet(torch.device("cpu"), "executor")
    graph = graphs.capture(lambda: tracing.layer("ring").__enter__())
    assert stand_in["launched"] == [] and graph.marks == ()


def _value(name, program):
    return default_registry().value(name, program=program) or 0.0


def test_registry_counts_a_scrub_programs_captures_and_replays(stand_in):
    game = BoxGame(2)
    scrub = build_scrub_program(game.advance, device="cpu")
    before = (_value("ggrs_graph_captures_total", "scrub"),
              _value("ggrs_graph_replays_total", "scrub"))
    st, inputs = scrub._batched(game.init_state_np(), np.zeros((4, 2), np.uint8))
    graph = scrub._capture(st, inputs)[0]
    for _ in range(3):
        graph.replay()
    assert (scrub.captures, scrub.replays) == (1, 3)
    assert _value("ggrs_graph_captures_total", "scrub") - before[0] == 1
    assert _value("ggrs_graph_replays_total", "scrub") - before[1] == 3
    assert stand_in["launched"] == []  # the scrub's graphs take no marks


OLD_SPANS = re.compile(r"ggrs:(batch_ticks|synctest_\w+|replay_steady|replay_warmup)")


def test_no_span_of_the_replaced_names_is_left():
    files = [*(ROOT / "ggrs_tpu_torch").rglob("*.py"), *(ROOT / "scripts").glob("port_*.py"),
             ROOT / "chip_smoke.py"]
    left = [f"{p.relative_to(ROOT)}: {m.group(0)}" for p in files
            for m in OLD_SPANS.finditer(p.read_text())]
    assert left == []
