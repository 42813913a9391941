"""The steady tick's layer marks on the card.

Each CUDA graph of the replay's steady tick holds seven mark kernels
(``ggrs_mark_<layer>``, ``csrc/digest.cu``), one where each stretch of a
layer's work begins (``ops/replay.py::steady_body``).  Pinned here: after
capture every mark node is disabled; the marks are enabled while a profiler
runs and disabled again after it; a traced replay runs them in the
layers' order; and the carry after two ring periods is bitwise that of the
same session whose graphs hold no marks.

Every test needs a CUDA card and skips without one.  ``tests/conftest.py``
imports JAX, which the card's machine does not have, so run this file there
on its own:

    python -m pytest tests/test_torch_layer_marks_card.py --noconftest -q
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ggrs_tpu_torch import BatchedSessions, BoxGame, DeviceSyncTestSession
from ggrs_tpu_torch.ops import graphs as graphs_mod
from ggrs_tpu_torch.ops import marks as layer_marks
from ggrs_tpu_torch.ops import replay as replay_mod
from ggrs_tpu_torch.utils.tree import tree_leaves

D = 8
ORDER = ["advance", "digest", "ring", "compare", "advance", "digest", "ring"]
ENTRIES = {"single": 1, "batched": 4096}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the marks are kernels in the tick's CUDA graphs")
    return torch.device("cuda", torch.cuda.current_device())


def _session(entry, device):
    game = BoxGame(2)
    if entry == "single":
        return DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                     check_distance=D, max_prediction=D, device=device)
    return BatchedSessions(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                           batch_size=ENTRIES[entry], check_distance=D, max_prediction=D,
                           device=device)


def _inputs(entry, ticks):
    rng = np.random.default_rng(2**31 + 21)
    if entry == "single":
        return rng.integers(0, 16, size=(ticks, 2)).astype(np.uint8)
    return rng.integers(0, 16, size=(ENTRIES[entry], ticks, 2)).astype(np.uint8)


def _ticks(entry, sess, inputs, lo, hi):
    for t in range(lo, hi):
        chunk = inputs[t:t + 1] if entry == "single" else inputs[:, t:t + 1]
        sess.run_ticks(chunk, check=True)


def _tick_graphs(sess):
    (tick_graphs,) = sess.programs.tick_graphs
    return list(tick_graphs.graphs.values())


def _enabled(graph):
    exec_handle = graph.graph.raw_cuda_graph_exec()
    return [layer_marks.enabled(exec_handle, node) for node in graph.marks]


def _warm(entry, device):
    """A session past its warmup and one ring period: every phase's graph
    captured."""
    sess = _session(entry, device)
    r = sess.programs.ring.length
    inputs = _inputs(entry, D + 1 + 4 * r)
    _ticks(entry, sess, inputs, 0, D + 1 + r)
    return sess, inputs, D + 1 + r


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_mark_nodes_are_disabled_after_capture(card, entry):
    sess, _, _ = _warm(entry, card)
    graphs = _tick_graphs(sess)
    assert len(graphs) == sess.programs.ring.length
    for g in graphs:
        assert len(g.marks) == len(ORDER)
        assert not g.marks_on and _enabled(g) == [False] * len(ORDER)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_marks_follow_the_profiler(card, entry):
    sess, inputs, at = _warm(entry, card)
    r = sess.programs.ring.length
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _ticks(entry, sess, inputs, at, at + r)
        torch.cuda.synchronize()
        for g in _tick_graphs(sess):
            assert g.marks_on and _enabled(g) == [True] * len(ORDER)
    _ticks(entry, sess, inputs, at + r, at + 2 * r)
    for g in _tick_graphs(sess):
        assert not g.marks_on and _enabled(g) == [False] * len(ORDER)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_traced_replay_runs_the_marks_in_layer_order(card, entry, tmp_path):
    sess, inputs, at = _warm(entry, card)
    traced = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _ticks(entry, sess, inputs, at, at + traced)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"),
                     key=lambda e: float(e["ts"]))
    marks = [e["name"][len("ggrs_mark_"):] for e in kernels
             if e["name"].startswith("ggrs_mark_")]
    assert marks == ORDER * traced


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_marks_leave_the_carry_bitwise(card, entry, monkeypatch):
    sess = _session(entry, card)
    r = sess.programs.ring.length
    ticks = D + 1 + 2 * r
    inputs = _inputs(entry, ticks)
    _ticks(entry, sess, inputs, 0, D + 1 + r)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _ticks(entry, sess, inputs, D + 1 + r, ticks)  # a period with the marks on
    torch.cuda.synchronize()
    # the same session, its tick's graphs captured without marks
    monkeypatch.setattr(replay_mod, "GraphSet",
                        lambda device, program, marks=False: graphs_mod.GraphSet(device, program))
    twin = _session(entry, card)
    _ticks(entry, twin, inputs, 0, ticks)
    assert all(not g.marks for g in _tick_graphs(twin))
    got, want = tree_leaves(sess.carry), tree_leaves(twin.carry)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
