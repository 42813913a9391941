"""Speculation's and the prediction plane's CUDA graphs, pinned on the CPU.

On the card ``SpeculativeRollback``'s programs
(``parallel.spec_rollback.SpecGraphs``), ``build_speculation_programs``'
five programs (``parallel.speculation.BranchGraphs``) and
``DevicePredictionPlane.begin_tick``'s kernel (``ops.graphs.KeyedGraphs``)
are CUDA graph replays.  All of their route but the capture and the replay
is plain PyTorch: the keys, the one upload of inputs, hypotheses and device
indices, the static buffers, the bodies over them, the clones out.  Here
that route runs on CPU tensors: each test hands a CPU object the graph
object the package makes for a CUDA device, and replaces
``ops.graphs._record`` (the capture) with a stand-in whose "graph" runs the
captured body again at each replay, as ``test_torch_request_graph.py``
does.  These bodies write the window in place, so the stand-in's capture
runs the body's Python as a capture does (the digest launches it records
are counted) but, like a capture, changes no tensor: every op that writes
an existing tensor is skipped.  Nothing in the package selects the
stand-in.

Every result is held against the JAX package (``SpeculativeRollback``,
``build_speculation_programs``, ``DevicePredictionPlane``, run as
``tests/test_spec_rollback.py`` and ``tests/test_parallel.py`` run them),
against the eager route, and against the hit and miss counts each case
states, leaf for leaf: tolerance exactly 0, since the games, the digest and
the predictors are integer math.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ggrs_tpu.predict as jpredict

import ggrs_tpu_torch.predict as tpredict
from ggrs_tpu_torch.ops import digest as tdg
from ggrs_tpu_torch.ops import graphs as graphs_mod
from ggrs_tpu_torch.ops.graphs import KeyedGraphs
from ggrs_tpu_torch.parallel import spec_rollback as spec_mod
from ggrs_tpu_torch.parallel.spec_rollback import SpecGraphs
from ggrs_tpu_torch.parallel.speculation import BranchGraphs
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_prediction_plane as tpp
from test_torch_checksum import _emulated_launch, _FakeCuda
from test_torch_request_graph import _graphed as _graphed_programs
from test_torch_request_graph import _Replayer
from test_torch_speculation import (
    PKGS,
    _advance1,
    _assert_states_equal,
    _four_peer_drive,
    _init,
    _mk_spec,
    _no_device_reads,
    _np,
)

CPU = torch.device("cpu")
ROUTES = ("jax", "eager", "graph")
MISS = 15  # player 1's input that no branch hypothesizes (CANDIDATES)


class _NoWrites(TorchDispatchMode):
    """Runs every op but those that write a tensor they are given (in
    place, or ``out=``): those return their targets untouched."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        written = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                written.append(kwargs[a.name] if a.name in kwargs else args[i])
        if written:
            return written[0] if len(written) == 1 else tuple(written)
        return func(*args, **kwargs)


@pytest.fixture
def stand_in(monkeypatch):
    """Replace the capture: the body's Python runs once under ``_NoWrites``
    (its digest launches counted, no tensor changed), and the "graph"
    replays the body.  Yields the captured bodies."""
    bodies = []

    def record(graphs, body):
        with _NoWrites():
            body()
        if graphs.pool is None:
            graphs.pool = ("stand-in pool", id(graphs))
        bodies.append(body)
        return _Replayer(body)

    monkeypatch.setattr(graphs_mod, "_record", record)
    return bodies


def _game(route):
    return PKGS["jax" if route == "jax" else "port"].games.BoxGame(2)


def _spec(route, game, K=4, **kw):
    spec = _mk_spec("jax" if route == "jax" else "port", game, K=K, **kw)
    if route == "graph":
        spec._graphs = SpecGraphs(spec)
    return spec


def _state(route, game):
    return _init("jax" if route == "jax" else "port", game)


def _adv(route, game, state, inputs):
    return _advance1("jax" if route == "jax" else "port", game, state, inputs)


def _window(spec):
    """What the host and the window hold: anchor, length, hits, branch
    states and the window's valid rows."""
    n = spec.window
    return {"root": spec.root_frame, "count": n, "hits": spec.hits,
            "states": None if spec._states is None else _np(spec._states),
            "traj": {k: v[:n] for k, v in _np(spec._traj_buf).items()},
            "inp": _np(spec._inp_buf)[:n], "prefix": _np(spec._prefix_buf)[:n]}


def _assert_windows_equal(a, b, msg=""):
    assert (a["root"], a["count"], a["hits"]) == (b["root"], b["count"], b["hits"]), msg
    for key in ("states", "traj"):
        if a[key] is None or b[key] is None:
            assert a[key] is b[key] is None, f"{msg} {key}"
        else:
            _assert_states_equal(a[key], b[key], f"{msg} {key}")
    for key in ("inp", "prefix"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"{msg} {key}")


def _assert_out_equal(a, b, msg=""):
    """Two fulfil results: (steps, sums[, live]) in any package."""
    assert len(a) == len(b), msg
    assert len(a[0]) == len(b[0]), msg
    for t, (x, y) in enumerate(zip(a[0], b[0])):
        _assert_states_equal(x, y, f"{msg} step {t}")
    assert (a[1] is None) == (b[1] is None), msg
    if a[1] is not None:
        for t, (x, y) in enumerate(zip(a[1], b[1])):
            np.testing.assert_array_equal(_np(x).view(np.uint32), _np(y).view(np.uint32),
                                          err_msg=f"{msg} digest {t}")
    if len(a) == 3:
        _assert_states_equal(a[2], b[2], f"{msg} live")


def _seq(count, p1=1):
    """Session inputs a frame: player 0 varies, player 1 holds ``p1``
    (CANDIDATES[1] = 1: branch 1 hypothesizes the session exactly)."""
    return [np.asarray([i % 5, p1], np.uint8) for i in range(count)]


# -- extend and advance_and_extend: one graph for every window row -----------


@pytest.mark.parametrize("live", [False, True])
def test_extension_rows_match_jax_and_eager(stand_in, live):
    seq = _seq(8)
    seq[3] = np.asarray([2, MISS], np.uint8)  # a row no branch matches: prefixes drop
    windows, lives = {}, {}
    for route in ROUTES:
        game = _game(route)
        spec = _spec(route, game)
        state = _state(route, game)
        spec.root(0, state)
        trail = []
        for x in seq[:6]:
            if live:
                state = spec.advance_and_extend(state, x)
                trail.append(state)
            else:
                spec.extend(x)
        windows[route], lives[route] = _window(spec), trail
        if route == "graph":
            g = spec.graphs()
            assert (g.captures, g.replays) == (1, 6)  # the row is an input, not a key
    for route in ("eager", "graph"):
        _assert_windows_equal(windows[route], windows["jax"], route)
        for t, (a, b) in enumerate(zip(lives[route], lives["jax"])):
            _assert_states_equal(a, b, f"{route} live {t}")
    assert windows["graph"]["prefix"][:, 1].tolist() == [True] * 3 + [False] * 3


# -- the fused rollback tick at an offset and row of its own ------------------


def _two_fused_ticks(route, n, live, case):
    """Root at 0 and advance six frames; the fused tick at offset 0 (which
    captures its key); advance again until all eight rows are valid; then
    the same key at a later offset and other window rows.  ``case`` makes
    the second tick hit, miss (a confirmed input no branch holds) or miss
    through the prefix (the session ran such an input between the root and
    the tick).  Returns the spec, both ticks' results and the row count the
    first left."""
    game = _game(route)
    spec = _spec(route, game)
    seq = _seq(24)
    state = _state(route, game)
    frames = {0: state}
    spec.root(0, state)
    for f in range(6):
        state = spec.advance_and_extend(state, seq[f])
        frames[f + 1] = state
    first = spec.fulfill_and_refill(0, seq[0:n], frames[0], True,
                                    live_inputs=seq[n] if live else None)
    # steps[t] is frame t + 1; the live state frame n + 1
    frames = {1 + t: s for t, s in enumerate(first[0])}
    state = first[2] if live else first[0][-1]
    root, rows = spec.root_frame, spec.window
    offset = 2
    if case == "prefix":
        seq[root + rows] = np.asarray([seq[root + rows][0], MISS], np.uint8)
        offset = rows + 1
    while spec.window < 8:
        f = root + spec.window
        state = spec.advance_and_extend(state, seq[f])
        frames[f + 1] = state
    confirmed = [x.copy() for x in seq[root + offset:root + offset + n]]
    if case == "miss":
        confirmed[-1][1] = MISS
    live_in = seq[root + offset + n] if live else None
    second = spec.fulfill_and_refill(root + offset, confirmed, frames[root + offset], True,
                                     live_inputs=live_in)
    return spec, [first, second], rows


@pytest.mark.parametrize("case", ["hit", "miss", "prefix"])
@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("n", [1, 3])
def test_fused_tick_at_another_offset_and_row(stand_in, n, live, case):
    runs = {route: _two_fused_ticks(route, n, live, case) for route in ROUTES}
    for route in ("eager", "graph"):
        for k, (a, b) in enumerate(zip(runs[route][1], runs["jax"][1])):
            _assert_out_equal(a, b, f"{route} tick {k}")
        _assert_windows_equal(_window(runs[route][0]), _window(runs["jax"][0]), route)
    # the first tick hits (branch 1 is the session); the second as stated
    spec, _, rows = runs["graph"]
    assert spec.hits == runs["eager"][0].hits == (2 if case == "hit" else 1)
    g = spec.graphs()
    # advance_and_extend and the fused key, each one graph: the second tick
    # replays the first one's graph at its own offset and rows
    assert (g.captures, g.replays) == (2, 6 + 1 + (8 - rows) + 1)


# -- warmup, then the live window ---------------------------------------------


def _live_window(spec, route, game, state):
    """A live window after whatever came before: root, five advances, a
    fused tick at offset 1, three more advances, a plain fulfil, a resolve."""
    seq = _seq(16)
    spec.root(4, state)
    lives = [state]
    for f in range(5):
        lives.append(spec.advance_and_extend(lives[-1], seq[f]))
    out = [spec.fulfill_and_refill(5, seq[1:4], lives[1], True, live_inputs=seq[4])]
    live = out[0][2]
    for x in seq[5:8]:
        live = spec.advance_and_extend(live, x)
    # frame f's session input is seq[f - 4]; the window is rooted at 6
    root = spec.root_frame
    out.append(spec.fulfill(root + 1, seq[3:5], out[0][0][1], True))
    traj = spec.resolve(root, seq[2:5])
    return out, live, traj


@pytest.mark.parametrize("when", ["before", "mid"])
def test_warmup_then_live_window(stand_in, when):
    # the graphs read and write the window's own buffers: a warmup that
    # swapped them for scratch ones would leave every graph it captured on
    # memory the live window no longer uses
    results = {}
    for route in ROUTES:
        game = _game(route)
        spec = _spec(route, game)
        state = _state(route, game)
        example = np.asarray([3, 1], np.uint8)
        if when == "mid":
            spec.root(0, state)
            for x in _seq(3):
                spec.extend(x)
            held = _window(spec)
        spec.warmup(state, example, range(1, 9), True)
        if when == "mid":
            _assert_windows_equal(_window(spec), held, f"{route} after warmup")
            assert spec.hits == 0
        results[route] = (_live_window(spec, route, game, state), _window(spec), spec)
    for route in ("eager", "graph"):
        (out, live, traj), window, _ = results[route]
        (jout, jlive, jtraj), jwindow, _ = results["jax"]
        for k, (a, b) in enumerate(zip(out, jout)):
            _assert_out_equal(a, b, f"{route} call {k}")
        _assert_states_equal(live, jlive, route)
        assert traj is not None and jtraj is not None
        for a, b in zip(traj, jtraj):
            _assert_states_equal(a, b, route)
        _assert_windows_equal(window, jwindow, route)
    assert results["graph"][1]["hits"] == 2
    g = results["graph"][2].graphs()
    # warmup: advance_and_extend, extend, the fused tick at n = 1..8 with and
    # without the live advance; the live window adds fulfill and resolve
    assert g.captures == 1 + 1 + 16 + 2


def test_executor_warmup_captures_every_speculation_graph(stand_in):
    game = PKGS["port"].games.BoxGame(4)
    spec = _mk_spec("port", game, K=8, branch_inputs_all=lambda f, x: np.stack([x] * 8))
    spec._graphs = SpecGraphs(spec)
    programs = _graphed_programs(game)
    ex = PKGS["port"].ops.DeviceRequestExecutor(game.advance, game.init_state_np(),
                                                lambda pairs: np.zeros(4, np.uint8),
                                                speculation=spec, programs=programs,
                                                device="cpu")
    ex.warmup(np.zeros(4, np.uint8), burst_depths=range(2, 10))
    assert spec.graphs().captures == 18 and programs._graphs[CPU].captures == 9
    assert (spec.root_frame, spec.window, spec.hits) == (None, 0, 0)


# -- the hit counter and what callers keep ------------------------------------


def test_hit_counter_after_several_replays(stand_in):
    hits = {}
    for route in ROUTES:
        game = _game(route)
        spec = _spec(route, game)
        state = _state(route, game)
        outs = []
        for k in range(5):
            spec.root(0, state)
            seq = _seq(3)
            for x in seq:
                spec.extend(x)
            confirmed = [x.copy() for x in seq[:2]]
            if k % 2:
                confirmed[1][1] = MISS
            outs.append(spec.fulfill_and_refill(0, confirmed, state, True))
        hits[route] = (spec.hits, outs)
        if route == "graph":
            keys = [key for key in spec.graphs()._entries if key[0] == "fulfill_and_refill"]
            assert len(keys) == 1 and spec.graphs().replays == 5 * 3 + 5
    assert hits["graph"][0] == hits["eager"][0] == hits["jax"][0] == 3
    for route in ("eager", "graph"):
        for a, b in zip(hits[route][1], hits["jax"][1]):
            _assert_out_equal(a, b, route)


@pytest.mark.parametrize("call", ["advance_and_extend", "fulfill", "fulfill_and_refill"])
def test_cells_keep_their_step_after_the_next_replay(stand_in, call):
    # a graph's outputs are static buffers that the next replay overwrites:
    # the states and digests a call returns (which cells and the live state
    # keep) must be the caller's own copies
    game = _game("graph")
    spec = _spec("graph", game)
    state = _state("graph", game)
    kept = []
    for k in range(3):
        seq = [np.asarray([(i + k) % 5, 1 if k != 1 else 4], np.uint8) for i in range(4)]
        spec.root(0, state)
        if call == "advance_and_extend":
            live = state
            for x in seq:
                live = spec.advance_and_extend(live, x)
                kept.append((live, tree_map(torch.clone, live)))
            continue
        for x in seq:
            spec.extend(x)
        if call == "fulfill":
            out = spec.fulfill(0, seq[:3], state, True)
        else:
            out = spec.fulfill_and_refill(0, seq[:3], state, True, live_inputs=seq[3])
        kept.append((out, tree_map(torch.clone, out)))
    for held, copy in kept:
        for a, b in zip(tree_leaves(held), tree_leaves(copy)):
            assert torch.equal(a, b)
    assert spec.graphs().captures == (1 if call == "advance_and_extend" else 2)


# -- the executor's speculating route ------------------------------------------


@pytest.fixture
def graphed_specs(monkeypatch, stand_in):
    """Every port ``SpeculativeRollback`` made from here on takes the graph
    route on the CPU; yields the graph objects made."""
    made = []

    def graphs(self):
        if self._graphs is None:
            self._graphs = SpecGraphs(self)
            made.append(self._graphs)
        return self._graphs

    monkeypatch.setattr(spec_mod.SpeculativeRollback, "graphs", graphs)
    return made


def test_four_peer_drive_on_graphs_matches_jax_and_eager(graphed_specs, monkeypatch):
    graph = _four_peer_drive("port")
    monkeypatch.undo()
    eager = _four_peer_drive("port")
    jx = _four_peer_drive("jax")
    assert graph.loads == eager.loads == jx.loads > 0
    for i, (a, b, c) in enumerate(zip(graph.per_tick, eager.per_tick, jx.per_tick)):
        _assert_states_equal(a, b, f"tick {i} eager")
        _assert_states_equal(a, c, f"tick {i} jax")
    ex = graph.executors[0]
    for name in ("spec_hits", "spec_misses"):
        assert getattr(ex, name) == getattr(eager.executors[0], name) \
            == getattr(jx.executors[0], name), name
    assert ex.spec_hits > 0 and ex.spec_hits + ex.spec_misses == graph.loads
    for gs, js in zip(graph.sessions, jx.sessions):
        assert gs._local_checksum_history == js._local_checksum_history
    (g,) = graphed_specs
    assert g.replays > graph.loads and g.captures <= 2 + 2 * 8


def test_speculating_graphs_read_nothing_and_count_their_digests(graphed_specs, monkeypatch):
    spy = _no_device_reads(monkeypatch)
    run = _four_peer_drive("port", ticks=30, scheduled=24, device_read_spy=spy)
    assert run.loads > 0 and run.executors[0].spec_hits > 0
    # the card's wrapper route, emulated: each replay counts the digest
    # launches its capture recorded, so a speculating peer launches what its
    # request lists predict, plus the one digest of the graphs' rehearsal
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    run = _four_peer_drive("port", ticks=40, scheduled=30)
    assert run.loads > 0 and run.desyncs == 0
    assert run.launched == run.predicted + 1 and run.predicted > 0


# -- build_speculation_programs ------------------------------------------------


def _branch_programs(route):
    game = _game(route)
    pkg = "jax" if route == "jax" else "port"
    progs = PKGS[pkg].par.build_speculation_programs(game.advance, num_branches=4)
    if route == "graph":
        progs.programs._graphs[CPU] = BranchGraphs(progs.programs, CPU)
    return game, progs


@pytest.mark.parametrize("w", [1, 8])
def test_branch_programs_match_jax_and_eager(stand_in, w):
    inputs_kw = np.random.default_rng(w).integers(0, 16, size=(4, w, 2)).astype(np.uint8)
    inputs_kw[3] = inputs_kw[1]  # two branches match: the first is taken
    outs = {}
    for route in ROUTES:
        game, progs = _branch_programs(route)
        base = _state(route, game)
        base = _adv(route, game, base, np.asarray([3, 9], np.uint8))
        branches = progs.speculate_window(base, inputs_kw)
        hit = progs.resolve(branches, inputs_kw, inputs_kw[1])
        miss = progs.resolve(branches, inputs_kw, np.full((w, 2), 255, np.uint8))
        replay = progs.replay_window(base, inputs_kw[1])
        outs[route] = {"init": progs.init(base), "branches": branches,
                       "hit": hit, "miss": miss, "replay": replay,
                       "collapse_hit": progs.collapse(branches, hit[1]),
                       "collapse_2": progs.collapse(branches, 2)}
        if route == "graph":
            g = progs.programs._graphs[CPU]
            assert (g.captures, g.replays) == (5, 7)
    for route in ("eager", "graph"):
        o, j = outs[route], outs["jax"]
        for key in ("init", "branches", "replay", "collapse_hit", "collapse_2"):
            _assert_states_equal(o[key], j[key], f"{route} {key}")
        for key, (idx, found) in (("hit", (1, True)), ("miss", (0, False))):
            _assert_states_equal(o[key][0], j[key][0], f"{route} {key}")
            assert (int(o[key][1]), bool(o[key][2])) == (idx, found)
            assert (int(j[key][1]), bool(j[key][2])) == (idx, found)
        _assert_states_equal(o["hit"][0], o["replay"], route)


# -- the prediction plane's kernel ---------------------------------------------


class _JaxStride(jpredict.BatchedInputPredictor):
    """Predicts ``(previous ^ 15) * 3 + 1`` mod 256: a kernel of several ops,
    in the JAX package's idiom."""

    def predict(self, previous):
        return ((previous ^ 15) * 3 + 1) % 256

    def kernel(self, base):
        return (((base.astype(jnp.int32) ^ 15) * 3 + 1) % 256).astype(jnp.uint8)


class _PortStride(tpredict.BatchedInputPredictor):
    """``_JaxStride`` in the port's idiom."""

    def predict(self, previous):
        return ((previous ^ 15) * 3 + 1) % 256

    def kernel(self, base):
        return ((base.to(torch.int32) ^ 15) * 3 + 1).remainder(256).to(torch.uint8)


@pytest.mark.parametrize("fault", ["clean", "fuzz"])
def test_plane_with_a_kernel_of_several_ops(stand_in, monkeypatch, fault):
    fault = tpp.FUZZ if fault == "fuzz" else tpp.CLEAN
    real = tpp._predictor
    monkeypatch.setattr(tpp, "_predictor", lambda pkg, name: (
        {"jax": _JaxStride, "port": _PortStride}[pkg]() if name == "stride" else real(pkg, name)))
    off = tpp._drive("port", "stride", False, fault)
    eager = tpp._drive("port", "stride", True, fault)
    jon = tpp._drive("jax", "stride", True, fault)
    made = []

    def graphs(self):
        if self._graphs is None:
            self._graphs = KeyedGraphs(self.device, "predict")
            made.append(self._graphs)
        return self._graphs

    monkeypatch.setattr(tpredict.DevicePredictionPlane, "graphs", graphs)
    on = tpp._drive("port", "stride", True, fault)
    for leg in (on, eager, jon):
        assert leg.record == off.record
        assert leg.wire == off.wire
        assert leg.states == off.states
    stats = on.plane.stats()
    assert stats == eager.plane.stats() == jon.plane.stats()
    assert stats["hits"] > 0
    assert on.plane_mispredicts == jon.plane_mispredicts
    (g,) = made
    ticks = tpp.TICKS + tpp.DRAIN
    assert (g.captures, g.replays) == (1, ticks)  # one base shape, one replay a tick
    base = np.random.default_rng(2).integers(0, 256, size=(6, 2, 1)).astype(np.uint8)
    want = np.asarray(_JaxStride().kernel(jnp.asarray(base)))
    np.testing.assert_array_equal(_PortStride().kernel(torch.from_numpy(base)).numpy(), want)
