"""The request path's CUDA graphs, pinned on the CPU.

On the card ``ExecutorPrograms.advance`` / ``burst`` and each shard of
``BatchedRequestExecutor``'s masked tick are CUDA graph replays
(``ops.executor.ExecutorGraphs``, ``parallel.session_pool._ShardGraphs``).
The graphs need the card, but all of their route but the capture and the
replay is plain PyTorch: the keys, the static buffers, the copies in, the
body over those buffers, the clones out, the fixed-shape masked writes.
Here that route runs on CPU tensors: each test hands a CPU programs object
or pool shard the graph object the package makes for a CUDA device, and
replaces ``ops.graphs._record`` (the capture) with a stand-in whose
"graph" runs the captured body again on the static buffers at each replay.
Nothing in the package selects the stand-in.

Every result is held against the JAX package (``ExecutorPrograms.burst``,
``DeviceRequestExecutor``, ``BatchedRequestExecutor``) on inputs made from
a seed with numpy, and against the eager route, leaf for leaf and digest for
digest: tolerance exactly 0, since the games and the digest are integer
math.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM
from ggrs_tpu.ops import ExecutorPrograms as JaxPrograms

from ggrs_tpu_torch import (
    BoxGame,
    ChipVM,
    DeviceRequestExecutor,
    ExecutorPrograms,
    GameStateCell,
    SaveGameState,
    make_mesh,
    to_numpy,
)
from ggrs_tpu_torch.convert import from_numpy
from ggrs_tpu_torch.ops import digest as tdg
from ggrs_tpu_torch.ops.kernels import GraphLaunches
from ggrs_tpu_torch.ops import graphs as graphs_mod
from ggrs_tpu_torch.ops.executor import ExecutorGraphs
from ggrs_tpu_torch.ops.ring import DeviceStateRing
from ggrs_tpu_torch.parallel import session_pool as pool_mod
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

from chip_smoke import pool_predicted
from test_torch_checksum import _emulated_launch, _FakeCuda
from test_torch_executor import _advance, _assert_states_equal, _jax_run, _port_inputs, _port_run
from test_torch_session_pool import PKGS, _drive, _make_matches, _np_state, _pool
from test_torch_session_pool import _assert_states_equal as _assert_pool_states_equal

CPU = torch.device("cpu")
GAMES = {
    "boxgame": (lambda: BoxGame(2), lambda: JaxBoxGame(2), 16),
    "chipvm": (lambda: ChipVM(2), lambda: JaxChipVM(2), 256),
}


class _Replayer:
    """A captured graph's stand-in: each replay runs the body again on the
    graph's static buffers.  The card's replay calls no wrapper, so the
    launches the body counts are taken off again; ``Graph.replay`` adds
    the capture's."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        with GraphLaunches().capturing():
            self.body()


@pytest.fixture
def stand_in(monkeypatch):
    """Replace the capture: the body runs once, as a capture runs its
    Python (and counts its launches), and the "graph" replays it.  Yields
    the captured bodies."""
    bodies = []

    def record(graphs, body):
        body()
        if graphs.pool is None:
            graphs.pool = ("stand-in pool", id(graphs))
        bodies.append(body)
        return _Replayer(body)

    monkeypatch.setattr(graphs_mod, "_record", record)
    return bodies


def _graphed(game, with_checksums=True):
    """A CPU programs object on the graph route."""
    programs = ExecutorPrograms(game.advance, with_checksums)
    programs._graphs[CPU] = ExecutorGraphs(programs, CPU)
    return programs


# -- the executor's programs --------------------------------------------------------


def _start(game, jgame, high, seed):
    """A state some frames into a game, in both packages' layouts."""
    moves = np.random.default_rng(seed).integers(0, high, size=(5, 2)).astype(np.uint8)
    jst = jgame.init_state()
    for m in moves:
        jst = jgame.advance(jst, jnp.asarray(m))
    return from_numpy(jax.device_get(jst), "cpu"), jst


@pytest.mark.parametrize("depth", range(2, 10))
@pytest.mark.parametrize("name", sorted(GAMES))
def test_burst_matches_jax_burst(stand_in, name, depth):
    make, jmake, high = GAMES[name]
    game, jgame = make(), jmake()
    state, jstate = _start(game, jgame, high, seed=depth)
    inputs = np.random.default_rng(100 + depth).integers(0, high, size=(depth, 2)).astype(np.uint8)
    jfinal, jsteps, jsums = JaxPrograms(jgame.advance).burst(jstate, jnp.asarray(inputs))
    programs = _graphed(game)
    steps, sums = programs.burst(state, inputs, range(depth))
    assert len(steps) == len(sums) == depth
    for k in range(depth):
        _assert_states_equal(steps[k], jsteps[k])
        np.testing.assert_array_equal(sums[k].numpy().view(np.uint32), np.asarray(jsums[k]))
    _assert_states_equal(steps[-1], jfinal)
    # the saved subset is picked from the same stack; no saves, no digest
    odd = list(range(1, depth, 2))
    steps_odd, sums_odd = programs.burst(state, inputs, odd)
    assert [s.numpy().tolist() for s in sums_odd] == [sums[k].numpy().tolist() for k in odd]
    bare, none = programs.burst(state, inputs, [])
    assert none is None
    for got, want in zip(bare + steps_odd, steps + steps):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)
    eager_steps, eager_sums = ExecutorPrograms(game.advance).burst_eager(state, inputs, odd)
    for a, b in zip(eager_sums, sums_odd):
        assert torch.equal(a, b)
    g = programs._graphs[CPU]
    assert (g.captures, g.replays) == (2, 3)  # digesting and not: two keys of one depth


@pytest.mark.parametrize("name", sorted(GAMES))
def test_synctest_run_matches_jax_executor(stand_in, name):
    make, jmake, high = GAMES[name]
    inputs = np.random.default_rng(41).integers(0, high, size=(60, 2)).astype(np.uint8)
    game = make()
    programs = _graphed(game)
    port_ex, port_saved = _port_run(game, inputs, 7, programs=programs)
    jax_ex, jax_saved = _jax_run(jmake(), inputs, 7)
    assert port_saved == jax_saved
    _assert_states_equal(port_ex.state, jax_ex.state)
    g = programs._graphs[CPU]
    # the lone saves' advances (one key) and the depth-8 burst (one key)
    assert g.captures == 2 and g.replays == 60


def test_warmup_captures_every_depth_and_leaves_the_state(stand_in):
    game = ChipVM(2)
    programs = _graphed(game)
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs,
                               programs=programs, device="cpu")
    before = ex.state
    copies = tree_map(torch.clone, before)
    ex.warmup(np.array([3, 4], np.uint8), burst_depths=range(1, 10))
    assert ex.state is before
    for k in before:
        assert torch.equal(ex.state[k], copies[k])
    g = programs._graphs[CPU]
    assert g.captures == 1 + 8 and g.replays == 1 + 8
    assert CPU in programs._eager_on


@pytest.mark.parametrize("route", ["burst", "advance"])
def test_saved_cells_keep_their_values_after_the_next_replay(stand_in, route):
    # a graph's outputs are static buffers that the next replay overwrites:
    # what a cell (its state and its unread digest) and the live state hold
    # must be the caller's own copies
    game = BoxGame(2)
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs,
                               programs=_graphed(game), device="cpu")
    rng = np.random.default_rng(5)
    kept = []
    for k in range(4):
        moves = rng.integers(0, 16, size=(3 if route == "burst" else 1, 2))
        cells = [GameStateCell() for _ in moves]
        reqs = []
        for j, (m, cell) in enumerate(zip(moves, cells)):
            reqs += [_advance(int(m[0]), int(m[1])), SaveGameState(cell=cell, frame=3 * k + j)]
        ex.run(reqs)
        held = [(cell.data(), cell._state.checksum._lanes) for cell in cells] + [ex.state]
        kept.append((held, tree_map(torch.clone, held)))
    for held, copy in kept:
        for a, b in zip(tree_leaves(held), tree_leaves(copy)):
            assert torch.equal(a, b)


def test_card_digest_route_counts_one_launch_a_frame(stand_in, monkeypatch):
    # the digest's card route, emulated: a capture's launches are taken off
    # the counters and added back once per replay, so a SyncTest frame still
    # counts one launch
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    game = BoxGame(2)
    programs = _graphed(game)
    # what warmup does first: the bodies once eagerly (one digest launch)
    programs.rehearse(from_numpy(game.init_state_np(), "cpu"), np.zeros(2, np.uint8))
    calls.clear()
    inputs = np.random.default_rng(8).integers(0, 16, size=(40, 2)).astype(np.uint8)
    per_frame = []
    before = tdg.state_digest.launches
    _port_run(game, inputs, 7, programs=programs,
              on_frame=lambda f, reqs: per_frame.append(tdg.state_digest.launches - before))
    assert per_frame == list(range(1, 41))
    g = programs._graphs[CPU]
    assert g.captures == 2 and g.replays == 40
    # the 8 lone saves are direct launches of one row; the burst's graph
    # digests its 8 stacked steps, once at its capture and once a replay
    assert calls == [1] * 8 + [8] * (1 + 32)


# -- the pool's masked tick ------------------------------------------------------


def _graph_pool(pool):
    """Give every shard of a warmed CPU pool the graphs a CUDA shard gets."""
    for shard in pool._shards:
        shard["graphs"] = pool_mod._ShardGraphs(pool, shard)
        shard["graphs"].warm()
    return pool


def _record_ticks(pool, rec):
    real = pool._tick

    def tick(desc):
        rec.append({k: v.copy() for k, v in desc.items()})
        return real(desc)

    pool._tick = tick


def _matches(pkg, n_matches, seed, sparse):
    """``_make_matches``' population over a lossy network with latency, so
    that rollbacks come in several depths; returns (net, sessions,
    schedules)."""
    p = PKGS[pkg]
    net = p.net.InMemoryNetwork(seed=seed, loss=0.05, latency_ticks=3)
    sessions, schedules = [], []
    for m in range(n_matches):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            b = (p.sessions.SessionBuilder(p.games.boxgame_config()).with_clock(lambda: 0)
                 .with_rng(random.Random(seed + 7 * m + me)).with_sparse_saving_mode(sparse)
                 .add_player(p.core.Local(), me).add_player(p.core.Remote(names[1 - me]), 1 - me))
            sessions.append(b.start_p2p_session(net.socket(names[me])))
            schedules.append(lambda i, m=m, me=me: ((i + 2 * m + me) // (2 + m % 3)) % 16)
    return net, sessions, schedules


def _pool_run(pkg, n_matches, ticks, seed, graphs=False, sparse=False, frozen=0, mesh=None):
    """The seeded matches through one pool (the port's sharded over
    ``mesh`` where given).  From tick 10 the first ``frozen`` sessions stop
    (no input, no ``advance_frame``: their lists are empty).  Returns per
    tick the live states and every saved frame's ring checksum, the pool
    and (port) every tick's descriptor."""
    net, sessions, schedules = _matches(pkg, n_matches, seed, sparse)
    if mesh is None:
        pool = _pool(pkg, PKGS[pkg].games.BoxGame(2), len(sessions))
    else:
        game = BoxGame(2)
        pool = pool_mod.BatchedRequestExecutor(game.advance, game.init_state_np(), _port_inputs,
                                               batch_size=len(sessions), ring_length=10,
                                               max_burst=9, mesh=mesh)
        pool.warmup(np.zeros((2,), np.uint8))
    if graphs:
        _graph_pool(pool)
    descs, rec = [], []
    if pkg == "port":
        _record_ticks(pool, descs)
    for i in range(ticks + 14):
        net.tick()
        for s in sessions:
            s.poll_remote_clients()
        all_reqs = []
        for b, (s, sched) in enumerate(zip(sessions, schedules)):
            if b < frozen and i >= 10:
                all_reqs.append([])
                continue
            s.add_local_input(b % 2, sched(min(i, ticks - 1)))
            all_reqs.append(s.advance_frame())
        pool.run(all_reqs)
        saved = [(b, r.frame) for b, rs in enumerate(all_reqs)
                 for r in rs if type(r).__name__ == "SaveGameState"]
        rec.append(([_np_state(pool.live_state(b)) for b in range(pool.batch_size)],
                    [(b, f, pool.ring_checksum(b, f)) for b, f in saved]))
    return rec, pool, descs


def _assert_runs_equal(got, want):
    assert len(got) == len(want)
    for i, ((sg, cg), (sw, cw)) in enumerate(zip(got, want)):
        _assert_pool_states_equal(sg, sw, f"tick {i}")
        assert cg == cw, f"tick {i}"


@pytest.mark.parametrize("sparse", [False, True])
def test_keyed_masked_tick_matches_jax_and_the_eager_tick(stand_in, sparse):
    graph_rec, pool, descs = _pool_run("port", 4, 40, seed=19, graphs=True, sparse=sparse)
    eager_rec, _, _ = _pool_run("port", 4, 40, seed=19, sparse=sparse)
    jax_rec, _, _ = _pool_run("jax", 4, 40, seed=19, sparse=sparse)
    _assert_runs_equal(graph_rec, eager_rec)
    _assert_runs_equal(graph_rec, jax_rec)
    # the drive met what the tests below rely on
    keys = {pool._shards[0]["graphs"].pack(d)[1] for d in descs}
    assert any(k[2] for k in keys) and len({k[0] for k in keys}) >= 3  # loads, depths
    assert (any(k[3] for k in keys) if sparse else not any(k[3] for k in keys))  # post-load saves
    assert any(not (k[1] or k[3] or any(k[4])) for k in keys) == sparse  # a tick of no write
    assert pool.captures == 2 + len(keys - {(1, True, False, False, (False,)),
                                            (9, True, True, False, (True,) * 8 + (False,))})
    assert pool.replays == len(descs)


def test_rows_that_do_not_advance_stay_put(stand_in):
    graph_rec, pool, descs = _pool_run("port", 3, 36, seed=7, graphs=True, frozen=2)
    eager_rec, _, _ = _pool_run("port", 3, 36, seed=7, frozen=2)
    jax_rec, _, _ = _pool_run("jax", 3, 36, seed=7, frozen=2)
    _assert_runs_equal(graph_rec, eager_rec)
    _assert_runs_equal(graph_rec, jax_rec)
    assert all(d["n_adv"][:2].max() == 0 for d in descs[10:])
    assert all(graph_rec[-1][0][b][k].tolist() == graph_rec[10][0][b][k].tolist()
               for b in range(2) for k in graph_rec[-1][0][b])


def test_graph_digests_are_the_descriptors_prediction(stand_in, monkeypatch):
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    sessions, schedules = _make_matches("port", 3, seed=11)
    pool = _graph_pool(_pool("port", BoxGame(2), 6))
    descs = []
    _record_ticks(pool, descs)
    before = tdg.state_digest.launches
    _drive(sessions, schedules, pool.run, 30)
    assert tdg.state_digest.launches - before == sum(pool_predicted(d) for d in descs) > 30
    assert pool.replays == len(descs)


def test_a_write_no_row_takes_leaves_the_ring_unchanged():
    ring = DeviceStateRing(4)
    rng = np.random.default_rng(3)
    live = {"a": torch.from_numpy(rng.integers(0, 99, (5, 3)).astype(np.int32)),
            "b": torch.from_numpy(rng.integers(0, 9, (5,)).astype(np.uint8))}
    buffers = ring.init(live)
    buffers["frames"].copy_(torch.from_numpy(rng.integers(0, 50, (5, 4)).astype(np.int32)))
    buffers["checksums"].copy_(torch.from_numpy(rng.integers(-9, 9, (5, 4, 4)).astype(np.int32)))
    before = tree_map(torch.clone, buffers)
    state = tree_map(lambda x: x + 1, live)
    cs = torch.ones((5, 4), dtype=torch.int32)
    frames = torch.from_numpy(np.array([7, 8, 9, 10, 11], np.int32))
    index = torch.from_numpy(ring.flat_index(np.arange(5), frames.numpy()))
    ring.save_rows_where(buffers, index, state, cs, frames, torch.zeros(5, dtype=torch.bool))
    for a, b in zip(tree_leaves(buffers), tree_leaves(before)):
        assert torch.equal(a, b)
    # a mask that takes rows 1 and 3 writes exactly what save_rows writes
    mask = torch.tensor([False, True, False, True, False])
    twin = tree_map(torch.clone, before)
    ring.save_rows_where(buffers, index, state, cs, frames, mask)
    rows = torch.tensor([1, 3])
    ring.save_rows(twin, index[rows], state, cs, frames[rows], rows)
    for a, b in zip(tree_leaves(buffers), tree_leaves(twin)):
        assert torch.equal(a, b)


def test_mesh_pool_keeps_one_set_of_graphs_per_shard(stand_in):
    mesh_rec, pool, descs = _pool_run("port", 4, 30, seed=23, graphs=True,
                                      mesh=make_mesh(2, device="cpu"))
    eager_rec, _, _ = _pool_run("port", 4, 30, seed=23)
    _assert_runs_equal(mesh_rec, eager_rec)
    sets = [shard["graphs"] for shard in pool._shards]
    assert len(sets) == 2 and sets[0].set is not sets[1].set
    assert all(g.shard is shard for g, shard in zip(sets, pool._shards))
    # each shard keys its own rows' decisions
    for g, shard in zip(sets, pool._shards):
        rows = slice(shard["lo"], shard["lo"] + 4)
        keys = {g.pack({k: v[rows] for k, v in d.items()})[1] for d in descs}
        assert g.captures == 2 + len(keys - {(1, True, False, False, (False,)),
                                            (9, True, True, False, (True,) * 8 + (False,))})
        assert g.replays == len(descs)
    live = to_numpy(pool.live_states)
    assert all(v.shape[0] == 8 for v in live.values())
