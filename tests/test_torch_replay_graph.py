"""What makes the replay's CUDA graphs right, pinned on the CPU.

On the card ``run_steady`` replays one captured graph per phase ``frame %
R``: the graph of a phase is captured at its first steady frame F and
replayed at F + R, F + 2R, ...  A capture freezes every host int it saw, so
the port's steady tick takes its slots from the host frame only through
the phase and every frame number it writes from the carry's own ``frame``
tensor.  The graphs themselves need the card; here each steady tick runs
eagerly with the host frame its graph was captured at (only the device
frame differs), and the carry must equal the JAX package's ``run_steady``
over the same ticks, leaf for leaf (tolerance exactly 0: every path is
integer).  Also pinned: the digest launch counts a graph moves onto its
replays, checkpoints that load into the carry's own buffers (captured
graphs stay valid), and the scrub's windows against the JAX scrub.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games import EcsWorld as JaxEcsWorld
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM
from ggrs_tpu.ops.replay import build_scrub_program as jax_build_scrub_program
from ggrs_tpu.parallel import BatchedSessions as JaxBatchedSessions
from ggrs_tpu.parallel import make_mesh as jax_make_mesh
from ggrs_tpu.sessions import DeviceSyncTestSession as JaxSession

from ggrs_tpu_torch import (
    BatchedSessions,
    BoxGame,
    ChipVM,
    DeviceSyncTestSession,
    EcsWorld,
    build_replay_programs,
    build_scrub_program,
    make_mesh,
    to_numpy,
)
from ggrs_tpu_torch.ops import digest as tdg
from ggrs_tpu_torch.ops.kernels import GraphLaunches
from ggrs_tpu_torch.ops.replay import I32_MAX
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

from test_torch_checksum import _emulated_launch, _FakeCuda
from test_torch_replay import _assert_trees_equal

# (port game, JAX game, players, check_distance, sessions); the ring is
# check_distance + 1 slots, as the sessions size it at max_prediction = d
CASES = {
    "boxgame": (lambda: BoxGame(2), lambda: JaxBoxGame(2), 2, 8, 1),
    "ecs": (lambda: EcsWorld(4, 8), lambda: JaxEcsWorld(4, 8), 4, 16, 1),
    "chipvm": (lambda: ChipVM(2), lambda: JaxChipVM(2), 2, 8, 4),
}
PERIODS = 3


def _inputs(case, ticks, seed):
    _, _, players, _, b = CASES[case]
    high = 256 if case == "chipvm" else 16
    return np.random.default_rng(seed).integers(0, high, size=(b, ticks, players)).astype(np.uint8)


def _port_programs(case):
    make, _, players, d, b = CASES[case]
    game = make()
    progs = build_replay_programs(game.advance, ring_length=d + 1, check_distance=d)
    carry = progs.init_carry(game.init_state_np(), np.zeros(players, np.uint8), batch_size=b,
                             device="cpu")
    return progs, carry


def _jax_session(case):
    _, make, players, d, b = CASES[case]
    game = make()
    if b == 1:
        return JaxSession(game.advance, game.init_state(), jnp.zeros((players,), jnp.uint8),
                          check_distance=d, max_prediction=d)
    return JaxBatchedSessions(game.advance, game.init_state(), jnp.zeros((players,), jnp.uint8),
                              batch_size=b, mesh=jax_make_mesh(1), check_distance=d,
                              max_prediction=d)


def _jax_run(jx, inputs):
    """``inputs`` is (B, n, P); a single JAX session takes (n, P)."""
    jx.run_ticks(inputs[0] if isinstance(jx, JaxSession) else inputs, check=False)


def _jax_carry(jx):
    """The JAX carry with a leading session axis, as the port holds it."""
    carry = jax.device_get(jx._carry)
    if isinstance(jx, JaxSession):
        carry = tree_map(lambda leaf: np.asarray(leaf)[None], carry)
    return carry


def _as_graphs_replay(progs, carry, inputs, start, stop):
    """Steady ticks ``start .. stop - 1`` as the card runs them: tick f
    takes the host frame of the first steady frame of its phase, where its
    graph was captured; only the device frame moves on."""
    w, r = progs.warmup_ticks, progs.ring.length
    for f in range(start, stop):
        captured_at = w + (f - w) % r
        assert captured_at % r == f % r and (captured_at == f) == (f < w + r)
        progs.steady_tick(carry, tree_map(lambda a: a[:, f], inputs), captured_at)


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase_graph_ticks_match_jax_over_ring_periods(case):
    progs, carry = _port_programs(case)
    w, r = progs.warmup_ticks, progs.ring.length
    ticks = w + PERIODS * r + 2
    inputs = _inputs(case, ticks, seed=len(case))
    port_in = torch.from_numpy(inputs)
    progs.run_warmup(carry, port_in[:, :w], 0)
    _as_graphs_replay(progs, carry, port_in, w, ticks)
    jx = _jax_session(case)
    _jax_run(jx, inputs)
    got = to_numpy(carry)
    _assert_trees_equal(got, _jax_carry(jx))
    # the ring holds the last R frames' numbers, all from the third period on
    assert sorted(got["ring"]["frames"][0].tolist()) == list(range(ticks - r, ticks))
    assert got["frame"].tolist() == [ticks] * CASES[case][4]
    assert got["mismatches"].tolist() == [0] * CASES[case][4]


@pytest.mark.parametrize("case", ["boxgame", "chipvm"])
def test_desync_in_the_third_period_is_reported_at_its_frame(case):
    # corrupt the state the next tick reloads, two ring periods after the
    # graphs were captured: a graph that froze its capture frame's numbers
    # would report the mismatch in the first period
    progs, carry = _port_programs(case)
    w, r, d = progs.warmup_ticks, progs.ring.length, progs.check_distance
    at = w + 2 * r + d + 1  # its first resimulated frame is in the third period
    ticks = at + 3
    inputs = _inputs(case, ticks, seed=40)
    port_in = torch.from_numpy(inputs)
    progs.run_warmup(carry, port_in[:, :w], 0)
    _as_graphs_replay(progs, carry, port_in, w, at)
    jx = _jax_session(case)
    _jax_run(jx, inputs[:, :at])
    slot = (at - d) % r
    leaf = "pos" if case == "boxgame" else "mem"
    carry["ring"]["states"][leaf][0, slot] += 1
    jstates = jx._carry["ring"]["states"]
    jstates[leaf] = jstates[leaf].at[(slot,) if isinstance(jx, JaxSession) else (0, slot)].add(1)
    _as_graphs_replay(progs, carry, port_in, at, ticks)
    _jax_run(jx, inputs[:, at:])
    got, want = to_numpy(carry), _jax_carry(jx)
    _assert_trees_equal(got, want)
    assert got["mismatches"][0] >= 1
    assert got["first_bad"][0] == at - d + 1 > w + 2 * r
    assert (got["first_bad"][1:] == I32_MAX).all()


def test_run_steady_on_the_cpu_is_the_eager_tick():
    # a CPU carry takes the eager steady_tick (no graph) and equals the
    # phase-keyed ticks above
    progs, carry = _port_programs("boxgame")
    twin_progs, twin = _port_programs("boxgame")
    w, r = progs.warmup_ticks, progs.ring.length
    ticks = w + 2 * r + 1
    port_in = torch.from_numpy(_inputs("boxgame", ticks, seed=5))
    for p, c in ((progs, carry), (twin_progs, twin)):
        p.run_warmup(c, port_in[:, :w], 0)
    progs.run_steady(carry, port_in[:, w:], w)
    _as_graphs_replay(twin_progs, twin, port_in, w, ticks)
    assert progs.tick_graphs == []
    _assert_trees_equal(to_numpy(carry), to_numpy(twin))


@pytest.mark.parametrize("b,d", [(1, 8), (3, 2)])
def test_graph_launches_move_from_the_capture_onto_each_replay(b, d, monkeypatch):
    # the digest's card route, emulated: the steady body "captured" under
    # GraphLaunches.capturing() launches its digests (one a contiguous span
    # of the window's ring slots, then the live state's), which are taken
    # off the counters again and added back once per replay
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    game = BoxGame(2)
    progs = build_replay_programs(game.advance, ring_length=d + 1, check_distance=d)
    carry = progs.init_carry(game.init_state_np(), np.zeros(2, np.uint8), batch_size=b,
                             device="cpu")
    inputs = torch.zeros((b, d + 1, 2), dtype=torch.uint8)
    progs.run_warmup(carry, inputs, 0)
    r = progs.ring.length
    for frame in range(d + 1, d + 1 + r):  # every phase, the window wrapping or not
        spans = [b * (rs.stop - rs.start) for rs, _ in progs.ring.spans(frame - d + 1, d)]
        n = progs.digest_calls(frame)
        assert n == len(spans) + 1
        before = (tdg.state_digest.launches, tdg.lane_sums_rows.launches)
        launches = GraphLaunches()
        with launches.capturing():
            progs.steady_body(carry, frame)
        assert (launches.counts[tdg.state_digest], launches.counts[tdg.lane_sums_rows]) == (n, 0)
        assert calls[-n:] == [*spans, b]  # the window's spans of rows, then the live advance's
        assert (tdg.state_digest.launches, tdg.lane_sums_rows.launches) == before
        for _ in range(5):
            launches.replayed()
        assert tdg.state_digest.launches - before[0] == 5 * n
        assert tdg.lane_sums_rows.launches == before[1]


def test_a_failed_capture_leaves_the_counters_as_they_were():
    before = tdg.state_digest.launches
    launches = GraphLaunches()
    with pytest.raises(RuntimeError):
        with launches.capturing():
            tdg.state_digest.launches += 1
            raise RuntimeError("capture failed")
    assert tdg.state_digest.launches == before
    assert (launches.counts[tdg.state_digest], launches.counts[tdg.lane_sums_rows]) == (1, 0)


# -- checkpoints load into the carry's own buffers ---------------------------


def _buffers(tree):
    return [(x.data_ptr(), tuple(x.shape), x.stride()) for x in tree_leaves(tree)]


def _box_session():
    game = BoxGame(2)
    return DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                 check_distance=3, device="cpu")


def _vm_batch(mesh=None):
    vm = ChipVM(2)
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    return BatchedSessions(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=4,
                           check_distance=3, max_prediction=3, **kw)


@pytest.mark.parametrize("kind", ["session", "batch", "mesh"])
def test_load_checkpoint_keeps_every_carry_buffer(kind, tmp_path):
    rng = np.random.default_rng(8)
    if kind == "session":
        sess = _box_session()
        inputs = rng.integers(0, 16, size=(20, 2)).astype(np.uint8)
        head, tail = inputs[:12], inputs[12:]
        carries = lambda: [sess.carry]  # noqa: E731  (views of the carry)
    else:
        sess = _vm_batch(make_mesh(2, device="cpu") if kind == "mesh" else None)
        inputs = rng.integers(0, 256, size=(4, 20, 2)).astype(np.uint8)
        head, tail = inputs[:, :12], inputs[:, 12:]
        carries = lambda: sess.shard_carries  # noqa: E731
    sess.run_ticks(head, check=False)
    path = str(tmp_path / "ckpt.npz")
    sess.save_checkpoint(path)
    saved = [to_numpy(c) for c in carries()]
    sess.run_ticks(tail, check=False)
    buffers = [_buffers(c) for c in carries()]
    sess.load_checkpoint(path)
    assert [_buffers(c) for c in carries()] == buffers
    for got, want in zip(carries(), saved):
        _assert_trees_equal(to_numpy(got), want)
    assert sess.current_frame == 12


# -- the scrub's windows -----------------------------------------------------


SCRUB_GAMES = {
    "boxgame": (lambda: BoxGame(2), lambda: JaxBoxGame(2), 16),
    "chipvm": (lambda: ChipVM(2), lambda: JaxChipVM(2), 256),
}


@pytest.mark.parametrize("frames", [1, 7, 64])
@pytest.mark.parametrize("game", sorted(SCRUB_GAMES))
def test_scrub_window_matches_jax(game, frames):
    make, make_jax, high = SCRUB_GAMES[game]
    port, jgame = make(), make_jax()
    window = np.random.default_rng(frames).integers(0, high, size=(frames, 2)).astype(np.uint8)
    scrub = build_scrub_program(port.advance, device="cpu")
    got = scrub(port.init_state_np(), window)
    want = jax_build_scrub_program(jgame.advance, donate=False)(jgame.init_state(),
                                                               jnp.asarray(window))
    _assert_trees_equal(to_numpy(got), jax.device_get(want))
    _assert_trees_equal(to_numpy(scrub.eager(port.init_state_np(), window)),
                        jax.device_get(want))
    assert (scrub.captures, scrub.replays) == (0, 0)  # the CPU runs the eager body
