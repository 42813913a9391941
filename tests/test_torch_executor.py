"""The port's DeviceRequestExecutor against the JAX package's.

Both packages play the same numpy-seeded inputs through ``SessionBuilder``
-> ``SyncTestSession`` -> ``DeviceRequestExecutor``; every saved cell's u128
checksum must be equal frame by frame and the final live states equal leaf
for leaf (tolerance exactly 0: all integer math).  Everything runs with
``device="cpu"``; the card's wrapper path of the digest is emulated on the
CPU as ``tests/test_torch_checksum.py`` does, to count the launches."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ggrs_tpu.core as jcore
import ggrs_tpu_torch.core as tcore
from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games import boxgame_config as jax_boxgame_config
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM
from ggrs_tpu.ops import DeviceRequestExecutor as JaxExecutor
from ggrs_tpu.sessions import SessionBuilder as JaxSessionBuilder

from ggrs_tpu_torch import (
    AdvanceFrame,
    BoxGame,
    ChipVM,
    DeviceRequestExecutor,
    ExecutorPrograms,
    GameStateCell,
    InputStatus,
    LoadGameState,
    SaveGameState,
    SessionBuilder,
    boxgame_config,
    pytree_checksum,
    to_numpy,
)
from ggrs_tpu_torch.ops import digest as tdg
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

from test_torch_checksum import _emulated_launch, _FakeCuda

FRAMES = 60
C = InputStatus.CONFIRMED


def _port_inputs(pairs):
    return np.asarray([p[0] for p in pairs], np.uint8)


def _jax_inputs(pairs):
    return jnp.asarray(np.asarray([p[0] for p in pairs], np.uint8))


def _games(name):
    if name == "boxgame":
        return BoxGame(2), JaxBoxGame(2), 16
    return ChipVM(2), JaxChipVM(2), 256


def _port_run(game, inputs, check_distance, with_checksums=True, programs=None, on_frame=None):
    sess = (SessionBuilder(boxgame_config()).with_check_distance(check_distance)
            .start_synctest_session())
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs,
                               with_checksums=with_checksums, programs=programs, device="cpu")
    saved = []
    for f in range(len(inputs)):
        for h in range(2):
            sess.add_local_input(h, int(inputs[f, h]))
        reqs = sess.advance_frame()
        ex.run(reqs)
        saves = [r for r in reqs if isinstance(r, SaveGameState)]
        saved.append([(r.frame, r.cell.checksum) for r in saves])
        if on_frame is not None:
            on_frame(f, reqs)
    return ex, saved


def _jax_run(game, inputs, check_distance):
    sess = (JaxSessionBuilder(jax_boxgame_config()).with_check_distance(check_distance)
            .start_synctest_session())
    ex = JaxExecutor(game.advance, game.init_state(), _jax_inputs)
    saved = []
    for f in range(len(inputs)):
        for h in range(2):
            sess.add_local_input(h, int(inputs[f, h]))
        reqs = sess.advance_frame()
        ex.run(reqs)
        saved.append([(r.frame, r.cell.checksum) for r in reqs
                      if isinstance(r, jcore.SaveGameState)])
    return ex, saved


def _assert_states_equal(port_state, jax_state):
    got = to_numpy(port_state)
    want = jax.device_get(jax_state)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize(
    "name,check_distance",
    [("boxgame", 1), ("boxgame", 2), ("boxgame", 4), ("boxgame", 7),
     ("chipvm", 2), ("chipvm", 7)],
)
def test_executor_matches_jax(name, check_distance):
    port_game, jax_game, high = _games(name)
    inputs = np.random.default_rng(30 + check_distance).integers(
        0, high, size=(FRAMES, 2)).astype(np.uint8)
    port_ex, port_saved = _port_run(port_game, inputs, check_distance)
    jax_ex, jax_saved = _jax_run(jax_game, inputs, check_distance)
    assert port_saved == jax_saved
    assert sum(len(s) for s in port_saved) == (check_distance + 1) + (FRAMES - check_distance - 1) * check_distance
    _assert_states_equal(port_ex.state, jax_ex.state)
    if name == "boxgame":
        ref = port_game.init_state_np()
        for f in range(FRAMES):
            ref = port_game.advance_np(ref, inputs[f])
        _assert_states_equal(port_ex.state, ref)


@pytest.mark.parametrize("check_distance", [0, 1, 2, 4])
def test_executor_matches_numpy_mirror(check_distance):
    # tests/test_device_executor.py's oracle, on the port
    game = BoxGame(2)
    inputs = np.random.default_rng(13).integers(0, 16, size=(30, 2)).astype(np.uint8)
    ex, _ = _port_run(game, inputs, check_distance)
    ref = game.init_state_np()
    for f in range(30):
        ref = game.advance_np(ref, inputs[f])
    for k in ("pos", "vel", "rot"):
        np.testing.assert_array_equal(ex.state[k].numpy(), ref[k], err_msg=k)


def test_checksums_are_u128_and_match_pytree_checksum():
    game = BoxGame(2)
    sess = SessionBuilder(boxgame_config()).with_check_distance(1).start_synctest_session()
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs, device="cpu")
    sess.add_local_input(0, 1)
    sess.add_local_input(1, 2)
    reqs = sess.advance_frame()
    ex.run(reqs)
    (save,) = [r for r in reqs if isinstance(r, SaveGameState)]
    assert save.frame == 0 and 0 <= save.cell.checksum < (1 << 128)
    assert save.cell.checksum == pytree_checksum(save.cell.data())


def test_state_keeps_the_jax_single_state_layout():
    vm = ChipVM(2)
    ex, _ = _port_run(vm, np.zeros((12, 2), np.uint8), 2)
    st = ex.state
    assert st["mem"].shape == (256,) and st["regs"].shape == (4,) and st["pc"].dim() == 0
    assert all(leaf.dtype == torch.uint8 for leaf in tree_leaves(st))


def test_checksums_off_gives_none_and_the_same_states():
    game = BoxGame(2)
    inputs = np.random.default_rng(2).integers(0, 16, size=(FRAMES, 2)).astype(np.uint8)
    on, _ = _port_run(game, inputs, 3)
    off, saved = _port_run(game, inputs, 3, with_checksums=False)
    assert all(cs is None for frame in saved for _, cs in frame)
    assert sum(len(frame) for frame in saved) > 0
    for k in ("pos", "vel", "rot"):
        assert torch.equal(on.state[k], off.state[k])


def test_shared_programs_serve_several_executors():
    game = BoxGame(2)
    programs = ExecutorPrograms(game.advance)
    inputs = np.random.default_rng(6).integers(0, 16, size=(20, 2)).astype(np.uint8)
    a, saved_a = _port_run(game, inputs, 2, programs=programs)
    b, saved_b = _port_run(game, inputs, 2, programs=programs)
    c, saved_c = _port_run(game, inputs, 2)
    assert saved_a == saved_b == saved_c
    for k in ("pos", "vel", "rot"):
        assert torch.equal(a.state[k], b.state[k]) and torch.equal(a.state[k], c.state[k])


def test_shared_programs_identity_is_checked():
    game, other = BoxGame(2), BoxGame(3)
    programs = ExecutorPrograms(game.advance)
    with pytest.raises(AssertionError, match="different advance"):
        DeviceRequestExecutor(other.advance, other.init_state_np(), _port_inputs,
                              programs=programs, device="cpu")
    with pytest.raises(AssertionError, match="with_checksums"):
        DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs,
                              with_checksums=False, programs=programs, device="cpu")
    # a fresh bound method of the same game compares equal
    DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs,
                          programs=programs, device="cpu")


def test_warmup_leaves_the_state_unchanged():
    vm = ChipVM(2)
    ex = DeviceRequestExecutor(vm.advance, vm.init_state_np(), _port_inputs, device="cpu")
    before = ex.state
    copies = tree_map(torch.clone, before)
    ex.warmup(np.array([3, 4], np.uint8), burst_depths=range(1, 10))
    assert ex.state is before
    for k in before:
        assert torch.equal(ex.state[k], copies[k])


def test_collect_burst_groups_as_jax_does():
    # the same shapes of request list through both packages' grouping
    patterns = ["A", "AS", "AA", "ASA", "ASAS", "AASA", "ASASA", "SA", "ASL"]
    for p in patterns:
        def build(core):
            cell = None
            out = []
            for ch in p:
                if ch == "A":
                    out.append(core.AdvanceFrame(inputs=[]))
                elif ch == "S":
                    out.append(core.SaveGameState(cell=cell, frame=0))
                else:
                    out.append(core.LoadGameState(cell=cell, frame=0))
            return out

        def shape(pairs, saves, j):
            return len(pairs), [s is not None for s in saves], j

        got = shape(*DeviceRequestExecutor._collect_burst(build(tcore), 0))
        want = shape(*JaxExecutor._collect_burst(build(jcore), 0))
        assert got == want, p


# -- bursts built by hand --------------------------------------------------------


def _advance(v0, v1):
    return AdvanceFrame(inputs=[(v0, C), (v1, C)])


def _saved_cell(ex, frame=0):
    cell = GameStateCell()
    ex.run([SaveGameState(cell=cell, frame=frame)])
    return cell


def test_load_followed_by_nothing_makes_the_cell_live():
    game = BoxGame(2)
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs, device="cpu")
    cell = _saved_cell(ex)
    ex.run([_advance(1, 2), _advance(4, 8)])
    ex.run([LoadGameState(cell=cell, frame=0)])
    assert ex.state is cell.data()


def test_burst_whose_every_step_is_saved():
    game = BoxGame(2)
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs, device="cpu")
    moves = [(1, 2), (4, 8), (5, 9), (8, 1)]
    cells = [GameStateCell() for _ in moves]
    reqs = []
    for k, (a, b) in enumerate(moves):
        reqs += [_advance(a, b), SaveGameState(cell=cells[k], frame=k + 1)]
    ex.run(reqs)
    ref = game.init_state_np()
    for k, (a, b) in enumerate(moves):
        ref = game.advance_np(ref, np.array([a, b], np.uint8))
        data = cells[k].data()
        for key in ref:
            np.testing.assert_array_equal(data[key].numpy(), ref[key])
        assert cells[k].checksum == pytree_checksum(data)
    assert ex.state is cells[-1].data()


def test_burst_of_one_after_a_load_is_a_single_advance():
    game = BoxGame(2)
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs, device="cpu")
    start = _saved_cell(ex)
    after = GameStateCell()
    ex.run([_advance(9, 9)])
    ex.run([LoadGameState(cell=start, frame=0), _advance(1, 2), SaveGameState(cell=after, frame=1)])
    ref = game.advance_np(game.init_state_np(), np.array([1, 2], np.uint8))
    for key in ref:
        np.testing.assert_array_equal(ex.state[key].numpy(), ref[key])
    assert after.data() is ex.state and after.checksum == pytree_checksum(ex.state)


def test_burst_steps_are_the_advance_outputs_not_the_digest_stack():
    game = BoxGame(2)
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), _port_inputs, device="cpu")
    cells = [GameStateCell() for _ in range(3)]
    ex.run([_advance(1, 2), SaveGameState(cell=cells[0], frame=1), _advance(3, 4),
            SaveGameState(cell=cells[1], frame=2), _advance(5, 6),
            SaveGameState(cell=cells[2], frame=3)])
    ptrs = {c.data()[k].untyped_storage().data_ptr() for c in cells for k in ("pos", "rot", "vel")}
    assert len(ptrs) == 9  # every saved leaf has storage of its own


# -- launch counts on the card's wrapper path ---------------------------------------


@pytest.fixture
def card_digest(monkeypatch):
    """Route every digest through the card's wrapper path, with the kernel
    replaced by the numpy emulation; yields the list of launched row counts."""
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    return calls


@pytest.mark.parametrize("name,check_distance", [("boxgame", 1), ("boxgame", 7), ("chipvm", 3)])
def test_one_digest_launch_per_frame(card_digest, name, check_distance):
    game = _games(name)[0]
    inputs = np.random.default_rng(8).integers(0, 16, size=(FRAMES, 2)).astype(np.uint8)
    per_frame = []
    kept = []

    def on_frame(f, reqs):
        per_frame.append(len(card_digest))
        for r in reqs:
            if isinstance(r, SaveGameState):
                kept.append((r.cell.data(), tree_map(torch.clone, r.cell.data())))

    before = tdg.state_digest.launches
    _port_run(game, inputs, check_distance, on_frame=on_frame)
    assert tdg.state_digest.launches - before == len(card_digest) == FRAMES
    assert per_frame == list(range(1, FRAMES + 1))
    d = check_distance
    assert card_digest == [1] * (d + 1) + [d] * (FRAMES - d - 1)
    # no saved state was ever written in place
    assert len(kept) == (d + 1) + (FRAMES - d - 1) * d
    for live, copy in kept:
        for a, b in zip(tree_leaves(live), tree_leaves(copy)):
            assert torch.equal(a, b)


def test_emulated_card_path_matches_jax(card_digest):
    inputs = np.random.default_rng(31).integers(0, 16, size=(FRAMES, 2)).astype(np.uint8)
    _, port_saved = _port_run(BoxGame(2), inputs, 4)
    _, jax_saved = _jax_run(JaxBoxGame(2), inputs, 4)
    assert port_saved == jax_saved and len(card_digest) == FRAMES


@pytest.mark.parametrize("check_distance,with_checksums", [(3, False), (0, True)])
def test_no_digest_launch_without_saves_or_checksums(card_digest, check_distance, with_checksums):
    inputs = np.random.default_rng(9).integers(0, 16, size=(FRAMES, 2)).astype(np.uint8)
    _port_run(BoxGame(2), inputs, check_distance, with_checksums=with_checksums)
    assert card_digest == []
