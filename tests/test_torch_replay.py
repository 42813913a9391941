"""The port's device replay against the JAX package's, whole carry at once.

The same numpy-seeded inputs drive a JAX session and a port session (on the
CPU); their carries -- state ring, input ring, digest history, live state,
frame and desync counters -- must be equal leaf for leaf (tolerance exactly
0: every path is integer)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM
from ggrs_tpu.parallel import BatchedSessions as JaxBatchedSessions
from ggrs_tpu.parallel import make_mesh
from ggrs_tpu.sessions import DeviceSyncTestSession as JaxSession

from ggrs_tpu_torch import (
    BatchedSessions,
    BoxGame,
    ChipVM,
    DeviceStateRing,
    DeviceSyncTestSession,
    InvalidRequest,
    MismatchedChecksum,
    build_replay_programs,
    to_numpy,
)
from ggrs_tpu_torch.ops.checksum import checksum_device
from ggrs_tpu_torch.utils.tree import tree_leaves


def _inputs(n, players, seed, high=16):
    return np.random.default_rng(seed).integers(0, high, size=(n, players)).astype(np.uint8)


def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype, f"{path}/{k}: {got[k].dtype} != {w.dtype}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}/{k}")


def _session_pair(check_distance=2, players=2):
    port = DeviceSyncTestSession(
        BoxGame(players).advance, BoxGame(players).init_state_np(),
        np.zeros(players, np.uint8), check_distance=check_distance, device="cpu",
    )
    jx = JaxSession(
        JaxBoxGame(players).advance, JaxBoxGame(players).init_state(),
        jnp.zeros((players,), jnp.uint8), check_distance=check_distance,
    )
    return port, jx


@pytest.mark.parametrize("d", [1, 4, 8])
def test_workload_per_tick_matches_jax(d):
    # the two numbers that turn the flagship's ticks into resimulated frames/s
    port, jx = _session_pair(check_distance=d)
    assert port.resim_frames_per_tick == jx.resim_frames_per_tick == d
    assert port.requests_per_tick == jx.requests_per_tick == 2 * d + 2
    inputs = _inputs(2 * d + 2, 2, seed=d)
    port.run_ticks(inputs)
    jx.run_ticks(inputs)
    assert (port.resim_frames_per_tick, port.requests_per_tick) == \
        (jx.resim_frames_per_tick, jx.requests_per_tick)


@pytest.mark.parametrize("splits", [[7, 13, 29], [40]], ids=["across-warmup", "one-call"])
def test_boxgame_session_carry_matches_jax(splits):
    inputs = _inputs(64, 2, seed=9)
    port, jx = _session_pair(check_distance=8)
    for chunk in np.split(inputs, splits):
        port.run_ticks(chunk)
        jx.run_ticks(chunk)
    assert port.current_frame == jx.current_frame == 64
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(jx._carry))


def test_boxgame_session_matches_numpy_oracle():
    game = BoxGame(2)
    inputs = _inputs(64, 2, seed=5)
    port, _ = _session_pair(check_distance=8)
    port.run_ticks(inputs, check=False)
    port.verify()
    ref = game.init_state_np()
    for i in range(64):
        ref = game.advance_np(ref, inputs[i])
    _assert_trees_equal(port.live_state(), ref)


def test_nondeterministic_game_caught():
    # corrupt the saved state the next rollback reloads: at frame 10 with
    # check_distance=2 the next steady tick loads frame 8, and its resim of
    # frame 9 must diverge from frame 9's first-seen digest
    port, jx = _session_pair()
    for s in (port, jx):
        s.run_ticks(_inputs(10, 2, seed=1))
    slot = 8 % port.programs.ring.length
    port.carry["ring"]["states"]["pos"][slot, 0, 0] += 1
    jx._carry["ring"]["states"]["pos"] = jx._carry["ring"]["states"]["pos"].at[slot, 0, 0].add(1)
    with pytest.raises(MismatchedChecksum) as ei:
        port.run_ticks(_inputs(10, 2, seed=2))
    reports = [ei.value.mismatched_frames]
    with pytest.raises(Exception) as ej:  # the JAX package's own error class
        jx.run_ticks(_inputs(10, 2, seed=2))
    reports.append(ej.value.mismatched_frames)
    assert reports == [[9], [9]]


def test_all_window_mismatches_reported():
    # corrupting the first-seen history of two window frames makes both
    # resimulations diverge; every divergent frame must be listed
    port, jx = _session_pair()
    for s in (port, jx):
        s.run_ticks(_inputs(10, 2, seed=1))
    r = port.programs.ring.length
    for frame in (9, 10):
        port.carry["hist"][frame % r] = 0xBAD
        jx._carry["hist"] = jx._carry["hist"].at[frame % r].set(jnp.uint32(0xBAD))
    with pytest.raises(MismatchedChecksum) as ei:
        port.run_ticks(_inputs(1, 2, seed=2))
    port_frames = ei.value.mismatched_frames
    with pytest.raises(Exception) as ej:
        jx.run_ticks(_inputs(1, 2, seed=2))
    assert port_frames == ej.value.mismatched_frames == [9, 10]


def test_deferred_check_surfaces_at_verify():
    port, _ = _session_pair()
    port.run_ticks(_inputs(10, 2, seed=1))
    port.carry["ring"]["states"]["vel"][8 % port.programs.ring.length, 1, 1] -= 3
    port.run_ticks(_inputs(4, 2, seed=2), check=False)  # no raise: deferred
    with pytest.raises(MismatchedChecksum):
        port.verify()


def test_check_distance_zero_rejected():
    with pytest.raises(InvalidRequest):
        DeviceSyncTestSession(
            BoxGame(2).advance, BoxGame(2).init_state_np(), np.zeros(2, np.uint8),
            check_distance=0, device="cpu",
        )


def test_chipvm_batched_sessions_carry_matches_jax():
    b, d = 8, 8
    rng = np.random.default_rng(3)
    inputs = rng.integers(0, 256, size=(b, 24, 2)).astype(np.uint8)
    vm = ChipVM(2)
    port = BatchedSessions(
        vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=b,
        check_distance=d, device="cpu",
    )
    jvm = JaxChipVM(2)
    jx = JaxBatchedSessions(
        jvm.advance, jvm.init_state(), jnp.zeros((2,), jnp.uint8), batch_size=b,
        mesh=make_mesh(1), check_distance=d,
    )
    for chunk in (inputs[:, :5], inputs[:, 5:]):
        assert port.run_ticks(chunk) == jx.run_ticks(chunk)
    assert port.verify() == {"mismatches": 0, "first_bad": 2**31 - 1}
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(jx._carry))
    _assert_trees_equal(port.live_states(), jax.device_get(jx.live_states()))


def test_batched_sessions_count_every_session_mismatch():
    vm = ChipVM(2)
    port = BatchedSessions(
        vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=4,
        check_distance=2, device="cpu",
    )
    port.run_ticks(np.zeros((4, 10, 2), np.uint8))
    r = port._programs.ring.length
    port.carry["hist"][1, 9 % r] = 1  # session 1, frame 9
    port.carry["hist"][3, 10 % r] = 1  # session 3, frame 10
    stats = port.run_ticks(np.zeros((4, 1, 2), np.uint8))
    assert stats == {"mismatches": 2, "first_bad": 9}


def test_ring_save_where_and_window_wrap():
    ring = DeviceStateRing(4)
    state = {"x": torch.zeros((2, 3), dtype=torch.int32)}
    buf = ring.init(state)
    cs = torch.ones((2, 4), dtype=torch.int32)
    ring.save_where(buf, 5, {"x": torch.full((2, 3), 7, dtype=torch.int32)}, cs,
                    torch.tensor([True, False]))
    assert ring.frame_at(buf, 5).tolist() == [5, -1]
    assert ring.load(buf, 5)["x"].tolist() == [[7, 7, 7], [0, 0, 0]]
    assert ring.load_checksum(buf, 5).tolist() == [[1] * 4, [0] * 4]
    # a 3-frame window from frame 3 wraps: slots 3, 0, 1 (slot 2 untouched)
    vals = torch.arange(2 * 3 * 3, dtype=torch.int32).reshape(2, 3, 3)
    ring.save_many(buf, 3, {"x": vals}, torch.zeros((2, 3, 4), dtype=torch.int32))
    assert buf["frames"].tolist() == [[4, 5, -1, 3], [4, 5, -1, 3]]
    np.testing.assert_array_equal(
        ring.read_window(buf["states"]["x"], 3, 3).numpy(), vals.numpy()
    )


def test_replay_programs_validate_their_window():
    with pytest.raises(ValueError):
        build_replay_programs(BoxGame(2).advance, ring_length=3, check_distance=3)
    progs = build_replay_programs(BoxGame(2).advance, ring_length=9, check_distance=8)
    assert progs.warmup_ticks == 9
    assert progs.split_at_warmup(0, 20) == 9
    assert progs.split_at_warmup(5, 20) == 4
    assert progs.split_at_warmup(9, 20) == 0


# -- the folded resim digest -------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 5, 8])
def test_folded_steady_ticks_carry_matches_jax(d):
    # warmup, then 20 steady ticks whose d resim digests are one call each
    ticks = d + 1 + 20
    inputs = _inputs(ticks, 3, seed=20 + d)
    port = DeviceSyncTestSession(
        BoxGame(3).advance, BoxGame(3).init_state_np(), np.zeros(3, np.uint8),
        check_distance=d, device="cpu",
    )
    jx = JaxSession(
        JaxBoxGame(3).advance, JaxBoxGame(3).init_state(), jnp.zeros((3,), jnp.uint8),
        check_distance=d,
    )
    port.run_ticks(inputs)
    jx.run_ticks(inputs)
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(jx._carry))


def test_chipvm_folded_steady_ticks_carry_matches_jax():
    b, d = 4, 3
    inputs = np.random.default_rng(21).integers(0, 256, size=(b, d + 1 + 20, 2)).astype(np.uint8)
    vm = ChipVM(2)
    port = BatchedSessions(
        vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=b,
        check_distance=d, max_prediction=d, device="cpu",
    )
    jvm = JaxChipVM(2)
    jx = JaxBatchedSessions(
        jvm.advance, jvm.init_state(), jnp.zeros((2,), jnp.uint8), batch_size=b,
        mesh=make_mesh(1), check_distance=d, max_prediction=d,
    )
    assert port.run_ticks(inputs) == jx.run_ticks(inputs)
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(jx._carry))


@pytest.mark.parametrize("b,d", [(1, 8), (3, 2)])
def test_every_tick_makes_two_digest_calls(b, d):
    calls = []

    def counting(state):
        calls.append(tree_leaves(state)[0].shape[0])
        return checksum_device(state)

    game = BoxGame(2)
    progs = build_replay_programs(game.advance, ring_length=d + 1, check_distance=d,
                                  checksum=counting)
    carry = progs.init_carry(game.init_state_np(), np.zeros(2, np.uint8), batch_size=b,
                             device="cpu")
    inputs = torch.from_numpy(_inputs(b * (d + 1 + 4), 2, seed=3).reshape(b, d + 1 + 4, 2))
    progs.run_warmup(carry, inputs[:, : d + 1], 0)
    assert calls == [b, b] * (d + 1)
    del calls[:]
    progs.run_steady(carry, inputs[:, d + 1:], d + 1)
    assert calls == [b * d, b] * 4  # the window's B*d rows, then the live advance
    assert int(carry["mismatches"].sum()) == 0
