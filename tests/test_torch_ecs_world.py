"""The port's EcsWorld (BASELINE config 4: 4 players, 16-frame rollback)
against the JAX package's, on the CPU.

The same numpy-seeded inputs drive the port's batch-native ``advance``, the
JAX ``advance`` (jitted, and vmapped for batches) and both NumPy oracles;
sessions' whole carries and the digests of world states are compared too.
Tolerance: exactly 0 (every leaf is int32 fixed point)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ggrs_tpu.games import EcsWorld as JaxEcsWorld
from ggrs_tpu.ops.checksum import checksum_device as jax_checksum_device
from ggrs_tpu.ops.checksum import pytree_checksum as jax_pytree_checksum
from ggrs_tpu.sessions import DeviceSyncTestSession as JaxSession

from ggrs_tpu_torch import (
    BatchedSessions,
    DeviceSyncTestSession,
    EcsWorld,
    from_numpy,
    pytree_checksum,
    to_numpy,
)
from ggrs_tpu_torch.ops import digest as tdg
from ggrs_tpu_torch.ops.checksum import checksum_device
from ggrs_tpu_torch.utils.tree import tree_map

from test_torch_checksum import _emulated_launch, _FakeCuda
from test_torch_replay import _assert_trees_equal

CONVERGE = (10, 5, 6, 9)  # each player's rally toward the center of the world


def _inputs(n, players, seed, converge=0):
    """Random bitmasks; the first ``converge`` frames steer every rally
    toward the center, so that units meet, fight and respawn."""
    ins = np.random.default_rng(seed).integers(0, 16, size=(n, players)).astype(np.uint8)
    ins[:converge] = CONVERGE[:players]
    return ins


def _batch(state, b=1):
    return {k: v.unsqueeze(0).expand(b, *v.shape).clone() for k, v in from_numpy(state, "cpu").items()}


def _assert_state_equal(got, want, what=""):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype == np.int32, (what, k)
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("players,epp", [(4, 8), (2, 4)])
def test_advance_matches_jax_and_oracles(players, epp):
    port, jx = EcsWorld(players, epp), JaxEcsWorld(players, epp)
    ins = _inputs(40, players, seed=2)
    s_t = _batch(port.init_state_np())
    s_j, s_o, s_jo = jx.init_state(), port.init_state_np(), jx.init_state_np()
    adv = jax.jit(jx.advance)
    for i in range(len(ins)):
        s_t = port.advance(s_t, torch.from_numpy(ins[i][None]))
        s_j = adv(s_j, jnp.asarray(ins[i]))
        s_o, s_jo = port.advance_np(s_o, ins[i]), jx.advance_np(s_jo, ins[i])
        got = {k: v[0] for k, v in to_numpy(s_t).items()}
        _assert_state_equal(got, jax.device_get(s_j), f"frame {i} jax")
        _assert_state_equal(s_o, s_jo, f"frame {i} oracles")
        _assert_state_equal(got, s_o, f"frame {i} port oracle")


def test_init_state_matches_jax():
    for players, epp in ((4, 32), (3, 5)):
        _assert_state_equal(to_numpy(EcsWorld(players, epp).init_state("cpu")),
                            jax.device_get(JaxEcsWorld(players, epp).init_state()))


def test_batch_native_matches_three_jax_runs():
    port, jx = EcsWorld(4, 8), JaxEcsWorld(4, 8)
    ins = np.stack([_inputs(60, 4, seed=s, converge=c) for s, c in ((3, 0), (4, 40), (5, 60))])
    s_t = _batch(port.init_state_np(), 3)
    adv = jax.jit(jx.advance)
    runs = [jx.init_state() for _ in range(3)]
    for i in range(ins.shape[1]):
        s_t = port.advance(s_t, torch.from_numpy(ins[:, i]))
        runs = [adv(s, jnp.asarray(ins[b, i])) for b, s in enumerate(runs)]
    got = to_numpy(s_t)
    for b, s in enumerate(runs):
        _assert_state_equal({k: v[b] for k, v in got.items()}, jax.device_get(s), f"session {b}")
    # the three sessions took different paths
    assert not np.array_equal(got["pos"][0], got["pos"][2])


def test_contact_and_respawn_invariants():
    """``tests/test_ecs_world.py``'s invariant on the port: with both rallies
    at the center, units collide, health stays in 1..100, and dead units
    respawn; bitwise the JAX oracle's run at every frame."""
    world, jx = EcsWorld(2, 4), JaxEcsWorld(2, 4)
    s = world.init_state_np()
    s["rally"] = np.asarray([[512 << 16, 512 << 16], [512 << 16, 512 << 16]], np.int32)
    ref = {k: v.copy() for k, v in s.items()}
    st = _batch(s)
    inputs = torch.zeros((1, 2), dtype=torch.uint8)
    took_damage = respawned = False
    prev = s["health"]
    for _ in range(600):
        st = world.advance(st, inputs)
        ref = jx.advance_np(ref, np.zeros(2, np.uint8))
        health = st["health"][0].numpy()
        assert np.all(health >= 1) and np.all(health <= 100)
        took_damage |= bool(np.any(health < 100))
        respawned |= bool(np.any((health == 100) & (prev < 100)))
        prev = health
    assert took_damage, "units never made contact"
    assert respawned, "no unit died and respawned"
    _assert_state_equal({k: v[0] for k, v in to_numpy(st).items()}, ref)


def test_digest_of_a_world_matches_jax():
    # the leaf order (dict keys sorted) and the int32 salt of every leaf,
    # owner included, must give the JAX package's lanes and u128
    world = EcsWorld(4, 32)
    s = world.init_state_np()
    for i in range(5):
        s = world.advance_np(s, _inputs(5, 4, seed=8, converge=5)[i])
    s["health"][3] = 17  # a state no init could give
    want = np.asarray(jax_checksum_device(jax.tree_util.tree_map(jnp.asarray, s)))
    got = checksum_device(_batch(s))[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert pytree_checksum(from_numpy(s, "cpu")) == jax_pytree_checksum(s)


def _melee(world, frames=200):
    """A world after ``frames`` converging frames: units in contact."""
    s = world.init_state_np()
    for inp in _inputs(frames, world.num_players, seed=6, converge=frames):
        s = world.advance_np(s, inp)
    return s


@pytest.mark.parametrize("start", ["init", "melee"])
def test_device_synctest_carry_matches_jax_at_d16(start):
    # tests/test_ecs_world.py's 16-frame rollback session, whole carry, from
    # the initial world and from a world in melee (contact and respawns in
    # every window)
    world, jx, d = EcsWorld(4, 8), JaxEcsWorld(4, 8), 16
    init = world.init_state_np() if start == "init" else _melee(world)
    ins = _inputs(80, 4, seed=9)
    port = DeviceSyncTestSession(world.advance, init, np.zeros(4, np.uint8),
                                 check_distance=d, max_prediction=d, device="cpu")
    ref = JaxSession(jx.advance, jax.tree_util.tree_map(jnp.asarray, init),
                     jnp.zeros((4,), jnp.uint8), check_distance=d, max_prediction=d)
    port.run_ticks(ins[:30])
    port.run_ticks(ins[30:])
    ref.run_ticks(ins)
    assert port.current_frame == ref.current_frame == 80
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(ref._carry))
    live = init
    for i in range(80):
        live = world.advance_np(live, ins[i])
    _assert_state_equal(port.live_state(), live)
    if start == "melee":
        assert np.any(live["health"] < 100)


def test_batched_sessions_match_single_sessions_and_launch_twice_per_tick(monkeypatch):
    """B = 3 worlds in one ``BatchedSessions`` at d = 16, on the card's
    wrapper path (emulated on the CPU): a warmup tick's 2 digest launches,
    a steady tick's one a contiguous span of its window's B x 16 ring rows
    (two spans where the window wraps) and the live row batch, 0
    mismatches, and each session's carry equal to a single session's on the
    same inputs.  (The name is older: every tick launched twice when the
    window was stacked.)"""
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    world, d, ticks = EcsWorld(2, 4), 16, 24
    ins = np.stack([_inputs(ticks, 2, seed=s, converge=c) for s, c in ((1, 0), (2, 24), (3, 12))])
    batch = BatchedSessions(world.advance, world.init_state_np(), np.zeros(2, np.uint8),
                            batch_size=3, check_distance=d, max_prediction=d, device="cpu")
    before = tdg.state_digest.launches
    assert batch.run_ticks(ins)["mismatches"] == 0
    progs = batch.programs
    assert tdg.state_digest.launches - before == len(calls) == sum(
        progs.digest_calls(f) for f in range(ticks))
    want = [3, 3] * (d + 1)
    for f in range(d + 1, ticks):
        want += [3 * (rs.stop - rs.start) for rs, _ in progs.ring.spans(f - d + 1, d)] + [3]
    assert calls == want
    for b in range(3):
        one = DeviceSyncTestSession(world.advance, world.init_state_np(), np.zeros(2, np.uint8),
                                    check_distance=d, max_prediction=d, device="cpu")
        one.run_ticks(ins[b])
        _assert_trees_equal(to_numpy(tree_map(lambda leaf: leaf[b], batch.carry)),
                            to_numpy(one.carry))
