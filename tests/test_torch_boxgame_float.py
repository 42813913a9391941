"""The port's float32 BoxGame against the JAX package's, on the CPU.

The float variant is deterministic only within one backend: torch's
``cos``/``sin`` and XLA's may round differently in the last bit.  So the
port is held to the JAX package within ATOL (absolute, on ``pos``, ``vel``
and ``rot``) over 60 frames of numpy-seeded inputs, each package advancing
its own state; and to itself bitwise: a SyncTest session's resimulations
must reproduce every first-seen digest, and its live state must equal a
plain run of ``advance``.  Digests of the same float32 bits equal the JAX
package's exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.ops.checksum import checksum_device as jax_checksum_device

from ggrs_tpu_torch import BoxGame, DeviceSyncTestSession, from_numpy, to_numpy
from ggrs_tpu_torch.ops.checksum import checksum_device

ATOL = 1e-4
FRAMES = 60


def _inputs(n, b, players, seed):
    return np.random.default_rng(seed).integers(0, 16, size=(b, n, players)).astype(np.uint8)


def test_init_state_matches_jax_bitwise():
    for players in (2, 3, 4):
        got = BoxGame(players, "float").init_state_np()
        want = jax.device_get(JaxBoxGame(players, "float").init_state())
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("batch", [1, 4])
def test_float_advance_within_atol_of_jax(batch):
    port, jx = BoxGame(2, "float"), JaxBoxGame(2, "float")
    ins = _inputs(FRAMES, batch, 2, seed=batch)
    init = port.init_state_np()
    st = {k: v.unsqueeze(0).expand(batch, *v.shape).clone() for k, v in from_numpy(init, "cpu").items()}
    js = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(jnp.asarray(a), (batch,) + a.shape), init)
    adv = jax.jit(jax.vmap(jx.advance))
    worst = {k: 0.0 for k in init}
    for f in range(FRAMES):
        st = port.advance(st, torch.from_numpy(ins[:, f]))
        js = adv(js, jnp.asarray(ins[:, f]))
        got, want = to_numpy(st), jax.device_get(js)
        for k in want:
            assert got[k].dtype == np.float32, k
            worst[k] = max(worst[k], float(np.abs(got[k] - want[k]).max()))
    assert all(w <= ATOL for w in worst.values()), worst
    assert np.abs(got["pos"] - init["pos"]).max() > 1.0  # the ships moved


def test_float_synctest_session_is_bitwise_repeatable():
    game = BoxGame(2, "float")
    ins = _inputs(200, 1, 2, seed=7)[0]
    sess = DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                 check_distance=8, device="cpu")
    sess.run_ticks(ins[:50])
    sess.run_ticks(ins[50:])  # raises MismatchedChecksum on any diverged resimulation
    assert int(sess.carry["mismatches"]) == 0
    st = {k: v.unsqueeze(0) for k, v in from_numpy(game.init_state_np(), "cpu").items()}
    for f in range(len(ins)):
        st = game.advance(st, torch.from_numpy(ins[f][None]))
    live = sess.live_state()
    for k, v in to_numpy(st).items():
        np.testing.assert_array_equal(live[k], v[0], err_msg=k)


def test_float_digest_matches_jax():
    s = BoxGame(3, "float").init_state_np()
    s["vel"][1] = [-0.0, np.float32(1e-30)]  # sign and denormal bits count
    want = np.asarray(jax_checksum_device(jax.tree_util.tree_map(jnp.asarray, s)))
    got = checksum_device({k: v.unsqueeze(0) for k, v in from_numpy(s, "cpu").items()})
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want)


def test_float_variant_has_no_numpy_oracle():
    game = BoxGame(2, "float")
    with pytest.raises(ValueError, match="fixed variant"):
        game.advance_np(game.init_state_np(), np.zeros(2, np.uint8))
    with pytest.raises(ValueError):
        BoxGame(2, "double")
