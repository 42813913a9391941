"""The port's batch-native games against the JAX package's ``advance`` and
the NumPy oracles, bit for bit (integer simulations: tolerance exactly 0).

Each rollout is 200 frames of numpy-seeded random inputs, run batched (the
port's B sessions against a vmapped JAX advance) and with B = 1."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM

from ggrs_tpu_torch import BoxGame, ChipVM, from_numpy, to_numpy

FRAMES = 200


def _stack(states):
    return {k: np.stack([s[k] for s in states]) for k in states[0]}


def _rollout(port_game, jax_game, inputs):
    """Run ``inputs`` (B, FRAMES, P) through the port (batched), the vmapped
    JAX advance and the port's NumPy oracle per session; compare every
    frame's state."""
    b = inputs.shape[0]
    init = port_game.init_state_np()
    port = {k: v.unsqueeze(0).expand(b, *v.shape).clone() for k, v in from_numpy(init, "cpu").items()}
    jx = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(jnp.asarray(a), (b,) + np.shape(a)), init)
    oracle = [init] * b
    jadv = jax.jit(jax.vmap(jax_game.advance))
    for f in range(FRAMES):
        port = port_game.advance(port, torch.from_numpy(inputs[:, f]))
        jx = jadv(jx, jnp.asarray(inputs[:, f]))
        oracle = [port_game.advance_np(oracle[i], inputs[i, f]) for i in range(b)]
        got, want_j, want_o = to_numpy(port), jax.device_get(jx), _stack(oracle)
        for k in want_o:
            assert got[k].dtype == want_o[k].dtype, k
            np.testing.assert_array_equal(got[k], want_j[k], err_msg=f"jax {k} frame {f}")
            np.testing.assert_array_equal(got[k], want_o[k], err_msg=f"oracle {k} frame {f}")


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("players", [2, 3, 4])
def test_boxgame_matches_jax_and_oracle(players, batch):
    rng = np.random.default_rng(10 * players + batch)
    inputs = rng.integers(0, 16, size=(batch, FRAMES, players)).astype(np.uint8)
    _rollout(BoxGame(players), JaxBoxGame(players), inputs)


@pytest.mark.parametrize("batch", [1, 4])
def test_chipvm_matches_jax_and_oracle(batch):
    rng = np.random.default_rng(batch)
    inputs = rng.integers(0, 256, size=(batch, FRAMES, 2)).astype(np.uint8)
    _rollout(ChipVM(2), JaxChipVM(2), inputs)


def test_init_states_match_jax():
    for port_game, jax_game in ((BoxGame(3), JaxBoxGame(3)), (ChipVM(2), JaxChipVM(2))):
        got = to_numpy(port_game.init_state("cpu"))
        want = jax.device_get(jax_game.init_state())
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == np.asarray(want[k]).dtype


def test_boxgame_oracle_matches_jax_oracle():
    # the port keeps its own copy of the NumPy oracle: same numbers as the
    # JAX package's
    rng = np.random.default_rng(0)
    a, b = BoxGame(2), JaxBoxGame(2)
    sa, sb = a.init_state_np(), b.init_state_np()
    for _ in range(50):
        inp = rng.integers(0, 16, 2).astype(np.uint8)
        sa, sb = a.advance_np(sa, inp), b.advance_np(sb, inp)
    for k in sb:
        np.testing.assert_array_equal(sa[k], sb[k])


def test_chipvm_uint8_wraparound():
    # inputs of 255 make r0 += r1 wrap; the batched uint8 path must wrap as
    # the oracle does
    vm = ChipVM(2)
    inp = np.full((1, 2), 255, np.uint8)
    state = {k: v.unsqueeze(0) for k, v in vm.init_state("cpu").items()}
    ref = vm.init_state_np()
    for _ in range(20):
        state = vm.advance(state, torch.from_numpy(inp))
        ref = vm.advance_np(ref, inp[0])
    got = to_numpy(state)
    for k in ref:
        np.testing.assert_array_equal(got[k][0], ref[k])
