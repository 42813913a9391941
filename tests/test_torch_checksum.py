"""The port's state digest against the JAX package's, bit for bit.

Every path is integer arithmetic mod 2^32, so the tolerance is exactly 0:
the port's plain ``lane_sums_rows`` must equal ``ggrs_tpu.ops.checksum.
lane_sums`` and the Pallas kernel (interpret mode), and the port's
``checksum_device`` must equal the JAX ``checksum_device`` on every state.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM
from ggrs_tpu.ops import checksum as jck
from ggrs_tpu.ops import pallas_checksum as jpc

from ggrs_tpu_torch import from_numpy
from ggrs_tpu_torch.ops import checksum as tck
from ggrs_tpu_torch.ops.digest import lane_sums_rows, lane_sums_rows_plain
from ggrs_tpu_torch.utils.tree import tree_map

BLOCK = jpc._BLOCK_ROWS * jpc._LANES
SIZES = [1, 100, jpc._LANES, BLOCK, BLOCK + 1, 3 * BLOCK - 7]


def _words(n, seed, rows=None):
    shape = (n,) if rows is None else (rows, n)
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


def _port_rows(words_u32, offset=0):
    """The port's plain lanes of a (R, W) uint32 array, back as uint32."""
    t = torch.from_numpy(np.ascontiguousarray(words_u32).view(np.int32))
    return lane_sums_rows(t, offset).numpy().view(np.uint32)


def _port_digest(state):
    """The port's digest of ONE numpy state (batch of 1), as uint32."""
    batched = tree_map(lambda v: v.unsqueeze(0), from_numpy(state, "cpu"))
    return tck.checksum_device(batched).numpy().view(np.uint32)[0]


def _jax_digest(state):
    return np.asarray(jck.checksum_device(jax.tree_util.tree_map(jnp.asarray, state)))


# -- lane sums -------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 5, 2**31 + 3, 2**32 - 2])
@pytest.mark.parametrize("n", SIZES)
def test_plain_lane_sums_match_jax(n, offset):
    w = _words(n, seed=n)
    want = np.asarray(jck.lane_sums(jnp.asarray(w), offset))
    np.testing.assert_array_equal(_port_rows(w[None], offset)[0], want)


@pytest.mark.parametrize("n", SIZES)
def test_plain_lane_sums_match_pallas_kernel(n):
    w = _words(n, seed=100 + n)
    want = np.asarray(jpc.leaf_digest_pallas(jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(_port_rows(w[None])[0], want)


def test_lane_sums_all_zero_words_are_index_dependent():
    # all-zero words: lanes 0-2 are 0, lane 3 is sum(idx * PRIME_B), so a
    # wrong offset or a dropped word would change it
    for n in (BLOCK // 2 + 3, 2 * BLOCK + 17):
        w = np.zeros((1, n), np.uint32)
        got = _port_rows(w, 7)[0]
        assert got[0] == got[1] == got[2] == 0
        np.testing.assert_array_equal(got, np.asarray(jck.lane_sums(jnp.asarray(w[0]), 7)))


@pytest.mark.parametrize("rows,width,offset", [(5, 66, 0), (16, 66, 5), (3, 4097, 11)])
def test_batched_rows_equal_row_by_row(rows, width, offset):
    w = _words(width, seed=rows, rows=rows)
    got = _port_rows(w, offset)
    for r in range(rows):
        np.testing.assert_array_equal(got[r], _port_rows(w[r:r + 1], offset)[0])
        np.testing.assert_array_equal(
            got[r], np.asarray(jck.lane_sums(jnp.asarray(w[r]), offset))
        )


def test_chunk_additivity():
    w = _words(1000, seed=4)
    whole = _port_rows(w[None])[0]
    parts = _port_rows(w[None, :333])[0] + _port_rows(w[None, 333:], 333)[0]
    np.testing.assert_array_equal(whole, parts)


def test_rotation_uses_a_logical_shift():
    # words with the top bit set: an arithmetic >> 19 would smear sign bits
    # into lane 3
    w = np.array([[0x80000000, 0xFFFFFFFF, 0xF0F0F0F1]], np.uint32)
    want = np.asarray(jck.lane_sums(jnp.asarray(w[0])))
    np.testing.assert_array_equal(_port_rows(w)[0], want)


def test_module_lane_sums_matches_rows_form():
    w = _words(77, seed=9)
    got = tck.lane_sums(torch.from_numpy(w.view(np.int32)), 3).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jck.lane_sums(jnp.asarray(w), 3)))


# -- the wrapper's contract ------------------------------------------------


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    w = torch.from_numpy(_words(66, seed=1, rows=4).view(np.int32))
    before = lane_sums_rows.launches
    np.testing.assert_array_equal(lane_sums_rows(w, 2).numpy(), lane_sums_rows_plain(w, 2).numpy())
    assert lane_sums_rows.launches == before  # the plain version launches nothing


@pytest.mark.parametrize(
    "bad,exc",
    [
        (torch.zeros((2, 3), dtype=torch.int64), TypeError),
        (torch.zeros((6,), dtype=torch.int32), ValueError),
        (torch.zeros((3, 4), dtype=torch.int32).t(), ValueError),
        (torch.zeros((2, 3), dtype=torch.int32, device="meta"), ValueError),
    ],
    ids=["dtype", "rank", "contiguity", "device"],
)
def test_wrapper_rejects_bad_inputs(bad, exc):
    with pytest.raises(exc):
        lane_sums_rows(bad)


# -- word views and the structure salt -------------------------------------


def test_sub_word_leaves_pack_little_endian_with_zero_padding():
    x = np.array([0x01, 0x02, 0x03, 0x04, 0x05], np.uint8)
    words = tck._as_u32_words(torch.from_numpy(x)[None]).numpy().view(np.uint32)[0]
    np.testing.assert_array_equal(words, np.asarray(jck._as_u32_words(jnp.asarray(x))))
    np.testing.assert_array_equal(words, [0x04030201, 0x00000005])


def test_zero_d_uint8_is_one_word():
    x = torch.tensor([7], dtype=torch.uint8)  # batch of one 0-d leaf
    words = tck._as_u32_words(x).numpy().view(np.uint32)
    np.testing.assert_array_equal(words, [[7]])
    np.testing.assert_array_equal(words[0], np.asarray(jck._as_u32_words(jnp.uint8(7))))


def test_bool_leaves_widen_to_u8():
    x = np.array([True, False, True], bool)
    words = tck._as_u32_words(torch.from_numpy(x)[None]).numpy().view(np.uint32)[0]
    np.testing.assert_array_equal(words, np.asarray(jck._as_u32_words(jnp.asarray(x))))


def test_eight_byte_leaves_split_low_word_then_high():
    x = np.array([0x1122334455667788, -2], np.int64)
    words = tck._as_u32_words(torch.from_numpy(x)[None]).numpy().view(np.uint32)[0]
    np.testing.assert_array_equal(words, [0x55667788, 0x11223344, 0xFFFFFFFE, 0xFFFFFFFF])
    with jax.enable_x64(True):
        want = np.asarray(jck._as_u32_words(jnp.asarray(x)))
    np.testing.assert_array_equal(words, want)


def test_eight_byte_state_digest_matches_jax():
    state = {"t": np.array([1, 2**40 + 5, -9], np.int64), "f": np.array([0.5, -1.25])}
    with jax.enable_x64(True):
        want = _jax_digest(state)
    np.testing.assert_array_equal(_port_digest(state), want)


@pytest.mark.parametrize(
    "dtype",
    [np.bool_, np.uint8, np.int8, np.uint16, np.int16, np.float16, np.int32,
     np.uint32, np.float32, np.int64, np.float64],
)
def test_structure_salt_matches_numpy_kinds(dtype):
    x = np.zeros((3, 5), dtype)
    t = torch.from_numpy(x.view(np.int32) if dtype == np.uint32 else x)
    if dtype == np.uint32:
        t = t.view(torch.uint32)
    got = tck._structure_salt([(tuple(t.shape), t.dtype)])
    np.testing.assert_array_equal(got, jck._structure_salt([x]))


def test_bfloat16_salt_kind_matches_jax():
    x = jnp.zeros((4,), jnp.bfloat16)
    got = tck._structure_salt([((4,), torch.bfloat16)])
    np.testing.assert_array_equal(got, jck._structure_salt([x]))


# -- whole-state digests ---------------------------------------------------


def _mixed_state(seed):
    rng = np.random.default_rng(seed)
    return {
        "flag": rng.integers(0, 2, size=(3,)).astype(bool),
        "bytes": rng.integers(0, 256, size=(7,)).astype(np.uint8),  # odd length
        "shorts": rng.integers(-(2**15), 2**15, size=(5,)).astype(np.int16),
        "half": rng.standard_normal(3).astype(np.float16),
        "pc": np.uint8(rng.integers(0, 256)),  # 0-d leaf
        "scalar": np.int32(rng.integers(-(2**31), 2**31)),  # 0-d leaf
        "f32": rng.standard_normal((2, 3)).astype(np.float32),
        "nested": {"b": np.arange(4, dtype=np.int32), "a": np.uint8(9)},
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_dtype_pytree_matches_jax(seed):
    state = _mixed_state(seed)
    np.testing.assert_array_equal(_port_digest(state), _jax_digest(state))


def test_empty_pytree_returns_init_lanes():
    got = tck.checksum_device({}, device="cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(got[0], _jax_digest({}))
    np.testing.assert_array_equal(got[0], np.asarray(tck._INIT_LANES, np.uint32))


@pytest.mark.parametrize("players", [2, 3, 4])
def test_boxgame_state_matches_jax(players):
    # dict insertion order pos, vel, rot; jax digests pos, rot, vel
    game = JaxBoxGame(players)
    state = game.init_state_np()
    rng = np.random.default_rng(players)
    for _ in range(10):
        state = game.advance_np(state, rng.integers(0, 16, players).astype(np.uint8))
    assert list(state) == ["pos", "vel", "rot"]
    np.testing.assert_array_equal(_port_digest(state), _jax_digest(state))


def test_chipvm_state_matches_jax():
    # insertion order mem, regs, pc; jax digests mem, pc, regs
    vm = JaxChipVM(2)
    state = vm.init_state_np()
    rng = np.random.default_rng(3)
    for _ in range(5):
        state = vm.advance_np(state, rng.integers(0, 256, 2).astype(np.uint8))
    np.testing.assert_array_equal(_port_digest(state), _jax_digest(state))


def test_large_multi_leaf_state_matches_jax():
    # over the JAX package's 4096-word concat threshold: it sums per-leaf
    # offset digests there, the port concatenates; the values must agree
    rng = np.random.default_rng(8)
    state = {
        "a": rng.integers(0, 2**31, size=(3000,)).astype(np.int32),
        "b": rng.integers(0, 256, size=(5001,)).astype(np.uint8),
    }
    np.testing.assert_array_equal(_port_digest(state), _jax_digest(state))


def test_batched_digest_rows_equal_per_session_digests():
    states = [_mixed_state(s) for s in range(4)]
    per = [from_numpy(s, "cpu") for s in states]
    batched = jax.tree_util.tree_map(lambda *xs: torch.stack(xs), *per)
    got = tck.checksum_device(batched).numpy().view(np.uint32)
    for b, s in enumerate(states):
        np.testing.assert_array_equal(got[b], _jax_digest(s))


def test_u128_composition_matches_jax():
    state = _mixed_state(5)
    want = jck.pytree_checksum(jax.tree_util.tree_map(jnp.asarray, state))
    assert tck.pytree_checksum(from_numpy(state, "cpu")) == want
    lanes = tck.checksum_device(tree_map(lambda v: v.unsqueeze(0), from_numpy(state, "cpu")))[0]
    lazy = tck.DeviceChecksum(lanes)
    assert int(lazy) == want and lazy == want and hash(lazy) == hash(want)
