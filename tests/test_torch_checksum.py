"""The port's state digest against the JAX package's, bit for bit.

Every path is integer arithmetic mod 2^32, so the tolerance is exactly 0:
the port's plain ``lane_sums_rows`` must equal ``ggrs_tpu.ops.checksum.
lane_sums`` and the Pallas kernel (interpret mode), and the port's
``checksum_device`` must equal the JAX ``checksum_device`` on every state.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there)."""

import ctypes
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM
from ggrs_tpu.ops import checksum as jck
from ggrs_tpu.ops import pallas_checksum as jpc
from ggrs_tpu.sessions import DeviceSyncTestSession as JaxSession

from ggrs_tpu_torch import BoxGame, DeviceSyncTestSession, from_numpy, to_numpy
from ggrs_tpu_torch.ops import checksum as tck
from ggrs_tpu_torch.ops import digest as tdg
from ggrs_tpu_torch.ops.digest import lane_sums_rows, lane_sums_rows_plain
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

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


# -- the byte view and the kernel's leaf table -------------------------------

# numpy dtype of a session's leaf -> how its bits become a torch tensor
_DTYPES = {
    "bool": (np.bool_, None),
    "u8": (np.uint8, None),
    "i8": (np.int8, None),
    "i16": (np.int16, None),
    "u16": (np.uint16, torch.uint16),
    "f16": (np.float16, None),
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "i32": (np.int32, None),
    "u32": (np.uint32, torch.uint32),
    "f32": (np.float32, None),
    "i64": (np.int64, None),
    "u64": (np.uint64, torch.uint64),
    "f64": (np.float64, None),
}
_SIGNED_VIEW = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _np_leaf(rng, name, shape):
    """A leaf of random bits (NaN patterns included) of the named dtype."""
    np_t = np.dtype(_DTYPES[name][0])
    if np_t == np.bool_:
        return rng.integers(0, 2, size=shape).astype(bool)
    bits = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    return bits.astype(_SIGNED_VIEW[np_t.itemsize]).view(np_t)


def _torch_leaf(arr, name):
    torch_t = _DTYPES[name][1]
    if torch_t is None:
        return torch.from_numpy(np.ascontiguousarray(arr))
    raw = np.ascontiguousarray(arr).view(_SIGNED_VIEW[arr.dtype.itemsize])
    return torch.from_numpy(raw).view(torch_t)


def _all_dtypes_batch(seed, b):
    """(per-session numpy states, the batched torch state): every dtype the
    salt knows, odd byte counts ((B, 3) u8, (B, 5) i16) and 0-d leaves."""
    rng = np.random.default_rng(seed)
    shapes = {"bool": (3,), "u8": (3,), "i8": (5,), "i16": (5,), "u16": (3,),
              "f16": (3,), "bf16": (5,), "i32": (), "u32": (2,), "f32": (2, 3),
              "i64": (2,), "u64": (), "f64": (2,)}
    batched_np = {k: _np_leaf(rng, k, (b, *s)) for k, s in shapes.items()}
    batched_np["u8_0d"] = _np_leaf(rng, "u8", (b,))
    sessions = [{k: v[i] for k, v in batched_np.items()} for i in range(b)]
    state = {k: _torch_leaf(v, "u8" if k == "u8_0d" else k) for k, v in batched_np.items()}
    return sessions, state


def _jax_digest_x64(state):
    with jax.enable_x64(True):
        return _jax_digest(state)


def _structure(leaves, batch_dims=1):
    return tuple((tuple(l.shape[batch_dims:]), l.dtype) for l in leaves)


def _emulate(entries, rows, width, mix=None, offset=0):
    """The kernel's addressing and arithmetic in numpy over a leaf table:
    word k of a leaf's row r is bytes 4k..4k+3 at ptr + r * row_stride (zero
    past row_bytes), at index word_off + k; raw lanes where ``mix`` is None."""
    words = np.zeros((rows, width), np.uint32)
    for ptr, stride, nbytes, woff in entries:
        span = (rows - 1) * stride + nbytes
        mem = np.frombuffer((ctypes.c_ubyte * span).from_address(ptr), np.uint8)
        row_bytes = np.lib.stride_tricks.as_strided(mem, (rows, nbytes), (stride, 1))
        padded = np.zeros((rows, -(-nbytes // 4) * 4), np.uint8)
        padded[:, :nbytes] = row_bytes
        w = padded.view("<u4")
        words[:, woff:woff + w.shape[1]] = w
    idx = (np.arange(1, width + 1, dtype=np.uint64) + offset).astype(np.uint32)
    rot = (words << np.uint32(13)) | (words >> np.uint32(19))
    lanes = np.stack([
        words.sum(axis=1, dtype=np.uint32),
        (words * idx).sum(axis=1, dtype=np.uint32),
        (words * (idx * np.uint32(40503) + np.uint32(1))).sum(axis=1, dtype=np.uint32),
        (rot ^ (idx * np.uint32(2246822519))).sum(axis=1, dtype=np.uint32),
    ], axis=1)
    if mix is None:
        return lanes
    acc = np.asarray(mix, np.uint32) + lanes
    return acc ^ (acc >> np.uint32(15))


@pytest.mark.parametrize("name", sorted(_DTYPES))
@pytest.mark.parametrize("shape", [(), (1,), (3,), (5,), (2, 3)], ids=str)
def test_byte_view_words_match_jax_per_dtype(name, shape):
    rng = np.random.default_rng(len(shape) * 31 + len(name))
    arr = _np_leaf(rng, name, (2, *shape))
    got = tck._as_u32_words(_torch_leaf(arr, name)).numpy().view(np.uint32)
    with jax.enable_x64(True):
        for b in range(2):
            want = np.asarray(jck._as_u32_words(jnp.asarray(arr[b])))
            np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_all_dtypes_state_matches_jax(seed):
    sessions, state = _all_dtypes_batch(seed, 3)
    plain = tck.checksum_device_plain(state).numpy().view(np.uint32)
    routed = tck.checksum_device(state).numpy().view(np.uint32)
    np.testing.assert_array_equal(routed, plain)
    for b, s in enumerate(sessions):
        np.testing.assert_array_equal(plain[b], _jax_digest_x64(s))


def _ring_slot_view(state, ring_len=5, slot=3):
    """``state``'s leaves placed in slot ``slot`` of (B, R, ...) ring buffers,
    returned as the strided slot views the replay loads."""
    def place(leaf):
        buf = torch.zeros((leaf.shape[0], ring_len, *leaf.shape[1:]), dtype=leaf.dtype)
        buf[:, slot] = leaf
        return buf[:, slot]
    return tree_map(place, state)


def _table_cases():
    _, dtypes_state = _all_dtypes_batch(7, 4)
    vm = JaxChipVM(2)
    chip = from_numpy(vm.init_state_np(), "cpu")
    rng = np.random.default_rng(5)
    chip_b = tree_map(lambda v: torch.from_numpy(
        rng.integers(0, 256, size=(6, *v.shape)).astype(np.uint8)), chip)
    box = from_numpy(JaxBoxGame(3).init_state_np(), "cpu")
    box_b = tree_map(lambda v: (v.unsqueeze(0) + torch.arange(5).reshape(5, *[1] * v.dim()))
                     .to(v.dtype), box)
    expanded = {"x": torch.arange(6, dtype=torch.int16).expand(4, 6), "y": torch.ones(4, 3)}
    cases = {
        "chipvm": chip_b,
        "boxgame": box_b,
        "all_dtypes": dtypes_state,
        "chipvm_ring_slot": _ring_slot_view(chip_b),
        "all_dtypes_ring_slot": _ring_slot_view(dtypes_state, ring_len=3, slot=1),
        "expanded_rows": expanded,
    }
    assert sorted(cases) == TABLE_CASES
    return cases


TABLE_CASES = sorted(["chipvm", "boxgame", "all_dtypes", "chipvm_ring_slot",
                      "all_dtypes_ring_slot", "expanded_rows"])


@pytest.mark.parametrize("case", TABLE_CASES)
def test_leaf_table_addressing_matches_plain_digest(case):
    state = _table_cases()[case]
    leaves = tree_leaves(state)
    entries, rows, width = tdg.leaf_table(leaves)
    assert rows == leaves[0].shape[0]
    assert width == sum((math.prod(l.shape[1:]) * l.element_size() + 3) // 4 for l in leaves)
    mix = tck._salt_mix(_structure(leaves))
    got = _emulate(entries, rows, width, mix)
    np.testing.assert_array_equal(got, tck.checksum_device_plain(state).numpy().view(np.uint32))


def test_leaf_table_entries_of_a_ring_slot_view():
    # ChipVM leaves in jax order: mem (256 B), pc (1 B), regs (4 B) per row
    b, r = 6, 5
    state = _table_cases()["chipvm"]
    view = _ring_slot_view(state, ring_len=r, slot=3)
    entries, rows, width = tdg.leaf_table(tree_leaves(view))
    assert (rows, width) == (b, 66)
    assert [e[1:] for e in entries] == [(r * 256, 256, 0), (r * 1, 1, 64), (r * 4, 4, 65)]
    assert [e[0] for e in entries] == [l.data_ptr() for l in tree_leaves(view)]


def test_leaf_table_of_a_stack_reads_b_times_d_rows():
    b, d = 3, 4
    rng = np.random.default_rng(2)
    steps = [{"mem": torch.from_numpy(rng.integers(0, 256, (b, 7)).astype(np.uint8)),
              "v": torch.from_numpy(rng.integers(-9, 9, (b, 2)).astype(np.int64))}
             for _ in range(d)]
    stack = tree_map(lambda *xs: torch.stack(xs, dim=1), *steps)  # (B, d, ...)
    leaves = tree_leaves(stack)
    entries, rows, width = tdg.leaf_table(leaves, batch_dims=2)
    assert (rows, width) == (b * d, 2 + 4)
    assert [e[1:] for e in entries] == [(7, 7, 0), (16, 16, 2)]
    mix = tck._salt_mix(_structure(leaves, batch_dims=2))
    got = tdg.state_digest(leaves, mix, batch_dims=2).numpy().view(np.uint32)
    np.testing.assert_array_equal(_emulate(entries, rows, width, mix), got)
    # B*d stacked rows equal the d per-step digests, row b*d + j = step j
    per_step = np.stack([tck.checksum_device(s).numpy().view(np.uint32) for s in steps], axis=1)
    np.testing.assert_array_equal(got.reshape(b, d, 4), per_step)
    flat = tck.checksum_device(tree_map(lambda l: l.flatten(0, 1), stack))
    np.testing.assert_array_equal(flat.numpy().view(np.uint32), got)


def test_leaf_table_raw_lanes_match_lane_sums_rows():
    w = _words(33, seed=12, rows=5)
    t = torch.from_numpy(w.view(np.int32))
    entries, rows, width = tdg.leaf_table([t])
    np.testing.assert_array_equal(_emulate(entries, rows, width, offset=9), _port_rows(w, 9))


def test_leaf_count_above_the_maximum_raises():
    # the kernel's table holds MAX_LEAVES leaves, so leaf_table raises past
    # it; checksum_device digests any count, as JAX does (33 and 40 leaves
    # here; on the card in groups of MAX_LEAVES, see the emulated test below)
    for count in (tdg.MAX_LEAVES + 1, 40):
        state = {f"l{i:02d}": torch.full((2, 3), i, dtype=torch.int32) for i in range(count)}
        with pytest.raises(ValueError, match="at most"):
            tdg.leaf_table(tree_leaves(state))
        got = tck.checksum_device(state).numpy().view(np.uint32)
        for b in range(2):
            np.testing.assert_array_equal(
                got[b], _jax_digest({k: v[b].numpy() for k, v in state.items()}))
    # exactly the maximum digests, and as JAX does
    state = {f"l{i:02d}": torch.full((2, 3), i, dtype=torch.int32) for i in range(tdg.MAX_LEAVES)}
    tdg.leaf_table(tree_leaves(state))
    got = tck.checksum_device(state).numpy().view(np.uint32)
    np.testing.assert_array_equal(got[0], _jax_digest({k: v[0].numpy() for k, v in state.items()}))


@pytest.mark.parametrize(
    "leaves,batch_dims",
    [
        ([torch.zeros((4, 3, 5), dtype=torch.int32).transpose(1, 2)], 1),  # row not contiguous
        ([torch.zeros((4, 6, 2), dtype=torch.int32)[:, ::2]], 1),  # row has gaps
        ([torch.zeros((3, 3, 2), dtype=torch.int32)[:, :2]], 2),  # batch axes uneven
        ([torch.zeros((2, 3)), torch.zeros((3, 3))], 1),  # row counts differ
        ([], 1),
    ],
    ids=["transposed", "gapped", "uneven-batch", "row-count", "empty"],
)
def test_leaf_table_rejects_what_the_kernel_cannot_read(leaves, batch_dims):
    with pytest.raises(ValueError):
        tdg.leaf_table(leaves, batch_dims)


def test_state_digest_routes_cpu_tensors_to_the_plain_version():
    _, state = _all_dtypes_batch(3, 2)
    leaves = tree_leaves(state)
    mix = tck._salt_mix(_structure(leaves))
    before = tdg.state_digest.launches
    np.testing.assert_array_equal(tdg.state_digest(leaves, mix).numpy(),
                                  tdg.state_digest_plain(leaves, mix).numpy())
    assert tdg.state_digest.launches == before


def _emulated_launch(calls):
    """A stand-in for the kernel launch that runs ``_emulate`` over the
    table the wrapper built, so the CUDA wrapper path runs on the CPU."""
    def launch(entries, rows, width, device, mix, offset, raw, out=None):
        calls.append(rows)
        lanes = torch.from_numpy(
            _emulate(entries, rows, width, None if raw else mix, offset).view(np.int32).copy())
        return lanes if out is None else out.copy_(lanes)
    return launch


class _FakeCuda:
    type = "cuda"


def test_wrapper_path_over_a_session_matches_jax(monkeypatch):
    # the card's route -- leaf table over ring views and the window's ring
    # slots in place -- through the numpy emulation of the kernel, against
    # the JAX session
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    d = 3
    ticks = d + 1 + 20  # warmup, then 20 steady ticks
    inputs = np.random.default_rng(4).integers(0, 16, size=(ticks, 2)).astype(np.uint8)
    port = DeviceSyncTestSession(
        BoxGame(2).advance, BoxGame(2).init_state_np(), np.zeros(2, np.uint8),
        check_distance=d, device="cpu",
    )
    before = tdg.state_digest.launches
    port.run_ticks(inputs)
    progs = port.programs
    assert tdg.state_digest.launches - before == len(calls) == sum(
        progs.digest_calls(f) for f in range(ticks))
    # the resim digests: one launch a contiguous span of the window's slots
    want = [1, 1] * (d + 1)
    for f in range(d + 1, ticks):
        want += [rs.stop - rs.start for rs, _ in progs.ring.spans(f - d + 1, d)] + [1]
    assert calls == want
    jx = JaxSession(JaxBoxGame(2).advance, JaxBoxGame(2).init_state(),
                    jnp.zeros((2,), jnp.uint8), check_distance=d)
    jx.run_ticks(inputs)
    got = tree_leaves(to_numpy(port.carry))
    want = jax.tree_util.tree_leaves(jax.device_get(jx._carry))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# -- states the kernel cannot read in one launch in place ---------------------


def _many_leaves(count, seed, b=3):
    """``count`` leaves of mixed dtypes and odd byte counts, some empty."""
    rng = np.random.default_rng(seed)
    names = ["u8", "i16", "i32", "f32", "i64", "bool"]
    shapes = [(3,), (5,), (), (2,), (1,), (0,)]
    return {f"l{i:03d}": _torch_leaf(_np_leaf(rng, names[i % 6], (b, *shapes[i % 5])), names[i % 6])
            if i % 11 else torch.zeros((b, 0), dtype=torch.int32)
            for i in range(count)}


def _copied_layouts():
    base = torch.arange(4 * 3 * 5, dtype=torch.int32).reshape(4, 3, 5) * 7919
    return {
        "transposed": {"t": base.transpose(1, 2), "u": torch.ones((4, 2), dtype=torch.uint8)},
        "gapped": {"g": (base.reshape(4, 15)[:, :12].reshape(4, 6, 2) + 3)[:, ::2]},
        "expanded": {"e": torch.arange(6, dtype=torch.int16).reshape(1, 1, 6).expand(4, 3, 6),
                     "x": torch.full((4, 2), -5, dtype=torch.int64)},
        "expanded_batch": {"e": torch.arange(5, dtype=torch.float32).expand(4, 5)},
    }


COPIED = ["transposed", "gapped", "expanded", "expanded_batch"]


def _per_session_jax(state):
    leaves = tree_leaves(state)
    rows = leaves[0].shape[0]
    return np.stack([_jax_digest_x64(tree_map(lambda v: v[b].contiguous().numpy(), state))
                     for b in range(rows)])


@pytest.mark.parametrize("case", COPIED)
def test_copied_layouts_match_jax_on_the_cpu(case):
    state = _copied_layouts()[case]
    got = tck.checksum_device(state).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, _per_session_jax(state))


@pytest.mark.parametrize("case", COPIED)
def test_copied_layouts_match_jax_on_the_card_route(case, monkeypatch):
    # the card's route through the numpy emulation of the kernel: the one
    # leaf the kernel cannot read in place is copied, the rest read in place
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    state = _copied_layouts()[case]
    before = tdg.state_digest.launches
    got = tck.checksum_device(state).numpy().view(np.uint32)
    assert tdg.state_digest.launches - before == len(calls) == 1
    np.testing.assert_array_equal(got, _per_session_jax(state))


@pytest.mark.parametrize("count", [tdg.MAX_LEAVES, tdg.MAX_LEAVES + 1, 40, 3 * tdg.MAX_LEAVES + 5])
def test_many_leaves_match_jax_on_the_card_route(count, monkeypatch):
    # more than MAX_LEAVES non-empty leaves: one raw launch per group at its
    # word offset, the lanes summed, mixed and finished once
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    state = _many_leaves(count, seed=count)
    nonempty = sum(1 for l in tree_leaves(state) if l[0].numel())
    got = tck.checksum_device(state).numpy().view(np.uint32)
    assert len(calls) == -(-nonempty // tdg.MAX_LEAVES)
    np.testing.assert_array_equal(got, _per_session_jax(state))
    monkeypatch.undo()
    np.testing.assert_array_equal(tck.checksum_device(state).numpy().view(np.uint32), got)


def test_many_leaves_and_a_copied_leaf_on_the_card_route(monkeypatch):
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    state = _many_leaves(45, seed=9)
    state["l020"] = torch.arange(4 * 3, dtype=torch.int32).reshape(3, 4).t()[:3]  # (3, 3), strided
    got = tck.checksum_device(state).numpy().view(np.uint32)
    assert len(calls) == 2
    np.testing.assert_array_equal(got, _per_session_jax(state))
