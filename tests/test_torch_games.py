"""The port's batch-native games against the JAX package's ``advance`` and
the NumPy oracles, bit for bit (integer simulations: tolerance exactly 0).

Each rollout is 200 frames of numpy-seeded random inputs, run batched (the
port's B sessions against a vmapped JAX advance) and with B = 1.  On the CPU
every BoxGame call takes the eager route; the tests at the end pin that
routing, the route counter, what the kernel's wrapper hands the library
(a stand-in library on CPU tensors: pointers and strides of ring slot
views, expanded rows, copies, the calls it refuses), the launch count through
graph replays and the kernel's build entry (the kernel itself is held to
the eager body on the card, ``test_torch_boxgame_kernel_card.py``)."""

import ctypes
import hashlib
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM

import ggrs_tpu_torch._build as tbuild
from ggrs_tpu_torch import BoxGame, ChipVM, from_numpy, to_numpy
from ggrs_tpu_torch.games import _card
from ggrs_tpu_torch.games import boxgame as boxgame_mod
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.ops.kernels import GraphLaunches, count_launch

FRAMES = 200
ROOT = Path(__file__).resolve().parents[1]


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


@pytest.mark.parametrize("players", [2, 3, 4])
def test_init_state_np_matches_jax_key_order(players):
    # C8: the soak harness digests a state's leaves in dict order, so the
    # order is part of what the two packages must agree on
    got, want = BoxGame(players).init_state_np(), JaxBoxGame(players).init_state_np()
    assert list(got) == list(want)
    assert list(ChipVM(2).init_state_np()) == list(JaxChipVM(2).init_state_np())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


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


# -- BoxGame's route: the CUDA kernel or the eager body ---------------------------


def _advances(route):
    return default_registry().value("ggrs_game_advance_total", game="boxgame", route=route) or 0.0


def _batch(game, b):
    return {k: v.unsqueeze(0).expand(b, *v.shape).clone() for k, v in game.init_state("cpu").items()}


@pytest.mark.parametrize("variant", ["fixed", "float"])
def test_cpu_tensors_and_the_float_variant_take_the_eager_route(variant):
    game = BoxGame(2, variant)
    state, inputs = _batch(game, 3), torch.full((3, 2), 5, dtype=torch.uint8)
    assert not _card.on_card(inputs, *state.values())
    before = (_advances("kernel"), _advances("eager"))
    out = game.advance(state, inputs)
    assert (_advances("kernel"), _advances("eager")) == (before[0], before[1] + 1)
    want = game._advance_float(state, inputs) if variant == "float" else game._advance_fixed(state, inputs)
    assert list(out) == ["pos", "vel", "rot"]
    for k in want:
        assert torch.equal(out[k], want[k])


class _FakeCard:
    """The kernel route with CPU tensors standing in for the card's: the
    library's entry records its arguments and writes ``want`` (the eager
    body's result) through the output pointers, or returns ``err``."""

    def __init__(self, monkeypatch):
        self.calls, self.want, self.err = [], None, 0
        lib = type("Lib", (), {"ggrs_boxgame_advance": staticmethod(self.launch)})
        monkeypatch.setattr(_card, "on_card", lambda *tensors: True)
        monkeypatch.setattr(boxgame_mod, "_lib", lambda: lib)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: type("S", (), {"cuda_stream": 0})())
        monkeypatch.setattr(torch.cuda, "current_device", lambda: None)

    def launch(self, *args):
        self.calls.append(args)
        if self.err:
            return self.err
        for ptr, key in zip(args[11:14], ("pos", "vel", "rot")):
            src = self.want[key].contiguous()
            ctypes.memmove(ptr, src.data_ptr(), src.numel() * src.element_size())
        return 0


def _launched():
    return boxgame_mod._advance_kernel.launches


def test_advance_total_counts_each_call_under_its_route(monkeypatch):
    game = BoxGame(3)
    state, inputs = _batch(game, 4), torch.arange(12, dtype=torch.uint8).reshape(4, 3)
    before = (_advances("kernel"), _advances("eager"), _launched())
    for _ in range(3):
        game.advance(state, inputs)
    assert (_advances("kernel"), _advances("eager"), _launched()) == (before[0], before[1] + 3, before[2])
    # a call on the card counts one launch under "kernel" and on the
    # kernel's launch count, and gives what the library wrote
    fake = _FakeCard(monkeypatch)
    fake.want = game._advance_fixed(state, inputs)
    out = game.advance(state, inputs)
    assert len(fake.calls) == 1
    assert (_advances("kernel"), _advances("eager"), _launched()) == (before[0] + 1, before[1] + 3, before[2] + 1)
    for k in fake.want:
        assert torch.equal(out[k], fake.want[k])
    # an empty batch launches nothing and counts nothing, whatever the
    # strides of its leaves (numpy gives an empty stack all-zero strides)
    for strided in (False, True):
        st = {k: v[:0] for k, v in state.items()}
        if strided:
            st = {k: torch.empty_strided(v.shape, (0,) * v.dim(), dtype=v.dtype) for k, v in st.items()}
        empty = game.advance(st, inputs[:0])
        assert len(fake.calls) == 1 and _launched() == before[2] + 1
        assert {k: tuple(v.shape) for k, v in empty.items()} == {"pos": (0, 3, 2), "vel": (0, 3, 2), "rot": (0, 3)}
    # a launch that fails raises and counts nothing
    fake.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        game.advance(state, inputs)
    assert (_advances("kernel"), _launched()) == (before[0] + 1, before[2] + 1)
    # the float variant never asks for the kernel
    BoxGame(3, "float").advance(_batch(BoxGame(3, "float"), 4), inputs)
    assert len(fake.calls) == 2
    assert _advances("eager") == before[1] + 4


@pytest.mark.parametrize("players", [2, 3, 4])
def test_kernel_reads_ring_slot_views_and_window_slices_in_place(monkeypatch, players):
    game, r, b = BoxGame(players), 9, 5
    rng = np.random.default_rng(2**31 + players)
    ring = {"pos": torch.from_numpy(rng.integers(0, 1 << 20, (b, r, players, 2)).astype(np.int32)),
            "vel": torch.from_numpy(rng.integers(-(6 << 16), 6 << 16, (b, r, players, 2)).astype(np.int32)),
            "rot": torch.from_numpy(rng.integers(0, 256, (b, r, players)).astype(np.int32))}
    window = torch.from_numpy(rng.integers(0, 16, (b, r, players)).astype(np.uint8))
    st, inp = {k: v[:, 3] for k, v in ring.items()}, window[:, 4]
    fake = _FakeCard(monkeypatch)
    fake.want = game._advance_fixed(st, inp)
    out = game.advance(st, inp)
    (p, rows, pos, pos_s, vel, vel_s, rot, rot_s, ip, ip_s, item) = fake.calls[-1][:11]
    assert (p, rows, item) == (players, b, 1)
    assert (pos, vel, rot, ip) == (st["pos"].data_ptr(), st["vel"].data_ptr(),
                                   st["rot"].data_ptr(), inp.data_ptr())
    assert (pos_s, vel_s, rot_s, ip_s) == (r * players * 8, r * players * 8, r * players * 4, r * players)
    for k in fake.want:
        assert torch.equal(out[k], fake.want[k])


def test_kernel_copies_other_layouts_and_reads_expanded_rows(monkeypatch):
    game, b = BoxGame(2), 6
    state = _batch(game, b)
    inputs = torch.arange(2 * b, dtype=torch.int64).reshape(b, 2)
    fake = _FakeCard(monkeypatch)
    # a leaf whose inner dimensions are not contiguous is copied once
    odd = dict(state, pos=state["pos"].transpose(1, 2).contiguous().transpose(1, 2))
    fake.want = game._advance_fixed(state, inputs)
    out = game.advance(odd, inputs)
    args = fake.calls[-1]
    assert args[2] != odd["pos"].data_ptr() and args[3] == 16
    assert args[8:11] == (inputs.data_ptr(), 16, 8)
    for k in fake.want:
        assert torch.equal(out[k], fake.want[k])
    # one state expanded to every row, as speculation's branches are: read
    # in place at stride 0
    one = {k: v.unsqueeze(0).expand(b, *v.shape) for k, v in game.init_state("cpu").items()}
    fake.want = game._advance_fixed(one, inputs)
    out = game.advance(one, inputs)
    args = fake.calls[-1]
    assert args[1] == b and (args[2], args[3], args[5], args[7]) == (one["pos"].data_ptr(), 0, 0, 0)
    assert out["pos"].shape == (b, 2, 2)
    for k in fake.want:
        assert torch.equal(out[k], fake.want[k])


def test_kernel_route_raises_where_the_kernel_cannot_read(monkeypatch):
    game, b = BoxGame(2), 4
    state, inputs = _batch(game, b), torch.zeros((b, 2), dtype=torch.uint8)
    fake = _FakeCard(monkeypatch)
    with pytest.raises(TypeError, match="int32"):
        game.advance({k: v.to(torch.int64) for k, v in state.items()}, inputs)
    with pytest.raises(TypeError, match="integer dtype"):
        game.advance(state, inputs.to(torch.float32))
    with pytest.raises(ValueError, match="shapes"):
        game.advance(state, torch.zeros((b, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="same sessions"):
        game.advance(game.init_state("cpu"), inputs)
    with pytest.raises(ValueError, match="several devices"):
        game.advance(state, torch.zeros((b, 2), dtype=torch.uint8, device="meta"))
    shifted = torch.zeros(b * 4 + 1, dtype=torch.int32)[1:].view(b, 2, 2)
    with pytest.raises(ValueError, match="8-byte aligned"):
        game.advance(dict(state, vel=shifted), inputs)
    assert fake.calls == []


def test_graph_replays_carry_the_kernels_launches():
    kernel, graph = boxgame_mod._advance_kernel, GraphLaunches()
    before = kernel.launches
    with graph.capturing():  # a capture launches nothing yet
        for _ in range(9):
            count_launch(kernel)
    assert kernel.launches == before
    graph.replayed()
    graph.replayed()
    assert kernel.launches == before + 18


def test_build_names_and_hashes_the_kernel_source(tmp_path, monkeypatch):
    src = ROOT / "ggrs_tpu_torch" / "csrc" / "boxgame.cu"
    assert tbuild.SOURCES["boxgame"] == src and src.exists()
    path = tbuild.library_path("boxgame")
    digest = hashlib.sha256(src.read_bytes() + " ".join(tbuild.NVCC_FLAGS).encode())
    assert path == tbuild.BUILD_DIR / f"libboxgame-{digest.hexdigest()[:12]}.so"
    # an edited source is a new library, never the old one
    edited = tmp_path / "boxgame.cu"
    edited.write_bytes(src.read_bytes() + b"\n")
    monkeypatch.setitem(tbuild.SOURCES, "boxgame", edited)
    assert tbuild.library_path("boxgame") != path
    assert tbuild.library_path("boxgame").name.startswith("libboxgame-")
