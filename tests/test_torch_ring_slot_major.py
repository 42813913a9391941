"""The lockstep replay's slot-major ring, pinned on the CPU.

``ReplayPrograms.init_carry`` stores every ring-indexed buffer (the state
ring, its checksums and frames, the input ring, the digest history) as a
``(R, B, ...)`` tensor held through ``transpose(0, 1)``: the carry keeps the
JAX package's ``(B, R, ...)`` shapes while each slot is one contiguous
block, and the steady tick advances, digests and compares the resimulated
window in its own slots.  Pinned here:

- after warmup and more than two ring periods of steady ticks (every phase,
  the window wrapping the ring and not) the carry has the old shapes over
  slot-major storage and is bitwise an independent replay made of the
  game's own advance and digest (and, where the JAX package has the game,
  the JAX carry), for BoxGame fixed and float, VectorWar, and ChipVM and a
  caller's own BoxGame step, which take no ``out`` (the replay copies their
  results into the slot);
- a checkpoint round-trips into the slot-major carry's own buffers;
- the session pool's ring stays session-major;
- ``out`` on the games' kernel route (a stand-in library on CPU tensors):
  the slot's pointers go to the kernel and the slot's tensors come back,
  refusals raise before any launch; on the eager route every steady
  advance is handed its slot, and the carry keeps its tensors.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM
from ggrs_tpu.parallel import BatchedSessions as JaxBatchedSessions
from ggrs_tpu.parallel import make_mesh as jax_make_mesh

from ggrs_tpu_torch import BatchedSessions, BoxGame, ChipVM, DeviceSyncTestSession, to_numpy
from ggrs_tpu_torch.games import _card
from ggrs_tpu_torch.games import boxgame as boxgame_mod
from ggrs_tpu_torch.games import vectorwar as vectorwar_mod
from ggrs_tpu_torch.games.vectorwar import VectorWar
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.ops.checksum import checksum_device
from ggrs_tpu_torch.ops.replay import I32_MAX
from ggrs_tpu_torch.ops.ring import DeviceStateRing
from ggrs_tpu_torch.parallel.session_pool import BatchedRequestExecutor
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

from test_torch_replay import _assert_trees_equal

D = 8
B = 3


def _no_out(game):
    """The game's step as a caller's own function, with no ``out``."""
    return lambda state, inputs: game.advance(state, inputs)


# name: (port game, its step, players, input bits, JAX game or None)
GAMES = {
    "boxgame": (lambda: BoxGame(2), None, 2, 16, lambda: JaxBoxGame(2)),
    "boxgame_float": (lambda: BoxGame(2, "float"), None, 2, 16, None),
    "vectorwar": (VectorWar, None, 4, 32, None),
    "chipvm": (lambda: ChipVM(2), None, 2, 256, lambda: JaxChipVM(2)),
    "no_out": (lambda: BoxGame(3), _no_out, 3, 16, lambda: JaxBoxGame(3)),
}


def _ring_leaves(carry):
    """Every ring-indexed buffer of the carry."""
    return [*tree_leaves(carry["ring"]), *tree_leaves(carry["inputs"]), carry["hist"]]


def _expected_carry(game, step, inputs, r):
    """The carry after ``inputs`` (B, T, P) with no desync, from the game's
    advance and digest alone: the ring holds frames T - R .. T - 1, the
    history the first-seen digests of T - R + 1 .. T, each in slot f % R."""
    t = inputs.shape[1]
    states = [tree_map(lambda x: x.unsqueeze(0).expand(B, *x.shape).clone(),
                       game.init_state("cpu"))]
    for f in range(t):
        states.append(step(states[-1], torch.from_numpy(inputs[:, f])))
    digests = [checksum_device(s).numpy().view(np.uint32) for s in states]
    saved = {f % r: f for f in range(t - r, t)}
    seen = {f % r: f for f in range(t - r + 1, t + 1)}
    by_slot = lambda frames, leaf: np.stack([np.asarray(leaf(frames[i])) for i in range(r)], axis=1)
    return {
        "ring": {
            "states": {k: by_slot(saved, lambda f, k=k: states[f][k].numpy()) for k in states[0]},
            "checksums": by_slot(saved, lambda f: digests[f]),
            "frames": np.stack([np.full(B, saved[i], np.int32) for i in range(r)], axis=1),
        },
        "inputs": np.stack([inputs[:, saved[i]] for i in range(r)], axis=1),
        "hist": by_slot(seen, lambda f: digests[f]),
        "live": to_numpy(states[t]),
        "frame": np.full(B, t, np.int32),
        "mismatches": np.zeros(B, np.int32),
        "first_bad": np.full(B, I32_MAX, np.int32),
    }


@pytest.mark.parametrize("max_prediction", [D, D + 3])
@pytest.mark.parametrize("name", sorted(GAMES))
def test_slot_major_carry_over_every_phase(name, max_prediction):
    make, wrap, players, high, make_jax = GAMES[name]
    game = make()
    step = game.advance if wrap is None else wrap(game)
    sess = BatchedSessions(step, game.init_state_np(), np.zeros(players, np.uint8), batch_size=B,
                           check_distance=D, max_prediction=max_prediction, device="cpu")
    r = sess.programs.ring.length
    ticks = D + 1 + 2 * r + 3  # warmup, then every phase at least twice
    inputs = np.random.default_rng(2**33 + len(name) + r).integers(
        0, high, size=(B, ticks, players)).astype(np.uint8)
    phases = {f % r for f in range(D + 1, ticks)}
    assert phases == set(range(r))
    wraps = {len(sess.programs.ring.spans(f - D + 1, D)) for f in range(D + 1, ticks)}
    assert wraps == {1, 2}
    assert sess.run_ticks(inputs)["mismatches"] == 0

    carry = sess.carry
    for buf in _ring_leaves(carry):
        assert buf.shape[:2] == (B, r)
        assert buf.transpose(0, 1).is_contiguous()
        assert all(buf[:, i].is_contiguous() for i in range(r))
    got = to_numpy(carry)
    _assert_trees_equal(got, _expected_carry(game, step, inputs, r))
    if make_jax is not None:
        jg = make_jax()
        jx = JaxBatchedSessions(jg.advance, jg.init_state(), jnp.zeros((players,), jnp.uint8),
                                batch_size=B, mesh=jax_make_mesh(1), check_distance=D,
                                max_prediction=max_prediction)
        jx.run_ticks(inputs)
        _assert_trees_equal(got, jax.device_get(jx._carry))


def _buffers(tree):
    return [(x.data_ptr(), tuple(x.shape), x.stride()) for x in tree_leaves(tree)]


@pytest.mark.parametrize("entry", ["single", "batched"])
def test_checkpoint_round_trips_into_the_slot_major_carry(entry, tmp_path):
    game = BoxGame(2)

    def session():
        if entry == "single":
            return DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                         check_distance=D, device="cpu")
        return BatchedSessions(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                               batch_size=B, check_distance=D, device="cpu")

    def tick(sess, chunk):
        sess.run_ticks(chunk[0] if entry == "single" else chunk)

    rng = np.random.default_rng(2**34)
    inputs = rng.integers(0, 16, size=(B, 40, 2)).astype(np.uint8)
    a, b = session(), session()
    tick(a, inputs[:, :25])
    path = str(tmp_path / "carry.npz")
    a.save_checkpoint(path)
    before = _buffers(b.carry)
    b.load_checkpoint(path)
    assert _buffers(b.carry) == before  # loaded into its own slot-major buffers
    for buf in _ring_leaves(b._carry if entry == "single" else b.carry):
        assert buf.transpose(0, 1).is_contiguous()
    _assert_trees_equal(to_numpy(b.carry), to_numpy(a.carry))
    tick(a, inputs[:, 25:])
    tick(b, inputs[:, 25:])
    _assert_trees_equal(to_numpy(b.carry), to_numpy(a.carry))


def test_the_pool_ring_stays_session_major():
    game = BoxGame(2)
    pool = BatchedRequestExecutor(game.advance, game.init_state_np(),
                                  lambda pairs: np.asarray([p[0] for p in pairs], np.uint8),
                                  batch_size=B, ring_length=5, max_burst=2, device="cpu")
    ring = pool._shards[0]["ring"]
    for buf in tree_leaves(ring):
        assert buf.shape[:2] == (B, 5) and buf.is_contiguous()
    # the per-row slots view a session-major buffer, and refuse a slot-major one
    assert DeviceStateRing._slots(ring["checksums"]).shape == (B * 5, 4)
    sess = BatchedSessions(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                           batch_size=B, check_distance=D, device="cpu")
    with pytest.raises(RuntimeError):
        DeviceStateRing._slots(sess.carry["ring"]["checksums"])


# -- out on the kernel route, with a stand-in library on CPU tensors ----------


def _advances(game, route):
    return default_registry().value("ggrs_game_advance_total", game=game, route=route) or 0.0


# name: (module, game, library entry, the outputs' argument positions)
KERNELS = {
    "boxgame": (boxgame_mod, lambda: BoxGame(2), "ggrs_boxgame_advance", slice(11, 14)),
    "vectorwar": (vectorwar_mod, VectorWar, "ggrs_vectorwar_advance", 6),
}


@contextlib.contextmanager
def _stand_in_card(monkeypatch, name):
    """The kernel route on CPU tensors: the library's entry records its
    arguments and writes nothing."""
    mod, _, entry, _ = KERNELS[name]
    calls = []
    lib = type("Lib", (), {entry: staticmethod(lambda *args: calls.append(args) or 0)})
    monkeypatch.setattr(_card, "on_card", lambda *tensors: True)
    monkeypatch.setattr(mod, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    yield calls


def _out_pointers(name, args):
    """The output pointers the wrapper handed the library (VectorWar's as a
    ctypes array)."""
    return list(args[KERNELS[name][3]])


def _slot_major_ring(game, r):
    live = tree_map(lambda x: x.unsqueeze(0).expand(B, *x.shape).clone(), game.init_state("cpu"))
    return tree_map(lambda x: x.unsqueeze(0).expand(r, *x.shape).clone().transpose(0, 1), live)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_writes_a_slot_in_place_and_counts_it(monkeypatch, name):
    mod, make, _, _ = KERNELS[name]
    game = make()
    players = 2 if name == "boxgame" else 4
    ring = _slot_major_ring(game, 9)
    st, out = {k: v[:, 3] for k, v in ring.items()}, {k: v[:, 4] for k, v in ring.items()}
    inputs = torch.zeros((B, players), dtype=torch.uint8)
    before = (_advances(name, "kernel"), _advances(name, "eager"), mod._advance_kernel.launches)
    with _stand_in_card(monkeypatch, name) as calls:
        got = game.advance(st, inputs, out=out)
        assert len(calls) == 1
        keys = mod._advance_kernel.names
        slot = [out[k].data_ptr() for k in keys]
        assert _out_pointers(name, calls[0]) == slot
        assert sorted(got) == sorted(keys) and all(got[k] is out[k] for k in keys)
        after = (_advances(name, "kernel"), _advances(name, "eager"), mod._advance_kernel.launches)
        assert after == (before[0] + 1, before[1], before[2] + 1)
        fresh = game.advance(st, inputs)  # a lone advance: fresh outputs, not the slot
        assert _out_pointers(name, calls[1]) == [fresh[k].data_ptr() for k in keys] != slot
        after = (_advances(name, "kernel"), _advances(name, "eager"), mod._advance_kernel.launches)
        assert after == (before[0] + 2, before[1], before[2] + 2)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_route_refuses_an_out_it_cannot_write(monkeypatch, name):
    _, make, _, _ = KERNELS[name]
    game = make()
    players = 2 if name == "boxgame" else 4
    ring = _slot_major_ring(game, 9)
    st = {k: v[:, 3] for k, v in ring.items()}
    inputs = torch.zeros((B, players), dtype=torch.uint8)
    session_major = {k: v.contiguous() for k, v in ring.items()}  # a slot is strided there
    key = "pos"
    with _stand_in_card(monkeypatch, name) as calls:
        with pytest.raises(ValueError, match="not contiguous"):
            game.advance(st, inputs, out={k: v[:, 4] for k, v in session_major.items()})
        wide = {k: torch.empty_like(v) for k, v in st.items()}
        wide[key] = wide[key].to(torch.int64)
        with pytest.raises(ValueError, match="int32 tensor"):
            game.advance(st, inputs, out=wide)
        with pytest.raises(ValueError, match="int32 tensor"):
            game.advance(st, inputs, out={k: torch.empty_like(v[:1]) for k, v in st.items()})
        with pytest.raises(ValueError, match="overlaps"):
            game.advance(st, inputs, out=st)  # the state being read
        with pytest.raises(ValueError, match="overlaps"):
            fresh = {k: torch.empty_like(v) for k, v in st.items()}
            game.advance(st, inputs, out=dict(fresh, **{key: ring[key][:, 3]}))
        assert calls == []


@pytest.mark.parametrize("name", ["boxgame", "vectorwar"])
def test_eager_steady_ticks_count_their_advances_in_place(name):
    game = BoxGame(2) if name == "boxgame" else VectorWar()
    players = 2 if name == "boxgame" else 4
    outs = []

    def step(state, inputs, out=None):
        if out is not None:
            outs.append([x.data_ptr() for x in tree_leaves(out)])
        got = game.advance(state, inputs, out)
        assert out is None or all(got[k] is out[k] for k in out)
        return got

    sess = BatchedSessions(step, game.init_state_np(), np.zeros(players, np.uint8),
                           batch_size=B, check_distance=D, device="cpu")
    inputs = np.zeros((B, D + 1 + 4, players), np.uint8)
    before = (_advances(name, "kernel"), _advances(name, "eager"))
    sess.run_ticks(inputs[:, :D + 1])  # the warmup ticks advance into fresh tensors
    assert outs == []
    carry = [x.data_ptr() for x in tree_leaves(sess.carry)]
    states, live = sess.carry["ring"]["states"], sess.carry["live"]
    r = sess.programs.ring.length
    slots = [[x[:, i].data_ptr() for x in tree_leaves(states)] for i in range(r)]
    slots.append([x.data_ptr() for x in tree_leaves(live)])
    sess.run_ticks(inputs[:, D + 1:])
    # every steady advance is handed a ring slot or the live state, and the
    # carry keeps its tensors
    assert len(outs) == 4 * (D + 1) and all(o in slots for o in outs)
    assert [x.data_ptr() for x in tree_leaves(sess.carry)] == carry
    assert _advances(name, "kernel") == before[0]
    assert _advances(name, "eager") - before[1] == (D + 1) + 4 * (D + 1)
