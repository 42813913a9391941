"""BoxGame's advance kernel (``csrc/boxgame.cu``) on the card.

Pinned here: the kernel route is bitwise the eager body and the NumPy
oracle ``advance_np`` at P = 2, 3, 4 and every batch size up to 2^20 (and
0), on seeded states, on edge states (positions at the window, velocities
at the speed clamp, headings 0 and 255, all 16 input masks), on any int32
state and on inputs of every integer dtype; it reads the slot views and
window-input slices of a session-major ring in place, copies a leaf
of any other layout and refuses what it cannot read; both session
entries carry bitwise what the same session carries on the eager route
over two ring periods; and a traced steady tick runs exactly nine advance
kernels, all inside the tick's two advance layers.

Every test needs a CUDA card and skips without one.  ``tests/conftest.py``
imports JAX, which the card's machine does not have, so run this file there
on its own:

    python -m pytest tests/test_torch_boxgame_kernel_card.py --noconftest -q
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ggrs_tpu_torch import BatchedSessions, BoxGame, DeviceSyncTestSession
from ggrs_tpu_torch.games import _card
from ggrs_tpu_torch.games import boxgame as bg
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.ops.ring import DeviceStateRing
from ggrs_tpu_torch.utils.tree import tree_leaves

D = 8
R = D + 1
ENTRIES = {"single": 1, "batched": 4096}
ORACLE_ROWS = 64
MAX = 6 << 16
W, H = bg.WINDOW_W, bg.WINDOW_H


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the BoxGame kernel runs only there")
    return torch.device("cuda", torch.cuda.current_device())


def _count(route):
    return default_registry().value("ggrs_game_advance_total", game="boxgame", route=route) or 0.0


def _random_state(rng, b, p):
    return {
        "pos": np.stack([rng.integers(0, W, (b, p)), rng.integers(0, H, (b, p))], -1).astype(np.int32),
        "vel": rng.integers(-MAX, MAX + 1, (b, p, 2)).astype(np.int32),
        "rot": rng.integers(0, 256, (b, p)).astype(np.int32),
    }


def _edge_state(p):
    """Every combination of edge values, one a player, padded to whole
    sessions: positions at the window's edges, velocities at and next to the
    clamp, headings at the table's ends and quarter points, all 16 masks."""
    pos_x = np.array([0, 1, W // 2, W - 1], np.int64)
    pos_y = np.array([0, 1, H // 2, H - 1], np.int64)
    vels = np.array([-MAX, -MAX + 1, -1, 0, 1, MAX - 1, MAX], np.int64)
    rots = np.array([0, 1, 63, 64, 127, 128, 192, 255], np.int64)
    masks = np.arange(16, dtype=np.int64)
    grid = np.stack(np.meshgrid(pos_x, pos_y, vels, vels, rots, masks, indexing="ij"), -1)
    grid = grid.reshape(-1, 6)
    pad = (-len(grid)) % p
    grid = np.concatenate([grid, grid[:pad]]).reshape(-1, p, 6).astype(np.int32)
    state = {"pos": grid[..., 0:2].copy(), "vel": grid[..., 2:4].copy(), "rot": grid[..., 4].copy()}
    return state, grid[..., 5].astype(np.uint8)


def _to(state, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in state.items()}


def _check(game, state, inputs, oracle_rows=ORACLE_ROWS):
    """The kernel route against the eager body (every row) and the oracle
    (``oracle_rows`` rows spread over the batch); the route is the kernel's,
    one launch (none for an empty batch)."""
    before = (_count("kernel"), bg._advance_kernel.launches)
    got = game.advance(state, inputs)
    n = 1 if inputs.numel() else 0
    assert (_count("kernel"), bg._advance_kernel.launches) == (before[0] + n, before[1] + n)
    want = game._advance_fixed(state, inputs)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.int32 and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    b = inputs.shape[0]
    if b == 0 or oracle_rows == 0:
        return got
    host = {k: v.cpu().numpy() for k, v in state.items()}
    inp = inputs.cpu().numpy()
    out = {k: v.cpu().numpy() for k, v in got.items()}
    for i in np.unique(np.linspace(0, b - 1, min(b, oracle_rows)).astype(np.int64)):
        ref = game.advance_np({k: v[i] for k, v in host.items()}, inp[i])
        for k in ref:
            np.testing.assert_array_equal(out[k][i], ref[k], err_msg=f"oracle {k} row {i}")
    return got


@pytest.mark.parametrize("batch", [0, 1, 7, 4096, 2**20])
@pytest.mark.parametrize("players", [2, 3, 4])
def test_kernel_matches_eager_and_oracle(card, players, batch):
    game = BoxGame(players)
    rng = np.random.default_rng(2**33 + 100 * players + batch)
    state = _to(_random_state(rng, batch, players), card)
    inputs = torch.from_numpy(rng.integers(0, 16, (batch, players)).astype(np.uint8)).to(card)
    for _ in range(3):  # a few frames, each on the last one's output
        state = _check(game, state, inputs)


@pytest.mark.parametrize("players", [2, 3, 4])
def test_edge_states_and_every_mask(card, players):
    game = BoxGame(players)
    state, masks = _edge_state(players)
    _check(game, _to(state, card), torch.from_numpy(masks).to(card), oracle_rows=4096)


@pytest.mark.parametrize("players", [2, 3, 4])
def test_any_int32_state(card, players):
    # states no frame reaches: sums that wrap, headings and positions far
    # outside their ranges; the kernel keeps the eager body's int32 wrap
    game = BoxGame(players)
    rng = np.random.default_rng(2**34 + players)
    b = 65536
    state = {k: torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                                 .astype(np.int32)).to(card)
             for k, shape in (("pos", (b, players, 2)), ("vel", (b, players, 2)),
                              ("rot", (b, players)))}
    inputs = torch.from_numpy(rng.integers(0, 256, (b, players)).astype(np.uint8)).to(card)
    _check(game, state, inputs, oracle_rows=0)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64])
def test_input_dtypes(card, dtype):
    game = BoxGame(2)
    rng = np.random.default_rng(2**35)
    state = _to(_random_state(rng, 4096, 2), card)
    info = torch.iinfo(dtype)
    raw = rng.integers(max(info.min, -2**40), min(info.max, 2**40) + 1, (4096, 2), dtype=np.int64)
    _check(game, state, torch.from_numpy(raw).to(dtype).to(card), oracle_rows=0)


@pytest.mark.parametrize("players", [2, 3, 4])
def test_ring_slot_views_and_window_slices(card, players):
    game = BoxGame(players)
    ring = DeviceStateRing(R)
    rng = np.random.default_rng(2**36 + players)
    b = 4096
    bufs = {k: torch.from_numpy(np.stack([v] * R, 1)).to(card).clone()
            for k, v in _random_state(rng, b, players).items()}
    for k in bufs:  # every slot its own state
        bufs[k].add_(torch.arange(R, device=card, dtype=torch.int32).view(1, R, *[1] * (bufs[k].dim() - 2)))
    inputs = torch.from_numpy(rng.integers(0, 16, (b, R, players)).astype(np.uint8)).to(card)
    for frame in range(D, D + R):  # every phase: windows that wrap and that do not
        slot = ring.slot(frame - D)
        st = {k: v[:, slot] for k, v in bufs.items()}
        for j in range(D):
            inp = inputs[:, ring.slot(frame - D + j)]
            read, _ = bg._card_leaves(st, inp)
            assert all(a.data_ptr() == x.data_ptr() and a.stride() == x.stride()
                       for a, x in zip(read, (st["pos"], st["vel"], st["rot"], inp)))
            _check(game, st, inp, oracle_rows=16)
    # a layout the kernel does not read in place is copied once, and the
    # kernel still runs it, with the same result
    st = {k: v[:, 0] for k, v in bufs.items()}
    odd = {"pos": st["pos"].transpose(1, 2).contiguous().transpose(1, 2),
           "vel": st["vel"], "rot": st["rot"]}
    before = _count("eager")
    got = _check(game, odd, inputs[:, 0], oracle_rows=16)
    assert _count("eager") == before
    want = game._advance_fixed(st, inputs[:, 0])
    for k in want:
        assert torch.equal(got[k], want[k])
    # what the kernel cannot read raises, on the card, and never goes eager
    with pytest.raises(TypeError):
        game.advance(st, inputs[:, 0].to(torch.float32))
    with pytest.raises(ValueError):
        game.advance(dict(st, vel=torch.zeros(b * players * 2 + 1, dtype=torch.int32, device=card)[1:]
                          .view(b, players, 2)), inputs[:, 0])
    assert _count("eager") == before


def _session(entry, device):
    game = BoxGame(2)
    if entry == "single":
        return DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                     check_distance=D, max_prediction=D, device=device)
    return BatchedSessions(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                           batch_size=ENTRIES[entry], check_distance=D, max_prediction=D,
                           device=device)


def _inputs(entry, ticks):
    rng = np.random.default_rng(2**31 + 22)
    if entry == "single":
        return rng.integers(0, 16, size=(ticks, 2)).astype(np.uint8)
    return rng.integers(0, 16, size=(ENTRIES[entry], ticks, 2)).astype(np.uint8)


def _ticks(entry, sess, inputs, lo, hi):
    for t in range(lo, hi):
        chunk = inputs[t:t + 1] if entry == "single" else inputs[:, t:t + 1]
        sess.run_ticks(chunk, check=True)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entries_carry_bitwise_the_eager_route(card, entry, monkeypatch):
    ticks = D + 1 + 2 * R
    inputs = _inputs(entry, ticks)
    before = (_count("kernel"), bg._advance_kernel.launches)
    sess = _session(entry, card)
    _ticks(entry, sess, inputs, 0, ticks)
    torch.cuda.synchronize()
    # each warmup tick calls advance once; each phase's capture once a frame
    # of the window and once live; on the card, one launch a warmup tick and
    # d + 1 a steady tick (the graphs' replays)
    assert _count("kernel") - before[0] >= (D + 1) + R * (D + 1)
    assert bg._advance_kernel.launches - before[1] == (D + 1) + 2 * R * (D + 1)
    monkeypatch.setattr(_card, "on_card", lambda *tensors: False)
    eager_before = _count("eager")
    twin = _session(entry, card)
    _ticks(entry, twin, inputs, 0, ticks)
    torch.cuda.synchronize()
    assert _count("eager") > eager_before
    got, want = tree_leaves(sess.carry), tree_leaves(twin.carry)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_traced_tick_runs_nine_advance_kernels(card, entry, tmp_path):
    sess = _session(entry, card)
    inputs = _inputs(entry, D + 1 + 2 * R + 3)
    at = D + 1 + R
    _ticks(entry, sess, inputs, 0, at)
    traced = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _ticks(entry, sess, inputs, at, at + traced)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"),
                     key=lambda e: float(e["ts"]))
    # the kernels of each advance layer: from its mark to the next mark
    stretches, layer = [], None
    for e in kernels:
        name = e["name"]
        if name.startswith("ggrs_mark_"):
            layer = name[len("ggrs_mark_"):]
            if layer == "advance":
                stretches.append([])
        elif layer == "advance":
            stretches[-1].append(name)
        else:
            assert "boxgame_advance" not in name, name
    assert [len(s) for s in stretches] == [D, 1] * traced
    assert all("boxgame_advance" in n for s in stretches for n in s)
