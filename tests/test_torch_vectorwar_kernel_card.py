"""VectorWar's advance kernel (``csrc/vectorwar.cu``) on the card.

Pinned here: the kernel route is bitwise the eager body at B = 0, 1, 7,
4,096 and the benchmark cell's B, on seeded states crowded
with bullets beside the ships (so that hits, full slot sets, the speed limit
and wall bounces all occur), on states that frames reach and on inputs of
every integer dtype; it reads the slot views and window-input slices of a
session-major ring in place, copies a leaf of any other layout and
refuses what it cannot read; one launch a frame; both session entries carry
bitwise what the same session carries on the eager route over two ring
periods; and a traced steady tick runs exactly nine advance kernels, all
inside the tick's two advance layers.

Every test needs a CUDA card and skips without one.  ``tests/conftest.py``
imports JAX, which the card's machine does not have, so run this file there
on its own:

    python -m pytest tests/test_torch_vectorwar_kernel_card.py --noconftest -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ggrs_tpu_torch import BatchedSessions, DeviceSyncTestSession
from ggrs_tpu_torch.games import _card
from ggrs_tpu_torch.games import vectorwar as vw
from ggrs_tpu_torch.games.vectorwar import VectorWar
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.ops.ring import DeviceStateRing
from ggrs_tpu_torch.utils.tree import tree_leaves

D = 8
R = D + 1
ENTRIES = {"single": 1, "batched": 4096}
ONE = 1 << 16
CELL_B = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "traffic"
                     / "closed-vectorwar4-host.json").read_text())["sessions"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the VectorWar kernel runs only there")
    return torch.device("cuda", torch.cuda.current_device())


def _count(route):
    return default_registry().value("ggrs_game_advance_total", game="vectorwar", route=route) or 0.0


def crowded_state(rng, b):
    """Seeded states with bullets beside the ships: positions over the whole
    playfield and past its walls, speeds up to 5 px, some sessions with all
    30 slots live, and half the bullets within 30 px of a ship."""
    p = vw.SHIPS
    pos = np.stack([rng.integers(0, 640 * ONE, (b, p)), rng.integers(0, 480 * ONE, (b, p))], -1)
    near = pos[np.arange(b)[:, None, None], rng.integers(0, p, (b, p, vw.SLOTS))]
    far = np.stack([rng.integers(-20 * ONE, 660 * ONE, (b, p, vw.SLOTS)),
                    rng.integers(-20 * ONE, 500 * ONE, (b, p, vw.SLOTS))], -1)
    bpos = np.where(rng.random((b, p, vw.SLOTS, 1)) < 0.5,
                    near + rng.integers(-30 * ONE, 30 * ONE, (b, p, vw.SLOTS, 2)), far)
    active = (rng.random((b, p, vw.SLOTS)) < 0.5) | (rng.random((b, 1, 1)) < 0.1)
    return {
        "bullet_active": active.astype(np.int32),
        "bullet_pos": bpos.astype(np.int32),
        "bullet_vel": rng.integers(-10 * ONE, 10 * ONE, (b, p, vw.SLOTS, 2)).astype(np.int32),
        "cooldown": rng.integers(0, 9, (b, p)).astype(np.int32),
        "heading": rng.integers(0, 360, (b, p)).astype(np.int32),
        "health": rng.integers(-500, 101, (b, p)).astype(np.int32),
        "pos": pos.astype(np.int32),
        "score": rng.integers(0, 1000, (b, p)).astype(np.int32),
        "vel": rng.integers(-5 * ONE, 5 * ONE, (b, p, 2)).astype(np.int32),
    }


def _to(state, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in state.items()}


def _check(game, state, inputs):
    """The kernel route against the eager body, every row; one launch (none
    for an empty batch)."""
    before = (_count("kernel"), vw._advance_kernel.launches)
    got = game.advance(state, inputs)
    n = 1 if inputs.numel() else 0
    assert (_count("kernel"), vw._advance_kernel.launches) == (before[0] + n, before[1] + n)
    want = game._advance_eager(state, inputs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32 and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    return got


@pytest.mark.parametrize("batch", [0, 1, 7, 4096, CELL_B])
def test_kernel_matches_eager(card, batch):
    game = VectorWar()
    rng = np.random.default_rng(2**33 + batch)
    state = _to(crowded_state(rng, batch), card)
    for _ in range(3):  # a few frames, each on the last one's output
        inputs = torch.from_numpy(rng.integers(0, 64, (batch, 4)).astype(np.uint8)).to(card)
        state = _check(game, state, inputs)


def test_frames_from_the_start(card):
    # 600 frames of uniform inputs from GGPO's start, every frame checked
    game = VectorWar()
    b = 2048
    state = {k: v.unsqueeze(0).expand(b, *v.shape).clone() for k, v in game.init_state(card).items()}
    rng = np.random.default_rng(2**34)
    for _ in range(600):
        inputs = torch.from_numpy(rng.integers(0, 32, (b, 4)).astype(np.uint8)).to(card)
        state = _check(game, state, inputs)
    assert int(state["score"].sum()) > 0 and int(state["bullet_active"].sum()) > 0


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64])
def test_input_dtypes(card, dtype):
    game = VectorWar()
    rng = np.random.default_rng(2**35)
    state = _to(crowded_state(rng, 4096), card)
    info = torch.iinfo(dtype)
    raw = rng.integers(max(info.min, -2**40), min(info.max, 2**40) + 1, (4096, 4), dtype=np.int64)
    _check(game, state, torch.from_numpy(raw).to(dtype).to(card))


@pytest.mark.parametrize("batch", [4096, CELL_B])
def test_ring_slot_views_and_window_slices(card, batch):
    game = VectorWar()
    ring = DeviceStateRing(R)
    rng = np.random.default_rng(2**36 + batch)
    bufs = {k: torch.from_numpy(np.stack([v] * R, 1)).to(card)
            for k, v in crowded_state(rng, batch).items()}
    for k in ("pos", "bullet_pos"):  # every slot its own state
        bufs[k].add_(torch.arange(R, device=card, dtype=torch.int32).view(1, R, *[1] * (bufs[k].dim() - 2)))
    inputs = torch.from_numpy(rng.integers(0, 64, (batch, R, 4)).astype(np.uint8)).to(card)
    for frame in (D, D + R - 1):  # a window that does not wrap and one that does
        slot = ring.slot(frame - D)
        st = {k: v[:, slot] for k, v in bufs.items()}
        for j in (0, D - 1):
            inp = inputs[:, ring.slot(frame - D + j)]
            every, _ = vw._card_leaves(st, inp)
            assert all(a.data_ptr() == x.data_ptr() and a.stride() == x.stride()
                       for a, x in zip(every, (*(st[k] for k in vw.LEAVES), inp)))
            _check(game, st, inp)
    # a layout the kernel does not read in place is copied once, and the
    # kernel still runs it, with the same result
    st = {k: v[:, 0] for k, v in bufs.items()}
    odd = dict(st, bullet_pos=st["bullet_pos"].transpose(2, 3).contiguous().transpose(2, 3))
    before = _count("eager")
    got = _check(game, odd, inputs[:, 0])
    assert _count("eager") == before
    want = game._advance_eager(st, inputs[:, 0])
    for k in want:
        assert torch.equal(got[k], want[k])
    # what the kernel cannot read raises, on the card, and never goes eager
    with pytest.raises(TypeError):
        game.advance(st, inputs[:, 0].to(torch.float32))
    with pytest.raises(ValueError):
        shifted = torch.zeros(batch * 8 + 1, dtype=torch.int32, device=card)[1:].view(batch, 4, 2)
        game.advance(dict(st, vel=shifted), inputs[:, 0])
    assert _count("eager") == before


def _session(entry, device):
    game = VectorWar()
    if entry == "single":
        return DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(4, np.uint8),
                                     check_distance=D, max_prediction=D, device=device)
    return BatchedSessions(game.advance, game.init_state_np(), np.zeros(4, np.uint8),
                           batch_size=ENTRIES[entry], check_distance=D, max_prediction=D,
                           device=device)


def _inputs(entry, ticks):
    rng = np.random.default_rng(2**31 + 23)
    if entry == "single":
        return rng.integers(0, 32, size=(ticks, 4)).astype(np.uint8)
    return rng.integers(0, 32, size=(ENTRIES[entry], ticks, 4)).astype(np.uint8)


def _ticks(entry, sess, inputs, lo, hi):
    for t in range(lo, hi):
        chunk = inputs[t:t + 1] if entry == "single" else inputs[:, t:t + 1]
        sess.run_ticks(chunk, check=True)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entries_carry_bitwise_the_eager_route(card, entry, monkeypatch):
    ticks = D + 1 + 2 * R
    inputs = _inputs(entry, ticks)
    before = (_count("kernel"), vw._advance_kernel.launches)
    sess = _session(entry, card)
    _ticks(entry, sess, inputs, 0, ticks)
    torch.cuda.synchronize()
    # one launch a warmup tick and d + 1 a steady tick (the graphs' replays)
    assert _count("kernel") - before[0] >= (D + 1) + R * (D + 1)
    assert vw._advance_kernel.launches - before[1] == (D + 1) + 2 * R * (D + 1)
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
            assert "vectorwar_advance" not in name, name
    assert [len(s) for s in stretches] == [D, 1] * traced
    assert all("vectorwar_advance" in n for s in stretches for n in s)
