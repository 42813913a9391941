"""The lockstep replay's slot-major ring on the card.

``ReplayPrograms.init_carry`` stores the ring, its checksums and frames, the
input ring and the digest history slot-major, so the steady tick advances
each resimulated frame into its ring slot, digests the window one launch a
contiguous span of slots straight into the checksums, and compares it where
it lies.  Pinned here, at B = 4,096, R = 9 and d = 8, for BoxGame and
VectorWar on their advance kernels:

- a profiled steady tick of every phase runs no ``CatArrayBatchedCopy*``
  kernel in its graph and no copy in its ring layer, and exactly the
  kernels its phase predicts, layer by layer (``_predicted_layers``: the
  window wraps the ring in 7 phases of 9);
- each captured steady tick launches its 9 advances from Python, each
  into its ring slot or the live state (the output pointers handed to the
  library), a lone advance and a scrub window into fresh tensors, and no
  replay launches from Python; the carry keeps its tensors;
- the carry after the run is bitwise the same sessions' on the eager
  bodies: all of them on the card, the first ``CPU_ROWS`` on the CPU;
- the kernel wrappers refuse an ``out`` that is not contiguous rows, is not
  int32 or overlaps the state being read.

Every test needs a CUDA card and skips without one.  ``tests/conftest.py``
imports JAX, which the card's machine does not have, so run this file there
on its own:

    python -m pytest tests/test_torch_ring_slot_major_card.py --noconftest -q
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ggrs_tpu_torch import BatchedSessions, BoxGame, build_scrub_program
from ggrs_tpu_torch.games import _card
from ggrs_tpu_torch.games import boxgame as boxgame_mod
from ggrs_tpu_torch.games import vectorwar as vectorwar_mod
from ggrs_tpu_torch.games.vectorwar import VectorWar
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

D = 8
B = 4096
MARKS = 7  # the steady tick's layer marks, kernels while a profiler runs

# sessions rerun on the CPU's eager body: few, since a profiled window that
# opens tens of seconds after the process's last one drops its first kernel
# (torch 2.11, CUDA 12.8), which a slow test would do to the traced tests
# after it
CPU_ROWS = 64

# name: (game, players, input bits, the advance kernel's name, its module)
GAMES = {
    "boxgame": (lambda: BoxGame(2), 2, 16, "boxgame_advance_kernel", boxgame_mod),
    "vectorwar": (VectorWar, 4, 32, "vectorwar_advance_kernel", vectorwar_mod),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the advance and digest kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())


def _launched(name):
    return default_registry().value("ggrs_game_advance_total", game=name, route="kernel") or 0.0


def _spy(monkeypatch, name):
    """The output pointers of each launch of the game's kernel made from
    Python, in the kernel's leaf order, as the launches go on."""
    seen, call = [], _card.call

    def spy(what, fn, args, device):
        outs = args[11:14] if name == "boxgame" else args[6]  # a ctypes array
        seen.append(list(outs))
        call(what, fn, args, device)

    monkeypatch.setattr(_card, "call", spy)
    return seen


def _carry_slots(name, carry, r):
    """Each ring slot's and the live state's pointers, in the kernel's leaf
    order."""
    keys = GAMES[name][4]._advance_kernel.names
    states, live = carry["ring"]["states"], carry["live"]
    return [[states[k][:, i].data_ptr() for k in keys] for i in range(r)] + \
        [[live[k].data_ptr() for k in keys]]


def _session(name, device):
    make, players, _, _, _ = GAMES[name]
    game = make()
    return game, BatchedSessions(game.advance, game.init_state_np(), np.zeros(players, np.uint8),
                                 batch_size=B, check_distance=D, max_prediction=D, device=device)


def _inputs(name, ticks):
    _, players, high, _, _ = GAMES[name]
    rng = np.random.default_rng(2**31 + 24 + players)
    return rng.integers(0, high, size=(B, ticks, players)).astype(np.uint8)


def _predicted_layers(spans: int) -> list:
    """The kernels of one profiled steady tick whose window lies in
    ``spans`` contiguous spans of ring slots, stretch by stretch as the
    marks open them: d advances; a digest a span; the window's frame
    offsets and a stamp a span; a span's compare (``!=``, ``any``, the
    count's cast to int32 and its sum, its add, ``where`` with the fill of
    its scalar, ``amin``, ``minimum``); the live advance; its digest; the
    frame's increment."""
    return [("advance", D), ("digest", spans), ("ring", 1 + spans), ("compare", 9 * spans),
            ("advance", 1), ("digest", 1), ("ring", 1)]


def _stretches(kernels):
    """One tick's graph kernels as (layer, [kernels]) stretches, each opened
    by its mark."""
    out = []
    for k in kernels:
        if k.startswith("ggrs_mark_"):
            out.append((k[len("ggrs_mark_"):], []))
        else:
            assert out, f"{k} before the tick's first mark"
            out[-1][1].append(k)
    return out


def _graph_kernels(prof, tmp_path):
    """The kernels each ``cudaGraphLaunch`` ran, one list a launch, in
    launch order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "correlation" in (e.get("args") or {})]
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "GraphLaunch" in e["name"]), key=lambda e: float(e["ts"]))
    by_launch = {e["args"]["correlation"]: [] for e in launches}
    for e in sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: float(e["ts"])):
        if e["args"]["correlation"] in by_launch:
            by_launch[e["args"]["correlation"]].append(e["name"])
    return [by_launch[e["args"]["correlation"]] for e in launches]


@pytest.mark.parametrize("name", sorted(GAMES))
def test_every_phase_runs_its_window_in_place(card, name, tmp_path, monkeypatch):
    game, sess = _session(name, card)
    programs, ring = sess.programs, sess.programs.ring
    r = ring.length
    at = D + 1 + r  # the warmup, then a ring period: every phase captured
    ticks = at + r + 2
    inputs = _inputs(name, ticks)
    seen = _spy(monkeypatch, name)
    before = _launched(name)
    sess.run_ticks(inputs[:, :D + 1], check=True)
    slots = _carry_slots(name, sess.carry, r)
    carry = [x.data_ptr() for x in tree_leaves(sess.carry)]
    # the warmup's advances write fresh tensors
    assert len(seen) == _launched(name) - before == D + 1
    assert not [p for p in seen if p in slots]
    for t in range(D + 1, at):
        sess.run_ticks(inputs[:, t:t + 1], check=True)
    (graphs,) = programs.tick_graphs
    assert graphs.captures == r
    # 9 of 9 a captured tick into the carry
    captured = seen[D + 1:]
    assert len(captured) == _launched(name) - before - (D + 1) == (D + 1) * r
    assert all(p in slots for p in captured)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(at, at + r):
            sess.run_ticks(inputs[:, t:t + 1], check=True)
        torch.cuda.synchronize()
    assert len(seen) == _launched(name) - before == (D + 1) * (r + 1)  # no Python in a replay
    per_tick = _graph_kernels(prof, tmp_path)
    assert len(per_tick) == r
    kernel = GAMES[name][3]
    for frame, kernels in zip(range(at, at + r), per_tick):
        spans = len(ring.spans(frame - D + 1, D))
        assert programs.digest_calls(frame) == spans + 1
        stretches = _stretches(kernels)
        shape = [(layer, len(ks)) for layer, ks in stretches]
        assert shape == _predicted_layers(spans), (frame % r, shape, stretches)
        assert len(kernels) == MARKS + sum(n for _, n in shape)
        assert not [k for k in kernels if "CatArrayBatchedCopy" in k], kernels
        for layer, ks in stretches:
            want = {"advance": kernel, "digest": "state_digest"}.get(layer)
            if want is not None:
                assert all(want in k for k in ks), (layer, ks)
            if layer == "ring":
                assert not [k for k in ks if "direct_copy" in k or "Copy" in k], ks
    assert {len(ring.spans(f - D + 1, D)) for f in range(at, at + r)} == {1, 2}
    sess.run_ticks(inputs[:, at + r:], check=True)
    torch.cuda.synchronize()
    assert [x.data_ptr() for x in tree_leaves(sess.carry)] == carry
    # a lone advance and a scrub window write fresh tensors, not the carry
    count = len(seen)
    live = tree_map(lambda x: x[:4], sess.carry["live"])
    game.advance(live, torch.from_numpy(inputs[:4, 0]).to(card))
    scrub = build_scrub_program(game.advance, card)
    scrub(tree_map(lambda x: x[0], live), torch.from_numpy(inputs[0, :3]).to(card))
    torch.cuda.synchronize()
    assert len(seen) > count and not [p for p in seen[count:] if p in slots]

    # the same ticks on the eager bodies: every session on the card, and the
    # first CPU_ROWS on the CPU (kept short: see CPU_ROWS)
    got = tree_leaves(sess.carry)
    monkeypatch.setattr(_card, "on_card", lambda *tensors: False)
    _, twin = _session(name, card)
    twin.run_ticks(inputs, check=True)
    torch.cuda.synchronize()
    cpu = BatchedSessions(game.advance, game.init_state_np(), np.zeros(GAMES[name][1], np.uint8),
                          batch_size=CPU_ROWS, check_distance=D, max_prediction=D, device="cpu")
    assert cpu.run_ticks(inputs[:CPU_ROWS])["mismatches"] == 0
    for want in (tree_leaves(twin.carry), tree_leaves(cpu.carry)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            rows = a[:b.shape[0]]
            assert rows.shape == b.shape
            assert torch.equal(rows.to(b.device), b)


@pytest.mark.parametrize("name", sorted(GAMES))
def test_kernel_refuses_an_out_it_cannot_write(card, name):
    make, players, _, _, _ = GAMES[name]
    game = make()
    r = D + 1
    live = {k: v.unsqueeze(0).expand(B, *v.shape).clone() for k, v in game.init_state(card).items()}
    slot_major = {k: v.unsqueeze(0).expand(r, *v.shape).clone().transpose(0, 1)
                  for k, v in live.items()}
    session_major = {k: v.contiguous() for k, v in slot_major.items()}
    st = {k: v[:, 3] for k, v in slot_major.items()}
    inputs = torch.zeros((B, players), dtype=torch.uint8, device=card)
    want = game.advance(st, inputs)
    out = {k: v[:, 4] for k, v in slot_major.items()}
    assert game.advance(st, inputs, out=out) is not None
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(out[k], want[k])
    with pytest.raises(ValueError, match="not contiguous"):
        game.advance(st, inputs, out={k: v[:, 4] for k, v in session_major.items()})
    wide = {k: torch.empty_like(v) for k, v in st.items()}
    wide["pos"] = wide["pos"].to(torch.int64)
    with pytest.raises(ValueError, match="int32 tensor"):
        game.advance(st, inputs, out=wide)
    with pytest.raises(ValueError, match="overlaps"):
        game.advance(st, inputs, out=st)
    torch.cuda.synchronize()
