"""The SyncTest tick's input stage on the card.

A call's host inputs are copied once into the carry's pinned ``InputStage``
(``ops/stage.py``), and each tick's row is sent from there straight into
its input ring slot.  Pinned here, for both entries (``BatchedSessions`` at
B = 2,048 and ``DeviceSyncTestSession``), for BoxGame(2) and VectorWar:

- a traced steady BoxGame tick sends its inputs in one host-to-device copy
  inside its upload and launches no kernel there (no ``direct_copy``):
  nothing stores them on the card;
- calls made back to back with ``check=False`` and nothing read between,
  behind a kernel that holds the card, so that the stage must wait before
  it rewrites a buffer whose copies have not run: 3 one-tick calls, a
  12-tick call that crosses the warmup into the steady ticks and wraps the
  ring, 3R one-tick calls, and a second 12-tick call; the whole carry then
  equals bitwise the same calls given as CUDA tensors, and, in its first
  ``CPU_ROWS`` sessions, the same calls on the CPU route;
- ``ggrs_tick_upload_total`` rises by one a tick under ``route="staged"``
  (and under ``"device"`` for the CUDA tensors), and the stage's
  allocations do not rise after the first call of each tick count.

The traced tests come first and no test here runs long: a profiler window
that opens some 40 s after the process's previous one drops its first
kernel (torch 2.11, CUDA 12.8), and the traced card tests of the files run
after this one in the same process with it.

Every test needs a CUDA card and skips without one.  ``tests/conftest.py``
imports JAX, which the card's machine does not have, so run this file there
on its own:

    python -m pytest tests/test_torch_input_stage_card.py --noconftest -q
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ggrs_tpu_torch import BatchedSessions, BoxGame, DeviceSyncTestSession
from ggrs_tpu_torch.games.vectorwar import VectorWar
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.utils.tree import tree_leaves

D = 8
B = 2048
R = D + 1

# sessions rerun on the CPU route: few, since a test that runs long makes
# the traced tests after it in the process drop their first kernels (below)
CPU_ROWS = 256

# name: (game, players, input bits)
GAMES = {
    "boxgame": (lambda: BoxGame(2), 2, 16),
    "vectorwar": (VectorWar, 4, 32),
}

# ticks a call, in order: warmup ticks, a call across the warmup's end that
# wraps the ring, 3R calls back to back, a second long call
CALLS = [1] * 3 + [12] + [1] * (3 * R) + [12]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stage sends from pinned memory to the card")
    return torch.device("cuda", torch.cuda.current_device())


def _session(name, entry, device, batch=B):
    make, players, _ = GAMES[name]
    game = make()
    if entry == "single":
        return DeviceSyncTestSession(game.advance, game.init_state_np(),
                                     np.zeros(players, np.uint8), check_distance=D,
                                     max_prediction=D, device=device)
    return BatchedSessions(game.advance, game.init_state_np(), np.zeros(players, np.uint8),
                           batch_size=batch, check_distance=D, max_prediction=D, device=device)


def _calls(name, entry):
    _, players, high = GAMES[name]
    rng = np.random.default_rng(2**31 + 26 + players)
    b = 1 if entry == "single" else B
    calls = [rng.integers(0, high, size=(b, n, players)).astype(np.uint8) for n in CALLS]
    return [a[0] for a in calls] if entry == "single" else calls


def _uploaded(route):
    return default_registry().value("ggrs_tick_upload_total", route=route) or 0.0


@pytest.mark.parametrize("entry", ["single", "batched"])
def test_a_traced_steady_tick_sends_its_inputs_in_one_copy(card, entry, tmp_path):
    # BoxGame alone: the upload does not depend on the game, and traced
    # VectorWar ticks here made the VectorWar kernel file's traced test,
    # run later in the same process, drop its window's first kernel
    sess = _session("boxgame", entry, card)
    calls = _calls("boxgame", entry)
    for a in calls[:4]:  # past the warmup; every steady phase captured below
        sess.run_ticks(a, check=True)
    for a in calls[4:4 + R]:
        sess.run_ticks(a, check=True)
    ticks = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=card).add_(1)  # a first kernel the window may drop
        torch.cuda.synchronize()
        for a in calls[4 + R:4 + R + ticks]:
            sess.run_ticks(a, check=True)
        torch.cuda.synchronize()
    uploaded = _launched_in(prof, tmp_path, "ggrs:tick.upload")
    # the upload holds the tick's one send into its slot, and no kernel
    assert [e["cat"] for e in uploaded] == ["gpu_memcpy"] * ticks, uploaded
    assert all("HtoD" in e["name"] and "Pinned" in e["name"] for e in uploaded), uploaded


def _launched_in(prof, tmp_path, span):
    """The device operations (kernels, copies, fills) launched from inside
    the host spans named ``span``, by launch time."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == span]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in (e.get("args") or {})}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e.get("args", {}).get("correlation") in launched]
    inside = [e for e in device
              if any(lo <= launched[e["args"]["correlation"]] <= hi for lo, hi in spans)]
    return sorted(inside, key=lambda e: launched[e["args"]["correlation"]])


@pytest.mark.parametrize("entry", ["single", "batched"])
@pytest.mark.parametrize("name", sorted(GAMES))
def test_back_to_back_calls_match_the_other_routes(card, name, entry):
    sess = _session(name, entry, card)
    calls = _calls(name, entry)
    staged, allocations, seen = _uploaded("staged"), [], set()
    for i, a in enumerate(calls):
        if i == 4:
            torch.cuda._sleep(200_000_000)  # holds the card while the calls queue
        sess.run_ticks(a, check=False)
        (stage,) = sess.programs.input_stages
        if CALLS[i] in seen:
            assert stage.allocations == allocations[-1], (i, CALLS[i])
        seen.add(CALLS[i])
        allocations.append(stage.allocations)
    assert _uploaded("staged") - staged == sum(CALLS)
    assert allocations[0] == 2 and allocations[-1] == 4  # two buffers, grown once
    sess.verify()
    # the same calls as CUDA tensors (every session), and on the CPU route
    twin, device = _session(name, entry, card), _uploaded("device")
    for a in calls:
        twin.run_ticks(torch.from_numpy(a).to(card), check=False)
    twin.verify()
    assert _uploaded("device") - device == sum(CALLS)
    rows = 1 if entry == "single" else CPU_ROWS
    cpu = _session(name, entry, "cpu", rows)
    for a in calls:
        cpu.run_ticks(a if entry == "single" else a[:rows], check=False)
    cpu.verify()
    torch.cuda.synchronize()
    got = tree_leaves(sess.carry)
    for want, lead in ((tree_leaves(twin.carry), None), (tree_leaves(cpu.carry), rows)):
        assert len(got) == len(want)
        for x, y in zip(got, want):
            x = x if entry == "single" or lead is None else x[:lead]
            assert x.shape == y.shape and x.dtype == y.dtype
            assert torch.equal(x.to(y.device), y)
