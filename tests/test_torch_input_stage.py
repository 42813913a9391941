"""The SyncTest tick's input stage (``ops/stage.py``), pinned on the CPU.

``InputStage`` copies a call's ``(B, n, ...)`` inputs once into a
persistent block laid out ``(n, B, ...)``, so tick t's row is one
contiguous block, the layout of an input ring slot.  On the CPU the blocks
are plain memory and no event is kept; the card's pinned blocks, events and
sends are ``tests/test_torch_input_stage_card.py``.

- tick t's row equals ``inputs[:, t]``, and is one contiguous block;
- a u32 leaf is carried as int32 of the same bits;
- a dict of leaves of several dtypes keeps each leaf's dtype and order;
- a read-only numpy array is staged with no warning;
- the blocks grow only with a call of more ticks than any before;
- the single session's ``(n, P)`` inputs, as its entry lifts them;
- the staged rows, run through ``run_warmup`` / ``run_steady``, give the
  carry of the CPU route;
- the CPU route counts its ticks under ``ggrs_tick_upload_total{route="host"}``.
"""

import warnings

import numpy as np
import pytest
import torch

from ggrs_tpu_torch import BatchedSessions, BoxGame, DeviceSyncTestSession, build_replay_programs
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.ops.stage import InputStage
from ggrs_tpu_torch.sessions.device_synctest import _one_session
from ggrs_tpu_torch.utils.tree import tree_leaves

CPU = torch.device("cpu")


def _inputs(b, n, p, seed=0, dtype=np.uint8, high=16):
    return np.random.default_rng(seed).integers(0, high, size=(b, n, p)).astype(dtype)


@pytest.mark.parametrize("n", [1, 3, 12])
def test_each_tick_is_one_contiguous_row(n):
    stage = InputStage(CPU)
    a = _inputs(5, n, 2, seed=n)
    rows = stage.put(a)
    assert not stage.pinned
    assert rows.shape == (5, n, 2) and rows.dtype == torch.uint8
    for t in range(n):
        assert rows[:, t].is_contiguous()
        assert np.array_equal(rows[:, t].numpy(), a[:, t])
    assert rows.transpose(0, 1).is_contiguous()  # laid out (n, B, P)


def test_the_benchmark_view_of_a_tick_block():
    # a (B, n, P) transpose of an (n, B, P) block, as a traffic mix hands it
    block = _inputs(4, 6, 3, seed=1).transpose(1, 0, 2).copy()  # (6, 4, 3)
    view = block[2:4].transpose(1, 0, 2)
    rows = InputStage(CPU).put(view)
    assert torch.equal(rows, torch.from_numpy(block[2:4]).transpose(0, 1))


def test_u32_is_carried_as_int32_of_the_same_bits():
    a = np.array([[[0, 1, 2**31, 2**32 - 1]]], np.uint32).repeat(3, axis=0)
    rows = InputStage(CPU).put(a)
    assert rows.dtype == torch.int32
    assert np.array_equal(rows.numpy().view(np.uint32), a)


def test_a_dict_of_leaves_keeps_each_dtype():
    b, n = 4, 2
    tree = {
        "pad": _inputs(b, n, 3, seed=2, dtype=np.int16, high=1000),
        "buttons": _inputs(b, n, 2, seed=3),
        "seq": _inputs(b, n, 1, seed=4, dtype=np.uint32, high=2**32 - 1),
    }
    stage = InputStage(CPU)
    rows = stage.put(tree)
    assert sorted(rows) == ["buttons", "pad", "seq"]
    assert [x.dtype for x in tree_leaves(rows)] == [torch.uint8, torch.int16, torch.int32]
    for key, leaf in tree.items():
        want = leaf.view(np.int32) if leaf.dtype == np.uint32 else leaf
        assert np.array_equal(rows[key].numpy(), want)
    assert stage.allocations == 2 * len(tree)


def test_a_read_only_array_is_taken_with_no_warning():
    a = _inputs(3, 2, 2, seed=5)
    a.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rows = InputStage(CPU).put(a)
    assert np.array_equal(rows.numpy(), a)


def test_a_cpu_tensor_is_staged_too():
    a = torch.from_numpy(_inputs(3, 2, 2, seed=6))
    rows = InputStage(CPU).put(a)
    assert torch.equal(rows, a) and rows.data_ptr() != a.data_ptr()


def test_blocks_grow_only_with_more_ticks_than_before():
    stage = InputStage(CPU)
    counts = []
    for i, n in enumerate([1, 1, 1, 4, 2, 4, 1, 9, 9, 3]):
        a = _inputs(5, n, 2, seed=10 + i)
        assert np.array_equal(stage.put(a).numpy(), a)
        counts.append(stage.allocations)
    # two buffers a leaf: made at the first call, then at n = 4 and n = 9
    assert counts == [2, 2, 2, 4, 4, 4, 4, 6, 6, 6]


def test_calls_alternate_between_the_two_buffers():
    stage = InputStage(CPU)
    ptrs = [stage.put(_inputs(3, 1, 2, seed=i)).data_ptr() for i in range(4)]
    assert ptrs[0] == ptrs[2] and ptrs[1] == ptrs[3] and ptrs[0] != ptrs[1]


def test_the_single_session_layout():
    a = _inputs(1, 5, 2, seed=7)[0]  # (n, P)
    rows = InputStage(CPU).put(_one_session(a))
    assert rows.shape == (1, 5, 2)
    for t in range(5):
        assert np.array_equal(rows[0, t].numpy(), a[t])
    lifted = _one_session(torch.from_numpy(a))
    assert lifted.shape == (1, 5, 2)


def test_staged_rows_run_as_the_cpu_route():
    d, b, n = 3, 4, 12
    game = BoxGame(2)
    progs = build_replay_programs(game.advance, ring_length=d + 1, check_distance=d)
    a = _inputs(b, n, 2, seed=8)
    carries = []
    for staged in (False, True):
        carry = progs.init_carry(game.init_state_np(), np.zeros(2, np.uint8), batch_size=b,
                                 device="cpu")
        if staged:
            stage = InputStage(CPU)
            w = progs.warmup_ticks
            progs.run_warmup(carry, stage.put(a[:, :w]), 0)
            for t in range(w, n):  # one call a tick, the buffers in turns
                progs.run_steady(carry, stage.put(a[:, t:t + 1]), t)
        else:
            progs.run_ticks(carry, a, 0)
        carries.append(tree_leaves(carry))
    for x, y in zip(*carries):
        assert torch.equal(x, y)


def _uploaded(route):
    return default_registry().value("ggrs_tick_upload_total", route=route) or 0.0


@pytest.mark.parametrize("entry", ["single", "batched"])
def test_the_cpu_route_counts_its_ticks(entry):
    game = BoxGame(2)
    if entry == "single":
        sess = DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                     check_distance=2, device="cpu")
        calls = [_inputs(1, n, 2, seed=n)[0] for n in (1, 4, 0, 2)]
    else:
        sess = BatchedSessions(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                               batch_size=3, check_distance=2, max_prediction=2, device="cpu")
        calls = [_inputs(3, n, 2, seed=n) for n in (1, 4, 0, 2)]
    before = {r: _uploaded(r) for r in ("host", "staged", "device")}
    for a in calls:
        sess.run_ticks(a, check=False)
    sess.verify()
    assert _uploaded("host") - before["host"] == 7
    assert _uploaded("staged") == before["staged"] and _uploaded("device") == before["device"]
