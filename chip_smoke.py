#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``ggrs_tpu_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the run non-zero:

1. build -- compile the CUDA kernels from ``ggrs_tpu_torch/csrc`` with nvcc
   (all sources at once) and report the build seconds and ptxas summary.
2. kernel -- the digest kernel against its plain PyTorch version on the
   card, bitwise, at every shape the port uses: through ``lane_sums_rows``
   (raw lanes of a word matrix) and through ``state_digest`` (whole batches
   of states read from their leaves: the ChipVM live and folded resim
   digests, BoxGame, a strided ring slot view, a state of every dtype and a
   2^26-word leaf).  Per shape: device us per launch from CUDA events
   around a CUDA graph of many launches (inputs rotated so the working set
   exceeds the L2 cache), host us per wrapper call, the plain version's
   time and the bytes bound.  The profiler checks that one CUDA
   ``checksum_device`` runs exactly one kernel.
3. flagship -- BoxGame(2) in a DeviceSyncTestSession at check_distance=8 on
   the card for 4096 ticks, 0 mismatches, bitwise equal to the same run on
   the CPU and to the NumPy oracle, exactly 2 digest launches per tick.
4. batched (the main path at real scale) -- ChipVM(2), B = 16,384 sessions,
   d = 8, 64 ticks: 0 mismatches; sessions 0-7 rerun on the CPU bitwise
   equal; exactly 2 digest launches per tick.  Kernel launch counts are
   zeroed just before this drive and read just after it.
5. executor (the request-list path) -- ``SessionBuilder`` -> host
   ``SyncTestSession`` (check_distance 7, max_prediction 8) ->
   ``DeviceRequestExecutor`` on the card, for BoxGame(2) over 2,000 frames
   and ChipVM(2) over 500.  Every ``executor.run`` runs under
   ``torch.cuda.set_sync_debug_mode("error")``, so a device->host read
   there fails the run.  Every saved checksum and the final live state
   equal the same run on the CPU (BoxGame also the NumPy oracle), and the
   digest launches exactly once per frame (counts zeroed just before each
   drive).  Host ms per frame, and the digest's device us at the 1 and 7
   rows the executor digests, with both held bitwise against the plain
   version.
6. checkpoint -- the ChipVM B = 16,384, d = 8 batch saved after 32 ticks,
   loaded into a fresh ``BatchedSessions`` and run 32 more ticks: its carry
   (16,384 x 2,964 bytes) is bitwise the uninterrupted run's.  File size,
   save and load seconds.

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and, last, ``{"ok": true, "device": {...}}``.
Exits non-zero with no result when CUDA is not available.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ggrs_tpu_torch import (
    BatchedSessions,
    BoxGame,
    ChipVM,
    DeviceRequestExecutor,
    DeviceSyncTestSession,
    SaveGameState,
    SessionBuilder,
    _build,
    boxgame_config,
    to_numpy,
)
from ggrs_tpu_torch.ops.checksum import checksum_device, checksum_device_plain
from ggrs_tpu_torch.ops.digest import lane_sums_rows, lane_sums_rows_plain, state_digest
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
L2_BYTES = 50e6
D = 8
FLAGSHIP_TICKS, FLAGSHIP_CHUNK = 4096, 512
BATCH, BATCH_TICKS, BATCH_UNTIMED = 16384, 64, 16
CHIPVM_WORDS = 66  # 256 mem bytes + 4 regs + 1 pc byte -> 64 + 1 + 1 words
KERNEL_SHAPES = [  # (rows, width, offset)
    (1, 1, 0), (1, 100, 0), (1, 128, 0), (1, 32768, 0), (1, 32769, 0),
    (1, 3 * 32768 - 7, 0), (BATCH, CHIPVM_WORDS, 0), (BATCH, CHIPVM_WORDS, 5),
    (1, 1 << 26, 0),
]
BIG_LEAF_WORDS = 1 << 26  # one 256 MiB leaf
MAIN_CASE = "chipvm_live"
EXEC_D, EXEC_MAX_PREDICTION = 7, 8
EXEC_GAMES = [("BoxGame(2)", BoxGame(2), 2000, 16), ("ChipVM(2)", ChipVM(2), 500, 256)]
CKPT_TICKS = 32
CHIPVM_STATE_BYTES = 256 + 4 + 1


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events around the run (the host's dispatch floor for short kernels)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_us(fn, inputs: list, launches: int = 64, reps: int = 5) -> float:
    """Device us per call of ``fn``: CUDA events around replays of a CUDA
    graph of ``launches`` calls, cycling over ``inputs`` (copies, so that a
    working set above the L2 cache is read from device memory)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in inputs:  # first calls (library load, occupancy) outside capture
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    us = start.elapsed_time(end) * 1e3 / (reps * launches)
    del graph
    torch.cuda.empty_cache()
    return us


def host_us(fn, calls: int = 200) -> float:
    """Host us per call of ``fn`` (the enqueue cost), then a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def copies_for(nbytes: int) -> int:
    """How many copies of an input exceed the L2 cache twice over."""
    return max(1, min(32, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound_us(bytes_read: int, rows: int) -> float:
    """Least time: the bytes the kernel must read once, and 16 B of output
    per row written once, at the device memory rate.  About a dozen integer
    operations per 4-byte word puts the digest far on the bytes side."""
    return (bytes_read + 16 * rows) / HBM_BYTES_PER_S * 1e6


def u32_err(got: torch.Tensor, want: torch.Tensor) -> int:
    diff = (got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)
    return int(diff.abs().max()) if diff.numel() else 0


def trees_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb)
    )


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- the states of phase 2 ---------------------------------------------------


def _card(arr: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return (t if dtype is None else t.view(dtype)).cuda()


def chipvm_state(rng, lead: tuple) -> dict:
    u8 = lambda shape: _card(rng.integers(0, 256, size=shape, dtype=np.uint8))
    return {"mem": u8(lead + (256,)), "pc": u8(lead), "regs": u8(lead + (4,))}


def boxgame_state(rng, lead: tuple) -> dict:
    i32 = lambda shape: _card(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int32))
    return {"pos": i32(lead + (2, 2)), "rot": i32(lead + (2,)), "vel": i32(lead + (2, 2))}


def all_dtypes_state(rng, b: int) -> dict:
    """Every dtype the structure salt knows, odd byte counts and 0-d leaves."""
    bits = lambda shape, np_t: rng.integers(0, 2**64, size=shape, dtype=np.uint64).astype(np_t)
    return {
        "bool": _card(rng.integers(0, 2, size=(b, 3)).astype(bool)),
        "u8": _card(bits((b, 3), np.uint8)),
        "u8_0d": _card(bits((b,), np.uint8)),
        "i8": _card(bits((b, 5), np.int8)),
        "i16": _card(bits((b, 5), np.int16)),
        "u16": _card(bits((b, 3), np.int16), torch.uint16),
        "f16": _card(bits((b, 3), np.int16), torch.float16),
        "bf16": _card(bits((b, 5), np.int16), torch.bfloat16),
        "i32": _card(bits((b,), np.int32)),
        "u32": _card(bits((b, 2), np.int32), torch.uint32),
        "f32": _card(bits((b, 3), np.int32), torch.float32),
        "i64": _card(bits((b, 2), np.int64)),
        "u64": _card(bits((b, 1), np.int64), torch.uint64),
        "f64": _card(bits((b, 2), np.int64), torch.float64),
    }


def flat_rows(state):
    """A (B, n, ...) stack as B*n rows: views, as the replay digests its window."""
    return tree_map(lambda leaf: leaf.flatten(0, 1), state)


def ring_slot(ring):
    """Slot 4 of a (B, R, ...) ring: rows strided by the ring's length."""
    return tree_map(lambda buf: buf[:, 4], ring)


def state_cases(rng):
    """(name, the state's tensors, the view of them that is digested)."""
    same = lambda s: s
    return [
        ("chipvm_live", chipvm_state(rng, (BATCH,)), same),
        ("chipvm_resim_folded", chipvm_state(rng, (BATCH, D)), flat_rows),
        ("boxgame_b1", boxgame_state(rng, (1,)), same),
        ("boxgame_b1_resim_folded", boxgame_state(rng, (1, D)), flat_rows),
        ("chipvm_ring_slot_view", chipvm_state(rng, (BATCH, D + 1)), ring_slot),
        ("all_dtypes", all_dtypes_state(rng, BATCH), same),
        ("leaf_2p26_words", {"w": _card(rng.integers(0, 2**32, size=(1, BIG_LEAF_WORDS),
                                                     dtype=np.uint32).view(np.int32))}, same),
    ]


# -- phases ------------------------------------------------------------------


def phase_build(smi: str) -> None:
    seconds = _build.build()
    ptxas = [
        line.strip()
        for log in _build.build_logs.values()
        for line in log.splitlines()
        if "ptxas info" in line and ("Used" in line or "spill" in line)
    ]
    emit({"phase": "build", "seconds": seconds, "sources": sorted(_build.SOURCES),
          "ptxas": ptxas, "card": smi})


def phase_lane_sums(rng) -> int:
    """``lane_sums_rows`` against its plain version; returns the worst error."""
    worst = 0
    for rows, width, offset in KERNEL_SHAPES:
        host = rng.integers(0, 2**32, size=(rows, width), dtype=np.uint32)
        words = torch.from_numpy(host.view(np.int32)).cuda()
        del host
        got = lane_sums_rows(words, offset)
        want = lane_sums_rows_plain(words, offset)
        torch.cuda.synchronize()
        err = u32_err(got, want)
        check(torch.equal(got, want), f"lane_sums_rows != plain at {(rows, width, offset)}")
        worst = max(worst, err)
        nbytes = 4 * rows * width
        inputs = [words] + [words.clone() for _ in range(copies_for(nbytes) - 1)]
        big = nbytes >= 1 << 26
        emit({"phase": "kernel", "entry": "lane_sums_rows", "rows": rows, "width": width,
              "offset": offset, "bitwise_equal": True, "max_abs_err": err,
              "device_us": graph_us(lambda w: lane_sums_rows(w, offset), inputs),
              "host_us": host_us(lambda: lane_sums_rows(words, offset)),
              "plain_ms": device_ms(lambda: lane_sums_rows_plain(words, offset),
                                    iters=3 if big else 20, warmup=1),
              "bound_us": bound_us(nbytes, rows)})
        del words, got, want, inputs
        torch.cuda.empty_cache()
    return worst


def one_kernel_per_digest(state) -> dict:
    """Profile one CUDA ``checksum_device``: it must run exactly one kernel
    and nothing else on the device (the output comes from torch.empty)."""
    from torch.profiler import ProfilerActivity, profile

    checksum_device(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        checksum_device(state)
        torch.cuda.synchronize()
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in device_events]
    check(len(device_events) == 1 and "state_digest" in names[0],
          f"a CUDA checksum_device ran {names} on the device, not one state_digest kernel")
    return {"device_ops": names, "profiler_device_us": device_events[0].device_time}


def phase_state_digest(rng) -> dict:
    """``state_digest`` (through ``checksum_device``) against
    ``checksum_device_plain`` at every state shape; returns the records."""
    records = {}
    for name, state, view in state_cases(rng):
        rows_state = view(state)
        leaves = tree_leaves(rows_state)
        rows = leaves[0].shape[0]
        bytes_per_row = sum(math.prod(l.shape[1:]) * l.element_size() for l in leaves)
        got = checksum_device(rows_state)
        want = checksum_device_plain(rows_state)
        torch.cuda.synchronize()
        err = u32_err(got, want)
        check(got.shape == (rows, 4) and torch.equal(got, want),
              f"state_digest != plain on {name}")
        n_copies = copies_for(bytes_per_row * rows)
        inputs = [rows_state] + [view(tree_map(torch.clone, state)) for _ in range(n_copies - 1)]
        big = bytes_per_row * rows >= 1 << 26
        rec = {"phase": "kernel", "entry": "state_digest", "case": name, "rows": rows,
               "leaves": len(leaves), "bytes_per_row": bytes_per_row,
               "bitwise_equal": True, "max_abs_err": err,
               "device_us": graph_us(checksum_device, inputs),
               "device_us_l2_warm": graph_us(checksum_device, [rows_state]),
               "input_copies": n_copies,
               "host_us": host_us(lambda: checksum_device(rows_state)),
               "plain_ms": device_ms(lambda: checksum_device_plain(rows_state),
                                     iters=3 if big else 20, warmup=1),
               "bound_us": bound_us(bytes_per_row * rows, rows)}
        rec["share_of_bound"] = rec["bound_us"] / rec["device_us"]
        if name == MAIN_CASE:
            rec.update(one_kernel_per_digest(rows_state))
        emit(rec)
        records[name] = rec
        del state, rows_state, leaves, got, want, inputs
        torch.cuda.empty_cache()
    return records


def phase_flagship() -> None:
    game = BoxGame(2)
    inputs = np.random.default_rng(7).integers(0, 16, size=(FLAGSHIP_TICKS, 2)).astype(np.uint8)
    chunks = torch.from_numpy(inputs).cuda().split(FLAGSHIP_CHUNK)
    sess = DeviceSyncTestSession(
        game.advance, game.init_state_np(), np.zeros(2, np.uint8), check_distance=D
    )
    state_digest.launches = lane_sums_rows.launches = 0
    sess.run_ticks(chunks[0], check=False)
    sess.block_until_ready()
    t0 = time.perf_counter()
    for c in chunks[1:]:
        sess.run_ticks(c, check=False)
    sess.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = state_digest.launches
    check(lane_sums_rows.launches == 0, "flagship: the digest went around state_digest")
    sess.verify()  # raises MismatchedChecksum on any desync
    check(launches == 2 * FLAGSHIP_TICKS,
          f"flagship: {launches} digest launches, not 2 x {FLAGSHIP_TICKS} ticks")

    cpu = DeviceSyncTestSession(
        game.advance, game.init_state_np(), np.zeros(2, np.uint8), check_distance=D, device="cpu"
    )
    for c in np.split(inputs, FLAGSHIP_TICKS // FLAGSHIP_CHUNK):
        cpu.run_ticks(c, check=False)
    cpu.verify()
    check(trees_equal(to_numpy(sess.carry), to_numpy(cpu.carry)),
          "flagship: card carry != CPU carry")
    ref = game.init_state_np()
    for i in range(FLAGSHIP_TICKS):
        ref = game.advance_np(ref, inputs[i])
    check(trees_equal(sess.live_state(), ref), "flagship: live state != NumPy oracle")
    timed_ticks = FLAGSHIP_TICKS - FLAGSHIP_CHUNK
    emit({"phase": "flagship", "game": "BoxGame(2)", "check_distance": D,
          "ticks": FLAGSHIP_TICKS, "mismatches": 0, "equal_to_cpu": True,
          "equal_to_oracle": True, "timed_ticks": timed_ticks,
          "ms_per_tick": elapsed / timed_ticks * 1e3,
          "resim_frames_per_s": timed_ticks * D / elapsed,
          "digest_launches": launches,
          "digest_launches_per_tick": launches / FLAGSHIP_TICKS})


def phase_batched() -> int:
    vm = ChipVM(2)
    inputs = np.random.default_rng(11).integers(0, 256, size=(BATCH, BATCH_TICKS, 2)).astype(np.uint8)
    dev_inputs = torch.from_numpy(inputs).cuda()
    batch = BatchedSessions(
        vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=BATCH,
        check_distance=D, max_prediction=D,
    )
    torch.cuda.synchronize()
    state_digest.launches = lane_sums_rows.launches = 0
    batch.run_ticks(dev_inputs[:, :BATCH_UNTIMED], check=False)
    batch.block_until_ready()
    t0 = time.perf_counter()
    batch.run_ticks(dev_inputs[:, BATCH_UNTIMED:], check=False)
    batch.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = state_digest.launches
    check(lane_sums_rows.launches == 0, "batched: the digest went around state_digest")
    stats = batch.verify()
    check(stats["mismatches"] == 0, f"batched: {stats['mismatches']} mismatches")
    check(launches == 2 * BATCH_TICKS,
          f"batched: {launches} digest launches, not 2 x {BATCH_TICKS} ticks")

    n_cpu = 8
    cpu = BatchedSessions(
        vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=n_cpu,
        check_distance=D, max_prediction=D, device="cpu",
    )
    check(cpu.run_ticks(inputs[:n_cpu])["mismatches"] == 0, "batched: CPU rerun mismatched")
    head = to_numpy(tree_map(lambda t: t[:n_cpu], batch.carry))
    check(trees_equal(head, to_numpy(cpu.carry)), "batched: sessions 0-7 != CPU rerun")
    timed = BATCH_TICKS - BATCH_UNTIMED
    live = batch.live_states()
    check(all(np.isfinite(l).all() and l.shape[0] == BATCH for l in tree_leaves(live)),
          "batched: live states malformed")
    emit({"phase": "batched", "game": "ChipVM(2)", "sessions": BATCH,
          "check_distance": D, "ring": D + 1, "ticks": BATCH_TICKS, "mismatches": 0,
          "sessions_equal_to_cpu": n_cpu, "timed_ticks": timed,
          "ms_per_tick": elapsed / timed * 1e3,
          "resim_frames_per_s": BATCH * timed * D / elapsed,
          "digest_launches": launches,
          "digest_launches_per_tick": launches / BATCH_TICKS,
          "kernels": ["digest"]})
    return launches


def executor_inputs(pairs) -> np.ndarray:
    return np.asarray([p[0] for p in pairs], np.uint8)


def drive_executor(game, inputs: np.ndarray, device):
    """Play ``inputs`` through SessionBuilder -> SyncTestSession ->
    DeviceRequestExecutor.  On the card every ``run`` is under the sync
    debug mode "error", and the digest launch counts are zeroed just before
    the first frame (after the warmup).  Each frame's saved checksums are
    read back after its ``run``, as the session reads them next frame.
    Returns (executor, saved (frame, checksum) per frame, loop seconds, the
    last frame's saved states)."""
    sess = (SessionBuilder(boxgame_config()).with_check_distance(EXEC_D)
            .with_max_prediction_window(EXEC_MAX_PREDICTION).start_synctest_session())
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), executor_inputs, device=device)
    ex.warmup(inputs[0], burst_depths=range(2, EXEC_MAX_PREDICTION + 2))
    card = ex.device.type == "cuda"
    saved, saves = [], []
    state_digest.launches = lane_sums_rows.launches = 0
    t0 = time.perf_counter()
    for f in range(len(inputs)):
        sess.add_local_input(0, int(inputs[f, 0]))
        sess.add_local_input(1, int(inputs[f, 1]))
        reqs = sess.advance_frame()
        if card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            ex.run(reqs)
        finally:
            if card:
                torch.cuda.set_sync_debug_mode(0)
        saves = [r for r in reqs if isinstance(r, SaveGameState)]
        saved.append([(r.frame, r.cell.checksum) for r in saves])
    ex.block_until_ready()
    seconds = time.perf_counter() - t0
    return ex, saved, seconds, [r.cell.data() for r in saves]


def sync_caught(fn) -> bool:
    """Whether ``fn`` raises under the sync debug mode "error"."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return False


def phase_executor() -> int:
    """The request-list path on the card against the CPU; returns the digest
    launches of the card's drives."""
    # the guard around executor.run must catch a device->host read
    item_caught = sync_caught(lambda: torch.ones(1, device="cuda").item())
    check(item_caught, "executor: the sync debug mode let .item() through")
    emit({"phase": "executor", "sync_debug_control": {
        "item_caught": item_caught,
        "pageable_copy_caught": sync_caught(lambda: torch.ones(2).to("cuda"))}})
    total = 0
    for name, game, frames, high in EXEC_GAMES:
        inputs = np.random.default_rng(17).integers(0, high, size=(frames, 2)).astype(np.uint8)
        ex, saved, seconds, last = drive_executor(game, inputs, None)
        launches = state_digest.launches
        check(lane_sums_rows.launches == 0, f"executor {name}: the digest went around state_digest")
        check(launches == frames, f"executor {name}: {launches} digest launches, not one per frame ({frames})")
        cpu, cpu_saved, _, _ = drive_executor(game, inputs, "cpu")
        check(saved == cpu_saved, f"executor {name}: saved checksums != CPU run")
        check(trees_equal(to_numpy(ex.state), to_numpy(cpu.state)), f"executor {name}: live state != CPU run")
        oracle = None
        if isinstance(game, BoxGame):
            ref = game.init_state_np()
            for f in range(frames):
                ref = game.advance_np(ref, inputs[f])
            oracle = trees_equal(to_numpy(ex.state), ref)
            check(oracle, f"executor {name}: live state != NumPy oracle")
        check(len(last) == EXEC_D, f"executor {name}: the last frame saved {len(last)} states")
        digest = {}
        for rows, st in ((1, tree_map(lambda l: l.unsqueeze(0), ex.state)),
                         (EXEC_D, tree_map(lambda *ls: torch.stack(ls), *last))):
            got, want = checksum_device(st), checksum_device_plain(st)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"executor {name}: digest of {rows} rows != plain")
            row_bytes = sum(math.prod(l.shape[1:]) * l.element_size() for l in tree_leaves(st))
            digest[rows] = {"device_us": graph_us(checksum_device, [st]),
                            "plain_ms": device_ms(lambda: checksum_device_plain(st), iters=20),
                            "bound_us": bound_us(row_bytes * rows, rows),
                            "max_abs_err": u32_err(got, want)}
        emit({"phase": "executor", "game": name, "check_distance": EXEC_D,
              "max_prediction": EXEC_MAX_PREDICTION, "frames": frames,
              "saves": sum(len(s) for s in saved), "equal_to_cpu": True,
              "equal_to_oracle": oracle, "sync_debug_mode": "error",
              "host_ms_per_frame": seconds / frames * 1e3,
              "digest_launches": launches, "digest_launches_per_frame": launches / frames,
              "digest_us_1_row": digest[1]["device_us"],
              f"digest_us_{EXEC_D}_rows": digest[EXEC_D]["device_us"],
              "digest_plain_ms_1_row": digest[1]["plain_ms"],
              f"digest_plain_ms_{EXEC_D}_rows": digest[EXEC_D]["plain_ms"],
              "digest_bound_us_1_row": digest[1]["bound_us"],
              f"digest_bound_us_{EXEC_D}_rows": digest[EXEC_D]["bound_us"],
              "digest_max_abs_err": max(d["max_abs_err"] for d in digest.values())})
        total += launches
    return total


def phase_checkpoint() -> None:
    vm = ChipVM(2)
    inputs = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, size=(BATCH, 2 * CKPT_TICKS, 2)).astype(np.uint8)).cuda()

    def fresh():
        return BatchedSessions(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8),
                               batch_size=BATCH, check_distance=D, max_prediction=D)

    a = fresh()
    a.run_ticks(inputs[:, :CKPT_TICKS], check=False)
    carry_bytes = sum(l.numel() * l.element_size() for l in tree_leaves(a.carry))
    ring = D + 1  # states, digests, frames, inputs, history; live; 3 counters
    per_session = ring * (CHIPVM_STATE_BYTES + 16 + 4 + 2 + 16) + CHIPVM_STATE_BYTES + 12
    check(carry_bytes == BATCH * per_session,
          f"checkpoint: carry holds {carry_bytes} bytes, the layout counts {BATCH * per_session}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "batch.npz")
        a.block_until_ready()
        t0 = time.perf_counter()
        a.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        a.run_ticks(inputs[:, CKPT_TICKS:], check=False)
        b = fresh()
        b.block_until_ready()
        t0 = time.perf_counter()
        b.load_checkpoint(path)
        b.block_until_ready()
        load_s = time.perf_counter() - t0
    check(b.current_frame == CKPT_TICKS, f"checkpoint: resumed at frame {b.current_frame}")
    b.run_ticks(inputs[:, CKPT_TICKS:], check=False)
    stats = a.verify()
    check(stats["mismatches"] == 0, f"checkpoint: {stats['mismatches']} mismatches")
    check(b.verify() == stats, "checkpoint: resumed batch's stats differ")
    check(all(torch.equal(x, y) for x, y in zip(tree_leaves(a.carry), tree_leaves(b.carry))),
          "checkpoint: resumed carry != uninterrupted carry")
    emit({"phase": "checkpoint", "game": "ChipVM(2)", "sessions": BATCH, "check_distance": D,
          "ticks_before": CKPT_TICKS, "ticks_after": CKPT_TICKS, "carry_bytes": carry_bytes,
          "bytes_per_session": per_session, "file_bytes": size, "save_s": save_s,
          "load_s": load_s, "resumed_bitwise_equal": True, "mismatches": 0})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs the card",
              file=sys.stderr)
        return 2
    smi = nvidia_smi()
    phase_build(smi)
    rng = np.random.default_rng(2026)
    worst = phase_lane_sums(rng)
    cases = phase_state_digest(rng)
    worst = max([worst] + [c["max_abs_err"] for c in cases.values()])
    phase_flagship()
    launches = phase_batched()
    exec_launches = phase_executor()
    phase_checkpoint()
    main_case = cases[MAIN_CASE]
    emit({"kernels": [{
        "name": "digest", "route": "cuda", "source": "ggrs_tpu_torch/csrc/digest.cu",
        "replaces": "ggrs_tpu/ops/pallas_checksum.py:66",
        "launches": launches, "launches_executor": exec_launches, "max_abs_err": worst,
        "ms": main_case["device_us"] / 1e3, "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_us"] / 1e3, "bound_by": "bytes", "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
