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
   2^26-word leaf; the EcsWorld live and folded resim digests, a strided
   EcsWorld ring slot and a float BoxGame state; the fulfilled speculation
   window, the pool's 64- and 512-row writes, states of 33 and 40 leaves (one
   raw launch per group of 32) and transposed, gapped and expanded leaves
   (each copied once first)).  Per shape: device us per launch from CUDA events
   around a CUDA graph of many launches (inputs rotated so the working set
   exceeds the L2 cache), host us per wrapper call, the plain version's
   time and the bytes bound.  The profiler checks that one CUDA
   ``checksum_device`` runs exactly one kernel.
3. flagship -- BoxGame(2) in a DeviceSyncTestSession at check_distance=8 on
   the card for 2048 ticks, 0 mismatches, bitwise equal to the same run on
   the CPU and to the NumPy oracle, exactly 2 digest launches per tick.
4. batched (the main path at real scale) -- ChipVM(2), B = 16,384 sessions,
   d = 8, 64 ticks: 0 mismatches; sessions 0-7 rerun on the CPU bitwise
   equal; exactly 2 digest launches per tick.  Kernel launch counts are
   zeroed just before this drive and read just after it.
5. executor (the request-list path) -- ``SessionBuilder`` -> host
   ``SyncTestSession`` (check_distance 7, max_prediction 8) ->
   ``DeviceRequestExecutor`` on the card, for BoxGame(2) over 2,000 frames
   and ChipVM(2) over 250.  Every ``executor.run`` runs under
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
7. p2p (the P2P rollback path) -- two ``P2PSession`` peers in one process,
   built by ``SessionBuilder.add_player(...).start_p2p_session``, each with
   its own ``DeviceRequestExecutor`` on the card, linked by a seeded
   ``InMemoryNetwork`` with 5 % loss, 5 % reordering and 3 ticks of latency,
   on a fake 16 ms clock, with desync detection at interval 1: BoxGame(2)
   for 750 frames and ChipVM(2) for 80.  Inputs change every few frames,
   so rollbacks come regularly.  0 ``DesyncDetected``; every checksum each
   peer sent and both final live states equal the same seeded run on the
   CPU (BoxGame also the NumPy oracle); every ``executor.run`` runs under
   the sync debug mode "error"; the digest's launches (counts zeroed just
   before the drive) equal the count the request lists predict: one per
   burst that saves plus one per lone Save.  Rollbacks, depth, kernels and
   digest launches per frame, host ms per frame split into
   ``poll_remote_clients``, ``advance_frame`` (with its checksum read) and
   ``run``.  A second, short BoxGame drive corrupts peer B's live state and
   must raise ``DesyncDetected`` with unequal checksums.

8. ecs (BASELINE config 4) -- ``EcsWorld(4, 32)`` (128 units, 3,104 B of
   int32 state) in a ``DeviceSyncTestSession`` at check_distance 16 on the
   card for 768 ticks: 0 mismatches, bitwise equal to the same run on the
   CPU and to the NumPy oracle, exactly 2 digest launches per tick.  Then
   B = 4,096 worlds in ``BatchedSessions`` at d = 16 for 64 ticks, started
   from a world in melee (units in contact): 0 mismatches, sessions 0-7
   rerun on the CPU bitwise equal, 2 digest launches per tick.  ms per tick,
   resim frames/s, kernels per advance and per tick, the digest's share of
   device time.
9. float -- ``BoxGame(2, "float")`` in a ``DeviceSyncTestSession`` at d = 8
   for 1,024 ticks: 0 mismatches on the card (its resimulations repeat
   bitwise), 2 digest launches per tick, and the max abs error per leaf
   against the same run on the CPU within ``FLOAT_ATOL`` (positions and
   angles measured on their torus).
10. journal -- two ``P2PSession`` peers play ``RtsCmd(2, 4, 4)`` (command
   streams in varrec envelopes) over phase 7's seeded network, each with an
   executor on the card reading the raw envelopes; peer A carries a
   ``JournalTap`` (``adopt_spectator_endpoint``) writing a ``MatchJournal``.
   0 ``DesyncDetected``, no device->host read in ``run``, digest launches
   as the request lists predict, the journal and final states equal to the
   CPU run and to ``RtsCmdGame``.  The closed journal is replayed by
   ``ReplaySession``: fast-forwarded on the card by ``build_scrub_program``
   in 64-frame windows, and its first 64 frames played through
   ``advance_frame`` and an executor; both equal the oracle at every window
   edge, and the end state equals peer A's live state at the frame the
   journal ends.  Journal bytes and host ms per frame, scrub ms per window,
   kernels per RtsCmd advance.
11. speculation (BASELINE config 3) -- four ``BoxGame(4)`` P2P peers over an
   in-memory network, max_prediction 8, desync detection at interval 1, for
   400 ticks (the last 20 with inputs held); peer 0's executor carries
   ``SpeculativeRollback(K=8, max_window=8)`` with ``bench.py``'s
   hypotheses (seven held-button guesses and the schedule itself).  The
   same drive without speculation, and the speculating drive on the CPU:
   all four peers' states and every checksum they sent are bitwise equal
   across the three, 0 ``DesyncDetected``, hits + misses equal peer 0's
   rollbacks, every window the branches cover hits, and no fused rollback
   tick runs a burst.  Every ``run`` under the sync debug mode "error".
   Kernels and device busy per peer-0 rollback tick and plain tick for both
   variants (40 rollback ticks mid-run and the last 15, plain, each ``run``
   alone under the profiler), host ms per tick, digest launches observed
   and predicted.
12. pool -- ``bench.py``'s massed hosting: 32 two-peer BoxGame matches (64
   sessions, ring 10, max_burst 9, desync detection at interval 8) for 180
   ticks through one ``BatchedRequestExecutor``, and through 64
   ``DeviceRequestExecutor``s, and the pool on the CPU: live states, the
   last tick's ring checksums and every sent checksum bitwise equal, 0
   ``DesyncDetected``, every fulfilment under the sync debug mode "error".
   Kernels, busy and idle share per tick (the fulfilment of the last 8
   ticks, each alone under the profiler) and host ms per tick for both;
   digest launches per tick, observed and predicted from the descriptors.  Then 256 matches (512 sessions) for 24 ticks, the first 32
   matches held against a CPU rerun of them.

Then the seconds each phase took, one ``{"kernels": [...]}`` line, the
card's name and power limit as nvidia-smi prints them, and, last,
``{"ok": true, "device": {...}}``.
Exits non-zero with no result when CUDA is not available.
"""

from __future__ import annotations

import json
import math
import os
import random
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ggrs_tpu_torch import (
    AdvanceFrame,
    BatchedRequestExecutor,
    BatchedSessions,
    BoxGame,
    ChipVM,
    DesyncDetected,
    DesyncDetection,
    DeviceRequestExecutor,
    DeviceSyncTestSession,
    EcsWorld,
    ExecutorPrograms,
    InMemoryNetwork,
    InputStatus,
    JournalTap,
    LoadGameState,
    Local,
    MatchJournal,
    Remote,
    ReplaySession,
    RtsCmd,
    RtsCmdGame,
    SaveGameState,
    SessionBuilder,
    SpeculativeRollback,
    _build,
    boxgame_config,
    build_scrub_program,
    to_numpy,
)
from ggrs_tpu_torch.obs import FlightRecorder
from ggrs_tpu_torch.ops.checksum import checksum_device, checksum_device_plain
from ggrs_tpu_torch.ops.digest import (
    MAX_LEAVES,
    lane_sums_rows,
    lane_sums_rows_plain,
    state_digest,
)
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
L2_BYTES = 50e6
D = 8
# the flagship is cut from 4,096 ticks to 2,048, and phase 7's drives from
# 1,500 BoxGame and 150 ChipVM frames to 750 and 80, to keep the whole run
# well under 7 minutes on a slow host now that phases 8-10 run too
FLAGSHIP_TICKS, FLAGSHIP_CHUNK = 2048, 512
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
# ChipVM's executor drive is cut from 500 frames to 250 to keep the whole
# run near 5 minutes on a slow host now that phase 7 runs too
EXEC_GAMES = [("BoxGame(2)", BoxGame(2), 2000, 16), ("ChipVM(2)", ChipVM(2), 250, 256)]
CKPT_TICKS = 32
CHIPVM_STATE_BYTES = 256 + 4 + 1
P2P_GAMES = [("BoxGame(2)", BoxGame(2), 750, 100), ("ChipVM(2)", ChipVM(2), 80, 20)]
P2P_NET = dict(seed=2026, loss=0.05, reorder=0.05, latency_ticks=3)
P2P_TICK_MS, P2P_DRAIN, P2P_MAX_PREDICTION = 16, 20, 8
P2P_CORRUPT_FRAMES, P2P_CORRUPT_FROM, P2P_CORRUPT_FOR = 90, 30, 10
ECS_PLAYERS, ECS_EPP, ECS_D = 4, 32, 16  # BASELINE config 4
ECS_WORDS = 776  # 128 x (2 pos + 2 vel + health + owner) + 4 x 2 rally, int32
ECS_CONVERGE = (10, 5, 6, 9)  # each player's input steering its rally to the center
ECS_TICKS, ECS_CHUNK, ECS_PROFILED = 768, 256, 8  # bench.py's tick count off the TPU
ECS_BATCH, ECS_BATCH_TICKS, ECS_BATCH_UNTIMED, ECS_BATCH_PROFILED = 4096, 64, 24, 4
ECS_MELEE_FRAMES = 200
FLOAT_D, FLOAT_TICKS, FLOAT_CHUNK = 8, 1024, 256
FLOAT_ATOL = 1e-3  # per leaf, card against CPU; cos/sin may differ in the last bit
RTS_FRAMES, RTS_DRAIN, RTS_SETTLE, RTS_WINDOW = 600, 20, 200, 64
SPEC_PLAYERS, SPEC_K, SPEC_W, SPEC_MAX_PREDICTION = 4, 8, 8, 8  # BASELINE config 3
SPEC_TICKS, SPEC_DRAIN = 400, 20
# peer 0's profiled ticks: rollback ticks mid-run, plain ticks in the drain
SPEC_PROFILED = tuple(range(100, 140)) + tuple(range(SPEC_TICKS - 15, SPEC_TICKS))
POOL_MATCHES, POOL_RING, POOL_MAX_BURST, POOL_DESYNC_INTERVAL = 32, 10, 9, 8
POOL_SESSIONS, POOL_TICKS, POOL_PROFILED = 2 * POOL_MATCHES, 180, 8
POOL_BIG_MATCHES, POOL_BIG_TICKS = 256, 24
POOL_BIG_SESSIONS = 2 * POOL_BIG_MATCHES


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


def boxgame_state(rng, lead: tuple, players: int = 2) -> dict:
    i32 = lambda shape: _card(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int32))
    p = players
    return {"pos": i32(lead + (p, 2)), "rot": i32(lead + (p,)), "vel": i32(lead + (p, 2))}


def many_leaves_state(rng, b: int, count: int) -> dict:
    """``count`` small leaves of mixed dtypes and odd byte counts."""
    kinds = [(np.uint8, (3,)), (np.int16, (5,)), (np.int32, ()), (np.int32, (2,)),
             (np.int64, (1,))]
    out = {}
    for i in range(count):
        dt, shape = kinds[i % len(kinds)]
        out[f"l{i:02d}"] = _card(rng.integers(0, 2**63, size=(b,) + shape, dtype=np.int64).astype(dt))
    return out


def copied_base(rng, shape: tuple) -> dict:
    """An int32 leaf and a contiguous u8 leaf; the view functions below make
    the first one a layout the kernel cannot read in place."""
    return {"t": _card(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int32)),
            "u": _card(rng.integers(0, 256, size=(shape[0], 3), dtype=np.uint8))}


def transposed(state):
    return {**state, "t": state["t"].transpose(1, 2)}


def gapped(state):
    return {**state, "t": state["t"][:, ::2]}


def expanded(state):
    return {**state, "t": state["t"].expand(-1, 4, -1)}


def ecs_state(rng, lead: tuple) -> dict:
    e, i32 = ECS_PLAYERS * ECS_EPP, lambda shape: _card(
        rng.integers(-(2**31), 2**31, size=shape, dtype=np.int32))
    return {"health": i32(lead + (e,)), "owner": i32(lead + (e,)), "pos": i32(lead + (e, 2)),
            "rally": i32(lead + (ECS_PLAYERS, 2)), "vel": i32(lead + (e, 2))}


def boxgame_float_state(rng, lead: tuple) -> dict:
    f32 = lambda shape, scale: _card((rng.standard_normal(shape) * scale).astype(np.float32))
    return {"pos": f32(lead + (2, 2), 300.0), "rot": f32(lead + (2,), 3.0), "vel": f32(lead + (2, 2), 6.0)}


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
        ("ecs_live", ecs_state(rng, (ECS_BATCH,)), same),
        ("ecs_resim_folded", ecs_state(rng, (ECS_BATCH, ECS_D)), flat_rows),
        ("ecs_ring_slot_view", ecs_state(rng, (ECS_BATCH, ECS_D + 1)), ring_slot),
        ("boxgame_float_b1", boxgame_float_state(rng, (1,)), same),
        ("boxgame_float_b1_resim_folded", boxgame_float_state(rng, (1, FLOAT_D)), flat_rows),
        # the fulfilled speculation window (phase 11) and the pool's B-row
        # writes (phase 12)
        ("boxgame4_spec_window", boxgame_state(rng, (SPEC_W, ), players=4), same),
        ("boxgame_pool_64", boxgame_state(rng, (POOL_SESSIONS,)), same),
        ("boxgame_pool_512", boxgame_state(rng, (POOL_BIG_SESSIONS,)), same),
        # more leaves than one launch takes: one raw launch per group
        ("leaves_33", many_leaves_state(rng, BATCH, 33), same),
        ("leaves_40", many_leaves_state(rng, BATCH, 40), same),
        # leaves the kernel cannot read in place: each copied once
        ("copied_transposed", copied_base(rng, (BATCH, 5, 3)), transposed),
        ("copied_gapped", copied_base(rng, (BATCH, 6, 2)), gapped),
        ("copied_expanded", copied_base(rng, (BATCH, 1, 6)), expanded),
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
        before = state_digest.launches
        got = checksum_device(rows_state)
        launches = state_digest.launches - before
        want = checksum_device_plain(rows_state)
        torch.cuda.synchronize()
        err = u32_err(got, want)
        check(got.shape == (rows, 4) and torch.equal(got, want),
              f"state_digest != plain on {name}")
        groups = -(-sum(1 for l in leaves if l[0].numel()) // MAX_LEAVES)
        check(launches == groups, f"state_digest on {name}: {launches} launches, not {groups}")
        n_copies = copies_for(bytes_per_row * rows)
        inputs = [rows_state] + [view(tree_map(torch.clone, state)) for _ in range(n_copies - 1)]
        big = bytes_per_row * rows >= 1 << 26
        rec = {"phase": "kernel", "entry": "state_digest", "case": name, "rows": rows,
               "leaves": len(leaves), "launches_per_digest": launches,
               "bytes_per_row": bytes_per_row,
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


def guarded_run(fulfil, reqs, card: bool) -> None:
    """``fulfil(reqs)``; on the card under the sync debug mode "error", so
    that a device->host read there fails the run."""
    if card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        fulfil(reqs)
    finally:
        if card:
            torch.cuda.set_sync_debug_mode(0)


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
        guarded_run(ex.run, reqs, card)
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


def p2p_input(handle: int, frame: int, frames: int) -> int:
    """The schedule of ``tests/test_desync_device_executor.py``: inputs that
    change every few frames, held for the last ``P2P_DRAIN`` frames so that
    every prediction is right at the end."""
    i = min(frame, frames - P2P_DRAIN - 1)
    return (i // 4) % 16 if handle == 0 else (i // 3) % 16


def predicted_digest_launches(requests) -> int:
    """Digest launches a request list makes on the card: one per burst (two
    or more Advances, each maybe followed by a Save) that saves, and one per
    Save outside a burst."""
    launches, i, n = 0, 0, len(requests)
    while i < n:
        if not isinstance(requests[i], AdvanceFrame):
            launches += isinstance(requests[i], SaveGameState)
            i += 1
            continue
        advances = saves = 0
        while i < n and isinstance(requests[i], AdvanceFrame):
            advances, i = advances + 1, i + 1
            if i < n and isinstance(requests[i], SaveGameState):
                saves, i = saves + 1, i + 1
        launches += (1 if saves else 0) if advances >= 2 else saves
    return launches


def drive_p2p(game, frames: int, device, profiled: int = 0, corrupt: bool = False) -> dict:
    """Two P2P peers, each with its own executor on ``device``, over a seeded
    in-memory network on a fake clock.  On the card every ``run`` is under
    the sync debug mode "error", digest counts are zeroed after the warmup,
    and the ``profiled`` frames just before the drain run under the
    profiler (host times are taken over the other frames).  With ``corrupt``, peer B's live
    state is nudged for ``P2P_CORRUPT_FOR`` frames from ``P2P_CORRUPT_FROM``
    on, past the depth of any rollback."""
    from torch.profiler import ProfilerActivity, profile

    net = InMemoryNetwork(**P2P_NET)
    now = [0]
    peers = []
    for me, other, h in (("A", "B", 0), ("B", "A", 1)):
        ex = DeviceRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                                   device=device)
        ex.warmup(np.zeros(2, np.uint8), burst_depths=range(2, P2P_MAX_PREDICTION + 2))
        sess = (SessionBuilder(boxgame_config()).with_clock(lambda: now[0])
                .with_rng(random.Random(41 + h))
                .with_max_prediction_window(P2P_MAX_PREDICTION)
                .with_desync_detection_mode(DesyncDetection.on(1))
                .add_player(Local(), h).add_player(Remote(other), 1 - h)
                .start_p2p_session(net.socket(me)))
        sess.attach_forensics(recorder=FlightRecorder(checksum_window=frames + 8))
        peers.append((h, sess, ex))
    card = peers[0][2].device.type == "cuda"
    host = {"poll": 0.0, "advance_frame": 0.0, "run": 0.0}
    desyncs, predicted = [], 0
    prof_end = frames - P2P_DRAIN - 1
    prof_start = prof_end - profiled
    prof = None
    state_digest.launches = lane_sums_rows.launches = 0
    for f in range(frames):
        if profiled and f in (prof_start, prof_end):
            if card:
                torch.cuda.synchronize()
            if f == prof_start:
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
            else:
                prof.__exit__(None, None, None)
        timed = not profiled or not prof_start <= f < prof_end
        for h, sess, ex in peers:
            t0 = time.perf_counter()
            sess.poll_remote_clients()
            t1 = time.perf_counter()
            sess.add_local_input(h, p2p_input(h, f, frames))
            reqs = sess.advance_frame()
            t2 = time.perf_counter()
            guarded_run(ex.run, reqs, card)
            t3 = time.perf_counter()
            if timed:
                host["poll"] += t1 - t0
                host["advance_frame"] += t2 - t1
                host["run"] += t3 - t2
            predicted += predicted_digest_launches(reqs)
            desyncs += [e for e in sess.events() if isinstance(e, DesyncDetected)]
            if corrupt and h == 1 and P2P_CORRUPT_FROM <= f < P2P_CORRUPT_FROM + P2P_CORRUPT_FOR:
                ex._state = {**ex.state, "pos": ex.state["pos"] + 1}
        net.tick()
        now[0] += P2P_TICK_MS
    if card:
        torch.cuda.synchronize()
    kernels = busy_us = None
    if prof is not None:
        device_ops = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and (getattr(e, "self_device_time_total", 0) or 0) > 0]
        kernels = sum(e.count for e in device_ops) / (2 * profiled)
        busy_us = sum(e.self_device_time_total for e in device_ops) / (2 * profiled)
    sessions = [s for _, s, _ in peers]
    return {
        "launches": state_digest.launches, "around": lane_sums_rows.launches,
        "predicted": predicted, "desyncs": desyncs,
        "sent": [dict(s.recorder.checksums.items()) for s in sessions],
        "states": [to_numpy(ex.state) for _, _, ex in peers],
        "frames_reached": [s.current_frame for s in sessions],
        "rollbacks": sum(s._stat_rollbacks for s in sessions),
        "rollback_frames": sum(s._stat_rollback_frames for s in sessions),
        "max_rollback": max(s._stat_max_rollback for s in sessions),
        "host_ms": {k: v / (2 * (frames - profiled)) * 1e3 for k, v in host.items()},
        "kernels_per_frame": kernels, "busy_us_per_frame": busy_us,
    }


def phase_p2p() -> int:
    """The P2P path on the card against the CPU; returns the digest launches
    of the card's drives."""
    total = 0
    for name, game, frames, profiled in P2P_GAMES:
        run = drive_p2p(game, frames, None, profiled)
        check(run["around"] == 0, f"p2p {name}: the digest went around state_digest")
        check(run["desyncs"] == [], f"p2p {name}: {len(run['desyncs'])} DesyncDetected")
        check(run["launches"] == run["predicted"],
              f"p2p {name}: {run['launches']} digest launches, the request lists predict "
              f"{run['predicted']}")
        a, b = run["frames_reached"]
        check(a == b, f"p2p {name}: the peers stopped at frames {a} and {b}")
        check(trees_equal(*run["states"]), f"p2p {name}: the two peers' live states differ")
        check(all(len(s) > frames // 2 for s in run["sent"]),
              f"p2p {name}: too few checksum reports sent")
        cpu = drive_p2p(game, frames, "cpu")
        check(run["sent"] == cpu["sent"], f"p2p {name}: sent checksums != CPU run")
        check(all(trees_equal(g, c) for g, c in zip(run["states"], cpu["states"])),
              f"p2p {name}: live states != CPU run")
        oracle = None
        if isinstance(game, BoxGame):
            ref = game.init_state_np()
            for f in range(a):
                ref = game.advance_np(ref, np.asarray(
                    [p2p_input(0, f, frames), p2p_input(1, f, frames)], np.uint8))
            oracle = trees_equal(run["states"][0], ref)
            check(oracle, f"p2p {name}: live state != NumPy oracle")
        peer_frames = 2 * frames
        emit({"phase": "p2p", "game": name, "frames": frames, "peers": 2,
              "network": P2P_NET, "tick_ms": P2P_TICK_MS, "desync_interval": 1,
              "max_prediction": P2P_MAX_PREDICTION, "desyncs": 0,
              "sent_checksums_equal_to_cpu": True, "states_equal_to_cpu": True,
              "equal_to_oracle": oracle, "sync_debug_mode": "error",
              "frames_reached": a,
              "rollbacks_per_100_frames": run["rollbacks"] / peer_frames * 100,
              "mean_rollback_depth": run["rollback_frames"] / max(run["rollbacks"], 1),
              "max_rollback_depth": run["max_rollback"],
              "profiled_frames": profiled,
              "kernels_per_frame": run["kernels_per_frame"],
              "device_busy_ms_per_frame": run["busy_us_per_frame"] / 1e3,
              "digest_launches": run["launches"],
              "digest_launches_predicted": run["predicted"],
              "digest_launches_per_frame": run["launches"] / peer_frames,
              "host_ms_per_frame": sum(run["host_ms"].values()),
              "host_ms_poll_remote_clients": run["host_ms"]["poll"],
              "host_ms_advance_frame": run["host_ms"]["advance_frame"],
              "host_ms_run": run["host_ms"]["run"],
              "checksum_reports_sent": [len(s) for s in run["sent"]]})
        total += run["launches"]
    bad = drive_p2p(BoxGame(2), P2P_CORRUPT_FRAMES, None, corrupt=True)
    check(bad["desyncs"], "p2p: the corrupted peer was not detected")
    check(all(e.local_checksum != e.remote_checksum for e in bad["desyncs"]),
          "p2p: a DesyncDetected with equal checksums")
    emit({"phase": "p2p", "corrupted_drive": True, "frames": P2P_CORRUPT_FRAMES,
          "corrupted_from": P2P_CORRUPT_FROM, "desyncs_detected": len(bad["desyncs"]),
          "first_detected_frame": min(e.frame for e in bad["desyncs"])})
    return total


def profile_device(fn, calls: int) -> dict:
    """Device kernels and busy us per call of ``fn`` over ``calls`` calls,
    and the digest kernel's share of that time, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and (getattr(e, "self_device_time_total", 0) or 0) > 0]
    # record_function ranges ("ggrs:...") also appear as device-side
    # annotations spanning their kernels; only kernels count as busy time
    ops = [e for e in ops if not e.key.startswith("ggrs:")]
    busy = sum(e.self_device_time_total for e in ops)
    digest = sum(e.self_device_time_total for e in ops if "state_digest" in e.key)
    return {"kernels": sum(e.count for e in ops) / calls, "busy_us": busy / calls,
            "digest_us": digest / calls, "digest_share": digest / busy if busy else None}


def kernels_per_advance(advance, state: dict, inputs: torch.Tensor) -> dict:
    """Device kernels and busy us of one ``advance`` on the card."""
    advance(state, inputs)
    return profile_device(lambda: advance(state, inputs), 3)


def ecs_inputs(n: int, seed: int, converge: int) -> np.ndarray:
    """Random bitmasks; the first ``converge`` frames steer every rally to
    the center of the world, so that units meet, fight and respawn."""
    ins = np.random.default_rng(seed).integers(0, 16, size=(n, ECS_PLAYERS)).astype(np.uint8)
    ins[:converge] = ECS_CONVERGE
    return ins


def ecs_melee(world: EcsWorld) -> dict:
    """A world ``ECS_MELEE_FRAMES`` converging frames in: units in contact."""
    s = world.init_state_np()
    for inp in ecs_inputs(ECS_MELEE_FRAMES, 6, ECS_MELEE_FRAMES):
        s = world.advance_np(s, inp)
    return s


def phase_ecs() -> int:
    """BASELINE config 4 on the card: one session, then a B = 4,096 batch;
    returns the digest launches of both card drives."""
    world = EcsWorld(ECS_PLAYERS, ECS_EPP)
    blank = np.zeros(ECS_PLAYERS, np.uint8)
    # -- one session, from the initial world ----------------------------------
    inputs = ecs_inputs(ECS_TICKS, 4, converge=128)
    chunks = [inputs[:ECS_CHUNK], inputs[ECS_CHUNK:ECS_TICKS - ECS_PROFILED],
              inputs[ECS_TICKS - ECS_PROFILED:]]
    card_chunks = [torch.from_numpy(c).cuda() for c in chunks]
    sess = DeviceSyncTestSession(world.advance, world.init_state_np(), blank,
                                 check_distance=ECS_D, max_prediction=ECS_D)
    state_digest.launches = lane_sums_rows.launches = 0
    sess.run_ticks(card_chunks[0], check=False)
    sess.block_until_ready()
    t0 = time.perf_counter()
    sess.run_ticks(card_chunks[1], check=False)
    sess.block_until_ready()
    elapsed = time.perf_counter() - t0
    prof = profile_device(lambda: sess.run_ticks(card_chunks[2], check=False), 1)
    single_launches = state_digest.launches
    check(lane_sums_rows.launches == 0, "ecs: the digest went around state_digest")
    sess.verify()
    check(single_launches == 2 * ECS_TICKS,
          f"ecs: {single_launches} digest launches, not 2 x {ECS_TICKS} ticks")
    cpu = DeviceSyncTestSession(world.advance, world.init_state_np(), blank,
                                check_distance=ECS_D, max_prediction=ECS_D, device="cpu")
    for c in chunks:
        cpu.run_ticks(c, check=False)
    cpu.verify()
    check(trees_equal(to_numpy(sess.carry), to_numpy(cpu.carry)), "ecs: card carry != CPU carry")
    ref = world.init_state_np()
    for i in range(ECS_TICKS):
        ref = world.advance_np(ref, inputs[i])
    check(trees_equal(sess.live_state(), ref), "ecs: live state != NumPy oracle")
    one = {k: v.unsqueeze(0) for k, v in world.init_state().items()}
    adv1 = kernels_per_advance(world.advance, one, torch.from_numpy(inputs[:1]).cuda())
    timed = len(chunks[1])
    emit({"phase": "ecs", "game": "EcsWorld(4, 32)", "sessions": 1, "check_distance": ECS_D,
          "ticks": ECS_TICKS, "mismatches": 0, "equal_to_cpu": True, "equal_to_oracle": True,
          "units_hurt_at_end": int((ref["health"] < 100).sum()),
          "timed_ticks": timed, "ms_per_tick": elapsed / timed * 1e3,
          "resim_frames_per_s": timed * ECS_D / elapsed,
          "digest_launches": single_launches,
          "digest_launches_per_tick": single_launches / ECS_TICKS,
          "kernels_per_advance": adv1["kernels"], "advance_busy_us": adv1["busy_us"],
          "profiled_ticks": ECS_PROFILED, "kernels_per_tick": prof["kernels"] / ECS_PROFILED,
          "device_busy_ms_per_tick": prof["busy_us"] / ECS_PROFILED / 1e3,
          "idle_share": 1 - prof["busy_us"] / ECS_PROFILED / (elapsed / timed * 1e6),
          "digest_share_of_busy": prof["digest_share"]})

    # -- B = 4,096 worlds, from a world in melee -----------------------------
    melee = ecs_melee(world)
    batch_in = np.random.default_rng(12).integers(
        0, 16, size=(ECS_BATCH, ECS_BATCH_TICKS, ECS_PLAYERS)).astype(np.uint8)
    dev_in = torch.from_numpy(batch_in).cuda()
    u, p = ECS_BATCH_UNTIMED, ECS_BATCH_TICKS - ECS_BATCH_PROFILED
    batch = BatchedSessions(world.advance, melee, blank, batch_size=ECS_BATCH,
                            check_distance=ECS_D, max_prediction=ECS_D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_digest.launches = lane_sums_rows.launches = 0
    batch.run_ticks(dev_in[:, :u], check=False)
    batch.block_until_ready()
    t0 = time.perf_counter()
    batch.run_ticks(dev_in[:, u:p], check=False)
    batch.block_until_ready()
    elapsed = time.perf_counter() - t0
    prof = profile_device(lambda: batch.run_ticks(dev_in[:, p:], check=False), 1)
    batch_launches = state_digest.launches
    check(lane_sums_rows.launches == 0, "ecs batch: the digest went around state_digest")
    stats = batch.verify()
    check(stats["mismatches"] == 0, f"ecs batch: {stats['mismatches']} mismatches")
    check(batch_launches == 2 * ECS_BATCH_TICKS,
          f"ecs batch: {batch_launches} digest launches, not 2 x {ECS_BATCH_TICKS} ticks")
    n_cpu = 8
    cpu = BatchedSessions(world.advance, melee, blank, batch_size=n_cpu,
                          check_distance=ECS_D, max_prediction=ECS_D, device="cpu")
    check(cpu.run_ticks(batch_in[:n_cpu])["mismatches"] == 0, "ecs batch: CPU rerun mismatched")
    head = to_numpy(tree_map(lambda t: t[:n_cpu], batch.carry))
    check(trees_equal(head, to_numpy(cpu.carry)), "ecs batch: sessions 0-7 != CPU rerun")
    live = batch.live_states()
    check(all(l.shape[0] == ECS_BATCH for l in tree_leaves(live)), "ecs batch: live states malformed")
    carry_bytes = sum(l.numel() * l.element_size() for l in tree_leaves(batch.carry))
    many = tree_map(lambda t: t[:, 0].contiguous(), batch.carry["ring"]["states"])
    adv_b = kernels_per_advance(world.advance, many, dev_in[:, 0])
    timed = p - u
    emit({"phase": "ecs", "game": "EcsWorld(4, 32)", "sessions": ECS_BATCH,
          "start": f"melee after {ECS_MELEE_FRAMES} converging frames",
          "check_distance": ECS_D, "ring": ECS_D + 1, "ticks": ECS_BATCH_TICKS, "mismatches": 0,
          "sessions_equal_to_cpu": n_cpu, "state_bytes": ECS_WORDS * 4,
          "carry_bytes": carry_bytes, "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "units_hurt_at_end": int((live["health"] < 100).sum()),
          "timed_ticks": timed, "ms_per_tick": elapsed / timed * 1e3,
          "resim_frames_per_s": ECS_BATCH * timed * ECS_D / elapsed,
          "digest_launches": batch_launches,
          "digest_launches_per_tick": batch_launches / ECS_BATCH_TICKS,
          "kernels_per_advance": adv_b["kernels"], "advance_busy_us": adv_b["busy_us"],
          "profiled_ticks": ECS_BATCH_PROFILED,
          "kernels_per_tick": prof["kernels"] / ECS_BATCH_PROFILED,
          "device_busy_ms_per_tick": prof["busy_us"] / ECS_BATCH_PROFILED / 1e3,
          "idle_share": 1 - prof["busy_us"] / ECS_BATCH_PROFILED / (elapsed / timed * 1e6),
          "digest_share_of_busy": prof["digest_share"]})
    del batch, dev_in, many
    torch.cuda.empty_cache()
    return single_launches + batch_launches


def torus_err(a: np.ndarray, b: np.ndarray, period) -> float:
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    if period is not None:
        d = np.minimum(d, np.asarray(period, np.float64) - d)
    return float(d.max())


def phase_float() -> int:
    """The float BoxGame in a SyncTest on the card; returns its launches."""
    game = BoxGame(2, "float")
    inputs = np.random.default_rng(19).integers(0, 16, size=(FLOAT_TICKS, 2)).astype(np.uint8)
    chunks = torch.from_numpy(inputs).cuda().split(FLOAT_CHUNK)
    sess = DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                 check_distance=FLOAT_D)
    state_digest.launches = lane_sums_rows.launches = 0
    sess.run_ticks(chunks[0], check=False)
    sess.block_until_ready()
    t0 = time.perf_counter()
    for c in chunks[1:]:
        sess.run_ticks(c, check=False)
    sess.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = state_digest.launches
    check(lane_sums_rows.launches == 0, "float: the digest went around state_digest")
    sess.verify()  # its resimulations repeated every first-seen digest
    check(launches == 2 * FLOAT_TICKS, f"float: {launches} digest launches, not 2 x {FLOAT_TICKS}")
    cpu = DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                check_distance=FLOAT_D, device="cpu")
    for c in np.split(inputs, FLOAT_TICKS // FLOAT_CHUNK):
        cpu.run_ticks(c, check=False)
    cpu.verify()
    card, host = sess.live_state(), cpu.live_state()
    periods = {"pos": (800.0, 600.0), "rot": 2 * math.pi, "vel": None}
    err = {k: torus_err(card[k], host[k], periods[k]) for k in sorted(card)}
    check(all(np.isfinite(card[k]).all() and card[k].dtype == np.float32 for k in card),
          "float: live state malformed")
    check(all(e <= FLOAT_ATOL for e in err.values()), f"float: card vs CPU error {err}")
    timed = FLOAT_TICKS - FLOAT_CHUNK
    emit({"phase": "float", "game": "BoxGame(2, float)", "check_distance": FLOAT_D,
          "ticks": FLOAT_TICKS, "mismatches": 0, "atol": FLOAT_ATOL,
          "max_abs_err_vs_cpu": err, "bitwise_equal_to_cpu": all(e == 0 for e in err.values()),
          "timed_ticks": timed, "ms_per_tick": elapsed / timed * 1e3,
          "resim_frames_per_s": timed * FLOAT_D / elapsed,
          "digest_launches": launches, "digest_launches_per_tick": launches / FLOAT_TICKS})
    return launches


def rts_orders(handle: int, frame: int) -> tuple:
    """``bench.py``'s RtsCmd schedule: 0-3 orders a frame, seeded per
    (player, frame); held from frame ``RTS_FRAMES - 1`` on."""
    rng = random.Random(17 + handle * 613 + min(frame, RTS_FRAMES - 1))
    cmds = []
    for _ in range(rng.randrange(0, 4)):
        kind = rng.randrange(3)
        if kind == 0:
            cmds.append(("move", rng.randrange(4), rng.randrange(-2, 3), rng.randrange(-2, 3)))
        elif kind == 1:
            cmds.append(("gather", rng.randrange(4)))
        else:
            cmds.append(("build", rng.randrange(16), rng.randrange(16)))
    return tuple(cmds)


def drive_journal(rts: RtsCmd, device, path: str) -> dict:
    """Two RtsCmd peers with executors on ``device``; peer A records the
    match through a ``JournalTap``.  After the drain both stop advancing and
    poll until A holds B's every input; A's last ``advance_frame`` then
    sends the journal every frame up to the one A stood at.  On the card
    every ``run`` is under the sync debug mode "error"."""
    to_env = lambda pairs: rts.envelopes_np([v for v, _ in pairs])
    net = InMemoryNetwork(**P2P_NET)
    now = [0]
    journal = MatchJournal(path, 2, rts.config().native_input_size)
    peers = []
    for me, other, h in (("A", "B", 0), ("B", "A", 1)):
        ex = DeviceRequestExecutor(rts.advance, rts.init_state_np(), to_env, device=device)
        ex.warmup(rts.envelopes_np([(), ()]), burst_depths=range(2, P2P_MAX_PREDICTION + 2))
        sess = (SessionBuilder(rts.config()).with_clock(lambda: now[0])
                .with_rng(random.Random(41 + h))
                .with_max_prediction_window(P2P_MAX_PREDICTION)
                .with_desync_detection_mode(DesyncDetection.on(1))
                .add_player(Local(), h).add_player(Remote(other), 1 - h)
                .start_p2p_session(net.socket(me)))
        peers.append((h, sess, ex))
    peers[0][1].adopt_spectator_endpoint(JournalTap.ADDR, JournalTap(journal, rts.config()))
    card = peers[0][2].device.type == "cuda"
    desyncs, predicted, host_s, steps = [], 0, 0.0, 0

    def step(h, sess, ex):
        nonlocal predicted, host_s, steps
        t0 = time.perf_counter()
        sess.poll_remote_clients()
        sess.add_local_input(h, rts_orders(h, sess.current_frame))
        reqs = sess.advance_frame()
        guarded_run(ex.run, reqs, card)
        host_s += time.perf_counter() - t0
        steps += 1
        predicted += predicted_digest_launches(reqs)
        desyncs.extend(e for e in sess.events() if isinstance(e, DesyncDetected))

    state_digest.launches = lane_sums_rows.launches = 0
    for _ in range(RTS_FRAMES + RTS_DRAIN):
        for h, sess, ex in peers:
            step(h, sess, ex)
        net.tick()
        now[0] += P2P_TICK_MS
    a = peers[0][1]
    settle = 0
    while a.confirmed_frame() < a.current_frame - 1 and settle < RTS_SETTLE:
        net.tick()
        now[0] += P2P_TICK_MS
        for _, sess, _ in peers:
            sess.poll_remote_clients()
        settle += 1
    end = a.current_frame
    live_at_end = to_numpy(peers[0][2].state)
    step(*peers[0])
    journal.close()
    return {"launches": state_digest.launches, "around": lane_sums_rows.launches,
            "predicted": predicted, "desyncs": desyncs, "end": end, "settle_ticks": settle,
            "journal_next_frame": journal.next_frame, "live_at_end": live_at_end,
            "states": [to_numpy(ex.state) for _, _, ex in peers],
            "frames_reached": [s.current_frame for _, s, _ in peers],
            "sent": [dict(s._local_checksum_history) for _, s, _ in peers],
            "rollbacks": sum(s._stat_rollbacks for _, s, _ in peers),
            "host_ms_per_peer_frame": host_s / steps * 1e3}


def phase_journal() -> int:
    """RtsCmd over P2P on the card, recorded and replayed; returns the
    digest launches of the card's match."""
    rts = RtsCmd(2, num_units=4, max_cmds=4)
    with tempfile.TemporaryDirectory() as tmp:
        card_path, cpu_path = os.path.join(tmp, "card.ggjl"), os.path.join(tmp, "cpu.ggjl")
        run = drive_journal(rts, None, card_path)
        launches = run["launches"]
        check(run["around"] == 0, "journal: the digest went around state_digest")
        check(run["desyncs"] == [], f"journal: {len(run['desyncs'])} DesyncDetected")
        check(launches == run["predicted"],
              f"journal: {launches} digest launches, the request lists predict {run['predicted']}")
        check(run["journal_next_frame"] == run["end"],
              f"journal: the journal ends at frame {run['journal_next_frame']}, "
              f"peer A stood at {run['end']}: the drain left frames unconfirmed")
        check(run["end"] >= RTS_FRAMES, f"journal: the match reached frame {run['end']} only")
        cpu = drive_journal(rts, "cpu", cpu_path)
        with open(card_path, "rb") as f:
            journal_bytes = f.read()
        with open(cpu_path, "rb") as f:
            check(f.read() == journal_bytes, "journal: the journal's bytes != the CPU run's")
        check(run["sent"] == cpu["sent"], "journal: the checksums peers compared != CPU run")
        check(all(trees_equal(g, c) for g, c in zip(run["states"], cpu["states"])),
              "journal: final states != CPU run")
        check(run["frames_reached"][0] == run["frames_reached"][1] + 1,
              f"journal: the peers stopped at frames {run['frames_reached']}")
        oracle = RtsCmdGame(rts)
        at_end = None
        for f in range(run["frames_reached"][0]):
            if f == run["end"]:
                at_end = oracle.snapshot()[1]
            oracle.handle_requests([AdvanceFrame(inputs=[
                (rts_orders(h, f), InputStatus.CONFIRMED) for h in (0, 1)])])
        check(trees_equal(run["states"][0], oracle.state), "journal: peer A != RtsCmdGame")
        check(trees_equal(run["live_at_end"], at_end),
              "journal: peer A's live state at the journal's end != RtsCmdGame")
        b_oracle = RtsCmdGame(rts)
        for f in range(run["frames_reached"][1]):
            b_oracle.handle_requests([AdvanceFrame(inputs=[
                (rts_orders(h, f), InputStatus.CONFIRMED) for h in (0, 1)])])
        check(trees_equal(run["states"][1], b_oracle.state), "journal: peer B != RtsCmdGame")

        # -- replay: scrub windows on the card, then per-frame playback ---------
        rs = ReplaySession(card_path, rts.config())
        check(rs.closed and not rs.truncated and not rs.gaps and rs.first_frame == 0,
              "journal: the closed journal does not read back whole")
        check(rs.last_frame + 1 == run["end"], "journal: ReplaySession's last frame")
        scrub = build_scrub_program(rts.advance)
        state, ref = rts.init_state_np(), rts.init_state_np()
        windows, scrub_s = 0, 0.0
        scrub(state, np.stack([rts.envelopes_np([(), ()])] * RTS_WINDOW))  # first call
        while rs.frames_remaining():
            inputs, statuses = rs.stacked_inputs(min(RTS_WINDOW, rs.frames_remaining()))
            check(all(s is InputStatus.CONFIRMED for row in statuses for s in row),
                  "journal: a replayed input is not confirmed")
            envs = np.stack([rts.envelopes_np(row) for row in inputs])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = scrub(state, envs)
            torch.cuda.synchronize()
            if len(inputs) == RTS_WINDOW:
                scrub_s += time.perf_counter() - t0
                windows += 1
            for row in inputs:
                ref = rts.advance_np(ref, row)
            check(trees_equal(to_numpy(state), ref),
                  f"journal: the scrub != the oracle at frame {rs.current_frame}")
        check(trees_equal(to_numpy(state), run["live_at_end"]),
              "journal: the scrubbed end state != peer A's live state")
        rs.seek(0)
        ex = DeviceRequestExecutor(rts.advance, rts.init_state_np(),
                                   lambda pairs: rts.envelopes_np([v for v, _ in pairs]))
        ref = rts.init_state_np()
        for _ in range(RTS_WINDOW):
            (req,) = rs.advance_frame()
            ex.run([req])
            ref = rts.advance_np(ref, [v for v, _ in req.inputs])
        check(trees_equal(to_numpy(ex.state), ref),
              f"journal: per-frame playback != the oracle at frame {RTS_WINDOW}")
        one = {k: v.unsqueeze(0) for k, v in rts.init_state().items()}
        envs = torch.from_numpy(rts.envelopes_np([rts_orders(0, 3), rts_orders(1, 5)])[None]).cuda()
        adv = kernels_per_advance(rts.advance, one, envs)
        emit({"phase": "journal", "game": "RtsCmd(2, 4, 4)", "peers": 2, "network": P2P_NET,
              "tick_ms": P2P_TICK_MS, "desync_interval": 1, "max_prediction": P2P_MAX_PREDICTION,
              "frames": RTS_FRAMES, "drain": RTS_DRAIN, "settle_ticks": run["settle_ticks"],
              "desyncs": 0, "sync_debug_mode": "error", "frames_reached": run["frames_reached"],
              "journal_frames": rs.last_frame + 1, "journal_bytes": len(journal_bytes),
              "journal_bytes_per_frame": len(journal_bytes) / (rs.last_frame + 1),
              "journal_equal_to_cpu": True, "states_equal_to_cpu": True,
              "equal_to_oracle": True, "replay_equal_to_live": True,
              "rollbacks_per_100_peer_frames": run["rollbacks"] / (2 * run["end"]) * 100,
              "digest_launches": launches, "digest_launches_predicted": run["predicted"],
              "host_ms_per_peer_frame": run["host_ms_per_peer_frame"],
              "scrub_windows_timed": windows, "scrub_ms_per_window": scrub_s / windows * 1e3,
              "scrub_frames_per_s": windows * RTS_WINDOW / scrub_s,
              "kernels_per_advance": adv["kernels"], "advance_busy_us": adv["busy_us"]})
    return launches


def spec_sched(player: int, i: int) -> int:
    """``bench.py``'s config-3 schedule (every player's input changes every
    3 frames, staggered), held for the last ``SPEC_DRAIN`` ticks."""
    return ((min(i, SPEC_TICKS - SPEC_DRAIN - 1) + player) // 3) % 16


def spec_branches():
    """``bench.py``'s hypotheses for peer 0 (``branch_inputs_all``):
    branches 0-6 hold every remote at k, branch 7 is the schedule itself."""
    base = np.zeros((SPEC_K, SPEC_PLAYERS), np.uint8)
    base[:7, 1:] = np.arange(7, dtype=np.uint8)[:, None]

    def branch_inputs_all(frame, arr):
        out = base.copy()
        out[:, 0] = arr[0]
        out[7, 1:] = [spec_sched(p, frame) for p in range(1, SPEC_PLAYERS)]
        return out

    return (lambda k, frame, arr: branch_inputs_all(frame, arr)[k]), branch_inputs_all


def drive_spec(speculate: bool, device, profile: bool = False) -> dict:
    """BASELINE config 3: four ``BoxGame(4)`` P2P peers over an in-memory
    network, max_prediction 8, desync detection at interval 1, each with an
    executor on ``device``; with ``speculate`` peer 0 carries
    ``SpeculativeRollback(K=8, max_window=8)``.  Every ``run`` on the card
    is under the sync debug mode "error".  With ``profile``, peer 0's runs
    of the ``SPEC_PROFILED`` ticks run alone under the profiler and are left
    out of the host times."""
    game = BoxGame(SPEC_PLAYERS)
    net = InMemoryNetwork()
    names = [f"P{p}" for p in range(SPEC_PLAYERS)]
    branch_inputs, branch_inputs_all = spec_branches()
    peers = []
    for me in range(SPEC_PLAYERS):
        spec = None
        if speculate and me == 0:
            spec = SpeculativeRollback(game.advance, SPEC_K, branch_inputs, max_window=SPEC_W,
                                       branch_inputs_all=branch_inputs_all, device=device)
        ex = DeviceRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                                   speculation=spec, device=device)
        ex.warmup(np.zeros(SPEC_PLAYERS, np.uint8),
                  burst_depths=range(2, SPEC_MAX_PREDICTION + 2))
        b = (SessionBuilder(boxgame_config()).with_num_players(SPEC_PLAYERS)
             .with_max_prediction_window(SPEC_MAX_PREDICTION).with_clock(lambda: 0)
             .with_rng(random.Random(91 + me)).with_desync_detection_mode(DesyncDetection.on(1)))
        for p in range(SPEC_PLAYERS):
            b = b.add_player(Local() if p == me else Remote(names[p]), p)
        sess = b.start_p2p_session(net.socket(names[me]))
        sess.attach_forensics(recorder=FlightRecorder(checksum_window=SPEC_TICKS + 8))
        peers.append((me, sess, ex))
    ex0 = peers[0][2]
    card = ex0.device.type == "cuda"
    calls = {"burst": 0, "fused": 0}
    for obj, name, key in ((ex0, "_do_burst", "burst"), (ex0._spec, "fulfill_and_refill", "fused")):
        if obj is not None:
            orig = getattr(obj, name)
            setattr(obj, name, lambda *a, _o=orig, _k=key, **kw: (
                calls.__setitem__(_k, calls[_k] + 1), _o(*a, **kw))[1])
    loads = predicted = desyncs = fused_with_burst = 0
    host = {"tick": 0.0, "ticks": 0, "rollback": [0.0, 0], "plain": [0.0, 0]}
    prof = {"rollback": [], "plain": []}
    state_digest.launches = lane_sums_rows.launches = 0
    for i in range(SPEC_TICKS):
        in_prof = profile and card and i in SPEC_PROFILED
        t_tick = time.perf_counter()
        for _, sess, _ in peers:
            sess.poll_remote_clients()
        for p, sess, ex in peers:
            sess.add_local_input(p, spec_sched(p, i))
            t0 = time.perf_counter()
            reqs = sess.advance_frame()
            predicted += predicted_digest_launches(reqs)
            if p == 0:
                kind = "rollback" if any(isinstance(r, LoadGameState) for r in reqs) else "plain"
                loads += kind == "rollback"
                before = dict(calls)
                if in_prof:
                    prof[kind].append(profile_device(lambda: guarded_run(ex.run, reqs, card), 1))
                else:
                    guarded_run(ex.run, reqs, card)
                    host[kind][0] += time.perf_counter() - t0
                    host[kind][1] += 1
                fused_with_burst += calls["fused"] > before["fused"] and calls["burst"] > before["burst"]
            else:
                guarded_run(ex.run, reqs, card)
            desyncs += sum(1 for e in sess.events() if isinstance(e, DesyncDetected))
        if not in_prof:
            host["tick"] += time.perf_counter() - t_tick
            host["ticks"] += 1
    if card:
        torch.cuda.synchronize()
    per_class = {}
    for kind, rows in prof.items():
        per_class[kind] = {
            "ticks_profiled": len(rows),
            "kernels": sum(r["kernels"] for r in rows) / len(rows) if rows else None,
            "device_busy_us": sum(r["busy_us"] for r in rows) / len(rows) if rows else None,
            "host_ms_advance_frame_and_run": host[kind][0] / max(host[kind][1], 1) * 1e3,
        }
    return {
        "launches": state_digest.launches, "around": lane_sums_rows.launches,
        "predicted": predicted, "desyncs": desyncs, "loads": loads,
        "hits": ex0.spec_hits, "misses": ex0.spec_misses,
        "fused": calls["fused"], "bursts": calls["burst"], "fused_with_burst": fused_with_burst,
        "states": [to_numpy(ex.state) for _, _, ex in peers],
        "sent": [dict(s.recorder.checksums.items()) for _, s, _ in peers],
        "frames_reached": [s.current_frame for _, s, _ in peers],
        "host_ms_per_tick": host["tick"] / host["ticks"] * 1e3, "per_class": per_class,
    }


def phase_speculation() -> int:
    """BASELINE config 3 on the card, speculation on and off, against a CPU
    rerun; returns the digest launches of the card's drives."""
    on = drive_spec(True, None, profile=True)
    off = drive_spec(False, None, profile=True)
    for name, run in (("on", on), ("off", off)):
        check(run["around"] == 0, f"speculation {name}: the digest went around state_digest")
        check(run["desyncs"] == 0, f"speculation {name}: {run['desyncs']} DesyncDetected")
        check(run["launches"] == run["predicted"],
              f"speculation {name}: {run['launches']} digest launches, the request lists "
              f"predict {run['predicted']}")
        check(len(set(run["frames_reached"])) == 1 and all(
            trees_equal(run["states"][0], st) for st in run["states"][1:]),
              f"speculation {name}: the four peers differ after the drain")
    check(all(trees_equal(a, b) for a, b in zip(on["states"], off["states"])),
          "speculation: states with speculation != without")
    check(on["sent"] == off["sent"], "speculation: sent checksums with speculation != without")
    check(on["hits"] + on["misses"] == on["loads"],
          f"speculation: {on['hits']} hits + {on['misses']} misses != {on['loads']} rollbacks")
    check(on["fused_with_burst"] == 0, "speculation: a fused rollback tick also ran a burst")
    # branch 7 is the schedule itself, so every window the branches cover hits
    check(on["hits"] == on["fused"] > 0,
          f"speculation: {on['hits']} hits of {on['fused']} fused windows")
    check(on["bursts"] <= on["misses"], "speculation: bursts on ticks that hit")
    cpu = drive_spec(True, "cpu")
    check(all(trees_equal(a, b) for a, b in zip(on["states"], cpu["states"])),
          "speculation: card states != CPU rerun")
    check(on["sent"] == cpu["sent"], "speculation: sent checksums != CPU rerun")
    check((cpu["hits"], cpu["misses"]) == (on["hits"], on["misses"]),
          "speculation: hits and misses != CPU rerun")
    emit({"phase": "speculation", "config": "BASELINE config 3", "game": "BoxGame(4)",
          "peers": SPEC_PLAYERS, "branches": SPEC_K, "max_window": SPEC_W,
          "max_prediction": SPEC_MAX_PREDICTION, "ticks": SPEC_TICKS, "drain": SPEC_DRAIN,
          "desync_interval": 1, "desyncs": 0, "sync_debug_mode": "error",
          "states_equal_on_off_cpu": True, "sent_checksums_equal_on_off_cpu": True,
          "rollbacks_peer0": on["loads"], "hits": on["hits"], "misses": on["misses"],
          "fused_windows": on["fused"], "fallback_bursts": on["bursts"],
          "frames_reached": on["frames_reached"][0],
          "peer0_per_tick": {"on": on["per_class"], "off": off["per_class"]},
          "host_ms_per_tick_4_peers": {"on": on["host_ms_per_tick"],
                                       "off": off["host_ms_per_tick"]},
          "digest_launches": {"on": on["launches"], "off": off["launches"]},
          "digest_launches_predicted": {"on": on["predicted"], "off": off["predicted"]}})
    return on["launches"] + off["launches"]


def pool_sched(m: int, me: int, i: int) -> int:
    """``bench.py``'s ``_match_population`` schedule for match m's peer."""
    return ((i + 2 * m + me) // (2 + m % 3)) % 16


def pool_sessions(n_matches: int, ticks: int) -> list:
    """``bench.py``'s match population (``_match_population``): 2-peer
    BoxGame matches over one in-memory network, with desync detection."""
    net = InMemoryNetwork()
    sessions = []
    for m in range(n_matches):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            sess = (SessionBuilder(boxgame_config()).with_clock(lambda: 0)
                    .with_rng(random.Random(3 + 5 * m + me))
                    .with_desync_detection_mode(DesyncDetection.on(POOL_DESYNC_INTERVAL))
                    .add_player(Local(), me).add_player(Remote(names[1 - me]), 1 - me)
                    .start_p2p_session(net.socket(names[me])))
            sess.attach_forensics(recorder=FlightRecorder(checksum_window=ticks + 8))
            sessions.append(sess)
    return sessions


def pool_predicted(desc) -> int:
    """Digest launches of one pooled tick, from its descriptor: one per
    masked write that some row takes."""
    n_adv = desc["n_adv"]
    writes = int(desc["pre_save"].any()) + int(desc["postload_save"].any())
    for j in range(int(n_adv.max())):
        writes += int(((j < n_adv) & desc["save_mask"][:, j]).any())
    return writes


def drive_pool(n_matches: int, ticks: int, device, pooled: bool = True, profiled_ticks: int = 0):
    """``n_matches`` matches fulfilled by one ``BatchedRequestExecutor``
    (``pooled``) or by one ``DeviceRequestExecutor`` per session, on
    ``device``.  On the card every fulfilment is under the sync debug mode
    "error"; in the last ``profiled_ticks`` ticks the fulfilment runs alone
    under the profiler, and those ticks are left out of the host times."""
    sessions = pool_sessions(n_matches, ticks)
    B = len(sessions)
    game = BoxGame(2)
    predicted = 0
    if pooled:
        pool = BatchedRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                                      batch_size=B, ring_length=POOL_RING,
                                      max_burst=POOL_MAX_BURST, device=device)
        pool.warmup(np.zeros(2, np.uint8))
        card = pool.device.type == "cuda"
        real_tick = pool._tick

        def tick(desc):
            nonlocal predicted
            predicted += pool_predicted(desc)
            return real_tick(desc)

        pool._tick = tick
        fulfil = pool.run
    else:
        programs = ExecutorPrograms(game.advance)
        exs = [DeviceRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                                     programs=programs, device=device) for _ in range(B)]
        exs[0].warmup(np.zeros(2, np.uint8), burst_depths=range(2, POOL_MAX_BURST + 1))
        card = exs[0].device.type == "cuda"

        def fulfil(all_reqs):
            for ex, reqs in zip(exs, all_reqs):
                ex.run(reqs)

    host = {"sessions": 0.0, "fulfil": 0.0}
    desyncs, last, prof = 0, None, []
    state_digest.launches = lane_sums_rows.launches = 0
    timed = ticks - (profiled_ticks if card else 0)
    if card:
        torch.cuda.synchronize()
    t_start = time.perf_counter()
    for i in range(ticks):
        if i == timed and card:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        t0 = time.perf_counter()
        for s in sessions:
            s.poll_remote_clients()
        reqs = []
        for b, s in enumerate(sessions):
            s.add_local_input(b % 2, pool_sched(b // 2, b % 2, i))
            reqs.append(s.advance_frame())
        t1 = time.perf_counter()
        if not pooled:
            predicted += sum(predicted_digest_launches(r) for r in reqs)
        if i < timed:
            guarded_run(fulfil, reqs, card)
            host["sessions"] += t1 - t0
            host["fulfil"] += time.perf_counter() - t1
        else:
            prof.append(profile_device(lambda: guarded_run(fulfil, reqs, card), 1))
        desyncs += sum(1 for s in sessions for e in s.events() if isinstance(e, DesyncDetected))
        last = reqs
    if card:
        torch.cuda.synchronize()
    if timed == ticks:
        wall = time.perf_counter() - t_start
    kernels = busy = None
    if prof:
        kernels = sum(r["kernels"] for r in prof) / len(prof)
        busy = sum(r["busy_us"] for r in prof) / len(prof)
    saved = [(b, r.frame) for b, rs in enumerate(last) for r in rs if isinstance(r, SaveGameState)]
    if pooled:
        states = [pool.live_state(b) for b in range(B)]
        cs = {(b, f): pool.ring_checksum(b, f) for b, f in saved}
    else:
        states = [to_numpy(ex.state) for ex in exs]
        cs = {(b, r.frame): r.cell.checksum for b, rs in enumerate(last)
              for r in rs if isinstance(r, SaveGameState)}
    wall_ms = wall / timed * 1e3
    return {
        "launches": state_digest.launches, "around": lane_sums_rows.launches,
        "predicted": predicted, "desyncs": desyncs, "states": states, "last_checksums": cs,
        "sent": [dict(s.recorder.checksums.items()) for s in sessions],
        "frames_reached": [s.current_frame for s in sessions],
        "rollbacks": sum(s._stat_rollbacks for s in sessions),
        "checksum_reads_per_tick": sum(len(s.recorder.checksums) for s in sessions) / ticks,
        "host_ms_per_tick": wall_ms,
        "host_ms_sessions": host["sessions"] / timed * 1e3,
        "host_ms_fulfil": host["fulfil"] / timed * 1e3,
        "kernels_per_tick": kernels,
        "device_busy_ms_per_tick": None if busy is None else busy / 1e3,
        "idle_share": None if busy is None else 1 - busy / 1e3 / wall_ms,
    }


def phase_pool() -> int:
    """Massed hosting on the card: one pool against one executor per
    session, and a CPU rerun; then B = 512.  Returns the digest launches
    of the card's drives."""
    pooled = drive_pool(POOL_MATCHES, POOL_TICKS, None, True, POOL_PROFILED)
    single = drive_pool(POOL_MATCHES, POOL_TICKS, None, False, POOL_PROFILED)
    for name, run in (("pool", pooled), ("executors", single)):
        check(run["around"] == 0, f"pool {name}: the digest went around state_digest")
        check(run["desyncs"] == 0, f"pool {name}: {run['desyncs']} DesyncDetected")
        check(run["launches"] == run["predicted"],
              f"pool {name}: {run['launches']} digest launches, predicted {run['predicted']}")
        check(all(len(s) > POOL_TICKS // (2 * POOL_DESYNC_INTERVAL) for s in run["sent"]),
              f"pool {name}: too few checksum reports sent")
    check(pooled["frames_reached"] == single["frames_reached"], "pool: frames != executors'")
    check(all(trees_equal(a, b) for a, b in zip(pooled["states"], single["states"])),
          "pool: live states != 64 executors'")
    check(pooled["last_checksums"] == single["last_checksums"] and pooled["last_checksums"],
          "pool: ring checksums != the executors' saved checksums")
    check(pooled["sent"] == single["sent"], "pool: sent checksums != the executors'")
    cpu = drive_pool(POOL_MATCHES, POOL_TICKS, "cpu", True)
    check(all(trees_equal(a, b) for a, b in zip(pooled["states"], cpu["states"])),
          "pool: live states != CPU rerun")
    check(pooled["last_checksums"] == cpu["last_checksums"], "pool: ring checksums != CPU rerun")
    check(pooled["sent"] == cpu["sent"], "pool: sent checksums != CPU rerun")
    big = drive_pool(POOL_BIG_MATCHES, POOL_BIG_TICKS, None, True, POOL_PROFILED)
    check(big["around"] == 0 and big["desyncs"] == 0, "pool 512: desync or stray digest")
    check(big["launches"] == big["predicted"],
          f"pool 512: {big['launches']} digest launches, predicted {big['predicted']}")
    head = drive_pool(POOL_MATCHES, POOL_BIG_TICKS, "cpu", True)
    check(all(trees_equal(a, b) for a, b in zip(big["states"], head["states"])),
          "pool 512: sessions 0-63 != CPU rerun of their matches")
    check(big["sent"][:POOL_SESSIONS] == head["sent"], "pool 512: sent checksums != CPU rerun")
    keys = ("host_ms_per_tick", "host_ms_sessions", "host_ms_fulfil", "kernels_per_tick",
            "device_busy_ms_per_tick", "idle_share", "checksum_reads_per_tick")
    emit({"phase": "pool", "game": "BoxGame(2)", "matches": POOL_MATCHES,
          "sessions": POOL_SESSIONS, "ring_length": POOL_RING, "max_burst": POOL_MAX_BURST,
          "desync_interval": POOL_DESYNC_INTERVAL, "ticks": POOL_TICKS, "desyncs": 0,
          "sync_debug_mode": "error", "states_equal_to_executors_and_cpu": True,
          "ring_checksums_equal": True, "rollbacks_per_100_session_ticks":
              pooled["rollbacks"] / (POOL_SESSIONS * POOL_TICKS) * 100,
          "profiled_ticks": POOL_PROFILED,
          "pool": {k: pooled[k] for k in keys}, "executors": {k: single[k] for k in keys},
          "digest_launches_per_tick": {"pool": pooled["launches"] / POOL_TICKS,
                                       "executors": single["launches"] / POOL_TICKS},
          "digest_launches": {"pool": pooled["launches"], "executors": single["launches"]},
          "digest_launches_predicted": {"pool": pooled["predicted"],
                                        "executors": single["predicted"]}})
    emit({"phase": "pool", "game": "BoxGame(2)", "matches": POOL_BIG_MATCHES,
          "sessions": POOL_BIG_SESSIONS, "ticks": POOL_BIG_TICKS, "desyncs": 0,
          "sessions_equal_to_cpu": POOL_SESSIONS, "profiled_ticks": POOL_PROFILED,
          "pool": {k: big[k] for k in keys},
          "digest_launches": big["launches"], "digest_launches_predicted": big["predicted"],
          "digest_launches_per_tick": big["launches"] / POOL_BIG_TICKS})
    return pooled["launches"] + single["launches"] + big["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs the card",
              file=sys.stderr)
        return 2
    smi = nvidia_smi()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build, smi)
    rng = np.random.default_rng(2026)
    worst = timed("kernel_lane_sums", phase_lane_sums, rng)
    cases = timed("kernel_state_digest", phase_state_digest, rng)
    worst = max([worst] + [c["max_abs_err"] for c in cases.values()])
    timed("flagship", phase_flagship)
    launches = timed("batched", phase_batched)
    exec_launches = timed("executor", phase_executor)
    timed("checkpoint", phase_checkpoint)
    p2p_launches = timed("p2p", phase_p2p)
    ecs_launches = timed("ecs", phase_ecs)
    float_launches = timed("float", phase_float)
    journal_launches = timed("journal", phase_journal)
    spec_launches = timed("speculation", phase_speculation)
    pool_launches = timed("pool", phase_pool)
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values())})
    main_case = cases[MAIN_CASE]
    emit({"kernels": [{
        "name": "digest", "route": "cuda", "source": "ggrs_tpu_torch/csrc/digest.cu",
        "replaces": "ggrs_tpu/ops/pallas_checksum.py:66",
        "launches": launches, "launches_executor": exec_launches,
        "launches_p2p": p2p_launches, "launches_ecs": ecs_launches,
        "launches_float": float_launches, "launches_journal": journal_launches,
        "launches_speculation": spec_launches, "launches_pool": pool_launches,
        "max_abs_err": worst,
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
