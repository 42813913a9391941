#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``ggrs_tpu_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the run non-zero:

1. build -- compile the CUDA kernels from ``ggrs_tpu_torch/csrc`` with nvcc
   (all sources at once) and report the build seconds and ptxas summary.
2. kernel -- the digest kernel against its plain PyTorch version on the
   card, bitwise, at every shape the slice uses, with kernel / plain / bound
   times.
3. flagship -- BoxGame(2) in a DeviceSyncTestSession at check_distance=8 on
   the card for 4096 ticks, 0 mismatches, bitwise equal to the same run on
   the CPU and to the NumPy oracle.
4. batched (the main path at real scale) -- ChipVM(2), B = 16,384 sessions,
   d = 8, 64 ticks: 0 mismatches; sessions 0-7 rerun on the CPU bitwise
   equal.  Kernel launch counts are zeroed just before this drive and read
   just after it.

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and, last, ``{"ok": true, "device": {...}}``.
Exits non-zero with no result when CUDA is not available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ggrs_tpu_torch import (
    BatchedSessions,
    BoxGame,
    ChipVM,
    DeviceSyncTestSession,
    _build,
    to_numpy,
)
from ggrs_tpu_torch.ops.digest import lane_sums_rows, lane_sums_rows_plain
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
D = 8
FLAGSHIP_TICKS, FLAGSHIP_CHUNK = 4096, 512
BATCH, BATCH_TICKS, BATCH_UNTIMED = 16384, 64, 16
CHIPVM_WORDS = 66  # 256 mem bytes + 4 regs + 1 pc byte -> 64 + 1 + 1 words
KERNEL_SHAPES = [  # (rows, width, offset)
    (1, 1, 0), (1, 100, 0), (1, 128, 0), (1, 32768, 0), (1, 32769, 0),
    (1, 3 * 32768 - 7, 0), (BATCH, CHIPVM_WORDS, 0), (BATCH, CHIPVM_WORDS, 5),
    (1, 1 << 26, 0),
]


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events around the run."""
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


def digest_bound_ms(rows: int, width: int) -> float:
    """Least time for the digest: each input word read once (4 B) and each
    (rows, 4) u32 output written once, at the device memory rate.  About a
    dozen integer operations per 4-byte word puts it far on the bytes side."""
    return (4 * rows * width + 16 * rows) / HBM_BYTES_PER_S * 1e3


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


def phase_kernel() -> dict:
    """Kernel vs plain version on the card; returns the main-path shape's
    numbers for the kernels line."""
    rng = np.random.default_rng(2026)
    worst_err, main = 0, None
    for rows, width, offset in KERNEL_SHAPES:
        host = rng.integers(0, 2**32, size=(rows, width), dtype=np.uint32)
        words = torch.from_numpy(host.view(np.int32)).cuda()
        del host
        got = lane_sums_rows(words, offset)
        want = lane_sums_rows_plain(words, offset)
        torch.cuda.synchronize()
        err = int(((got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)).abs().max())
        check(torch.equal(got, want), f"digest kernel != plain at {(rows, width, offset)}")
        worst_err = max(worst_err, err)
        big = rows * width >= 1 << 24
        ms = device_ms(lambda: lane_sums_rows(words, offset), iters=20 if big else 200)
        plain_ms = device_ms(lambda: lane_sums_rows_plain(words, offset), iters=3 if big else 20, warmup=1)
        rec = {"phase": "kernel", "name": "digest", "rows": rows, "width": width,
               "offset": offset, "bitwise_equal": True, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": digest_bound_ms(rows, width)}
        emit(rec)
        if (rows, width, offset) == (BATCH, CHIPVM_WORDS, 0):
            main = rec
        del words, got, want
        torch.cuda.empty_cache()
    main["max_abs_err"] = worst_err
    return main


def phase_flagship() -> None:
    game = BoxGame(2)
    inputs = np.random.default_rng(7).integers(0, 16, size=(FLAGSHIP_TICKS, 2)).astype(np.uint8)
    chunks = torch.from_numpy(inputs).cuda().split(FLAGSHIP_CHUNK)
    sess = DeviceSyncTestSession(
        game.advance, game.init_state_np(), np.zeros(2, np.uint8), check_distance=D
    )
    lane_sums_rows.launches = 0
    sess.run_ticks(chunks[0], check=False)
    sess.block_until_ready()
    t0 = time.perf_counter()
    for c in chunks[1:]:
        sess.run_ticks(c, check=False)
    sess.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = lane_sums_rows.launches
    sess.verify()  # raises MismatchedChecksum on any desync
    steady = FLAGSHIP_TICKS - (D + 1)
    check(launches >= (D + 1) * steady,
          f"flagship: {launches} digest launches < (d+1) x {steady} steady ticks")

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
          "digest_launches_per_steady_tick": launches / steady})


def phase_batched() -> int:
    vm = ChipVM(2)
    inputs = np.random.default_rng(11).integers(0, 256, size=(BATCH, BATCH_TICKS, 2)).astype(np.uint8)
    dev_inputs = torch.from_numpy(inputs).cuda()
    batch = BatchedSessions(
        vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=BATCH,
        check_distance=D, max_prediction=D,
    )
    torch.cuda.synchronize()
    lane_sums_rows.launches = 0
    batch.run_ticks(dev_inputs[:, :BATCH_UNTIMED], check=False)
    batch.block_until_ready()
    t0 = time.perf_counter()
    batch.run_ticks(dev_inputs[:, BATCH_UNTIMED:], check=False)
    batch.block_until_ready()
    elapsed = time.perf_counter() - t0
    launches = lane_sums_rows.launches
    stats = batch.verify()
    check(stats["mismatches"] == 0, f"batched: {stats['mismatches']} mismatches")
    steady = BATCH_TICKS - (D + 1)
    check(launches >= (D + 1) * steady,
          f"batched: {launches} digest launches < (d+1) x {steady} steady ticks")

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
          "digest_launches_per_steady_tick": launches / steady,
          "kernels": ["digest"]})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs the card",
              file=sys.stderr)
        return 2
    smi = nvidia_smi()
    phase_build(smi)
    digest = phase_kernel()
    phase_flagship()
    launches = phase_batched()
    emit({"kernels": [{
        "name": "digest", "route": "cuda", "source": "ggrs_tpu_torch/csrc/digest.cu",
        "replaces": "ggrs_tpu/ops/pallas_checksum.py:66",
        "launches": launches, "max_abs_err": digest["max_abs_err"],
        "ms": digest["ms"], "plain_ms": digest["plain_ms"],
        "bound_ms": digest["bound_ms"], "bound_by": "bytes", "library_ms": None,
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
