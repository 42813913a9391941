#!/usr/bin/env python3
"""Where a tick's time goes in the PyTorch / CUDA port, on one card.

    python3 scripts/port_tick_profile.py [--batch 16384] [--ticks 4]
    python3 scripts/port_tick_profile.py --executor [--frames 32]

Runs the port's batched replay (ChipVM(2), B sessions, check_distance 8) and
the flagship (BoxGame(2), one session, check_distance 8) past warmup, then
times a few steady ticks of each, then traces as many more with
``torch.profiler``.  With ``--executor`` it does the same for frames of the
request-list path instead: ``SessionBuilder`` -> ``SyncTestSession`` ->
``DeviceRequestExecutor`` at check_distance 7 (max_prediction 8), for
BoxGame(2) and ChipVM(2); a frame is ``advance_frame``, ``run`` and reading
back the frame's saved checksums, as the session reads them next frame.

Prints one JSON line per workload: host wall time per tick or frame
(untraced, and traced), device busy time (sum of kernel times; one stream,
so kernels do not overlap), the device's idle share, kernel launches, and
the kernels that take the most device time; for the executor also the host
ms of ``advance_frame`` and of ``run``.  The whole digest is the digest
kernel (found by name) plus every other kernel launched inside the digest
calls, which are wrapped in a ``ggrs:digest`` range for the traced window
only: so the packing ops of an older digest count too.  (The profiler does
not tie a kernel launched through ctypes to the range around it, hence the
name.)  If the profiler records no device time, the device numbers print as
"not measured".
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ggrs_tpu_torch import (  # noqa: E402
    BatchedSessions,
    BoxGame,
    ChipVM,
    DeviceRequestExecutor,
    DeviceSyncTestSession,
    SaveGameState,
    SessionBuilder,
    boxgame_config,
)
from ggrs_tpu_torch.ops import executor as executor_mod  # noqa: E402

D = 8
EXEC_D, EXEC_MAX_PREDICTION = 7, 8
DIGEST_KERNELS = ("state_digest", "lane_sums_rows")  # the digest kernel, now and before its redesign


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _span_kernels(evt):
    """(device us, kernel count) of every kernel launched under ``evt``,
    the digest kernel left out."""
    own = [k for k in evt.kernels if not any(d in k.name for d in DIGEST_KERNELS)]
    us = sum(k.duration for k in own)
    n = len(own)
    for child in evt.cpu_children:
        cu, cn = _span_kernels(child)
        us, n = us + cu, n + cn
    return us, n


def _in_digest_range(fn):
    def traced(state):
        with record_function("ggrs:digest"):
            return fn(state)

    return traced


@contextlib.contextmanager
def replay_digest_range(owner):
    """Wrap ``owner._programs.checksum`` in a ``ggrs:digest`` range."""
    untraced = owner._programs
    owner._programs = dataclasses.replace(untraced, checksum=_in_digest_range(untraced.checksum))
    try:
        yield
    finally:
        owner._programs = untraced


@contextlib.contextmanager
def executor_digest_range():
    """Wrap the executor's ``checksum_device`` in a ``ggrs:digest`` range."""
    untraced = executor_mod.checksum_device
    executor_mod.checksum_device = _in_digest_range(untraced)
    try:
        yield
    finally:
        executor_mod.checksum_device = untraced


def profile_ticks(name: str, run_tick, sync, ticks: int, digest_range) -> dict:
    """Time ``ticks`` steady ticks untraced (the wall the idle share is taken
    against: tracing slows the host), then trace ``ticks`` more with the
    digest calls inside ``digest_range()``."""
    run_tick()
    sync()
    t0 = time.perf_counter()
    for _ in range(ticks):
        run_tick()
    sync()
    plain_wall = time.perf_counter() - t0
    with digest_range(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            run_tick()
        sync()
        traced_wall = time.perf_counter() - t0
    # record_function ranges ("ggrs:...") also appear as device-side
    # annotations spanning their kernels; only kernels count as busy time
    kernels = [
        e for e in prof.key_averages()
        if _device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA
        and not e.key.startswith("ggrs:")
    ]
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:8]
    span_us = span_n = 0
    for e in prof.events():
        if e.name == "ggrs:digest" and e.device_type == torch.autograd.DeviceType.CPU:
            us, n = _span_kernels(e)
            span_us, span_n = span_us + us, span_n + n
    by_name = [e for e in kernels if any(k in e.key for k in DIGEST_KERNELS)]
    by_name_us = sum(_device_us(e) for e in by_name)
    rec = {"workload": name, "ticks": ticks,
           "wall_ms_per_tick": plain_wall / ticks * 1e3,
           "traced_wall_ms_per_tick": traced_wall / ticks * 1e3}
    if busy_us == 0:
        rec.update({"device_busy_ms_per_tick": "not measured", "idle_share": "not measured"})
    else:
        rec.update({
            "device_busy_ms_per_tick": busy_us / ticks / 1e3,
            "idle_share": 1 - busy_us / 1e6 / plain_wall,
            "kernel_launches_per_tick": launches / ticks,
            "top_kernels": [
                {"name": e.key[:80], "count_per_tick": e.count / ticks,
                 "device_us_per_tick": _device_us(e) / ticks,
                 "device_us_per_launch": _device_us(e) / e.count}
                for e in top
            ],
            "digest_kernel": [
                {"name": e.key[:80], "count_per_tick": e.count / ticks,
                 "device_us_per_launch": _device_us(e) / e.count}
                for e in by_name
            ],
            "digest_kernel_share_of_busy": by_name_us / busy_us,
            "whole_digest": {
                "kernels_per_tick": (span_n + sum(e.count for e in by_name)) / ticks,
                "device_us_per_tick": (span_us + by_name_us) / ticks,
                "share_of_busy": (span_us + by_name_us) / busy_us,
            },
        })
    print(json.dumps(rec), flush=True)
    return rec


def profile_executor(name: str, game, high: int, frames: int, sync) -> dict:
    """Frames of the request-list path past warmup: ``frames`` untraced,
    then ``frames`` traced; also the host ms per frame of ``advance_frame``,
    of ``run`` and of reading the saved checksums back (where the host
    waits for the card), over both windows."""
    sess = (SessionBuilder(boxgame_config()).with_check_distance(EXEC_D)
            .with_max_prediction_window(EXEC_MAX_PREDICTION).start_synctest_session())
    ex = DeviceRequestExecutor(
        game.advance, game.init_state_np(),
        lambda pairs: np.asarray([p[0] for p in pairs], np.uint8))
    ex.warmup(np.zeros(2, np.uint8), burst_depths=range(2, EXEC_MAX_PREDICTION + 2))
    inputs = np.random.default_rng(7).integers(0, high, size=(EXEC_D + 4 + 3 * frames, 2))
    split = {"advance_frame": 0.0, "run": 0.0, "read_checksums": 0.0}
    it = iter(range(len(inputs)))

    def frame() -> None:
        f = next(it)
        sess.add_local_input(0, int(inputs[f, 0]))
        sess.add_local_input(1, int(inputs[f, 1]))
        t0 = time.perf_counter()
        reqs = sess.advance_frame()
        t1 = time.perf_counter()
        ex.run(reqs)
        t2 = time.perf_counter()
        for r in reqs:
            if isinstance(r, SaveGameState):
                r.cell.checksum  # the session reads these next frame
        split["advance_frame"] += t1 - t0
        split["run"] += t2 - t1
        split["read_checksums"] += time.perf_counter() - t2

    for _ in range(EXEC_D + 3):
        frame()
    sync()
    split.update(advance_frame=0.0, run=0.0, read_checksums=0.0)
    rec = profile_ticks(name, frame, sync, frames, executor_digest_range)
    # split covers the untimed first frame, the untraced and the traced window
    return rec, {k: v / (2 * frames + 1) * 1e3 for k, v in split.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--ticks", type=int, default=4,
                    help="ChipVM ticks per window; the flagship runs 32 times as many")
    ap.add_argument("--executor", action="store_true",
                    help="profile frames of the request-list path instead")
    ap.add_argument("--frames", type=int, default=32,
                    help="executor frames per window (ChipVM runs a quarter as many)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_tick_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    sync = torch.cuda.synchronize
    if args.executor:
        for name, game, high, frames in (("BoxGame(2)", BoxGame(2), 16, args.frames),
                                         ("ChipVM(2)", ChipVM(2), 256, max(1, args.frames // 4))):
            _, split = profile_executor(f"executor frame {name} d={EXEC_D}", game, high, frames, sync)
            print(json.dumps({"workload": f"executor frame {name} d={EXEC_D}",
                              "host_ms_per_frame": split}), flush=True)
        return 0
    rng = np.random.default_rng(5)

    vm = ChipVM(2)
    batch = BatchedSessions(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8),
                            batch_size=args.batch, check_distance=D, max_prediction=D)
    n = D + 4 + 2 * args.ticks
    inputs = torch.from_numpy(
        rng.integers(0, 256, size=(args.batch, n, 2)).astype(np.uint8)).cuda()
    batch.run_ticks(inputs[:, : D + 3], check=False)
    it = iter(range(D + 3, n))
    profile_ticks(f"batched ChipVM(2) B={args.batch} d={D}",
                  lambda: batch.run_ticks(inputs[:, next(it)].unsqueeze(1), check=False),
                  sync, args.ticks, lambda: replay_digest_range(batch))
    if batch.verify()["mismatches"]:
        print("port_tick_profile: batched run mismatched", file=sys.stderr)
        return 1

    game = BoxGame(2)
    sess = DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                 check_distance=D)
    ticks = 32 * args.ticks
    box_in = torch.from_numpy(
        rng.integers(0, 16, size=(D + 4 + 2 * ticks, 2)).astype(np.uint8)).cuda()
    sess.run_ticks(box_in[: D + 3], check=False)
    it2 = iter(range(D + 3, D + 4 + 2 * ticks))
    profile_ticks(f"flagship BoxGame(2) d={D}",
                  lambda: sess.run_ticks(box_in[next(it2)].unsqueeze(0), check=False),
                  sync, ticks, lambda: replay_digest_range(sess))
    sess.verify()
    return 0


if __name__ == "__main__":
    sys.exit(main())
