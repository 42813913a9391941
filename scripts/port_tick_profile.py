#!/usr/bin/env python3
"""Where a tick's time goes in the PyTorch / CUDA port, on one card.

    python3 scripts/port_tick_profile.py [--batch 16384] [--ticks 4]

Runs the port's batched replay (ChipVM(2), B sessions, check_distance 8) and
the flagship (BoxGame(2), one session, check_distance 8) past warmup, then
times a few steady ticks of each, then traces as many more with
``torch.profiler``.  Prints one JSON line per workload: host wall time per
tick (untraced, and traced), device busy time per tick (sum of
kernel times; one stream, so kernels do not overlap), the device's idle
share, kernel launches per tick, and the kernels that take the most device
time, the digest kernel among them.  If the profiler records no device
time, the device numbers print as "not measured".
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ggrs_tpu_torch import BatchedSessions, BoxGame, ChipVM, DeviceSyncTestSession  # noqa: E402

D = 8


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_ticks(name: str, run_tick, sync, ticks: int) -> dict:
    """Time ``ticks`` steady ticks untraced (the wall the idle share is taken
    against: tracing slows the host), then trace ``ticks`` more."""
    run_tick()
    sync()
    t0 = time.perf_counter()
    for _ in range(ticks):
        run_tick()
    sync()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
                {"count_per_tick": e.count / ticks,
                 "device_us_per_launch": _device_us(e) / e.count}
                for e in kernels if "lane_sums_rows" in e.key
            ],
        })
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--ticks", type=int, default=4)
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
                  sync, args.ticks)
    if batch.verify()["mismatches"]:
        print("port_tick_profile: batched run mismatched", file=sys.stderr)
        return 1

    game = BoxGame(2)
    sess = DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                 check_distance=D)
    ticks = 8 * args.ticks
    box_in = torch.from_numpy(
        rng.integers(0, 16, size=(D + 4 + 2 * ticks, 2)).astype(np.uint8)).cuda()
    sess.run_ticks(box_in[: D + 3], check=False)
    it2 = iter(range(D + 3, D + 4 + 2 * ticks))
    profile_ticks(f"flagship BoxGame(2) d={D}",
                  lambda: sess.run_ticks(box_in[next(it2)].unsqueeze(0), check=False),
                  sync, ticks)
    sess.verify()
    return 0


if __name__ == "__main__":
    sys.exit(main())
