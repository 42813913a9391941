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
time.  The whole digest is the digest kernel (found by name) plus every
other kernel launched inside the replay's checksum calls, which are wrapped
in a ``ggrs:digest`` range for the traced ticks only: so the packing ops of
an older digest count too.  (The profiler does not tie a kernel launched
through ctypes to the range around it, hence the name.)  If the profiler
records no device time, the device numbers print as "not measured".
"""

from __future__ import annotations

import argparse
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

from ggrs_tpu_torch import BatchedSessions, BoxGame, ChipVM, DeviceSyncTestSession  # noqa: E402

D = 8
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


def _trace_digest(owner) -> None:
    """Wrap ``owner._programs.checksum`` in a ``ggrs:digest`` range."""
    plain = owner._programs.checksum

    def traced(state):
        with record_function("ggrs:digest"):
            return plain(state)

    owner._programs = dataclasses.replace(owner._programs, checksum=traced)


def profile_ticks(name: str, run_tick, sync, ticks: int, owner) -> dict:
    """Time ``ticks`` steady ticks untraced (the wall the idle share is taken
    against: tracing slows the host), then trace ``ticks`` more."""
    run_tick()
    sync()
    t0 = time.perf_counter()
    for _ in range(ticks):
        run_tick()
    sync()
    plain_wall = time.perf_counter() - t0
    untraced = owner._programs
    _trace_digest(owner)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            run_tick()
        sync()
        traced_wall = time.perf_counter() - t0
    owner._programs = untraced
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--ticks", type=int, default=4,
                    help="ChipVM ticks per window; the flagship runs 32 times as many")
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
                  sync, args.ticks, batch)
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
                  sync, ticks, sess)
    sess.verify()
    return 0


if __name__ == "__main__":
    sys.exit(main())
