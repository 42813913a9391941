#!/usr/bin/env python3
"""Where a request-path frame's time goes in the PyTorch / CUDA port, on one card.

    python3 scripts/port_tick_profile.py --executor [--frames 32]

Runs frames of the request-list path: ``SessionBuilder`` ->
``SyncTestSession`` -> ``DeviceRequestExecutor`` at check_distance 7
(max_prediction 8), for BoxGame(2) and ChipVM(2), past the warmup that
captures the executor's graphs; a frame is ``advance_frame``, ``run`` (one
burst graph replay once steady) and reading back the frame's saved
checksums, as the session reads them next frame.  It times a few frames,
then traces as many more with ``torch.profiler``.

Prints one JSON line per workload: host wall time per frame (untraced, and
traced), device busy time (sum of kernel times; one stream, so kernels do
not overlap), the device's idle share, kernel launches, the kernels that
take the most device time, the digest kernel (found by name: it runs
inside the graphs, so no range can be put around it), the host's launch
calls a frame (``cudaGraphLaunch``, copies, kernel launches), the host ms
of ``advance_frame`` and of ``run``, and the graphs' captures and replays.
If the profiler records no device time, the device numbers print as "not
measured".

The SyncTest replay's steady tick is profiled, layer by layer, by the
benchmark's traced run (``benchmark/run.py --trace 1``).  The host bank's
own tick (the native crossing and its phases) is profiled by
``scripts/port_profile_tick.py``, the twin of ``scripts/profile_tick.py``;
the two scripts share no code.
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

from ggrs_tpu_torch import (  # noqa: E402
    BoxGame,
    ChipVM,
    DeviceRequestExecutor,
    SaveGameState,
    SessionBuilder,
    boxgame_config,
)

EXEC_D, EXEC_MAX_PREDICTION = 7, 8
DIGEST_KERNELS = ("state_digest", "lane_sums_rows")  # the digest kernel, now and before its redesign
# the host's CUDA calls the profiler names that launch work on the card
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                "cuMemcpy", "cudaMemset", "cuMemset")


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile_ticks(name: str, run_tick, sync, ticks: int) -> dict:
    """Time ``ticks`` frames untraced (the wall the idle share is taken
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
    host_launches = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(LAUNCH_CALLS):
            host_launches[e.name] = host_launches.get(e.name, 0) + 1 / ticks
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
        })
    rec["host_launch_calls_per_tick"] = host_launches
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
    rec = profile_ticks(name, frame, sync, frames)
    graphs = ex._programs.graphs(ex.device)  # the graphs of the current card
    print(json.dumps({"workload": name, "captures": graphs.captures,
                      "replays": graphs.replays}), flush=True)
    # split covers the untimed first frame, the untraced and the traced window
    return rec, {k: v / (2 * frames + 1) * 1e3 for k, v in split.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--executor", action="store_true",
                    help="profile frames of the request-list path (the only mode)")
    ap.add_argument("--frames", type=int, default=32,
                    help="executor frames per window (ChipVM runs a quarter as many)")
    args = ap.parse_args()
    if not args.executor:
        ap.error("the SyncTest replay's tick is profiled by benchmark/run.py --trace 1; "
                 "this script profiles request-path frames with --executor")
    if not torch.cuda.is_available():
        print("port_tick_profile: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    sync = torch.cuda.synchronize
    for name, game, high, frames in (("BoxGame(2)", BoxGame(2), 16, args.frames),
                                     ("ChipVM(2)", ChipVM(2), 256, max(1, args.frames // 4))):
        _, split = profile_executor(f"executor frame {name} d={EXEC_D}", game, high, frames, sync)
        print(json.dumps({"workload": f"executor frame {name} d={EXEC_D}",
                          "host_ms_per_frame": split}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
