#!/usr/bin/env python3
"""What the steady tick's layer marks cost, and how they split its graph, on
one card.

    python3 scripts/port_layer_marks.py --workload boxgame2-d8-b1 --seed 7 \
        [--calls 2000] [--rounds 2] [--trace-ticks 64]

Builds a benchmark cell's program (``BENCHMARK.json``, the benchmark's own
``Run``), warms it up as the benchmark does (every phase's graph captured),
then:

1. the cost: ``--rounds`` rounds of marks off, on, on, off, each
   ``--calls`` closed-loop calls (one tick, ``check=True``) with no
   profiler running.  The marks are held on or off through the tick
   graphs' ``GraphSet.pin_marks``; the first replay of each graph after a
   switch flips its marks, so 2R calls run untimed after each switch.  One
   JSON line a block: mean, median and p95 ms a call on the host clock,
   and the mean and median ms of the tick graph's replay on the card
   (CUDA events around it);
2. the split: ``--trace-ticks`` ticks under the profiler (marks following
   it) and three lone advances, as the benchmark's traced run takes them.
   One JSON line: the ``ggrs_mark_*`` kernels of each graph launch against
   the layers' order, each layer's device microseconds a tick (the
   benchmark's ``layer_us``), the marks' own, their sum against the union
   of the graph's operations, and the in-graph advance against d + 1 lone
   advances.

Each line carries the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, spec, trace  # noqa: E402

ORDER = ["ring", "advance", "ring", "digest", "ring", "compare", "advance", "digest", "ring"]
LAYERS = ("ring", "advance", "digest", "compare")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def time_replays(tick_graphs, events: list) -> None:
    """Each tick graph's replay between two CUDA events, appended to
    ``events``: the graph's own time on the card, gaps inside it included."""
    for tg in tick_graphs:
        for graph in tg.graphs.values():
            def replay(inner=graph.replay):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                inner()
                end.record()
                events.append((start, end))
            graph.replay = replay


def timed(run: harness.Run, sets, events: list, on: bool, calls: int) -> dict:
    for s in sets:
        s.pin_marks = on
    for _ in range(2 * run.program.ring_length):
        run.call()
    torch.cuda.synchronize()
    events.clear()
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        run.call()
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    dev = [s.elapsed_time(e) for s, e in events]
    return {"marks": "on" if on else "off", "calls": calls, "mean_ms": statistics.fmean(ms),
            "median_ms": statistics.median(ms), "p95_ms": harness.p95(ms),
            "graph_device_mean_ms": statistics.fmean(dev),
            "graph_device_median_ms": statistics.median(dev)}


def split(cell: spec.Cell, run: harness.Run, ticks: int) -> dict:
    tr, calls = run.traced(ticks)
    ctx = {"cell": cell, "trace": tr, "ticks": calls * run.traffic.ticks_per_call}
    lo, hi = tr.window()
    graph_ops = [e for e in tr.launched_in(lo, hi) if "GraphLaunch" in e.launch.name]
    per_launch: dict = {}
    for e in graph_ops:
        if e.name.startswith("ggrs_mark_"):
            per_launch.setdefault(id(e.launch), []).append(e.name[len("ggrs_mark_"):])
    ring = spec.metric_reader(cell, "ring.device_us_per_tick")
    layers = {name: ring.layer_us(ctx, name) for name in LAYERS}
    ops = ring.layer_ops(ctx) or {}
    marks_us = trace.busy_us(ops.get("mark", [])) / ctx["ticks"]
    union_us = trace.busy_us(graph_ops) / ctx["ticks"]
    lone = [trace.busy_us(tr.launched_in(s.start, s.end)) for s in tr.spans("bench:advance")]
    d = int(cell.config["check_distance"])
    summed = sum(v for v in layers.values() if v is not None) + marks_us
    return {
        "ticks": ctx["ticks"], "graph_launches": len(per_launch),
        "launches_in_layer_order": sum(m == ORDER for m in per_launch.values()),
        "layers_us_per_tick": layers, "marks_us_per_tick": marks_us,
        "graph_union_us_per_tick": union_us,
        "layers_plus_marks_over_union": summed / union_us if union_us else None,
        "lone_advance_us": statistics.fmean(lone) if lone else None,
        "in_graph_advance_over_lone": (layers["advance"] / ((d + 1) * statistics.fmean(lone))
                                       if lone and layers["advance"] else None),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--trace-ticks", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_layer_marks: needs a CUDA card", file=sys.stderr)
        return 2
    name = card()
    cell = spec.load_cell(args.workload)
    run = harness.Run(cell, args.seed, "cuda", None, None, [])
    run.warm()
    tick_graphs = run.program.sess.programs.tick_graphs
    sets, events = [tg.set for tg in tick_graphs], []
    time_replays(tick_graphs, events)
    for _ in range(args.rounds):
        for on in (False, True, True, False):
            print(json.dumps({"card": name, "workload": cell.name,
                              **timed(run, sets, events, on, args.calls)}), flush=True)
    for s in sets:
        s.pin_marks = None
    print(json.dumps({"card": name, "workload": cell.name,
                      **split(cell, run, args.trace_ticks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
