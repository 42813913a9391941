"""One run of one cell: set-up, the measured window, the traced ticks, the
check, and the result line.

``run_cell`` is everything ``run.py`` does after it has found the card; the
CPU tests call it with ``device="cpu"`` at a small size.  In order:

1. the traffic's start and input block from the seed, and the program on
   the device through the cell's entry (``program.entry``);
2. warm-up: the entry's ``warmup_calls``, so that nothing is built or
   captured in the window; ``setup_s`` ends here, measured from the end of
   ``import torch`` (``run.py``);
3. the window: closed-loop calls until ``seconds`` have passed, each timed
   on the host clock from the call to its return; the rate divides the
   entry's ``resim_frames`` of the window's calls by its wall seconds;
4. the device's peak memory; with ``trace``, a second of calls split at
   their read with no tracer running (``Run.split``), then ``trace_ticks``
   more calls and three lone advances under the profiler, read by the
   cell's per-layer metric readers;
5. the entry's check: the program freed but for what it produced, the
   reference run over every call the program ran, each count held to its
   limit (``check.verdict``); its seconds are printed before its counts.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import check, program, spec, trace
from .traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "ggrs_tpu")
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 160
ADVANCE_CALLS = 3
SPLIT_SECONDS = 1.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def _device_info(device: str, peak: int) -> Dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak}


class Run:
    """The state of one run: the cell, its traffic, the program through the
    cell's entry (``program``), the calls.  ``sessions`` replaces the mix's
    B, for the generator and the entry alike."""

    def __init__(self, cell: spec.Cell, seed: int, device: str, sessions: Optional[int],
                 advance: Optional[Callable], marks: List) -> None:
        self.cell, self.device = cell, device
        self.reference = spec.game_module(cell, "reference")
        mix = cell.traffic if sessions is None else dict(cell.traffic, sessions=sessions)
        self.traffic = Traffic(mix, cell.config, self.reference, seed)
        marks.append(("traffic", time.perf_counter()))
        self.program = program.entry(cell, mix, self.traffic.start_numpy(), device, advance)
        marks.append(("program", time.perf_counter()))
        self.calls = 0
        self.failed = 0

    def call(self) -> bool:
        ok = self.program.call(self.traffic.call_inputs(self.calls))
        self.calls += 1
        return ok

    def warm(self) -> None:
        for _ in range(self.program.warmup_calls):
            self.call()
        _sync(self.device)

    def window(self, seconds: float) -> Tuple[List[float], float]:
        """Closed-loop calls for ``seconds``: each call's ms, and the window's
        wall seconds."""
        times = []
        clock = time.perf_counter
        start = clock()
        end = start
        while end - start < seconds:
            t0 = clock()
            ok = self.call()
            end = clock()
            times.append((end - t0) * 1e3)
            self.failed += not ok
        return times, end - start

    def split(self, seconds: float) -> float:
        """Closed-loop ticks for ``seconds`` with no tracer running, each
        split at its read (the entry's ``launch``, then its ``read``): the
        mean host microseconds of the part before the read."""
        clock = time.perf_counter
        spent, n = 0.0, 0
        start = clock()
        while clock() - start < seconds:
            t0 = clock()
            self.program.launch(self.traffic.call_inputs(self.calls))
            spent += clock() - t0
            self.failed += not self.program.read()
            self.calls += 1
            n += 1
        return spent * 1e6 / (n * self.traffic.ticks_per_call)

    def traced(self, ticks: int) -> Tuple[trace.Trace, int]:
        """``ticks`` ticks under the profiler (the host and the device), and
        three lone advances after them."""
        game = self.program.game
        b = self.traffic.sessions
        batch = {k: v.to(self.device).expand(b, *v.shape).clone().to(torch.int32)
                 for k, v in self.traffic.start.items()}
        inp = torch.from_numpy(self.traffic.block[0]).to(self.device)
        game.advance(batch, inp)  # the lone advance's first call, before the trace
        _sync(self.device)
        calls = -(-ticks // self.traffic.ticks_per_call)

        def body():
            for _ in range(calls):
                with torch.profiler.record_function("bench:tick"):
                    self.failed += not self.call()
            for _ in range(ADVANCE_CALLS):
                with torch.profiler.record_function("bench:advance"):
                    game.advance(batch, inp)
                    _sync(self.device)

        return trace.profile(body, card=self.device != "cpu"), calls

    def check(self) -> Tuple[bool, Dict, List[str]]:
        """The entry's check after the window; its lines lead with the
        check's wall seconds."""
        t0 = time.perf_counter()
        values = self.program.check(self.reference, self.traffic, self.calls)
        seconds = time.perf_counter() - t0
        ok, table, lines = check.verdict(values, self.program.limits)
        return ok, table, [f"check took {seconds:.3f} s"] + lines


def read_metrics(cell: spec.Cell, run: Run, tr: trace.Trace, calls: int,
                 window_ms_per_tick: float, enqueue_us: float) -> Dict:
    """The cell's per-layer metrics.  ``window_ms_per_tick`` is the measured
    window's wall time a tick and ``enqueue_us`` the split pass's host time
    a tick before the read, both on the host clock with no tracer
    running; ``entry`` is the cell's entry, for a reader of what only that
    entry counts."""
    ctx = {"cell": cell, "entry": run.program, "trace": tr, "calls": calls,
           "enqueue_us": enqueue_us, "ticks": calls * run.traffic.ticks_per_call,
           "sessions": run.program.sessions,
           "window_ms_per_tick": window_ms_per_tick,
           "kind": torch.cuda.get_device_name(0) if run.device != "cpu" else "cpu"}
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(cell, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def short(name: str) -> str:
    """A kernel's name without its argument list and namespaces, cut to
    ``NAME_CHARS`` (the functor in a PyTorch kernel's template names the
    operation)."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(noise, "")
    depth, end = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            end = i
            break
    return name[:end][:NAME_CHARS]


def breakdown(tr: trace.Trace) -> Dict:
    """The device operations of the traced ticks that took most time, and
    the device's idle time between them by the host op that launched the
    operation it waited for, in seconds."""
    ticks = tr.launched_in(*tr.window())
    ops: Dict[str, float] = {}
    for e in ticks:
        ops[e.name] = ops.get(e.name, 0.0) + (e.end - e.start) / 1e6
    idle: Dict[str, float] = {}
    for name, us in tr.idle_by_launcher(ticks):
        idle[name] = idle.get(name, 0.0) + us / 1e6

    def top(d):
        return [[short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]

    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def window_lines(times: List[float]) -> List[str]:
    """The window's calls on standard error: their quantiles, and the calls
    completed in each second of it (a drift shows there)."""
    ordered = sorted(times)

    def q(p):
        return ordered[min(len(ordered) - 1, int(p * len(ordered)))]

    per_s, at, n = [], 0.0, 0
    for t in times:
        at += t / 1e3
        n += 1
        if at >= len(per_s) + 1:
            per_s.append(n)
            n = 0
    return [f"window calls {len(times)} mean_ms {sum(times) / len(times):.4f} p50_ms {q(0.5):.4f} "
            f"p95_ms {p95(times):.4f} p99_ms {q(0.99):.4f} max_ms {ordered[-1]:.4f}",
            "window calls_per_s " + " ".join(map(str, per_s))]


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
             t0: float, sessions: Optional[int] = None, advance: Optional[Callable] = None,
             marks: Optional[List] = None) -> Tuple[Dict, List[str]]:
    """One run; returns the result line's object and the lines for standard
    error: set-up's phases, then each number compared beside its limit.
    ``sessions`` and ``advance`` are for the tests and the control: a
    smaller batch on the CPU, another step in the game's place; ``marks``,
    (name, clock) pairs of set-up before the call, for the phases' lines."""
    marks = list(marks or []) + [("run", time.perf_counter())]
    run = Run(cell, seed, device, sessions, advance, marks)
    run.warm()
    gc.collect()
    marks.append(("warm", time.perf_counter()))
    setup_s = time.perf_counter() - t0
    at = t0
    phases = []
    for name, t in marks:
        phases.append(f"setup {name} {t - at:.3f} s")
        at = t
    times, window_s = run.window(seconds)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    attempted, failed = len(times), run.failed
    result: Dict = {"device": _device_info(device, peak)}
    if traced:
        enqueue_us = run.split(SPLIT_SECONDS)
        tr, calls = run.traced(int(cell.traffic["trace_ticks"]))
        per_tick = window_s * 1e3 / (attempted * run.traffic.ticks_per_call)
        result["metrics"] = read_metrics(cell, run, tr, calls, per_tick, enqueue_us)
        lo, hi = tr.window()
        result["device"]["busy_s"] = trace.busy_us(tr.launched_in(lo, hi)) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = breakdown(tr)
        adv = [round(trace.busy_us(tr.launched_in(e.start, e.end)), 3)
               for e in tr.spans("bench:advance")]
        phases.append(f"trace ticks {calls} device_ops {len(tr.device)} host_events {len(tr.host)} "
                      f"advance_busy_us {adv} traced_tick_us {(hi - lo) / calls:.3f} "
                      f"window_tick_us {per_tick * 1e3:.3f} enqueue_us {enqueue_us:.3f}")
    else:
        rate, tail = run.program.resim_frames(attempted) / window_s, p95(times)
        # a client's cells report the same quantities under names of their
        # own, whose bounds follow a host-paced client's spread
        values = {"resim_frames_per_s": rate, "tick_ms_p95": tail,
                  "client.resim_frames_per_s": rate, "client.tick_ms_p95": tail,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    ok, table, lines = run.check()
    line = {"correct": ok, "attempted": attempted, "failed": failed, **result, "checks": table}
    return line, phases + window_lines(times) + lines
