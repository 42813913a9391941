"""The traced part of a ``--trace 1`` run, read from ``torch.profiler``.

``profile(body)`` runs ``body`` under the profiler (the CPU and, on the
card, CUDA) and returns a ``Trace``: the device operations (kernels, copies,
fills) and the host's events, on one clock, in microseconds, read from the
profiler's Chrome trace (written under ``TMPDIR`` and deleted).  The
benchmark marks its own ranges with ``bench:`` spans: ``bench:tick`` around
each traced call, ``bench:advance`` around each lone advance.
``record_function`` ranges also show on the device as annotations spanning
their kernels; they are not device work and are left out.

A device operation belongs to the host range in which it was launched: its
correlation id names the runtime call (``cudaLaunchKernel``,
``cudaGraphLaunch``, ``cudaMemcpyAsync``) that launched it, and that call's
time is on the host's clock.  The device's clock is aligned to the host's
only roughly (a kernel can appear to start before its launch), so no
device time is compared with a host time: spans pick operations by their
launches, and device intervals are only measured against each other.

The arithmetic of busy time is ``chip_smoke.py``'s ``device_summary``, made
exact: busy time is the union of the device operations' intervals, not the
sum of their durations, so overlapping operations count once.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Tuple

import torch

Interval = Tuple[float, float]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclass
class Op:
    name: str
    cat: str
    start: float
    end: float
    corr: Optional[int] = None
    launch: Optional["Op"] = None  # a device operation's launching runtime call


@dataclass
class Trace:
    device: List[Op] = field(default_factory=list)  # device operations, by start
    host: List[Op] = field(default_factory=list)  # host events, by start
    _starts: Optional[List[float]] = field(default=None, repr=False)
    _ranges: List[Op] = field(default_factory=list, repr=False)
    _longest: float = field(default=0.0, repr=False)

    def spans(self, name: str) -> List[Op]:
        return [e for e in self.host if e.cat == "user_annotation" and e.name == name]

    def window(self) -> Optional[Interval]:
        """From the first ``bench:tick``'s start to the last one's end."""
        s = self.spans("bench:tick")
        return (s[0].start, max(e.end for e in s)) if s else None

    def launched_in(self, lo: float, hi: float, cat: Optional[str] = None) -> List[Op]:
        """Device operations launched by a host call inside [lo, hi] (host
        clock)."""
        return [e for e in self.device if e.launch is not None and lo <= e.launch.start <= hi
                and (cat is None or e.cat == cat)]

    def host_at(self, t: float) -> str:
        """The innermost host op or span (the shortest) that covers ``t``,
        runtime calls left out; ``host:python`` where none does."""
        if self._starts is None:
            self._ranges = [e for e in self.host if e.cat in ("cpu_op", "user_annotation")]
            self._starts = [e.start for e in self._ranges]
            self._longest = max((e.end - e.start for e in self._ranges), default=0.0)
        lo = bisect.bisect_left(self._starts, t - self._longest)
        hi = bisect.bisect_right(self._starts, t)
        best = None
        for e in self._ranges[lo:hi]:
            if e.end >= t and (best is None or e.end - e.start < best.end - best.start):
                best = e
        return "host:python" if best is None else best.name

    def idle_by_launcher(self, ops: List[Op]) -> List[Tuple[str, float]]:
        """The gaps between ``ops`` on the device's clock, each named by the
        host op inside which the operation that ends the gap was launched:
        what the device waited for."""
        out, at = [], None
        for e in sorted(ops, key=lambda o: o.start):
            if at is not None and e.start > at:
                out.append((f"{self.host_at(e.launch.start)} > {e.launch.name}", e.start - at))
            at = e.end if at is None else max(at, e.end)
        return out


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_us(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in merged(intervals))


def busy_us(ops: Iterable[Op]) -> float:
    """The union of the operations' intervals."""
    return union_us((e.start, e.end) for e in ops)


def parse(events: list) -> Trace:
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        op = Op(ev.get("name", ""), ev.get("cat", ""), float(ev["ts"]),
                float(ev["ts"]) + float(ev["dur"]), (ev.get("args") or {}).get("correlation"))
        if op.cat in DEVICE_CATS:
            dev.append(op)
        elif op.cat in HOST_CATS:
            host.append(op)
    calls = {e.corr: e for e in host if e.cat in ("cuda_runtime", "cuda_driver") and e.corr}
    for e in dev:
        e.launch = calls.get(e.corr)
    dev.sort(key=lambda e: e.start)
    host.sort(key=lambda e: e.start)
    return Trace(dev, host)


def profile(body: Callable[[], None], card: bool) -> Trace:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        body()
        if card:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events)
