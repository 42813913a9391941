"""Low-overhead span tracer with Chrome/Perfetto trace-event export (the
port's copy of ``ggrs_tpu/obs/trace.py``).

A :class:`Tracer` keeps a bounded ring of completed spans (a P2P session
wraps ``session.tick`` and ``session.poll`` in them) and exports the window
in the Chrome trace-event JSON format, so one ``tracer.write(path)``
produces a file that loads in ``chrome://tracing`` or
https://ui.perfetto.dev.

- **Compiles out.**  ``Tracer(enabled=False)`` hands back a shared no-op
  context manager from ``span()`` and drops every ``add_*`` immediately:
  no clock reads, no allocation, nothing on the ring.
- **Monotonic clocks only.**  Spans are stamped with
  ``time.perf_counter_ns`` (never the session clock), so tracing cannot
  perturb timer-driven protocol behavior.
- **Bounded.**  The ring drops the oldest span; ``dropped`` counts what
  fell off.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = ["Tracer", "NULL_TRACER", "chrome_trace_events",
           "validate_chrome_trace"]

# event phases on the ring (Chrome trace-event "ph" values)
_PH_COMPLETE = "X"
_PH_INSTANT = "i"


class _NullSpan:
    """Shared no-op context manager: the whole cost of a disabled span is
    one attribute load and one method call returning this singleton."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t0 = self._t0
        self._tracer._append(
            _PH_COMPLETE, self._name, self._cat, t0,
            time.perf_counter_ns() - t0, self._args,
        )
        return False


class Tracer:
    """Bounded ring of trace spans with Chrome trace-event export.

    Usage::

        tracer = Tracer()                      # or Tracer(enabled=False)
        with tracer.span("session.tick", cat="py", frame=7):
            with tracer.span("session.poll"):
                ...
        tracer.write("session.trace.json")        # chrome://tracing loads this

    Spans nest naturally through ``with`` nesting (Chrome infers the tree
    from containment on one thread's timeline).  ``add_complete`` records a
    span from explicit timestamps.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True) -> None:
        self.enabled = enabled
        self.capacity = capacity
        # (ph, name, cat, start_ns, dur_ns, tid, args)
        self._ring: Deque[Tuple] = deque(maxlen=capacity)
        self.recorded = 0  # total ever recorded (ring drops the oldest)

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------

    def span(self, name: str, cat: str = "py", **args):
        """Context manager timing one span; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args or None)

    def add_complete(self, name: str, start_ns: int, dur_ns: int,
                     cat: str = "native",
                     args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete span from explicit monotonic-ns timestamps."""
        if self.enabled:
            self._append(_PH_COMPLETE, name, cat, start_ns, dur_ns, args)

    def add_instant(self, name: str, cat: str = "py", **args) -> None:
        """Record an instant event (faults, desyncs, evictions)."""
        if self.enabled:
            self._append(_PH_INSTANT, name, cat, time.perf_counter_ns(), 0,
                         args or None)

    def now_ns(self) -> int:
        """The tracer's clock (monotonic ns), for callers timing a region
        by hand."""
        return time.perf_counter_ns()

    def import_spans(self, events: List[Tuple], *, offset_ns: int = 0,
                     extra_args: Optional[Dict[str, Any]] = None) -> int:
        """Re-emit raw ring events shipped from ANOTHER process
        (the fleet's harvest): each event's start time is shifted by
        ``offset_ns`` (the RTT-estimated clock offset between the two
        processes' ``perf_counter`` clocks) and recorded on THIS thread's
        track, so a runner's spans nest inside the supervisor span that
        covers the RPC which carried them.  ``extra_args`` (e.g.
        ``{"shard": "s1"}``) is folded into every event's args; the
        source thread id is preserved as ``src_tid``.  Returns the number
        of events imported; malformed entries are skipped, never raised.
        """
        if not self.enabled or not events:
            return 0
        n = 0
        for ev in events:
            try:
                ph, name, cat, start_ns, dur_ns, src_tid, args = ev
                start_ns = int(start_ns) - offset_ns
                dur_ns = int(dur_ns)
            except Exception:
                continue
            a: Dict[str, Any] = dict(args) if args else {}
            if extra_args:
                a.update(extra_args)
            a.setdefault("src_tid", src_tid)
            self._append(ph, str(name), str(cat), start_ns, dur_ns, a)
            n += 1
        return n

    def _append(self, ph: str, name: str, cat: str, start_ns: int,
                dur_ns: int, args: Optional[Dict[str, Any]]) -> None:
        self._ring.append(
            (ph, name, cat, start_ns, dur_ns, threading.get_ident(), args)
        )
        self.recorded += 1

    # ------------------------------------------------------------------
    # reads / export
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        return self.recorded - len(self._ring)

    def events(self, last: int = 0) -> List[Tuple]:
        """The retained raw events, oldest first; ``last`` > 0 keeps only
        the newest ``last``."""
        out = list(self._ring)
        if last > 0:
            out = out[-last:]
        return out

    def clear(self) -> None:
        self._ring.clear()

    def chrome_trace(self, last: int = 0) -> Dict[str, Any]:
        """The current window as a Chrome trace-event JSON object
        (``{"traceEvents": [...]}``) — loads in ``chrome://tracing`` and
        Perfetto.  Timestamps are microseconds relative to the oldest
        retained event."""
        events = self.events(last)
        return {
            "traceEvents": chrome_trace_events(events),
            "displayTimeUnit": "ms",
        }

    def write(self, path) -> str:
        """Serialize :meth:`chrome_trace` to ``path``; returns the path."""
        path = os.fspath(path)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name totals over the window: count and total/max
        duration in microseconds."""
        out: Dict[str, Dict[str, float]] = {}
        for ph, name, _cat, _t0, dur, _tid, _args in self._ring:
            if ph != _PH_COMPLETE:
                continue
            s = out.setdefault(name, {"count": 0, "total_us": 0.0,
                                      "max_us": 0.0})
            s["count"] += 1
            us = dur / 1000.0
            s["total_us"] += us
            if us > s["max_us"]:
                s["max_us"] = us
        return out


def chrome_trace_events(events: List[Tuple]) -> List[Dict[str, Any]]:
    """Convert raw ring events to Chrome trace-event dicts.  The time base
    is shifted so the oldest event sits at ts=0 (chrome://tracing dislikes
    raw multi-hour perf_counter offsets)."""
    if not events:
        return []
    base = min(e[3] for e in events)
    out: List[Dict[str, Any]] = []
    for ph, name, cat, start_ns, dur_ns, tid, args in events:
        ev: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "ts": (start_ns - base) / 1000.0,
            "pid": 1,
            "tid": tid & 0xFFFF,
        }
        if ph == _PH_COMPLETE:
            ev["dur"] = dur_ns / 1000.0
        else:
            ev["s"] = "t"  # instant scope: thread
        if args:
            ev["args"] = dict(args)
        out.append(ev)
    return out


# The shared disabled tracer: sessions and pools default to this so the
# hot path pays one attribute load + one no-op call when nobody is tracing.
NULL_TRACER = Tracer(capacity=1, enabled=False)


def validate_chrome_trace(trace: Any, eps_us: float = 0.001) -> List[str]:
    """Schema validation for a Chrome/Perfetto trace-event export: the
    checks a load into ui.perfetto.dev would fail on, run in CI instead.  Returns a list of problems (empty = valid):

    - the object is ``{"traceEvents": [...]}`` and JSON-serializable;
    - every event has a string ``name``, a known ``ph``, numeric
      finite ``ts >= 0``, and ``pid``/``tid``;
    - complete ("X") events carry ``dur >= 0``;
    - per (pid, tid) track, complete events properly nest: sorted by
      start time, any two spans are either disjoint or one contains the
      other — partial overlap on one track is how a bad clock offset or
      a torn import shows up.

    ``eps_us`` is the nesting slack in microseconds: keep the tight
    default for single-process traces (one clock, exact containment);
    fleet traces carrying imported cross-process spans should allow the
    residual clock-offset error (tens of µs).
    """
    problems: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["not a {'traceEvents': [...]} object"]
    events = trace["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as e:
        problems.append(f"not JSON-serializable: {e}")
    known_ph = {"X", "i", "I", "B", "E", "M", "b", "e", "n", "s", "t", "f"}
    tracks: Dict[Tuple, List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            problems.append(f"event {i}: missing/empty name")
            name = "?"
        ph = ev.get("ph")
        if ph not in known_ph:
            problems.append(f"event {i} ({name}): unknown ph {ph!r}")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts != ts or ts < 0 \
                or ts in (float("inf"), float("-inf")):
            problems.append(f"event {i} ({name}): bad ts {ts!r}")
            continue
        if "pid" not in ev or "tid" not in ev:
            problems.append(f"event {i} ({name}): missing pid/tid")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur != dur or dur < 0:
                problems.append(f"event {i} ({name}): bad dur {dur!r}")
                continue
            tracks.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ts), float(dur), name)
            )
    # nesting per track: the epsilon absorbs ns→µs rounding (default)
    # or residual cross-process offset error (caller-raised)
    eps = eps_us
    for track, spans in tracks.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, str]] = []  # (end_ts, name)
        for ts, dur, name in spans:
            end = ts + dur
            while stack and ts >= stack[-1][0] - eps:
                stack.pop()
            if stack and end > stack[-1][0] + eps:
                problems.append(
                    f"track {track}: span {name!r} [{ts:.3f}, {end:.3f}] "
                    f"partially overlaps enclosing {stack[-1][1]!r} "
                    f"(ends {stack[-1][0]:.3f})"
                )
                continue
            stack.append((end, name))
    return problems


# The shared disabled tracer: sessions and pools default to this so the
# hot path pays one attribute load + one no-op call when nobody is tracing.
NULL_TRACER = Tracer(capacity=1, enabled=False)
