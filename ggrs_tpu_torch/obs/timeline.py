"""Match-lifecycle timelines (DESIGN.md §28).

The port's copy of ``ggrs_tpu/obs/timeline.py``.

Through §26 a match's life became genuinely distributed — admitted
through ingress, placed by the ``PlacementService``, live-migrated
cross-host, demoted to lockstep, journal-failed-over on host death —
but every one of those transitions landed in an isolated counter with
no causal ordering.  This module is the shared vocabulary that stitches
them back together:

- a **stable event schema**: each event is one flat JSON-safe dict
  (``TIMELINE_VERSION`` pins the shape) stamped with the origin
  process's monotonic clock, so events ferry over the existing
  harvest plane exactly like forensics do and get clock-offset
  corrected at ingest like spans do (§18);
- a **16-byte trace context** (``TRACE_CTX``: match-id hash u64,
  placement epoch u32, span id u32) that rides real wire bytes — the
  ingress ROUTE_UPDATE tail and the fleet-link RPC payloads — so one
  Perfetto export correlates a match's events across hosts;
- bounded per-match logs (:class:`MatchTimeline`) and a bounded
  per-process store (:class:`TimelineStore`) with LRU match eviction —
  a timeline is forensic context, never an unbounded ledger.

Transport is strictly piggyback: emitters buffer events locally and the
EXISTING heartbeat/tick obs payloads ship them (zero extra RPC round
trips); nothing here touches the native bank (zero extra ctypes
crossings) — both pinned by tests/test_timeline_slo.py.

Event schema (``v`` = TIMELINE_VERSION = 1)::

    {"v": 1, "ev": "ADMIT", "mid": "m3", "ts_ns": 123456789,
     "origin": "h0", "tick": 7, "trace": 0x9a..., "epoch": 2,
     "span": 5, "detail": {...}}

``ts_ns`` is ``time.perf_counter_ns()`` in the ORIGIN process; merging
across processes applies the §18 RTT-estimated offset, merging across
hosts relies on the per-runner offsets both supervisors maintain.
"""

from __future__ import annotations

import struct
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "TIMELINE_VERSION", "TIMELINE_EVENTS",
    "EV_ADMIT", "EV_PLACE", "EV_MIGRATE_BEGIN", "EV_MIGRATE_COMMIT",
    "EV_MIGRATE_ABORT", "EV_ROUTE_FLIP", "EV_DEMOTE_LOCKSTEP",
    "EV_QUARANTINE", "EV_EVICT", "EV_FAILOVER", "EV_DESYNC", "EV_RETIRE",
    "TRACE_CTX_FMT", "TRACE_CTX", "TRACE_CTX_BYTES", "ZERO_TRACE_CTX",
    "match_trace_id", "pack_trace_ctx", "unpack_trace_ctx",
    "timeline_event", "MatchTimeline", "TimelineStore",
    "merge_timelines", "fold_trace_aliases", "timeline_ring_events",
    "format_timeline", "first_occurrence_order",
]

# ----------------------------------------------------------------------
# the stable event vocabulary
# ----------------------------------------------------------------------

TIMELINE_VERSION = 1

EV_ADMIT = "ADMIT"                      # supervisor accepted the match
EV_PLACE = "PLACE"                      # placement chose a host + vport
EV_MIGRATE_BEGIN = "MIGRATE_BEGIN"      # source bundle exported
EV_MIGRATE_COMMIT = "MIGRATE_COMMIT"    # route flipped after adoption
EV_MIGRATE_ABORT = "MIGRATE_ABORT"      # adopt failed; restored on source
EV_ROUTE_FLIP = "ROUTE_FLIP"            # ingress dst actually changed
EV_DEMOTE_LOCKSTEP = "DEMOTE_LOCKSTEP"  # load-shed to the lockstep tier
EV_QUARANTINE = "QUARANTINE"            # slot fault isolated the match
EV_EVICT = "EVICT"                      # bundled off its shard
EV_FAILOVER = "FAILOVER"                # host/shard death; journal resume
EV_DESYNC = "DESYNC"                    # desync forensics captured
EV_RETIRE = "RETIRE"                    # shard retired under the match

TIMELINE_EVENTS: Tuple[str, ...] = (
    EV_ADMIT, EV_PLACE, EV_MIGRATE_BEGIN, EV_MIGRATE_COMMIT,
    EV_MIGRATE_ABORT, EV_ROUTE_FLIP, EV_DEMOTE_LOCKSTEP, EV_QUARANTINE,
    EV_EVICT, EV_FAILOVER, EV_DESYNC, EV_RETIRE,
)

# ----------------------------------------------------------------------
# the 16-byte trace context (§20 layout row: TRACE_CTX_FMT)
# ----------------------------------------------------------------------

# match-id hash u64, placement epoch u32, span id u32 — 16 bytes that
# ride inside the fleet-link RPC payloads and as the ROUTE_UPDATE tail
# (fleet/transport.py mirrors the struct; analysis/layout.py pins both).
TRACE_CTX_FMT = "<QII"
TRACE_CTX = struct.Struct("<QII")  # literal: the §20 layout parser
TRACE_CTX_BYTES = 16
ZERO_TRACE_CTX = b"\x00" * TRACE_CTX_BYTES

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3


def match_trace_id(match_id: str) -> int:
    """A stable u64 for ``match_id`` — FNV-1a over the utf-8 bytes, so
    every host/process derives the SAME id with no coordination (the
    property that lets a Perfetto query join a match's events across
    hosts)."""
    h = _FNV64_OFFSET
    for b in str(match_id).encode("utf-8"):
        h = ((h ^ b) * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def pack_trace_ctx(match_id: str, epoch: int, span: int) -> bytes:
    return TRACE_CTX.pack(match_trace_id(match_id),
                          epoch & 0xFFFFFFFF, span & 0xFFFFFFFF)


def unpack_trace_ctx(data: bytes) -> Tuple[int, int, int]:
    """``(trace, epoch, span)`` from 16 packed bytes; all-zero context
    decodes to ``(0, 0, 0)`` (the "no context" value)."""
    return TRACE_CTX.unpack(data)


# ----------------------------------------------------------------------
# events
# ----------------------------------------------------------------------

def timeline_event(
    etype: str,
    match_id: str,
    *,
    origin: str = "",
    tick: Optional[int] = None,
    epoch: Optional[int] = None,
    span: Optional[int] = None,
    detail: Optional[Dict[str, Any]] = None,
    ts_ns: Optional[int] = None,
) -> Dict[str, Any]:
    """One schema-stable event dict (flat, JSON-safe, picklable)."""
    return {
        "v": TIMELINE_VERSION,
        "ev": etype,
        "mid": str(match_id),
        "ts_ns": time.perf_counter_ns() if ts_ns is None else int(ts_ns),
        "origin": origin,
        "tick": tick,
        "trace": match_trace_id(match_id),
        "epoch": 0 if epoch is None else int(epoch),
        "span": 0 if span is None else int(span),
        "detail": dict(detail) if detail else {},
    }


class MatchTimeline:
    """One match's bounded event log.  Events keep arrival order in
    storage; :meth:`events` returns them time-sorted (with arrival seq
    as the tiebreak so same-nanosecond events stay stable).  Past
    ``capacity`` the OLDEST events are dropped and counted — the tail
    of a match's life (the interesting part during an incident) always
    survives."""

    __slots__ = ("match_id", "capacity", "dropped", "_events", "_seq")

    def __init__(self, match_id: str, capacity: int = 64) -> None:
        self.match_id = str(match_id)
        self.capacity = int(capacity)
        self.dropped = 0
        self._events: List[Tuple[int, int, Dict[str, Any]]] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._events)

    def add(self, event: Dict[str, Any]) -> None:
        self._events.append((int(event.get("ts_ns", 0)), self._seq, event))
        self._seq += 1
        if len(self._events) > self.capacity:
            # evict the oldest-by-time entry, not merely oldest-arrived:
            # a late-ferried early event must not push out the live tail
            self._events.remove(min(self._events))
            self.dropped += 1

    def events(self) -> List[Dict[str, Any]]:
        return [e for _, _, e in sorted(self._events,
                                        key=lambda t: (t[0], t[1]))]

    def last_ts_ns(self) -> int:
        return max((ts for ts, _, _ in self._events), default=0)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "match_id": self.match_id,
            "dropped": self.dropped,
            "events": self.events(),
        }


class TimelineStore:
    """A bounded per-process timeline sink: one :class:`MatchTimeline`
    per match, LRU-evicted past ``capacity_matches`` (a retired match's
    timeline ages out naturally once nothing touches it).

    Two write paths mirror the harvest plane's split:

    - :meth:`record` — a LOCAL emission: stamps this process's clock,
      stores the event, and returns it (callers buffer the same dict
      for the piggyback ferry);
    - :meth:`ingest` — REMOTE events off a harvest payload: each
      ``ts_ns`` is shifted by ``offset_ns`` (the §18 RTT-estimated
      clock offset) into the local clock domain before storage.

    Malformed remote events are dropped and counted, never raised — a
    corrupt ferry item must not poison the whole ingest fold.
    """

    def __init__(self, capacity_matches: int = 256,
                 capacity_events: int = 64,
                 clock: Callable[[], int] = time.perf_counter_ns) -> None:
        self.capacity_matches = int(capacity_matches)
        self.capacity_events = int(capacity_events)
        self.clock = clock
        self.malformed = 0
        self._matches: Dict[str, MatchTimeline] = {}
        self._touch = 0
        self._touched: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._matches)

    def _get(self, match_id: str) -> MatchTimeline:
        tl = self._matches.get(match_id)
        if tl is None:
            tl = MatchTimeline(match_id, capacity=self.capacity_events)
            self._matches[match_id] = tl
            if len(self._matches) > self.capacity_matches:
                victim = min(self._touched, key=self._touched.get,
                             default=None)
                if victim is not None and victim != match_id:
                    self._matches.pop(victim, None)
                    self._touched.pop(victim, None)
        self._touch += 1
        self._touched[match_id] = self._touch
        return tl

    def record(
        self,
        etype: str,
        match_id: str,
        *,
        origin: str = "",
        tick: Optional[int] = None,
        epoch: Optional[int] = None,
        span: Optional[int] = None,
        detail: Optional[Dict[str, Any]] = None,
        ts_ns: Optional[int] = None,
    ) -> Dict[str, Any]:
        ev = timeline_event(
            etype, match_id, origin=origin, tick=tick, epoch=epoch,
            span=span, detail=detail,
            ts_ns=self.clock() if ts_ns is None else ts_ns,
        )
        self._get(ev["mid"]).add(ev)
        return ev

    def ingest(self, events: Iterable[Dict[str, Any]],
               offset_ns: int = 0) -> int:
        n = 0
        for ev in events:
            try:
                mid = str(ev["mid"])
                shifted = dict(ev)
                shifted["ts_ns"] = int(ev["ts_ns"]) - int(offset_ns)
            except Exception:
                self.malformed += 1
                continue
            self._get(mid).add(shifted)
            n += 1
        return n

    def match_ids(self) -> List[str]:
        return list(self._matches)

    def timeline(self, match_id: str) -> List[Dict[str, Any]]:
        tl = self._matches.get(str(match_id))
        return [] if tl is None else tl.events()

    def to_dict(self) -> Dict[str, List[Dict[str, Any]]]:
        """``{match_id: [events...]}`` — the chaos-artifact embedding."""
        return {mid: tl.events() for mid, tl in self._matches.items()}

    def counts(self) -> Dict[str, int]:
        return {mid: len(tl) for mid, tl in self._matches.items()}


# ----------------------------------------------------------------------
# merging, rendering, re-emission
# ----------------------------------------------------------------------

def merge_timelines(*sources: Any) -> Dict[str, List[Dict[str, Any]]]:
    """Merge stores and/or already-exported ``{mid: [events]}`` dicts
    into one time-sorted per-match view — the cross-host merged
    timeline (two supervisors + the placement plane + ingress)."""
    merged: Dict[str, List[Dict[str, Any]]] = {}
    for src in sources:
        if src is None:
            continue
        exported = src.to_dict() if isinstance(src, TimelineStore) else src
        for mid, events in exported.items():
            merged.setdefault(str(mid), []).extend(events)
    for mid in merged:
        merged[mid].sort(key=lambda e: (e.get("ts_ns", 0),
                                        e.get("span", 0)))
    return merged


def fold_trace_aliases(
    merged: Dict[str, List[Dict[str, Any]]],
) -> Dict[str, List[Dict[str, Any]]]:
    """Fold ``trace:<hex>`` pseudo-matches into the real match whose
    :func:`match_trace_id` equals the hex.  Ingress nodes never learn
    match ids — their ROUTE_FLIP events key on the 16-byte wire trace
    context — so this join is what lands an edge-observed flip inside
    the match's causal chain.  Unresolvable aliases stay keyed as-is."""
    by_trace = {match_trace_id(mid): mid
                for mid in merged if not mid.startswith("trace:")}
    out: Dict[str, List[Dict[str, Any]]] = {}
    for mid, events in merged.items():
        if mid.startswith("trace:"):
            try:
                trace = int(mid.split(":", 1)[1], 16)
            except ValueError:
                trace = -1
            real = by_trace.get(trace)
            if real is not None:
                out.setdefault(real, []).extend(events)
                continue
        out.setdefault(mid, []).extend(events)
    for mid in out:
        out[mid].sort(key=lambda e: (e.get("ts_ns", 0), e.get("span", 0)))
    return out


def timeline_ring_events(
    events: Iterable[Dict[str, Any]],
) -> List[Tuple[str, str, str, int, int, int, Dict[str, Any]]]:
    """Timeline events as raw Tracer ring tuples (instant phase) for
    ``Tracer.import_spans`` — the clock-offset-corrected Perfetto
    re-emission path timelines share with harvested spans (§18)."""
    out = []
    for ev in events:
        args = {
            "mid": ev.get("mid"),
            "origin": ev.get("origin"),
            "tick": ev.get("tick"),
            "trace": f"{ev.get('trace', 0):#018x}",
            "epoch": ev.get("epoch"),
            "span": ev.get("span"),
        }
        detail = ev.get("detail")
        if detail:
            args.update(detail)
        out.append((
            "i", f"timeline.{ev.get('ev', '?')}", "timeline",
            int(ev.get("ts_ns", 0)), 0, 0, args,
        ))
    return out


def format_timeline(events: List[Dict[str, Any]],
                    base_ns: Optional[int] = None) -> List[str]:
    """Human-readable lines, one per event, offsets relative to the
    first event (fleet_top footer, match_timeline.py)."""
    if not events:
        return []
    base = events[0].get("ts_ns", 0) if base_ns is None else base_ns
    lines = []
    for ev in events:
        dt_ms = (ev.get("ts_ns", 0) - base) / 1e6
        bits = [f"+{dt_ms:10.3f}ms", f"{ev.get('ev', '?'):<16}"]
        if ev.get("origin"):
            bits.append(f"origin={ev['origin']}")
        if ev.get("tick") is not None:
            bits.append(f"tick={ev['tick']}")
        if ev.get("epoch"):
            bits.append(f"epoch={ev['epoch']}")
        if ev.get("span"):
            bits.append(f"span={ev['span']}")
        detail = ev.get("detail") or {}
        for k in sorted(detail):
            bits.append(f"{k}={detail[k]}")
        lines.append("  ".join(bits))
    return lines


def first_occurrence_order(events: List[Dict[str, Any]],
                           *etypes: str) -> bool:
    """True when the FIRST occurrence of each named event type appears
    in the given order (and all are present) — the causal-ordering
    acceptance check (ADMIT → MIGRATE_BEGIN → ROUTE_FLIP →
    MIGRATE_COMMIT) chaos legs and tests assert."""
    firsts = []
    for etype in etypes:
        idx = next((i for i, ev in enumerate(events)
                    if ev.get("ev") == etype), None)
        if idx is None:
            return False
        firsts.append(idx)
    return firsts == sorted(firsts) and len(set(firsts)) == len(firsts)
