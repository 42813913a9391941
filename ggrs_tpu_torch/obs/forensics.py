"""Desync forensics: turn a checksum mismatch into an actionable report
(the port's copy of ``ggrs_tpu/obs/forensics.py``).

The reference's desync story ends at an opaque ``DesyncDetected`` event
(p2p_session.rs:904-975): frame, two checksums, an address.  This module
assembles what a human needs into a :class:`DesyncReport`:

- **first divergent frame**: a bisection over the two peers' shared
  per-frame checksum history (:func:`first_divergent_frame`).  Determinism
  makes agreement prefix-closed, so the boundary is found in O(log n)
  compares over the retained window;
- **flight-recorder dump** of the local ring;
- **journal tail**: the frames around the divergence from an attached
  journal's in-memory ``tail`` window, when the caller has one;
- **trace window**: the active :class:`~.trace.Tracer` ring as Chrome
  trace events.

Reports are plain data: ``to_dict()`` is JSON-serializable.  Building one
is observational only: it reads histories and rings, never session state.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..core.types import NULL_FRAME
from .recorder import ChecksumHistory, FlightRecorder

__all__ = [
    "DesyncReport",
    "build_desync_report",
    "first_divergent_frame",
]

# how many frames of checksum/journal context a report carries each side
# of the divergence
_CONTEXT_FRAMES = 8
# a session keeps at most this many reports (one desync usually re-fires
# every interval until the match is torn down)
MAX_REPORTS = 8


def first_divergent_frame(
    local: Mapping[int, int], remote: Mapping[int, int]
) -> int:
    """The smallest shared frame whose checksums differ, or ``NULL_FRAME``.

    Bisection over the sorted shared frames: a deterministic simulation
    that diverged at frame F agrees on every reported frame < F and
    differs on every reported frame >= F, so "does frame i match?" is
    monotone and the boundary is found in O(log n) compares.  The result
    is validated to actually mismatch, so a non-monotone history (memory
    corruption rather than divergence) can at worst return a later
    divergent frame, never a false one.
    """
    common = sorted(set(local) & set(remote))
    if not common:
        return NULL_FRAME
    lo, hi = 0, len(common) - 1
    first = NULL_FRAME
    while lo <= hi:
        mid = (lo + hi) // 2
        frame = common[mid]
        if local[frame] == remote[frame]:
            lo = mid + 1
        else:
            first = frame
            hi = mid - 1
    return first


class DesyncReport:
    """One desync post-mortem.  ``kind`` is ``"checksum-compare"`` (the
    reference detection path: both histories available, bisection ran) or
    ``"native-fault"`` (a desync-class slot fault in the bank: evidence
    without a local checksum history).  Plain data throughout — safe to
    stash, serialize, and ship long after the session is gone."""

    __slots__ = (
        "kind", "detected_frame", "first_divergent_frame", "addr",
        "local_checksum", "remote_checksum", "checksum_window",
        "recorder_dump", "remote_recorder_dump", "journal_tail",
        "trace_events", "timeline", "detail",
    )

    def __init__(
        self,
        kind: str,
        detected_frame: int,
        first_divergent: int,
        addr: Any = None,
        local_checksum: Optional[int] = None,
        remote_checksum: Optional[int] = None,
        checksum_window: Optional[Dict[str, Dict[int, int]]] = None,
        recorder_dump: str = "",
        journal_tail: Optional[List[Tuple[int, int]]] = None,
        trace_events: Optional[List[Dict[str, Any]]] = None,
        timeline: Optional[List[Dict[str, Any]]] = None,
        detail: str = "",
    ) -> None:
        self.kind = kind
        self.detected_frame = detected_frame
        self.first_divergent_frame = first_divergent
        self.addr = addr
        self.local_checksum = local_checksum
        self.remote_checksum = remote_checksum
        self.checksum_window = checksum_window or {}
        self.recorder_dump = recorder_dump
        # filled by a caller that holds both ends
        self.remote_recorder_dump = ""
        self.journal_tail = journal_tail or []
        self.trace_events = trace_events or []
        # the match's lifecycle timeline up to the desync, when the
        # caller keeps one
        self.timeline = timeline or []
        self.detail = detail

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "detected_frame": self.detected_frame,
            "first_divergent_frame": self.first_divergent_frame,
            "addr": None if self.addr is None else repr(self.addr),
            "local_checksum": self.local_checksum,
            "remote_checksum": self.remote_checksum,
            # JSON objects key on strings; keep frames sortable
            "checksum_window": {
                side: {str(f): c for f, c in sorted(window.items())}
                for side, window in self.checksum_window.items()
            },
            "recorder_dump": self.recorder_dump,
            "remote_recorder_dump": self.remote_recorder_dump,
            "journal_tail": [
                {"frame": f, "crc32": c} for f, c in self.journal_tail
            ],
            "trace_events": self.trace_events,
            "timeline": self.timeline,
            "detail": self.detail,
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def write(self, path) -> str:
        path = os.fspath(path)
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))
        return path

    def summary(self) -> str:
        """One-paragraph human digest."""
        lines = [
            f"DesyncReport[{self.kind}] detected at frame "
            f"{self.detected_frame}, first divergent frame "
            f"{self.first_divergent_frame}"
            + (f", peer {self.addr!r}" if self.addr is not None else ""),
        ]
        if self.local_checksum is not None:
            lines.append(
                f"  checksums at detection: local={self.local_checksum:#x} "
                f"remote={self.remote_checksum:#x}"
            )
        if self.journal_tail:
            lines.append(
                f"  journal tail: {len(self.journal_tail)} frames around "
                f"the divergence"
            )
        if self.trace_events:
            lines.append(f"  trace window: {len(self.trace_events)} spans")
        if self.detail:
            lines.append(f"  {self.detail}")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"DesyncReport(kind={self.kind!r}, "
            f"detected={self.detected_frame}, "
            f"first_divergent={self.first_divergent_frame})"
        )


def _window_around(
    history: Mapping[int, int], center: int, context: int = _CONTEXT_FRAMES
) -> Dict[int, int]:
    if center == NULL_FRAME:
        return dict(history)
    return {
        f: c for f, c in history.items()
        if center - context <= f <= center + context
    }


def _journal_tail_around(journal, center: int,
                         context: int = _CONTEXT_FRAMES
                         ) -> List[Tuple[int, int]]:
    """(frame, crc32(inputs)) pairs from a journal's in-memory tail
    window around ``center`` — enough to replay-diff the divergence
    without embedding raw input bytes in the report."""
    if journal is None:
        return []
    tail = getattr(journal, "tail", None)
    if not tail:
        return []
    out = []
    for frame, flags, blob in tail:
        if center == NULL_FRAME or center - context <= frame <= center + context:
            out.append((frame, zlib.crc32(bytes(flags) + bytes(blob))))
    return out


def build_desync_report(
    *,
    kind: str = "checksum-compare",
    detected_frame: int,
    addr: Any = None,
    local_checksum: Optional[int] = None,
    remote_checksum: Optional[int] = None,
    local_history: Optional[Mapping[int, int]] = None,
    remote_history: Optional[Mapping[int, int]] = None,
    recorder: Optional[FlightRecorder] = None,
    journal: Any = None,
    tracer: Any = None,
    timeline: Optional[List[Dict[str, Any]]] = None,
    detail: str = "",
) -> DesyncReport:
    """Assemble a :class:`DesyncReport` from whatever forensic sources the
    caller holds; every source is optional and a missing one simply leaves
    its section empty.  ``local_history``/``remote_history`` accept plain
    frame→checksum mappings or :class:`ChecksumHistory` instances."""
    if isinstance(local_history, ChecksumHistory):
        local_history = local_history.items()
    if isinstance(remote_history, ChecksumHistory):
        remote_history = remote_history.items()
    local_history = dict(local_history or {})
    remote_history = dict(remote_history or {})
    first = first_divergent_frame(local_history, remote_history)
    if first == NULL_FRAME and local_checksum is not None:
        # histories too thin to bisect (e.g. the very first report
        # mismatched): the detection frame is the best known bound
        first = detected_frame
    center = first if first != NULL_FRAME else detected_frame
    trace_events: List[Dict[str, Any]] = []
    if tracer is not None and getattr(tracer, "enabled", False):
        trace_events = tracer.chrome_trace()["traceEvents"]
    return DesyncReport(
        kind=kind,
        detected_frame=detected_frame,
        first_divergent=first,
        addr=addr,
        local_checksum=local_checksum,
        remote_checksum=remote_checksum,
        checksum_window={
            "local": _window_around(local_history, center),
            "remote": _window_around(remote_history, center),
        },
        recorder_dump=recorder.dump(32) if recorder is not None else "",
        journal_tail=_journal_tail_around(journal, center),
        trace_events=trace_events,
        timeline=timeline,
        detail=detail,
    )
