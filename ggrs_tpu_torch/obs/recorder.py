"""Flight recorder: a bounded ring of recent events, plus the per-frame
checksum windows that desync forensics bisect (the port's copy of
``ggrs_tpu/obs/recorder.py``).

Events are ``(tick, kind, detail)`` triples.  ``detail`` is usually a
short pre-formatted string; hot-path events may pass a small tuple of
scalars, which ``dump`` formats lazily.  The recorder never holds
references into live session state, so a dump is safe to keep after the
session is gone.  Recording is observational only and never perturbs
session behavior.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Tuple

__all__ = ["ChecksumHistory", "FlightRecorder", "EV_STATE", "EV_FAULT",
           "EV_ROLLBACK", "EV_WIRE", "EV_EVICT", "EV_DESYNC"]

# event kinds (free-form strings are allowed too; these are the ones the
# pool emits and the chaos summaries group by)
EV_STATE = "state"        # supervision transition (native -> quarantined...)
EV_FAULT = "fault"        # a SlotFault landed
EV_ROLLBACK = "rollback"  # the slot executed a rollback (load op)
EV_WIRE = "wire"          # outbound datagram digest (crc32, length)
EV_EVICT = "evict"        # eviction attempt / outcome
EV_DESYNC = "desync"      # a checksum mismatch / desync-class fault landed


class ChecksumHistory:
    """Bounded per-frame checksum window (desync forensics).

    The reference's desync detection compares one frame at a time and
    forgets; the first-divergent-frame bisection needs a *window* of
    recent (frame, checksum) pairs from both ends.  This is that window:
    a dict bounded to the newest ``capacity`` distinct frames.
    """

    __slots__ = ("_map", "_order", "capacity")

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = capacity
        self._map: Dict[int, int] = {}
        self._order: Deque[int] = deque()

    def record(self, frame: int, checksum: int) -> None:
        if frame not in self._map:
            self._order.append(frame)
            while len(self._order) > self.capacity:
                self._map.pop(self._order.popleft(), None)
        self._map[frame] = checksum

    def get(self, frame: int):
        return self._map.get(frame)

    def items(self) -> Dict[int, int]:
        """A snapshot copy, safe to keep after the session is gone."""
        return dict(self._map)

    def frames(self) -> List[int]:
        return sorted(self._map)

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, frame: int) -> bool:
        return frame in self._map


class FlightRecorder:
    """Bounded event ring for one session."""

    __slots__ = ("_ring", "recorded", "checksums", "remote_checksums")

    def __init__(self, capacity: int = 256,
                 checksum_window: int = 256) -> None:
        self._ring: Deque[Tuple[int, str, Any]] = deque(maxlen=capacity)
        self.recorded = 0  # total ever recorded (ring drops the oldest)
        # desync forensics: the local per-frame checksum
        # window plus one window per remote peer, fed from the desync
        # detection interval traffic — the bisection inputs
        self.checksums = ChecksumHistory(checksum_window)
        self.remote_checksums: Dict[Any, ChecksumHistory] = {}

    def record_checksum(self, frame: int, checksum: int,
                        addr: Any = None) -> None:
        """Record one per-frame checksum: local when ``addr`` is None,
        else into the peer's window."""
        if addr is None:
            self.checksums.record(frame, checksum)
        else:
            hist = self.remote_checksums.get(addr)
            if hist is None:
                hist = ChecksumHistory(self.checksums.capacity)
                self.remote_checksums[addr] = hist
            hist.record(frame, checksum)

    def record(self, tick: int, kind: str, detail: Any = "") -> None:
        self._ring.append((tick, kind, detail))
        self.recorded += 1

    def events(self, last: int = 0) -> List[Tuple[int, str, Any]]:
        """The retained events, oldest first; ``last`` > 0 keeps only the
        newest ``last``."""
        out = list(self._ring)
        if last > 0:
            out = out[-last:]
        return out

    def dump(self, last: int = 32) -> str:
        """Human-readable dump of the newest ``last`` events: the
        post-mortem a desync report carries."""
        events = self.events(last)
        if not events:
            return "  (no recorded events)"
        dropped = self.recorded - len(self._ring)
        lines = []
        if len(events) < self.recorded:
            lines.append(
                f"  ... {self.recorded - len(events)} earlier events "
                f"({dropped} beyond ring capacity)"
            )
        for tick, kind, detail in events:
            if kind == EV_WIRE and isinstance(detail, tuple):
                ep, length, crc = detail
                detail = f"ep={ep} len={length}B crc={crc:08x}"
            lines.append(f"  t{tick:06d} {kind:<9s} {detail}")
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self._ring)
