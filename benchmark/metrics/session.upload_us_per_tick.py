"""session.upload_us_per_tick: the host time of the port's
``ggrs:tick.upload`` spans (a call's inputs to the card: the host copies
and the host-to-device copy) inside the traced ticks' ``bench:tick``
spans, summed over the ticks, in microseconds a tick.  Also the reader
``session.read_us_per_tick`` reaches (``span_us``).  None where the trace
holds no device operation (a run without the card) or no such span (a
program without the ``ggrs:tick`` spans).  Moves ``tick_ms_p95``."""

from typing import Optional


def span_us(ctx, name: str) -> Optional[float]:
    tr = ctx["trace"]
    window = tr.window()
    if window is None or not tr.device:
        return None
    lo, hi = window
    spans = [s for s in tr.spans(name) if lo <= s.start <= hi]
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / ctx["ticks"]


def read(ctx):
    return span_us(ctx, "ggrs:tick.upload")
