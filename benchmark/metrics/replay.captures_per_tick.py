"""replay.captures_per_tick: the port's ``ggrs:graph.capture`` spans (one a
CUDA graph captured) that start inside the traced ticks' ``bench:tick``
spans, over the ticks.  Every graph is captured in warm-up, so a sound run
reads 0; a capture inside the ticks shows as a slow call.  None where the
trace holds no device operation (a run without the card) or no
``ggrs:tick`` span (a program without the span tree).  Moves
``tick_ms_p95``."""


def read(ctx):
    tr = ctx["trace"]
    window = tr.window()
    if window is None or not tr.device or not tr.spans("ggrs:tick"):
        return None
    lo, hi = window
    return sum(lo <= s.start <= hi for s in tr.spans("ggrs:graph.capture")) / ctx["ticks"]
