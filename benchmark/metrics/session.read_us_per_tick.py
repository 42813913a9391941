"""session.read_us_per_tick: the host time of the port's ``ggrs:tick.read``
spans (the read of the mismatch count, where a call waits for the card)
inside the traced ticks' ``bench:tick`` spans, summed over the ticks, in
microseconds a tick (``session.upload_us_per_tick``'s ``span_us``).  None
where the trace holds no device operation or no such span.  Moves
``tick_ms_p95``."""

from benchmark.spec import metric_reader


def read(ctx):
    return metric_reader(ctx["cell"], "session.upload_us_per_tick").span_us(ctx, "ggrs:tick.read")
