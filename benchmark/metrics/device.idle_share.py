"""device.idle_share: 1 - the card's busy time a tick over the measured
window's wall time a tick.  The busy time is ``device.busy_ms_per_tick``'s
(the union of the device operations' intervals in the traced ticks); the
wall time is the window's own, on the host clock with no tracer running
(window seconds over the ticks it completed), because the device tracer
adds some microseconds of host time to each node of a graph's launch,
during which the card waits.  So it is the share of the end-to-end
window's time in which the card sat idle, with the busy time taken from
the trace.  None where the trace holds no device operation; moves
``resim_frames_per_s``."""

from benchmark.spec import metric_reader


def read(ctx):
    busy_ms = metric_reader(ctx["cell"], "device.busy_ms_per_tick").read(ctx)
    if busy_ms is None:
        return None
    return 1.0 - busy_ms / ctx["window_ms_per_tick"]
