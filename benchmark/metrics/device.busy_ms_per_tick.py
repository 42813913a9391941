"""device.busy_ms_per_tick: the union of the intervals of the device
operations launched inside the traced ticks, over the ticks, in
milliseconds.  None where the trace holds no device operation; moves
``resim_frames_per_s``."""

from benchmark.trace import busy_us


def read(ctx):
    tr = ctx["trace"]
    busy = busy_us(tr.launched_in(*tr.window()))
    if busy <= 0:
        return None
    return busy / 1e3 / ctx["ticks"]
