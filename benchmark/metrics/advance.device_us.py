"""advance.device_us: the device time of one batched advance of the game at
the cell's session count, called alone after warm-up (the
``bench:advance`` spans, each ending in a synchronise): the union of the
intervals of the device operations launched inside the span, the mean over
the calls, in microseconds.  Moves ``resim_frames_per_s``."""

from benchmark.trace import busy_us


def device_us(ctx):
    tr = ctx["trace"]
    per_call = [busy_us(tr.launched_in(s.start, s.end)) for s in tr.spans("bench:advance")]
    if not per_call or min(per_call) <= 0:
        return None
    return sum(per_call) / len(per_call)


def read(ctx):
    return device_us(ctx)
