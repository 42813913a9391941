"""compare.device_us_per_tick: the device time of the compare inside the traced
ticks' CUDA graphs (each resimulated digest against the first one seen, and
the counts it updates), in microseconds a tick, by the layer marks
(``ring.device_us_per_tick``'s ``layer_us``). None where the trace holds no
mark.  Moves ``resim_frames_per_s``."""

from benchmark.spec import metric_reader


def read(ctx):
    return metric_reader(ctx["cell"], "ring.device_us_per_tick").layer_us(ctx, "compare")
