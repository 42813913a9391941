"""advance.device_us_per_tick.client: ``advance.device_us_per_tick`` (its reader, unchanged) in a
client's cell, where it moves ``client.resim_frames_per_s``."""

from benchmark.spec import metric_reader


def read(ctx):
    return metric_reader(ctx["cell"], "advance.device_us_per_tick").read(ctx)
