"""replay.captures_per_tick.client: ``replay.captures_per_tick`` (its reader, unchanged) in a
client's cell, where it moves ``client.tick_ms_p95``."""

from benchmark.spec import metric_reader


def read(ctx):
    return metric_reader(ctx["cell"], "replay.captures_per_tick").read(ctx)
