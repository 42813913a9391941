"""device.idle_share.client: ``device.idle_share`` (its reader, unchanged) in a
client's cell, where it moves ``client.resim_frames_per_s``."""

from benchmark.spec import metric_reader


def read(ctx):
    return metric_reader(ctx["cell"], "device.idle_share").read(ctx)
