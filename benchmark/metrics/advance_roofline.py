"""advance_roofline: the least time one advance could take (its bytes from
``roofline/<game>.py`` at the card's HBM rate) as a share of
``advance.device_us``, in percent.  The bound counts bytes alone; for
EcsWorld's contact pass, bound by int32 operations without a published
peak, it is a yardstick that a fused kernel raises, not the chip's limit.
Moves ``resim_frames_per_s``."""

import importlib

from benchmark.roofline import peaks
from benchmark.spec import metric_reader


def read(ctx):
    cell = ctx["cell"]
    rate = peaks.hbm_bytes_per_s(ctx["kind"])
    us = metric_reader(cell, "advance.device_us").device_us(ctx)
    if rate is None or us is None:
        return None
    game = importlib.import_module(f"benchmark.roofline.{cell.game}")
    bound_us = game.advance_bytes(cell.config, ctx["sessions"]) / rate * 1e6
    return 100.0 * bound_us / us
