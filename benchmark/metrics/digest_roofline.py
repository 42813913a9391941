"""digest_roofline: the least time of a tick's digests (the B live and
B * d resimulated states read once, 16 B a row written once, at the card's
HBM rate; ``roofline/digest.py``) as a share of the device time of the
traced ticks' digest kernels (launched inside the ticks, found by their
``state_digest`` names), in percent.  Moves ``resim_frames_per_s``."""

import importlib

from benchmark.roofline import digest, peaks


def read(ctx):
    cell, tr = ctx["cell"], ctx["trace"]
    rate = peaks.hbm_bytes_per_s(ctx["kind"])
    kernels = [e for e in tr.launched_in(*tr.window(), "kernel") if "state_digest" in e.name]
    if rate is None or not kernels:
        return None
    us_per_tick = sum(e.end - e.start for e in kernels) / ctx["ticks"]
    game = importlib.import_module(f"benchmark.roofline.{cell.game}")
    rows = digest.rows_per_tick(ctx["sessions"], int(cell.config["check_distance"]))
    bound_us = digest.digest_bytes(rows, game.state_bytes(cell.config)) / rate * 1e6
    return 100.0 * bound_us / us_per_tick
