"""replay.kernels_per_tick: the device kernels launched inside the traced
ticks, over the ticks (copies and fills are not kernels).  None where the
trace holds no kernel (a run without the card); moves
``resim_frames_per_s``."""


def read(ctx):
    tr = ctx["trace"]
    kernels = tr.launched_in(*tr.window(), "kernel")
    if not kernels:
        return None
    return len(kernels) / ctx["ticks"]
