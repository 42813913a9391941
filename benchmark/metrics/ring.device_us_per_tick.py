"""ring.device_us_per_tick: the device time of the ring's work inside the
traced ticks' CUDA graphs, in microseconds a tick.  Moves
``resim_frames_per_s``.

Also the reader the four layers of the tick share (``layer_us``; the
advance's, the digest's and the compare's readers reach it through
``metric_reader``).  The port launches a mark kernel (``ggrs_mark_<layer>``)
into the tick's graph where each stretch of a layer's work begins, nine a
tick, enabled only while a profiler runs.  The device operations launched
by a ``cudaGraphLaunch`` inside the ``bench:tick`` spans, taken in start
order, each belong to the layer of the last mark before them; a layer's
time is the union of its operations' intervals over the ticks, the marks'
own time left out.  Operations launched outside the graphs (the inputs'
upload, the batch's reduction) belong to no layer.  None where the trace
holds no mark (a program without them, or a run without the card)."""

from typing import Dict, List, Optional

from benchmark.trace import Op, busy_us

MARK = "ggrs_mark_"


def layer_ops(ctx) -> Optional[Dict[str, List[Op]]]:
    """The graph-launched device operations of the traced ticks by layer
    (``"mark"``: the marks themselves); None where there is no mark."""
    tr = ctx["trace"]
    window = tr.window()
    if window is None:
        return None
    out: Dict[str, List[Op]] = {}
    current = None
    for e in tr.launched_in(*window):
        if "GraphLaunch" not in e.launch.name:
            continue
        if e.name.startswith(MARK):
            current = e.name[len(MARK):]
            out.setdefault("mark", []).append(e)
        elif current is not None:
            out.setdefault(current, []).append(e)
    return out if "mark" in out else None


def layer_us(ctx, layer: str) -> Optional[float]:
    ops = layer_ops(ctx)
    if ops is None:
        return None
    return busy_us(ops.get(layer, [])) / ctx["ticks"]


def read(ctx):
    return layer_us(ctx, "ring")
