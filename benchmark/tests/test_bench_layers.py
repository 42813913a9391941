"""The readers of the tick's layers and of the port's tick spans, on
synthetic traces: a graph launch's operations land in the layer of the last
``ggrs_mark_*`` before them and overlaps count once, operations launched
outside the graphs are left out, no mark reads None, the session spans and
the captures are counted inside the ``bench:tick`` window only, and a trace
without the port's spans (a program that has none) reads None."""

import pytest

from benchmark import spec
from benchmark.trace import Op, Trace

CELL = spec.load_cell("boxgame2-d8-b1769472")
CLIENT = spec.load_cell("boxgame2-d8-b1")


def _host(name, start, end, cat="user_annotation"):
    return Op(name, cat, start, end)


def _trace(device, host):
    return Trace(sorted(device, key=lambda e: e.start), sorted(host, key=lambda e: e.start))


def _graph_tick(t0, launch, layers):
    """One graph replay at ``t0`` (device clock): per layer a mark (1 us)
    then its operations, each (start offset, end offset) after the mark."""
    ops, at = [], t0
    for layer, spans in layers:
        ops.append(Op(f"ggrs_mark_{layer}", "kernel", at, at + 1, launch=launch))
        at += 1
        for s, e in spans:
            ops.append(Op("kernel_x", "kernel", at + s, at + e, launch=launch))
        at += max((e for _, e in spans), default=0)
    return ops


def _read(cell, metric, tr, ticks):
    return spec.metric_reader(cell, metric).read({"cell": cell, "trace": tr, "ticks": ticks})


def _two_ticks():
    bench = [_host("bench:tick", 0, 100), _host("bench:tick", 100, 200)]
    launches = [_host("cudaGraphLaunch", 10, 11, "cuda_runtime"),
                _host("cudaGraphLaunch", 110, 111, "cuda_runtime")]
    upload = _host("cudaMemcpyAsync", 5, 6, "cuda_runtime")
    layers = [("ring", [(0, 4)]), ("advance", [(0, 10), (5, 12)]),  # overlap: 12 us, not 17
              ("digest", [(0, 3)]), ("compare", [(0, 2)]), ("ring", [(0, 1)])]
    device = [*_graph_tick(1000, launches[0], layers), *_graph_tick(2000, launches[1], layers),
              Op("memcpy_h2d", "gpu_memcpy", 990, 999, launch=upload),
              Op("reduce_kernel", "kernel", 1060, 1070, launch=upload)]
    host = bench + launches + [upload]
    return device, host


def test_graph_operations_land_in_the_last_marks_layer_and_overlaps_count_once():
    device, host = _two_ticks()
    tr = _trace(device, host)
    got = {m: _read(CELL, f"{m}.device_us_per_tick", tr, 2)
           for m in ("ring", "advance", "digest", "compare")}
    assert got == {"ring": 5.0, "advance": 12.0, "digest": 3.0, "compare": 2.0}
    assert _read(CLIENT, "advance.device_us_per_tick.client", tr, 2) == 12.0
    ops = spec.metric_reader(CELL, "ring.device_us_per_tick").layer_ops(
        {"cell": CELL, "trace": tr, "ticks": 2})
    assert len(ops["mark"]) == 10
    # the eager upload and the reduction launched outside the graph are in no layer
    assert not any(e.name in ("memcpy_h2d", "reduce_kernel") for v in ops.values() for e in v)


def test_no_mark_reads_none():
    device, host = _two_ticks()
    unmarked = [e for e in device if not e.name.startswith("ggrs_mark_")]
    tr = _trace(unmarked, host)
    for m in ("ring", "advance", "digest", "compare"):
        assert _read(CELL, f"{m}.device_us_per_tick", tr, 2) is None
    assert _read(CELL, "ring.device_us_per_tick", _trace([], []), 1) is None


def _spans_trace(captures_at):
    device, host = _two_ticks()
    host += [_host("ggrs:tick", 1, 99), _host("ggrs:tick", 101, 199),
             _host("ggrs:tick.upload", 2, 6), _host("ggrs:tick.upload", 102, 110),
             _host("ggrs:tick.read", 20, 90), _host("ggrs:tick.read", 120, 150),
             _host("ggrs:tick.upload", 300, 400)]  # after the window
    host += [_host("ggrs:graph.capture", t, t + 5) for t in captures_at]
    return _trace(device, host)


def test_session_spans_are_summed_over_the_ticks_inside_the_window():
    tr = _spans_trace([])
    assert _read(CELL, "session.upload_us_per_tick", tr, 2) == 6.0
    assert _read(CELL, "session.read_us_per_tick", tr, 2) == 50.0
    assert _read(CLIENT, "session.read_us_per_tick.client", tr, 2) == 50.0


@pytest.mark.parametrize("at,want", [([], 0.0), ([-50, 250], 0.0), ([30], 0.5), ([30, 150], 1.0)])
def test_captures_are_counted_inside_the_window_only(at, want):
    tr = _spans_trace(at)
    assert _read(CELL, "replay.captures_per_tick", tr, 2) == want
    assert _read(CLIENT, "replay.captures_per_tick.client", tr, 2) == want


def test_a_program_without_the_spans_or_a_run_without_the_card_reads_none():
    device, host = _two_ticks()  # no ggrs: span at all, as the program before them
    tr = _trace(device, host)
    for m in ("session.upload_us_per_tick", "session.read_us_per_tick",
              "replay.captures_per_tick"):
        assert _read(CELL, m, tr, 2) is None
    cpu = _spans_trace([30])
    cpu.device.clear()  # a CPU run: host spans, no device operation
    for m in ("session.upload_us_per_tick", "session.read_us_per_tick",
              "replay.captures_per_tick"):
        assert _read(CELL, m, cpu, 2) is None
