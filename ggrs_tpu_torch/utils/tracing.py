"""Tracing and logging.

Host-side events log through the ``ggrs_tpu_torch`` logger hierarchy
(``get_logger("fleet")``), as the JAX package's do under ``ggrs_tpu``.
The JAX package wraps device dispatches in ``jax.profiler.TraceAnnotation``;
the port uses ``torch.profiler.record_function``, so the same span names
show up in ``torch.profiler`` traces (Chrome / Perfetto).

``trace_span`` costs one flag read and returns a shared no-op context when
no profiler runs, so spans may be as fine as the layers they name.

``layer(name)`` marks where one layer of the replay's steady tick begins
(``LAYERS``).  Run eagerly it is a ``ggrs:layer.<name>`` span.  While a
``GraphSet`` that takes marks captures the tick (``marking``), it instead
launches the layer's mark kernel (``ggrs_mark_<name>``) into the graph: a
graph replay is one launch, and the marks are how a trace tells its kernels'
layers apart.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _profiler

_ROOT = "ggrs_tpu_torch"

# the steady tick's layers, in the order of their mark kernels'
# ``ggrs_mark`` indices (csrc/digest.cu)
LAYERS = ("ring", "advance", "digest", "compare")
_LAYER_SPANS = {name: f"ggrs:layer.{name}" for name in LAYERS}


def get_logger(name: str = "") -> logging.Logger:
    """Logger under the ``ggrs_tpu_torch`` hierarchy (e.g. ``get_logger("net")``)."""
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def enable_tracing(level: int = logging.DEBUG) -> None:
    """Opt-in console tracing: a stream handler on the package's root logger."""
    logger = get_logger()
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
    logger.setLevel(level)


class _NullSpan:
    """Shared no-op context manager: a span while no profiler runs."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) records now."""
    return _profiler._is_profiler_enabled


def trace_span(name: str):
    """Named range in torch profiler traces (a ``record_function``) while a
    profiler runs; otherwise a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _NULL_SPAN
    return torch.profiler.record_function(name)


_capture = threading.local()


class marking:
    """While in effect on this thread, ``layer`` calls ``sink(name)`` (which
    launches the layer's mark into the graph being captured) in place of a
    span.  ``GraphSet.capture`` puts it around a capture that takes marks."""

    def __init__(self, sink: Callable[[str], None]) -> None:
        self.sink = sink
        self._outer: Optional[Callable[[str], None]] = None

    def __enter__(self) -> "marking":
        self._outer = getattr(_capture, "sink", None)
        _capture.sink = self.sink
        return self

    def __exit__(self, *exc) -> bool:
        _capture.sink = self._outer
        return False


def layer(name: str):
    """The start of layer ``name`` of the replay's steady tick: its mark,
    launched into the graph, while a capture takes marks on this thread
    (``marking``); otherwise a ``ggrs:layer.<name>`` span."""
    span = _LAYER_SPANS.get(name)
    if span is None:
        raise ValueError(f"layer {name!r} is not one of {LAYERS}")
    sink = getattr(_capture, "sink", None)
    if sink is None:
        return trace_span(span)
    sink(name)
    return _NULL_SPAN

