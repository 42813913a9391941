"""Named ranges for profiler traces.

The JAX package wraps device dispatches in ``jax.profiler.TraceAnnotation``;
the port uses ``torch.profiler.record_function``, so the same span names
show up in ``torch.profiler`` traces (Chrome / Perfetto)."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Named range in torch profiler traces; a few microseconds when not
    profiling."""
    with torch.profiler.record_function(name):
        yield
