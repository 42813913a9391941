"""Tracing and logging.

Host-side events log through the ``ggrs_tpu_torch`` logger hierarchy
(``get_logger("fleet")``), as the JAX package's do under ``ggrs_tpu``.
The JAX package wraps device dispatches in ``jax.profiler.TraceAnnotation``;
the port uses ``torch.profiler.record_function``, so the same span names
show up in ``torch.profiler`` traces (Chrome / Perfetto)."""

from __future__ import annotations

import contextlib
import logging
from typing import Iterator

import torch

_ROOT = "ggrs_tpu_torch"


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


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Named range in torch profiler traces; a few microseconds when not
    profiling."""
    with torch.profiler.record_function(name):
        yield
