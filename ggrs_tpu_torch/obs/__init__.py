"""``ggrs_tpu_torch.obs``: the observability the P2P path counts into (the
port's copy of part of ``ggrs_tpu/obs``).

- :mod:`registry`: counters, gauges and fixed-bucket histograms with label
  sets, and the port's own process-wide ``default_registry()``;
- :mod:`trace`: the span tracer with Chrome/Perfetto trace-event export;
- :mod:`recorder`: the flight recorder and per-frame checksum windows;
- :mod:`forensics`: first-divergent-frame bisection and ``DesyncReport``.
"""

from .forensics import DesyncReport, build_desync_report, first_divergent_frame
from .recorder import ChecksumHistory, FlightRecorder
from .registry import DEFAULT, Counter, Gauge, Histogram, Registry, default_registry
from .trace import NULL_TRACER, Tracer

__all__ = [
    "ChecksumHistory",
    "Counter",
    "DEFAULT",
    "DesyncReport",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "NULL_TRACER",
    "Registry",
    "Tracer",
    "build_desync_report",
    "default_registry",
    "first_divergent_frame",
]
