"""``ggrs_tpu_torch.obs``: the port's observability (its copy of
``ggrs_tpu/obs``).

- :mod:`registry`: counters, gauges and fixed-bucket histograms with label
  sets, the port's own process-wide ``default_registry()``, and the
  ``MultiRegistry`` union view the exporters read;
- :mod:`trace`: the span tracer with Chrome/Perfetto trace-event export and
  its schema check;
- :mod:`recorder`: the flight recorder and per-frame checksum windows;
- :mod:`forensics`: first-divergent-frame bisection and ``DesyncReport``;
- :mod:`exporters`: Prometheus text exposition, JSON snapshots and the
  stdlib HTTP endpoint (``/metrics``, ``/healthz``, ``/trace``);
- :mod:`fleet_obs`: the fleet's harvest of shard registries, spans,
  forensics and timelines;
- :mod:`timeline`: match-lifecycle timelines and the 16-byte trace context;
- :mod:`slo`: frame-budget SLO counters and multi-window burn rates.
"""

from .registry import (
    Counter,
    DEFAULT,
    Gauge,
    Histogram,
    MultiRegistry,
    Registry,
    default_registry,
)
from .recorder import ChecksumHistory, FlightRecorder
from .trace import NULL_TRACER, Tracer, validate_chrome_trace
from .forensics import (
    DesyncReport,
    build_desync_report,
    first_divergent_frame,
)
from .exporters import (
    MetricsHTTPServer,
    MetricsServer,
    json_snapshot,
    prometheus_text,
    start_http_server,
    validate_exposition,
)
from .fleet_obs import (
    FleetObs,
    RegistryCollector,
    fleet_metrics_digest,
    histogram_quantile,
)
from .timeline import (
    MatchTimeline,
    TIMELINE_EVENTS,
    TRACE_CTX,
    TRACE_CTX_BYTES,
    TimelineStore,
    first_occurrence_order,
    format_timeline,
    match_trace_id,
    merge_timelines,
    pack_trace_ctx,
    timeline_event,
    unpack_trace_ctx,
)
from .slo import (
    BurnRateEngine,
    ShardSloMeter,
    SloPolicy,
)

__all__ = [
    "BurnRateEngine",
    "ChecksumHistory",
    "Counter",
    "DEFAULT",
    "DesyncReport",
    "FleetObs",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MatchTimeline",
    "MetricsHTTPServer",
    "MetricsServer",
    "MultiRegistry",
    "NULL_TRACER",
    "Registry",
    "RegistryCollector",
    "ShardSloMeter",
    "SloPolicy",
    "TIMELINE_EVENTS",
    "TRACE_CTX",
    "TRACE_CTX_BYTES",
    "TimelineStore",
    "Tracer",
    "build_desync_report",
    "default_registry",
    "first_divergent_frame",
    "first_occurrence_order",
    "fleet_metrics_digest",
    "format_timeline",
    "histogram_quantile",
    "json_snapshot",
    "match_trace_id",
    "merge_timelines",
    "pack_trace_ctx",
    "prometheus_text",
    "start_http_server",
    "timeline_event",
    "unpack_trace_ctx",
    "validate_chrome_trace",
    "validate_exposition",
]
