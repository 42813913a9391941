"""Fleet-wide observability plane: runner telemetry harvest over RPC,
cross-process trace correlation, and the forensics ferry (DESIGN.md §18).

The port's copy of ``ggrs_tpu/obs/fleet_obs.py``.

The registry and tracer make a *single process* fully observable; the
process fleet grows the system into a multi-process fleet where each subprocess runner builds a private
``Registry`` that used to die with the child.  This module is the seam
that makes the whole fleet observable from one endpoint:

- :class:`RegistryCollector` — the RUNNER side: walks a local registry
  (or several) and emits a **delta-encoded snapshot** — counters as
  monotonic deltas, gauges by value, histograms by per-bucket deltas —
  containing only the samples that changed since the last collect.  The
  snapshot piggybacks on the existing heartbeat/tick RPC replies, so the
  harvest adds ZERO extra round trips.
- :class:`FleetObs` — the SUPERVISOR side: merges snapshots into a
  dedicated ``harvest`` registry under a ``shard=<id>,backend=proc``
  label set (labels the runner already carries are kept; ``shard`` is
  overridden with the supervisor's id so one scrape is unambiguous),
  re-emits runner trace spans into the supervisor's tracer with an
  RTT-estimated clock offset, aggregates span durations into a
  ``ggrs_fleet_span_seconds{shard,name}`` histogram (the per-phase p99
  data ``scripts/fleet_top.py`` renders), and keeps a bounded ring of
  ferried forensics (flight-recorder dumps, DesyncReports) that would
  otherwise die with the child.

Merge semantics (pinned by tests/test_fleet_obs.py):

- **idempotent** — every snapshot carries ``(gen, seq)``; ``gen`` is the
  runner incarnation (its pid), ``seq`` a per-incarnation monotonic
  counter.  A re-delivered snapshot (same gen, seq <= last applied) is
  dropped, so double delivery can never double-count a counter delta.
- **restart-safe** — a new incarnation's ``gen`` differs; its deltas are
  relative to a fresh registry, so merged counters simply keep growing
  monotonically across restarts (federation semantics, no reset dip).
- **loss-tolerant** — a lost reply loses at most one interval's deltas;
  gauges self-heal on the next snapshot, counters under-count by the
  lost interval, which the ``ggrs_fleet_obs_snapshot_gaps_total``
  counter makes visible.

Like the rest of ``ggrs_tpu_torch.obs``, everything here is observational
only: merging never drives a shard, collection never perturbs session
behavior, and a disabled harvest (``FleetTuning.obs_harvest=0``)
compiles the runner side out entirely.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from .registry import Registry
from .timeline import TimelineStore, timeline_ring_events
from .trace import NULL_TRACER

__all__ = [
    "RegistryCollector",
    "FleetObs",
    "histogram_quantile",
    "fleet_metrics_digest",
]

SNAPSHOT_VERSION = 1

# span-duration aggregation buckets (seconds): sub-ms resolution for the
# in-crossing phases, stretching to the 16.7 ms tick budget and beyond
SPAN_SECONDS_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
    0.0167, 0.05, 0.25, 1.0,
)

# cardinality clamp: at most this many distinct span names aggregate per
# shard; the long tail lands in name="other" (no unbounded label values)
MAX_SPAN_NAMES_PER_SHARD = 24

# the supervisor keeps at most this many ferried forensic records
MAX_FORENSICS = 64


class RegistryCollector:
    """Delta-encoded snapshots of one or more local registries.

    Single-threaded like its caller (the shard runner's serving loop):
    ``collect()`` walks every family, emits only samples whose value
    moved since the previous collect, and advances its baseline.  The
    first collect is therefore a full snapshot (every touched sample's
    delta from zero), which is exactly what a fresh incarnation should
    send.
    """

    def __init__(self, *registries: Registry, gen: int = 0) -> None:
        self._registries = [r for r in registries if r is not None]
        self.gen = gen
        self.seq = 0
        # (registry idx, family name, label values) -> baseline
        self._counters: Dict[Tuple, float] = {}
        self._gauges: Dict[Tuple, float] = {}
        self._hists: Dict[Tuple, Tuple[Tuple[int, ...], float, int]] = {}

    def collect(self) -> Optional[Dict[str, Any]]:
        """The changes since the last collect as a snapshot dict, or
        ``None`` when nothing moved (the caller then skips the payload
        entirely — an idle shard costs nothing on the wire)."""
        families: List[Dict[str, Any]] = []
        for ridx, reg in enumerate(self._registries):
            for fam in reg.families():
                samples: List[Tuple[Tuple[str, ...], Any]] = []
                for labels, child in list(fam.children.items()):
                    key = (ridx, fam.name, labels)
                    if fam.kind == "counter":
                        v = child.value
                        delta = v - self._counters.get(key, 0.0)
                        if delta:
                            self._counters[key] = v
                            samples.append((labels, delta))
                    elif fam.kind == "gauge":
                        v = child.value
                        if key not in self._gauges or self._gauges[key] != v:
                            self._gauges[key] = v
                            samples.append((labels, v))
                    elif fam.kind == "histogram":
                        counts = tuple(child.counts)
                        s, c = child.sum, child.count
                        last = self._hists.get(
                            key, ((0,) * len(counts), 0.0, 0)
                        )
                        if c != last[2] or counts != last[0]:
                            self._hists[key] = (counts, s, c)
                            samples.append((labels, [
                                [a - b for a, b in zip(counts, last[0])],
                                s - last[1], c - last[2],
                            ]))
                if samples:
                    entry: Dict[str, Any] = dict(
                        name=fam.name, kind=fam.kind, help=fam.help,
                        labels=list(fam.labelnames), samples=samples,
                    )
                    if fam.kind == "histogram":
                        entry["uppers"] = list(
                            next(iter(fam.children.values())).uppers
                        )
                    families.append(entry)
        if not families:
            return None
        self.seq += 1
        return dict(v=SNAPSHOT_VERSION, gen=self.gen, seq=self.seq,
                    families=families)


class FleetObs:
    """The supervisor-side sink: snapshot merge, span re-emission, and
    the forensics ring.  One instance per supervisor, shared by its
    :class:`~ggrs_tpu_torch.fleet.proc.ProcShard` proxies; a standalone
    ``ProcShard`` builds its own.

    ``harvest`` is a dedicated registry — merged runner families keep
    their own names/labels plus ``shard``/``backend``, and live beside
    (never colliding with) the supervisor's local instruments; the
    exporters serve both through one
    :class:`~ggrs_tpu_torch.obs.registry.MultiRegistry` view
    (``ShardSupervisor.merged_registry()``).
    """

    def __init__(self, metrics: Optional[Registry] = None, tracer=None,
                 harvest: Optional[Registry] = None,
                 max_forensics: int = MAX_FORENSICS) -> None:
        self.harvest = harvest if harvest is not None else Registry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.forensics: Deque[Dict[str, Any]] = deque(maxlen=max_forensics)
        # per-match lifecycle timelines (§28): local events recorded by
        # the supervisor + remote events ferried over the same payloads
        # that carry metrics/spans/forensics, clock-offset corrected
        self.timelines = TimelineStore()
        self._applied: Dict[str, Tuple[int, int]] = {}  # shard -> (gen, seq)
        self._span_names: Dict[str, set] = {}           # shard -> names seen
        m = metrics if metrics is not None else Registry(enabled=False)
        self._m_snapshots = m.counter(
            "ggrs_fleet_obs_snapshots_total",
            "runner metric snapshots merged into the fleet harvest",
            labels=("shard",))
        self._m_dups = m.counter(
            "ggrs_fleet_obs_snapshot_dups_total",
            "re-delivered snapshots dropped by the (gen, seq) dedup",
            labels=("shard",))
        self._m_gaps = m.counter(
            "ggrs_fleet_obs_snapshot_gaps_total",
            "sequence gaps observed in a runner's snapshot stream "
            "(an interval of counter deltas was lost)", labels=("shard",))
        self._m_dropped = m.counter(
            "ggrs_fleet_obs_samples_dropped_total",
            "merged samples refused (family shape conflict)",
            labels=("shard", "reason"))
        self._m_spans = m.counter(
            "ggrs_fleet_obs_spans_total",
            "runner trace spans re-emitted into the supervisor tracer",
            labels=("shard",))
        self._m_forensics = m.counter(
            "ggrs_fleet_obs_forensics_total",
            "forensic records (flight dumps, desync reports) ferried "
            "from shards", labels=("shard", "kind"))
        self._m_timeline = m.counter(
            "ggrs_fleet_obs_timeline_events_total",
            "match-lifecycle timeline events merged into the fleet view",
            labels=("shard",))
        self._h_span = self.harvest.histogram(
            "ggrs_fleet_span_seconds",
            "fleet-wide span durations harvested from shard trace rings",
            buckets=SPAN_SECONDS_BUCKETS, labels=("shard", "name"))

    # ------------------------------------------------------------------
    # ingestion (one call per RPC reply / heartbeat payload)
    # ------------------------------------------------------------------

    def ingest(self, shard: str, payload: Optional[Dict[str, Any]], *,
               backend: str = "proc", offset_ns: int = 0) -> None:
        """Fold one piggybacked obs payload (``{"metrics":..,
        "spans":.., "forensics":..}`` — every key optional) into the
        fleet view.  Never raises: a malformed payload must not take the
        serving path down."""
        if not payload:
            return
        # each section fails independently: a malformed span tuple must
        # not discard the forensics ferried in the same payload
        for section, fold in (
            # metrics may be one snapshot or an ordered list (a runner
            # re-sending a previously unsent snapshot before the fresh
            # one — seq order preserved, the dedup handles the rest)
            ("metrics", lambda v: [
                self.merge_snapshot(shard, s, backend=backend)
                for s in (v if isinstance(v, list) else [v])
            ]),
            ("spans", lambda v: self.ingest_spans(
                shard, v, offset_ns=offset_ns)),
            ("forensics", lambda v: self.ingest_forensics(shard, v)),
            ("timeline", lambda v: self.ingest_timeline(
                shard, v, offset_ns=offset_ns)),
        ):
            value = payload.get(section) if isinstance(payload, dict) \
                else None
            if not value:
                continue
            try:
                fold(value)
            except Exception:
                self._m_dropped.labels(shard=str(shard),
                                       reason="ingest-error").inc()

    # ------------------------------------------------------------------
    # metric snapshot merge
    # ------------------------------------------------------------------

    def merge_snapshot(self, shard: str, snap: Dict[str, Any], *,
                       backend: str = "proc") -> bool:
        """Merge one delta snapshot under ``shard``/``backend`` labels.
        Returns False when the snapshot was a duplicate (idempotency)."""
        shard = str(shard)
        gen = int(snap.get("gen", 0))
        seq = int(snap.get("seq", 0))
        last = self._applied.get(shard)
        if last is not None and last[0] == gen:
            if seq <= last[1]:
                self._m_dups.labels(shard=shard).inc()
                return False
            if seq != last[1] + 1:
                self._m_gaps.labels(shard=shard).inc()
        elif seq != 1:
            # first snapshot seen from this (shard, gen) is not the
            # incarnation's first collect: the earlier ones were lost in
            # transit (e.g. a discarded first tick reply) — the startup
            # window is where losses are most likely, count it
            self._m_gaps.labels(shard=shard).inc()
        self._applied[shard] = (gen, seq)
        for fam in snap.get("families", ()):
            self._merge_family(shard, backend, fam)
        self._m_snapshots.labels(shard=shard).inc()
        return True

    def _merge_family(self, shard: str, backend: str,
                      fam: Dict[str, Any]) -> None:
        name = fam["name"]
        kind = fam["kind"]
        labelnames = list(fam.get("labels", ()))
        merged_names = list(labelnames)
        for extra in ("shard", "backend"):
            if extra not in merged_names:
                merged_names.append(extra)
        help_ = fam.get("help", "")
        try:
            if kind == "counter":
                family = self.harvest.counter(name, help_,
                                              labels=merged_names)
            elif kind == "gauge":
                family = self.harvest.gauge(name, help_,
                                            labels=merged_names)
            elif kind == "histogram":
                family = self.harvest.histogram(
                    name, help_, buckets=tuple(fam.get("uppers", ())),
                    labels=merged_names)
            else:
                self._m_dropped.labels(shard=shard, reason="kind").inc()
                return
        except ValueError:
            # two shards (or a shard and an earlier merge) disagree about
            # the family's shape: refuse loudly rather than corrupt
            self._m_dropped.labels(shard=shard, reason="conflict").inc()
            return
        for values, payload in fam.get("samples", ()):
            lv = dict(zip(labelnames, values))
            lv["shard"] = shard
            lv["backend"] = backend
            try:
                child = family.labels(**lv)
            except ValueError:
                self._m_dropped.labels(shard=shard, reason="labels").inc()
                continue
            if kind == "counter":
                child.inc(float(payload))
            elif kind == "gauge":
                child.set(float(payload))
            else:
                deltas, dsum, dcount = payload
                if len(deltas) != len(child.counts):
                    self._m_dropped.labels(shard=shard,
                                           reason="buckets").inc()
                    continue
                for i, d in enumerate(deltas):
                    child.counts[i] += d
                child.sum += dsum
                child.count += dcount

    # ------------------------------------------------------------------
    # cross-process traces
    # ------------------------------------------------------------------

    def ingest_spans(self, shard: str, events: List[Tuple], *,
                     offset_ns: int = 0) -> int:
        """Re-emit a runner's shipped span ring into the supervisor's
        tracer (start times shifted by the RTT-estimated clock offset so
        they nest inside the supervisor's fleet-tick span) and fold the
        durations into ``ggrs_fleet_span_seconds{shard,name}``."""
        shard = str(shard)
        n = self.tracer.import_spans(
            events, offset_ns=offset_ns, extra_args={"shard": shard},
        )
        if n:
            self._m_spans.labels(shard=shard).inc(n)
        names = self._span_names.setdefault(shard, set())
        for ev in events:
            try:
                ph, name, _cat, _t0, dur_ns = ev[:5]
                dur_ns = int(dur_ns)
                name = str(name)
            except Exception:
                continue  # malformed entry: skip, never raise
            if ph != "X":
                continue
            if name not in names:
                if len(names) >= MAX_SPAN_NAMES_PER_SHARD:
                    name = "other"
                else:
                    names.add(name)
            self._h_span.labels(shard=shard, name=name).observe(
                dur_ns / 1e9
            )
        return n

    # ------------------------------------------------------------------
    # forensics ferry
    # ------------------------------------------------------------------

    def ingest_forensics(self, shard: str,
                         items: List[Dict[str, Any]]) -> None:
        """Stash ferried forensic records (bounded ring) and mark each
        arrival on the tracer — the dump now outlives the child that
        produced it."""
        shard = str(shard)
        for item in items:
            if not isinstance(item, dict):
                continue
            record = dict(item)
            record["shard"] = shard
            record.setdefault("received_at", time.time())
            self.forensics.append(record)
            kind = str(record.get("kind", "unknown"))
            self._m_forensics.labels(shard=shard, kind=kind).inc()
            self.tracer.add_instant(
                "fleet.forensic", cat="fleet", shard=shard, kind=kind,
                match=record.get("match"),
            )

    def drain_forensics(self) -> List[Dict[str, Any]]:
        out = list(self.forensics)
        self.forensics.clear()
        return out

    # ------------------------------------------------------------------
    # match-lifecycle timelines (§28)
    # ------------------------------------------------------------------

    def ingest_timeline(self, shard: str, events: List[Dict[str, Any]],
                        *, offset_ns: int = 0) -> int:
        """Fold ferried timeline events into the per-match store (clock
        offset applied, like spans) and re-emit each as a Perfetto
        instant on the supervisor tracer — the cross-host causal view
        drops out of the existing ``chrome_trace`` export."""
        shard = str(shard)
        n = self.timelines.ingest(events, offset_ns=offset_ns)
        if n:
            self._m_timeline.labels(shard=shard).inc(n)
            self.tracer.import_spans(
                timeline_ring_events(events), offset_ns=offset_ns,
                extra_args={"shard": shard},
            )
        return n

    def record_timeline(self, etype: str, match_id: str,
                        **kw: Any) -> Dict[str, Any]:
        """A LOCAL (supervisor-side) timeline emission: stored, and
        re-emitted as a tracer instant in the local clock domain."""
        ev = self.timelines.record(etype, match_id, **kw)
        self.tracer.import_spans(timeline_ring_events([ev]))
        return ev


# ----------------------------------------------------------------------
# read-side helpers (fleet_top, chaos artifacts)
# ----------------------------------------------------------------------


def histogram_quantile(q: float, uppers, cumcounts) -> Optional[float]:
    """Prometheus-style quantile estimate from cumulative bucket counts
    (``uppers`` excludes +Inf; ``cumcounts`` includes it as last entry).
    Linear interpolation within the chosen bucket; the +Inf bucket
    answers with the largest finite upper bound."""
    if not cumcounts:
        return None
    total = cumcounts[-1]
    if total <= 0:
        return None
    rank = q * total
    prev_upper, prev_cum = 0.0, 0
    for upper, cum in zip(uppers, cumcounts):
        if cum >= rank:
            if cum == prev_cum:
                return upper
            return prev_upper + (upper - prev_upper) * (
                (rank - prev_cum) / (cum - prev_cum)
            )
        prev_upper, prev_cum = upper, cum
    return uppers[-1] if uppers else None


def fleet_metrics_digest(supervisor) -> Dict[str, Any]:
    """A compact JSON-safe digest of the merged fleet view — embedded in
    ``scripts/chaos.py`` artifacts so a CI run records what the harvest
    saw: series counts, harvest-plane health, and the headline per-shard
    counters."""
    merged = supervisor.merged_registry()
    obs = supervisor.fleet_obs
    series = 0
    by_family: Dict[str, int] = {}
    for fam in merged.families():
        n = len(fam.children)
        series += n
        by_family[fam.name] = by_family.get(fam.name, 0) + n
    reg = supervisor.metrics

    def _sum(name: str) -> float:
        total = 0.0
        for fam in reg.families():
            if fam.name != name:
                continue
            for _labels, child in fam.samples():
                total += child.value
        return total

    return dict(
        series=series,
        families=len(by_family),
        top_families=dict(sorted(by_family.items(),
                                 key=lambda kv: -kv[1])[:10]),
        snapshots_merged=_sum("ggrs_fleet_obs_snapshots_total"),
        snapshot_dups=_sum("ggrs_fleet_obs_snapshot_dups_total"),
        snapshot_gaps=_sum("ggrs_fleet_obs_snapshot_gaps_total"),
        samples_dropped=_sum("ggrs_fleet_obs_samples_dropped_total"),
        spans_reemitted=_sum("ggrs_fleet_obs_spans_total"),
        forensics_ferried=_sum("ggrs_fleet_obs_forensics_total"),
        forensics_pending=len(obs.forensics),
        timeline_events_merged=_sum(
            "ggrs_fleet_obs_timeline_events_total"),
        timeline_matches=len(obs.timelines),
    )
