"""Dependency-free metrics registry: counters, gauges, fixed-bucket
histograms, label sets (the port's copy of ``ggrs_tpu/obs/registry.py``).

- **Near-zero cost when nothing is watching.**  Instruments are plain
  Python attribute adds under the GIL: no locks on the hot path, no
  timestamps, no allocation per increment.  A registry built with
  ``enabled=False`` hands out shared null instruments whose methods are
  no-ops.
- **Observational only.**  Nothing here may perturb session behavior: no
  RNG draws, no clock reads, no socket traffic.
- **No dependencies.**  Pure stdlib.

Instruments follow the Prometheus data model: a *family* has a name, a
type, help text, and a tuple of label names; ``family.labels(k=v, ...)``
returns (creating on first use) the child instrument for one label-value
combination.  A label-free family is itself the instrument.

Process-wide layers (protocol drops, socket send errors, session
rollbacks) register on the module's ``DEFAULT`` registry at import.  It is
the port's own global, separate from the JAX package's.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MultiRegistry",
    "Registry",
    "DEFAULT",
    "default_registry",
]

# histogram default: powers of two — rollback depths, queue lengths, and
# latency-in-ticks all live on this scale
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class Counter:
    """Monotonic counter.  ``inc`` only; decrements are a bug."""

    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self) -> None:
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """A value that can go up and down (slot counts, window occupancy)."""

    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self) -> None:
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = value

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram: per-bucket counts plus sum and count.

    Buckets are upper bounds (a le="+Inf" bucket is implicit); the small
    linear scan beats bisect for the single-digit bucket counts used
    here.
    """

    __slots__ = ("uppers", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.uppers: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts = [0] * (len(self.uppers) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for upper in self.uppers:
            if value <= upper:
                break
            i += 1
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """(upper_bound, cumulative_count) pairs, +Inf last — the
        Prometheus exposition shape."""
        out: List[Tuple[float, int]] = []
        running = 0
        for upper, c in zip(self.uppers, self.counts):
            running += c
            out.append((upper, running))
        out.append((float("inf"), running + self.counts[-1]))
        return out


class _Null:
    """Shared no-op instrument for disabled registries: every method of
    every instrument kind, doing nothing."""

    __slots__ = ()
    kind = "null"
    value = 0.0
    sum = 0.0
    count = 0
    uppers: Tuple[float, ...] = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def labels(self, **label_values) -> "_Null":
        return self

    def cumulative(self) -> List[Tuple[float, int]]:
        return []


_NULL = _Null()


class Family:
    """One named metric: its type, help text, label names, and the child
    instrument per label-value combination.  A label-free family proxies
    the single default child so ``registry.counter("x").inc()`` works."""

    __slots__ = ("name", "kind", "help", "labelnames", "children", "_ctor",
                 "_default", "_lock")

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Tuple[str, ...], ctor, lock) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = labelnames
        self.children: Dict[Tuple[str, ...], object] = {}
        self._ctor = ctor
        self._lock = lock  # the owning registry's creation lock
        self._default = None
        if not labelnames:
            self._default = ctor()
            self.children[()] = self._default

    def labels(self, **label_values):
        if set(label_values) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {sorted(label_values)}"
            )
        values = tuple(str(label_values[n]) for n in self.labelnames)
        child = self.children.get(values)
        if child is None:
            # lock only the first touch of a label set: two threads racing
            # here must not each build a child (increments on the loser
            # would vanish); steady-state lookups stay lock-free
            with self._lock:
                child = self.children.get(values)
                if child is None:
                    child = self._ctor()
                    self.children[values] = child
        return child

    # label-free convenience: the family is the instrument
    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    def set(self, value: float) -> None:
        self._default.set(value)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    @property
    def value(self) -> float:
        return self._default.value

    @property
    def count(self) -> int:
        return self._default.count

    @property
    def sum(self) -> float:
        return self._default.sum

    def cumulative(self) -> List[Tuple[float, int]]:
        return self._default.cumulative()

    def samples(self) -> Iterable[Tuple[Dict[str, str], object]]:
        for values, child in self.children.items():
            yield dict(zip(self.labelnames, values)), child


class Registry:
    """A metric namespace.  Instrument factories are idempotent: asking
    for an existing name returns the existing family (the kind and label
    names must match, else ``ValueError`` — two call sites disagreeing
    about a metric is a bug worth failing loudly on).

    Threading: creation (families and first-touch label children) is
    lock-guarded; increments deliberately take no lock — ``+=`` spans
    bytecodes, so concurrent writers to the SAME instrument from several
    threads can rarely lose an increment (never corrupt state).  Sessions
    and pools are single-threaded by contract, so each instrument has one
    writer in practice; reads from other threads (exporters) are always
    safe.  ``Registry(enabled=False)`` returns shared null instruments
    from every factory — the off switch for the bit-identical-wire-bytes
    comparisons and for cost-averse callers.
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # instrument factories
    # ------------------------------------------------------------------

    def _family(self, name: str, kind: str, help: str,
                labels: Sequence[str], ctor) -> Family:
        labelnames = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames}; asked for {kind} "
                        f"with {labelnames}"
                    )
                return fam
            fam = Family(name, kind, help, labelnames, ctor, self._lock)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()):
        if not self.enabled:
            return _NULL
        return self._family(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()):
        if not self.enabled:
            return _NULL
        return self._family(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  labels: Sequence[str] = ()):
        if not self.enabled:
            return _NULL
        return self._family(
            name, "histogram", help, labels,
            lambda b=tuple(buckets): Histogram(b),
        )

    # ------------------------------------------------------------------
    # reads (exporters, tests, scripts)
    # ------------------------------------------------------------------

    def families(self) -> List[Family]:
        with self._lock:
            return list(self._families.values())

    def value(self, name: str, **label_values) -> Optional[float]:
        """One sample's value, or None when the metric or label set was
        never touched (convenience for tests and summaries — histograms
        report their count)."""
        fam = self._families.get(name)
        if fam is None:
            return None
        values = tuple(str(label_values[n]) for n in fam.labelnames
                       if n in label_values)
        if len(values) != len(fam.labelnames):
            return None
        child = fam.children.get(values)
        if child is None:
            return None
        if fam.kind == "histogram":
            return float(child.count)
        return child.value


class MultiRegistry:
    """A read-only union view over several registries, for the exporters.

    The fleet observability plane keeps harvested runner
    metrics in a registry of their own — the same family NAME can then
    carry different label sets locally vs merged (e.g. an unlabeled local
    ``ggrs_pool_ticks_total`` beside the harvested
    ``ggrs_pool_ticks_total{shard,backend}``) without tripping the
    single-registry shape check.  The exporters group families by name,
    so one ``/metrics`` scrape serves the union; writes still go to the
    underlying registries (this view has no factories on purpose).
    """

    __slots__ = ("registries",)

    def __init__(self, *registries) -> None:
        self.registries = tuple(r for r in registries if r is not None)

    def families(self) -> List[Family]:
        out: List[Family] = []
        for reg in self.registries:
            out.extend(reg.families())
        return out

    def value(self, name: str, **label_values) -> Optional[float]:
        for reg in self.registries:
            v = reg.value(name, **label_values)
            if v is not None:
                return v
        return None


# The process-wide registry: cross-cutting layers (protocol, sockets,
# sessions) bind their instruments here at import.
DEFAULT = Registry()


def default_registry() -> Registry:
    return DEFAULT
