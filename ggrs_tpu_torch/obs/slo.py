"""Frame-budget SLOs and multi-window burn rates (DESIGN.md §28).

The port's copy of ``ggrs_tpu/obs/slo.py``.

The 16.7 ms frame budget is the acceptance metric of every benchmark,
but until §28 nothing tracked budget COMPLIANCE at serve time.  This
module closes that gap in two halves, split the same way the harvest
plane is (§18):

- **shard side** (:class:`ShardSloMeter`): per-tick budget-compliance
  counters — ``ggrs_slo_ticks_total{tier}`` /
  ``ggrs_slo_breaches_total{tier}`` — fed from measurements the tick
  already makes (the shard's wall-clock tick timer over the native
  phase timers; the lockstep tier's confirmed-lag from its
  Python-resident sessions).  The counters ride the EXISTING registry
  harvest: zero extra RPC round trips, zero extra ctypes crossings.
- **supervisor side** (:class:`BurnRateEngine`): windowed burn rates
  over the merged counters.  Burn rate = (windowed error rate) /
  (error budget); a burn of 1.0 exactly spends the budget at the
  target, 14.4 spends a month's 99.9% budget in ~5 m.  Two windows on
  the FLEET clock (ticks, not wall time — deterministic under test and
  under chaos clock control) must BOTH burn hot before escalation, the
  classic multi-window guard against paging on a blip.

Escalation is wired into the existing health plane: a ``critical``
verdict flips ``supervisor.healthz()["ok"]`` to False, which the
``MetricsServer`` dict-health path already answers with a 503 — the
SLO plane pages through the door the fleet already watches.  These burn
rates are the designated autoscaling trigger input.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "TIER_ROLLBACK", "TIER_LOCKSTEP", "SLO_TIERS",
    "LEVEL_OK", "LEVEL_WARN", "LEVEL_CRITICAL", "SLO_LEVELS",
    "SloPolicy", "ShardSloMeter", "BurnRateEngine",
]

TIER_ROLLBACK = "rollback"
TIER_LOCKSTEP = "lockstep"
SLO_TIERS = (TIER_ROLLBACK, TIER_LOCKSTEP)

LEVEL_OK = "ok"
LEVEL_WARN = "warn"
LEVEL_CRITICAL = "critical"
SLO_LEVELS = (LEVEL_OK, LEVEL_WARN, LEVEL_CRITICAL)
_LEVEL_RANK = {LEVEL_OK: 0, LEVEL_WARN: 1, LEVEL_CRITICAL: 2}


class SloPolicy:
    """Per-tier targets and burn thresholds.

    - rollback tier: a tick is compliant when it lands inside the frame
      budget (default 16.7 ms — one 60 Hz frame);
    - lockstep tier: a tick is compliant when the worst confirmed-lag
      across lockstep slots stays within ``lockstep_lag_frames``
      (a lockstep session's only latency observable — it never
      predicts, it waits);
    - ``windows`` are (name, fleet-ticks) pairs, defaults sized for
      5 m / 1 h at 60 Hz.  Both must burn past a threshold to change
      the verdict.
    """

    __slots__ = ("rollback_budget_ms", "lockstep_lag_frames", "target",
                 "windows", "warn_burn", "critical_burn")

    def __init__(
        self,
        rollback_budget_ms: float = 16.7,
        lockstep_lag_frames: int = 4,
        target: float = 0.999,
        windows: Tuple[Tuple[str, int], ...] = (("5m", 18000),
                                                ("1h", 216000)),
        warn_burn: float = 6.0,
        critical_burn: float = 14.4,
    ) -> None:
        self.rollback_budget_ms = float(rollback_budget_ms)
        self.lockstep_lag_frames = int(lockstep_lag_frames)
        self.target = float(target)
        self.windows = tuple((str(n), int(w)) for n, w in windows)
        self.warn_burn = float(warn_burn)
        self.critical_burn = float(critical_burn)

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.target)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rollback_budget_ms": self.rollback_budget_ms,
            "lockstep_lag_frames": self.lockstep_lag_frames,
            "target": self.target,
            "windows": {n: w for n, w in self.windows},
            "warn_burn": self.warn_burn,
            "critical_burn": self.critical_burn,
        }


class ShardSloMeter:
    """The shard-resident half: two counters per tier, prebound label
    children so the per-tick hot path is two attribute loads and an
    ``+=`` (the §23 zero-allocation discipline)."""

    __slots__ = ("policy", "_rb_ticks", "_rb_breaches",
                 "_ls_ticks", "_ls_breaches")

    def __init__(self, metrics, policy: Optional[SloPolicy] = None) -> None:
        self.policy = policy if policy is not None else SloPolicy()
        c_ticks = metrics.counter(
            "ggrs_slo_ticks_total",
            "ticks observed for slo budget compliance, by tier",
            labels=("tier",))
        c_breaches = metrics.counter(
            "ggrs_slo_breaches_total",
            "ticks that breached the tier's slo budget",
            labels=("tier",))
        self._rb_ticks = c_ticks.labels(tier=TIER_ROLLBACK)
        self._rb_breaches = c_breaches.labels(tier=TIER_ROLLBACK)
        self._ls_ticks = c_ticks.labels(tier=TIER_LOCKSTEP)
        self._ls_breaches = c_breaches.labels(tier=TIER_LOCKSTEP)

    def observe_rollback(self, tick_ms: float) -> bool:
        """One rollback-tier tick; returns True when compliant."""
        ok = tick_ms <= self.policy.rollback_budget_ms
        self._rb_ticks.inc()
        if not ok:
            self._rb_breaches.inc()
        return ok

    def observe_lockstep(self, worst_lag_frames: int) -> bool:
        """One lockstep-tier tick (worst confirmed-lag across the
        shard's lockstep slots); returns True when compliant."""
        ok = worst_lag_frames <= self.policy.lockstep_lag_frames
        self._ls_ticks.inc()
        if not ok:
            self._ls_breaches.inc()
        return ok


def _slo_totals(registry) -> Dict[str, Tuple[float, float]]:
    """Sum the two ``ggrs_slo_*`` counter families across every sample
    (harvested shard counters carry extra shard/backend labels; the
    tier label is the grouping key), from a ``Registry`` or a merged
    ``MultiRegistry`` view."""
    ticks: Dict[str, float] = {}
    breaches: Dict[str, float] = {}
    for fam in registry.families():
        if fam.name == "ggrs_slo_ticks_total":
            dest = ticks
        elif fam.name == "ggrs_slo_breaches_total":
            dest = breaches
        else:
            continue
        for labels, child in fam.samples():
            tier = labels.get("tier", TIER_ROLLBACK)
            dest[tier] = dest.get(tier, 0.0) + child.value
    return {
        tier: (ticks.get(tier, 0.0), breaches.get(tier, 0.0))
        for tier in set(ticks) | set(breaches)
    }


class BurnRateEngine:
    """The supervisor-resident half: per fleet tick, snapshot the merged
    cumulative counters and derive windowed burn rates + the verdict.

    Snapshots are kept on a pruned ring sized by the longest window —
    memory is O(windowed ticks), not O(uptime).  The exported family:

    - ``ggrs_slo_burn_rate{tier,window}`` (gauge)
    - ``ggrs_slo_level`` (gauge: 0 ok / 1 warn / 2 critical)
    - ``ggrs_slo_escalations_total`` (counter: transitions INTO
      critical — the page count, not the page duration)
    """

    def __init__(self, metrics=None,
                 policy: Optional[SloPolicy] = None) -> None:
        self.policy = policy if policy is not None else SloPolicy()
        self._snaps: List[Tuple[int, Dict[str, Tuple[float, float]]]] = []
        self._verdict: Dict[str, Any] = {
            "ok": True, "level": LEVEL_OK, "tiers": {},
            "policy": self.policy.as_dict(),
        }
        self._g_burn = self._g_level = self._c_escalations = None
        if metrics is not None:
            self._g_burn = metrics.gauge(
                "ggrs_slo_burn_rate",
                "windowed error-budget burn rate, by tier and window",
                labels=("tier", "window"))
            self._g_level = metrics.gauge(
                "ggrs_slo_level",
                "slo verdict level: 0 ok, 1 warn, 2 critical")
            self._c_escalations = metrics.counter(
                "ggrs_slo_escalations_total",
                "slo verdict transitions into critical")

    # ------------------------------------------------------------------

    def _reference(self, fleet_tick: int, window_ticks: int,
                   ) -> Tuple[int, Dict[str, Tuple[float, float]]]:
        """The snapshot to delta against for a window ending now: the
        newest snapshot at or before the window start, else the oldest
        held (a partial window while history warms up)."""
        start = fleet_tick - window_ticks
        ref = self._snaps[0]
        for snap in self._snaps:
            if snap[0] <= start:
                ref = snap
            else:
                break
        return ref

    def update(self, fleet_tick: int, registry) -> Dict[str, Any]:
        totals = _slo_totals(registry)
        self._snaps.append((int(fleet_tick), totals))
        # prune: keep one snapshot at/before the longest window start
        horizon = int(fleet_tick) - max(w for _, w in self.policy.windows)
        while len(self._snaps) > 2 and self._snaps[1][0] <= horizon:
            self._snaps.pop(0)

        tiers: Dict[str, Any] = {}
        level = LEVEL_OK
        for tier, (n_ticks, n_breaches) in sorted(totals.items()):
            burns: Dict[str, float] = {}
            for wname, wticks in self.policy.windows:
                _, ref = self._reference(fleet_tick, wticks)
                ref_ticks, ref_breaches = ref.get(tier, (0.0, 0.0))
                d_ticks = n_ticks - ref_ticks
                d_breaches = n_breaches - ref_breaches
                rate = (d_breaches / d_ticks) if d_ticks > 0 else 0.0
                burn = rate / self.policy.error_budget
                burns[wname] = burn
                if self._g_burn is not None:
                    self._g_burn.labels(tier=tier, window=wname).set(burn)
            # multi-window rule: EVERY window must burn past a threshold
            floor = min(burns.values()) if burns else 0.0
            if floor >= self.policy.critical_burn:
                tier_level = LEVEL_CRITICAL
            elif floor >= self.policy.warn_burn:
                tier_level = LEVEL_WARN
            else:
                tier_level = LEVEL_OK
            if _LEVEL_RANK[tier_level] > _LEVEL_RANK[level]:
                level = tier_level
            tiers[tier] = {
                "ticks": n_ticks, "breaches": n_breaches,
                "burn": burns, "level": tier_level,
            }
        prev = self._verdict.get("level", LEVEL_OK)
        if level == LEVEL_CRITICAL and prev != LEVEL_CRITICAL:
            if self._c_escalations is not None:
                self._c_escalations.inc()
        if self._g_level is not None:
            self._g_level.set(_LEVEL_RANK[level])
        self._verdict = {
            "ok": level != LEVEL_CRITICAL,
            "level": level,
            "tiers": tiers,
            "policy": self.policy.as_dict(),
        }
        return self._verdict

    def verdict(self) -> Dict[str, Any]:
        """The last computed verdict (healthz embeds this; ``ok`` False
        means the multi-window critical burn tripped and ``/healthz``
        should answer 503)."""
        return self._verdict
