#!/usr/bin/env python
"""port_fleet_top: a live per-shard terminal dashboard over the merged fleet
metrics (DESIGN.md §18), for fleets of the PyTorch / CUDA port.

The twin of ``scripts/fleet_top.py`` over ``ggrs_tpu_torch``: the same
frame, text for text, from the same two JSON documents.  Points at a
supervisor's ``obs.start_http_server`` endpoint -- the one serving
``supervisor.merged_registry()`` on ``/metrics.json`` and
``supervisor.healthz`` on ``/healthz`` -- and renders, refreshing in
place:

- the fleet header: tick, overall verdict, matches placed/pending/lost;
- one row per shard: backend, lifecycle state, matches (bank/adopted),
  heartbeat age, watchdog stage, restarts, ingress routes terminating
  on the shard (when a §26 placement healthz is being rendered), tick
  p99;
- per-shard span-phase p99s estimated from the harvested
  ``ggrs_fleet_span_seconds{shard,name}`` histogram;
- the fleet counters (admissions, migrations, failovers, lost) and the
  harvest plane's own health (snapshots merged, dups, gaps, ferried
  forensics);
- the §28 SLO plane: per-shard budget compliance from the harvested
  ``ggrs_slo_*`` counters (the SLO column), the supervisor's
  multi-window burn-rate verdict from ``healthz["slo"]``, and a match
  timeline footer (the last lifecycle events per match) when the
  endpoint also serves ``/timeline``.

Usage:
  python scripts/port_fleet_top.py --url http://127.0.0.1:9464
  python scripts/port_fleet_top.py --url http://127.0.0.1:9464 --once  # one frame

``render()`` is a pure function over the two JSON documents, so tests
drive it from captured snapshots without a server.  Host only: it reads
JSON and touches no device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ggrs_tpu_torch.obs.fleet_obs import histogram_quantile  # noqa: E402


def fetch(url: str, timeout: float = 3.0) -> Dict[str, Any]:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _fetch_healthz(base: str, timeout: float = 3.0) -> Dict[str, Any]:
    # /healthz answers 503 (with the same JSON body) when the fleet is
    # unhealthy — that is a datum, not a fetch failure
    try:
        return fetch(base + "/healthz", timeout)
    except urllib.error.HTTPError as e:
        try:
            return json.loads(e.read().decode())
        except Exception:
            return {"ok": False, "error": str(e)}


def _fmt_age(age: Optional[float]) -> str:
    if age is None:
        return "-"
    if age < 10:
        return f"{age * 1000:.0f}ms"
    return f"{age:.1f}s"


def _fmt_ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.2f}"


def _span_p99s(metrics: Dict[str, Any]
               ) -> Dict[str, List[Tuple[str, float, int]]]:
    """Per shard: [(span name, p99 ms, count)] from the harvested
    ``ggrs_fleet_span_seconds`` histogram, largest p99 first."""
    fam = metrics.get("ggrs_fleet_span_seconds")
    out: Dict[str, List[Tuple[str, float, int]]] = {}
    if not fam:
        return out
    for sample in fam.get("samples", ()):
        labels = sample.get("labels", {})
        shard = labels.get("shard", "?")
        name = labels.get("name", "?")
        buckets = sample.get("buckets", ())
        uppers = [b["le"] for b in buckets if b["le"] != "+Inf"]
        cums = [b["count"] for b in buckets]
        p99 = histogram_quantile(0.99, uppers, cums)
        if p99 is None:
            continue
        out.setdefault(shard, []).append(
            (name, p99 * 1000.0, sample.get("count", 0))
        )
    for shard in out:
        out[shard].sort(key=lambda t: -t[1])
    return out


def _slo_by_shard(metrics: Dict[str, Any]) -> Dict[str, Tuple[int, int]]:
    """Per shard: (ticks, breaches) summed across tiers from the
    harvested ``ggrs_slo_*`` counter families."""
    out: Dict[str, List[int]] = {}
    for name, idx in (("ggrs_slo_ticks_total", 0),
                      ("ggrs_slo_breaches_total", 1)):
        fam = metrics.get(name)
        if not fam:
            continue
        for sample in fam.get("samples", ()):
            shard = sample.get("labels", {}).get("shard", "?")
            out.setdefault(shard, [0, 0])[idx] += int(sample.get("value", 0))
    return {s: (t[0], t[1]) for s, (t) in out.items()}


def _fmt_slo(stats: Optional[Tuple[int, int]]) -> str:
    if not stats or stats[0] <= 0:
        return "-"
    ticks, breaches = stats
    return f"{100.0 * (1.0 - breaches / ticks):.2f}%"


def _slo_header(slo: Dict[str, Any]) -> str:
    """One line: verdict level plus each tier's worst-window burn."""
    parts = [f"slo: {slo.get('level', '?')}"]
    for tier, t in sorted((slo.get("tiers") or {}).items()):
        burns = t.get("burn") or {}
        worst = max(burns.values()) if burns else 0.0
        parts.append(
            f"{tier}={t.get('level', '?')} burn_max={worst:.2f} "
            f"({int(t.get('breaches', 0))}/{int(t.get('ticks', 0))} breached)"
        )
    return "  ".join(parts)


def _timeline_footer(timelines: Dict[str, List[Dict[str, Any]]],
                     max_matches: int = 8,
                     max_events: int = 10) -> List[str]:
    """Compact per-match lifecycle rows from merged §28 timelines:
    newest matches first, each as ``mid: EV@origin -> EV@origin ...``."""
    lines = ["match timelines (latest events):"]
    def newest(evs: List[Dict[str, Any]]) -> int:
        return max((e.get("ts_ns", 0) for e in evs), default=0)
    mids = sorted(timelines, key=lambda m: -newest(timelines[m]))
    for mid in mids[:max_matches]:
        evs = timelines[mid][-max_events:]
        chain = " -> ".join(
            f"{e.get('ev', '?')}@{e.get('origin') or '?'}" for e in evs
        )
        lines.append(f"  {mid:<14} {chain}")
    if len(mids) > max_matches:
        lines.append(f"  ... and {len(mids) - max_matches} more matches")
    return lines


def _counter_total(metrics: Dict[str, Any], name: str) -> int:
    fam = metrics.get(name)
    if not fam:
        return 0
    return int(sum(s.get("value", 0) for s in fam.get("samples", ())))


def render(healthz: Dict[str, Any], metrics: Dict[str, Any],
           phases_per_shard: int = 4,
           timelines: Optional[Dict[str, List[Dict[str, Any]]]] = None
           ) -> str:
    """One dashboard frame as text (pure; no I/O)."""
    lines: List[str] = []
    ok = healthz.get("ok")
    verdict = "OK" if ok else "DEGRADED"
    lines.append(
        f"ggrs fleet_top — tick {healthz.get('tick', '?')}  "
        f"[{verdict}]  matches={healthz.get('matches', '?')} "
        f"pending={healthz.get('pending_admissions', 0)} "
        f"lost={healthz.get('lost_matches', 0)}  "
        f"last_tick={_fmt_age(healthz.get('last_tick_age_s'))}"
    )
    slo = healthz.get("slo")
    if slo:
        lines.append(_slo_header(slo))
    lines.append("")
    header = (
        f"{'SHARD':<10} {'BACKEND':<8} {'STATE':<9} {'OK':<3} "
        f"{'MATCHES':<9} {'HB AGE':<8} {'WATCHDOG':<11} {'RST':<4} "
        f"{'LINK':<14} {'INGRESS':<8} {'P99 MS':<8} {'SLO':<8}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    shards = healthz.get("shards", {})
    proc = healthz.get("proc", {})
    slo_shards = _slo_by_shard(metrics)
    for sid in sorted(shards):
        h = shards[sid]
        p = proc.get(sid, {})
        link = p.get("link") or h.get("link")
        if link:
            link_col = f"{link.get('state', '?')}/e{link.get('epoch', 0)}"
            if link.get("reconnects"):
                link_col += f"+r{link['reconnects']}"
        else:
            link_col = "-"
        matches = f"{h.get('matches', 0)}"
        if "bank_matches" in h:
            matches += (f" ({h.get('bank_matches', 0)}b/"
                        f"{h.get('adopted_matches', 0)}a)")
        lines.append(
            f"{sid:<10} {h.get('backend', 'inproc'):<8} "
            f"{h.get('state', '?'):<9} "
            f"{'y' if h.get('ok') else 'N':<3} {matches:<9} "
            f"{_fmt_age(p.get('heartbeat_age_s', h.get('heartbeat_age_s'))):<8} "
            f"{p.get('watchdog', h.get('watchdog', '-')) or '-':<11} "
            f"{str(p.get('restarts', h.get('restarts', 0))):<4} "
            f"{link_col:<14} "
            f"{str(h.get('ingress_routes', '-')):<8} "
            f"{_fmt_ms(h.get('tick_p99_ms')):<8} "
            f"{_fmt_slo(slo_shards.get(sid)):<8}"
        )
    p99s = _span_p99s(metrics)
    if p99s:
        lines.append("")
        lines.append("phase p99 (harvested spans, ms):")
        for shard in sorted(p99s):
            tops = ", ".join(
                f"{name}={p99:.2f}"
                for name, p99, _count in p99s[shard][:phases_per_shard]
            )
            lines.append(f"  {shard:<10} {tops}")
    ing = healthz.get("ingress")
    if ing:
        lines.append("")
        fwd = sum(ing.get("forwarded", {}).values())
        dropped = sum(ing.get("dropped", {}).values())
        lines.append(
            "ingress {}: public={} routes={} flips={} fwd={} "
            "dropped={} route_epoch={}".format(
                ing.get("name", "?"),
                ":".join(str(p) for p in ing.get("public", ())) or "-",
                ing.get("routes", 0),
                ing.get("flips", 0),
                fwd,
                dropped,
                healthz.get("route_epoch", "-"),
            )
        )
    lines.append("")
    lines.append(
        "fleet: admissions={} migrations={} failovers={} lost={} | "
        "harvest: snapshots={} dups={} gaps={} forensics={}".format(
            _counter_total(metrics, "ggrs_fleet_admissions_total"),
            _counter_total(metrics, "ggrs_fleet_migrations_total"),
            _counter_total(metrics, "ggrs_fleet_failovers_total"),
            _counter_total(metrics, "ggrs_fleet_matches_lost_total"),
            _counter_total(metrics, "ggrs_fleet_obs_snapshots_total"),
            _counter_total(metrics, "ggrs_fleet_obs_snapshot_dups_total"),
            _counter_total(metrics, "ggrs_fleet_obs_snapshot_gaps_total"),
            _counter_total(metrics, "ggrs_fleet_obs_forensics_total"),
        )
    )
    if timelines:
        lines.append("")
        lines.extend(_timeline_footer(timelines))
    elif healthz.get("timeline_matches"):
        lines.append("")
        lines.append(
            f"timelines: {healthz['timeline_matches']} matches tracked "
            f"(serve /timeline or use scripts/match_timeline.py to view)"
        )
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--url", default="http://127.0.0.1:9464",
                    help="base URL of the supervisor's obs HTTP server")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (CI/scripting)")
    ap.add_argument("--phases", type=int, default=4, metavar="N",
                    help="top-N phases per shard in the p99 table")
    args = ap.parse_args()
    base = args.url.rstrip("/")
    while True:
        try:
            healthz = _fetch_healthz(base)
            metrics = fetch(base + "/metrics.json")
        except Exception as e:
            frame = f"fleet_top: cannot reach {base}: {e}"
        else:
            try:
                timelines = fetch(base + "/timeline")
            except Exception:
                timelines = None  # endpoint optional (older servers: 404)
            frame = render(healthz, metrics, phases_per_shard=args.phases,
                           timelines=timelines)
        if args.once:
            print(frame)
            return 0
        # clear + home, then the frame — refresh in place like top(1)
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
