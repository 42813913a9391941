#!/usr/bin/env python
"""port_match_timeline: render one match's merged cross-host lifecycle
timeline (DESIGN.md §28), for fleets of the PyTorch / CUDA port.

The twin of ``scripts/match_timeline.py`` over ``ggrs_tpu_torch``: the same
flags, lines, Perfetto export and exit codes.  Sources, freely mixed:

- ``--url BASE`` (repeatable) -- a live obs endpoint serving merged
  timelines on ``/timeline`` (the supervisor's ``start_http_server``
  with ``timelines=``); one URL per host stitches a cross-host view.
- ``--artifact FILE`` (repeatable) -- JSON artifacts: a raw
  ``{mid: [events]}`` export (``TimelineStore.to_dict``), a chaos
  artifact embedding a ``"timeline"``/``"timelines"`` section, or a
  ``DesyncReport`` dict whose ``"timeline"`` list is the match's life
  up to the desync.

Ingress nodes never learn match ids -- they emit ROUTE_FLIP events keyed
``trace:<hex>`` on the 16-byte wire trace context.  Merging folds those
into the real match whose ``match_trace_id`` equals the hex, so a flip
observed at the edge lands inside the match's causal chain.

Usage:
  python scripts/port_match_timeline.py --url http://127.0.0.1:9464 --list
  python scripts/port_match_timeline.py --url http://h0:9464 --url http://h1:9464 -m m3
  python scripts/port_match_timeline.py --artifact chaos_net.json -m m0 \
      --perfetto m0.trace.json

Host only: it reads JSON and touches no device.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from pathlib import Path
from typing import Any, Dict, List

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ggrs_tpu_torch.obs.timeline import (  # noqa: E402
    fold_trace_aliases, format_timeline, match_trace_id, merge_timelines,
    timeline_ring_events,
)
from ggrs_tpu_torch.obs.trace import Tracer, validate_chrome_trace  # noqa: E402

Timelines = Dict[str, List[Dict[str, Any]]]


def _extract_timelines(doc: Any) -> List[Timelines]:
    """Every ``{mid: [events]}`` mapping findable in an artifact: the
    document itself, any ``timeline``/``timelines``/``merged_timeline``
    member (dict form), or a DesyncReport-style ``timeline`` list."""
    found: List[Timelines] = []
    if not isinstance(doc, dict):
        return found
    values = list(doc.values())
    if values and all(isinstance(v, list) for v in values) and any(
        isinstance(e, dict) and "ev" in e for v in values for e in v
    ):
        found.append(doc)  # already {mid: [events]}
        return found
    for key in ("timeline", "timelines", "merged_timeline"):
        sub = doc.get(key)
        if isinstance(sub, dict):
            found.extend(_extract_timelines(sub))
        elif isinstance(sub, list) and sub and isinstance(sub[0], dict):
            mid = str(sub[0].get("mid", doc.get("match_id", "?")))
            found.append({mid: sub})
    # recurse one level into nested sections (chaos artifacts nest the
    # timeline under a leg/report key)
    for v in values:
        if isinstance(v, dict) and any(
            k in v for k in ("timeline", "timelines", "merged_timeline")
        ):
            found.extend(_extract_timelines(v))
    return found


def load_sources(urls: List[str], artifacts: List[str]) -> Timelines:
    sources: List[Timelines] = []
    for base in urls:
        with urllib.request.urlopen(base.rstrip("/") + "/timeline",
                                    timeout=5.0) as r:
            sources.append(json.loads(r.read().decode()))
    for path in artifacts:
        with open(path) as f:
            doc = json.load(f)
        sources.extend(_extract_timelines(doc))
    return fold_trace_aliases(merge_timelines(*sources))


def export_perfetto(events: List[Dict[str, Any]], path: str) -> List[str]:
    """Write the match's events as a Chrome/Perfetto trace (instant
    phase on the shared ``timeline`` category) and return validation
    problems (empty = the export loads in ui.perfetto.dev)."""
    tracer = Tracer(capacity=max(len(events) + 16, 256))
    tracer.import_spans(timeline_ring_events(events))
    trace = tracer.chrome_trace()
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)
    return validate_chrome_trace(trace)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--url", action="append", default=[],
                    help="live obs endpoint base URL (repeatable)")
    ap.add_argument("--artifact", action="append", default=[],
                    help="chaos/timeline JSON artifact (repeatable)")
    ap.add_argument("-m", "--match", help="match id to render")
    ap.add_argument("--list", action="store_true",
                    help="list match ids and event counts, then exit")
    ap.add_argument("--perfetto", metavar="OUT",
                    help="also write the match as a Perfetto trace JSON")
    args = ap.parse_args()
    if not args.url and not args.artifact:
        ap.error("need at least one --url or --artifact")
    merged = load_sources(args.url, args.artifact)
    if args.list or not args.match:
        for mid in sorted(merged):
            evs = merged[mid]
            kinds = "->".join(dict.fromkeys(e.get("ev", "?") for e in evs))
            print(f"{mid:<16} {len(evs):>4} events  {kinds}")
        return 0
    events = merged.get(args.match, [])
    if not events:
        print(f"match_timeline: no events for {args.match!r} "
              f"(known: {sorted(merged)})", file=sys.stderr)
        return 1
    print(f"match {args.match} — {len(events)} events, "
          f"trace {match_trace_id(args.match):#018x}")
    for line in format_timeline(events):
        print("  " + line)
    if args.perfetto:
        problems = export_perfetto(events, args.perfetto)
        if problems:
            print(f"perfetto export INVALID: {problems}", file=sys.stderr)
            return 1
        print(f"perfetto trace written: {args.perfetto}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
