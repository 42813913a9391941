"""Exporters for the metrics registry: Prometheus text exposition, JSON
snapshots, and a stdlib HTTP endpoint (DESIGN.md §12, §14).

The port's copy of ``ggrs_tpu/obs/exporters.py``.

The exporters only *read* — they never drive the pool.  Bank-side gauges
refresh when the driving thread calls ``HostSessionPool.scrape()`` (one
ctypes crossing for the whole bank); the HTTP server then serves whatever
the last scrape left in the registry.  Serving and scraping are split
deliberately: sessions are single-threaded (the Send-not-Sync contract),
so an HTTP thread must never reach into the bank itself.

Endpoints:

- ``/metrics`` — Prometheus text, ``/metrics.json`` — the JSON snapshot;
- ``/healthz`` — liveness plus last-tick age (a ``health`` callable
  returning the driving loop's last-tick ``time.monotonic()`` stamp, e.g.
  ``lambda: pool.last_tick_at``; 503 when the loop has gone stale);
- ``/trace`` — the attached :class:`~ggrs_tpu_torch.obs.trace.Tracer`'s current
  window as Chrome trace-event JSON (save it, open in chrome://tracing).
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .registry import Registry

__all__ = ["prometheus_text", "json_snapshot", "start_http_server",
           "validate_exposition", "MetricsServer", "MetricsHTTPServer"]


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(value: str) -> str:
    # HELP lines escape backslash and newline (not quotes) per the text
    # exposition format — an unescaped newline would tear the line apart
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _grouped_families(registry) -> "List[List[Any]]":
    """Families grouped by name, preserving first-seen order.  A
    :class:`~ggrs_tpu_torch.obs.registry.MultiRegistry` view can legitimately
    yield the same family name from two member registries (local vs
    fleet-harvested, DESIGN.md §18); the exposition must then emit ONE
    ``# TYPE`` header with every group's samples under it — duplicate
    headers are a promtool error."""
    order: List[str] = []
    groups: Dict[str, List[Any]] = {}
    for fam in registry.families():
        if fam.name not in groups:
            order.append(fam.name)
            groups[fam.name] = []
        groups[fam.name].append(fam)
    return [groups[name] for name in order]


def prometheus_text(registry) -> str:
    """The registry (or a ``MultiRegistry`` union view) in Prometheus
    text exposition format (version 0.0.4: ``# HELP`` / ``# TYPE``
    headers, one sample per line, label/help values escaped)."""
    lines = []
    for group in _grouped_families(registry):
        first = group[0]
        if first.help:
            lines.append(f"# HELP {first.name} {_escape_help(first.help)}")
        lines.append(f"# TYPE {first.name} {first.kind}")
        for fam in group:
            if fam.kind != first.kind:
                # shape conflict across registries: emitting mixed-kind
                # samples under one header would be invalid exposition
                continue
            for labels, child in fam.samples():
                if fam.kind == "histogram":
                    for upper, cum in child.cumulative():
                        le = ("+Inf" if upper == float("inf")
                              else _fmt_value(upper))
                        extra = 'le="%s"' % le
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_label_str(labels, extra)} {cum}"
                        )
                    lines.append(
                        f"{fam.name}_sum{_label_str(labels)} "
                        f"{_fmt_value(child.sum)}"
                    )
                    lines.append(
                        f"{fam.name}_count{_label_str(labels)} {child.count}"
                    )
                else:
                    lines.append(
                        f"{fam.name}{_label_str(labels)} "
                        f"{_fmt_value(child.value)}"
                    )
    return "\n".join(lines) + "\n"


def json_snapshot(registry) -> Dict[str, Any]:
    """The registry (or a ``MultiRegistry`` view) as a JSON-serializable
    dict — the shape bench.py embeds in its ``bench_out`` records and
    chaos summaries print.  Same-name families across member registries
    merge their sample lists."""
    out: Dict[str, Any] = {}
    for group in _grouped_families(registry):
        first = group[0]
        samples = []
        for fam in group:
            if fam.kind != first.kind:
                continue
            for labels, child in fam.samples():
                if fam.kind == "histogram":
                    samples.append({
                        "labels": labels,
                        "sum": child.sum,
                        "count": child.count,
                        "buckets": [
                            {"le": upper if upper != float("inf")
                             else "+Inf",
                             "count": cum}
                            for upper, cum in child.cumulative()
                        ],
                    })
                else:
                    samples.append({"labels": labels, "value": child.value})
        out[first.name] = {
            "type": first.kind,
            "help": first.help,
            "samples": samples,
        }
    return out


# ----------------------------------------------------------------------
# promtool-style exposition validation (DESIGN.md §18, run in CI by
# build_sanitized.sh through tests/test_fleet_obs.py)
# ----------------------------------------------------------------------

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_VALUE_RE = re.compile(
    r"(?:[+-]?Inf|NaN|[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)"
)
_SAMPLE_KINDS = {"counter", "gauge", "histogram", "summary", "untyped"}


def _parse_labels(s: str, errors: List[str], where: str
                  ) -> Optional[List[Tuple[str, str]]]:
    """Parse one ``{k="v",...}`` label block (without the braces);
    validates names and escape sequences.  Returns None on error."""
    out: List[Tuple[str, str]] = []
    i, n = 0, len(s)
    while i < n:
        m = _LABEL_NAME_RE.match(s, i)
        if m is None:
            errors.append(f"{where}: bad label name at ...{s[i:i+20]!r}")
            return None
        name = m.group(0)
        i = m.end()
        if i >= n or s[i] != "=":
            errors.append(f"{where}: expected '=' after label {name!r}")
            return None
        i += 1
        if i >= n or s[i] != '"':
            errors.append(f"{where}: label {name!r} value not quoted")
            return None
        i += 1
        value = []
        while i < n and s[i] != '"':
            if s[i] == "\\":
                if i + 1 >= n or s[i + 1] not in ('\\', '"', 'n'):
                    errors.append(
                        f"{where}: invalid escape in label {name!r}"
                    )
                    return None
                value.append({"\\": "\\", '"': '"', "n": "\n"}[s[i + 1]])
                i += 2
            elif s[i] == "\n":
                errors.append(f"{where}: raw newline in label {name!r}")
                return None
            else:
                value.append(s[i])
                i += 1
        if i >= n:
            errors.append(f"{where}: unterminated label value ({name!r})")
            return None
        i += 1  # closing quote
        out.append((name, "".join(value)))
        if i < n:
            if s[i] != ",":
                errors.append(f"{where}: expected ',' between labels")
                return None
            i += 1
    return out


def validate_exposition(text: str) -> List[str]:
    """Validate Prometheus text exposition the way ``promtool check
    metrics`` would: line syntax, label escaping, at most one ``# TYPE``
    per family (before its samples), no duplicate samples, and histogram
    structure — ``le`` strictly ascending with a terminal ``+Inf``
    bucket, cumulative counts non-decreasing, ``_count`` equal to the
    ``+Inf`` bucket, ``_sum``/``_count`` present.  Returns the list of
    problems (empty = conformant)."""
    errors: List[str] = []
    types: Dict[str, str] = {}
    sampled: set = set()      # family names that already emitted samples
    seen: set = set()         # (name, frozen labelset) duplicate check
    # histogram bookkeeping: (base name, base labelset) -> parts
    hist: Dict[Tuple[str, Tuple], Dict[str, Any]] = {}
    for lineno, line in enumerate(text.split("\n"), 1):
        if not line:
            continue
        where = f"line {lineno}"
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                name = parts[2]
                if _NAME_RE.fullmatch(name) is None:
                    errors.append(f"{where}: bad metric name {name!r}")
                    continue
                if parts[1] == "TYPE":
                    kind = parts[3].strip() if len(parts) > 3 else ""
                    if kind not in _SAMPLE_KINDS:
                        errors.append(
                            f"{where}: unknown TYPE {kind!r} for {name}"
                        )
                    if name in types:
                        errors.append(f"{where}: duplicate TYPE for {name}")
                    if name in sampled:
                        errors.append(
                            f"{where}: TYPE for {name} after its samples"
                        )
                    types[name] = kind
            continue
        m = _NAME_RE.match(line)
        if m is None:
            errors.append(f"{where}: unparseable sample {line[:40]!r}")
            continue
        name = m.group(0)
        rest = line[m.end():]
        labels: List[Tuple[str, str]] = []
        if rest.startswith("{"):
            # a '}' inside a quoted value is legal; scan for the real one
            depth_in_quote = False
            close = -1
            j = 1
            while j < len(rest):
                c = rest[j]
                if depth_in_quote:
                    if c == "\\":
                        j += 1
                    elif c == '"':
                        depth_in_quote = False
                elif c == '"':
                    depth_in_quote = True
                elif c == "}":
                    close = j
                    break
                j += 1
            if close < 0:
                errors.append(f"{where}: unterminated label block")
                continue
            parsed = _parse_labels(rest[1:close], errors, where)
            if parsed is None:
                continue
            labels = parsed
            rest = rest[close + 1:]
        if not rest.startswith(" "):
            errors.append(f"{where}: missing space before value")
            continue
        fields = rest[1:].split(" ")
        if not fields or _VALUE_RE.fullmatch(fields[0]) is None:
            errors.append(f"{where}: bad sample value {rest[1:]!r}")
            continue
        value = float(fields[0])
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(name[: -len(suffix)]) \
                    == "histogram":
                base = name[: -len(suffix)]
                break
        sampled.add(base)
        key = (name, tuple(sorted(labels)))
        if key in seen:
            errors.append(f"{where}: duplicate sample {name}{labels}")
        seen.add(key)
        if base != name or types.get(base) == "histogram":
            no_le = tuple(sorted(
                (k, v) for k, v in labels if k != "le"
            ))
            h = hist.setdefault((base, no_le),
                                {"le": [], "sum": None, "count": None})
            if name == base + "_bucket":
                le = dict(labels).get("le")
                if le is None:
                    errors.append(f"{where}: bucket without le label")
                    continue
                try:
                    le_v = float("inf") if le == "+Inf" else float(le)
                except ValueError:
                    errors.append(f"{where}: unparseable le {le!r}")
                    continue
                h["le"].append((le_v, value, lineno))
            elif name == base + "_sum":
                h["sum"] = value
            elif name == base + "_count":
                h["count"] = value
    for (base, no_le), h in hist.items():
        where = f"histogram {base}{dict(no_le)}"
        les = h["le"]
        if not les:
            errors.append(f"{where}: no buckets")
            continue
        uppers = [u for u, _c, _l in les]
        if uppers != sorted(uppers) or len(set(uppers)) != len(uppers):
            errors.append(f"{where}: le not strictly ascending")
        if uppers[-1] != float("inf"):
            errors.append(f"{where}: missing terminal +Inf bucket")
        cums = [c for _u, c, _l in les]
        if any(b < a for a, b in zip(cums, cums[1:])):
            errors.append(f"{where}: cumulative counts decrease")
        if h["count"] is None:
            errors.append(f"{where}: missing _count")
        elif uppers[-1] == float("inf") and h["count"] != cums[-1]:
            errors.append(
                f"{where}: _count {h['count']} != +Inf bucket {cums[-1]}"
            )
        if h["sum"] is None:
            errors.append(f"{where}: missing _sum")
    return errors


class MetricsServer:
    """Minimal scrape endpoint over ``http.server``: ``/metrics`` serves
    the Prometheus text format, ``/metrics.json`` the JSON snapshot,
    ``/healthz`` liveness + last-tick age, ``/trace`` the tracer window.
    Daemon-threaded; ``close()`` shuts it down.  Reads are GIL-safe
    against concurrent increments (plain attribute reads), so no
    coordination with the driving thread is needed.

    ``health``: optional callable returning either the driving loop's
    last-tick timestamp on the ``time.monotonic()`` clock (or None before
    the first tick), or an aggregate health DICT with an ``"ok"`` key
    (e.g. ``ShardSupervisor.healthz`` — the fleet-wide ``/healthz``
    aggregation, served verbatim).  ``/healthz`` reports 200 while
    healthy (timestamp age under ``stale_after`` seconds / ``ok`` true),
    503 otherwise — the pageable "pool wedged" signal.  ``tracer``:
    optional :class:`~ggrs_tpu_torch.obs.trace.Tracer` served on ``/trace``.
    ``timelines``: optional callable returning the merged §28 match
    timelines (``{mid: [events]}``), served on ``/timeline`` for
    ``scripts/match_timeline.py`` and the fleet_top footer.
    """

    def __init__(self, registry: Registry, port: int = 0,
                 addr: str = "127.0.0.1", tracer: Any = None,
                 health: Any = None, stale_after: float = 5.0,
                 timelines: Any = None) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        def healthz_body() -> tuple:
            last = health() if health is not None else None
            if isinstance(last, dict):
                # an aggregate health report (e.g.
                # ``ShardSupervisor.healthz``: fleet-wide verdict +
                # per-shard records): its "ok" decides the status code,
                # AND the server's stale_after still applies to the
                # report's last_tick_age_s — a wedged serving loop that
                # stops calling advance_all() must go 503 here exactly
                # like the timestamp path (the pageable signal), because
                # the aggregate's own ok is computed from state the dead
                # loop can no longer update
                age = last.get("last_tick_age_s")
                ok = bool(last.get("ok")) and (
                    age is None or age <= stale_after
                )
                return (200 if ok else 503), json.dumps(
                    dict(last, ok=ok), default=str
                ).encode()
            age = None
            if last is not None:
                age = max(0.0, time.monotonic() - last)
            ok = age is None or age <= stale_after
            body = json.dumps({
                "ok": ok,
                "last_tick_age_s": age,
                "stale_after_s": stale_after if health is not None else None,
            }).encode()
            return (200 if ok else 503), body

        class Handler(BaseHTTPRequestHandler):
            def do_GET(h) -> None:  # noqa: N805 - handler convention
                status = 200
                if h.path.startswith("/metrics.json"):
                    body = json.dumps(json_snapshot(registry)).encode()
                    ctype = "application/json"
                elif h.path.startswith("/metrics"):
                    body = prometheus_text(registry).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif h.path.startswith("/healthz"):
                    status, body = healthz_body()
                    ctype = "application/json"
                elif h.path.startswith("/trace") and tracer is not None:
                    body = json.dumps(tracer.chrome_trace()).encode()
                    ctype = "application/json"
                elif h.path.startswith("/timeline") and timelines is not None:
                    body = json.dumps(timelines(), default=str).encode()
                    ctype = "application/json"
                else:
                    h.send_response(404)
                    h.end_headers()
                    return
                h.send_response(status)
                h.send_header("Content-Type", ctype)
                h.send_header("Content-Length", str(len(body)))
                h.end_headers()
                h.wfile.write(body)

            def log_message(h, *args) -> None:  # quiet by default
                pass

        self._httpd = ThreadingHTTPServer((addr, port), Handler)
        self.addr = addr
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ggrs-obs-http",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# the name the quickstarts use; MetricsServer predates the /healthz and
# /trace endpoints and stays as an alias
MetricsHTTPServer = MetricsServer


def start_http_server(registry: Registry, port: int = 0,
                      addr: str = "127.0.0.1", tracer: Any = None,
                      health: Any = None,
                      stale_after: float = 5.0,
                      timelines: Any = None) -> MetricsServer:
    """Serve ``registry`` on ``http://addr:port/metrics`` (port 0 picks a
    free one; read it back from the returned server's ``.port``).  Pass
    ``tracer=`` / ``health=`` to light up ``/trace`` and ``/healthz``,
    ``timelines=`` for ``/timeline``."""
    return MetricsServer(registry, port=port, addr=addr, tracer=tracer,
                         health=health, stale_after=stale_after,
                         timelines=timelines)
