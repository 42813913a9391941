"""The port's fleet observability (``obs/timeline``, ``obs/slo``,
``obs/exporters``, ``obs/fleet_obs``, ``MultiRegistry`` and
``validate_chrome_trace``) against the JAX package's, on the CPU.

Mirrors ``tests/test_timeline_slo.py``, ``tests/test_fleet_obs.py`` and the
exporter cases of ``tests/test_obs.py``: every case runs the same seeded
input through both packages and requires equal bytes, strings, integers
and verdicts.  No verdict here is derived from the wall clock: the SLO
meters are fed one recorded series of tick milliseconds, timestamps are
passed in, and the HTTP health checks hand the server fixed ages."""

from __future__ import annotations

import json
import random
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import ggrs_tpu.obs as jobs
import ggrs_tpu.obs.exporters as jexp
import ggrs_tpu.obs.fleet_obs as jfo
import ggrs_tpu.obs.slo as jslo
import ggrs_tpu.obs.timeline as jtl
import ggrs_tpu.obs.trace as jtrace
import ggrs_tpu_torch.obs as tobs
import ggrs_tpu_torch.obs.exporters as texp
import ggrs_tpu_torch.obs.fleet_obs as tfo
import ggrs_tpu_torch.obs.slo as tslo
import ggrs_tpu_torch.obs.timeline as ttl
import ggrs_tpu_torch.obs.trace as ttrace

PKGS = {
    "jax": SimpleNamespace(obs=jobs, tl=jtl, slo=jslo, exp=jexp, fo=jfo, trace=jtrace),
    "port": SimpleNamespace(obs=tobs, tl=ttl, slo=tslo, exp=texp, fo=tfo, trace=ttrace),
}
EVENTS = ("ADMIT", "PLACE", "MIGRATE_BEGIN", "MIGRATE_COMMIT", "ROUTE_FLIP", "FAILOVER")


def both(fn):
    """``fn(package namespace)`` in each package; asserts equal results."""
    out = {name: fn(p) for name, p in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_obs_exports_the_jax_names():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    for name in tobs.__all__:
        assert hasattr(tobs, name), name
    for mod in ("tl", "slo", "exp", "fo"):
        assert sorted(getattr(PKGS["port"], mod).__all__) == sorted(
            getattr(PKGS["jax"], mod).__all__)
    assert ttl.TIMELINE_EVENTS == jtl.TIMELINE_EVENTS
    assert ttl.TRACE_CTX_FMT == jtl.TRACE_CTX_FMT


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_context_bytes(seed):
    rng = random.Random(seed)
    args = [(f"m{rng.randrange(10_000)}", rng.randrange(1 << 32), rng.randrange(1 << 32))
            for _ in range(64)]

    def run(p):
        packed = [p.tl.pack_trace_ctx(*a) for a in args]
        return (packed, [p.tl.unpack_trace_ctx(b) for b in packed],
                [p.tl.match_trace_id(a[0]) for a in args], p.tl.unpack_trace_ctx(p.tl.ZERO_TRACE_CTX))

    packed, unpacked, ids, zero = both(run)
    assert all(len(b) == tobs.TRACE_CTX_BYTES == 16 for b in packed)
    assert [u[1:] for u in unpacked] == [a[1:] for a in args] and zero == (0, 0, 0)


def _seeded_events(p, seed, n=200, mids=12):
    rng = random.Random(seed)
    return [p.tl.timeline_event(rng.choice(EVENTS), f"m{rng.randrange(mids)}",
                                origin=rng.choice(("h0", "h1", "fleet")), tick=rng.randrange(96),
                                epoch=rng.randrange(4), span=rng.randrange(9),
                                detail={"k": rng.randrange(5)}, ts_ns=rng.randrange(10**9))
            for _ in range(n)]


def test_timeline_store_ring_and_eviction():
    def run(p):
        store = p.tl.TimelineStore(capacity_matches=5, capacity_events=7, clock=lambda: 0)
        for ev in _seeded_events(p, 4):
            store.record(ev["ev"], ev["mid"], origin=ev["origin"], tick=ev["tick"],
                         detail=ev["detail"], ts_ns=ev["ts_ns"])
        n = store.ingest(_seeded_events(p, 5, n=40) + [{"no_mid": 1}, {"mid": "m0", "ts_ns": "x"}],
                         offset_ns=1234)
        tl = p.tl.MatchTimeline("m0", capacity=4)
        for ts in (400, 300, 500, 600, 100):
            tl.add(p.tl.timeline_event("X", "m0", ts_ns=ts))
        return (store.to_dict(), store.counts(), store.match_ids(), store.malformed, n,
                tl.events(), tl.dropped)

    d, counts, mids, malformed, n, kept, dropped = both(run)
    assert len(mids) == 5 and max(counts.values()) <= 7 and malformed == 2 and dropped == 1


def test_merge_fold_format_and_first_occurrence():
    def run(p):
        store = p.tl.TimelineStore()
        for ev in _seeded_events(p, 6, n=60, mids=4):
            store.record(ev["ev"], ev["mid"], origin=ev["origin"], tick=ev["tick"],
                         ts_ns=ev["ts_ns"])
        trace = p.tl.match_trace_id("m1")
        alias = {f"trace:{trace:016x}": [p.tl.timeline_event(
            p.tl.EV_ROUTE_FLIP, f"trace:{trace:016x}", ts_ns=150, origin="ingress")],
            "trace:00000000deadbeef": [p.tl.timeline_event(
                p.tl.EV_ROUTE_FLIP, "trace:00000000deadbeef", ts_ns=1)]}
        merged = p.tl.merge_timelines(store, {"m0": _seeded_events(p, 7, n=10, mids=1)}, None,
                                      alias)
        folded = p.tl.fold_trace_aliases(merged)
        text = {mid: p.tl.format_timeline(evs) for mid, evs in folded.items()}
        orders = {mid: [p.tl.first_occurrence_order(evs, *pair)
                        for pair in (("ADMIT", "FAILOVER"), ("MIGRATE_BEGIN", "MIGRATE_COMMIT"),
                                     ("ADMIT", "PLACE", "ROUTE_FLIP"))]
                  for mid, evs in folded.items()}
        ring = p.tl.timeline_ring_events(folded["m1"])
        return merged, folded, text, orders, ring, p.tl.format_timeline([])

    merged, folded, text, orders, ring, empty = both(run)
    assert "trace:00000000deadbeef" in folded and not any(
        k.startswith("trace:") and k != "trace:00000000deadbeef" for k in folded)
    assert empty == [] and all(len(text[m]) == len(folded[m]) for m in folded)


def test_ring_reemission_validates_as_chrome_trace():
    def run(p):
        tracer = p.trace.Tracer(capacity=256)
        tracer.import_spans(p.tl.timeline_ring_events(_seeded_events(p, 8, n=30, mids=1)),
                            offset_ns=77, extra_args={"shard": "s1"})
        events = tracer.chrome_trace()["traceEvents"]
        # the tracer's own clock and thread ids differ between processes
        return [(e["name"], e["ph"], e.get("args")) for e in events], \
            p.trace.validate_chrome_trace(tracer.chrome_trace())

    events, problems = both(run)
    assert problems == [] and len(events) >= 30


@pytest.mark.parametrize("case", ["nested", "bad", "overlap", "eps"])
def test_validate_chrome_trace(case):
    traces = {
        "nested": {"traceEvents": [
            {"name": "outer", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
            {"name": "inner", "ph": "X", "ts": 2, "dur": 3, "pid": 1, "tid": 1},
            {"name": "mark", "ph": "i", "ts": 4, "pid": 1, "tid": 1, "s": "t"}]},
        "bad": {"traceEvents": [
            {"name": "x", "ph": "Z", "ts": 0, "pid": 1, "tid": 1},
            {"name": "", "ph": "X", "ts": -5, "dur": 1, "pid": 1, "tid": 1},
            {"name": "y", "ph": "X", "ts": 1, "dur": -1, "pid": 1, "tid": 1},
            {"name": "z", "ph": "X", "ts": 1, "dur": 1}, 7]},
        "overlap": {"traceEvents": [
            {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
            {"name": "b", "ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 1}]},
        "eps": {"traceEvents": [
            {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
            {"name": "b", "ph": "X", "ts": 5, "dur": 5.02, "pid": 1, "tid": 1}]},
    }
    got = both(lambda p: (p.trace.validate_chrome_trace(traces[case]),
                          p.trace.validate_chrome_trace(traces[case], eps_us=0.05),
                          p.trace.validate_chrome_trace({"nope": 1})))
    assert (got[0] == []) == (case == "nested") and got[2]


def _tick_series(seed, n=120):
    """A recorded series of rollback tick milliseconds and lockstep lags."""
    rng = random.Random(seed)
    return [(rng.choice((4.0, 9.5, 16.0, 17.5, 30.0)), rng.randrange(8)) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_meter_and_burn_rates_on_one_series(seed):
    series = _tick_series(seed)

    def run(p):
        reg, mreg = p.obs.Registry(), p.obs.Registry()
        policy = p.slo.SloPolicy(target=0.9, windows=(("w4", 4), ("w16", 16)), warn_burn=2.0,
                                 critical_burn=5.0)
        meter = p.slo.ShardSloMeter(reg, policy=policy)
        burn = p.slo.BurnRateEngine(metrics=mreg, policy=policy)
        observed, verdicts = [], []
        for tick, (ms, lag) in enumerate(series):
            observed.append((meter.observe_rollback(ms), meter.observe_lockstep(lag)))
            verdicts.append(burn.update(tick, reg))
        return (observed, verdicts, burn.verdict() if hasattr(burn, "verdict") else None,
                p.exp.prometheus_text(reg), p.exp.prometheus_text(mreg), policy.as_dict(),
                p.slo.SloPolicy().as_dict())

    observed, verdicts, *_ = both(run)
    levels = {v["level"] for v in verdicts}
    assert len(levels) >= 2, levels  # the series crosses a threshold


def _filled(p, seed):
    """One registry filled from a seed: counters, gauges and histograms,
    labelled and not, with label and help values that need escaping."""
    rng = random.Random(seed)
    reg = p.obs.Registry()
    reg.counter("evil_total", 'help with\nnewline and \\backslash', labels=("why",)).labels(
        why='a "quoted"\nmulti\\line value').inc(rng.randrange(1, 9))
    c = reg.counter("ggrs_fleet_admissions_total", "admissions", labels=("tier",))
    g = reg.gauge("ggrs_fleet_matches", "matches", labels=("shard",))
    h = reg.histogram("ggrs_fleet_tick_seconds", "tick", buckets=(0.001, 0.004, 0.016, 0.064),
                      labels=("shard",))
    plain = reg.histogram("rollback_depth", "depth")
    for _ in range(200):
        c.labels(tier=rng.choice(("bank", "adopted"))).inc(rng.randrange(3))
        g.labels(shard=rng.choice(("s0", "s1"))).set(rng.randrange(64))
        h.labels(shard=rng.choice(("s0", "s1"))).observe(rng.random() * 0.1)
        plain.observe(rng.randrange(12))
    reg.gauge("ggrs_pool_ratio", "a float").set(rng.random())
    return reg


@pytest.mark.parametrize("seed", [0, 3])
def test_exposition_text_and_json_snapshot(seed):
    def run(p):
        reg = _filled(p, seed)
        text = p.exp.prometheus_text(reg)
        return text, json.dumps(p.exp.json_snapshot(reg), sort_keys=True), \
            p.exp.validate_exposition(text)

    text, snap, errors = both(run)
    assert errors == [] and "\\n" in text and '\\"' in text


BROKEN_EXPOSITIONS = [
    "# TYPE h histogram\nh_bucket{le=\"2\"} 1\nh_bucket{le=\"1\"} 1\n"
    "h_bucket{le=\"+Inf\"} 2\nh_sum 3\nh_count 2\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_sum 1\nh_count 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 5\nh_bucket{le=\"+Inf\"} 3\nh_sum 1\nh_count 3\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_bucket{le=\"1\"} 1\n"
    "h_bucket{le=\"+Inf\"} 1\nh_sum 1\nh_count 1\n",
    "a_total 1\na_total 2\n",
    'a{x="bad\\q"} 1\n',
    "a_total one\n",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_count 3\n",
    "# TYPE c counter\n# TYPE c gauge\nc 1\n",
    "bad-name 1\n",
]


@pytest.mark.parametrize("k", range(len(BROKEN_EXPOSITIONS)))
def test_validate_exposition_errors(k):
    errors = both(lambda p: p.exp.validate_exposition(BROKEN_EXPOSITIONS[k]))
    assert errors


def test_multi_registry_exposition():
    def run(p):
        local = p.obs.Registry()
        local.counter("dup_total", "local flavor").inc(1)
        harvest = p.obs.Registry()
        harvest.counter("dup_total", "harvested flavor", labels=("shard", "backend")).labels(
            shard="s1", backend="proc").inc(2)
        view = p.obs.MultiRegistry(local, None, harvest)
        text = p.exp.prometheus_text(view)
        return (text, p.exp.json_snapshot(view), p.exp.validate_exposition(text),
                view.value("dup_total"), view.value("dup_total", shard="s1", backend="proc"),
                view.value("missing"))

    text, snap, errors, local, harvested, missing = both(run)
    assert text.count("# TYPE dup_total counter") == 1 and errors == []
    # value() answers from the first registry holding the family
    assert (local, missing) == (1, None) and len(snap["dup_total"]["samples"]) == 2


def test_registry_collector_harvest_and_fleet_obs_ingest():
    def run(p):
        reg = _filled(p, 5)
        coll = p.fo.RegistryCollector(reg, gen=7)
        own = p.obs.Registry()
        obs = p.fo.FleetObs(metrics=own)
        snaps, merged = [], []
        for step in range(4):
            snap = coll.collect()
            snaps.append(snap)
            if snap is not None:
                merged.append(obs.merge_snapshot("s1", snap))
                merged.append(obs.merge_snapshot("s1", snap))  # redelivery: dropped
            reg.counter("ggrs_fleet_admissions_total", "admissions", labels=("tier",)).labels(
                tier="bank").inc(step)
        fresh = p.fo.RegistryCollector(_filled(p, 6), gen=8).collect()
        fresh["seq"] = 3  # first seen with seq > 1: one gap counted
        merged.append(obs.merge_snapshot("s0", fresh))
        obs.ingest("s1", {"forensics": [{"kind": "fault", "slot": 3}, "junk"],
                          "spans": [("X", "bad")],
                          "timeline": _seeded_events(p, 9, n=12, mids=3),
                          "metrics": [snaps[0], coll.collect()]}, offset_ns=5)
        harvest = p.exp.prometheus_text(obs.harvest)
        return (snaps, merged, harvest, p.exp.validate_exposition(harvest),
                obs.timelines.to_dict(), [{k: v for k, v in f.items() if k != "received_at"}
                                          for f in obs.drain_forensics()],
                p.exp.prometheus_text(own))

    snaps, merged, harvest, errors, timelines, forensics, own = both(run)
    assert errors == [] and merged[:2] == [True, False] and forensics
    assert 'shard="s1",backend="proc"' in harvest or 'backend="proc",shard="s1"' in harvest


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantile(q):
    uppers = [0.001, 0.004, 0.016, 0.064]
    rng = random.Random(int(q * 100))
    counts = []
    for _ in range(5):
        c = sorted(rng.randrange(100) for _ in range(len(uppers) + 1))
        counts.append(c)
    got = both(lambda p: [p.fo.histogram_quantile(q, uppers, c) for c in counts]
               + [p.fo.histogram_quantile(q, uppers, []), p.fo.histogram_quantile(q, uppers, [0] * 5)])
    assert got[-2:] == [None, None]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_http_server_metrics_healthz_and_stale_503():
    def run(p):
        reg = _filled(p, 2)
        tracer = p.trace.Tracer(capacity=8)
        tracer.add_instant("mark")
        health = {"v": {"ok": True, "last_tick_age_s": 0.25, "shards": {"s0": {}}}}
        servers = [
            p.exp.start_http_server(reg, port=0, tracer=tracer, health=lambda: health["v"],
                                    stale_after=5.0, timelines=lambda: {"m0": []}),
            p.exp.start_http_server(reg, port=0, health=lambda: None),
        ]
        try:
            base, bare = (f"http://127.0.0.1:{s.port}" for s in servers)
            out = [_get(base + "/metrics"), _get(base + "/metrics.json"), _get(base + "/healthz"),
                   _get(base + "/timeline"), _get(bare + "/healthz"), _get(bare + "/trace")[0],
                   _get(base + "/nope")[0]]
            health["v"] = dict(health["v"], last_tick_age_s=60.0)  # a wedged loop
            out.append(_get(base + "/healthz"))
            health["v"] = dict(health["v"], ok=False, last_tick_age_s=0.1)
            out.append(_get(base + "/healthz"))
            trace = json.loads(_get(base + "/trace")[1])
        finally:
            for s in servers:
                s.close()
        return out, [e["name"] for e in trace["traceEvents"]]

    out, trace_names = both(run)
    (status, text), *_ = out
    assert status == 200 and jexp.validate_exposition(text.decode()) == []
    assert [o if isinstance(o, int) else o[0] for o in out] == [200, 200, 200, 200, 200, 404, 404,
                                                               503, 503]
    assert json.loads(out[7][1])["ok"] is False and trace_names == ["mark"]
