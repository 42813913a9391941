"""Placement plane: multi-supervisor scheduling + cross-host live
migration behind stable virtual endpoints (DESIGN.md §26).

The port's copy of ``ggrs_tpu/fleet/placement_service.py``.

One level above :class:`~ggrs_tpu_torch.fleet.supervisor.ShardSupervisor`: the
:class:`PlacementService` fronts MANY supervisors ("hosts"), lifting the
same two ideas the supervisor applies to its shards — a
:class:`~ggrs_tpu_torch.fleet.placement.HashRing` preference walk and
capacity/p99-aware refusal — one level up, fed by each host's merged
fleet obs (per-shard ``admission_refusal`` and the harvested
``tick_p99_ms``).  Every match it admits gets a *virtual endpoint* from
the §26 ingress, so its public address survives anything the placement
plane does to it:

- **live migration** (:meth:`migrate`): ``export_transfer`` on the
  source (the §16 pickle-portable resume bundle, round-tripped through
  real ``pickle.dumps`` bytes — the cross-host contract), ``adopt_transfer``
  on the target, THEN the ingress route flip.  Flip-after-adoption is
  not a style choice: the route-flip machine in ``analysis/machines.py``
  (``route-flip:flip-before-ack``) pins the misroute counterexample, and
  every ``_Migration.phase`` edge below conforms to ``MIG_TRANSITIONS``
  under the §22 transition lint.
- **host failover**: each tick replicates every placed match's
  ``record_meta`` (the picklable description journal failover needs);
  when a host is confirmed dead (:meth:`kill_host`), survivors
  ``adopt_from_meta`` — rebuilding live sessions from the shared-storage
  journals — and the ingress flips routes to the new legs.  Peers keep
  talking to the SAME public address throughout; the §25-style fence
  (``route_epoch`` minted here, refused-if-stale at the ingress) keeps a
  supervisor that slept through the failover from ever flipping a route
  back.
"""

from __future__ import annotations

import functools
import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..core.errors import InvalidRequest
from ..obs.registry import Registry
from ..obs.timeline import (
    EV_FAILOVER,
    EV_MIGRATE_ABORT,
    EV_MIGRATE_BEGIN,
    EV_MIGRATE_COMMIT,
    EV_PLACE,
    EV_ROUTE_FLIP,
    TimelineStore,
    pack_trace_ctx,
)
from ..utils.tracing import get_logger
from .ingress import (
    ROUTE_OP_DEL,
    ROUTE_OP_PUT,
    encode_route_update,
    virtual_endpoint_socket,
)
from .placement import HashRing
from .supervisor import FleetError
from .tuning import FleetTuning

_logger = get_logger("fleet")

# ----------------------------------------------------------------------
# the migration phase machine (DESIGN.md §26, modeled in
# analysis/machines.py as route_flip_model — every ``phase`` assignment
# below is an edge of this table, proven by the §22 conformance lint)
# ----------------------------------------------------------------------

MIG_IDLE = "idle"          # no transfer in flight
MIG_EXPORTED = "exported"  # bundle off the source; nobody serves
MIG_ADOPTED = "adopted"    # target ACKED adoption; route still old
MIG_FLIPPED = "flipped"    # ingress accepted the new route

MIG_TRANSITIONS = (
    (MIG_IDLE, MIG_EXPORTED),      # export_transfer / journal pickup
    (MIG_EXPORTED, MIG_ADOPTED),   # target adoption acked
    (MIG_ADOPTED, MIG_FLIPPED),    # ingress route flip (never earlier)
    (MIG_FLIPPED, MIG_IDLE),       # settled
    (MIG_EXPORTED, MIG_IDLE),      # abort: restored on the source
)


class _Migration:
    """One in-flight transfer's phase, conformed to MIG_TRANSITIONS."""

    def __init__(self, match_id: str, src: Optional[str],
                 dst: str) -> None:
        self.match_id = match_id
        self.src = src
        self.dst = dst
        self.phase = MIG_IDLE


@dataclass
class PlacedMatch:
    """Placement-plane record: where a match serves and how the world
    reaches it.  ``meta`` is the per-tick-replicated supervisor
    ``record_meta`` — everything a survivor needs for journal failover
    when the serving host dies without a goodbye."""

    match_id: str
    host: str
    vport: int
    peers: Tuple[Tuple[str, int], ...] = ()
    meta: Optional[Dict[str, Any]] = None
    routed: bool = False
    lost: Optional[str] = None


_MIGRATION_BUCKETS = (0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 1.0, 5.0)


class PlacementService:
    """Admission, scheduling, migration, and failover across many
    supervisors, with the ingress owning every public address."""

    def __init__(self, hosts: Dict[str, Any], *, ingress: Any,
                 host_addrs: Optional[Dict[str, str]] = None,
                 tuning: Optional[FleetTuning] = None,
                 metrics: Optional[Registry] = None) -> None:
        if not hosts:
            raise InvalidRequest("placement needs at least one host")
        self.hosts = dict(hosts)
        self.ingress = ingress
        self.host_addrs = dict(host_addrs or {})
        self.tuning = tuning if tuning is not None else FleetTuning.from_env()
        self.metrics = metrics if metrics is not None else Registry()
        self.ring = HashRing(self.hosts.keys())
        self._dead: Set[str] = set()
        self._records: Dict[str, PlacedMatch] = {}
        # the placement-minted route fence: bumped on every confirmed
        # host death, so any route a stale epoch signed is refused at
        # the ingress forever after (§25's mint, applied to routes)
        self.route_epoch = 1
        self._route_version = 0
        self._tick = 0
        # match-lifecycle timelines (§28): the placement plane is the
        # cross-host narrator — it sees every PLACE / MIGRATE_* /
        # ROUTE_FLIP / FAILOVER edge, and mints the span ids the trace
        # context carries onto the wire
        self.timelines = TimelineStore()
        self._span_seq = 0
        m = self.metrics
        self._m_admissions = m.counter(
            "ggrs_placement_admissions_total",
            "matches placed, by host", labels=("host",))
        self._m_refusals = m.counter(
            "ggrs_placement_refusals_total",
            "per-host placement refusals, by reason", labels=("reason",))
        self._m_migrations = m.counter(
            "ggrs_placement_migrations_total",
            "cross-host transfers completed, by reason",
            labels=("reason",))
        self._h_migration = m.histogram(
            "ggrs_placement_migration_seconds",
            "export -> adopt -> route-flip latency per live migration",
            buckets=_MIGRATION_BUCKETS)
        self._m_route_updates = m.counter(
            "ggrs_placement_route_updates_total",
            "route updates pushed to the ingress, by verdict",
            labels=("verdict",))
        self._m_host_failovers = m.counter(
            "ggrs_placement_host_failovers_total",
            "matches journal-failed-over off a dead host")
        self._m_lost = m.counter(
            "ggrs_placement_matches_lost_total",
            "matches the placement plane could not recover")
        self._g_hosts = m.gauge(
            "ggrs_placement_hosts", "hosts per state", labels=("state",))
        self._update_host_gauge()

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _host_addr(self, hid: str) -> str:
        return self.host_addrs.get(hid, "127.0.0.1")

    def _next_span(self) -> int:
        self._span_seq += 1
        return self._span_seq

    def _record_timeline(self, etype: str, match_id: str,
                         span: Optional[int] = None,
                         detail: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        return self.timelines.record(
            etype, match_id, origin="placement", tick=self._tick,
            epoch=self.route_epoch,
            span=span if span is not None else self._next_span(),
            detail=detail,
        )

    def host_refusal(self, hid: str) -> Optional[str]:
        """Why this host cannot take a match right now (None = it can):
        dead, every shard refusing (the reason the first one gives), or
        over the placement p99 budget (``tuning.placement_p99_budget_ms``,
        fed by the harvested per-shard tick p99)."""
        if hid in self._dead:
            return "dead"
        sup = self.hosts[hid]
        first_reason: Optional[str] = None
        any_accepts = False
        for shard in sup.shards.values():
            r = shard.admission_refusal()
            if r is None:
                any_accepts = True
                break
            if first_reason is None:
                first_reason = r
        if not any_accepts:
            return first_reason or "dead"
        budget = self.tuning.placement_p99_budget_ms
        if budget:
            h = sup.healthz()
            p99s = [
                s.get("tick_p99_ms") for s in h["shards"].values()
                if s.get("tick_p99_ms") is not None
            ]
            if p99s and max(p99s) > budget:
                return "overloaded"
        return None

    def choose_host(self, match_id: str,
                    exclude: Tuple[str, ...] = ()) -> str:
        """The ring's preference walk with capacity/p99-aware refusal —
        the supervisor's §16 placement policy, one level up."""
        for hid in self.ring.preference(match_id):
            if hid in exclude:
                continue
            reason = self.host_refusal(hid)
            if reason is None:
                return hid
            self._m_refusals.labels(reason=reason).inc()
        raise FleetError(
            f"no host accepts match {match_id!r}")

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def admit(self, match_id: str,
              builder_factory: Callable[[], Any],
              socket_factory: Optional[Callable[[], Any]] = None,
              *, peer_addrs: Any = (),
              journal: Optional[bool] = None,
              state_template: Any = None,
              game_factory: Optional[Callable[[], Any]] = None,
              host: Optional[str] = None,
              shard: Optional[str] = None) -> str:
        """Place one match behind a fresh virtual endpoint.  With no
        ``socket_factory`` the match serves through a
        :func:`~ggrs_tpu_torch.fleet.ingress.virtual_endpoint_socket` leg —
        the normal ingress-fronted shape; passing one keeps direct-wire
        matches placeable too (they just cannot migrate invisibly).
        ``peer_addrs`` pre-claims the public peer source addresses.
        Returns the serving host id."""
        if match_id in self._records:
            raise InvalidRequest(f"match {match_id!r} already placed")
        peers = tuple((a[0], int(a[1])) for a in peer_addrs)
        vport = self.ingress.allocate_endpoint(peers=peers)
        if socket_factory is None:
            up = self.ingress.uplink_addr()
            socket_factory = functools.partial(
                virtual_endpoint_socket, up[0], up[1], vport)
        hid = host if host is not None else self.choose_host(match_id)
        sup = self.hosts[hid]
        placed = sup.admit(
            match_id, builder_factory, socket_factory,
            journal=journal, state_template=state_template,
            shard=shard, game_factory=game_factory,
        )
        rec = PlacedMatch(match_id, hid, vport, peers)
        self._records[match_id] = rec
        self._m_admissions.labels(host=hid).inc()
        self._record_timeline(
            EV_PLACE, match_id,
            detail={"host": hid, "vport": vport, "shard": placed})
        if placed is not None:
            self._push_route(rec)
        return hid

    def claim_peers(self, match_id: str, peers: Any) -> None:
        """Late joiners: claim more public source addresses for a
        match's virtual endpoint."""
        rec = self._record(match_id)
        peers = tuple((a[0], int(a[1])) for a in peers)
        self.ingress.claim_peers(rec.vport, peers)
        rec.peers = tuple(dict.fromkeys(rec.peers + peers))

    def _record(self, match_id: str) -> PlacedMatch:
        rec = self._records.get(match_id)
        if rec is None:
            raise InvalidRequest(f"no placed match {match_id!r}")
        return rec

    # ------------------------------------------------------------------
    # the route plane
    # ------------------------------------------------------------------

    def _push_route(self, rec: PlacedMatch) -> bool:
        """Point the match's virtual endpoint at its current serving
        leg.  Every push carries the placement epoch and a fresh
        monotonic version; the ingress refuses anything stale — pushes
        go through :func:`~ggrs_tpu_torch.fleet.ingress.encode_route_update`
        bytes even in-process, so the fenced path is the ONLY path."""
        port = self.hosts[rec.host].match_port(rec.match_id)
        if port is None:
            return False  # parked/pending: routed once actually placed
        self._route_version += 1
        was_routed = rec.routed
        # the §28 causal stamp rides the fenced route bytes themselves:
        # the ingress re-emits the flip keyed by this exact context
        span = self._next_span()
        update = encode_route_update(
            ROUTE_OP_PUT, self.route_epoch, self._route_version,
            rec.vport, (self._host_addr(rec.host), port),
            ctx=pack_trace_ctx(rec.match_id, self.route_epoch, span),
        )
        verdict = self.ingress.apply_route_update(update)
        self._m_route_updates.labels(verdict=verdict).inc()
        if verdict != "ok":
            raise FleetError(
                f"route update for {rec.match_id!r} refused: {verdict}")
        if was_routed:
            # a re-point of an already-live route IS the flip peers feel
            self._record_timeline(
                EV_ROUTE_FLIP, rec.match_id, span=span,
                detail={"host": rec.host, "port": port,
                        "vport": rec.vport})
        rec.routed = True
        return True

    def _drop_route(self, rec: PlacedMatch) -> None:
        self._route_version += 1
        update = encode_route_update(
            ROUTE_OP_DEL, self.route_epoch, self._route_version,
            rec.vport, (self._host_addr(rec.host), 0),
            ctx=pack_trace_ctx(rec.match_id, self.route_epoch,
                               self._next_span()),
        )
        verdict = self.ingress.apply_route_update(update)
        self._m_route_updates.labels(verdict=verdict).inc()
        rec.routed = False

    # ------------------------------------------------------------------
    # cross-host live migration
    # ------------------------------------------------------------------

    def migrate(self, match_id: str, dst_host: Optional[str] = None,
                *, reason: str = "manual") -> str:
        """Move a live match to another host: export the §16 resume
        bundle, round-trip it through pickle bytes (what the TCP frame
        carries), adopt on the target, and only THEN flip the ingress
        route — ``MIG_TRANSITIONS`` order, peers none the wiser.  On
        adoption failure the same bytes restore the match on the source
        (the EXPORTED→IDLE abort edge) and the error propagates."""
        rec = self._record(match_id)
        if rec.lost is not None:
            raise InvalidRequest(f"match {match_id!r} is lost")
        src = rec.host
        if dst_host is None:
            dst_host = self.choose_host(match_id, exclude=(src,))
        if dst_host == src:
            raise InvalidRequest(
                f"match {match_id!r} already serves on {src!r}")
        t0 = time.perf_counter()
        mig = _Migration(match_id, src, dst_host)
        self._record_timeline(
            EV_MIGRATE_BEGIN, match_id,
            detail={"from": src, "to": dst_host, "reason": reason})
        blob = self.hosts[src].export_transfer(match_id)
        # ggrs-model: transitions(idle->exported)
        mig.phase = MIG_EXPORTED
        # the cross-host contract: the bundle must survive real bytes
        # (module-level factories, plain-data state) — enforced on every
        # migration, not just the ones that actually cross a machine
        wire = pickle.dumps(blob, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            self.hosts[dst_host].adopt_transfer(
                match_id, pickle.loads(wire))
        except Exception as adopt_err:
            self._restore_on_source(rec, mig, wire, adopt_err)
            raise
        # ggrs-model: transitions(exported->adopted)
        mig.phase = MIG_ADOPTED
        rec.host = dst_host
        rec.meta = None  # stale source meta must not drive a failover
        self._push_route(rec)
        # ggrs-model: transitions(adopted->flipped)
        mig.phase = MIG_FLIPPED
        self._m_migrations.labels(reason=reason).inc()
        self._h_migration.observe(time.perf_counter() - t0)
        self._record_timeline(
            EV_MIGRATE_COMMIT, match_id,
            detail={"from": src, "to": dst_host})
        # ggrs-model: transitions(flipped->idle)
        mig.phase = MIG_IDLE
        return dst_host

    def _restore_on_source(self, rec: PlacedMatch, mig: _Migration,
                           wire: bytes, cause: Exception) -> None:
        """The abort edge: target refused/failed adoption, so the same
        exported bytes restore the match where it was (a fresh unpickle
        — the failed target may have half-consumed its copy)."""
        self._record_timeline(
            EV_MIGRATE_ABORT, rec.match_id,
            detail={"to": mig.dst, "cause": str(cause)})
        try:
            self.hosts[rec.host].adopt_transfer(
                rec.match_id, pickle.loads(wire))
            # ggrs-model: transitions(exported->idle)
            mig.phase = MIG_IDLE
            self._push_route(rec)  # the restored leg has a new port
        except Exception:
            rec.lost = (
                f"migration to {mig.dst!r} failed ({cause}) and the "
                f"source restore failed too")
            self._m_lost.inc()
            self._drop_route(rec)
            _logger.error("match %s lost in migration: %s",
                          rec.match_id, rec.lost)

    # ------------------------------------------------------------------
    # host death + cross-host journal failover
    # ------------------------------------------------------------------

    def kill_host(self, hid: str) -> None:
        """Confirm a whole machine dead (chaos / ops verdict — the
        placement analogue of the §17 watchdog's CONFIRMED-dead rule):
        stop scheduling to it, stop ticking it, and mint a fresh route
        epoch so anything the dead incarnation's supervisor signed is
        refused at the ingress.  Its matches failover on the next
        :meth:`advance_all` from their replicated meta + shared-storage
        journals."""
        if hid not in self.hosts or hid in self._dead:
            return
        self._dead.add(hid)
        self.ring.remove(hid)
        self.route_epoch += 1
        self._update_host_gauge()
        _logger.warning("host %s confirmed dead; route epoch now %d",
                        hid, self.route_epoch)

    def _failover_dead(self) -> None:
        for mid, rec in list(self._records.items()):
            if rec.host not in self._dead or rec.lost is not None:
                continue
            self._failover_match(rec)

    def _failover_match(self, rec: PlacedMatch) -> None:
        mig = _Migration(rec.match_id, None, "?")
        dead_host = rec.host
        meta = rec.meta
        if meta is None:
            rec.lost = "no replicated meta survived the host"
            self._m_lost.inc()
            self._drop_route(rec)
            return
        # the journal on shared storage IS the export (§16): same
        # machine edge, no source to ask
        # ggrs-model: transitions(idle->exported)
        mig.phase = MIG_EXPORTED
        excluded = tuple(self._dead)
        last_err: Optional[Exception] = None
        while True:
            try:
                dst = self.choose_host(rec.match_id, exclude=excluded)
            except FleetError:
                break
            mig.dst = dst
            try:
                self.hosts[dst].adopt_from_meta(
                    pickle.loads(pickle.dumps(
                        meta, protocol=pickle.HIGHEST_PROTOCOL)))
            except Exception as e:
                last_err = e
                excluded = excluded + (dst,)
                continue
            # ggrs-model: transitions(exported->adopted)
            mig.phase = MIG_ADOPTED
            rec.host = dst
            rec.meta = None
            self._push_route(rec)
            # ggrs-model: transitions(adopted->flipped)
            mig.phase = MIG_FLIPPED
            self._m_host_failovers.inc()
            self._record_timeline(
                EV_FAILOVER, rec.match_id,
                detail={"from": dead_host, "to": dst})
            # ggrs-model: transitions(flipped->idle)
            mig.phase = MIG_IDLE
            return
        rec.lost = f"no survivor could adopt: {last_err}"
        self._m_lost.inc()
        self._drop_route(rec)
        _logger.error("match %s lost in host failover: %s",
                      rec.match_id, rec.lost)

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------

    def advance_all(self) -> Dict[str, Dict[str, List[Any]]]:
        """One placement tick: tick every live host, route any
        backoff-parked match that finally placed, replicate failover
        meta, and run cross-host failover for dead hosts' matches.
        The ingress dataplane is pumped by its OWN loop (the runner's
        select loop, or the test driver for an in-process node) — this
        method owns only the control plane."""
        self._tick += 1
        out: Dict[str, Dict[str, List[Any]]] = {}
        for hid, sup in self.hosts.items():
            if hid in self._dead:
                continue
            out[hid] = sup.advance_all()
        for rec in self._records.values():
            if (not rec.routed and rec.lost is None
                    and rec.host not in self._dead):
                self._push_route(rec)
        self._refresh_meta()
        self._failover_dead()
        return out

    def _refresh_meta(self) -> None:
        """Replicate every placed match's failover description — cheap
        plain-data dicts, refreshed each tick so a host can die between
        any two ticks and lose at most one tick of identity drift."""
        for mid, rec in self._records.items():
            if rec.host in self._dead or rec.lost is not None:
                continue
            try:
                rec.meta = self.hosts[rec.host].record_meta(mid)
            except Exception:
                pass  # mid-transfer gap: last good meta stands

    # ------------------------------------------------------------------
    # the serving surface (routed to the serving host)
    # ------------------------------------------------------------------

    def add_local_input(self, match_id: str, handle: int, value) -> None:
        rec = self._record(match_id)
        self.hosts[rec.host].add_local_input(match_id, handle, value)

    def events(self, match_id: str) -> List[Any]:
        rec = self._record(match_id)
        return self.hosts[rec.host].events(match_id)

    def current_frame(self, match_id: str) -> int:
        rec = self._record(match_id)
        return self.hosts[rec.host].current_frame(match_id)

    def match_host(self, match_id: str) -> Optional[str]:
        rec = self._records.get(match_id)
        return None if rec is None else rec.host

    def virtual_endpoint(self, match_id: str) -> Tuple[Tuple[str, int], int]:
        """The match's public truth: (ingress public address, vport) —
        what never changes, whatever happens behind the ingress."""
        rec = self._record(match_id)
        return tuple(self.ingress.public_addr()), rec.vport

    def lost_matches(self) -> Dict[str, str]:
        lost: Dict[str, str] = {
            mid: rec.lost for mid, rec in self._records.items()
            if rec.lost is not None
        }
        for hid, sup in self.hosts.items():
            if hid in self._dead:
                continue
            for mid, why in sup.lost_matches().items():
                lost.setdefault(mid, f"{hid}: {why}")
        return lost

    # ------------------------------------------------------------------
    # obs
    # ------------------------------------------------------------------

    def _update_host_gauge(self) -> None:
        live = len(self.hosts) - len(self._dead)
        self._g_hosts.labels(state="live").set(live)
        self._g_hosts.labels(state="dead").set(len(self._dead))

    def healthz(self) -> Dict[str, Any]:
        """Fleet-of-fleets aggregate: every host's shard records under
        ``host/shard`` keys (each carrying its ``ingress_routes`` count
        for the fleet_top INGRESS column), the ingress info block, and
        one top-level verdict."""
        routes_by_loc: Dict[Tuple[str, str], int] = {}
        for mid, rec in self._records.items():
            if rec.lost is not None or rec.host in self._dead:
                continue
            sid = self.hosts[rec.host].match_location(mid)
            if sid is not None:
                key = (rec.host, sid)
                routes_by_loc[key] = routes_by_loc.get(key, 0) + 1
        shards: Dict[str, Any] = {}
        hosts: Dict[str, Any] = {}
        pending = 0
        ok = True
        for hid, sup in self.hosts.items():
            if hid in self._dead:
                hosts[hid] = dict(ok=False, state="dead")
                for sid in sup.shards:
                    shards[f"{hid}/{sid}"] = dict(
                        ok=False, state="dead", backend="-", matches=0,
                        ingress_routes=0)
                continue
            h = sup.healthz()
            ok = ok and bool(h["ok"])
            pending += h.get("pending_admissions", 0)
            hosts[hid] = dict(ok=h["ok"], state="live",
                              matches=h["matches"], tick=h["tick"],
                              slo=h.get("slo"))
            for sid, sh in h["shards"].items():
                sh = dict(sh)
                sh["ingress_routes"] = routes_by_loc.get((hid, sid), 0)
                shards[f"{hid}/{sid}"] = sh
        lost = self.lost_matches()
        try:
            ing = self.ingress.info()
        except Exception as e:
            ing = dict(error=str(e))
        # §28 rollup: the fleet-of-fleets SLO verdict is the worst
        # host's — one level to page on, per-host detail kept under hosts
        rank = {"ok": 0, "warn": 1, "critical": 2}
        host_levels = {
            hid: (hinfo.get("slo") or {}).get("level")
            for hid, hinfo in hosts.items()
            if (hinfo.get("slo") or {}).get("level")
        }
        slo = None
        if host_levels:
            worst = max(host_levels.values(),
                        key=lambda lv: rank.get(lv, 0))
            slo = dict(level=worst, ok=worst != "critical",
                       hosts=host_levels)
        return dict(
            ok=ok and not lost and bool(hosts),
            tick=self._tick,
            hosts=hosts,
            shards=shards,
            matches=len(self._records) - len(lost),
            pending_admissions=pending,
            lost_matches=len(lost),
            route_epoch=self.route_epoch,
            slo=slo,
            ingress=ing,
        )

    # ------------------------------------------------------------------
    # teardown
    # ------------------------------------------------------------------

    def close(self) -> None:
        for hid, sup in self.hosts.items():
            if hid in self._dead:
                continue
            try:
                sup.close()
            except Exception:
                pass
