"""One fleet shard: a supervised ``HostSessionPool`` plus the per-shard
bookkeeping the :class:`~ggrs_tpu_torch.fleet.supervisor.ShardSupervisor` drives
(DESIGN.md §16).

The port's copy of ``ggrs_tpu/fleet/shard.py``.

A shard owns two classes of matches:

- **bank matches** — admitted before the shard's first tick, stepped by the
  pool's native session bank (one ctypes crossing per tick, §8).  This is
  the steady-state serving shape: the supervisor fills a shard, it seals,
  it serves.
- **adopted matches** — arrived after the seal: live migrations in, crash
  failovers, and late admissions.  Each runs as a per-session Python
  ``P2PSession`` beside the bank (the same fallback tier eviction uses),
  ticked by the shard with the same per-match fault containment.

The shard also owns the durable side of the fleet story: per-match
``MatchJournal``s (attached through the hub so the confirmed stream rides
the tick crossing) and periodic **state checkpoints** embedded in them —
the only game state a dead process leaves behind, and therefore what crash
failover resumes from (``checkpoint_every`` must stay well under the
journal ``tail_window`` or failover cannot pair a checkpoint with the
confirmed inputs that follow it).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..core.errors import (
    GgrsError,
    InvalidRequest,
    NotSynchronized,
    PredictionThreshold,
)
from ..core.types import GgrsRequest, SessionState
from ..obs.registry import Registry, default_registry
from ..obs.slo import ShardSloMeter
from ..obs.timeline import (
    EV_DESYNC,
    EV_EVICT,
    EV_QUARANTINE,
    EV_RETIRE,
    timeline_event,
)
from ..parallel.host_bank import (
    HostSessionPool,
    SLOT_DEAD,
    adopt_resume_bundle,
)
from ..utils.tracing import get_logger

_logger = get_logger("fleet")

# shard lifecycle states (the drain/failover state machine, DESIGN.md §16)
SHARD_ACTIVE = "active"        # admitting and serving
SHARD_DRAINING = "draining"    # serving, admission closed, migrating off
SHARD_RETIRED = "retired"      # drained empty; no longer ticked
SHARD_DEAD = "dead"            # failed health check; matches failed over

# The declared lifecycle transition table (DESIGN.md §16, §22): every
# assignment to a shard's ``state`` — here, in proc.py, and in
# supervisor.py — performs an edge from this table; the ggrs-model
# conformance lint proves it and the §16 lifecycle model
# (analysis/machines.py) is built from it.  RETIRED is absorbing; DEAD
# is not (a failed-over proc shard respawns empty and re-enters
# admission).
SHARD_TRANSITIONS = (
    (SHARD_ACTIVE, SHARD_DRAINING),    # drain begins (admission off)
    (SHARD_DRAINING, SHARD_ACTIVE),    # drain cancelled / re-admitted
    (SHARD_ACTIVE, SHARD_RETIRED),     # retired without a drain phase
    (SHARD_DRAINING, SHARD_RETIRED),   # drained empty
    (SHARD_ACTIVE, SHARD_DEAD),        # failed health check -> failover
    (SHARD_DRAINING, SHARD_DEAD),      # died mid-drain -> failover
    (SHARD_DEAD, SHARD_ACTIVE),        # proc respawn: fresh incarnation
)


class AdoptedMatch:
    """A match running beside the bank on its own Python session: a
    migration/failover arrival (``pending`` leads its next request list
    with the state-restoring prelude) or a post-seal late admission."""

    __slots__ = ("session", "pending", "journal_from", "replay_local")

    def __init__(self, session, pending: Optional[List[GgrsRequest]] = None,
                 journal_from: int = 0,
                 replay_local: Optional[Dict[int, Dict[int, Any]]] = None):
        self.session = session
        self.pending = list(pending or [])
        # the first frame the session's input queues can answer for — a
        # fresh session has history from 0, an adopted one only from the
        # start of its resume window (_journal_adopted must not reach back
        # past it)
        self.journal_from = journal_from
        # crash failover only: {frame: {handle: decoded input}} recovered
        # from the dead incarnation's LOCAL journal tail.  While the
        # resumed session walks back through these frames, the serving
        # loop's inputs are OVERRIDDEN with the recorded values — the dead
        # process already sent them, and re-sending different ones would
        # silently desync every peer that holds the originals.
        self.replay_local = dict(replay_local or {})


class PoolShard:
    """One pool shard behind the fleet placement front.

    Single-threaded like everything session-shaped: the supervisor (or any
    driver) calls ``add_local_input`` per match per tick and then
    ``advance_all()``, which returns ``{match_id: request_list}`` across
    bank and adopted matches alike.
    """

    # backend tag the supervisor branches on ("inproc" serves in the
    # supervisor's process; fleet.proc.ProcShard says "proc")
    backend = "inproc"

    def __init__(
        self,
        shard_id: str,
        *,
        capacity: int = 64,
        metrics: Optional[Registry] = None,
        tracer=None,
        native_io: bool = False,
        retire_dead_matches: bool = False,
        checkpoint_every: int = 32,
        p99_budget_ms: Optional[float] = None,
        stale_after_s: Optional[float] = None,
        tuning=None,
    ) -> None:
        import random
        import zlib

        from ..broadcast import SpectatorHub

        self.shard_id = shard_id
        self.capacity = capacity
        self.metrics = metrics if metrics is not None else default_registry()
        self.pool = HostSessionPool(
            metrics=self.metrics, tracer=tracer, native_io=native_io,
            retire_dead_matches=retire_dead_matches,
            evict_max_per_tick=(
                None if tuning is None else tuning.evict_max_per_tick
            ),
        )
        # seeded from the shard id: identical topologies then produce
        # identical viewer magics — the control/chaos comparison contract
        self.hub = SpectatorHub(
            self.pool, rng=random.Random(zlib.crc32(shard_id.encode()))
        )
        self.state = SHARD_ACTIVE
        self.killed = False  # chaos switch: simulated process death
        self.ticks = 0
        self.checkpoint_every = checkpoint_every
        self.p99_budget_ms = p99_budget_ms
        self.stale_after_s = stale_after_s
        self._started = False
        self._matches: Dict[str, int] = {}          # match_id -> bank slot
        self._adopted: Dict[str, AdoptedMatch] = {}
        self._dead_matches: Dict[str, str] = {}     # match_id -> reason
        self._journals: Dict[str, Any] = {}
        self._encoders: Dict[str, Any] = {}         # match_id -> input_encode
        self._pending_journals: List[Tuple[int, Any]] = []
        self._pending_viewers: List[Tuple[int, Any]] = []
        self._ckpt_next: Dict[str, int] = {}
        self._ckpt_disabled: set = set()
        self._tick_ms: deque = deque(maxlen=128)
        # matches whose journal degraded (write failure): the shard keeps
        # serving them, but failover must treat them as journal-less —
        # the durable tip stopped tracking what the match acks (§17)
        self._journal_failed: set = set()
        # the forensics ferry (DESIGN.md §18): flight-recorder dumps and
        # DesyncReports captured the moment a slot quarantines/evicts/
        # dies, held until drain_forensics() ships them — on a
        # process-backed shard that ship rides the next tick/heartbeat
        # reply, so the artifact outlives the child that produced it
        self._forensic_items: List[Dict[str, Any]] = []
        self._slot_last_state: Dict[str, str] = {}
        # the timeline ferry (DESIGN.md §28): match-lifecycle events
        # buffered exactly like forensics until drain_timeline() ships
        # them on the next tick/heartbeat reply — zero extra round trips
        self._timeline_items: List[Dict[str, Any]] = []
        # a short per-match event history kept AFTER draining, so a
        # DesyncReport captured late still embeds the match's lifecycle
        # context (§28's "every DesyncReport carries its timeline")
        self._timeline_history: Dict[str, List[Dict[str, Any]]] = {}
        # per-tier SLO budget-compliance counters (§28), fed from the
        # tick timer this loop already runs — they ride the registry
        # harvest, adding zero crossings and zero RPCs
        self.slo = ShardSloMeter(self.metrics)
        # pool-level lifecycle emissions (host_bank §28 seam): the pool
        # reports by slot, the shard translates to match ids
        self.pool.timeline_sink = self._pool_timeline_event
        m = self.metrics
        self._g_matches = m.gauge(
            "ggrs_shard_matches", "matches served per shard, by tier",
            labels=("shard", "tier"))
        self._g_p99 = m.gauge(
            "ggrs_shard_tick_p99_ms",
            "shard tick p99 over the last 128 ticks (admission signal)",
            labels=("shard",))
        self._m_journal_failures = m.counter(
            "ggrs_shard_journal_failures_total",
            "matches whose journal degraded on a write failure",
            labels=("shard",))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    @property
    def sealed(self) -> bool:
        """The pool finalized: new matches can only be adopted (per-session
        tier), not added to the bank."""
        return self.pool._finalized

    def live_matches(self) -> int:
        return len(self._matches) + len(self._adopted)

    def match_ids(self) -> List[str]:
        return list(self._matches) + list(self._adopted)

    def has_match(self, match_id: str) -> bool:
        return match_id in self._matches or match_id in self._adopted

    def is_bank_match(self, match_id: str) -> bool:
        """Bank-tier (native-harvest-exportable) vs adopted-tier — the
        supervisor's migrate() branches on this instead of reaching into
        ``_matches`` so process-backed shards can answer from cache."""
        return match_id in self._matches

    def journal_failed_matches(self) -> List[str]:
        """Matches whose journal degraded on a write failure — the
        supervisor marks them journal-less for failover purposes."""
        return sorted(self._journal_failed)

    def match_port(self, match_id: str) -> Optional[int]:
        """The UDP port the match's host socket bound, when determinable
        (None for in-memory networks) — how a driver that admitted
        through a port-0 socket factory learns where to aim the peer."""
        sock = None
        slot = self._matches.get(match_id)
        if slot is not None and slot < len(self.pool._builders):
            sock = self.pool._builders[slot][1]
        else:
            am = self._adopted.get(match_id)
            if am is not None:
                sock = getattr(am.session, "_socket", None)
        port = getattr(sock, "local_port", None)
        return port() if callable(port) else None

    def admission_refusal(self) -> Optional[str]:
        """Why this shard refuses a new match right now, or None — the
        capacity-aware admission check, driven by the shard's own
        observables: lifecycle state, slot occupancy vs ``capacity``, the
        tick-p99 gauge vs ``p99_budget_ms``, and ``/healthz``-style
        last-tick staleness vs ``stale_after_s``."""
        if self.killed or self.state == SHARD_DEAD:
            return "dead"
        if self.state == SHARD_DRAINING:
            return "draining"
        if self.state == SHARD_RETIRED:
            return "retired"
        if self.live_matches() >= self.capacity:
            return "full"
        if self.p99_budget_ms is not None and self._tick_ms:
            if self.tick_p99_ms() > self.p99_budget_ms:
                return "overloaded"
        if self.stale_after_s is not None:
            last = self.pool.last_tick_at
            if last is not None and (
                time.monotonic() - last > self.stale_after_s
            ):
                return "stale"
        return None

    def admit(self, match_id: str, builder, socket, *,
              journal=None) -> str:
        """Admit one match.  Before the first tick it lands in the bank
        (the pool is still open); afterwards it starts as an adopted
        per-session match — the late-admission tier.  Returns ``"bank"``
        or ``"standalone"``.  ``journal``: a ``MatchJournal`` tapped on the
        confirmed stream (bank tier: from the tick crossing via the hub;
        adopted tier: through a ``JournalTap``)."""
        if self.has_match(match_id):
            raise InvalidRequest(f"match {match_id!r} already on this shard")
        refusal = self.admission_refusal()
        if refusal is not None:
            raise InvalidRequest(
                f"shard {self.shard_id} refuses admission: {refusal}"
            )
        if not self.sealed:
            slot = self.pool.add_session(builder, socket)
            self._matches[match_id] = slot
            if journal is not None:
                self._journals[match_id] = journal
                self._encoders[match_id] = builder._config.input_encode
                self._pending_journals.append((slot, journal))
            self._update_match_gauges()
            return "bank"
        session = builder.start_p2p_session(socket)
        if journal is not None:
            # adopted matches journal SYNCHRONOUSLY from the sync layer
            # after each tick (_journal_adopted), not through a
            # JournalTap: the tap rides the spectator relay, which trails
            # the confirmed watermark — and any frame acked beyond the
            # durable tip is unrecoverable after a crash (§16, the
            # durable-ack window)
            self._journals[match_id] = journal
            self._encoders[match_id] = builder._config.input_encode
        self._adopted[match_id] = AdoptedMatch(session)
        self._update_match_gauges()
        return "standalone"

    def attach_viewer(self, match_id: str, addr) -> None:
        """Register a spectator on a bank match (deferred to the shard's
        start when the pool has not finalized yet; adopted matches graft a
        live endpoint immediately through the hub's fallback path)."""
        slot = self._matches.get(match_id)
        if slot is None:
            raise InvalidRequest(
                f"match {match_id!r} is not a bank match on this shard"
            )
        if not self._started:
            self._pending_viewers.append((slot, addr))
            return
        self.hub.attach(slot, addr)

    # ------------------------------------------------------------------
    # ticking
    # ------------------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._started:
            return
        self._started = True
        self.pool.native_active  # lazy finalize (seals bank admission)
        for slot, journal in self._pending_journals:
            self.hub.attach_journal(slot, journal)
        self._pending_journals = []
        for slot, addr in self._pending_viewers:
            self.hub.attach(slot, addr)
        self._pending_viewers = []

    def add_local_input(self, match_id: str, handle: int, value) -> None:
        slot = self._matches.get(match_id)
        if slot is not None:
            self._journal_local(match_id, self.pool.current_frame(slot),
                               handle, value)
            self.pool.add_local_input(slot, handle, value)
            return
        am = self._adopted.get(match_id)
        if am is not None:
            frame = am.session.current_frame
            rep = am.replay_local
            if rep:
                # crash-failover replay window: substitute the recorded
                # value while re-walking frames the dead incarnation sent
                recorded = rep.get(frame, {})
                if handle in recorded:
                    value = recorded[handle]
                for f in [f for f in rep if f < frame]:
                    del rep[f]
            self._journal_local(match_id, frame, handle, value)
            am.session.add_local_input(handle, value)
        # dead/unknown matches swallow inputs, like dead pool slots

    def _journal_local(self, match_id: str, frame: int, handle: int,
                       value) -> None:
        """Journal a staged local input at staging time (ahead of the
        confirmed stream) — fsynced by the pre-send barrier in
        ``advance_all`` so everything the tick SENDS is durable first."""
        journal = self._journals.get(match_id)
        encode = self._encoders.get(match_id)
        if journal is None or encode is None:
            return
        try:
            journal.append_local_input(frame, handle, encode(value))
        except Exception:
            pass  # journaling must never take the serving path down

    def advance_all(self) -> Dict[str, List[GgrsRequest]]:
        """One shard tick: the pool's single crossing plus every adopted
        session's tick, with per-match containment.  Returns the per-match
        request lists; a killed/retired/dead shard returns {} (nothing
        here ticks — the supervisor fails its matches over)."""
        if self.killed or self.state in (SHARD_RETIRED, SHARD_DEAD):
            return {}
        self._ensure_started()
        t0 = time.perf_counter()
        # the durable-before-send barrier: every LOCAL input staged since
        # the last tick fsyncs BEFORE the crossing sends it — a crash can
        # then never leave the peers holding frames the journal lacks
        for journal in self._journals.values():
            journal.flush_local()
        # journal write-failure sweep: a degraded journal (ENOSPC/EIO —
        # the MatchJournal stops writing and flags itself) must degrade
        # the SHARD loudly, not silently drop records: fault counter +
        # health flag, and the supervisor marks the match journal-less
        # for failover purposes
        for match_id, journal in self._journals.items():
            if journal.failed is not None and (
                match_id not in self._journal_failed
            ):
                self._journal_failed.add(match_id)
                self._m_journal_failures.labels(shard=self.shard_id).inc()
                _logger.error(
                    "shard %s match %s: journal degraded (%s); match is "
                    "journal-less for failover until re-incarnated",
                    self.shard_id, match_id, journal.failed,
                )
        # Checkpoint BEFORE this tick steps, from last tick's fully
        # fulfilled state.  Checkpointing after the step would read save
        # cells whose corrective rollback re-saves are still unfulfilled
        # in the just-returned request lists: a rollback that fixes frame
        # F ≤ the new watermark leaves cell F stale (with cell.frame == F,
        # so the two-candidate rule cannot tell) until the caller fulfills
        # it — a checkpoint taken in that window captures mispredicted
        # state, and a journal-path migration/failover that resumes from
        # it desyncs permanently (the chaos shard_migrate desync).
        self._maybe_checkpoint()
        out: Dict[str, List[GgrsRequest]] = {}
        lists = self.pool.advance_all()
        for match_id, slot in self._matches.items():
            out[match_id] = lists[slot]
        self._sweep_slot_forensics()
        for match_id in list(self._adopted):
            out[match_id] = self._tick_adopted(match_id)
            am = self._adopted.get(match_id)
            if am is not None:
                self._journal_adopted(match_id, am)
        self.ticks += 1
        tick_ms = (time.perf_counter() - t0) * 1000.0
        self._tick_ms.append(tick_ms)
        self._g_p99.labels(shard=self.shard_id).set(self.tick_p99_ms())
        # SLO compliance (§28): the rollback tier against the frame
        # budget from the tick timer above; the lockstep tier against
        # its confirmed-lag budget, read straight off the Python-tier
        # sessions the lockstep slots already run on (no crossing)
        self.slo.observe_rollback(tick_ms)
        lockstep = self.pool.lockstep_slots()
        if lockstep:
            worst = 0
            for slot in lockstep:
                try:
                    lag = (self.pool.current_frame(slot)
                           - self.pool.last_confirmed_frame(slot))
                except Exception:
                    continue
                if lag > worst:
                    worst = lag
            self.slo.observe_lockstep(worst)
        return out

    def _sweep_slot_forensics(self) -> None:
        """Capture the post-mortem the instant a bank slot leaves native
        (quarantined / evicted / dead): flight-recorder dump, fault log
        tail, and any DesyncReport — into the ferry buffer
        ``drain_forensics`` ships (DESIGN.md §18).

        Incremental (DESIGN.md §19): driven by the pool's supervision
        transition feed instead of polling every match's slot state every
        tick — on the quiet steady state this is one empty-list drain.
        Pools without the feed (user-supplied stand-ins) keep the legacy
        full walk."""
        drain = getattr(self.pool, "drain_state_transitions", None)
        if drain is not None:
            transitions = drain()
            if not transitions:
                return  # the quiet steady state: one empty-list drain
            slot_to_match = {s: m for m, s in self._matches.items()}
            for slot, _old, state, _tick in transitions:
                match_id = slot_to_match.get(slot)
                if match_id is None:
                    continue
                self._slot_last_state[match_id] = state
                if state not in ("quarantined", "evicted", "dead"):
                    continue
                self._capture_slot_forensic(match_id, slot, state)
            return
        for match_id, slot in self._matches.items():
            try:
                state = self.pool.slot_state(slot)
            except Exception:
                continue
            prev = self._slot_last_state.get(match_id)
            self._slot_last_state[match_id] = state
            if state == prev or state not in (
                "quarantined", "evicted", "dead"
            ):
                continue
            self._capture_slot_forensic(match_id, slot, state)

    def _capture_slot_forensic(self, match_id: str, slot: int,
                               state: str) -> None:
        """Build one slot post-mortem item into the ferry buffer."""
        item: Dict[str, Any] = dict(
            kind="slot", match=match_id, slot=slot, state=state,
            tick=self.ticks,
        )
        try:
            item["dump"] = self.pool.flight_dump(slot, 32)
        except Exception:
            pass
        try:
            item["faults"] = [
                dict(tick=f.tick, code=f.code, detail=f.detail)
                for f in self.pool.fault_log(slot)[-8:]
            ]
        except Exception:
            pass
        try:
            report = self.pool.desync_report(slot)
            if report is not None:
                item["desync_report"] = report.to_dict()
        except Exception:
            pass
        if state == "quarantined":
            self._record_timeline(EV_QUARANTINE, match_id,
                                  {"slot": slot})
        if "desync_report" in item:
            self._record_timeline(EV_DESYNC, match_id, {"slot": slot})
            # every DesyncReport carries its match's lifecycle context
            # (§28) — the events that led here, late-captured included
            item["desync_report"]["timeline"] = list(
                self._timeline_history.get(match_id, ())
            )
        self._record_forensic(item)

    def _record_forensic(self, item: Dict[str, Any]) -> None:
        self._forensic_items.append(item)
        del self._forensic_items[:-32]  # bounded while undrained

    def drain_forensics(self) -> List[Dict[str, Any]]:
        """Ship-and-clear the ferry buffer (plain JSON-safe dicts)."""
        out = self._forensic_items
        self._forensic_items = []
        return out

    # ------------------------------------------------------------------
    # the timeline ferry (DESIGN.md §28)
    # ------------------------------------------------------------------

    def _record_timeline(self, etype: str, match_id: str,
                         detail: Optional[Dict[str, Any]] = None) -> None:
        ev = timeline_event(
            etype, match_id, origin=self.shard_id, tick=self.ticks,
            detail=detail,
        )
        self._timeline_items.append(ev)
        del self._timeline_items[:-64]  # bounded while undrained
        hist = self._timeline_history.setdefault(match_id, [])
        hist.append(ev)
        del hist[:-16]

    def _pool_timeline_event(self, etype: str, slot: int,
                             detail: Optional[Dict[str, Any]]) -> None:
        """The pool's §28 emission seam: translate its slot-keyed event
        to the match id this shard placed there."""
        for match_id, s in self._matches.items():
            if s == slot:
                self._record_timeline(etype, match_id, detail)
                return

    def drain_timeline(self) -> List[Dict[str, Any]]:
        """Ship-and-clear the timeline buffer — rides the same tick
        reply / heartbeat payloads as :meth:`drain_forensics`."""
        out = self._timeline_items
        self._timeline_items = []
        return out

    def scrape(self):
        """One stats scrape of the underlying pool (refreshes the
        ``ggrs_io_*`` / per-slot gauges the obs snapshot then exports);
        the runner drives this on ``FleetTuning.obs_scrape_every``."""
        return self.pool.scrape()

    def _tick_adopted(self, match_id: str) -> List[GgrsRequest]:
        am = self._adopted[match_id]
        session = am.session
        try:
            if session.current_state() is SessionState.SYNCHRONIZING:
                session.poll_remote_clients()
                if session.current_state() is SessionState.SYNCHRONIZING:
                    return []
            reqs = session.advance_frame()
        except (NotSynchronized, PredictionThreshold):
            # backpressure, not a fault: skip this match's tick (the game
            # loop's standard reaction), keep its staged inputs
            return []
        except GgrsError:
            raise
        except Exception as e:  # containment: one bad match, not the shard
            reason = f"adopted tick: {type(e).__name__}: {e}"
            self._dead_matches[match_id] = reason
            del self._adopted[match_id]
            self._update_match_gauges()
            self._record_forensic(dict(
                kind="adopted", match=match_id, reason=reason,
                tick=self.ticks,
            ))
            self._record_timeline(EV_QUARANTINE, match_id,
                                  {"reason": reason})
            _logger.error("shard %s match %s marked dead: %s",
                          self.shard_id, match_id, reason)
            return []
        if am.pending:
            # migration/failover prelude: restore (and, for failover,
            # rebuild) the resume state BEFORE this tick's own requests
            reqs = am.pending + reqs
            am.pending = []
        return reqs

    def _journal_adopted(self, match_id: str, am: AdoptedMatch) -> None:
        """Journal an adopted match's newly-confirmed frames straight from
        its sync layer — synchronous with the confirmed watermark, so the
        durable tip never trails what the session has acked to its peers
        (with ``fsync_every=1`` that makes crash failover lossless; a
        relay-based ``JournalTap`` would lag by the fan-out deferral)."""
        journal = self._journals.get(match_id)
        if journal is None:
            return
        session = am.session
        confirmed = session._sync_layer.last_confirmed_frame
        start = max(journal.next_frame, am.journal_from)
        if confirmed < start:
            return
        # a long stall can outrun the input queues; the forward jump below
        # is recorded by the journal as an explicit GAP, never papered over
        start = max(start, confirmed - 120)
        config = session._config
        isize = journal.input_size
        players = journal.num_players
        records = []
        for frame in range(start, confirmed + 1):
            flags = bytearray(players)
            parts = []
            for p in range(players):
                try:
                    pi = session._sync_layer.confirmed_input(p, frame)
                except AssertionError:
                    pi = None  # queue holds nothing for p at this frame
                if pi is None or pi.frame != frame:
                    flags[p] = 1  # disconnected below this frame
                    parts.append(bytes(isize))
                else:
                    parts.append(config.input_encode(pi.input))
            records.append((bytes(flags), b"".join(parts)))
        journal.append_frames(start, records)

    def tick_p99_ms(self) -> float:
        if not self._tick_ms:
            return 0.0
        ordered = sorted(self._tick_ms)
        return ordered[min(len(ordered) - 1, (len(ordered) * 99) // 100)]

    def events(self, match_id: str) -> List:
        slot = self._matches.get(match_id)
        if slot is not None:
            return self.pool.events(slot)
        am = self._adopted.get(match_id)
        return am.session.events() if am is not None else []

    def current_frame(self, match_id: str) -> int:
        slot = self._matches.get(match_id)
        if slot is not None:
            return self.pool.current_frame(slot)
        am = self._adopted.get(match_id)
        if am is None:
            raise InvalidRequest(f"no match {match_id!r} on this shard")
        return am.session.current_frame

    # ------------------------------------------------------------------
    # migration seam
    # ------------------------------------------------------------------

    def evict_match(self, match_id: str) -> Dict[str, Any]:
        """Export + release one bank match (the source half of live
        migration): one harvest crossing builds the portable resume
        bundle, then the slot is released (native I/O detached, journal
        tap dropped, state MIGRATED) and the match forgotten here.  The
        shard's journal for the match is closed — the destination journals
        its own incarnation."""
        slot = self._matches.get(match_id)
        if slot is None:
            raise InvalidRequest(
                f"match {match_id!r} has no bank slot on shard "
                f"{self.shard_id} (adopted matches migrate via their "
                "journal)"
            )
        self._ensure_started()
        bundle = self.pool.export_resume_state(slot)
        self.pool.release_slot(
            slot, detail=f"migrated off shard {self.shard_id}"
        )
        self._record_timeline(EV_EVICT, match_id, {"slot": slot})
        del self._matches[match_id]
        self._slot_last_state.pop(match_id, None)
        self._close_journal(match_id)
        self._update_match_gauges()
        return bundle

    def demote_match(self, match_id: str) -> int:
        """Load-shedding (DESIGN.md §27): demote one
        bank-tier match to the lockstep tier.  The match keeps its
        slot, its wire address, and its journal tap, but runs from
        here on as a ``max_prediction == 0`` per-session fallback —
        zero save/load work, no rollback re-simulation, confirmed
        frames only.  The cheap tier a shard answering "overloaded"
        from :meth:`admission_refusal` sheds into before refusing
        players outright.  Returns the resume frame.  One-way:
        re-promotion to the bank is a migration concern."""
        slot = self._matches.get(match_id)
        if slot is None:
            raise InvalidRequest(
                f"match {match_id!r} has no bank slot on shard "
                f"{self.shard_id} (adopted matches already run "
                "per-session; rebuild them lockstep instead)"
            )
        self._ensure_started()
        return self.pool.demote_to_lockstep(slot)

    def lockstep_matches(self) -> List[str]:
        """Bank matches demoted to the lockstep tier, by match id."""
        return sorted(
            mid for mid, slot in self._matches.items()
            if self.pool.in_lockstep(slot)
        )

    def drop_match(self, match_id: str, reason: str) -> None:
        """Forget a match without exporting (journal-path migration of an
        adopted match, or failover bookkeeping on a dead shard)."""
        slot = self._matches.pop(match_id, None)
        if slot is not None and not self.killed:
            try:
                self.pool.release_slot(slot, detail=reason)
            except Exception:
                pass
        self._adopted.pop(match_id, None)
        self._slot_last_state.pop(match_id, None)
        self._close_journal(match_id)
        self._update_match_gauges()

    def adopt_match(self, match_id: str, builder, socket,
                    bundle: Dict[str, Any], *,
                    saved_states=None,
                    prelude: Optional[List[GgrsRequest]] = None,
                    journal=None,
                    replay_local: Optional[Dict[int, Dict[int, Any]]] = None,
                    ) -> None:
        """Resume a migrated/failed-over match on this shard (destination
        half): builds the Python session through
        ``parallel.host_bank.adopt_resume_bundle`` and queues the
        state-restoring prelude as the head of the match's next request
        list.  ``prelude`` defaults to the bundle's single
        ``LoadGameState``; crash failover passes the longer
        load-checkpoint → advance-to-tip → save sequence."""
        if self.has_match(match_id):
            raise InvalidRequest(f"match {match_id!r} already on this shard")
        # journal=None to the adoption seam: the shard journals adopted
        # matches synchronously post-tick (see admit), not via JournalTap
        session, load = adopt_resume_bundle(
            builder, socket, bundle, saved_states=saved_states,
        )
        if journal is not None:
            self._journals[match_id] = journal
            self._encoders[match_id] = builder._config.input_encode
        # the new incarnation's journal can only reach back to the start
        # of the adopted input window; journaling that full window (not
        # just resume_frame+1) keeps the first post-adoption checkpoint
        # immediately pairable with in-window confirmed inputs
        starts = [
            start for start, blobs in bundle["harvest"]["player_inputs"]
            if blobs
        ]
        self._adopted[match_id] = AdoptedMatch(
            session, prelude if prelude is not None else [load],
            journal_from=(
                min(starts) if starts else bundle["resume_frame"] + 1
            ),
            replay_local=replay_local,
        )
        self._update_match_gauges()

    def wire_identity(self, match_id: str) -> Dict[str, Any]:
        """The match's peer-visible identity — endpoint/spectator magics,
        handles, liveness — refreshed into the supervisor's registry while
        the shard is healthy, so crash failover can rebuild endpoints the
        dead process can no longer describe."""
        slot = self._matches.get(match_id)
        if slot is not None and self.pool._native_active:
            m = self.pool._mirrors[slot]
            return dict(
                local_handles=list(m.local_handles),
                endpoints=[
                    dict(addr=ep.addr, handles=list(ep.handles),
                         magic=ep.magic, running=ep.running)
                    for ep in m.endpoints
                ],
                spectators=[
                    dict(addr=sp.addr, magic=sp.magic,
                         handles=list(sp.handles), running=sp.running)
                    for sp in m.spectators
                ],
            )
        session = None
        if slot is not None:
            session = self.pool.session(slot)
        else:
            am = self._adopted.get(match_id)
            if am is not None:
                session = am.session
        if session is None:
            raise InvalidRequest(f"no match {match_id!r} on this shard")
        return dict(
            local_handles=sorted(session._local_handles),
            endpoints=[
                dict(addr=addr, handles=list(ep.handles), magic=ep.magic,
                     running=ep.is_running())
                for addr, ep in session._player_reg.remotes.items()
            ],
            spectators=[
                dict(addr=addr, magic=ep.magic,
                     handles=list(getattr(ep, "handles", ())),
                     running=ep.is_running())
                for addr, ep in session._player_reg.spectators.items()
                if hasattr(ep, "_core")  # journal taps have no wire state
            ],
        )

    # ------------------------------------------------------------------
    # checkpoints (the durable half of crash failover)
    # ------------------------------------------------------------------

    def _saved_and_confirmed(self, match_id: str):
        slot = self._matches.get(match_id)
        if slot is not None:
            if self.pool._native_active:
                if self.pool.slot_state(slot) != "native":
                    return None, None
                return (self.pool._mirrors[slot].saved_states,
                        self.pool.last_confirmed_frame(slot))
            session = self.pool.session(slot)
        else:
            am = self._adopted.get(match_id)
            if am is None:
                return None, None
            session = am.session
        return (session._sync_layer.saved_states,
                session._sync_layer.last_confirmed_frame)

    def checkpoint_now(self, match_id: str) -> None:
        """Append a state checkpoint for one match NOW, cadence aside —
        the cross-host export seam (DESIGN.md §26) calls this before a
        journal-path transfer so the resume window always holds a fresh
        checkpoint (and the fast-forward prelude stays one save long)
        even when the match is younger than ``checkpoint_every``.  Same
        safety condition as the cadence path: runs between ticks, from
        last tick's fully fulfilled save cells."""
        self._maybe_checkpoint(only=match_id, force=True)

    def _maybe_checkpoint(self, only: Optional[str] = None,
                          force: bool = False) -> None:
        every = self.checkpoint_every
        if not every and not force:
            return
        for match_id, journal in self._journals.items():
            if only is not None and match_id != only:
                continue
            if match_id in self._ckpt_disabled:
                continue
            saved, confirmed = self._saved_and_confirmed(match_id)
            if saved is None or confirmed is None or confirmed < 0:
                continue
            if not force and confirmed < self._ckpt_next.get(
                    match_id, every):
                continue
            # the newest committed frame whose save the game fulfilled
            # (the same two-candidate rule the resume selection uses)
            frame = None
            for r in (confirmed, confirmed - 1):
                if r >= 0 and saved.get_cell(r).frame == r:
                    frame = r
                    break
            if frame is None:
                continue
            cell = saved.get_cell(frame)
            try:
                journal.append_checkpoint(frame, cell.data())
            except Exception as e:
                # a non-pytree game state cannot checkpoint: failover for
                # this match degrades to "unrecoverable", loudly, once
                self._ckpt_disabled.add(match_id)
                _logger.warning(
                    "shard %s match %s: state checkpoint failed (%s); "
                    "journal failover disabled for this match",
                    self.shard_id, match_id, e,
                )
                continue
            self._ckpt_next[match_id] = frame + every

    def _close_journal(self, match_id: str) -> None:
        journal = self._journals.pop(match_id, None)
        self._encoders.pop(match_id, None)
        self._ckpt_next.pop(match_id, None)
        self._ckpt_disabled.discard(match_id)
        self._journal_failed.discard(match_id)
        if journal is not None:
            try:
                journal.close()
            except Exception:
                pass

    # ------------------------------------------------------------------
    # lifecycle + health
    # ------------------------------------------------------------------

    def kill(self) -> None:
        """Chaos switch: simulate the shard process dying mid-tick.  The
        shard stops ticking instantly; nothing is flushed or released —
        recovery must come from the durable journals alone."""
        self.killed = True

    def inject_match_error(self, match_id: str,
                           code: Optional[int] = None) -> None:
        """Chaos/test seam: inject a native slot fault into one BANK
        match (the ctrl-op channel the §9 chaos harness drives) —
        reachable over the runner RPC so the forensics ferry can be
        exercised end-to-end on a process-backed shard."""
        slot = self._matches.get(match_id)
        if slot is None:
            raise InvalidRequest(
                f"match {match_id!r} is not a bank match on this shard"
            )
        self._ensure_started()
        self.pool.inject_slot_error(slot, code)

    def retire(self) -> None:
        # ggrs-model: transitions(active->retired, draining->retired)
        self.state = SHARD_RETIRED
        for match_id in self.match_ids():
            self._record_timeline(EV_RETIRE, match_id)
        for match_id in list(self._journals):
            self._close_journal(match_id)

    def flush_journals(self, close: bool = False) -> None:
        """Fsync (or close: CLOSE record + fsync) every journal — the
        shard runner's graceful-drain step, so a SIGTERM'd process leaves
        journals durable to the last served frame."""
        for match_id in list(self._journals):
            if close:
                self._close_journal(match_id)
            else:
                try:
                    self._journals[match_id].flush(fsync=True)
                except Exception:
                    pass  # a degraded journal already no-ops/flags

    def close(self) -> None:
        """Release durable resources (journal fds).  Lifecycle state is
        untouched — this is the supervisor's shutdown hook, not a drain."""
        for match_id in list(self._journals):
            self._close_journal(match_id)

    def healthz(self) -> Dict[str, Any]:
        """Per-shard health record (aggregated fleet-wide by
        ``ShardSupervisor.healthz``)."""
        last = self.pool.last_tick_at
        age = None if last is None else max(0.0, time.monotonic() - last)
        ok = (
            not self.killed
            and self.state in (SHARD_ACTIVE, SHARD_DRAINING)
        )
        if ok and self.stale_after_s is not None and age is not None:
            ok = age <= self.stale_after_s
        return dict(
            shard=self.shard_id,
            state=SHARD_DEAD if self.killed else self.state,
            ok=ok,
            matches=self.live_matches(),
            bank_matches=len(self._matches),
            adopted_matches=len(self._adopted),
            dead_matches=len(self._dead_matches),
            journal_failed=len(self._journal_failed),
            capacity=self.capacity,
            ticks=self.ticks,
            last_tick_age_s=age,
            tick_p99_ms=self.tick_p99_ms(),
        )

    def dead_slot_count(self) -> int:
        if not self.pool._finalized:
            return 0
        return sum(
            1 for i in range(len(self.pool))
            if self.pool.slot_state(i) == SLOT_DEAD
        )

    def _update_match_gauges(self) -> None:
        self._g_matches.labels(shard=self.shard_id, tier="bank").set(
            len(self._matches)
        )
        self._g_matches.labels(shard=self.shard_id, tier="adopted").set(
            len(self._adopted)
        )
