"""ShardSupervisor: the fleet's placement/drain/failover control plane
(DESIGN.md §16).

The port's copy of ``ggrs_tpu/fleet/supervisor.py``.

One supervisor owns N :class:`~ggrs_tpu_torch.fleet.shard.PoolShard` shards
(threads or subprocesses sharing the host — here: in-process pools, each
with its own native bank) behind a placement front:

- **admission** — consistent-hash owner first
  (:class:`~ggrs_tpu_torch.fleet.placement.HashRing`), then the ring's fallback
  order, each shard consulted through its capacity-aware
  ``admission_refusal`` check (slot occupancy, tick p99, ``/healthz``
  staleness).  A fully-refused match parks in a retry queue with
  exponential backoff plus seeded jitter — a thundering re-admission herd
  after a shard-wide event must not hammer one tick.
- **live migration** — ``migrate(match_id, dst)``: export on the source
  via the harvest seam (``HostSessionPool.export_resume_state``, falling
  back to the journal when the native harvest is dead), force the bundle
  through a serialize→deserialize round trip (the process-portability
  contract, pinned by tests), adopt on the destination
  (``adopt_resume_bundle``), re-attach the journal tap.  Peers and
  viewers see a retransmission hiccup, never a reset.
- **graceful drain** — ``drain(shard)``: admission closes, matches
  migrate off a few per tick (bounded work per tick), the empty shard
  retires.
- **crash failover** — a failed health check (or the chaos ``kill``)
  marks the shard dead; every match on it re-adopts onto survivors from
  its DURABLE journal alone (``broadcast.journal.resume_from_file``):
  the newest embedded state checkpoint, fast-forwarded to the last
  durable frame through a request prelude the game fulfills, plus the
  wire identity the supervisor cached while the shard was healthy.
  Matches without a usable checkpoint are counted lost, loudly.

The supervisor is single-threaded like everything session-shaped: the
serving loop calls ``add_local_input`` per match and ``advance_all()``
once per tick; control-plane work (drain steps, health checks, admission
retries) rides the same tick.
"""

from __future__ import annotations

import errno
import os
import pickle
import random
import time
from typing import Any, Callable, Dict, List, Optional

from ..core.errors import GgrsError, InvalidRequest
from ..core.sync_layer import SavedStates
from ..core.types import (
    AdvanceFrame,
    GgrsRequest,
    InputStatus,
    LoadGameState,
    SaveGameState,
)
from ..obs.fleet_obs import FleetObs
from ..obs.registry import MultiRegistry, Registry, default_registry
from ..obs.slo import BurnRateEngine
from ..obs.timeline import (
    EV_ADMIT,
    EV_FAILOVER,
    EV_MIGRATE_ABORT,
    EV_MIGRATE_BEGIN,
    EV_MIGRATE_COMMIT,
)
from ..obs.trace import NULL_TRACER
from ..utils.tracing import get_logger
from .placement import HashRing
from .rpc import PICKLE_PROTOCOL, FrameError, RpcError, RpcTimeout
from .shard import (
    PoolShard,
    SHARD_ACTIVE,
    SHARD_DEAD,
    SHARD_DRAINING,
    SHARD_RETIRED,
)
from .tuning import FleetTuning

_logger = get_logger("fleet")

# re-admission retry policy (satellite of DESIGN.md §16): exponential
# backoff with seeded jitter, bounded attempts.  These module constants
# are the documented defaults; each supervisor instance reads its OWN
# FleetTuning (readmit_backoff_ticks / readmit_max_attempts), which
# defaults to these values — see fleet/tuning.py.
READMIT_BACKOFF_TICKS = 8
READMIT_MAX_ATTEMPTS = 6


class FleetError(GgrsError):
    """A fleet-layer operation failed (placement, migration, failover)."""


class MatchRecord:
    """Control-plane registry entry for one match: how to rebuild it
    (factories), where it lives, its journal incarnations, and the cached
    wire identity crash failover needs when the serving process is gone."""

    __slots__ = (
        "match_id", "builder_factory", "socket_factory", "state_template",
        "journaled", "location", "incarnation", "journal_paths",
        "identity", "lost", "num_players", "input_size", "max_prediction",
        "local_handles", "game_factory", "journal_failed",
    )

    def __init__(self, match_id: str, builder_factory, socket_factory,
                 state_template, game_factory=None) -> None:
        self.match_id = match_id
        self.builder_factory = builder_factory
        self.socket_factory = socket_factory
        self.state_template = state_template
        # process-backed shards fulfill requests IN the runner: a
        # picklable callable returning an object with .fulfill(requests).
        # None keeps the match placeable on in-process shards only.
        self.game_factory = game_factory
        self.journaled = False
        # the CURRENT incarnation's journal degraded on a write failure:
        # its durable tip no longer tracks what the live match acks, so
        # failover must treat the match as journal-less (resuming from a
        # stale tip would silently desync the peers)
        self.journal_failed = False
        self.location: Optional[str] = None
        self.incarnation = 0
        self.journal_paths: List[str] = []
        self.identity: Optional[Dict[str, Any]] = None
        self.lost: Optional[str] = None
        self.num_players = 0
        self.input_size = 0
        self.max_prediction = 0
        self.local_handles: List[int] = []


class _PendingAdmission:
    __slots__ = ("record", "attempts", "next_try")

    def __init__(self, record: MatchRecord, attempts: int, next_try: int):
        self.record = record
        self.attempts = attempts
        self.next_try = next_try


class ShardSupervisor:
    """N pool shards behind one placement/drain/failover front."""

    def __init__(
        self,
        shard_ids=("shard0", "shard1"),
        *,
        capacity: int = 64,
        metrics: Optional[Registry] = None,
        tracer=None,
        journal_dir=None,
        # fsync per confirmed frame: the durable tip then tracks the
        # confirmed watermark exactly, so crash failover is lossless.  Any
        # frame a dead shard ACKED beyond its durable tip is unrecoverable
        # (the peer trimmed its resend window), and the resumed match
        # stalls — raising this trades fsync load for that risk window
        # (DESIGN.md §16, "the durable-ack window").
        journal_fsync_every: int = 1,
        journal_tail_window: int = 128,
        checkpoint_every: int = 32,
        seed: int = 0,
        max_migrations_per_tick: int = 4,
        identity_refresh_every: int = 8,
        p99_budget_ms: Optional[float] = None,
        stale_after_s: Optional[float] = None,
        native_io: bool = False,
        retire_dead_matches: bool = False,
        # out-of-process backend (DESIGN.md §17): shard ids listed here
        # run as real subprocesses (scripts/port_shard_runner.py) behind the
        # same supervisor interface — mixed fleets are the normal case.
        # proc_clock feeds the runners' session clock (shipped by value
        # with every tick RPC); tuning consolidates every fleet
        # timeout/backoff knob (FleetTuning.from_env() by default).
        proc_shards=(),
        proc_clock: Optional[Callable[[], int]] = None,
        tuning: Optional[FleetTuning] = None,
        # shard ids listed here (must also be in proc_shards) drive their
        # runner over the authenticated TCP fleet link instead of an
        # inherited socketpair — the multi-host path (DESIGN.md §25)
        tcp_shards=(),
    ) -> None:
        self.metrics = metrics if metrics is not None else default_registry()
        self.tuning = tuning if tuning is not None else FleetTuning.from_env()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # the fleet observability plane (DESIGN.md §18): one sink merges
        # every runner's harvested metrics/spans/forensics; proc shards
        # share it so one scrape serves the whole fleet
        self.fleet_obs = FleetObs(metrics=self.metrics, tracer=self.tracer)
        # the SLO plane (DESIGN.md §28): windowed burn rates over the
        # merged ggrs_slo_* counters every shard's harvest already
        # carries; a critical multi-window burn flips healthz to 503
        self.slo = BurnRateEngine(metrics=self.metrics)
        self.journal_dir = (
            os.fspath(journal_dir) if journal_dir is not None else None
        )
        self.journal_fsync_every = journal_fsync_every
        self.journal_tail_window = journal_tail_window
        self.max_migrations_per_tick = max_migrations_per_tick
        self.identity_refresh_every = identity_refresh_every
        self._rng = random.Random(seed)
        self.shards: Dict[str, Any] = {}
        self.ring = HashRing()
        proc_set = {str(s) for s in proc_shards}
        tcp_set = {str(s) for s in tcp_shards}
        if tcp_set - proc_set:
            raise ValueError(
                f"tcp_shards must be a subset of proc_shards; "
                f"{sorted(tcp_set - proc_set)} are not process-backed")
        for sid in shard_ids:
            sid = str(sid)
            if sid in proc_set:
                from .proc import ProcShard

                self.shards[sid] = ProcShard(
                    sid, capacity=capacity, metrics=self.metrics,
                    tuning=self.tuning, clock=proc_clock,
                    checkpoint_every=checkpoint_every,
                    p99_budget_ms=p99_budget_ms,
                    stale_after_s=stale_after_s, native_io=native_io,
                    retire_dead_matches=retire_dead_matches,
                    fleet_obs=self.fleet_obs,
                    tcp=sid in tcp_set,
                )
            else:
                self.shards[sid] = PoolShard(
                    sid, capacity=capacity, metrics=self.metrics,
                    tracer=tracer, checkpoint_every=checkpoint_every,
                    p99_budget_ms=p99_budget_ms,
                    stale_after_s=stale_after_s,
                    native_io=native_io,
                    retire_dead_matches=retire_dead_matches,
                    tuning=self.tuning,
                )
            self.ring.add(sid)
        self._records: Dict[str, MatchRecord] = {}
        self._pending: List[_PendingAdmission] = []
        # matches whose failover rebind hit EADDRINUSE (the dead
        # incarnation still holds the port): retried each tick until
        # tuning.failover_retry_s, then lost
        self._failover_retry: Dict[str, tuple] = {}
        self._tick = 0
        self.last_tick_at: Optional[float] = None
        m = self.metrics
        self._g_shards = m.gauge(
            "ggrs_fleet_shards", "shards per lifecycle state",
            labels=("state",))
        self._g_matches = m.gauge(
            "ggrs_fleet_matches", "matches tracked by the fleet, by status",
            labels=("status",))
        self._m_admissions = m.counter(
            "ggrs_fleet_admissions_total", "matches placed, by tier",
            labels=("tier",))
        self._m_refusals = m.counter(
            "ggrs_fleet_admission_refusals_total",
            "per-shard admission refusals, by reason", labels=("reason",))
        self._m_retries = m.counter(
            "ggrs_fleet_admission_retries_total",
            "re-admission attempts from the backoff queue")
        self._m_migrations = m.counter(
            "ggrs_fleet_migrations_total",
            "matches moved between shards, by reason", labels=("reason",))
        self._m_migration_failures = m.counter(
            "ggrs_fleet_migration_failures_total",
            "migrations/failovers that could not restore the match")
        self._m_failovers = m.counter(
            "ggrs_fleet_failovers_total",
            "shards failed over (every match journal-recovered)")
        self._m_lost = m.counter(
            "ggrs_fleet_matches_lost_total",
            "matches the fleet could not recover")
        self._m_journal_failed = m.counter(
            "ggrs_fleet_journal_failures_total",
            "matches marked journal-less after a journal write failure")
        self._update_shard_gauge()

    # ------------------------------------------------------------------
    # admission (placement front)
    # ------------------------------------------------------------------

    def admit(
        self,
        match_id: str,
        builder_factory: Callable[[], Any],
        socket_factory: Callable[[], Any],
        *,
        journal: Optional[bool] = None,
        state_template: Any = None,
        shard: Optional[str] = None,
        game_factory: Optional[Callable[[], Any]] = None,
    ) -> Optional[str]:
        """Place one match on the fleet.  ``builder_factory`` /
        ``socket_factory`` must return a FRESH fully-populated
        ``SessionBuilder`` / socket each call — migration and failover
        rebuild the session from them, so they are the match's durable
        description.  ``journal`` defaults to on when the supervisor has a
        ``journal_dir`` (journaling is what makes a match survive its
        shard); ``state_template`` is the pytree template failover rebuilds
        checkpointed game state into.  ``shard`` pins placement (bypassing
        the ring, not the admission check) — chaos/control topologies use
        it to make placement identical across legs.

        ``game_factory`` (a picklable callable returning an object with
        ``.fulfill(requests)``) makes the match placeable on
        process-backed shards, whose runners fulfill requests in-process
        — without one the match only lands on in-process shards.

        Returns the shard id, or None when every shard refused and the
        match parked in the re-admission backoff queue."""
        if match_id in self._records:
            raise InvalidRequest(f"match {match_id!r} already admitted")
        record = MatchRecord(
            match_id, builder_factory, socket_factory, state_template,
            game_factory=game_factory,
        )
        record.journaled = (
            journal if journal is not None else self.journal_dir is not None
        )
        if record.journaled and self.journal_dir is None:
            raise InvalidRequest(
                "journal=True needs a supervisor journal_dir"
            )
        probe = builder_factory()
        record.num_players = probe._num_players
        record.input_size = probe._config.native_input_size
        record.max_prediction = probe._max_prediction
        from ..core.types import Remote, Spectator

        record.local_handles = sorted(
            h for h, t in probe._player_reg.handles.items()
            if not isinstance(t, (Remote, Spectator))
        )
        self._records[match_id] = record
        placed = self._try_place(record, builder=probe, pinned=shard)
        if placed is None:
            self._park(record, attempts=0)
        self.fleet_obs.record_timeline(
            EV_ADMIT, match_id, origin="fleet", tick=self._tick,
            detail={"shard": placed} if placed else {"parked": True},
        )
        self._update_match_gauge()
        return placed

    def _candidate_shards(self, match_id: str,
                          pinned: Optional[str] = None,
                          exclude: Optional[str] = None):
        if pinned is not None:
            yield pinned
            return
        for sid in self.ring.preference(match_id):
            if sid != exclude:
                yield sid

    def _placement_refusal(self, shard, record: MatchRecord):
        """One shard's verdict on one match: the shard's own capacity/
        health refusal, plus the backend constraint — a process-backed
        shard cannot serve a match without a picklable game_factory
        (its runner fulfills requests in-process)."""
        refusal = shard.admission_refusal()
        if refusal is None and shard.backend == "proc" and (
            record.game_factory is None
        ):
            refusal = "no-game-factory"
        return refusal

    def _try_place(self, record: MatchRecord, *, builder=None,
                   pinned: Optional[str] = None,
                   exclude: Optional[str] = None) -> Optional[str]:
        for sid in self._candidate_shards(record.match_id, pinned, exclude):
            shard = self.shards[sid]
            refusal = self._placement_refusal(shard, record)
            if refusal is not None:
                self._m_refusals.labels(reason=refusal).inc()
                continue
            if shard.backend == "proc":
                spec = (
                    self._journal_spec(record) if record.journaled else None
                )
                try:
                    tier = shard.admit_spec(
                        record.match_id, record.builder_factory,
                        record.socket_factory, record.game_factory,
                        journal_spec=spec,
                    )
                except (RpcTimeout, FrameError):
                    # AMBIGUOUS outcome: the runner may have completed
                    # the admission before wedging.  Placing elsewhere
                    # now could put two live copies on the wire, so the
                    # match PARKS instead — by the backoff retry the
                    # watchdog will have confirmed the runner dead (its
                    # half-admitted copy with it) or healthy.
                    self._m_refusals.labels(reason="rpc-ambiguous").inc()
                    return None
                except RpcError:
                    # definitive failure (runner dead before completing,
                    # or the admit itself raised): nothing lives there —
                    # keep walking the preference order
                    self._m_refusals.labels(reason="rpc-error").inc()
                    continue
                if spec is not None:
                    record.journal_paths.append(spec["path"])
            else:
                b = (builder if builder is not None
                     else record.builder_factory())
                journal = (
                    self._open_journal(record) if record.journaled else None
                )
                try:
                    tier = shard.admit(
                        record.match_id, b, record.socket_factory(),
                        journal=journal,
                    )
                except Exception:
                    # unwind the just-registered stub so a retry of the
                    # same incarnation path can exclusive-create again
                    if journal is not None:
                        from .proc import _discard_stub_journal

                        record.journal_paths.pop()
                        _discard_stub_journal(journal)
                    raise
            record.location = sid
            self._m_admissions.labels(tier=tier).inc()
            return sid
        return None

    def _park(self, record: MatchRecord, attempts: int) -> None:
        if attempts >= self.tuning.readmit_max_attempts:
            record.lost = "admission refused by every shard"
            self._m_lost.inc()
            _logger.error("match %s lost: %s", record.match_id, record.lost)
            return
        backoff = self.tuning.readmit_backoff_ticks
        delay = backoff * (2 ** attempts) + self._rng.randrange(backoff)
        self._pending.append(_PendingAdmission(
            record, attempts + 1, self._tick + delay
        ))

    def _retry_pending(self) -> None:
        if not self._pending:
            return
        due = [p for p in self._pending if self._tick >= p.next_try]
        if not due:
            return
        self._pending = [p for p in self._pending if self._tick < p.next_try]
        for p in due:
            self._m_retries.inc()
            placed = self._try_place(p.record)
            if placed is None:
                self._park(p.record, p.attempts)
        self._update_match_gauge()

    def pending_admissions(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------------
    # journals
    # ------------------------------------------------------------------

    def _journal_spec(self, record: MatchRecord) -> Dict[str, Any]:
        """The new incarnation's journal, described as plain data — the
        in-process path opens a ``MatchJournal`` from it; the process
        backend ships it and the RUNNER opens the file (the supervisor
        must never create the file a runner will open with the
        exclusive-create contract).  The path is NOT registered on the
        record here: callers append it to ``journal_paths`` only once
        the open/adoption succeeds, so a failure can never leave a
        phantom path that a later journal failover would read instead
        of the previous incarnation's valid file."""
        path = os.path.join(
            self.journal_dir,
            f"{record.match_id}.{record.incarnation:03d}.ggjl",
        )
        return dict(
            path=path,
            num_players=record.num_players,
            input_size=record.input_size,
            meta=dict(match_id=record.match_id,
                      incarnation=record.incarnation),
            fsync_every=self.journal_fsync_every,
            tail_window=self.journal_tail_window,
        )

    def _open_journal(self, record: MatchRecord):
        from ..broadcast.journal import MatchJournal

        spec = self._journal_spec(record)
        journal = MatchJournal(
            spec["path"], spec["num_players"], spec["input_size"],
            meta=spec["meta"],
            fsync_every=spec["fsync_every"],
            tail_window=spec["tail_window"],
            metrics=self.metrics,
        )
        record.journal_paths.append(spec["path"])
        return journal

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------

    def add_local_input(self, match_id: str, handle: int, value) -> None:
        record = self._records[match_id]
        if record.lost is not None or record.location is None:
            return  # parked or lost: inputs drop, like dead pool slots
        self.shards[record.location].add_local_input(match_id, handle, value)

    def advance_all(self) -> Dict[str, List[GgrsRequest]]:
        """One fleet tick: every serving shard's tick (each pool still one
        native crossing), then the control plane — drain steps, health
        checks + failover, admission retries.  Returns ``{match_id:
        request_list}`` over every match that ticked.  Wrapped in a
        ``fleet.tick`` tracer span carrying the tick id: the runners'
        shipped spans (offset-adjusted) nest inside it, so one Perfetto
        export shows the whole fleet's tick structure (§18)."""
        self._tick += 1
        out: Dict[str, List[GgrsRequest]] = {}
        with self.tracer.span("fleet.tick", cat="fleet", tick=self._tick):
            for sid in sorted(self.shards):
                shard = self.shards[sid]
                if shard.backend == "proc":
                    shard.set_fleet_tick(self._tick)
                out.update(shard.advance_all())
            self._ferry_inproc_forensics()
            self._drive_procs()
            self._check_journal_failures()
            self._drive_drains()
            self._health_check()
            self._retry_failovers()
            self._retry_pending()
            if self.identity_refresh_every and (
                self._tick % self.identity_refresh_every == 0
            ):
                self._refresh_identities()
            # burn-rate update over the merged fleet counters (§28):
            # reads what the harvest already ferried — no new traffic
            self.slo.update(self._tick, self.merged_registry())
        self.last_tick_at = time.monotonic()
        return out

    def _ferry_inproc_forensics(self) -> None:
        """In-process shards feed the same forensics ring (and timeline
        store) the runners ferry into — one place to look, whatever the
        backend."""
        for sid in sorted(self.shards):
            shard = self.shards[sid]
            if shard.backend != "inproc":
                continue
            try:
                items = shard.drain_forensics()
                timeline = shard.drain_timeline()
            except Exception:
                continue
            payload: Dict[str, Any] = {}
            if items:
                payload["forensics"] = items
            if timeline:
                payload["timeline"] = timeline
            if payload:
                self.fleet_obs.ingest(sid, payload, backend="inproc")

    def events(self, match_id: str) -> List:
        record = self._records[match_id]
        if record.location is None:
            return []
        return self.shards[record.location].events(match_id)

    def current_frame(self, match_id: str) -> int:
        record = self._records[match_id]
        if record.location is None:
            raise InvalidRequest(f"match {match_id!r} is not placed")
        return self.shards[record.location].current_frame(match_id)

    def match_location(self, match_id: str) -> Optional[str]:
        return self._records[match_id].location

    def lost_matches(self) -> Dict[str, str]:
        return {
            mid: r.lost for mid, r in self._records.items()
            if r.lost is not None
        }

    def _refresh_identities(self) -> None:
        """Cache every healthy match's wire identity (endpoint/spectator
        magics) in the control plane — the piece of failover a dead
        process cannot provide.  Read-only; never perturbs the match."""
        for record in self._records.values():
            sid = record.location
            if sid is None or record.lost is not None:
                continue
            shard = self.shards[sid]
            if shard.killed or shard.state == SHARD_DEAD:
                continue
            try:
                record.identity = shard.wire_identity(record.match_id)
            except Exception:
                pass  # e.g. pool not started yet; next refresh catches it

    # ------------------------------------------------------------------
    # process-backend control plane (DESIGN.md §17)
    # ------------------------------------------------------------------

    def _drive_procs(self) -> None:
        """One watchdog step per process-backed shard: crash detection
        (waitpid/EOF), the hang escalation (SIGTERM → drain deadline →
        SIGKILL), failover of a CONFIRMED-dead shard's matches from
        their durable journals, and the jittered-backoff restart policy
        behind its storm budget."""
        now = time.monotonic()
        for sid in sorted(self.shards):
            shard = self.shards[sid]
            if shard.backend != "proc":
                continue
            if shard.poll_lifecycle() == "died":
                _logger.error(
                    "proc shard %s confirmed dead (%s); failing over",
                    sid, shard.last_exit,
                )
                self._fail_shard(sid, reason=shard.last_exit or "died")
                shard.schedule_respawn(now)
            if shard.respawn_due(now):
                if shard.try_respawn():
                    # the replacement serves NEW admissions; the dead
                    # incarnation's matches already failed over
                    # ggrs-model: transitions(dead->active)
                    shard.state = SHARD_ACTIVE
                    self.ring.add(sid)
                    self._update_shard_gauge()
                else:
                    # transient spawn failure: re-arm within the storm
                    # budget (the failed attempt consumed a slot) rather
                    # than silently going permanently dead
                    shard.schedule_respawn(now)

    def _check_journal_failures(self) -> None:
        """Mark matches whose journal degraded (write failure) as
        journal-less for failover purposes — the shard keeps serving
        them, but a crash can no longer recover them from that file."""
        for sid, shard in self.shards.items():
            try:
                failed = shard.journal_failed_matches()
            except Exception:
                continue
            for mid in failed:
                record = self._records.get(mid)
                if record is None or record.journal_failed:
                    continue
                if record.location != sid:
                    continue
                record.journal_failed = True
                self._m_journal_failed.inc()
                _logger.error(
                    "match %s: journal degraded on shard %s; the match "
                    "is journal-less for failover until re-incarnated",
                    mid, sid,
                )

    def close(self) -> None:
        """Release every shard's durable/process resources: runners get
        the drain → SIGTERM → SIGKILL ladder and are reaped (no orphan
        children, no leaked fds — pinned by the leak-check test);
        in-process shards close their journals."""
        for shard in self.shards.values():
            try:
                shard.close()
            except Exception:
                pass

    # ------------------------------------------------------------------
    # live migration
    # ------------------------------------------------------------------

    def migrate(self, match_id: str, dst_shard: Optional[str] = None,
                *, reason: str = "manual") -> str:
        """Move one running match to ``dst_shard`` (or the first accepting
        shard on its preference walk).  Bank matches move live through the
        harvest seam; adopted matches move through their (flushed) journal
        — both land as an adopted session on the destination with the
        peers/viewers seeing a retransmission hiccup."""
        record = self._records[match_id]
        if record.lost is not None or record.location is None:
            raise FleetError(f"match {match_id!r} is not serving")
        src_id = record.location
        src = self.shards[src_id]
        if dst_shard is None:
            for sid in self._candidate_shards(match_id, exclude=src_id):
                if self._placement_refusal(self.shards[sid], record) is None:
                    dst_shard = sid
                    break
            if dst_shard is None:
                raise FleetError("no shard accepts the migration")
        elif dst_shard == src_id:
            raise FleetError("destination is the source shard")
        else:
            refusal = self._placement_refusal(self.shards[dst_shard], record)
            if refusal is not None:
                raise FleetError(
                    f"shard {dst_shard} refuses the migration: {refusal}"
                )
        dst = self.shards[dst_shard]
        self.fleet_obs.record_timeline(
            EV_MIGRATE_BEGIN, match_id, origin="fleet", tick=self._tick,
            detail={"from": src_id, "to": dst_shard, "reason": reason},
        )
        # refresh the identity first: failover of the NEW incarnation needs
        # the same magics the bundle carries
        record.identity = src.wire_identity(match_id)
        bundle = None
        if src.is_bank_match(match_id):
            try:
                bundle = src.evict_match(match_id)
            except InvalidRequest:
                # no native harvest on the source (degraded Python bank,
                # or the harvest AND its journal-recovery slot hook are
                # gone): fall through to the durable-journal ladder below
                if not record.journaled:
                    raise FleetError(
                        f"match {match_id!r}: source shard cannot export "
                        "natively and the match is not journaled"
                    )
        if bundle is not None:
            try:
                # the process-portability contract, enforced on every
                # migration: the bundle must survive leaving this process
                bundle = pickle.loads(
                    pickle.dumps(bundle, protocol=PICKLE_PROTOCOL)
                )
                self._adopt_on(dst, record, bundle)
            except Exception as e:
                # the source slot is already released — never leave the
                # match half-tracked: fall back to the durable journal,
                # else it is lost, loudly (mirrors _fail_shard)
                self._m_migration_failures.inc()
                _logger.error(
                    "migration of %s to %s failed after eviction: %s",
                    match_id, dst_shard, e,
                )
                self._recover_or_lose(record, dst_shard, e)
            else:
                record.location = dst_shard
        else:
            if not record.journaled:
                raise FleetError(
                    f"adopted match {match_id!r} has no journal to migrate "
                    "through"
                )
            src.drop_match(match_id, reason=f"migrated ({reason})")
            try:
                self._readopt_from_journal(record, dst_shard)
            except Exception as e:
                self._m_migration_failures.inc()
                self._recover_or_lose(record, dst_shard, e,
                                      try_journal=False)
        self._m_migrations.labels(reason=reason).inc()
        if record.location == dst_shard and record.lost is None:
            self.fleet_obs.record_timeline(
                EV_MIGRATE_COMMIT, match_id, origin="fleet",
                tick=self._tick,
                detail={"from": src_id, "to": dst_shard},
            )
        else:
            self.fleet_obs.record_timeline(
                EV_MIGRATE_ABORT, match_id, origin="fleet",
                tick=self._tick,
                detail={"from": src_id, "to": dst_shard,
                        "landed": record.location, "lost": record.lost},
            )
        self._update_match_gauge()
        return dst_shard

    def _adopt_on(self, dst, record: MatchRecord, bundle: Dict[str, Any],
                  *, saved_states=None, prelude=None,
                  replay_local=None) -> None:
        """The destination half of migration/failover on EITHER backend:
        bump the incarnation, open (in-process) or describe (process
        backend — the runner opens the file) the new journal, adopt, and
        unwind the journal bookkeeping when adoption fails so a journal
        fallback reads the PREVIOUS incarnation, not an empty stub."""
        journal = spec = None
        record.incarnation += 1
        if record.journaled:
            spec = self._journal_spec(record)
            if dst.backend != "proc":
                journal = self._open_journal(record)  # registers the path
        try:
            if dst.backend == "proc":
                dst.adopt_spec(
                    record.match_id, record.builder_factory,
                    record.socket_factory, record.game_factory, bundle,
                    saved_states=saved_states, prelude=prelude,
                    journal_spec=spec, replay_local=replay_local,
                )
            else:
                dst.adopt_match(
                    record.match_id, record.builder_factory(),
                    record.socket_factory(), bundle,
                    saved_states=saved_states, prelude=prelude,
                    journal=journal, replay_local=replay_local,
                )
        except Exception:
            # the failed incarnation's journal (if it got registered) is
            # an empty stub: forget it so a journal fallback reads the
            # PREVIOUS incarnation, not this one
            if journal is not None:
                record.journal_paths.pop()
                try:
                    journal.close()
                except Exception:
                    pass
            raise
        if dst.backend == "proc" and spec is not None:
            record.journal_paths.append(spec["path"])
        # a fresh incarnation journals from scratch: any write-failure
        # degradation belonged to the previous incarnation's file
        record.journal_failed = False

    def _recover_or_lose(self, record: MatchRecord, dst_shard: str,
                         cause: Exception, *,
                         try_journal: bool = True) -> None:
        """Last-ditch path for a migration that failed AFTER the source
        released the match: one journal re-adoption attempt (skipped when
        the journal path is what just failed), else the match is marked
        lost (loudly) and a ``FleetError`` raised — a plain exception
        here would abort the whole fleet tick from ``_drive_drains``."""
        if try_journal and record.journaled and record.journal_paths:
            try:
                self._readopt_from_journal(record, dst_shard)
                return
            except Exception as e:
                cause = e
        record.lost = f"migration failed: {cause}"
        record.location = None
        self._m_lost.inc()
        _logger.error("match %s lost: %s", record.match_id, record.lost)
        self._update_match_gauge()
        raise FleetError(
            f"match {record.match_id!r} lost in migration: {cause}"
        ) from cause

    # ------------------------------------------------------------------
    # cross-host transfer (DESIGN.md §26)
    # ------------------------------------------------------------------

    def match_port(self, match_id: str) -> Optional[int]:
        """The UDP port the match's host-side socket bound (the leg the
        ingress routes to), when determinable — the placement service
        reads it after every adoption to aim the route flip."""
        record = self._records[match_id]
        if record.location is None:
            return None
        return self.shards[record.location].match_port(match_id)

    def record_meta(self, match_id: str) -> Dict[str, Any]:
        """The match's durable control-plane description as one
        picklable dict — everything :meth:`adopt_from_meta` needs to
        journal-failover the match onto ANOTHER supervisor after this
        whole host dies.  The placement service snapshots it every tick
        (cheap: references, not copies), which is exactly the metadata
        replication a real deployment would do."""
        record = self._records[match_id]
        return dict(
            match_id=record.match_id,
            builder_factory=record.builder_factory,
            socket_factory=record.socket_factory,
            game_factory=record.game_factory,
            state_template=record.state_template,
            journaled=record.journaled,
            journal_failed=record.journal_failed,
            incarnation=record.incarnation,
            journal_paths=list(record.journal_paths),
            identity=record.identity,
            num_players=record.num_players,
            input_size=record.input_size,
            max_prediction=record.max_prediction,
            local_handles=list(record.local_handles),
        )

    def _record_from_meta(self, meta: Dict[str, Any]) -> MatchRecord:
        record = MatchRecord(
            meta["match_id"], meta["builder_factory"],
            meta["socket_factory"], meta["state_template"],
            game_factory=meta["game_factory"],
        )
        record.journaled = bool(meta["journaled"])
        record.journal_failed = bool(meta["journal_failed"])
        record.incarnation = int(meta["incarnation"])
        record.journal_paths = list(meta["journal_paths"])
        record.identity = meta["identity"]
        record.num_players = meta["num_players"]
        record.input_size = meta["input_size"]
        record.max_prediction = meta["max_prediction"]
        record.local_handles = list(meta["local_handles"])
        if record.journaled and self.journal_dir is None:
            raise FleetError(
                "cannot adopt a journaled match: this supervisor has "
                "no journal_dir for the next incarnation"
            )
        return record

    def export_transfer(self, match_id: str) -> Dict[str, Any]:
        """The source half of CROSS-HOST migration: release the match
        here and return ONE picklable transfer blob — record metadata
        plus the adoption materials (live harvest bundle when the source
        shard can export natively, else the journal-rebuilt bundle with
        its fast-forward prelude).  The caller ships the blob to the
        target host's :meth:`adopt_transfer`; the match stops being
        tracked by this supervisor the moment this returns."""
        record = self._records[match_id]
        if record.lost is not None or record.location is None:
            raise FleetError(f"match {match_id!r} is not serving")
        src = self.shards[record.location]
        record.identity = src.wire_identity(match_id)
        bundle = None
        saved = prelude = replay_local = None
        if src.is_bank_match(match_id):
            try:
                bundle = src.evict_match(match_id)
            except InvalidRequest:
                if not record.journaled:
                    raise FleetError(
                        f"match {match_id!r}: source shard cannot "
                        "export natively and the match is not journaled"
                    )
        if bundle is None:
            if not record.journaled:
                raise FleetError(
                    f"adopted match {match_id!r} has no journal to "
                    "transfer through"
                )
            # freshen the journal checkpoint first (cadence aside): the
            # resume window then always holds one, and the target's
            # fast-forward prelude is as short as the journal allows
            if hasattr(src, "checkpoint_now"):
                src.checkpoint_now(match_id)
            src.drop_match(match_id, reason="exported off-host")
            bundle, saved, prelude, replay_local = (
                self._resume_materials(record)
            )
        meta = self.record_meta(match_id)
        del self._records[match_id]
        self._update_match_gauge()
        return dict(
            version=1, meta=meta, bundle=bundle, saved_states=saved,
            prelude=prelude, replay_local=replay_local,
        )

    def adopt_transfer(self, match_id: str, blob: Dict[str, Any], *,
                       shard: Optional[str] = None) -> str:
        """The target half of cross-host migration: register the
        transferred match and adopt it on ``shard`` (or the first
        accepting shard on the preference walk).  On failure nothing is
        left half-tracked — the record is unwound and the caller still
        holds the blob (re-adoptable on the source, or recoverable from
        the journal)."""
        if match_id in self._records:
            raise InvalidRequest(f"match {match_id!r} already admitted")
        meta = blob["meta"]
        if meta["match_id"] != match_id:
            raise InvalidRequest(
                f"transfer blob is for {meta['match_id']!r}, "
                f"not {match_id!r}"
            )
        record = self._record_from_meta(meta)
        if shard is None:
            for sid in self._candidate_shards(match_id):
                cand = self.shards[sid]
                if cand.state == SHARD_DEAD or cand.killed:
                    continue
                if self._placement_refusal(cand, record) is None:
                    shard = sid
                    break
            if shard is None:
                raise FleetError("no shard accepts the transfer")
        self._records[match_id] = record
        try:
            self._adopt_on(
                self.shards[shard], record, blob["bundle"],
                saved_states=blob["saved_states"],
                prelude=blob["prelude"],
                replay_local=blob["replay_local"],
            )
        except Exception:
            del self._records[match_id]
            raise
        record.location = shard
        self._m_admissions.labels(tier="transfer").inc()
        self._update_match_gauge()
        return shard

    def adopt_from_meta(self, meta: Dict[str, Any], *,
                        shard: Optional[str] = None) -> str:
        """Journal failover ACROSS hosts: rebuild a dead machine's match
        on THIS supervisor from replicated record metadata alone — the
        durable journal (shared storage) plus the cached wire identity
        are all that is assumed to survive the machine."""
        match_id = meta["match_id"]
        if match_id in self._records:
            raise InvalidRequest(f"match {match_id!r} already admitted")
        record = self._record_from_meta(meta)
        self._records[match_id] = record
        try:
            dst = self._readopt_from_journal(record, shard)
        except Exception:
            del self._records[match_id]
            raise
        self._m_admissions.labels(tier="transfer").inc()
        self._update_match_gauge()
        return dst

    # ------------------------------------------------------------------
    # graceful drain
    # ------------------------------------------------------------------

    def drain(self, shard_id: str) -> None:
        """Begin draining ``shard_id``: admission closes now; matches
        migrate off a bounded few per tick; the empty shard retires."""
        shard = self.shards[shard_id]
        if shard.state != SHARD_ACTIVE:
            raise InvalidRequest(
                f"shard {shard_id} is {shard.state}: only active shards "
                "drain"
            )
        # ggrs-model: transitions(active->draining)
        shard.state = SHARD_DRAINING
        self._update_shard_gauge()

    def _drive_drains(self) -> None:
        for sid in sorted(self.shards):
            shard = self.shards[sid]
            if shard.state != SHARD_DRAINING or shard.killed:
                continue
            moved = 0
            for match_id in sorted(shard.match_ids()):
                if moved >= self.max_migrations_per_tick:
                    break
                try:
                    self.migrate(match_id, reason="drain")
                except (FleetError, RpcError) as e:
                    # no capacity anywhere right now (or the draining
                    # runner wedged — the watchdog owns that): stay
                    # draining, the next tick retries (bounded work)
                    _logger.warning(
                        "drain of %s stalled on %s: %s", sid, match_id, e
                    )
                    break
                moved += 1
            if shard.live_matches() == 0:
                shard.retire()
                self._update_shard_gauge()
                _logger.info("shard %s drained and retired", sid)

    # ------------------------------------------------------------------
    # crash failover
    # ------------------------------------------------------------------

    def kill(self, shard_id: str) -> None:
        """Chaos entry: simulate the shard process dying mid-tick.  The
        next ``advance_all`` health check fails it over."""
        self.shards[shard_id].kill()

    def _health_check(self) -> None:
        for sid in sorted(self.shards):
            shard = self.shards[sid]
            if shard.state in (SHARD_RETIRED, SHARD_DEAD):
                continue
            if shard.backend == "proc":
                # process liveness is owned by _drive_procs: a WEDGED
                # runner must be escalated to confirmed-dead before its
                # matches fail over (it may still be sending to peers —
                # two live incarnations would fight over the wire)
                continue
            if not shard.healthz()["ok"]:
                self._fail_shard(sid, reason="failed health check")

    def _fail_shard(self, shard_id: str,
                    reason: str = "failed health check") -> None:
        """Every match on the failed shard journal-recovers onto the
        survivors — the durable artifacts (journal + checkpoints + cached
        identity) are all that is assumed to exist."""
        shard = self.shards[shard_id]
        # ggrs-model: transitions(active->dead, draining->dead)
        shard.state = SHARD_DEAD
        self.ring.remove(shard_id)
        self._m_failovers.inc()
        self._update_shard_gauge()
        matches = sorted(
            set(shard.match_ids()) | {
                mid for mid, r in self._records.items()
                if r.location == shard_id and r.lost is None
            }
        )
        _logger.error(
            "shard %s %s; failing over %d matches",
            shard_id, reason, len(matches),
        )
        for match_id in matches:
            record = self._records[match_id]
            try:
                self._readopt_from_journal(record, exclude=shard_id)
            except Exception as e:
                if getattr(e, "errno", None) == errno.EADDRINUSE:
                    # the dead incarnation still holds the match's wire
                    # port — when it was FENCED rather than signalled
                    # (§25: a remote host's process is not ours to
                    # kill) it releases its sockets only once the
                    # handshake refusal lands.  Park and retry, bounded.
                    record.location = None
                    self._failover_retry[match_id] = (
                        shard_id,
                        time.monotonic() + self.tuning.failover_retry_s,
                    )
                    _logger.warning(
                        "failover of %s stalled: wire port still bound "
                        "by the dead incarnation; retrying for %.1fs",
                        match_id, self.tuning.failover_retry_s,
                    )
                    continue
                record.lost = f"failover failed: {e}"
                record.location = None
                self._m_migration_failures.inc()
                self._m_lost.inc()
                _logger.error("match %s lost: %s", match_id, record.lost)
            else:
                self._m_migrations.labels(reason="failover").inc()
                self.fleet_obs.record_timeline(
                    EV_FAILOVER, match_id, origin="fleet", tick=self._tick,
                    detail={"from": shard_id, "to": record.location,
                            "reason": reason},
                )
        self._update_match_gauge()

    def _retry_failovers(self) -> None:
        """Re-drive parked failovers (wire port still bound — see
        :meth:`_fail_shard`) until the rebind succeeds or the bounded
        retry deadline passes; only then is the match lost."""
        for match_id, (exclude, deadline) in list(
                self._failover_retry.items()):
            record = self._records[match_id]
            try:
                self._readopt_from_journal(record, exclude=exclude)
            except Exception as e:
                if (getattr(e, "errno", None) == errno.EADDRINUSE
                        and time.monotonic() < deadline):
                    continue
                del self._failover_retry[match_id]
                record.lost = f"failover failed: {e}"
                record.location = None
                self._m_migration_failures.inc()
                self._m_lost.inc()
                _logger.error("match %s lost: %s", match_id, record.lost)
            else:
                del self._failover_retry[match_id]
                self._m_migrations.labels(reason="failover").inc()
                self.fleet_obs.record_timeline(
                    EV_FAILOVER, match_id, origin="fleet", tick=self._tick,
                    detail={"from": exclude, "to": record.location,
                            "reason": "retry-recovered"},
                )
                _logger.info("parked failover of %s recovered", match_id)
            self._update_match_gauge()

    def _resume_materials(self, record: MatchRecord):
        """Rebuild one match's adoption materials from its durable
        journal alone — ``(bundle, saved_states, prelude, replay_local)``
        — without placing it anywhere: load the newest in-window
        checkpoint, fast-forward to the last durable frame through a
        request prelude the game fulfills, resume the wire from the
        synthesized harvest + cached identity.  Shared by same-host
        journal failover (:meth:`_readopt_from_journal`) and the
        cross-host transfer seam (:meth:`export_transfer`)."""
        from ..broadcast.journal import resume_from_file
        from ..utils.checkpoint import loads_pytree

        if not record.journaled or not record.journal_paths:
            raise FleetError("match has no journal to recover from")
        if record.journal_failed:
            # the incarnation's journal degraded on a write failure: its
            # durable tip stopped tracking what the live match acked, so
            # resuming from it would silently desync the peers — the
            # match is journal-less, loudly (the §17 degradation contract)
            raise FleetError(
                "journal degraded by a write failure: the match is "
                "journal-less for failover"
            )
        identity = record.identity
        if identity is None:
            raise FleetError("no cached wire identity (shard died before "
                             "the first identity refresh)")
        res = resume_from_file(
            record.journal_paths[-1],
            local_handles=identity["local_handles"],
            endpoints=[
                (e["handles"], True) for e in identity["endpoints"]
            ],
            spectators=[True] * len(identity["spectators"]),
            tail_window=self.journal_tail_window,
        )
        if res["checkpoint"] is None:
            raise FleetError(
                "no state checkpoint inside the durable window "
                "(checkpoint_every too large vs tail_window?)"
            )
        cf, blob = res["checkpoint"]
        state, _meta = loads_pytree(blob, record.state_template)
        tip = res["durable_tip"]
        harvest = res["harvest"]
        saved = SavedStates(record.max_prediction)
        cell_cf = saved.get_cell(cf)
        cell_cf.save(cf, state, None)
        # the fast-forward prelude: restore the checkpoint, advance the
        # journaled confirmed frames cf..tip-1, save at the durable tip —
        # fulfilled by the game ahead of the session's own first requests
        builder = record.builder_factory()
        decode = builder._config.input_decode
        isize = record.input_size
        window_at = {f: (flags, b) for f, flags, b in res["window"]}
        prelude: List[GgrsRequest] = [
            LoadGameState(cell=cell_cf, frame=cf)
        ]
        for f in range(cf, tip):
            flags, fblob = window_at[f]
            prelude.append(AdvanceFrame(inputs=[
                (
                    decode(fblob[p * isize:(p + 1) * isize]),
                    InputStatus.DISCONNECTED if flags[p]
                    else InputStatus.CONFIRMED,
                )
                for p in range(record.num_players)
            ]))
        prelude.append(
            SaveGameState(cell=saved.get_cell(tip), frame=tip)
        )
        bundle = dict(
            version=1,
            num_players=record.num_players,
            input_size=record.input_size,
            max_prediction=record.max_prediction,
            local_handles=list(record.local_handles),
            resume_frame=tip,
            harvest=harvest,
            next_recommended_sleep=0,
            pending_events=[],
            endpoints=[
                dict(
                    addr=e["addr"], handles=list(e["handles"]),
                    magic=e["magic"], running=True,
                    peer_disc=list(harvest["local_disc"]),
                    peer_last=list(harvest["local_last"]),
                    pending_checksums={},
                )
                for e in identity["endpoints"]
            ],
            spectators=[dict(sp) for sp in identity["spectators"]],
            staged_inputs={},
        )
        # the staged-local replay map: values the dead incarnation already
        # SENT for frames at/after the durable tip.  The resumed session
        # re-walks those frames with the recorded inputs substituted, so
        # its wire stream is bit-identical to what the peers hold — this
        # is what keeps journal failover desync-free, not just stall-free.
        replay_local = {
            f: {h: decode(p) for h, p in per_handle.items()}
            for f, per_handle in res["local_tail"].items()
        }
        return bundle, saved, prelude, replay_local

    def _readopt_from_journal(self, record: MatchRecord,
                              dst_shard: Optional[str] = None,
                              exclude: Optional[str] = None) -> str:
        """Rebuild one match from its durable journal alone
        (:meth:`_resume_materials`) and adopt it on ``dst_shard`` (or
        the first accepting survivor)."""
        bundle, saved, prelude, replay_local = (
            self._resume_materials(record)
        )
        if dst_shard is None:
            for sid in self._candidate_shards(
                record.match_id, exclude=exclude
            ):
                shard = self.shards[sid]
                if shard.state == SHARD_DEAD or shard.killed:
                    continue
                if self._placement_refusal(shard, record) is None:
                    dst_shard = sid
                    break
            if dst_shard is None:
                raise FleetError("no surviving shard accepts the match")
        self._adopt_on(
            self.shards[dst_shard], record, bundle,
            saved_states=saved, prelude=prelude,
            replay_local=replay_local,
        )
        record.location = dst_shard
        return dst_shard

    # ------------------------------------------------------------------
    # health + gauges
    # ------------------------------------------------------------------

    def merged_registry(self) -> MultiRegistry:
        """The one-scrape fleet view: the supervisor's own instruments
        plus every runner's harvested families (``shard``/``backend``
        labeled) — hand this to ``obs.start_http_server`` and a single
        ``/metrics`` serves the entire fleet (§18)."""
        return MultiRegistry(self.metrics, self.fleet_obs.harvest)

    def healthz(self) -> Dict[str, Any]:
        """Fleet-wide aggregate for the ``/healthz`` endpoint
        (``start_http_server(health=supervisor.healthz)``): per-shard
        records plus one top-level verdict — ok while every non-retired
        shard is healthy and at least one shard still admits.  For a
        proc-backed fleet the aggregate carries each runner's heartbeat
        age and watchdog stage, so a STALE runner pages here before the
        watchdog confirms it dead (a wedged child is an incident, not a
        footnote)."""
        shards = {
            sid: shard.healthz() for sid, shard in self.shards.items()
        }
        serving = [
            h for h in shards.values()
            if h["state"] not in (SHARD_RETIRED, SHARD_DEAD)
        ]
        slo = self.slo.verdict()
        # the §28 escalation door: a critical multi-window burn answers
        # 503 through the health endpoint the fleet already watches
        ok = bool(serving) and all(h["ok"] for h in serving) and slo["ok"]
        age = (
            None if self.last_tick_at is None
            else max(0.0, time.monotonic() - self.last_tick_at)
        )
        out = dict(
            ok=ok,
            tick=self._tick,
            last_tick_age_s=age,
            shards=shards,
            matches=sum(h["matches"] for h in shards.values()),
            pending_admissions=len(self._pending),
            lost_matches=len(self.lost_matches()),
            slo=slo,
            timeline_matches=len(self.fleet_obs.timelines),
        )
        proc: Dict[str, Any] = {}
        for sid, shard in self.shards.items():
            if shard.backend != "proc":
                continue
            proc[sid] = dict(
                heartbeat_age_s=shard.heartbeat_age_s(),
                watchdog=shard.watchdog_stage(),
                restarts=shard.restarts,
                link=shard.link_info(),
            )
        if proc:
            ages = [
                p["heartbeat_age_s"] for p in proc.values()
                if p["heartbeat_age_s"] is not None
            ]
            out["proc"] = proc
            out["max_proc_heartbeat_age_s"] = max(ages) if ages else None
        return out

    def _update_shard_gauge(self) -> None:
        counts: Dict[str, int] = {}
        for shard in self.shards.values():
            state = SHARD_DEAD if shard.killed else shard.state
            counts[state] = counts.get(state, 0) + 1
        for state in (SHARD_ACTIVE, SHARD_DRAINING, SHARD_RETIRED,
                      SHARD_DEAD):
            self._g_shards.labels(state=state).set(counts.get(state, 0))

    def _update_match_gauge(self) -> None:
        placed = sum(
            1 for r in self._records.values()
            if r.location is not None and r.lost is None
        )
        self._g_matches.labels(status="placed").set(placed)
        self._g_matches.labels(status="pending").set(len(self._pending))
        self._g_matches.labels(status="lost").set(
            len(self.lost_matches())
        )
