"""The tree's real protocol state machines as checkable models
(the exploration half of ggrs-model, DESIGN.md §22).

Each model here is cross-checked against source, not hand-copied:

- the §9 supervision model is BUILT from ``SLOT_TRANSITIONS`` and
  ``EVICT_MAX_ATTEMPTS`` parsed out of ``parallel/host_bank.py`` — the
  builder raises :class:`~.model.ModelError` if the model's action
  edges and the declared table ever disagree, or if DEAD/MIGRATED stop
  being absorbing;
- the §16 lifecycle model is generated edge-for-edge from
  ``SHARD_TRANSITIONS`` in ``fleet/shard.py``;
- the §17 watchdog model validates its supervisor-status edges against
  ``PROC_TRANSITIONS`` in ``fleet/proc.py``.

The §16 ordering models (checkpoint-at-top-of-next-tick,
durable-before-send, 3-regressive-ack rebase) each come in a HEAD
variant that must explore clean and a FIXTURE variant that keeps the
known-broken ordering alive as a regression oracle: the old
checkpoint placement MUST reproduce the shard_migrate desync
(DESIGN.md §20.4) as a shortest counterexample, or the checker has
lost the very bug class it was built for.

:data:`MODEL_CATALOG` lists every model with its expected verdict
(and, for fixtures, the pinned shortest counterexample);
:func:`check_models` runs the catalog under a budget and turns any
mismatch into ggs-verify findings — the model leg of
``scripts/port_verify.py --model`` and ``scripts/port_build_sanitized.sh``.
"""

from __future__ import annotations

from pathlib import Path
from typing import (
    Any,
    Callable,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

from .conformance import machine_specs, parse_transition_table
from .model import (
    Action,
    CheckResult,
    Invariant,
    Model,
    ModelError,
    Progress,
    check,
    replay,
)
from .pysrc import parse_py_constants
from .report import PKG, Finding

# rule ids emitted by the model leg (DESIGN.md §22 renders this)
MODEL_RULES: Dict[str, str] = {
    "model/build-error": "a catalog model failed to build from source",
    "model/expectation":
        "a model's exploration verdict differs from the catalog's "
        "expectation (clean models must stay clean, fixture models "
        "must keep their pinned counterexample)",
}


# restart-storm budget modeled for the watchdog (§17): how many
# respawns of one shard the model explores before the supervisor must
# stop (FleetTuning's restart_max semantics, kept small for the state
# space — the invariant is that the count is BOUNDED, not its value)
RESTART_MAX = 2


def _table(root: Path, machine: str, pkg: str = PKG):
    spec = next(s for s in machine_specs(pkg) if s.name == machine)
    table, findings = parse_transition_table(Path(root), spec)
    if table is None or findings:
        raise ModelError(
            f"cannot parse the {machine} transition table: "
            + "; ".join(f.render() for f in findings)
        )
    return table


def _assert_edges(name: str, table, action_edges: Dict[str, Sequence[Tuple[str, str]]]) -> None:
    """Model actions and declared table must carry the SAME edge set —
    an edge added to either side alone is a build error, which is what
    keeps the model honest against the source it claims to describe."""
    modeled = {e for edges in action_edges.values() for e in edges}
    declared = set(table.edges)
    if modeled != declared:
        missing = sorted(declared - modeled)
        extra = sorted(modeled - declared)
        raise ModelError(
            f"model {name} vs {table.spec.table_name}: "
            f"table edges not modeled {missing}, "
            f"modeled edges not declared {extra}"
        )


# ----------------------------------------------------------------------
# §9: slot supervision (host_bank.py)
# ----------------------------------------------------------------------


class SlotS(NamedTuple):
    state: str
    attempts: int  # eviction attempts while quarantined; 0 elsewhere


def supervision_model(root: Path, pkg: str = PKG) -> Model:
    table = _table(root, "supervision", pkg)
    consts = parse_py_constants(Path(root) / table.spec.table_path)
    max_attempts = consts.get("EVICT_MAX_ATTEMPTS")
    if not max_attempts:
        raise ModelError("EVICT_MAX_ATTEMPTS not parseable from "
                         + table.spec.table_path)
    sinks = {
        v for v in table.values
        if not any(src == v for src, _ in table.edges)
    }
    if sinks != {"dead", "migrated"}:
        raise ModelError(
            f"supervision: DEAD/MIGRATED must be the absorbing states, "
            f"table sinks are {sorted(sinks)}"
        )

    def evict_fail(s: SlotS) -> SlotS:
        n = s.attempts + 1
        if n >= max_attempts:
            return SlotS("dead", 0)
        return SlotS("quarantined", n)

    actions = (
        Action("fault", lambda s: s.state == "native",
               lambda s: SlotS("quarantined", 0)),
        Action("evict_ok", lambda s: s.state == "quarantined",
               lambda s: SlotS("evicted", 0)),
        Action("evict_fail", lambda s: s.state == "quarantined",
               evict_fail),
        Action("evicted_fault", lambda s: s.state == "evicted",
               lambda s: SlotS("dead", 0)),
        Action("retire_match", lambda s: s.state in ("native", "evicted"),
               lambda s: SlotS("dead", 0)),
        # load-shed demotion (§27): a healthy bank-resident slot is moved
        # onto a per-session lockstep fallback — same destination state
        # as eviction, but from NATIVE, without a fault or quarantine
        Action("demote", lambda s: s.state == "native",
               lambda s: SlotS("evicted", 0)),
        Action("migrate",
               lambda s: s.state in ("native", "quarantined", "evicted"),
               lambda s: SlotS("migrated", 0)),
    )
    _assert_edges("supervision", table, {
        "fault": [("native", "quarantined")],
        "evict_ok": [("quarantined", "evicted")],
        "evict_fail": [("quarantined", "dead")],
        "evicted_fault": [("evicted", "dead")],
        "retire_match": [("native", "dead"), ("evicted", "dead")],
        "demote": [("native", "evicted")],
        "migrate": [("native", "migrated"), ("quarantined", "migrated"),
                    ("evicted", "migrated")],
    })
    return Model(
        "supervision",
        SlotS("native", 0),
        actions,
        invariants=(
            Invariant("declared-state",
                      lambda s: s.state in table.values),
            Invariant("bounded-evict-attempts",
                      lambda s: s.attempts < max_attempts),
        ),
        progress=(
            # a quarantined slot always resolves: evicted, dead, or
            # migrated — never parked in quarantine forever
            Progress("quarantine-resolves",
                     lambda s: s.state != "quarantined"),
        ),
        terminal=lambda s: s.state in ("dead", "migrated"),
    )


# ----------------------------------------------------------------------
# §16: shard lifecycle (shard.py table, generated edge-for-edge)
# ----------------------------------------------------------------------


class ShardS(NamedTuple):
    state: str


def lifecycle_model(root: Path, pkg: str = PKG) -> Model:
    table = _table(root, "lifecycle", pkg)
    sinks = {
        v for v in table.values
        if not any(src == v for src, _ in table.edges)
    }
    actions = tuple(
        Action(f"{src}->{dst}",
               (lambda s, _src=src: s.state == _src),
               (lambda s, _dst=dst: ShardS(_dst)))
        for src, dst in table.edges
    )
    return Model(
        "lifecycle",
        ShardS("active"),
        actions,
        invariants=(
            Invariant("declared-state",
                      lambda s: s.state in table.values),
        ),
        progress=(
            # every shard can still be drained to rest: RETIRED stays
            # reachable even from DEAD (respawn) and DRAINING
            Progress("retirable", lambda s: s.state == "retired"),
        ),
        terminal=lambda s: s.state in sinks,
    )


# ----------------------------------------------------------------------
# §16/§20.4: checkpoint ordering (HEAD vs the old-ordering fixture)
# ----------------------------------------------------------------------


class CkptS(NamedTuple):
    phase: str      # "top" (of tick) | "advanced" (requests emitted)
    cell_ok: bool   # save cells fully fulfilled (no pending re-save)
    ckpt: str       # "none" | "ok" | "poisoned"
    desynced: bool


def checkpoint_order_model(order: str = "head") -> Model:
    """The shard_migrate desync as a 4-field model (DESIGN.md §20.4).

    ``advance_rollback`` emits request lists whose corrective re-save is
    still unfulfilled (``cell_ok=False``) until the caller fulfills
    them.  HEAD checkpoints at the TOP of the next tick, when last
    tick's requests are fully fulfilled; the ``pre-pr11`` fixture
    checkpoints right after the advance — inside the mispredicted-cell
    window — and a journal-path failover that resumes from such a
    checkpoint desyncs permanently."""
    if order not in ("head", "pre-pr11"):
        raise ModelError(f"unknown checkpoint order {order!r}")
    ckpt_phase = "top" if order == "head" else "advanced"
    actions = (
        Action("advance_clean", lambda s: s.phase == "top",
               lambda s: s._replace(phase="advanced")),
        Action("advance_rollback", lambda s: s.phase == "top",
               lambda s: s._replace(phase="advanced", cell_ok=False)),
        Action("fulfill", lambda s: s.phase == "advanced",
               lambda s: s._replace(phase="top", cell_ok=True)),
        Action("checkpoint", lambda s: s.phase == ckpt_phase,
               lambda s: s._replace(
                   ckpt="ok" if s.cell_ok else "poisoned")),
        Action("crash_failover", lambda s: s.ckpt != "none",
               lambda s: CkptS("top", True, s.ckpt,
                               s.desynced or s.ckpt == "poisoned")),
    )
    return Model(
        f"checkpoint-order:{order}",
        CkptS("top", True, "none", False),
        actions,
        invariants=(
            # the §16 resume contract: a failover resumed from the
            # durable checkpoint re-simulates bit-identically
            Invariant("resume-on-chain", lambda s: not s.desynced),
        ),
        progress=(
            Progress("checkpoint-durable", lambda s: s.ckpt == "ok"),
        ),
    )


# ----------------------------------------------------------------------
# §27: the lockstep tier (max_prediction == 0)
# ----------------------------------------------------------------------

# frame horizon for the lockstep model's state space: the invariants are
# about the ORDER of confirm vs advance, not frame magnitude
LOCKSTEP_HORIZON = 3


class LsS(NamedTuple):
    current: int     # the frame the session is about to simulate
    confirmed: int   # the confirmed-frame watermark (-1 = none yet)
    saves: int       # SaveGameState requests emitted
    loads: int       # LoadGameState requests emitted


def lockstep_model(mode: str = "head") -> Model:
    """The §27 lockstep tier (``max_prediction == 0``) as a model —
    modeled BEFORE the pool demotion path was wired, per the §22 rule.

    HEAD has exactly two moves: a remote confirmation raises the
    watermark, and the session advances only when the current frame is
    fully confirmed (``P2PSession`` lockstep gate: ``last_confirmed ==
    current``).  The invariants are the tier's contract: zero
    SaveGameState/LoadGameState ever, and the simulation never runs past
    the confirmed frontier.  The ``predictive-advance`` fixture adds the
    one move a rollback-tier session performs routinely — advancing on a
    predicted (unconfirmed) frame — and must counterexample immediately:
    prediction IS the thing lockstep removes."""
    if mode not in ("head", "predictive-advance"):
        raise ModelError(f"unknown lockstep mode {mode!r}")
    actions = [
        # a remote input completes the current frame's confirmation
        Action("confirm_frame",
               lambda s: s.confirmed < s.current
               and s.confirmed < LOCKSTEP_HORIZON,
               lambda s: s._replace(confirmed=s.confirmed + 1)),
        # the lockstep advance gate: confirmed-frames-only
        Action("advance_confirmed",
               lambda s: s.confirmed == s.current
               and s.current < LOCKSTEP_HORIZON,
               lambda s: s._replace(current=s.current + 1)),
    ]
    if mode == "predictive-advance":
        actions.append(Action(
            "advance_predicted",
            lambda s: s.current > s.confirmed
            and s.current < LOCKSTEP_HORIZON,
            lambda s: s._replace(current=s.current + 1),
        ))
    return Model(
        f"lockstep:{mode}",
        LsS(0, -1, 0, 0),
        tuple(actions),
        invariants=(
            # the tier's defining contract: no state ring at all
            Invariant("never-saves", lambda s: s.saves == 0),
            Invariant("never-loads", lambda s: s.loads == 0),
            # at most the in-flight current frame ahead of the watermark
            Invariant("never-past-confirmed-frontier",
                      lambda s: s.current <= s.confirmed + 1),
        ),
        progress=(
            # confirmations always unblock the match: the full horizon
            # stays reachable from every state
            Progress("match-advances",
                     lambda s: s.current == LOCKSTEP_HORIZON),
        ),
        # the bounded horizon's end state is the declared finish line,
        # not a stall
        terminal=lambda s: s.current == LOCKSTEP_HORIZON
        and s.confirmed == LOCKSTEP_HORIZON,
    )


# ----------------------------------------------------------------------
# §16: the durable-before-send fsync barrier
# ----------------------------------------------------------------------


class DurS(NamedTuple):
    staged: bool   # local input appended to the journal buffer
    durable: bool  # fsynced
    sent: bool     # shipped to peers by the tick crossing
    lost: bool     # post-crash: peers hold a frame the journal lacks


def durable_before_send_model(barrier: bool = True) -> Model:
    """``advance_all`` fsyncs every journal BEFORE the crossing sends
    staged local inputs (shard.py's flush_local loop).  Without the
    barrier a crash after send leaves peers holding frames the journal
    cannot replay — the no-barrier fixture must counterexample."""
    def send_guard(s: DurS) -> bool:
        return s.staged and not s.sent and (s.durable or not barrier)

    actions = (
        Action("stage_local", lambda s: not s.staged,
               lambda s: s._replace(staged=True)),
        Action("fsync_barrier", lambda s: s.staged and not s.durable,
               lambda s: s._replace(durable=True)),
        Action("send_tick", send_guard,
               lambda s: s._replace(sent=True)),
        Action("crash_resume", lambda s: s.sent,
               lambda s: DurS(False, False, False,
                              s.lost or (s.sent and not s.durable))),
    )
    return Model(
        f"durable-before-send:{'head' if barrier else 'no-barrier'}",
        DurS(False, False, False, False),
        actions,
        invariants=(
            Invariant("journal-covers-the-wire", lambda s: not s.lost),
        ),
        progress=(
            Progress("inputs-ship", lambda s: s.sent),
        ),
    )


# ----------------------------------------------------------------------
# §16: send-window rewind + 3-regressive-ack rebase reconvergence
# ----------------------------------------------------------------------

REBASE_STREAK = 3   # identical consecutive regressive acks before rebase
_REORDER_DUP_MAX = 2  # how many duplicate stale acks reordering can fake


class RebS(NamedTuple):
    source: str    # "resumed" (peer really rewound) | "reorder" (dups)
    streak: int    # consecutive identical regressive acks observed
    rebased: bool
    wrong: bool    # a rebase triggered by reordering alone


def reconvergence_model(threshold: int = REBASE_STREAK) -> Model:
    """A resumed peer acks below our send window on EVERY message until
    we rebase; network reordering can also show us a stale (lower) ack,
    but only finitely many identical ones before a fresh in-order ack
    breaks the run.  The 3-identical-consecutive rule distinguishes the
    two; a ``threshold=1`` fixture rebases on the first stale ack and
    must counterexample (rewinding the send window for a reordered
    duplicate)."""
    actions = (
        Action("reorder_dup",
               lambda s: (s.source == "reorder" and not s.rebased
                          and s.streak < _REORDER_DUP_MAX),
               lambda s: s._replace(streak=s.streak + 1)),
        Action("fresh_ack",
               lambda s: s.source == "reorder" and not s.rebased,
               lambda s: s._replace(streak=0)),
        Action("resumed_ack",
               lambda s: s.source == "resumed" and not s.rebased,
               lambda s: s._replace(
                   streak=min(s.streak + 1, threshold))),
        Action("rebase",
               lambda s: not s.rebased and s.streak >= threshold,
               lambda s: s._replace(
                   rebased=True, wrong=s.source == "reorder")),
    )
    return Model(
        f"ack-rebase:{'head' if threshold == REBASE_STREAK else f'threshold-{threshold}'}",
        [RebS("resumed", 0, False, False),
         RebS("reorder", 0, False, False)],
        actions,
        invariants=(
            # rewinding the send window is for RESUMED peers only:
            # reordering alone must never trigger a rebase
            Invariant("no-rebase-on-reorder", lambda s: not s.wrong),
        ),
        progress=(
            # a genuinely resumed peer always reconverges
            Progress("resumed-peer-reconverges",
                     lambda s: s.rebased or s.source == "reorder"),
        ),
        terminal=lambda s: s.rebased,
    )


# ----------------------------------------------------------------------
# §17: watchdog / liveness (proc.py)
# ----------------------------------------------------------------------


class WdS(NamedTuple):
    proc: str         # "alive" | "wedged" | "stopped" | "gone"
    sup: str          # supervisor-side PROC_* status value
    sending: bool     # the incarnation can still reach the wire
    failed_over: bool
    restarts: int


def watchdog_model(root: Path, premature_failover: bool = False,
                   pkg: str = PKG) -> Model:
    """Heartbeat → SIGTERM → drain deadline → SIGKILL → reap → failover
    → (budgeted) respawn, against the wedged-but-still-sending runner.

    The supervisor-status edges every action performs are validated
    against ``PROC_TRANSITIONS`` parsed from proc.py.  The fixture adds
    the one action HEAD's code cannot perform — failing over from
    TERMINATING, before death is confirmed — and must counterexample
    with two live incarnations."""
    table = _table(root, "watchdog", pkg)
    sup_edges = {
        "sigterm": [("running", "terminating")],
        "graceful_drain": [],
        "reap": [("running", "exited"), ("terminating", "exited")],
        "sigkill": [("terminating", "exited")],
        "respawn": [("exited", "running")],
    }
    declared = set(table.edges)
    for name, edges in sup_edges.items():
        for e in edges:
            if e not in declared:
                raise ModelError(
                    f"watchdog action {name} performs supervisor edge "
                    f"{e[0]}->{e[1]}, absent from PROC_TRANSITIONS"
                )
    if declared != {e for es in sup_edges.values() for e in es}:
        raise ModelError(
            "PROC_TRANSITIONS declares edges the watchdog model "
            "does not exercise"
        )

    actions = [
        # the runner side: wedge keeps SENDING (the §17 hazard), a
        # SIGSTOP freeze does not, a crash can land at any moment
        Action("wedge", lambda s: s.proc == "alive",
               lambda s: s._replace(proc="wedged")),
        Action("freeze", lambda s: s.proc == "alive",
               lambda s: s._replace(proc="stopped", sending=False)),
        Action("crash", lambda s: s.proc in ("alive", "wedged", "stopped"),
               lambda s: s._replace(proc="gone", sending=False)),
        # the watchdog: a stale heartbeat SIGTERMs — including the
        # false positive on a runner that is merely slow (still alive)
        Action("sigterm",
               lambda s: s.sup == "running" and s.proc != "gone",
               lambda s: s._replace(sup="terminating")),
        Action("graceful_drain",
               lambda s: s.sup == "terminating" and s.proc == "alive",
               lambda s: s._replace(proc="gone", sending=False)),
        Action("reap",
               lambda s: s.proc == "gone" and s.sup in (
                   "running", "terminating"),
               lambda s: s._replace(sup="exited")),
        Action("sigkill",
               lambda s: s.sup == "terminating" and s.proc != "gone",
               lambda s: s._replace(proc="gone", sending=False,
                                    sup="exited")),
        Action("failover",
               lambda s: s.sup == "exited" and not s.failed_over,
               lambda s: s._replace(failed_over=True)),
        Action("respawn",
               lambda s: (s.failed_over and s.sup == "exited"
                          and s.restarts < RESTART_MAX),
               lambda s: WdS("alive", "running", True, False,
                             s.restarts + 1)),
    ]
    if premature_failover:
        actions.append(Action(
            "failover_premature",
            lambda s: s.sup == "terminating" and not s.failed_over,
            lambda s: s._replace(failed_over=True),
        ))
    return Model(
        f"watchdog:{'premature-failover' if premature_failover else 'head'}",
        WdS("alive", "running", True, False, 0),
        tuple(actions),
        invariants=(
            # failover only after CONFIRMED death — never while the old
            # incarnation might still be alive
            Invariant("failover-only-after-confirmed-death",
                      lambda s: not s.failed_over or s.proc == "gone"),
            # two live incarnations would fight over the wire
            Invariant("no-two-live-incarnations",
                      lambda s: not (s.failed_over and s.sending)),
            Invariant("restart-storm-budget",
                      lambda s: s.restarts <= RESTART_MAX),
        ),
        progress=(
            # a wedged/frozen/slow runner is always CONFIRMABLY dead
            # eventually: the SIGKILL fence works on all of them
            Progress("death-is-confirmable",
                     lambda s: s.proc == "gone" and s.sup == "exited"),
        ),
        terminal=lambda s: (s.sup == "exited" and s.failed_over
                            and s.restarts >= RESTART_MAX),
    )


# ----------------------------------------------------------------------
# §25: reconnect-vs-failover (fleet/transport.py TCP link)
# ----------------------------------------------------------------------


# epoch ceiling for the link model's state space (like RESTART_MAX:
# the invariants care about ORDER between epochs, not their magnitude,
# so the mint saturates instead of growing without bound)
EPOCH_MAX = 3


def _mint(sup: int) -> int:
    return min(sup + 1, EPOCH_MAX)


class LkS(NamedTuple):
    link: str                  # LINK_* value from LINK_TRANSITIONS
    window: bool               # reconnect window open?
    run: Optional[int]         # epoch the wire-side runner holds
                               # (None = fresh, not yet granted one)
    sup: int                   # the supervisor's minted epoch
    failed_over: bool          # §16 journal failover already ran
    stale_ack: bool            # a stale-epoch runner acked a tick
    premature: bool            # failover fired inside an open window


def link_model(root: Path, fenced: bool = True,
               premature: bool = False, pkg: str = PKG) -> Model:
    """The §25 TCP fleet-link machine: handshake → sever → bounded
    reconnect window → resume, or window expiry → confirmed dead →
    §16 failover → respawn under a fresh epoch — against a stale old
    incarnation that resurrects and re-dials.

    Every link_state edge the actions perform is validated against
    ``LINK_TRANSITIONS`` parsed from transport.py.  ``fenced=False``
    drops the epoch check from accept/resume — exactly what HEAD's
    handshake refuses — and must counterexample with a resurrected
    stale runner acking a tick after failover (split brain).
    ``premature=True`` adds the failover HEAD cannot perform — failing
    over while the reconnect window is still open."""
    table = _table(root, "link", pkg)

    def accept_guard(s: LkS) -> bool:
        if s.link != "connecting":
            return False
        # the fence: a handshake presenting a stale epoch is refused
        return (not fenced) or s.run is None or s.run == s.sup

    def accept_step(s: LkS) -> LkS:
        # a fresh runner is granted the current epoch in the verdict; a
        # resurrected one KEEPS its stale epoch (no re-grant — that is
        # the split-brain hazard the fence exists to stop)
        run = s.sup if s.run is None else s.run
        return s._replace(link="up", run=run)

    def resume_guard(s: LkS) -> bool:
        if s.link != "reconnecting" or not s.window:
            return False
        return (not fenced) or s.run == s.sup

    actions = [
        # handshake grant while awaiting a runner
        Action("accept", accept_guard, accept_step),
        # spawn deadline / refused handshakes only: give up on this
        # incarnation (mints a fresh epoch, like ShardLink.down)
        Action("fence_connect",
               lambda s: (s.link == "connecting" and s.run is not None
                          and s.run < s.sup),
               lambda s: s._replace(link="down", sup=_mint(s.sup))),
        # the transport sever: EOF/half-open opens the reconnect window
        Action("sever", lambda s: s.link == "up",
               lambda s: s._replace(link="reconnecting", window=True)),
        # an authenticated re-dial resumes inside the window
        Action("resume", resume_guard,
               lambda s: s._replace(link="up", window=False)),
        # window expiry: confirmed dead, epoch bumped (fencing mint)
        Action("expire",
               lambda s: s.link == "reconnecting" and s.window,
               lambda s: s._replace(link="down", window=False,
                                    sup=_mint(s.sup))),
        # fenced goodbye / supervisor teardown from a live link
        Action("goodbye", lambda s: s.link == "up",
               lambda s: s._replace(link="down", sup=_mint(s.sup))),
        # §16 journal failover: only once the link is DOWN (window
        # closed) — the liveness split poll_lifecycle enforces
        Action("failover",
               lambda s: (s.link == "down" and not s.window
                          and not s.failed_over),
               lambda s: s._replace(failed_over=True)),
        # the OLD incarnation survives on its host and re-dials
        Action("resurrect",
               lambda s: (s.link == "down" and s.failed_over
                          and s.run is not None and s.run < s.sup),
               lambda s: s._replace(link="connecting")),
        # the supervisor respawns a fresh runner under the new epoch
        Action("respawn",
               lambda s: s.link == "down" and s.failed_over,
               lambda s: s._replace(link="connecting", run=None)),
        # the wire-side runner acks a tick — the §25 fencing rule is
        # that a stale epoch must never get this far
        Action("ack_tick", lambda s: s.link == "up",
               lambda s: s._replace(
                   stale_ack=s.stale_ack or s.run != s.sup)),
    ]
    if premature:
        actions.append(Action(
            "failover_premature",
            lambda s: (s.link == "reconnecting" and s.window
                       and not s.failed_over),
            lambda s: s._replace(failed_over=True, premature=True,
                                 sup=_mint(s.sup)),
        ))
    _assert_edges("link", table, {
        "accept": [("connecting", "up")],
        "fence_connect": [("connecting", "down")],
        "sever": [("up", "reconnecting")],
        "resume": [("reconnecting", "up")],
        "expire": [("reconnecting", "down")],
        "goodbye": [("up", "down")],
        "failover": [],
        "resurrect": [("down", "connecting")],
        "respawn": [("down", "connecting")],
        "ack_tick": [],
        "failover_premature": [],
    })
    variant = ("premature-failover" if premature
               else ("head" if fenced else "split-brain"))
    return Model(
        f"link:{variant}",
        LkS("connecting", False, None, 1, False, False, False),
        tuple(actions),
        invariants=(
            # the fencing rule: a runner holding a stale epoch cannot
            # ack ticks (split brain = two incarnations driving state)
            Invariant("stale-epoch-never-acks",
                      lambda s: not s.stale_ack),
            # the liveness split: no failover while a reconnect window
            # is open — a severed link is NOT a dead shard
            Invariant("no-failover-inside-reconnect-window",
                      lambda s: not s.premature),
            # epochs flow supervisor → runner, never ahead of the mint
            Invariant("runner-epoch-never-ahead",
                      lambda s: s.run is None or s.run <= s.sup),
        ),
        progress=(
            # whatever the fault, a serving link is always reachable
            # (resume inside the window, or failover + respawn past it)
            Progress("link-eventually-serves",
                     lambda s: s.link == "up"),
        ),
    )


# ----------------------------------------------------------------------
# §26: route-flip ordering (fleet/placement_service.py migrations)
# ----------------------------------------------------------------------


class RfS(NamedTuple):
    phase: str         # MIG_* value from MIG_TRANSITIONS
    route: str         # where the virtual endpoint routes: "src" | "dst"
    adopted: bool      # the target supervisor ACKED the adoption
    sup: int           # the placement plane's minted route epoch
    writer: int        # epoch the (possibly fenced) route writer holds
    misroute: bool     # a flip landed before the adoption ack
    stale: bool        # a stale-epoch writer's route was accepted


def route_flip_model(root: Path, ordered: bool = True,
                     fenced: bool = True, pkg: str = PKG) -> Model:
    """The §26 cross-host migration machine: export off the source →
    adoption ack on the target → ingress route flip → settle, with the
    abort edge restoring the source — against a confirmed host death
    that mints a fresh route epoch while a fenced supervisor still
    believes it owns the route.

    Every ``phase`` edge the actions perform is validated against
    ``MIG_TRANSITIONS`` parsed from placement_service.py (the same
    table the §22 transition lint conforms the implementation to).
    ``ordered=False`` adds the flip HEAD cannot perform — pointing the
    virtual endpoint at the target BEFORE the adoption ack — and must
    counterexample with peers misrouted at a leg nobody serves.
    ``fenced=False`` drops the epoch check from route writes — exactly
    what the ingress's ``apply_route_update`` refuses as
    ``stale-epoch`` — and must counterexample with a fenced supervisor
    flipping a route after the failover epoch was minted."""
    table = _table(root, "route-flip", pkg)

    actions = [
        # export_transfer off the source (or the journal pickup when a
        # dead host's match fails over): nobody serves until adoption
        Action("begin", lambda s: s.phase == "idle",
               lambda s: s._replace(phase="exported")),
        # the target supervisor acked adopt_transfer/adopt_from_meta
        Action("adopt_ack", lambda s: s.phase == "exported",
               lambda s: s._replace(phase="adopted", adopted=True)),
        # the ingress route flip — HEAD orders it strictly after the
        # adoption ack (MIG_TRANSITIONS has no exported->flipped edge)
        Action("flip", lambda s: s.phase == "adopted",
               lambda s: s._replace(phase="flipped", route="dst")),
        # migration settles; the new leg is the next migration's source
        Action("settle", lambda s: s.phase == "flipped",
               lambda s: s._replace(phase="idle", route="src",
                                    adopted=False)),
        # adoption failed: the exported bytes restore the source
        Action("abort", lambda s: s.phase == "exported",
               lambda s: s._replace(phase="idle")),
        # a whole machine is confirmed dead: the placement plane mints
        # a fresh route epoch (kill_host), fencing everything the dead
        # incarnation's supervisor signed
        Action("host_die", lambda s: True,
               lambda s: s._replace(sup=_mint(s.sup))),
    ]
    if not ordered:
        actions.append(Action(
            "flip_premature",
            lambda s: s.phase == "exported",
            lambda s: s._replace(route="dst", misroute=True),
        ))
    if not fenced:
        actions.append(Action(
            "stale_write",
            lambda s: s.writer < s.sup,
            lambda s: s._replace(route="src", stale=True),
        ))
    _assert_edges("route-flip", table, {
        "begin": [("idle", "exported")],
        "adopt_ack": [("exported", "adopted")],
        "flip": [("adopted", "flipped")],
        "settle": [("flipped", "idle")],
        "abort": [("exported", "idle")],
        "host_die": [],
        "flip_premature": [],
        "stale_write": [],
    })
    variant = ("head" if ordered and fenced
               else ("flip-before-ack" if not ordered
                     else "stale-route-write"))
    return Model(
        f"route-flip:{variant}",
        RfS("idle", "src", False, 1, 1, False, False),
        tuple(actions),
        invariants=(
            # the ordering rule: the public route never points at a leg
            # whose adoption nobody acked (peers misrouted into a void)
            Invariant("no-route-flip-before-adoption-ack",
                      lambda s: not s.misroute),
            # the fencing rule: once a death minted a fresh epoch, a
            # supervisor holding the old one can never write a route
            Invariant("fenced-writer-never-routes",
                      lambda s: not s.stale),
            # epochs flow placement -> writers, never ahead of the mint
            Invariant("writer-epoch-never-ahead",
                      lambda s: s.writer <= s.sup),
        ),
        progress=(
            # whatever the interleaving, a migration can always settle
            Progress("migration-settles",
                     lambda s: s.phase == "idle"),
        ),
    )


# ----------------------------------------------------------------------
# the catalog + the verify leg
# ----------------------------------------------------------------------


class CatalogEntry(NamedTuple):
    name: str
    section: str                        # DESIGN.md anchor
    build: Callable[..., Model]         # (root, pkg=PKG) -> Model
    expect: str                         # "clean" | "counterexample"
    expect_kind: Optional[str] = None   # violated check kind for fixtures
    expect_actions: Optional[Tuple[str, ...]] = None  # pinned trace


MODEL_CATALOG: Tuple[CatalogEntry, ...] = (
    CatalogEntry("supervision", "§9", supervision_model, "clean"),
    CatalogEntry("lifecycle", "§16", lifecycle_model, "clean"),
    CatalogEntry("checkpoint-order:head", "§16",
                 lambda root, pkg=PKG:
                     checkpoint_order_model("head"), "clean"),
    CatalogEntry("checkpoint-order:pre-pr11", "§20.4",
                 lambda root, pkg=PKG: checkpoint_order_model("pre-pr11"),
                 "counterexample", "invariant",
                 ("advance_rollback", "checkpoint", "crash_failover")),
    CatalogEntry("lockstep:head", "§27",
                 lambda root, pkg=PKG: lockstep_model("head"), "clean"),
    # the rollback tier's routine move — advancing on a predicted frame
    # — is exactly what lockstep forbids: one such advance runs past the
    # confirmed frontier from the very first frame
    CatalogEntry("lockstep:predictive-advance", "§27",
                 lambda root, pkg=PKG: lockstep_model("predictive-advance"),
                 "counterexample", "invariant",
                 ("advance_predicted",)),
    CatalogEntry("durable-before-send:head", "§16",
                 lambda root, pkg=PKG:
                     durable_before_send_model(True), "clean"),
    CatalogEntry("durable-before-send:no-barrier", "§16",
                 lambda root, pkg=PKG: durable_before_send_model(False),
                 "counterexample", "invariant",
                 ("stage_local", "send_tick", "crash_resume")),
    CatalogEntry("ack-rebase:head", "§16",
                 lambda root, pkg=PKG: reconvergence_model(), "clean"),
    CatalogEntry("ack-rebase:threshold-1", "§16",
                 lambda root, pkg=PKG: reconvergence_model(1),
                 "counterexample", "invariant",
                 ("reorder_dup", "rebase")),
    CatalogEntry("watchdog:head", "§17",
                 lambda root, pkg=PKG:
                     watchdog_model(root, pkg=pkg), "clean"),
    CatalogEntry("watchdog:premature-failover", "§17",
                 lambda root, pkg=PKG:
                     watchdog_model(root, True, pkg=pkg),
                 "counterexample", "invariant",
                 ("sigterm", "failover_premature")),
    CatalogEntry("link:head", "§25",
                 lambda root, pkg=PKG: link_model(root, pkg=pkg), "clean"),
    # split brain: without the epoch fence, a runner that survives its
    # own failover resurrects, re-handshakes, and acks a tick while the
    # journal-recovered incarnation drives the same matches elsewhere
    CatalogEntry("link:split-brain", "§25",
                 lambda root, pkg=PKG:
                     link_model(root, pkg=pkg, fenced=False),
                 "counterexample", "invariant",
                 ("accept", "goodbye", "failover", "resurrect",
                  "accept", "ack_tick")),
    CatalogEntry("link:premature-failover", "§25",
                 lambda root, pkg=PKG:
                     link_model(root, pkg=pkg, premature=True),
                 "counterexample", "invariant",
                 ("accept", "sever", "failover_premature")),
    CatalogEntry("route-flip:head", "§26",
                 lambda root, pkg=PKG:
                     route_flip_model(root, pkg=pkg), "clean"),
    # misroute: flipping the virtual endpoint before the target acked
    # adoption points every peer at a leg nobody serves — the ordering
    # MIG_TRANSITIONS (no exported->flipped edge) makes unrepresentable
    CatalogEntry("route-flip:flip-before-ack", "§26",
                 lambda root, pkg=PKG:
                     route_flip_model(root, pkg=pkg, ordered=False),
                 "counterexample", "invariant",
                 ("begin", "flip_premature")),
    # stale route write: without the epoch fence at the ingress, a
    # supervisor that slept through kill_host's mint flips a route back
    # to the dead machine after failover already moved the match
    CatalogEntry("route-flip:stale-route-write", "§26",
                 lambda root, pkg=PKG:
                     route_flip_model(root, pkg=pkg, fenced=False),
                 "counterexample", "invariant",
                 ("host_die", "stale_write")),
)


def check_models(
    root: Path,
    max_states: int = 200_000,
    max_seconds: float = 30.0,
    pkg: str = PKG,
) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """Run the whole catalog over ``pkg``'s tables.  Returns
    ``(findings, results)`` where findings flag expectation mismatches
    (PASS == empty) and results carry the per-model verdicts + traces
    for --json."""
    findings: List[Finding] = []
    results: List[Dict[str, Any]] = []
    machines_path = f"{pkg}/analysis/machines.py"
    for entry in MODEL_CATALOG:
        try:
            model = entry.build(Path(root), pkg=pkg)
        except ModelError as e:
            findings.append(Finding(
                "model/build-error", machines_path, 0,
                f"{entry.name}: {e}",
            ))
            results.append({
                "model": entry.name, "section": entry.section,
                "ok": False, "kind": "build-error", "detail": str(e),
            })
            continue
        result = check(model, max_states=max_states,
                       max_seconds=max_seconds)
        results.append({
            "model": entry.name,
            "section": entry.section,
            "ok": result.ok,
            "kind": result.kind,
            "violation": result.violation,
            "states": result.states,
            "transitions": result.transitions,
            "depth": result.depth,
            "elapsed_s": round(result.elapsed_s, 4),
            "expect": entry.expect,
            "trace": result.trace_json(),
        })
        findings.extend(_judge(entry, model, result, machines_path))
    return findings, results


def _judge(entry: CatalogEntry, model: Model, result: CheckResult,
           machines_path: str = f"{PKG}/analysis/machines.py",
           ) -> List[Finding]:
    if entry.expect == "clean":
        if result.ok:
            return []
        return [Finding(
            "model/expectation", machines_path, 0,
            f"{entry.name} ({entry.section}) must explore clean: "
            + result.describe().replace("\n", " "),
        )]
    # fixture: a specific shortest counterexample is the PASS condition
    if result.ok:
        return [Finding(
            "model/expectation", machines_path, 0,
            f"{entry.name} ({entry.section}) is a known-broken fixture "
            "but explored clean — the checker lost this bug class",
        )]
    if entry.expect_kind is not None and result.kind != entry.expect_kind:
        return [Finding(
            "model/expectation", machines_path, 0,
            f"{entry.name}: expected a {entry.expect_kind} "
            f"counterexample, got {result.kind} ({result.violation})",
        )]
    if entry.expect_actions is not None:
        got = tuple(s.action for s in result.trace[1:])
        if got != entry.expect_actions:
            return [Finding(
                "model/expectation", machines_path, 0,
                f"{entry.name}: shortest counterexample drifted: "
                f"expected {' -> '.join(entry.expect_actions)}, "
                f"got {' -> '.join(got)}",
            )]
        # the trace must REPLAY — a counterexample is a checked artifact
        try:
            replay(model, result.trace)
        except ModelError as e:
            return [Finding(
                "model/expectation", machines_path, 0,
                f"{entry.name}: counterexample does not replay: {e}",
            )]
    return []
