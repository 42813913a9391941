"""Deterministic explicit-state model checker (pillar 4 of ggrs-verify).

The repo's worst bugs are ORDERING bugs in its protocol state machines,
not layout drift: the shard_migrate desync (DESIGN.md §20.4) was a
checkpoint taken between request-list emission and fulfillment — an
interleaving chaos needed dozens of seeded runs to hit and a 4-state
model finds in milliseconds.  This module is the engine; the tree's
real machines (supervision §9, journal/failover ordering §16,
watchdog/liveness §17) live in :mod:`.machines`, and the transition-
conformance lint that ties the models back to source is
:mod:`.conformance`.

Semantics, deliberately minimal:

- A :class:`Model` is a set of initial states (any hashable values), a
  tuple of :class:`Action`\\ s (``guard`` predicate + ``step`` that
  returns one successor or a list of successors — a list is a
  nondeterministic choice), safety :class:`Invariant`\\ s checked on
  every reachable state, and :class:`Progress` goals checked as
  liveness-via-reachability: from EVERY reachable state a goal state
  must remain reachable (a state from which the goal is unreachable is
  a "stuck" counterexample — the wedge that simple safety never sees).
- :func:`check` explores breadth-first.  BFS discovery order is
  nondecreasing in depth and actions run in declared order, so
  exploration is fully deterministic and the first violation found is a
  SHORTEST counterexample.
- Traces are replayable: every step records ``(action, branch)`` —
  the branch index disambiguates nondeterministic steps — and
  :func:`replay` re-derives the violating state from the initial one,
  so a counterexample is a checked artifact, not a pretty-print.
- Budgets (``max_states`` / ``max_seconds``) turn a runaway model into
  a loud ``budget`` verdict instead of a hung CI leg.

The engine never imports the modules whose machines it checks — models
are built from parsed source (see machines.py), so a broken tree still
gets a verdict.
"""

from __future__ import annotations

import time
from collections import deque
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

DEFAULT_MAX_STATES = 200_000
DEFAULT_MAX_SECONDS = 30.0


class ModelError(Exception):
    """A malformed model (unhashable state, unknown action, bad table):
    the MODEL is broken, distinct from the model finding a violation."""


class Action(NamedTuple):
    name: str
    guard: Callable[[Any], bool]
    step: Callable[[Any], Any]  # one successor, or a list (nondet choice)


class Invariant(NamedTuple):
    name: str
    holds: Callable[[Any], bool]


class Progress(NamedTuple):
    """Liveness-via-reachability: every reachable state must still be
    able to reach a ``goal`` state."""

    name: str
    goal: Callable[[Any], bool]


class TraceStep(NamedTuple):
    action: str   # "<init>" for step 0
    branch: int   # successor index within the action's step() result
    state: Any


class Model:
    def __init__(
        self,
        name: str,
        init: Any,
        actions: Sequence[Action],
        invariants: Sequence[Invariant] = (),
        progress: Sequence[Progress] = (),
        terminal: Optional[Callable[[Any], bool]] = None,
        render: Optional[Callable[[Any], Any]] = None,
    ) -> None:
        self.name = name
        # multiple init states are passed as a LIST — never a tuple,
        # since NamedTuple states are themselves tuples
        self.inits: Tuple[Any, ...] = (
            tuple(init) if isinstance(init, list) else (init,)
        )
        self.actions = tuple(actions)
        self.invariants = tuple(invariants)
        self.progress = tuple(progress)
        # deadlock policy: a state with no enabled action violates unless
        # ``terminal`` blesses it (absorbing states are declared, never
        # accidental)
        self.terminal = terminal or (lambda s: False)
        self.render = render or _default_render
        names = [a.name for a in self.actions]
        if len(set(names)) != len(names):
            raise ModelError(f"model {name}: duplicate action names")


def _default_render(state: Any) -> Any:
    asdict = getattr(state, "_asdict", None)
    if asdict is not None:
        return dict(asdict())
    return repr(state)


class CheckResult(NamedTuple):
    model: str
    ok: bool
    kind: str          # "clean" | "invariant" | "deadlock" | "progress" | "budget"
    violation: str     # invariant/progress name, or detail for the rest
    states: int        # distinct states discovered
    transitions: int   # edges traversed (with multiplicity)
    depth: int         # max BFS depth reached (graph diameter when clean)
    elapsed_s: float
    trace: Tuple[TraceStep, ...]  # shortest counterexample; () when clean

    def describe(self) -> str:
        head = (
            f"model {self.model}: "
            + ("clean" if self.ok else f"{self.kind} ({self.violation})")
        )
        tail = (f" [{self.states} states, {self.transitions} transitions, "
                f"depth {self.depth}, {self.elapsed_s * 1e3:.1f} ms]")
        if self.trace:
            steps = " -> ".join(s.action for s in self.trace[1:])
            tail += f"\n  counterexample ({len(self.trace) - 1} steps): {steps}"
        return head + tail

    def trace_json(self) -> List[Dict[str, Any]]:
        return [
            {"action": s.action, "branch": s.branch, "state": s.state}
            for s in self.trace
        ]


def _successors(action: Action, state: Any) -> List[Any]:
    nxt = action.step(state)
    return list(nxt) if isinstance(nxt, list) else [nxt]


def _build_trace(
    model: Model,
    parents: Dict[Any, Optional[Tuple[Any, str, int]]],
    state: Any,
) -> Tuple[TraceStep, ...]:
    steps: List[TraceStep] = []
    cur: Any = state
    while True:
        link = parents[cur]
        if link is None:
            steps.append(TraceStep("<init>", 0, model.render(cur)))
            break
        prev, action, branch = link
        steps.append(TraceStep(action, branch, model.render(cur)))
        cur = prev
    steps.reverse()
    return tuple(steps)


def check(
    model: Model,
    *,
    max_states: int = DEFAULT_MAX_STATES,
    max_seconds: float = DEFAULT_MAX_SECONDS,
    clock: Callable[[], float] = time.monotonic,
) -> CheckResult:
    """Breadth-first exploration: deterministic, shortest-counterexample.

    Safety invariants are checked the moment a state is DISCOVERED (BFS
    discovery order is nondecreasing in depth, so the first violation is
    at minimal depth).  Deadlocks are checked at expansion.  Progress
    goals run after a complete exploration, as reverse reachability over
    the explored graph."""
    t0 = clock()
    parents: Dict[Any, Optional[Tuple[Any, str, int]]] = {}
    depth: Dict[Any, int] = {}
    adjacency: Dict[Any, List[Any]] = {}
    queue: deque = deque()
    transitions = 0
    max_depth = 0

    def result(ok: bool, kind: str, violation: str,
               trace: Tuple[TraceStep, ...] = ()) -> CheckResult:
        return CheckResult(
            model.name, ok, kind, violation, len(parents), transitions,
            max_depth, clock() - t0, trace,
        )

    def discover(state: Any, link) -> Optional[CheckResult]:
        try:
            if state in parents:
                return None
        except TypeError:
            raise ModelError(
                f"model {model.name}: unhashable state {state!r}"
            )
        parents[state] = link
        d = 0 if link is None else depth[link[0]] + 1
        depth[state] = d
        nonlocal max_depth
        max_depth = max(max_depth, d)
        for inv in model.invariants:
            if not inv.holds(state):
                return result(
                    False, "invariant", inv.name,
                    _build_trace(model, parents, state),
                )
        queue.append(state)
        return None

    for s0 in model.inits:
        bad = discover(s0, None)
        if bad is not None:
            return bad

    while queue:
        if len(parents) > max_states or (clock() - t0) > max_seconds:
            return result(
                False, "budget",
                f"exploration exceeded {max_states} states / "
                f"{max_seconds:.1f}s",
            )
        state = queue.popleft()
        enabled = False
        out = adjacency.setdefault(state, [])
        for action in model.actions:
            if not action.guard(state):
                continue
            enabled = True
            for branch, nxt in enumerate(_successors(action, state)):
                transitions += 1
                out.append(nxt)
                bad = discover(nxt, (state, action.name, branch))
                if bad is not None:
                    return bad
        if not enabled and not model.terminal(state):
            return result(
                False, "deadlock", "state has no enabled action",
                _build_trace(model, parents, state),
            )

    # liveness-via-progress over the fully explored graph: reverse BFS
    # from the goal set; a state outside the reverse-reachable set can
    # never reach the goal again — the shortest path to the FIRST such
    # state in discovery order (minimal depth) is the counterexample
    if model.progress:
        reverse: Dict[Any, List[Any]] = {}
        for src, dsts in adjacency.items():
            for dst in dsts:
                reverse.setdefault(dst, []).append(src)
        for goal in model.progress:
            reached = set()
            rq: deque = deque()
            for state in parents:
                if goal.goal(state):
                    reached.add(state)
                    rq.append(state)
            while rq:
                cur = rq.popleft()
                for prev in reverse.get(cur, ()):
                    if prev not in reached:
                        reached.add(prev)
                        rq.append(prev)
            for state in parents:  # discovery order == depth order
                if state not in reached:
                    return result(
                        False, "progress", goal.name,
                        _build_trace(model, parents, state),
                    )

    return result(True, "clean", "")


def replay(model: Model, trace: Iterable[TraceStep]) -> Any:
    """Re-derive a trace's final state from the model itself — proof the
    counterexample is a real run, not a printing artifact.  Steps are
    matched by action name; ``branch`` picks the successor of a
    nondeterministic step.  Raises ModelError on any mismatch."""
    steps = list(trace)
    if not steps or steps[0].action != "<init>":
        raise ModelError("trace must start with the <init> step")
    by_name = {a.name: a for a in model.actions}
    state = None
    for init in model.inits:
        if model.render(init) == steps[0].state:
            state = init
            break
    if state is None:
        raise ModelError("trace initial state is not a model init state")
    for step in steps[1:]:
        action = by_name.get(step.action)
        if action is None:
            raise ModelError(f"trace names unknown action {step.action!r}")
        if not action.guard(state):
            raise ModelError(
                f"action {step.action!r} is not enabled at {state!r}"
            )
        succ = _successors(action, state)
        if step.branch >= len(succ):
            raise ModelError(
                f"action {step.action!r} has no branch {step.branch}"
            )
        state = succ[step.branch]
        if model.render(state) != step.state:
            raise ModelError(
                f"replay diverged at {step.action!r}: {state!r}"
            )
    return state
