"""The port's model-checking engine (``ggrs_tpu_torch/analysis/model.py``):
the twin of tests/test_model_engine.py, held against the JAX engine.

Every toy model is explored by both engines and must give the same result
field for field, elapsed time aside (``check`` asserts it): BFS
determinism, shortest counterexamples, the deadlock policy, progress as
reachability, budget verdicts and replayable traces.
"""

from typing import NamedTuple

import pytest

import ggrs_tpu.analysis.model as JM
from ggrs_tpu_torch.analysis import (
    Action,
    Invariant,
    Model,
    ModelError,
    Progress,
    replay,
)
from ggrs_tpu_torch.analysis import check as port_check

_ELAPSED = JM.CheckResult._fields.index("elapsed_s")


def check(model, **kw):
    """The port's verdict, held equal to the JAX engine's on the same model
    (an injected clock is consumed by one run, so that case runs once)."""
    r = port_check(model, **kw)
    if "clock" not in kw:
        j = JM.check(model, **kw)
        assert r[:_ELAPSED] + r[_ELAPSED + 1:] == j[:_ELAPSED] + j[_ELAPSED + 1:]
        assert r.describe().split(" [")[0] == j.describe().split(" [")[0]
        assert r.trace_json() == j.trace_json()
    return r


class S(NamedTuple):
    n: int


def counter(limit: int, **kwargs) -> Model:
    """0 -> 1 -> ... -> limit, absorbing at limit."""
    return Model(
        "counter",
        S(0),
        [Action("inc", lambda s: s.n < limit, lambda s: S(s.n + 1))],
        terminal=lambda s: s.n == limit,
        **kwargs,
    )


class TestExploration:
    def test_clean_chain_counts_states_and_depth(self):
        r = check(counter(5))
        assert r.ok and r.kind == "clean"
        assert r.states == 6
        assert r.transitions == 5
        assert r.depth == 5
        assert r.trace == ()

    def test_invariant_violation_is_shortest(self):
        # two ways to reach n=3: the long inc chain and a 1-step jump.
        # BFS must report the 1-step trace, never the 3-step one.
        m = Model(
            "shortcut",
            S(0),
            [
                Action("inc", lambda s: s.n < 3, lambda s: S(s.n + 1)),
                Action("jump", lambda s: s.n == 0, lambda s: S(3)),
            ],
            invariants=[Invariant("below-three", lambda s: s.n < 3)],
            terminal=lambda s: True,
        )
        r = check(m)
        assert not r.ok and r.kind == "invariant"
        assert r.violation == "below-three"
        assert [t.action for t in r.trace] == ["<init>", "jump"]

    def test_exploration_is_deterministic(self):
        m = Model(
            "nondet",
            S(0),
            [Action("fan", lambda s: s.n < 4,
                    lambda s: [S(s.n + 1), S(s.n + 2)])],
            terminal=lambda s: True,
        )
        results = [check(m) for _ in range(3)]
        assert len({(r.kind, r.states, r.transitions, r.depth)
                    for r in results}) == 1

    def test_nondet_branch_recorded_in_trace(self):
        m = Model(
            "branchy",
            S(0),
            [Action("fan", lambda s: s.n == 0, lambda s: [S(1), S(7)])],
            invariants=[Invariant("small", lambda s: s.n < 7)],
            terminal=lambda s: True,
        )
        r = check(m)
        assert not r.ok
        assert r.trace[-1].action == "fan" and r.trace[-1].branch == 1
        assert replay(m, r.trace) == S(7)

    def test_multiple_inits_are_a_list(self):
        m = Model(
            "two-roots",
            [S(0), S(10)],
            [Action("inc", lambda s: s.n in (0, 10),
                    lambda s: S(s.n + 1))],
            invariants=[Invariant("not-eleven", lambda s: s.n != 11)],
            terminal=lambda s: True,
        )
        r = check(m)
        assert not r.ok
        # counterexample roots at the SECOND init state
        assert r.trace[0].state == {"n": 10}

    def test_duplicate_action_names_rejected(self):
        with pytest.raises(ModelError, match="duplicate action"):
            Model("dup", S(0), [
                Action("a", lambda s: True, lambda s: s),
                Action("a", lambda s: True, lambda s: s),
            ])

    def test_unhashable_state_is_a_model_error(self):
        m = Model(
            "unhashable", S(0),
            [Action("bad", lambda s: True, lambda s: [[1]])],
        )
        with pytest.raises(ModelError, match="unhashable"):
            check(m)


class TestDeadlockAndProgress:
    def test_undeclared_sink_is_a_deadlock(self):
        r = check(Model(
            "stuck", S(0),
            [Action("inc", lambda s: s.n < 2, lambda s: S(s.n + 1))],
        ))
        assert not r.ok and r.kind == "deadlock"
        assert [t.action for t in r.trace] == ["<init>", "inc", "inc"]

    def test_terminal_blesses_the_sink(self):
        assert check(counter(2)).ok

    def test_progress_catches_the_wedge(self):
        # n=2 branches to a wedged n=9 loop from which the goal n=3 is
        # unreachable — safety never fires, progress must
        m = Model(
            "wedge",
            S(0),
            [
                Action("inc", lambda s: s.n < 3, lambda s: S(s.n + 1)),
                Action("wedge", lambda s: s.n == 2, lambda s: S(9)),
                Action("spin", lambda s: s.n == 9, lambda s: S(9)),
            ],
            progress=[Progress("reaches-three", lambda s: s.n == 3)],
            terminal=lambda s: s.n == 3,
        )
        r = check(m)
        assert not r.ok and r.kind == "progress"
        assert r.violation == "reaches-three"
        assert r.trace[-1].state == {"n": 9}
        assert replay(m, r.trace) == S(9)

    def test_progress_clean_when_goal_always_reachable(self):
        m = counter(3, progress=[Progress("done", lambda s: s.n == 3)])
        assert check(m).ok


class TestBudgets:
    def test_state_budget_yields_budget_verdict(self):
        r = check(counter(10_000), max_states=50)
        assert not r.ok and r.kind == "budget"
        assert "50 states" in r.violation

    def test_time_budget_uses_injected_clock(self):
        ticks = iter(range(1000))
        r = check(counter(10_000), max_seconds=5.0,
                  clock=lambda: float(next(ticks)))
        assert not r.ok and r.kind == "budget"


class TestReplay:
    def test_replay_rejects_tampered_trace(self):
        m = Model(
            "tamper", S(0),
            [Action("inc", lambda s: s.n < 3, lambda s: S(s.n + 1))],
            invariants=[Invariant("below", lambda s: s.n < 3)],
            terminal=lambda s: True,
        )
        r = check(m)
        assert not r.ok
        forged = list(r.trace)
        forged[-1] = forged[-1]._replace(state={"n": 99})
        with pytest.raises(ModelError, match="diverged"):
            replay(m, forged)

    def test_replay_rejects_disabled_action(self):
        m = counter(2)
        r = check(m)
        trace = list(check(Model(
            "donor", S(0),
            [Action("inc", lambda s: s.n < 3, lambda s: S(s.n + 1))],
            invariants=[Invariant("below", lambda s: s.n < 3)],
            terminal=lambda s: True,
        )).trace)
        assert r.ok
        with pytest.raises(ModelError, match="not enabled"):
            replay(m, trace)  # third inc is disabled at limit=2

    def test_describe_and_trace_json_round(self):
        r = check(Model(
            "desc", S(0),
            [Action("inc", lambda s: s.n < 1, lambda s: S(s.n + 1))],
            invariants=[Invariant("zero", lambda s: s.n == 0)],
        ))
        assert "invariant (zero)" in r.describe()
        assert "counterexample (1 steps): inc" in r.describe()
        assert r.trace_json() == [
            {"action": "<init>", "branch": 0, "state": {"n": 0}},
            {"action": "inc", "branch": 0, "state": {"n": 1}},
        ]


class TestSameEngine:
    def test_replay_accepts_the_other_engines_trace(self):
        m = Model(
            "cross", S(0),
            [Action("inc", lambda s: s.n < 3, lambda s: S(s.n + 1))],
            invariants=[Invariant("below", lambda s: s.n < 3)],
            terminal=lambda s: True,
        )
        j = JM.check(m)
        assert replay(m, j.trace) == S(3) == JM.replay(m, port_check(m).trace)

    def test_default_budgets_match(self):
        from ggrs_tpu_torch.analysis import model as PM

        assert (PM.DEFAULT_MAX_STATES, PM.DEFAULT_MAX_SECONDS) == \
            (JM.DEFAULT_MAX_STATES, JM.DEFAULT_MAX_SECONDS)
