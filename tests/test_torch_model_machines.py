"""The port's protocol models (``ggrs_tpu_torch/analysis/machines.py``):
the twin of tests/test_model_machines.py, then the same 18 results as the
JAX catalog, field for field (elapsed time aside), on each package's own
tables.

The JAX file's pins, on the port's tables:

The load-bearing pins:
- the old checkpoint-ordering fixture (``pre-pr11``) must REDISCOVER the
  shard_migrate desync (DESIGN.md §20.4) as its shortest
  counterexample — that bug took long chaos runs to diagnose, and is
  this plane's reason to exist;
- every HEAD model explores invariant-clean;
- fixture counterexamples replay (they are runs, not pretty-prints);
- the whole catalog fits the build_sanitized.sh 60s budget with
  orders of magnitude to spare.
"""

import time
from pathlib import Path

import pytest

import ggrs_tpu.analysis.machines as JMach
from ggrs_tpu_torch.analysis import check, replay
from ggrs_tpu_torch.analysis.machines import (
    MODEL_CATALOG,
    check_models,
    checkpoint_order_model,
    durable_before_send_model,
    reconvergence_model,
    supervision_model,
    watchdog_model,
)

REPO = Path(__file__).resolve().parents[1]


def actions_of(result):
    return [s.action for s in result.trace[1:]]


class TestCatalog:
    def test_catalog_is_clean_and_fast(self):
        t0 = time.monotonic()
        findings, results = check_models(REPO)
        elapsed = time.monotonic() - t0
        assert findings == []
        assert len(results) == len(MODEL_CATALOG) == 18
        assert elapsed < 60.0  # the build_sanitized.sh budget
        by_name = {r["model"]: r for r in results}
        heads = [n for n in by_name if n.endswith(":head")
                 or n in ("supervision", "lifecycle")]
        assert all(by_name[n]["kind"] == "clean" for n in heads)

    def test_fixture_traces_are_embedded(self):
        _, results = check_models(REPO)
        by_name = {r["model"]: r for r in results}
        fix = by_name["checkpoint-order:pre-pr11"]
        assert fix["kind"] == "invariant"
        assert [s["action"] for s in fix["trace"][1:]] == [
            "advance_rollback", "checkpoint", "crash_failover",
        ]
        assert fix["trace"][-1]["state"]["desynced"] is True

    def test_budget_exhaustion_is_a_finding(self):
        findings, results = check_models(REPO, max_states=3)
        assert findings  # expectation broken: "budget" != clean
        assert all(f.rule == "model/expectation" for f in findings)
        assert any(r["kind"] == "budget" for r in results)


class TestCheckpointOrdering:
    def test_pre_pr11_rediscovers_the_shard_migrate_desync(self):
        r = check(checkpoint_order_model("pre-pr11"))
        assert not r.ok and r.kind == "invariant"
        assert r.violation == "resume-on-chain"
        # SHORTEST counterexample: rollback-advance, checkpoint inside
        # the mispredicted-cell window, failover from that checkpoint
        assert actions_of(r) == [
            "advance_rollback", "checkpoint", "crash_failover",
        ]
        final = replay(checkpoint_order_model("pre-pr11"), r.trace)
        assert final.desynced and final.ckpt == "poisoned"

    def test_head_ordering_is_clean(self):
        r = check(checkpoint_order_model("head"))
        assert r.ok, r.describe()


class TestDurableBeforeSend:
    def test_no_barrier_loses_the_wire(self):
        r = check(durable_before_send_model(False))
        assert not r.ok and r.violation == "journal-covers-the-wire"
        assert actions_of(r) == [
            "stage_local", "send_tick", "crash_resume",
        ]

    def test_barrier_is_clean(self):
        assert check(durable_before_send_model(True)).ok


class TestAckRebase:
    def test_threshold_three_survives_reordering(self):
        assert check(reconvergence_model()).ok

    def test_threshold_one_rebases_on_a_duplicate(self):
        r = check(reconvergence_model(1))
        assert not r.ok and r.violation == "no-rebase-on-reorder"
        assert actions_of(r) == ["reorder_dup", "rebase"]


class TestWatchdog:
    def test_head_watchdog_is_clean(self):
        r = check(watchdog_model(REPO))
        assert r.ok, r.describe()
        # the wedged-but-still-sending runner is actually in the state
        # space: depth must exceed the trivial kill path
        assert r.depth >= 8

    def test_premature_failover_is_caught(self):
        r = check(watchdog_model(REPO, premature_failover=True))
        assert not r.ok
        assert r.violation == "failover-only-after-confirmed-death"
        assert actions_of(r) == ["sigterm", "failover_premature"]


class TestSourceCoupling:
    def test_supervision_model_tracks_the_declared_table(self, tmp_path):
        # the model is BUILT from the parsed SLOT_TRANSITIONS table;
        # a tree without the table must fail loudly, not model a stale
        # hardcoded copy
        from ggrs_tpu_torch.analysis import ModelError
        with pytest.raises(ModelError):
            supervision_model(tmp_path)

    def test_supervision_head_is_clean(self):
        r = check(supervision_model(REPO))
        assert r.ok, r.describe()


def _timeless(results):
    return [{k: v for k, v in r.items() if k != "elapsed_s"} for r in results]


class TestSameModelsAsJax:
    def test_each_package_on_its_own_tables(self):
        port_findings, port = check_models(REPO)
        jax_findings, jax = JMach.check_models(REPO)
        assert port_findings == jax_findings == []
        assert len(port) == len(jax) == 18
        assert _timeless(port) == _timeless(jax)

    def test_port_engine_on_the_jax_tables(self):
        port_findings, port = check_models(REPO, pkg="ggrs_tpu")
        jax_findings, jax = JMach.check_models(REPO)
        assert port_findings == jax_findings
        assert _timeless(port) == _timeless(jax)

    def test_catalog_entries_match(self):
        assert [(e.name, e.section, e.expect, e.expect_kind, e.expect_actions)
                for e in MODEL_CATALOG] == \
            [(e.name, e.section, e.expect, e.expect_kind, e.expect_actions)
             for e in JMach.MODEL_CATALOG]

    def test_budget_findings_name_each_packages_path(self):
        port, _ = check_models(REPO, max_states=3)
        jax, _ = JMach.check_models(REPO, max_states=3)
        assert {f.path for f in port} == {"ggrs_tpu_torch/analysis/machines.py"}
        assert [(f.rule, f.detail.split(":")[0]) for f in port] == \
            [(f.rule, f.detail.split(":")[0]) for f in jax]

    def test_a_tree_without_the_port_tables_is_a_build_error(self, tmp_path):
        findings, results = check_models(tmp_path)
        failed = [r["model"] for r in results if r["kind"] == "build-error"]
        # the root-independent models still build; every table-built one fails
        assert failed == [e.name for e in MODEL_CATALOG
                          if e.name.split(":")[0] in ("supervision", "lifecycle", "watchdog",
                                                      "link", "route-flip")]
        assert [f.rule for f in findings] == ["model/build-error"] * len(failed)
        jax_findings, _ = JMach.check_models(tmp_path)
        assert [f.detail.split(":")[0] for f in findings] == \
            [f.detail.split(":")[0] for f in jax_findings]
