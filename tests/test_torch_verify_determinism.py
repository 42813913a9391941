"""The port's determinism lint (``ggrs_tpu_torch/analysis/determinism.py``):
the twin of tests/test_verify_determinism.py, held against the JAX lint.

Every snippet the JAX file lints goes through both ``lint_source``
functions and must give the same findings (``rules_of`` asserts it); then
the port's own rules — torch's process-global RNG and the torch compile and
graph-capture shapes — each with a snippet that fires and one that does
not, the port's tree clean against a baseline that equals the JAX one at
the port's paths (fault C5 pinned), and the port's lint over the JAX tree
equal to the JAX lint.
"""

import json
from pathlib import Path

import pytest

import ggrs_tpu.analysis as J
from ggrs_tpu.analysis import determinism as JD
from ggrs_tpu_torch.analysis import (
    DETERMINISM_RULES,
    load_baseline,
    lint_determinism,
)
from ggrs_tpu_torch.analysis.baseline import Baseline, write_baseline
from ggrs_tpu_torch.analysis.determinism import DET_SCOPE, det_scope, lint_source
from ggrs_tpu_torch.analysis.report import Finding

REPO = Path(__file__).resolve().parents[1]
PKG = "ggrs_tpu_torch"
BASELINE = REPO / PKG / "analysis/determinism_baseline.json"
JAX_BASELINE = REPO / "ggrs_tpu/analysis/determinism_baseline.json"


def rules_of(src: str, scope: str = "sim"):
    found = lint_source(src, "x.py", scope)
    assert found == JD.lint_source(src, "x.py", scope)
    return sorted({f.rule for f in found})


def port_rules_of(src: str, scope: str = "sim"):
    """For the port's own rules: no JAX counterpart to compare with."""
    return sorted({f.rule for f in lint_source(src, "x.py", scope)})


# ----------------------------------------------------------------------
# one firing + one non-firing golden per rule
# ----------------------------------------------------------------------


class TestWallClock:
    def test_fires(self):
        assert rules_of(
            "import time\n"
            "def f():\n"
            "    return time.monotonic()\n"
        ) == ["det/wall-clock"]
        assert rules_of(
            "import datetime\n"
            "def f():\n"
            "    return datetime.datetime.now()\n"
        ) == ["det/wall-clock"]

    def test_injected_clock_does_not_fire(self):
        assert rules_of(
            "def f(clock):\n"
            "    return clock()\n"
            "def g(self):\n"
            "    return self._clock()\n"
        ) == []

    def test_time_ns_variants_fire(self):
        assert rules_of(
            "import time\n"
            "def f():\n"
            "    return time.perf_counter_ns() + time.time_ns()\n"
        ) == ["det/wall-clock"]


class TestUnseededRng:
    def test_module_level_rng_fires(self):
        assert rules_of(
            "import random\n"
            "def f():\n"
            "    return random.randint(0, 3)\n"
        ) == ["det/unseeded-rng"]

    def test_noarg_random_fires(self):
        assert rules_of(
            "import random\n"
            "def f():\n"
            "    return random.Random()\n"
        ) == ["det/unseeded-rng"]

    def test_seeded_random_does_not_fire(self):
        assert rules_of(
            "import random\n"
            "def f(seed):\n"
            "    rng = random.Random(seed)\n"
            "    return rng.randint(0, 3)\n"
        ) == []

    def test_entropy_sources_fire(self):
        assert rules_of(
            "import os, uuid\n"
            "def f():\n"
            "    return os.urandom(8), uuid.uuid4()\n"
        ) == ["det/unseeded-rng"]
        assert rules_of(
            "import numpy as np\n"
            "def f():\n"
            "    return np.random.rand(3)\n"
        ) == ["det/unseeded-rng"]


class TestSetIteration:
    def test_for_over_set_fires(self):
        assert rules_of(
            "def f(xs):\n"
            "    for x in set(xs):\n"
            "        yield x\n"
        ) == ["det/set-iteration"]

    def test_comprehension_and_list_fire(self):
        assert rules_of(
            "def f(xs):\n"
            "    return [x for x in {1, 2}] + list(frozenset(xs))\n"
        ) == ["det/set-iteration"]

    def test_sorted_set_does_not_fire(self):
        assert rules_of(
            "def f(xs):\n"
            "    for x in sorted(set(xs)):\n"
            "        yield x\n"
            "    return sorted({1, 2})\n"
        ) == []

    def test_membership_does_not_fire(self):
        assert rules_of(
            "def f(xs, x):\n"
            "    s = set(xs)\n"
            "    return x in s\n"
        ) == []


class TestHashOrder:
    def test_builtin_hash_fires(self):
        assert rules_of(
            "def f(s):\n"
            "    return hash(s)\n"
        ) == ["det/hash-order"]

    def test_sort_key_id_fires(self):
        assert rules_of(
            "def f(xs):\n"
            "    xs.sort(key=id)\n"
            "    return sorted(xs, key=id)\n"
        ) == ["det/hash-order"]

    def test_crc_does_not_fire(self):
        assert rules_of(
            "import zlib\n"
            "def f(b):\n"
            "    return zlib.crc32(b)\n"
        ) == []


class TestJitFloatReduce:
    def test_sum_in_jit_fires(self):
        assert rules_of(
            "import jax\n"
            "@jax.jit\n"
            "def f(xs):\n"
            "    return sum(xs)\n"
        ) == ["det/jit-float-reduce"]

    def test_sum_outside_jit_does_not_fire(self):
        assert rules_of(
            "def f(xs):\n"
            "    return sum(xs)\n"
        ) == []

    def test_jnp_sum_in_jit_does_not_fire(self):
        assert rules_of(
            "import jax, jax.numpy as jnp\n"
            "@jax.jit\n"
            "def f(xs):\n"
            "    return jnp.sum(xs)\n"
        ) == []


class TestPickleProtocol:
    def test_unpinned_fires(self):
        assert rules_of(
            "import pickle\n"
            "def f(x):\n"
            "    return pickle.dumps(x)\n",
            scope="bundle",
        ) == ["det/pickle-protocol"]

    def test_highest_protocol_fires(self):
        assert rules_of(
            "import pickle\n"
            "def f(x):\n"
            "    return pickle.dumps(x, protocol=pickle.HIGHEST_PROTOCOL)\n",
            scope="bundle",
        ) == ["det/pickle-protocol"]

    def test_pinned_does_not_fire(self):
        assert rules_of(
            "import pickle\n"
            "PROTO = 4\n"
            "def f(x):\n"
            "    return pickle.dumps(x, protocol=4), "
            "pickle.dumps(x, protocol=PROTO)\n",
            scope="bundle",
        ) == []

    def test_loads_does_not_fire(self):
        assert rules_of(
            "import pickle\n"
            "def f(b):\n"
            "    return pickle.loads(b)\n",
            scope="bundle",
        ) == []


class TestScopesAndPragmas:
    def test_bundle_scope_allows_wall_clock(self):
        src = "import time\ndef f():\n    return time.monotonic()\n"
        assert rules_of(src, scope="sim") == ["det/wall-clock"]
        assert rules_of(src, scope="bundle") == []

    def test_allow_pragma_suppresses(self):
        assert rules_of(
            "def f(s):\n"
            "    return hash(s)  # ggrs-verify: allow(det/hash-order)\n"
        ) == []

    def test_allow_pragma_is_rule_specific(self):
        assert rules_of(
            "def f(s):\n"
            "    return hash(s)  # ggrs-verify: allow(det/wall-clock)\n"
        ) == ["det/hash-order"]


# ----------------------------------------------------------------------
# baseline semantics + the self-clean gate
# ----------------------------------------------------------------------


def F(rule, path, line, detail):
    return Finding(rule, path, line, detail)


class TestBaseline:
    def test_split_absorbs_up_to_count(self):
        f1 = F("det/wall-clock", "a.py", 10, "time.time() ...")
        f2 = F("det/wall-clock", "a.py", 20, "time.time() ...")
        f3 = F("det/wall-clock", "a.py", 30, "time.time() ...")
        base = Baseline({f1.key(): 2})
        new, legacy = base.split([f1, f2, f3])
        assert len(legacy) == 2 and len(new) == 1
        assert (new, legacy) == J.Baseline({f1.key(): 2}).split([f1, f2, f3])

    def test_line_moves_do_not_invalidate(self):
        f_old = F("det/hash-order", "a.py", 5, "builtin hash() ...")
        f_moved = F("det/hash-order", "a.py", 99, "builtin hash() ...")
        base = Baseline.from_findings([f_old])
        new, legacy = base.split([f_moved])
        assert new == [] and legacy == [f_moved]

    def test_roundtrip(self, tmp_path):
        base = Baseline({
            "det/wall-clock::a.py::time.time() read": 2,
            "det/hash-order::b.py::builtin hash()": 1,
            "det/wall-clock::a.py::burned down": 0,
        })
        path = tmp_path / "b.json"
        write_baseline(path, base)
        loaded = load_baseline(path)
        assert loaded.counts == {
            "det/wall-clock::a.py::time.time() read": 2,
            "det/hash-order::b.py::builtin hash()": 1,
        }
        # the JAX writer gives the same bytes
        J.write_baseline(tmp_path / "j.json", J.Baseline(base.counts))
        assert (tmp_path / "j.json").read_text() == path.read_text()

    def test_on_disk_format_is_per_file_v2(self, tmp_path):
        path = tmp_path / "b.json"
        write_baseline(path, Baseline({
            "det/wall-clock::a.py::time.time() read": 2,
        }))
        data = json.loads(path.read_text())
        assert data["version"] == 2
        assert data["files"] == {"a.py": [
            {"rule": "det/wall-clock", "detail": "time.time() read",
             "count": 2},
        ]}

    def test_v1_baseline_is_rejected_with_guidance(self, tmp_path):
        path = tmp_path / "b.json"
        path.write_text(json.dumps({"version": 1, "entries": []}))
        with pytest.raises(ValueError, match="--baseline-update"):
            load_baseline(path)
        with pytest.raises(ValueError, match="port_verify.py"):
            load_baseline(path)

    def test_missing_file_is_empty(self, tmp_path):
        assert load_baseline(tmp_path / "nope.json").counts == {}


class TestScope:
    def test_rollback_visible_files_are_in_sim_scope(self):
        sim_files = {p for s, p in DET_SCOPE if s == "sim"}
        assert f"{PKG}/parallel/session_pool.py" in sim_files
        assert f"{PKG}/broadcast/journal.py" in sim_files
        assert det_scope("ggrs_tpu") == JD.DET_SCOPE


class TestTreeIsClean:
    def test_repo_has_no_new_determinism_findings(self):
        findings = lint_determinism(REPO)
        new, _legacy = load_baseline(BASELINE).split(findings)
        assert new == [], "\n".join(f.render() for f in new)

    def test_baseline_is_not_stale(self):
        findings = lint_determinism(REPO)
        live = Baseline.from_findings(findings).counts
        base = load_baseline(BASELINE).counts
        stale = {
            k: n for k, n in base.items() if live.get(k, 0) < n
        }
        assert not stale, f"stale baseline entries: {stale}"

    def test_rule_catalog_matches_emitted_rules(self):
        assert set(DETERMINISM_RULES) >= {
            f.rule for f in lint_determinism(REPO)
        }
        assert DETERMINISM_RULES == J.DETERMINISM_RULES


class TestJaxRandomIsFunctional:
    def test_keyed_jax_random_does_not_fire(self):
        assert rules_of(
            "import jax\n"
            "def f(key):\n"
            "    return jax.random.uniform(key, (3,))\n"
        ) == []


class TestReviewRegressions:
    def test_pickle_dump_positional_protocol_not_flagged(self):
        assert rules_of(
            "import pickle\n"
            "def f(x, fh):\n"
            "    pickle.dump(x, fh, 4)\n",
            scope="bundle",
        ) == []

    def test_pickle_dumps_positional_protocol_not_flagged(self):
        assert rules_of(
            "import pickle\n"
            "def f(x):\n"
            "    return pickle.dumps(x, 4)\n",
            scope="bundle",
        ) == []

    def test_pickle_dump_without_protocol_fires(self):
        assert rules_of(
            "import pickle\n"
            "def f(x, fh):\n"
            "    pickle.dump(x, fh)\n",
            scope="bundle",
        ) == ["det/pickle-protocol"]

    def test_from_imported_nondeterminism_fires(self):
        assert rules_of(
            "from time import perf_counter, monotonic as mono\n"
            "from random import random\n"
            "def f():\n"
            "    return perf_counter() + mono() + random()\n"
        ) == ["det/unseeded-rng", "det/wall-clock"]

    def test_module_alias_import_fires(self):
        assert rules_of(
            "import time as t\n"
            "def f():\n"
            "    return t.monotonic()\n"
        ) == ["det/wall-clock"]

    def test_from_import_of_datetime_fires(self):
        assert rules_of(
            "from datetime import datetime\n"
            "def f():\n"
            "    return datetime.now()\n"
        ) == ["det/wall-clock"]

    def test_default_protocol_fires(self):
        assert rules_of(
            "import pickle\n"
            "def f(x):\n"
            "    return pickle.dumps(x, protocol=pickle.DEFAULT_PROTOCOL)\n",
            scope="bundle",
        ) == ["det/pickle-protocol"]

    def test_protocol_minus_one_fires(self):
        assert rules_of(
            "import pickle\n"
            "def f(x):\n"
            "    return pickle.dumps(x, -1)\n",
            scope="bundle",
        ) == ["det/pickle-protocol"]

    def test_protocol_none_fires(self):
        assert rules_of(
            "import pickle\n"
            "def f(x):\n"
            "    return pickle.dumps(x, protocol=None)\n",
            scope="bundle",
        ) == ["det/pickle-protocol"]


# ----------------------------------------------------------------------
# the port's own rules: torch's global RNG, compiled and captured code
# ----------------------------------------------------------------------


class TestTorchGlobalRng:
    @pytest.mark.parametrize("call", [
        "torch.rand(3)", "torch.randn(2, 2)", "torch.randint(0, 4, (3,))",
        "torch.randperm(8)", "torch.normal(0.0, 1.0, (3,))",
        "torch.bernoulli(p)", "torch.multinomial(p, 2)",
        "x.uniform_()", "x.normal_(0, 1)", "x.random_(0, 9)", "x.bernoulli_(0.5)",
        "torch.manual_seed(7)", "torch.seed()", "torch.cuda.manual_seed_all(7)",
        "torch.random.manual_seed(7)",
    ])
    def test_global_generator_fires(self, call):
        src = f"import torch\ndef f(x, p):\n    return {call}\n"
        assert port_rules_of(src) == ["det/unseeded-rng"]
        assert JD.lint_source(src, "x.py") == []  # the JAX lint cannot see it

    @pytest.mark.parametrize("call", [
        "torch.rand(3, generator=g)", "torch.randn(2, 2, generator=g)",
        "torch.randint(0, 4, (3,), generator=g)", "torch.randperm(8, generator=g)",
        "torch.multinomial(p, 2, generator=g)", "x.uniform_(generator=g)",
        "torch.Generator().manual_seed(7)", "g.manual_seed(7)",
        "torch.zeros(3)", "torch.arange(4)",
    ])
    def test_explicit_generator_does_not_fire(self, call):
        src = f"import torch\ndef f(x, p, g):\n    return {call}\n"
        assert port_rules_of(src) == []

    def test_from_import_and_alias_fire(self):
        assert port_rules_of(
            "from torch import randn as rn\n"
            "import torch as T\n"
            "def f():\n"
            "    return rn(3), T.rand(2)\n"
        ) == ["det/unseeded-rng"]

    def test_bundle_scope_ignores_rng(self):
        assert port_rules_of("import torch\ndef f():\n    return torch.rand(3)\n",
                             scope="bundle") == []


class TestTorchCompiledCode:
    @pytest.mark.parametrize("deco", [
        "@torch.compile", "@torch.compile(fullgraph=True)", "@torch.jit.script",
        "@triton.jit", "@functools.partial(torch.compile, dynamic=False)",
    ])
    def test_sum_under_compile_decorators_fires(self, deco):
        src = ("import functools, torch, triton\n"
               f"{deco}\n"
               "def f(xs):\n"
               "    return sum(xs)\n")
        assert port_rules_of(src) == ["det/jit-float-reduce"]
        assert JD.lint_source(src, "x.py") == []

    @pytest.mark.parametrize("wrap", [
        "step = torch.compile(step)", "traced = torch.jit.trace(step, (x,))",
        "g = torch.cuda.make_graphed_callables(step, (x,))",
        "g = torch.cuda.make_graphed_callables((step, other), ((x,), (x,)))",
    ])
    def test_sum_in_function_compiled_by_name_fires(self, wrap):
        src = ("import torch\n"
               "def step(xs):\n"
               "    return sum(xs)\n"
               "def other(xs):\n"
               "    return xs\n"
               "def build(x):\n"
               f"    {wrap}\n")
        assert port_rules_of(src) == ["det/jit-float-reduce"]

    def test_sum_in_cuda_graph_capture_body_fires(self):
        src = ("import torch\n"
               "def capture(g, xs):\n"
               "    with torch.cuda.graph(g):\n"
               "        out = sum(xs)\n"
               "    return sum(xs), out\n")
        found = lint_source(src, "x.py")
        assert [(f.rule, f.line) for f in found] == [("det/jit-float-reduce", 4)]

    def test_plain_torch_code_does_not_fire(self):
        assert port_rules_of(
            "import torch\n"
            "def f(xs):\n"
            "    with torch.no_grad():\n"
            "        return sum(xs), torch.sum(torch.stack(xs))\n"
            "@torch.no_grad()\n"
            "def g(xs):\n"
            "    return sum(xs)\n"
        ) == []

    def test_compiled_torch_sum_does_not_fire(self):
        assert port_rules_of(
            "import torch\n"
            "@torch.compile\n"
            "def f(x):\n"
            "    return torch.sum(x)\n"
        ) == []


# ----------------------------------------------------------------------
# the port's tree, its baseline, and the JAX tree through the port's lint
# ----------------------------------------------------------------------


class TestPortTree:
    def test_baseline_equals_the_jax_one_at_the_port_paths(self):
        jax = json.loads(JAX_BASELINE.read_text())
        port = json.loads(BASELINE.read_text())
        assert port == {
            "version": jax["version"],
            "files": {p.replace("ggrs_tpu/", f"{PKG}/", 1): e
                      for p, e in jax["files"].items()},
        }
        assert set(port["files"]) == {f"{PKG}/broadcast/journal.py"}

    def test_tree_findings_are_exactly_the_baseline(self):
        findings = lint_determinism(REPO)
        assert Baseline.from_findings(findings).counts == load_baseline(BASELINE).counts
        assert {(f.rule, f.path) for f in findings} == {
            ("det/wall-clock", f"{PKG}/broadcast/journal.py")}

    def test_checksum_hash_keeps_its_reviewed_exception(self):
        # fault C5: the port's copy of DeviceChecksum.__hash__ lost the
        # pragma the JAX line carries
        src = (REPO / PKG / "ops/checksum.py").read_text()
        line = next(l for l in src.splitlines() if "return hash(self.materialize())" in l)
        assert line.endswith("# ggrs-verify: allow(det/hash-order)")
        assert [f for f in lint_source(src, "checksum.py") if f.rule == "det/hash-order"] == []
        bare = src.replace("  # ggrs-verify: allow(det/hash-order)", "")
        assert [f.rule for f in lint_source(bare, "checksum.py")] == ["det/hash-order"]

    def test_port_lint_over_the_jax_tree_equals_the_jax_lint(self):
        assert lint_determinism(REPO, det_scope("ggrs_tpu")) == J.lint_determinism(REPO)
