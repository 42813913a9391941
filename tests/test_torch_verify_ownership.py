"""The port's thread-ownership lint (``ggrs_tpu_torch/analysis/ownership.py``):
the twin of tests/test_verify_ownership.py, held against the JAX lint.

Every fixture goes through both lints and must give the same findings
(``lint_src`` asserts it); the port's session classes declare exactly the
driving surface they guard; and the port's lint over the JAX tree gives the
JAX lint's findings.
"""

from pathlib import Path

import ggrs_tpu.analysis as J
from ggrs_tpu_torch.analysis import lint_ownership
from ggrs_tpu_torch.analysis.ownership import OWNERSHIP_SCOPE
from ggrs_tpu_torch.parallel.decode_pool import DecodePool
from ggrs_tpu_torch.sessions import P2PSession, SpectatorSession, SyncTestSession
from ggrs_tpu_torch.utils.ownership import ThreadOwned

REPO = Path(__file__).resolve().parents[1]


def lint_src(tmp_path, src: str):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(src)
    found = lint_ownership(tmp_path, scope=("pkg/",))
    assert found == J.lint_ownership(tmp_path, scope=("pkg/",))
    return found


OK_CLASS = """
class ThreadOwned:
    pass

class Session(ThreadOwned):
    _DRIVING_METHODS = ("advance",)

    def advance(self):
        self._check_owner()
        return 1

    def read_only(self):
        return 2
"""


class TestGoldenFixtures:
    def test_clean_class_passes(self, tmp_path):
        assert lint_src(tmp_path, OK_CLASS) == []

    def test_undeclared_fires(self, tmp_path):
        src = OK_CLASS.replace(
            '    _DRIVING_METHODS = ("advance",)\n', ""
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/undeclared"]

    def test_missing_guard_fires_on_unguarded_method(self, tmp_path):
        src = OK_CLASS.replace(
            "    def advance(self):\n        self._check_owner()\n",
            "    def advance(self):\n",
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/missing-guard"]

    def test_missing_guard_fires_on_phantom_method(self, tmp_path):
        src = OK_CLASS.replace(
            '_DRIVING_METHODS = ("advance",)',
            '_DRIVING_METHODS = ("advance", "phantom")',
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/missing-guard"]

    def test_unlisted_guard_fires(self, tmp_path):
        src = OK_CLASS.replace(
            "    def read_only(self):\n        return 2\n",
            "    def read_only(self):\n"
            "        self._check_owner()\n"
            "        return 2\n",
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/unlisted-guard"]

    def test_thread_target_fires(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "import threading\n"
            "def spawn(s):\n"
            "    return threading.Thread(target=s.advance)\n"
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/thread-target"]

    def test_subclass_inherits_declaration(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "class Derived(Session):\n"
            "    def helper(self):\n"
            "        return 3\n"
        )
        assert lint_src(tmp_path, src) == []

    def test_subclass_with_new_guard_must_declare(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "class Derived(Session):\n"
            "    def extra(self):\n"
            "        self._check_owner()\n"
            "        return 3\n"
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/undeclared"]


class TestHandOffGoldens:
    """The non-Thread escape hatches: Timer, executor.submit, and
    one-level bound-method aliasing.  The alias ALONE must stay clean —
    session_pool's same-thread hot-path alias is idiomatic — only the
    cross-thread hand-off fires."""

    def test_timer_positional_fires(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "import threading\n"
            "def arm(s):\n"
            "    return threading.Timer(0.5, s.advance)\n"
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/thread-target"]

    def test_timer_function_kw_fires(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "import threading\n"
            "def arm(s):\n"
            "    return threading.Timer(0.5, function=s.advance)\n"
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/thread-target"]

    def test_timer_with_benign_callback_is_clean(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "import threading\n"
            "def arm(s):\n"
            "    return threading.Timer(0.5, s.read_only)\n"
        )
        assert lint_src(tmp_path, src) == []

    def test_executor_submit_fires(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "def offload(pool, s):\n"
            "    return pool.submit(s.advance, 1)\n"
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/executor-submit"]

    def test_executor_submit_benign_is_clean(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "def offload(pool, s):\n"
            "    return pool.submit(s.read_only)\n"
        )
        assert lint_src(tmp_path, src) == []

    def test_alias_handed_to_thread_fires(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "import threading\n"
            "def spawn(s):\n"
            "    step = s.advance\n"
            "    return threading.Thread(target=step)\n"
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/thread-target"]
        assert "step (= ….advance)" in findings[0].detail

    def test_alias_handed_to_submit_fires(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "def offload(pool, s):\n"
            "    step = s.advance\n"
            "    return pool.submit(step)\n"
        )
        findings = lint_src(tmp_path, src)
        assert [f.rule for f in findings] == ["own/executor-submit"]

    def test_bare_alias_is_clean(self, tmp_path):
        # the same-thread hot-path alias (session_pool's
        # `add = self.host.add_local_input`) must never fire
        src = OK_CLASS + (
            "\n"
            "def hot_loop(s):\n"
            "    step = s.advance\n"
            "    for _ in range(8):\n"
            "        step()\n"
        )
        assert lint_src(tmp_path, src) == []


class TestTreeIsClean:
    def test_repo_ownership_clean(self):
        findings = lint_ownership(REPO)
        assert findings == [], "\n".join(f.render() for f in findings)

    def test_declarations_exist_and_are_live(self):
        """The runtime classes carry the declarations the lint reads,
        and every declared name is a real attribute."""
        for cls in (P2PSession, SpectatorSession, SyncTestSession):
            declared = cls._DRIVING_METHODS
            assert declared, f"{cls.__name__} declares no driving methods"
            for name in declared:
                assert callable(getattr(cls, name)), (cls, name)
        assert ThreadOwned._DRIVING_METHODS == ()


class TestReviewRegressions:
    def test_inheritance_resolution_is_name_order_independent(self, tmp_path):
        """A subclass sorting alphabetically BEFORE its declaring base
        must still inherit the declaration (bases resolve first)."""
        src = """
class ThreadOwned:
    pass

class ZBase(ThreadOwned):
    _DRIVING_METHODS = ("step",)

    def step(self):
        self._check_owner()
        return 1

class ASub(ZBase):
    _DRIVING_METHODS = ("step",)

    def step(self):
        self._check_owner()
        return 2

class AQuiet(ZBase):
    def helper(self):
        return 3
"""
        assert lint_src(tmp_path, src) == []

    def test_thread_target_pragma_suppresses(self, tmp_path):
        src = OK_CLASS + (
            "\n"
            "import threading\n"
            "def spawn(s):\n"
            "    return threading.Thread(target=s.advance)"
            "  # ggrs-verify: allow(own/thread-target)\n"
        )
        assert lint_src(tmp_path, src) == []


class TestPortTree:
    def test_scope_is_the_port_package(self):
        assert OWNERSHIP_SCOPE == ("ggrs_tpu_torch/",)

    def test_port_lint_over_the_jax_tree_equals_the_jax_lint(self):
        assert lint_ownership(REPO, scope=("ggrs_tpu/",)) == J.lint_ownership(REPO)

    def test_decode_pool_declares_its_guarded_surface(self):
        assert DecodePool._DRIVING_METHODS == ("decode_slots",)
        assert callable(getattr(DecodePool, "decode_slots"))

    def test_an_unguarded_port_method_fires_on_a_tree_copy(self, tmp_path):
        text = (REPO / "ggrs_tpu_torch/parallel/decode_pool.py").read_text()
        pkg = tmp_path / "ggrs_tpu_torch/parallel"
        pkg.mkdir(parents=True)
        (pkg / "decode_pool.py").write_text(text)
        assert lint_ownership(tmp_path) == []
        bare = text.replace("self._check_owner()", "pass", 1)
        assert bare != text
        (pkg / "decode_pool.py").write_text(bare)
        assert [f.rule for f in lint_ownership(tmp_path)] == ["own/missing-guard"]
