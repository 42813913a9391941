"""The port's transition-conformance lint
(``ggrs_tpu_torch/analysis/conformance.py``): the twin of
tests/test_verify_transitions.py, held against the JAX lint.

Every toy fixture goes through both lints and must give the same findings
(``lint_src`` asserts it); every setter site of the port's fleet layer
performs an edge of its declared table; the port's five tables equal the
JAX package's; and the port's lint over the JAX tree gives the JAX lint's
findings.
"""

from pathlib import Path

import ggrs_tpu.analysis as J
import ggrs_tpu.analysis.conformance as JC
from ggrs_tpu_torch.analysis import MACHINE_SPECS, lint_transitions
from ggrs_tpu_torch.analysis.conformance import (
    MachineSpec,
    machine_specs,
    parse_transition_table,
)

REPO = Path(__file__).resolve().parents[1]

SPEC = MachineSpec(
    name="toy",
    table_path="pkg/mod.py",
    table_name="TOY_TRANSITIONS",
    prefix="TOY_",
    setter_kind="attr",
    setter_name="state",
    dst_arg=0,
    scan=("pkg/mod.py",),
)

HEADER = '''
TOY_IDLE = "idle"
TOY_BUSY = "busy"
TOY_TRANSITIONS = (
    (TOY_IDLE, TOY_BUSY),
    (TOY_BUSY, TOY_IDLE),
)
'''


def lint_src(tmp_path, body: str, header: str = HEADER):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(header + body)
    found = lint_transitions(tmp_path, specs=(SPEC,))
    jspec = JC.MachineSpec(*SPEC)
    assert found == J.lint_transitions(tmp_path, specs=(jspec,))
    return found


def rules_of(findings):
    return [f.rule for f in findings]


class TestTableParsing:
    def test_missing_file(self, tmp_path):
        findings = lint_transitions(tmp_path, specs=(SPEC,))
        assert findings == J.lint_transitions(tmp_path, specs=(JC.MachineSpec(*SPEC),))
        assert rules_of(findings) == ["model/table-missing"]

    def test_missing_table(self, tmp_path):
        findings = lint_src(tmp_path, "", header='TOY_IDLE = "idle"\n')
        assert rules_of(findings) == ["model/table-missing"]

    def test_table_entry_with_undeclared_constant(self, tmp_path):
        bad = HEADER.replace("(TOY_BUSY, TOY_IDLE),",
                             "(TOY_BUSY, TOY_GONE),")
        findings = lint_src(tmp_path, "", header=bad)
        assert "model/unknown-state" in rules_of(findings)

    def test_parse_live_tables(self):
        for spec in MACHINE_SPECS:
            table, findings = parse_transition_table(REPO, spec)
            assert findings == [], (spec.name, findings)
            assert table is not None and len(table.edges) >= 4


class TestSiteResolution:
    def test_pragma_site_on_declared_edge_is_clean(self, tmp_path):
        assert lint_src(tmp_path, '''
class Toy:
    def go(self):
        # ggrs-model: transitions(idle->busy)
        self.state = TOY_BUSY
''') == []

    def test_pragma_declaring_unlisted_edge_fires(self, tmp_path):
        findings = lint_src(tmp_path, '''
class Toy:
    def go(self):
        # ggrs-model: transitions(busy->busy2)
        self.state = TOY_BUSY
''')
        assert "model/unknown-state" in rules_of(findings)

    def test_pragma_dst_mismatch_fires(self, tmp_path):
        findings = lint_src(tmp_path, '''
class Toy:
    def go(self):
        # ggrs-model: transitions(idle->busy)
        self.state = TOY_IDLE
''')
        assert rules_of(findings) == ["model/transition-unlisted"]

    def test_guard_inference_clean(self, tmp_path):
        assert lint_src(tmp_path, '''
class Toy:
    def go(self):
        if self.state == TOY_IDLE:
            self.state = TOY_BUSY
''') == []

    def test_guard_inference_unlisted_edge_fires(self, tmp_path):
        findings = lint_src(tmp_path, '''
TOY_DEAD = "dead"

class Toy:
    def go(self):
        if self.state == TOY_IDLE:
            self.state = TOY_DEAD
''')
        assert rules_of(findings) == ["model/transition-unlisted"]

    def test_else_branch_never_infers(self, tmp_path):
        # inferring idle from the ELSE of `== TOY_IDLE` would invert the
        # guard; the site must be undeclared instead
        findings = lint_src(tmp_path, '''
class Toy:
    def go(self):
        if self.state == TOY_IDLE:
            pass
        else:
            self.state = TOY_BUSY
''')
        assert rules_of(findings) == ["model/transition-undeclared"]

    def test_bare_site_is_undeclared(self, tmp_path):
        findings = lint_src(tmp_path, '''
class Toy:
    def go(self):
        self.state = TOY_BUSY
''')
        assert rules_of(findings) == ["model/transition-undeclared"]

    def test_init_sites_are_exempt(self, tmp_path):
        assert lint_src(tmp_path, '''
class Toy:
    def __init__(self):
        self.state = TOY_IDLE
''') == []

    def test_reflexive_pragma_edge_is_fine(self, tmp_path):
        assert lint_src(tmp_path, '''
class Toy:
    def refresh(self):
        # ggrs-model: transitions(busy->busy)
        self.state = TOY_BUSY
''') == []

    def test_allow_pragma_suppresses(self, tmp_path):
        assert lint_src(tmp_path, '''
class Toy:
    def go(self):
        self.state = TOY_BUSY  # ggrs-verify: allow(model/transition-undeclared)
''') == []


class TestTreeIsClean:
    def test_live_fleet_layer_conforms(self):
        assert lint_transitions(REPO) == []


class TestPortTree:
    def test_specs_are_the_jax_specs_at_the_port_paths(self):
        assert [tuple(s) for s in machine_specs("ggrs_tpu")] == \
            [tuple(s) for s in JC.MACHINE_SPECS]
        for spec in MACHINE_SPECS:
            assert spec.table_path.startswith("ggrs_tpu_torch/")
            assert all(p.startswith("ggrs_tpu_torch/") for p in spec.scan)

    def test_port_tables_equal_the_jax_tables(self):
        for port_spec, jax_spec in zip(MACHINE_SPECS, JC.MACHINE_SPECS):
            port, pf = parse_transition_table(REPO, port_spec)
            jax, jf = JC.parse_transition_table(REPO, jax_spec)
            assert pf == [] and jf == []
            assert (port.states, port.values, port.edges) == \
                (jax.states, jax.values, jax.edges), port_spec.name

    def test_port_lint_over_the_jax_tree_equals_the_jax_lint(self):
        assert lint_transitions(REPO, machine_specs("ggrs_tpu")) == J.lint_transitions(REPO)

    def test_an_undeclared_edge_in_a_port_copy_fires(self, tmp_path):
        spec = next(s for s in MACHINE_SPECS if s.name == "route-flip")
        text = (REPO / spec.table_path).read_text()
        target = tmp_path / spec.table_path
        target.parent.mkdir(parents=True)
        target.write_text(text)
        assert lint_transitions(tmp_path, (spec,)) == []
        bare = text.replace("# ggrs-model: transitions(", "# transitions(", 1)
        assert bare != text
        target.write_text(bare)
        assert "model/transition-undeclared" in rules_of(lint_transitions(tmp_path, (spec,)))
