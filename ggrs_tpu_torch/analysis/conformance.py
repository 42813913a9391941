"""Transition-conformance lint: code-performed transitions ⊆ declared
tables (the static half of ggrs-model, DESIGN.md §22).

The fleet layer's three protocol state machines used to be implicit —
whichever assignments the code happened to perform.  They are now
DECLARED, next to their state constants:

====================  ==================  ============================
machine               table               file
====================  ==================  ============================
slot supervision §9   SLOT_TRANSITIONS    parallel/host_bank.py
watchdog/liveness §17 PROC_TRANSITIONS    fleet/proc.py
shard lifecycle §16   SHARD_TRANSITIONS   fleet/shard.py
====================  ==================  ============================

This lint parses each table from source (no imports — same contract as
every other ggrs-verify pillar) and proves every setter site performs a
declared edge.  A site's source state comes from one of:

- a ``# ggrs-model: transitions(src->dst[, src->dst...])`` pragma on
  the site's line or the line above — the reviewed per-site statement
  of which edges this assignment may perform;
- guard inference, for the clean pattern where the site sits under an
  enclosing ``if <state> == STATE_CONST:`` body;
- neither → ``model/transition-undeclared`` (write the pragma).

Assignments inside ``__init__`` are initial-state sites, not
transitions.  Reflexive pairs (``a->a``) are ignored — the runtime
setters already early-return on no-change.

The same tables feed the exploration side: :mod:`.machines` builds the
§9/§16/§17 models from them, so declared table, model, and code cannot
drift apart independently.

Rules: ``model/table-missing``, ``model/unknown-state``,
``model/transition-undeclared``, ``model/transition-unlisted``.  All
are hard findings (never baseline-eligible); a reviewed exception uses
the standard ``# ggrs-verify: allow(model/...)`` pragma.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .report import PKG, Finding, allow_pragmas, is_allowed

# rule id -> one-line catalog entry (DESIGN.md §22 renders this)
TRANSITION_RULES: Dict[str, str] = {
    "model/table-missing": "declared transition table absent/unparseable",
    "model/unknown-state": "pragma or table names an undeclared state",
    "model/transition-undeclared":
        "setter site with no pragma and no inferable source state",
    "model/transition-unlisted":
        "site performs an edge missing from the declared table",
}

_PRAGMA_RE = re.compile(r"#\s*ggrs-model:\s*transitions\(([^)]*)\)")


class MachineSpec(NamedTuple):
    name: str                # machine id used in finding details
    table_path: str          # repo-relative file declaring the table
    table_name: str          # e.g. "SLOT_TRANSITIONS"
    prefix: str              # state-constant prefix, e.g. "SLOT_"
    setter_kind: str         # "call" (method call) | "attr" (assignment)
    setter_name: str         # "_set_slot_state" | "_status" | "state"
    dst_arg: int             # for "call": positional index of the dst
    scan: Tuple[str, ...]    # repo-relative files holding setter sites


class MachineTable(NamedTuple):
    spec: MachineSpec
    states: Dict[str, str]            # CONST name -> state value
    values: Tuple[str, ...]           # declared values, declaration order
    edges: Tuple[Tuple[str, str], ...]  # (src, dst) values, table order


def machine_specs(pkg: str = PKG) -> Tuple[MachineSpec, ...]:
    """The five machines' specs, their paths rooted at ``pkg``."""
    return (
        MachineSpec(
            name="supervision",
            table_path=f"{pkg}/parallel/host_bank.py",
            table_name="SLOT_TRANSITIONS",
            prefix="SLOT_",
            setter_kind="call",
            setter_name="_set_slot_state",
            dst_arg=1,
            scan=(f"{pkg}/parallel/host_bank.py",),
        ),
        MachineSpec(
            name="watchdog",
            table_path=f"{pkg}/fleet/proc.py",
            table_name="PROC_TRANSITIONS",
            prefix="PROC_",
            setter_kind="attr",
            setter_name="_status",
            dst_arg=0,
            scan=(f"{pkg}/fleet/proc.py",),
        ),
        MachineSpec(
            name="lifecycle",
            table_path=f"{pkg}/fleet/shard.py",
            table_name="SHARD_TRANSITIONS",
            prefix="SHARD_",
            setter_kind="attr",
            setter_name="state",
            dst_arg=0,
            scan=(
                f"{pkg}/fleet/shard.py",
                f"{pkg}/fleet/proc.py",
                f"{pkg}/fleet/supervisor.py",
            ),
        ),
        MachineSpec(
            name="link",
            table_path=f"{pkg}/fleet/transport.py",
            table_name="LINK_TRANSITIONS",
            prefix="LINK_",
            setter_kind="attr",
            setter_name="link_state",
            dst_arg=0,
            scan=(f"{pkg}/fleet/transport.py",),
        ),
        MachineSpec(
            name="route-flip",
            table_path=f"{pkg}/fleet/placement_service.py",
            table_name="MIG_TRANSITIONS",
            prefix="MIG_",
            setter_kind="attr",
            setter_name="phase",
            dst_arg=0,
            scan=(f"{pkg}/fleet/placement_service.py",),
        ),
    )


MACHINE_SPECS: Tuple[MachineSpec, ...] = machine_specs()


# ----------------------------------------------------------------------
# table parsing (shared with machines.py)
# ----------------------------------------------------------------------


def _const_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def parse_transition_table(
    root: Path, spec: MachineSpec
) -> Tuple[Optional[MachineTable], List[Finding]]:
    """Parse the declared states (``PREFIX_* = "value"``) and the table
    (a module-level tuple of 2-tuples of state constants) from source."""
    path = Path(root) / spec.table_path
    if not path.exists():
        return None, [Finding(
            "model/table-missing", spec.table_path, 0,
            f"{spec.name}: file declaring {spec.table_name} is missing",
        )]
    tree = ast.parse(path.read_text())
    states: Dict[str, str] = {}
    table_node: Optional[ast.AST] = None
    table_line = 0
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        if (
            target.id.startswith(spec.prefix)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            states[target.id] = node.value.value
        elif target.id == spec.table_name:
            table_node = node.value
            table_line = node.lineno
    if table_node is None:
        return None, [Finding(
            "model/table-missing", spec.table_path, 0,
            f"{spec.name}: no module-level {spec.table_name} tuple",
        )]
    findings: List[Finding] = []
    edges: List[Tuple[str, str]] = []
    elts = table_node.elts if isinstance(
        table_node, (ast.Tuple, ast.List)
    ) else []
    for pair in elts:
        names = [
            _const_name(e) for e in pair.elts
        ] if isinstance(pair, (ast.Tuple, ast.List)) and len(
            pair.elts
        ) == 2 else [None]
        if any(n is None or n not in states for n in names):
            findings.append(Finding(
                "model/unknown-state", spec.table_path, pair.lineno,
                f"{spec.table_name} entry is not a pair of declared "
                f"{spec.prefix}* constants",
            ))
            continue
        edges.append((states[names[0]], states[names[1]]))
    # declaration-order values keep downstream model action order (and
    # therefore counterexample traces) deterministic
    values = tuple(dict.fromkeys(states.values()))
    if not edges and not findings:
        findings.append(Finding(
            "model/table-missing", spec.table_path, table_line,
            f"{spec.table_name} declares no edges",
        ))
    table = MachineTable(spec, states, values, tuple(edges))
    return table, findings


# ----------------------------------------------------------------------
# site discovery + source-state resolution
# ----------------------------------------------------------------------


def _parent_map(tree: ast.AST) -> Dict[ast.AST, Tuple[ast.AST, str]]:
    parents: Dict[ast.AST, Tuple[ast.AST, str]] = {}
    for parent in ast.walk(tree):
        for field, value in ast.iter_fields(parent):
            if isinstance(value, ast.AST):
                parents[value] = (parent, field)
            elif isinstance(value, list):
                for child in value:
                    if isinstance(child, ast.AST):
                        parents[child] = (parent, field)
    return parents


def _iter_sites(tree: ast.AST, spec: MachineSpec):
    """Yield ``(node, dst_expr)`` for every setter site of this machine.
    ``dst_expr`` is None when the assigned value is not syntactically
    present (short call)."""
    for node in ast.walk(tree):
        if spec.setter_kind == "call":
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == spec.setter_name
            ):
                dst = (
                    node.args[spec.dst_arg]
                    if len(node.args) > spec.dst_arg else None
                )
                yield node, dst
        else:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Attribute)
                and node.targets[0].attr == spec.setter_name
            ):
                yield node, node.value


def _resolve_state(
    expr: Optional[ast.AST], states: Dict[str, str]
) -> Optional[str]:
    name = _const_name(expr) if expr is not None else None
    return states.get(name) if name is not None else None


def _enclosing_function(node, parents):
    cur = node
    while cur in parents:
        cur = parents[cur][0]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
    return None


def _state_compare(test: ast.AST, states: Dict[str, str]) -> Optional[str]:
    """``x == STATE_CONST`` (either side) -> the state value."""
    if not (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.Eq)
    ):
        return None
    for side in (test.left, test.comparators[0]):
        value = _resolve_state(side, states)
        if value is not None:
            return value
    return None


def _inferred_source(node, parents, states) -> Optional[str]:
    """Nearest enclosing ``if <...> == STATE_CONST:`` BODY (never the
    else branch — that would invert the guard) within the function."""
    cur = node
    while cur in parents:
        parent, field = parents[cur]
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        if isinstance(parent, ast.If) and field == "body":
            src = _state_compare(parent.test, states)
            if src is not None:
                return src
        cur = parent
    return None


def _pragma_pairs(
    lines: Sequence[str], lineno: int
) -> Optional[List[Tuple[str, str]]]:
    """Parse ``# ggrs-model: transitions(a->b, c->d)`` from the site's
    line or the line above.  Returns None when no pragma is present;
    a malformed pair surfaces as an ('', raw) entry the caller flags."""
    for idx in (lineno - 1, lineno - 2):
        if 0 <= idx < len(lines):
            m = _PRAGMA_RE.search(lines[idx])
            if m:
                pairs: List[Tuple[str, str]] = []
                for part in m.group(1).split(","):
                    part = part.strip()
                    if not part:
                        continue
                    if "->" in part:
                        src, dst = part.split("->", 1)
                        pairs.append((src.strip(), dst.strip()))
                    else:
                        pairs.append(("", part))
                return pairs
    return None


# ----------------------------------------------------------------------
# the lint
# ----------------------------------------------------------------------


def lint_transitions(
    root: Path, specs: Sequence[MachineSpec] = MACHINE_SPECS
) -> List[Finding]:
    root = Path(root)
    findings: List[Finding] = []
    allows: Dict[str, Dict[int, set]] = {}
    for spec in specs:
        table, table_findings = parse_transition_table(root, spec)
        findings.extend(table_findings)
        if table is None:
            continue
        edge_set = set(table.edges)
        for rel in spec.scan:
            path = root / rel
            if not path.exists():
                findings.append(Finding(
                    "model/table-missing", rel, 0,
                    f"{spec.name}: scan file is missing",
                ))
                continue
            text = path.read_text()
            lines = text.splitlines()
            if rel not in allows:
                allows[rel] = allow_pragmas(lines)
            tree = ast.parse(text)
            parents = _parent_map(tree)
            for site, dst_expr in _iter_sites(tree, spec):
                lineno = site.lineno
                dst = _resolve_state(dst_expr, table.states)
                fn = _enclosing_function(site, parents)
                if fn is not None and fn.name == "__init__":
                    continue  # initial-state site, not a transition
                pairs = _pragma_pairs(lines, lineno)
                if pairs is not None:
                    declared_dsts = set()
                    for src, pdst in pairs:
                        if src not in table.values or (
                            pdst not in table.values
                        ):
                            findings.append(Finding(
                                "model/unknown-state", rel, lineno,
                                f"{spec.name}: pragma pair "
                                f"{src or '?'}->{pdst} names an "
                                "undeclared state",
                            ))
                            continue
                        declared_dsts.add(pdst)
                        if src != pdst and (src, pdst) not in edge_set:
                            findings.append(Finding(
                                "model/transition-unlisted", rel, lineno,
                                f"{spec.name}: site declares "
                                f"{src}->{pdst}, absent from "
                                f"{spec.table_name}",
                            ))
                    if dst is not None and declared_dsts and (
                        dst not in declared_dsts
                    ):
                        findings.append(Finding(
                            "model/transition-unlisted", rel, lineno,
                            f"{spec.name}: site assigns {dst!r} but its "
                            f"pragma only declares -> "
                            f"{sorted(declared_dsts)}",
                        ))
                    continue
                src = _inferred_source(site, parents, table.states)
                if src is not None and dst is not None:
                    if src != dst and (src, dst) not in edge_set:
                        findings.append(Finding(
                            "model/transition-unlisted", rel, lineno,
                            f"{spec.name}: guarded site performs "
                            f"{src}->{dst}, absent from "
                            f"{spec.table_name}",
                        ))
                    continue
                findings.append(Finding(
                    "model/transition-undeclared", rel, lineno,
                    f"{spec.name}: {spec.setter_name} site has no "
                    "'# ggrs-model: transitions(...)' pragma and no "
                    "inferable '== STATE' guard",
                ))
    findings = [
        f for f in findings
        if not is_allowed(f.rule, allows.get(f.path, {}).get(f.line, set()))
    ]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
