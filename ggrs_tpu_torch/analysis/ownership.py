"""Static thread-ownership lint (pillar 3 of ggrs-verify, with the TSan
leg in ``scripts/port_build_sanitized.sh`` as its dynamic sibling).

``utils.ownership.ThreadOwned`` encodes the reference's Send-not-Sync
contract dynamically: driving calls pin the owning thread and raise
``CrossThreadAccess`` from any other.  That guard is only as good as
its coverage, and coverage was previously implicit — whichever methods
happened to call ``_check_owner()``.  This lint makes the contract
declarative and closed:

- ``own/undeclared`` — a class mixing in ``ThreadOwned`` must declare
  ``_DRIVING_METHODS`` (a tuple of method-name strings): the class's
  thread-affinity surface, visible to review.
- ``own/missing-guard`` — every declared driving method must exist and
  call ``self._check_owner()`` in its body.
- ``own/unlisted-guard`` — every method that calls ``_check_owner()``
  must be declared, so the declaration stays authoritative.
- ``own/thread-target`` — a bound driving method must not be handed to
  ``threading.Thread(target=...)`` or ``threading.Timer(delay, fn)`` at
  any call site: driving from a spawned thread without
  ``transfer_ownership()`` is the exact race the guard exists to stop.
  This is a NAME-based heuristic (the lint cannot type the target
  object); a reviewed false positive on an unrelated object is
  suppressed in place with ``# ggrs-verify: allow(own/thread-target)``
  — the same pragma the determinism lint honors, and it works for
  every own/* rule.
- ``own/executor-submit`` — the pool-shaped variant of the same escape:
  ``executor.submit(bound_driving_method, ...)`` drives from a worker
  thread just as surely as ``Thread(target=...)`` does.

Hand-off sites see through one level of bound-method ALIASING: a file
that does ``advance = pool.advance_frame`` and later hands ``advance``
to Thread/Timer/submit fires the same rules.  The alias alone is fine —
the same-thread hot-path alias (e.g. session_pool's
``add = self.host.add_local_input``) is idiomatic and stays clean; only
the cross-thread hand-off is the bug.

The checker is AST-only and resolves inheritance within the scanned
file set (a subclass of a ThreadOwned class is ThreadOwned).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .report import PKG, Finding, allow_pragmas, is_allowed

OWNERSHIP_SCOPE: Tuple[str, ...] = (f"{PKG}/",)
_MIXIN = "ThreadOwned"


def _calls_check_owner(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "_check_owner"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
        ):
            return True
    return False


def _declared_driving(cls: ast.ClassDef) -> Optional[List[str]]:
    for node in cls.body:
        targets: Sequence[ast.expr] = ()
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "_DRIVING_METHODS":
                if isinstance(value, (ast.Tuple, ast.List)) and all(
                    isinstance(e, ast.Constant)
                    and isinstance(e.value, str)
                    for e in value.elts
                ):
                    return [e.value for e in value.elts]
                return []  # declared but not statically readable
    return None


def _base_names(cls: ast.ClassDef) -> List[str]:
    out = []
    for b in cls.bases:
        if isinstance(b, ast.Name):
            out.append(b.id)
        elif isinstance(b, ast.Attribute):
            out.append(b.attr)
    return out


def lint_ownership(
    root: Path, scope: Sequence[str] = OWNERSHIP_SCOPE
) -> List[Finding]:
    root = Path(root)
    files: List[Path] = []
    for prefix in scope:
        target = root / prefix
        files.extend(
            sorted(target.rglob("*.py")) if target.is_dir() else [target]
        )

    # pass 1: classes + which are ThreadOwned (transitively, within scope)
    classes: Dict[str, ast.ClassDef] = {}
    class_file: Dict[str, str] = {}
    trees: List[Tuple[str, ast.Module]] = []
    allows: Dict[str, Dict[int, Set[str]]] = {}
    for path in files:
        rel = path.relative_to(root).as_posix()
        text = path.read_text()
        tree = ast.parse(text)
        trees.append((rel, tree))
        allows[rel] = allow_pragmas(text.splitlines())
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = node
                class_file[node.name] = rel

    owned: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, cls in classes.items():
            if name in owned:
                continue
            for base in _base_names(cls):
                if base == _MIXIN or base in owned:
                    owned.add(name)
                    changed = True
                    break

    # topological order, bases before subclasses: inheritance of
    # _DRIVING_METHODS must resolve from driving_by_class, so a class is
    # processed only after every owned base it names (alphabetical order
    # would make verdicts depend on class NAMES).  Ties break sorted for
    # deterministic output; a cycle (impossible in valid Python) would
    # fall back to name order rather than loop.
    order: List[str] = []
    remaining = set(owned)
    while remaining:
        ready = sorted(
            n for n in remaining
            if not (set(_base_names(classes[n])) & remaining)
        )
        if not ready:
            ready = sorted(remaining)
        order.extend(ready)
        remaining -= set(ready)

    findings: List[Finding] = []
    driving_by_class: Dict[str, Set[str]] = {}
    for name in order:
        cls = classes[name]
        rel = class_file[name]
        declared = _declared_driving(cls)
        methods = {
            n.name: n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        guarded = {
            m for m, fn in methods.items() if _calls_check_owner(fn)
        }
        if declared is None:
            # inherit the parent's declaration when the subclass adds no
            # guards of its own (a pure extension class re-declares
            # nothing); otherwise it must declare
            inherited = set()
            for base in _base_names(cls):
                inherited |= driving_by_class.get(base, set())
            if guarded - inherited:
                findings.append(Finding(
                    "own/undeclared", rel, cls.lineno,
                    f"class {name} mixes in {_MIXIN} but declares no "
                    "_DRIVING_METHODS",
                ))
            driving_by_class[name] = inherited | guarded
            continue
        declared_set = set(declared)
        driving_by_class[name] = declared_set
        for m in declared:
            fn = methods.get(m)
            if fn is None:
                # declared-but-inherited is fine when a base guards it
                if any(
                    m in driving_by_class.get(b, set())
                    for b in _base_names(cls)
                ):
                    continue
                findings.append(Finding(
                    "own/missing-guard", rel, cls.lineno,
                    f"{name}._DRIVING_METHODS lists {m!r} but the "
                    "class defines no such method",
                ))
            elif not _calls_check_owner(fn):
                findings.append(Finding(
                    "own/missing-guard", rel, fn.lineno,
                    f"{name}.{m} is declared driving but never calls "
                    "self._check_owner()",
                ))
        for m in sorted(guarded - declared_set):
            findings.append(Finding(
                "own/unlisted-guard", rel, methods[m].lineno,
                f"{name}.{m} guards with _check_owner() but is not in "
                "_DRIVING_METHODS",
            ))

    # pass 2: a bound driving method handed to another thread at any
    # scanned site — Thread(target=...), Timer(delay, fn),
    # executor.submit(fn, ...) — directly or through one level of
    # file-local aliasing (name = obj.driving_method)
    all_driving = set()
    for names in driving_by_class.values():
        all_driving |= names
    for rel, tree in trees:
        aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr in all_driving
            ):
                aliases[node.targets[0].id] = node.value.attr

        def _handed_driving(expr: Optional[ast.AST]) -> Optional[str]:
            """'….name' when expr is a bound driving method (or a
            file-local alias of one), else None."""
            if isinstance(expr, ast.Attribute) and expr.attr in all_driving:
                return f"….{expr.attr}"
            if isinstance(expr, ast.Name) and expr.id in aliases:
                return f"{expr.id} (= ….{aliases[expr.id]})"
            return None

        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fname = node.func.attr if isinstance(
                node.func, ast.Attribute
            ) else (node.func.id if isinstance(node.func, ast.Name)
                    else None)
            if fname == "Thread":
                for kw in node.keywords:
                    if kw.arg != "target":
                        continue
                    handed = _handed_driving(kw.value)
                    if handed is not None:
                        findings.append(Finding(
                            "own/thread-target", rel, node.lineno,
                            f"Thread(target={handed}) hands a driving "
                            "method to another thread without "
                            "transfer_ownership()",
                        ))
            elif fname == "Timer":
                # threading.Timer(interval, function): positional or kw
                fn_expr = node.args[1] if len(node.args) > 1 else None
                for kw in node.keywords:
                    if kw.arg == "function":
                        fn_expr = kw.value
                handed = _handed_driving(fn_expr)
                if handed is not None:
                    findings.append(Finding(
                        "own/thread-target", rel, node.lineno,
                        f"Timer(…, {handed}) fires a driving method on "
                        "the timer thread without transfer_ownership()",
                    ))
            elif fname == "submit" and isinstance(
                node.func, ast.Attribute
            ):
                handed = _handed_driving(
                    node.args[0] if node.args else None
                )
                if handed is not None:
                    findings.append(Finding(
                        "own/executor-submit", rel, node.lineno,
                        f"….submit({handed}) runs a driving method on "
                        "an executor worker thread without "
                        "transfer_ownership()",
                    ))
    findings = [
        f for f in findings
        if not is_allowed(f.rule, allows.get(f.path, {}).get(f.line, set()))
    ]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
