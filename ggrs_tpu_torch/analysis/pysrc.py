"""Static (AST) extraction from the Python decoder sources.

The layout checker's Python half: module-level integer constants,
tuple-of-string / tuple-of-pairs field tables, and every ``struct``
format string a file packs or unpacks with — including through the
hot-path local aliases the decoders use (``pack = struct.pack``;
``unpack_from = struct.unpack_from``).  Everything is read from the
AST, never by importing the module: the checker must be able to judge a
broken tree, and a broken tree may not import.
"""

from __future__ import annotations

import ast
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence, Tuple, Union

_STRUCT_FNS = {"pack", "pack_into", "unpack", "unpack_from", "calcsize",
               "Struct", "iter_unpack"}


class StructFormat(NamedTuple):
    line: int
    func: str   # struct function name (post-alias: "pack", "unpack_from"…)
    fmt: str


def _module(source: Union[str, Path]) -> ast.Module:
    text = (
        Path(source).read_text() if isinstance(source, Path) else source
    )
    return ast.parse(text)


def _const_int(node: ast.AST) -> Union[int, None]:
    """Fold the constant-int subset used by the decoder modules:
    literals, unary +/-/~, binary shifts/or/and/add/sub/mul on the
    same."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp):
        v = _const_int(node.operand)
        if v is None:
            return None
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return v
        if isinstance(node.op, ast.Invert):
            return ~v
        return None
    if isinstance(node, ast.BinOp):
        left, right = _const_int(node.left), _const_int(node.right)
        if left is None or right is None:
            return None
        ops = {
            ast.LShift: lambda a, b: a << b,
            ast.RShift: lambda a, b: a >> b,
            ast.BitOr: lambda a, b: a | b,
            ast.BitAnd: lambda a, b: a & b,
            ast.BitXor: lambda a, b: a ^ b,
            ast.Add: lambda a, b: a + b,
            ast.Sub: lambda a, b: a - b,
            ast.Mult: lambda a, b: a * b,
        }
        fn = ops.get(type(node.op))
        return fn(left, right) if fn else None
    return None


def parse_py_constants(source: Union[str, Path]) -> Dict[str, int]:
    """Module-level ``NAME = <int expr>`` assignments (constant-foldable
    only), the Python halves of the mirrored-constant pairs."""
    out: Dict[str, int] = {}
    for node in _module(source).body:
        targets: Sequence[ast.expr] = ()
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        folded = _const_int(value)
        if folded is None:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out[t.id] = folded
    return out


def parse_py_field_tuples(
    source: Union[str, Path],
) -> Dict[str, List[Tuple]]:
    """Module-level tuples/lists of strings or of ``(str, str)`` pairs —
    the dtype field tables (``BANK_HDR_FIELDS``) and stat-field name
    tuples the layout contract sizes against."""
    out: Dict[str, List[Tuple]] = {}
    for node in _module(source).body:
        if not isinstance(node, ast.Assign):
            continue
        if not isinstance(node.value, (ast.Tuple, ast.List)):
            continue
        rows: List[Tuple] = []
        ok = True
        for elt in node.value.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                rows.append((elt.value,))
            elif isinstance(elt, ast.Constant) and isinstance(
                elt.value, int
            ):
                rows.append((elt.value,))
            elif isinstance(elt, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) for e in elt.elts
            ):
                rows.append(tuple(e.value for e in elt.elts))
            else:
                ok = False
                break
        if not ok or not rows:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out[t.id] = rows
    return out


def parse_py_struct_formats(
    source: Union[str, Path],
) -> List[StructFormat]:
    """Every ``struct`` call with a literal format string, resolved
    through one level of aliasing (``pack = struct.pack`` and
    ``from struct import unpack_from`` both count).  A format given as
    a module-level string constant (``struct.pack(VARREC_HEADER_FMT,
    n)`` with ``VARREC_HEADER_FMT = "<H"``) resolves to its literal,
    as the named constant is the same contract.  f-string formats
    (the timing tail's ``f"<{n}Q"``) are out of static reach and
    skipped — the contract table pins their fixed-width parts via the
    surrounding constants instead."""
    tree = _module(source)
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Attribute
        ):
            v = node.value
            if (
                isinstance(v.value, ast.Name)
                and v.value.id == "struct"
                and v.attr in _STRUCT_FNS
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        aliases[t.id] = v.attr
        elif isinstance(node, ast.ImportFrom) and node.module == "struct":
            for a in node.names:
                if a.name in _STRUCT_FNS:
                    aliases[a.asname or a.name] = a.name

    # module-level NAME = "literal", bound nowhere else in the module (a
    # second binding makes the name's value no longer static)
    bindings: Counter = Counter(
        t.id
        for node in ast.walk(tree)
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign))
        for t in (node.targets if isinstance(node, ast.Assign)
                  else [node.target])
        if isinstance(t, ast.Name)
    )
    str_consts: Dict[str, str] = {
        node.targets[0].id: node.value.value
        for node in tree.body
        if isinstance(node, ast.Assign)
        and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
        and isinstance(node.value, ast.Constant)
        and isinstance(node.value.value, str)
        and bindings[node.targets[0].id] == 1
    }

    out: List[StructFormat] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        func = None
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _STRUCT_FNS:
            # struct.pack(...) or some_struct_obj.unpack_from(...)
            if isinstance(f.value, ast.Name) and f.value.id == "struct":
                func = f.attr
        elif isinstance(f, ast.Name) and f.id in aliases:
            func = aliases[f.id]
        if func is None:
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            out.append(StructFormat(node.lineno, func, first.value))
        elif isinstance(first, ast.Name) and first.id in str_consts:
            out.append(StructFormat(node.lineno, func, str_consts[first.id]))
    return out
