"""Static extraction of integer constants from the native C++ sources.

The native fast paths declare their wire/ABI contract as ``constexpr``
ints and plain enums (``csrc/host/wire_common.h``, ``session_bank.cpp``,
``net_batch.cpp``, ...).  This parser recovers a ``{name: value}`` map
from the *source text* — no compiler, no loaded library — which is what
lets the layout checker run on a tree with no toolchain and still fail
on drift before anything is built.

Scope is deliberately the subset of C++ the native sources actually
use for layout constants:

- ``constexpr <int-type> kName = <expr>;`` where ``<expr>`` is an
  integer literal (decimal/hex, with or without a ``u``/``U``/``ul``/
  ``ull`` suffix: ``csrc/digest.cu``'s primes), a brace-initialized cast
  (``size_t{1}``), unary ``-``/``~``, shifts, and or/and of the same;
- ``enum [class] [Name] [: type] { A = <expr>, B, C = <expr>, ... };``
  with C's implicit previous+1 rule for bare enumerators.

Anything else (constexpr arrays, string constants, templated values) is
skipped silently — it is not part of the mirrored-constant contract.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional

# brace-initialized integer casts: size_t{1}, uint64_t{0}, int64_t{1}...
_BRACE_CAST = re.compile(
    r"\b(u?int(?:8|16|32|64)?_t|size_t|unsigned|int|long)\s*\{\s*"
    r"(-?\s*(?:0[xX][0-9a-fA-F]+|\d+))\s*\}"
)
_STATIC_CAST = re.compile(r"static_cast<[^>]+>")
# integer-literal suffixes (40503u, 1ull, 0xFFUL, 7LL): the value is the
# literal's, the suffix only picks its type
_INT_SUFFIX = re.compile(
    r"\b(0[xX][0-9a-fA-F]+|\d+)(?:[uU](?:ll|LL|l|L)?|(?:ll|LL|l|L)[uU]?)\b"
)
# after sanitizing, only arithmetic on integer literals may remain
_SAFE_EXPR = re.compile(r"^[\d\s()xXa-fA-F+\-*<>|&~^{}]*$")

_CONSTEXPR = re.compile(
    r"^\s*(?:static\s+)?constexpr\s+[\w:<>\s]+?\b(k\w+)\s*=\s*([^;]+);",
    re.MULTILINE,
)
_ENUM_BLOCK = re.compile(
    r"\benum\b(?:\s+class)?\s*\w*\s*(?::\s*[\w:]+)?\s*\{([^{}]*)\}",
    re.DOTALL,
)


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.DOTALL)
    return re.sub(r"//[^\n]*", " ", text)


_UNSIGNED_BITS = {
    "uint8_t": 8, "uint16_t": 16, "uint32_t": 32, "uint64_t": 64,
    "uint_t": 64, "size_t": 64, "unsigned": 32,
}


def _eval_int(expr: str) -> Optional[int]:
    """Evaluate one constant expression, or None when it is outside the
    supported subset.  ``~`` on an unsigned brace-cast follows C
    semantics — it wraps to the complement AT THE CAST'S WIDTH
    (``~uint32_t{0}`` is 0xFFFFFFFF, not 2^64-1), where Python's
    infinite-width ``~0`` would yield ``-1``."""
    expr = expr.strip()
    unsigned_types = re.findall(
        r"\bu(?:int(?:8|16|32|64)?_t|nsigned)\b|\bsize_t\b", expr
    )
    expr = _INT_SUFFIX.sub(r"\1", expr)
    expr = _STATIC_CAST.sub("", expr)
    expr = _BRACE_CAST.sub(lambda m: f"({m.group(2)})", expr)
    if not _SAFE_EXPR.match(expr) or "{" in expr or "}" in expr:
        return None
    if not expr:
        return None
    try:
        value = eval(expr, {"__builtins__": {}}, {})  # noqa: S307
    except Exception:
        return None
    if not isinstance(value, int):
        return None
    if value < 0 and unsigned_types and "~" in expr:
        bits = max(_UNSIGNED_BITS.get(t, 64) for t in unsigned_types)
        value &= (1 << bits) - 1
    return value


def parse_cpp_constants(source: str | Path) -> Dict[str, int]:
    """``{name: value}`` for every constexpr int and enumerator in the
    file (or source string).  Later definitions win, matching the one-
    translation-unit layout of the native sources."""
    text = (
        Path(source).read_text()
        if isinstance(source, Path)
        else source
    )
    text = _strip_comments(text)
    out: Dict[str, int] = {}
    for m in _CONSTEXPR.finditer(text):
        value = _eval_int(m.group(2))
        if value is not None:
            out[m.group(1)] = value
    for block in _ENUM_BLOCK.finditer(text):
        next_implicit: Optional[int] = 0
        for entry in block.group(1).split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" in entry:
                name, _, expr = entry.partition("=")
                value = _eval_int(expr)
                if value is None:
                    # the true value is unknown: implicit numbering from
                    # here on would be silently wrong — poison it until
                    # the next evaluable explicit entry resets it
                    next_implicit = None
                    continue
            else:
                if next_implicit is None:
                    continue  # follows an unevaluable entry: skip
                name, value = entry, next_implicit
            name = name.strip()
            if not re.fullmatch(r"\w+", name):
                continue
            out[name] = value
            next_implicit = value + 1
    return out
