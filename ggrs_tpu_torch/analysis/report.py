"""Shared finding record for the ggrs-verify pillars.

One flat, hashable shape for everything the layout checker, the
determinism lint, and the ownership lint emit, so the CLI and the
baseline machinery treat all three uniformly.  The baseline key
deliberately omits the line number: legacy findings must not churn when
unrelated edits shift a file.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Sequence, Set

# the package every path table of the plane is rooted at: the checkers take
# a ``pkg`` (or a table built from one), so the same code judges the JAX
# package's tree when handed "ggrs_tpu"
PKG = "ggrs_tpu_torch"

# reviewed in-place exception: `# ggrs-verify: allow(rule[, rule])` on
# the offending line.  Shared by the determinism and ownership lints;
# the layout checker has no pragma escape (ABI skew IS the bug).
_ALLOW_RE = re.compile(r"ggrs-verify:\s*allow\(([^)]*)\)")


def allow_pragmas(source_lines: Sequence[str]) -> Dict[int, Set[str]]:
    """``{lineno: {rule, ...}}`` for every allow pragma in the file."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source_lines, start=1):
        m = _ALLOW_RE.search(line)
        if m:
            out[i] = {
                r.strip() for r in m.group(1).split(",") if r.strip()
            }
    return out


def is_allowed(rule: str, allowed: Set[str]) -> bool:
    """A pragma may name the full rule id or its short name after the
    family prefix (``det/hash-order`` or ``hash-order``)."""
    return rule in allowed or rule.split("/", 1)[-1] in allowed


class Finding(NamedTuple):
    rule: str       # e.g. "layout/mirror", "det/wall-clock", "own/undeclared"
    path: str       # repo-relative source path
    line: int       # 1-based; 0 when the finding is file-scoped
    detail: str     # human-readable one-liner

    def key(self) -> str:
        """Line-independent identity used by the baseline: a finding
        survives unrelated edits to its file, and N identical findings
        in one file are absorbed by the baseline entry's occurrence
        count (see baseline.Baseline.split)."""
        return f"{self.rule}::{self.path}::{self.detail}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.detail}"
