"""Committed-baseline handling for ggrs-verify.

The determinism lint (and any future rule set) runs against a baseline
file checked into the tree: findings present in the baseline are
``legacy`` — reported but non-fatal — while anything new fails the run.
``scripts/port_verify.py --baseline-update`` rewrites the file from the
current tree, the reviewed way to bless or burn down entries.

Format (version 2): JSON, grouped and counted PER FILE::

    {"version": 2,
     "files": {"ggrs_tpu_torch/broadcast/journal.py":
                   [{"rule": "det/wall-clock",
                     "detail": "time.perf_counter() ...",
                     "count": 2}]}}

Entries are line-number free (see report.Finding.key) so the baseline
survives unrelated edits, and counted so *additional* occurrences of an
already-baselined finding still fail.  The per-file grouping is load-
bearing, not cosmetic: a version-1 baseline was a flat key list whose
total could stay constant while a violation MOVED between files — a
new wall-clock read in file A could hide behind a burned-down one in
file B.  Version 2 makes the diff of a moved violation visible (one
file's count drops, another's entry appears) and ``split`` budgets per
(rule, file, detail), never across files.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from .report import Finding

BASELINE_VERSION = 2


class Baseline:
    """An allowance multiset over finding keys
    (``rule::path::detail``)."""

    def __init__(self, counts: Dict[str, int] | None = None) -> None:
        self.counts: Dict[str, int] = dict(counts or {})

    def split(
        self, findings: Iterable[Finding]
    ) -> Tuple[List[Finding], List[Finding]]:
        """Partition into ``(new, legacy)``.  Each baseline entry absorbs
        up to ``count`` occurrences of its key; the rest are new."""
        budget = Counter(self.counts)
        new: List[Finding] = []
        legacy: List[Finding] = []
        for f in findings:
            k = f.key()
            if budget.get(k, 0) > 0:
                budget[k] -= 1
                legacy.append(f)
            else:
                new.append(f)
        return new, legacy

    @staticmethod
    def from_findings(findings: Iterable[Finding]) -> "Baseline":
        return Baseline(Counter(f.key() for f in findings))


def load_baseline(path: Path) -> Baseline:
    """Missing file == empty baseline: a fresh checkout (or a rule set
    with nothing legacy) needs no committed file to run strict."""
    if not Path(path).exists():
        return Baseline()
    data = json.loads(Path(path).read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}, "
            f"this tool reads {BASELINE_VERSION} — regenerate it with "
            "scripts/port_verify.py --baseline-update"
        )
    counts: Dict[str, int] = {}
    for file_path, entries in data.get("files", {}).items():
        for e in entries:
            key = f"{e['rule']}::{file_path}::{e['detail']}"
            counts[key] = counts.get(key, 0) + int(e["count"])
    return Baseline(counts)


def write_baseline(path: Path, baseline: Baseline) -> None:
    files: Dict[str, List[dict]] = {}
    for key, n in sorted(baseline.counts.items()):
        if n <= 0:
            continue
        rule, file_path, detail = key.split("::", 2)
        files.setdefault(file_path, []).append(
            {"rule": rule, "detail": detail, "count": n}
        )
    Path(path).write_text(
        json.dumps(
            {"version": BASELINE_VERSION,
             "files": {k: files[k] for k in sorted(files)}},
            indent=2,
        )
        + "\n"
    )
