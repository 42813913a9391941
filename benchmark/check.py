"""The comparison that decides ``correct``.

After the window, the cell's entry (``entries/<entry>.py``) holds what the
program produced against its plain reference and returns named counts, each
with a limit of its own (``Entry.limits``); ``verdict`` holds each count to
its limit.  The counts and the readings that set each limit are in PERF.md.

``rows_off`` and ``digests`` are the row-by-row comparisons the entries
share: a session's rows differ anywhere, and the program's u32 digests as
values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

MASK = 0xFFFFFFFF


def rows_off(got, want) -> torch.Tensor:
    """(B,) bool on ``want``'s device: the session's rows differ anywhere
    (dicts leaf by leaf)."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise ValueError(f"carry keys {sorted(got)} differ from {sorted(want)}")
        off = None
        for k in want:
            o = rows_off(got[k], want[k])
            off = o if off is None else off | o
        return off
    b = want.shape[0]
    if tuple(got.shape) != tuple(want.shape):
        return torch.ones(b, dtype=torch.bool, device=want.device)
    return (got.to(torch.int64) != want).reshape(b, -1).any(dim=1)


def digests(x: torch.Tensor) -> torch.Tensor:
    """The program's digests (u32 bit patterns in int32) as values in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def verdict(values: Dict[str, int], limits: Dict[str, int]
            ) -> Tuple[bool, Dict[str, Dict[str, int]], List[str]]:
    """``(correct, {name: {value, limit}}, lines)``: each of the entry's
    counts beside its limit, for the result line and for the last lines of
    standard error."""
    if sorted(values) != sorted(limits):
        raise ValueError(f"the check counts {sorted(values)}, its limits name {sorted(limits)}")
    table = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    lines = [f"check {k} {v['value']} limit {v['limit']}" for k, v in table.items()]
    lines.append(f"check correct {str(ok).lower()}")
    return ok, table, lines
