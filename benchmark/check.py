"""The comparison that decides ``correct``.

After the window, the program's carry is held against ``reference.replay``'s
expected carry, session by session, exactly (the game and the digest are
integer arithmetic).  Each number compared counts the sessions that differ,
and every limit is 0:

- ``live_rows_off``: the live state or the frame counter differs (the game
  advance);
- ``ring_rows_off``: a saved ring slot differs in its state, digest or
  frame number, or the input ring differs (the ring and the digest kernel);
- ``digest_rows_off``: the first-seen digest history differs, or the
  mismatch count is not 0, or a first bad frame is named (the digests the
  replay tick's compare reads, and its verdict).

The control (the reference in float32 in the program's place) makes every
session differ in all three; a float step is as repeatable as an integer
one, so the control alone never trips the compare's counters, and they are
read inside ``digest_rows_off``, which the control separates.  The readings
that set the limits are in PERF.md.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

MASK = 0xFFFFFFFF
LIMITS = {"live_rows_off": 0, "ring_rows_off": 0, "digest_rows_off": 0}


def _rows_off(got, want) -> torch.Tensor:
    """(B,) bool: the session's rows differ anywhere (dicts leaf by leaf)."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise ValueError(f"carry keys {sorted(got)} differ from {sorted(want)}")
        off = None
        for k in want:
            o = _rows_off(got[k], want[k])
            off = o if off is None else off | o
        return off
    b = want.shape[0]
    if tuple(got.shape) != tuple(want.shape):
        return torch.ones(b, dtype=torch.bool)
    return (got.to(torch.int64) != want).reshape(b, -1).any(dim=1)


def _digests(x: torch.Tensor) -> torch.Tensor:
    """The program's digests (u32 bit patterns in int32) as values in [0, 2^32)."""
    return x.to(torch.int64) & MASK


def compare(got: Dict, want: Dict) -> Dict[str, int]:
    ring = got["ring"]
    live = _rows_off(got["live"], want["live"]) | _rows_off(got["frame"], want["frame"])
    saved = (_rows_off(ring["states"], want["ring"]["states"])
             | _rows_off(_digests(ring["checksums"]), want["ring"]["checksums"])
             | _rows_off(ring["frames"], want["ring"]["frames"])
             | _rows_off(got["inputs"], want["inputs"]))
    digests = (_rows_off(_digests(got["hist"]), want["hist"])
               | _rows_off(got["mismatches"], want["mismatches"])
               | _rows_off(got["first_bad"], want["first_bad"]))
    return {"live_rows_off": int(live.sum()), "ring_rows_off": int(saved.sum()),
            "digest_rows_off": int(digests.sum())}


def verdict(values: Dict[str, int]) -> Tuple[bool, Dict[str, Dict[str, int]], List[str]]:
    """``(correct, {name: {value, limit}}, lines)``: each number beside its
    limit, for the result line and for the last lines of standard error."""
    table = {k: {"value": values[k], "limit": LIMITS[k]} for k in LIMITS}
    ok = all(v["value"] <= v["limit"] for v in table.values())
    lines = [f"check {k} {v['value']} limit {v['limit']}" for k, v in table.items()]
    lines.append(f"check correct {str(ok).lower()}")
    return ok, table, lines
