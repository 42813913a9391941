"""Bytes of the state digest: every row's state read once and 16 B of
digest (4 u32 lanes) written once a row.  About a dozen integer operations
a 4-byte word put the digest far on the bytes side of the roofline.

A steady replay tick digests B live states and B * d resimulated ones."""

from __future__ import annotations

OUT_BYTES_PER_ROW = 16


def digest_bytes(rows: int, state_bytes: int) -> int:
    return rows * (state_bytes + OUT_BYTES_PER_ROW)


def rows_per_tick(sessions: int, check_distance: int) -> int:
    return sessions * (check_distance + 1)
