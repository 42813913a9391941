"""Bytes of one BoxGame advance: each session's state read once and written
once, and its inputs read once.  A player holds 5 int32 words of state
(position 2, velocity 2, heading 1) and one u8 of input."""

from __future__ import annotations

STATE_WORDS_PER_PLAYER = 5


def state_bytes(config: dict) -> int:
    return 4 * STATE_WORDS_PER_PLAYER * int(config["players"])


def input_bytes(config: dict) -> int:
    return int(config["players"])


def advance_bytes(config: dict, sessions: int) -> int:
    return sessions * (2 * state_bytes(config) + input_bytes(config))
