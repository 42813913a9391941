"""Bytes of one VectorWar advance: each session's state read once and written
once, and its inputs read once.  A ship holds 8 int32 words of its own
(position 2, velocity 2, heading, health, cooldown, score) and 30 bullet
slots of 5 (active, position 2, velocity 2): 158 words, 632 B; a player's
input is one u8."""

from __future__ import annotations

SLOTS = 30
SHIP_WORDS = 8
SLOT_WORDS = 5


def state_bytes(config: dict) -> int:
    return 4 * (SHIP_WORDS + SLOTS * SLOT_WORDS) * int(config["players"])


def input_bytes(config: dict) -> int:
    return int(config["players"])


def advance_bytes(config: dict, sessions: int) -> int:
    return sessions * (2 * state_bytes(config) + input_bytes(config))
