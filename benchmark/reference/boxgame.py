"""The plain reference of BoxGame: GGRS ``examples/ex_game``'s ships in
16.16 fixed point, one step for a batch of sessions.

A frozen rewrite of the game's rules, kept with the benchmark so that no
change to the program moves it.  It imports nothing of the program.  The
state is a dict of tensors, batched over sessions::

    pos (B, P, 2)   vel (B, P, 2)   rot (B, P)

Each player's input is one u8 bitmask (up 1, down 2, left 4, right 8).  A
frame turns the ship by 3 steps of a 256-step sine table, thrusts along its
heading by 0.12 px, clamps each velocity axis to 6 px, keeps 252/256 of the
velocity ("ice") and wraps the position on an 800 x 600 playfield.

``advance`` computes in ``dtype``: int64 is exact and is the reference;
float32 is the control, the same rules carried in the nearest precision
below the configuration's 32-bit integers (a 24-bit significand).
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch

from . import shr

FP = 16
ONE = 1 << FP
WINDOW = (800 * ONE, 600 * ONE)
ACCEL = int(0.12 * ONE)
MAX_SPEED = 6 * ONE
FRICTION_NUM = 252
ROT_STEP = 3
ROT_PERIOD = 256
SINE_TABLE = tuple(round(math.sin(2.0 * math.pi * i / ROT_PERIOD) * ONE) for i in range(ROT_PERIOD))

State = Dict[str, torch.Tensor]


def players(config: dict) -> int:
    return int(config["players"])


def init_state(config: dict) -> State:
    """One session's start, int64 on the CPU: ships on a circle of 150 px
    around the playfield's center, facing outward, at rest."""
    p = players(config)
    table = torch.tensor(SINE_TABLE, dtype=torch.int64)
    angles = (torch.arange(p, dtype=torch.int64) * (ROT_PERIOD // p)) % ROT_PERIOD
    r = 150 * ONE
    cos = table[(angles + ROT_PERIOD // 4) % ROT_PERIOD]
    sin = table[angles]
    pos = torch.stack([WINDOW[0] // 2 + ((r * cos) >> FP), WINDOW[1] // 2 + ((r * sin) >> FP)], dim=1)
    return {"pos": pos, "rot": angles, "vel": torch.zeros((p, 2), dtype=torch.int64)}


def _decode(bits: int):
    """(turn, thrust) of a bitmask: right - left, up - down."""
    up, down, left, right = ((bits >> b) & 1 for b in range(4))
    return right - left, up - down


@functools.lru_cache(maxsize=16)
def _consts(device: torch.device, dtype: torch.dtype):
    table = torch.tensor(SINE_TABLE, dtype=torch.int64, device=device).to(dtype)
    window = torch.tensor(WINDOW, dtype=torch.int64, device=device).to(dtype)
    # (turn, thrust) of each of the 256 u8 inputs
    buttons = torch.tensor([_decode(i) for i in range(256)], dtype=torch.int64,
                           device=device).to(dtype)
    return table, window, buttons


def advance(state: State, inputs: torch.Tensor, config: dict,
            dtype: torch.dtype = torch.int64) -> State:
    """One frame for B sessions; ``state`` leaves in ``dtype``, ``inputs``
    (B, P) u8.  Returns new tensors."""
    table, window, buttons = _consts(inputs.device, dtype)
    decoded = buttons[inputs.to(torch.int64)]  # (B, P, 2)
    turn, thrust = decoded[..., 0], decoded[..., 1]
    rot = torch.remainder(state["rot"] + turn * ROT_STEP, ROT_PERIOD)
    idx = rot.to(torch.int64)
    cos = table[(idx + ROT_PERIOD // 4) % ROT_PERIOD]
    sin = table[idx]
    acc = torch.stack([thrust * shr(ACCEL * cos, FP), thrust * shr(ACCEL * sin, FP)], dim=-1)
    vel = torch.clamp(state["vel"] + acc, -MAX_SPEED, MAX_SPEED)
    vel = shr(vel * FRICTION_NUM, 8)
    pos = torch.remainder(state["pos"] + vel, window)
    return {"pos": pos, "rot": rot, "vel": vel}
