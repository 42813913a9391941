"""The plain reference of VectorWar: the GGPO SDK's sample game
(``src/apps/vectorwar/gamestate.cpp``, ``GameState::Update`` with no
disconnected player; constants from ``gamestate.h``, input bits from
``vectorwar.h``), one frame for a batch of sessions.

A frozen rewrite of the game's rules, kept with the benchmark so that no
change to the program moves it.  It imports nothing of the program.  The
state is a dict of tensors, batched over sessions (P ships, S = 30 bullet
slots a ship)::

    pos (B, P, 2)   vel (B, P, 2)   heading, health, cooldown, score (B, P)
    bullet_active (B, P, S)   bullet_pos (B, P, S, 2)   bullet_vel (B, P, S, 2)

Each player's input is one u8: thrust 1, brake 2, rotate left 4, rotate
right 8, fire 16 (bomb, 32, is not read by the rules).  Each frame, for
ship i = 0, 1, ... in order, as ``MoveShip`` does: turn by 3 degrees (right
before left); if the cooldown is 0 and fire is held, the first inactive
slot becomes a bullet 15 px ahead of the ship, at the ship's velocity
(before this frame's thrust) plus 5 px along the heading, and the cooldown
is 8; thrust (or brake) adds 0.06 px along the heading, and a speed above 4
px is scaled back to 4; the ship moves, and bounces off a wall of the
bounds (the velocity's axis negated, then twice it added); each active
bullet of ship i moves, leaves the bounds (inactive) or hits the first ship
j in ship order within 15 px (ship i's score + 1, ship j's health - 10,
inactive); ships j < i and i itself have moved this frame, ships j > i not
yet.  Then the cooldown counts down by 1.

The playfield is assumed to be the 640 x 480 client area that
``main.cpp`` asks for: ``Init`` insets it by 8 px (w 624, h 464, radius
h / 4 = 116), places ship i at (w/2 + r cos t, h/2 + r sin t) with
t = i 360 / P degrees, heading (t + 180) mod 360 and health 100, and
insets it by 8 px again: the bounds are [16, 624] x [16, 464].

Departures from ``gamestate.cpp``, each one forced by exact integers:

- positions and velocities are 16.16 fixed point in place of ``double``
  (the thrust 0.06 is int(0.06 * 2^16) = 3932, and thrust times a sine is
  shifted right by 16, rounding down);
- sine and cosine come from a 360-entry table, round(sin(d pi / 180) 2^16),
  cos d = sin(d + 90), in place of ``::cos`` / ``::sin``;
- the speed is the exact integer square root of vx^2 + vy^2 (in int64),
  and the scaled velocity is vx * 4 / speed in one integer division that
  truncates toward zero;
- a bullet hits where the squared distance is below 15^2, compared in
  int64, in place of ``sqrt``;
- the ships' radius (always 15) is not part of the state;
- ``_framenumber`` is the session's frame counter, which the replay holds.

``advance`` computes in ``dtype``: int64 is exact and is the reference;
float32 is the control, the same rules carried in the nearest precision
below the configuration's 32-bit integers (a 24-bit significand; positions
reach 2^25.3).  With an integer ``dtype`` the bullets' words are int32: a
bullet is born at a ship's nose and dies once it leaves the bounds, so every
word of it stays below 2^26 in magnitude; the ships' words, which the speed
limit and the bounce compute, and every bullet's distance to a ship stay in
``dtype``.  The bounds and the ships are tested for the live bullets alone,
found by ``nonzero`` in the integer reference (it runs eagerly); the float
control, which runs inside the program's CUDA graphs where a count cannot
be read back, visits every bullet and masks the dead ones.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch

from . import shr

FP = 16
ONE = 1 << FP
SLOTS = 30  # MAX_BULLETS
DEGREES = 360
ROTATE = 3  # degrees a frame
RADIUS = 15  # SHIP_RADIUS, px
THRUST = int(0.06 * ONE)  # SHIP_THRUST
MAX_THRUST = 4 * ONE  # SHIP_MAX_THRUST
BULLET_SPEED = 5
COOLDOWN = 8
DAMAGE = 10
HEALTH = 100
WIDTH, HEIGHT = 640 - 16, 480 - 16  # the client area, inset once by 8 px a side
LO = (16, 16)  # the bounds: inset twice
HI = (624, 464)
SINE_TABLE = tuple(round(math.sin(d * math.pi / 180) * ONE) for d in range(DEGREES))
THRUST_BIT, BRAKE_BIT, LEFT_BIT, RIGHT_BIT, FIRE_BIT = 1, 2, 4, 8, 16

State = Dict[str, torch.Tensor]


def players(config: dict) -> int:
    return int(config["players"])


def init_state(config: dict) -> State:
    """One session's start, int64 on the CPU (``GameState::Init``)."""
    p = players(config)
    table = torch.tensor(SINE_TABLE, dtype=torch.int64)
    t = torch.arange(p, dtype=torch.int64) * DEGREES // p
    r = HEIGHT // 4
    pos = torch.stack([(WIDTH // 2) * ONE + r * table[(t + 90) % DEGREES],
                       (HEIGHT // 2) * ONE + r * table[t]], dim=1)
    zeros = torch.zeros(p, dtype=torch.int64)
    return {
        "bullet_active": torch.zeros((p, SLOTS), dtype=torch.int64),
        "bullet_pos": torch.zeros((p, SLOTS, 2), dtype=torch.int64),
        "bullet_vel": torch.zeros((p, SLOTS, 2), dtype=torch.int64),
        "cooldown": zeros.clone(),
        "heading": (t + 180) % DEGREES,
        "health": torch.full((p,), HEALTH, dtype=torch.int64),
        "pos": pos,
        "score": zeros.clone(),
        "vel": torch.zeros((p, 2), dtype=torch.int64),
    }


@functools.lru_cache(maxsize=16)
def _consts(device: torch.device, dtype: torch.dtype):
    table = torch.tensor(SINE_TABLE, dtype=torch.int64, device=device).to(dtype)
    lo = torch.tensor([c * ONE for c in LO], dtype=torch.int64, device=device).to(dtype)
    hi = torch.tensor([c * ONE for c in HI], dtype=torch.int64, device=device).to(dtype)
    slots = torch.arange(SLOTS, device=device)
    return table, lo, hi, slots


def _isqrt(n: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(n)): exact for int64 (a float64 root, moved by one where it
    rounded across an integer), plain for a float dtype."""
    root = torch.floor(torch.sqrt(n.to(torch.float64) if not n.is_floating_point() else n))
    if n.is_floating_point():
        return root
    root = root.to(torch.int64)
    root = root - (root * root > n).to(torch.int64)
    return root + ((root + 1) * (root + 1) <= n).to(torch.int64)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """The index of the first True along the last axis (0 where none is)."""
    return mask.to(torch.uint8).argmax(dim=-1)


def _visited(live: torch.Tensor, exact: bool) -> torch.Tensor:
    """The flat indices of the bullets the bounds and the ships are tested
    for: the live ones where ``exact`` (an integer state), else every one."""
    if exact:
        return live.reshape(-1).nonzero().squeeze(1)
    return torch.arange(live.numel(), device=live.device)


def advance(state: State, inputs: torch.Tensor, config: dict,
            dtype: torch.dtype = torch.int64) -> State:
    """One frame for B sessions; ``state`` leaves in ``dtype`` (the bullets'
    may be int32 already), ``inputs`` (B, P) u8.  Returns new tensors: the
    ships' leaves in ``dtype``, the bullets' in int32 for an integer
    ``dtype`` (the module docstring).

    ``MoveShip`` moves ship i from ship i's own state and input alone, so
    every ship's move is computed at once; what the order within a frame
    decides is which ships a bullet meets, so ship i's bullets are tested
    against ship j where it moved to for j <= i and where it was for j > i,
    and the first ship in order that it comes within 15 px of takes the
    hit."""
    table, lo, hi, slots = _consts(inputs.device, dtype)
    lane = dtype if dtype.is_floating_point else torch.int32  # the bullets' words
    p = players(config)
    bits = inputs.to(torch.int64)
    radius = RADIUS * ONE
    pos, vel = state["pos"], state["vel"]
    active = state["bullet_active"].to(lane)
    bpos, bvel = state["bullet_pos"].to(lane), state["bullet_vel"].to(lane)
    # ParseShipInputs
    h = state["heading"]
    h = torch.where((bits & RIGHT_BIT) != 0, (h + ROTATE) % DEGREES,
                    torch.where((bits & LEFT_BIT) != 0, (h - ROTATE + DEGREES) % DEGREES, h))
    thrust = torch.where((bits & THRUST_BIT) != 0, THRUST,
                         torch.where((bits & BRAKE_BIT) != 0, -THRUST, 0)).to(dtype)
    fire = (bits & FIRE_BIT) != 0
    idx = h.to(torch.int64)
    direction = torch.stack([table[(idx + 90) % DEGREES], table[idx]], dim=-1)  # (B, P, 2)
    # MoveShip: fire into the first inactive slot
    free = active == 0  # (B, P, S)
    first = _first(free).unsqueeze(-1)  # (B, P, 1)
    shoot = (state["cooldown"] == 0) & fire & free.gather(-1, first).squeeze(-1)
    new = ((slots == first) & shoot.unsqueeze(-1)).unsqueeze(-1)  # (B, P, S, 1)
    spawn_vel = (vel + BULLET_SPEED * direction).to(lane).unsqueeze(-2)
    spawn_pos = (pos + RADIUS * direction).to(lane).unsqueeze(-2)
    cooldown = torch.where(shoot, COOLDOWN, state["cooldown"]).to(dtype)
    # thrust, and the speed limit
    v = vel + shr(thrust.unsqueeze(-1) * direction, FP)
    speed = _isqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
    limit = (thrust != 0) & (speed > MAX_THRUST)
    scaled = torch.div(v * MAX_THRUST, torch.clamp(speed, min=1).unsqueeze(-1),
                       rounding_mode="trunc")
    v = torch.where(limit.unsqueeze(-1), scaled, v)
    # move, and bounce off the bounds
    x = pos + v
    wall = (x - radius < lo) | (x + radius > hi)  # (B, P, 2): an axis each
    v = torch.where(wall, -v, v)
    x = torch.where(wall, x + 2 * v, x)
    # the bullets: the new one and every live one move
    moved = torch.addcmul(bpos, (~free).unsqueeze(-1), bvel)
    bpos = torch.where(new, spawn_pos + spawn_vel, moved)
    bvel = torch.where(new, spawn_vel, bvel)
    live = ~free | new.squeeze(-1)  # (B, P, S): shooter, slot
    # each leaves the bounds, or hits the first ship j in order within
    # 15 px: ship j as shooter i's bullets find it, moved if j <= i
    order = torch.arange(p, device=inputs.device)
    seen = torch.where((order.unsqueeze(1) >= order).unsqueeze(-1), x.unsqueeze(1),
                       pos.unsqueeze(1))  # (B, I, J, 2)
    at = _visited(live, not dtype.is_floating_point)
    owner = at // SLOTS  # session * P + shooter
    b = bpos.reshape(-1, 2).index_select(0, at).to(dtype)  # (N, 2)
    bx, by = b[:, 0], b[:, 1]
    inside = live.reshape(-1).index_select(0, at) & (bx >= lo[0]) & (bx <= hi[0]) \
        & (by >= lo[1]) & (by <= hi[1])
    target = torch.full_like(owner, p)  # the first ship within 15 px in order (p: none)
    for j in reversed(range(p)):
        dx = seen[:, :, j, 0].reshape(-1).index_select(0, owner) - bx
        dy = seen[:, :, j, 1].reshape(-1).index_select(0, owner) - by
        target = torch.where(dx * dx + dy * dy < radius * radius, j, target)
    hit = inside & (target < p)
    hits = hit.to(dtype)
    victim = owner // p * p + target.clamp(max=p - 1)  # session * P + the ship hit
    active = torch.zeros(live.numel(), dtype=lane, device=inputs.device)
    active = active.index_put((at,), (inside & ~hit).to(lane)).view(live.shape)
    score, health = state["score"], state["health"]
    score = score.reshape(-1).index_add(0, owner, hits).view(score.shape)
    health = health.reshape(-1).index_add(0, victim, -DAMAGE * hits).view(health.shape)
    return {
        "bullet_active": active,  # live, inside and no hit
        "bullet_pos": bpos,
        "bullet_vel": bvel,
        "cooldown": torch.where(cooldown > 0, cooldown - 1, cooldown),
        "heading": h,
        "health": health,
        "pos": x,
        "score": score,
        "vel": v,
    }
