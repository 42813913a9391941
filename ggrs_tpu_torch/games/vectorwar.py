"""VectorWar: the GGPO SDK's sample game (``src/apps/vectorwar`` of
``github.com/pond3r/ggpo``), as a batch-native game of the port.

Four ships, each with 30 bullet slots, on a 640 x 480 playfield.  Each frame
the ships move in order: ship i turns, fires into its first free slot, thrusts
(a speed above 4 px is scaled back), moves and bounces off the walls; then
each of its live bullets moves, leaves the bounds or hits the first ship
within 15 px in ship order (ship i scores, the ship hit loses 10 health), and
ship i's cooldown counts down.  Ships j < i, and i itself, have moved when
ship i's bullets are tested; ships j > i have not.  The rules are GGPO's
``GameState::Update`` carried in exact integers: 16.16 fixed point, a
360-entry sine table, an exact integer square root for the speed, one
truncating division for its scaling, and the hit test on squared distances
in int64.  ``benchmark/reference/vectorwar.py`` is the plain reference and
lists each departure from ``gamestate.cpp``.

State is a dict of int32 tensors batched over sessions (4 ships, 30 slots)::

    bullet_active (B, 4, 30)   bullet_pos (B, 4, 30, 2)   bullet_vel (B, 4, 30, 2)
    cooldown, heading, health, score (B, 4)   pos (B, 4, 2)   vel (B, 4, 2)

632 words (2,528 B) a session.  Inputs are one u8 a player, ``(B, 4)``:
thrust 1, brake 2, rotate left 4, rotate right 8, fire 16.

On the card the step is one launch of a hand-written CUDA kernel a frame
(``csrc/vectorwar.cu``, a warp a session), which reads each leaf in place at
its own session stride and writes the new state once.  The route, ``out``
and the counts are ``games/_card.py``'s: a call with a tensor on a CUDA card
takes the kernel, or raises where the kernel cannot read it (leaves not
int32, inputs not of an integer dtype, tensors on several devices; shapes
other than the ones above of the same sessions; pair rows not 8-byte
aligned); a leaf that is not evenly strided rows of contiguous inner
dimensions is copied contiguous first.  CPU tensors take the eager body.
Both compute the same integers on every state whose positions and
velocities lie within +-2^29 (every frame stays far inside; an int32 sum
wraps on both routes).  The process registry's ``ggrs_game_advance_total``
counts both routes under ``game="vectorwar"``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..convert import from_numpy
from ..core.device import DeviceLike
from ._card import Kernel, check_call, read_in_place

INPUT_THRUST = 1 << 0
INPUT_BRAKE = 1 << 1
INPUT_ROTATE_LEFT = 1 << 2
INPUT_ROTATE_RIGHT = 1 << 3
INPUT_FIRE = 1 << 4

# the rules' constants (gamestate.h), positions and speeds in 16.16 fixed point
_FP = 16
_ONE = 1 << _FP
SHIPS = 4
SLOTS = 30
_DEGREES = 360
_ROTATE = 3
_RADIUS = 15 * _ONE
_THRUST = int(0.06 * _ONE)
_MAX_THRUST = 4 * _ONE
_BULLET_SPEED = 5
_COOLDOWN = 8
_DAMAGE = 10
_HEALTH = 100
# the 640 x 480 client area inset by 8 px (the start), then by 8 px again (the bounds)
_WIDTH, _HEIGHT = 624, 464
_BOUNDS = (16 * _ONE, 16 * _ONE, 624 * _ONE, 464 * _ONE)  # left, top, right, bottom

# int32 sine table in 16.16: sin_fp[d] = round(sin(d degrees) * 65536)
_SIN_FP = np.round(np.sin(np.arange(_DEGREES) * np.pi / 180) * _ONE).astype(np.int32)

# the state's leaves in the kernel's order (sorted), with a session's shapes
SHAPES = {"bullet_active": (SHIPS, SLOTS), "bullet_pos": (SHIPS, SLOTS, 2),
          "bullet_vel": (SHIPS, SLOTS, 2), "cooldown": (SHIPS,), "heading": (SHIPS,),
          "health": (SHIPS,), "pos": (SHIPS, 2), "score": (SHIPS,), "vel": (SHIPS, 2)}
LEAVES = tuple(SHAPES)


@functools.lru_cache(maxsize=8)
def _device_consts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sine table, bounds' low corner, bounds' high corner) on ``device``,
    copied there once."""
    lut = torch.from_numpy(_SIN_FP).to(device)
    lo = torch.tensor(_BOUNDS[:2], dtype=torch.int32, device=device)
    hi = torch.tensor(_BOUNDS[2:], dtype=torch.int32, device=device)
    return lut, lo, hi


# -- the kernel route (csrc/vectorwar.cu) ------------------------------------

# the leaves the kernel loads in 8-byte pairs
_PAIRED = tuple(i for i, k in enumerate(LEAVES) if k in ("bullet_pos", "bullet_vel", "pos", "vel"))


def _lib() -> ctypes.CDLL:
    lib = _build.load("vectorwar")
    fn = lib.ggrs_vectorwar_advance
    if fn.argtypes is None:
        consts = (ctypes.c_longlong * 14)()
        lib.ggrs_vectorwar_constants.argtypes = [ctypes.c_void_p]
        lib.ggrs_vectorwar_constants.restype = None
        lib.ggrs_vectorwar_constants(consts)
        want = (SHIPS, SLOTS, _FP, _ROTATE, _RADIUS, _THRUST, _MAX_THRUST, _BULLET_SPEED, _COOLDOWN,
                _DAMAGE, *_BOUNDS)
        if tuple(consts) != want:
            raise RuntimeError(f"vectorwar library constants {tuple(consts)} differ from {want}")
        fn.argtypes = [
            ctypes.c_int64,  # rows
            ctypes.c_void_p, ctypes.c_void_p,  # leaves' first rows, their row strides in bytes
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # inputs, stride, item bytes
            ctypes.c_void_p,  # outputs' first rows
            ctypes.c_void_p,  # sine table
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def _card_leaves(state: Any, inputs: Any) -> Tuple[Tuple[torch.Tensor, ...], Tuple[int, ...]]:
    """The nine leaves (``LEAVES`` order) and ``inputs`` as the kernel reads
    them, and the bytes from one session's row to the next of each
    (``games/_card.py``).  Raises where the kernel cannot read the call."""
    leaves = tuple(state[k] for k in LEAVES)
    check_call("VectorWar", leaves, inputs)
    lead = inputs.dim() - 1
    if lead < 0 or inputs.shape[-1] != SHIPS or any(
            x.shape != (*inputs.shape[:-1], *SHAPES[k]) for k, x in zip(LEAVES, leaves)):
        raise ValueError(f"VectorWar.advance on the card: shapes "
                         f"{ {k: tuple(x.shape) for k, x in zip(LEAVES, leaves)} }, inputs "
                         f"{tuple(inputs.shape)} are not the state's leaves and (..., 4) "
                         f"inputs of the same sessions")
    every = (*leaves, inputs)
    if inputs.numel() == 0:  # no rows to read: an empty tensor's strides may be anything
        return every, (0,) * len(every)
    return read_in_place("VectorWar", every, lead, paired=_PAIRED,
                         paired_names="bullet_pos, bullet_vel, pos and vel")


def _kernel_args(read: tuple, strides: tuple, new: Dict[str, torch.Tensor], rows: int) -> tuple:
    """``ggrs_vectorwar_advance``'s arguments but the stream."""
    leaves, inp = read[:-1], read[-1]
    lut, _, _ = _device_consts(inp.device)
    ptrs = (ctypes.c_void_p * len(LEAVES))(*(x.data_ptr() for x in leaves))
    row_bytes = (ctypes.c_int64 * len(LEAVES))(*strides[:-1])
    outs = (ctypes.c_void_p * len(LEAVES))(*(new[k].data_ptr() for k in LEAVES))
    return (rows, ptrs, row_bytes, inp.data_ptr(), strides[-1], inp.element_size(), outs,
            lut.data_ptr())


_advance_kernel = Kernel("VectorWar", LEAVES, _card_leaves, _kernel_args,
                         lambda: _lib().ggrs_vectorwar_advance)


def _isqrt(n: torch.Tensor) -> torch.Tensor:
    """The exact integer square root of int64 ``n >= 0``: a float64 root,
    moved by one where it rounded across an integer."""
    root = torch.sqrt(n.to(torch.float64)).floor().to(torch.int64)
    root = root - (root * root > n).to(torch.int64)
    return root + ((root + 1) * (root + 1) <= n).to(torch.int64)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """``mask`` with only its first True along the last axis kept."""
    return mask & (mask.cumsum(dim=-1) == 1)


class VectorWar:
    """``init_state`` / batch-native ``advance`` in torch."""

    # -- state ---------------------------------------------------------

    def init_state_np(self) -> Dict[str, np.ndarray]:
        """GGPO's start (``GameState::Init``): ship i on a circle of 116 px
        about (312, 232) at 90 i degrees, heading the other way, health 100;
        no bullet.  Leaves in sorted key order."""
        t = np.arange(SHIPS) * _DEGREES // SHIPS
        r = _HEIGHT // 4
        pos = np.stack([(_WIDTH // 2) * _ONE + r * _SIN_FP[(t + 90) % _DEGREES].astype(np.int64),
                        (_HEIGHT // 2) * _ONE + r * _SIN_FP[t].astype(np.int64)], axis=1)
        state = {k: np.zeros(shape, np.int32) for k, shape in SHAPES.items()}
        state["heading"] = ((t + 180) % _DEGREES).astype(np.int32)
        state["health"] = np.full(SHIPS, _HEALTH, np.int32)
        state["pos"] = pos.astype(np.int32)
        return state

    def init_state(self, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """One unbatched initial state as tensors on ``device``."""
        return from_numpy(self.init_state_np(), device)

    # -- advance: torch, batch-native ------------------------------------

    def advance(self, state: Any, inputs: torch.Tensor,
                out: Optional[Any] = None) -> Dict[str, torch.Tensor]:
        """One frame for B sessions.  ``inputs``: (B, P) uint8.  On the card
        the kernel, else the eager body (module docstring); both give the
        same integers.  Where ``out`` is given (leaves of the state's
        shapes, e.g. a ring slot) the new state is written there and ``out``
        returned (``games/_card.py``)."""
        return _advance_kernel.advance(self._advance_eager, state, inputs, out)

    def _advance_eager(self, state: Any, inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The step as eager PyTorch, every ship at once: the CPU route and
        the plain version the kernel is held to.  A ship's move reads only
        its own ship, so all move first; ship i's bullets are then tested
        against the moved ships j <= i and the unmoved ships j > i."""
        lut, lo, hi = _device_consts(inputs.device)
        bits = inputs.to(torch.int32)
        i32 = torch.int32
        # turn, then the heading's direction
        turn = torch.where((bits & INPUT_ROTATE_RIGHT) != 0, _ROTATE,
                           torch.where((bits & INPUT_ROTATE_LEFT) != 0, -_ROTATE, 0)).to(i32)
        heading = torch.remainder(state["heading"] + turn, _DEGREES)
        cos = lut[torch.remainder(heading + 90, _DEGREES)]
        sin = lut[heading]
        direction = torch.stack([cos, sin], dim=-1)  # (B, P, 2)
        # fire into the first free slot
        active = state["bullet_active"]
        free = active == 0
        shoot = (state["cooldown"] == 0) & ((bits & INPUT_FIRE) != 0) & free.any(dim=-1)
        new = _first_true(free) & shoot.unsqueeze(-1)  # (B, P, S)
        fired = new.unsqueeze(-1)
        bpos = torch.where(fired, (state["pos"] + 15 * direction).unsqueeze(-2), state["bullet_pos"])
        bvel = torch.where(fired, (state["vel"] + _BULLET_SPEED * direction).unsqueeze(-2),
                           state["bullet_vel"])
        active = active | new.to(i32)
        cooldown = torch.where(shoot, _COOLDOWN, state["cooldown"]).to(i32)
        # thrust, and the speed limit
        thrust = torch.where((bits & INPUT_THRUST) != 0, _THRUST,
                             torch.where((bits & INPUT_BRAKE) != 0, -_THRUST, 0)).to(i32)
        vel = state["vel"] + ((thrust.unsqueeze(-1) * direction) >> _FP)
        wide = vel.to(torch.int64)
        speed = _isqrt((wide * wide).sum(dim=-1))  # (B, P)
        limit = ((thrust != 0) & (speed > _MAX_THRUST)).unsqueeze(-1)
        scaled = torch.div(wide * _MAX_THRUST, speed.clamp(min=1).unsqueeze(-1),
                           rounding_mode="trunc").to(i32)
        vel = torch.where(limit, scaled, vel)
        # move, and bounce off the bounds (an axis each)
        moved = state["pos"] + vel
        wall = (moved - _RADIUS < lo) | (moved + _RADIUS > hi)
        vel = torch.where(wall, -vel, vel)
        pos = torch.where(wall, moved + 2 * vel, moved)
        # bullets: move, leave the bounds, or hit the first ship in ship order
        live = active != 0
        bpos = torch.where(live.unsqueeze(-1), bpos + bvel, bpos)
        outside = ((bpos < lo) | (bpos > hi)).any(dim=-1)
        order = torch.arange(SHIPS, device=inputs.device)
        moved_first = (order.unsqueeze(1) <= order.unsqueeze(0)).unsqueeze(-1)  # (J, I, 1): j <= i
        targets = torch.where(moved_first, pos.unsqueeze(-2), state["pos"].unsqueeze(-2))  # (B, J, I, 2)
        gap = bpos.unsqueeze(-2).to(torch.int64) - targets.transpose(-3, -2).unsqueeze(-3).to(torch.int64)
        near = (gap * gap).sum(dim=-1) < _RADIUS * _RADIUS  # (B, I, S, J)
        hits = _first_true(near & (live & ~outside).unsqueeze(-1))
        hit = hits.any(dim=-1)  # (B, I, S)
        score = state["score"] + hit.sum(dim=-1, dtype=i32)
        health = state["health"] - _DAMAGE * hits.sum(dim=(-3, -2), dtype=i32)
        active = torch.where(live & (outside | hit), 0, active).to(i32)
        cooldown = torch.where(cooldown > 0, cooldown - 1, cooldown)
        return {"bullet_active": active, "bullet_pos": bpos, "bullet_vel": bvel,
                "cooldown": cooldown, "heading": heading, "health": health, "pos": pos,
                "score": score, "vel": vel}
