"""BoxGame: the flagship deterministic workload.

The port of ``ggrs_tpu/games/boxgame.py``: 2-4 ships with "ice physics"
(rotate / thrust / drift / wrap-around playfield).  The canonical variant is
16.16 fixed-point int32 with a sine LUT, so the simulation is bitwise
identical on the card, on the CPU, in the JAX package and in the NumPy
oracle.  The float32 variant (``variant="float"``) keeps the physics feel of
the reference's float example; like it, it is deterministic only within one
backend: torch's ``cos``/``sin`` and XLA's may differ in the last bit, so it
is held to the JAX package within a tolerance, and to itself bitwise.

State is a dict of tensors vectorized over players and batched over
sessions: ``{"pos": (B, P, 2), "vel": (B, P, 2), "rot": (B, P)}``, int32 or
float32.  Inputs are one ``uint8`` bitmask per player, ``(B, P)``
(up/down/left/right).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..convert import from_numpy
from ..core.config import Config
from ..core.device import DeviceLike

BOX_INPUT_UP = 1 << 0
BOX_INPUT_DOWN = 1 << 1
BOX_INPUT_LEFT = 1 << 2
BOX_INPUT_RIGHT = 1 << 3

# playfield and physics constants, 16.16 fixed point
_FP = 16
_ONE = 1 << _FP
WINDOW_W = 800 * _ONE
WINDOW_H = 600 * _ONE
_ACCEL = int(0.12 * _ONE)  # thrust per frame
_MAX_SPEED = 6 * _ONE  # per-axis speed clamp
_FRICTION_NUM = 252  # vel *= 252/256 per frame ("ice")
_ROT_STEP = 3  # LUT steps per frame of turning
_ROT_PERIOD = 256  # sine LUT length (full circle)

# int32 sine LUT in 16.16: sin_fp[i] = round(sin(2*pi*i/256) * 65536)
_SIN_FP = np.round(
    np.sin(2.0 * np.pi * np.arange(_ROT_PERIOD) / _ROT_PERIOD) * _ONE
).astype(np.int32)

# the float variant's float32 constants, as Python floats of their exact
# float32 values (a scalar operand of a float32 tensor is rounded to float32)
_F_TURN = float(np.float32(0.05))
_F_TWO_PI = float(np.float32(2 * np.pi))
_F_ACCEL = float(np.float32(0.12))
_F_FRICTION = float(np.float32(_FRICTION_NUM / 256.0))
_F_MAX_SPEED = 6.0


@functools.lru_cache(maxsize=8)
def _device_consts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sine LUT, window size) on ``device``, copied there once."""
    lut = torch.from_numpy(_SIN_FP).to(device)
    window = torch.tensor([WINDOW_W, WINDOW_H], dtype=torch.int32, device=device)
    return lut, window


@functools.lru_cache(maxsize=8)
def _float_window(device: torch.device) -> torch.Tensor:
    """The float variant's playfield size (2,) float32 on ``device``."""
    return torch.tensor([800.0, 600.0], dtype=torch.float32, device=device)


def _decode_buttons(inputs: Any) -> Tuple[Any, Any]:
    """bitmask -> (turn, thrust) in {-1, 0, 1} as int32 (numpy or torch)."""
    inp = inputs.astype(np.int32) if isinstance(inputs, np.ndarray) else inputs.to(torch.int32)
    up = (inp >> 0) & 1
    down = (inp >> 1) & 1
    left = (inp >> 2) & 1
    right = (inp >> 3) & 1
    return right - left, up - down


class BoxGame:
    """``init_state`` / batch-native ``advance`` in torch, and the NumPy
    oracle ``init_state_np`` / ``advance_np`` (one unbatched state)."""

    def __init__(self, num_players: int, variant: str = "fixed") -> None:
        if not 2 <= num_players <= 4:
            raise ValueError("BoxGame supports 2-4 players")
        if variant not in ("fixed", "float"):
            raise ValueError('BoxGame variant is "fixed" or "float"')
        self.num_players = num_players
        self.variant = variant

    # -- state ---------------------------------------------------------

    def init_state_np(self) -> Dict[str, np.ndarray]:
        """Ships spaced around the playfield center, facing outward (in
        float32 pixels and radians for the float variant).  The leaves come
        in sorted key order, as the JAX package's ``init_state_np`` gives
        them (``jax.tree_util`` rebuilds a dict sorted): a consumer that
        walks the dict in order, such as a soak harness's digest, sees the
        same bytes from both."""
        state = self._init_fixed_np()
        if self.variant == "float":
            state = {
                "pos": (state["pos"] / _ONE).astype(np.float32),
                "vel": np.zeros((self.num_players, 2), np.float32),
                "rot": (state["rot"] * (2 * np.pi / _ROT_PERIOD)).astype(np.float32),
            }
        return dict(sorted(state.items()))

    def _init_fixed_np(self) -> Dict[str, np.ndarray]:
        p = self.num_players
        angles = (np.arange(p) * (_ROT_PERIOD // p)) % _ROT_PERIOD
        cx, cy = WINDOW_W // 2, WINDOW_H // 2
        r = 150 * _ONE
        cos = _SIN_FP[(angles + _ROT_PERIOD // 4) % _ROT_PERIOD].astype(np.int64)
        sin = _SIN_FP[angles].astype(np.int64)
        pos = np.stack(
            [cx + ((r * cos) >> _FP), cy + ((r * sin) >> _FP)], axis=1
        ).astype(np.int32)
        return {
            "pos": pos,
            "vel": np.zeros((p, 2), np.int32),
            "rot": angles.astype(np.int32),
        }

    def init_state(self, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """One unbatched initial state as tensors on ``device``."""
        return from_numpy(self.init_state_np(), device)

    # -- advance: torch, batch-native ------------------------------------

    def advance(self, state: Any, inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One simulation step for B sessions.  ``inputs``: (B, P) uint8."""
        if self.variant == "float":
            return self._advance_float(state, inputs)
        lut, window = _device_consts(inputs.device)
        turn, thrust = _decode_buttons(inputs)
        rot = torch.remainder(state["rot"] + turn * _ROT_STEP, _ROT_PERIOD)
        cos = lut[torch.remainder(rot + _ROT_PERIOD // 4, _ROT_PERIOD)]
        sin = lut[rot]
        # thrust is +-1; _ACCEL * cos fits int32, and int32 >> is arithmetic
        acc = torch.stack(
            [thrust * ((_ACCEL * cos) >> _FP), thrust * ((_ACCEL * sin) >> _FP)],
            dim=-1,
        )
        vel = torch.clamp(state["vel"] + acc, -_MAX_SPEED, _MAX_SPEED)
        vel = (vel * _FRICTION_NUM) >> 8
        pos = torch.remainder(state["pos"] + vel, window)
        return {"pos": pos, "vel": vel, "rot": rot}

    def _advance_float(self, state: Any, inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The float32 step, operation for operation the JAX package's."""
        turn, thrust = _decode_buttons(inputs)
        rot = torch.remainder(state["rot"] + turn.to(torch.float32) * _F_TURN, _F_TWO_PI)
        acc = thrust.to(torch.float32).unsqueeze(-1) * torch.stack(
            [torch.cos(rot), torch.sin(rot)], dim=-1
        ) * _F_ACCEL
        vel = torch.clamp(state["vel"] + acc, -_F_MAX_SPEED, _F_MAX_SPEED) * _F_FRICTION
        pos = torch.remainder(state["pos"] + vel, _float_window(inputs.device))
        return {"pos": pos, "vel": vel, "rot": rot}

    # -- advance: numpy mirror (the independent CPU oracle) ------------

    def advance_np(self, state: Dict[str, np.ndarray], inputs: np.ndarray) -> Dict[str, np.ndarray]:
        """Bitwise mirror of ``advance`` in plain NumPy, one session (the
        fixed variant only, as in the JAX package)."""
        if self.variant != "fixed":
            raise ValueError("advance_np mirrors the fixed variant only")
        turn, thrust = _decode_buttons(inputs)
        rot = np.remainder(state["rot"] + turn * _ROT_STEP, _ROT_PERIOD).astype(np.int32)
        cos = _SIN_FP[np.remainder(rot + _ROT_PERIOD // 4, _ROT_PERIOD)]
        sin = _SIN_FP[rot]
        acc = np.stack(
            [
                thrust * ((_ACCEL * cos.astype(np.int64)) >> _FP).astype(np.int32),
                thrust * ((_ACCEL * sin.astype(np.int64)) >> _FP).astype(np.int32),
            ],
            axis=1,
        ).astype(np.int32)
        vel = state["vel"] + acc
        vel = np.clip(vel, -_MAX_SPEED, _MAX_SPEED)
        vel = ((vel * np.int64(_FRICTION_NUM)) >> 8).astype(np.int32)
        window = np.asarray([WINDOW_W, WINDOW_H], np.int32)
        pos = np.remainder(state["pos"] + vel, window).astype(np.int32)
        return {"pos": pos, "vel": vel, "rot": rot}


def boxgame_config() -> Config:
    """Host-session Config for BoxGame inputs (one u8 bitmask per player)."""
    return Config.for_uint(bits=8)
