"""RtsCmd: an RTS-style command-stream game over variable-size inputs.

The port of ``ggrs_tpu/games/rtscmd.py``.  Each player submits a *command
stream* per frame -- zero or more orders for their units -- so the per-frame
input is ``Vec<enum>``-shaped and rides a varrec envelope
(``core/varrec.py``).  An empty stream (the default input) is a no-op frame.

Command wire format -- every order is one fixed 4-byte cell
``[tag, op0, op1, op2]`` and a stream is their concatenation:

    tag 1 MOVE   unit, dx (i8), dy (i8)      march a unit on the grid
    tag 2 GATHER unit, 0, 0                  harvest at the unit's cell
    tag 3 BUILD  x, y, 0                     spend 5 res, place a building

State is all integer (positions wrap on a 64x64 grid), batched over
sessions: ``{"units": (B, P, U, 2), "res": (B, P), "built": (B, P)}`` int32.
``advance`` reads the raw envelope bytes ``u8 (B, P, S)`` with no host
decode, branchlessly: every session and player runs every one of the
``max_cmds`` cell slots in order, masked by ``slot < n_cmds``, and every
unit access is a one-hot compare and select.  ``advance_np`` is the
independent NumPy oracle over decoded commands; the two agree exactly.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..convert import from_numpy
from ..core.config import Config, InputPredictor
from ..core.device import DeviceLike
from ..core.types import AdvanceFrame, LoadGameState, SaveGameState
from ..core.varrec import VARREC_HEADER_BYTES, envelope_pack

CMD_BYTES = 4
CMD_MOVE = 1
CMD_GATHER = 2
CMD_BUILD = 3

GRID_MASK = 0x3F  # 64x64 torus
BUILD_COST = 5

_TAGS = {"move": CMD_MOVE, "gather": CMD_GATHER, "build": CMD_BUILD}


def encode_commands(cmds: Sequence[Tuple]) -> bytes:
    """Commands -> packed byte stream.  Accepts ("move", unit, dx, dy),
    ("gather", unit), ("build", x, y)."""
    out = bytearray()
    for cmd in cmds:
        tag = _TAGS[cmd[0]]
        ops = [int(v) & 0xFF for v in cmd[1:]]
        ops += [0] * (3 - len(ops))
        out += bytes([tag, *ops])
    return bytes(out)


def decode_commands(data: bytes) -> Tuple[Tuple, ...]:
    if len(data) % CMD_BYTES:
        raise ValueError(
            f"command stream length {len(data)} is not a multiple of {CMD_BYTES}"
        )
    cmds = []
    for off in range(0, len(data), CMD_BYTES):
        tag, op0, op1, op2 = data[off : off + CMD_BYTES]
        if tag == CMD_MOVE:
            # dx/dy travel as u8, mean i8
            cmds.append(("move", op0, _i8(op1), _i8(op2)))
        elif tag == CMD_GATHER:
            cmds.append(("gather", op0))
        elif tag == CMD_BUILD:
            cmds.append(("build", op0, op1))
        else:
            raise ValueError(f"unknown command tag {tag}")
    return tuple(cmds)


def _i8(v: int) -> int:
    return v - 256 if v >= 128 else v


@functools.lru_cache(maxsize=8)
def _unit_lanes(num_units: int, device: torch.device) -> torch.Tensor:
    """(1, 1, U) int32 unit indices on ``device``."""
    return torch.arange(num_units, dtype=torch.int32, device=device).view(1, 1, num_units)


class RtsCmd:
    """``init_state`` / batch-native ``advance`` over envelope bytes in torch,
    the NumPy oracle over decoded commands, and the varrec ``config`` that
    carries the command streams."""

    def __init__(self, num_players: int = 2, num_units: int = 4, max_cmds: int = 7) -> None:
        if not 1 <= num_players <= 4:
            raise ValueError("RtsCmd supports 1-4 players")
        self.num_players = num_players
        self.num_units = num_units
        self.max_cmds = max_cmds
        self.capacity = max_cmds * CMD_BYTES

    def config(self, predictor: InputPredictor = None) -> Config:
        """Session config: command tuples in a varrec envelope sized for
        ``max_cmds`` orders per player per frame."""
        return Config.for_varrec(
            self.capacity,
            encode=encode_commands,
            decode=decode_commands,
            default=tuple,
            predictor=predictor,
        )

    # -- state ---------------------------------------------------------

    def init_state_np(self) -> Dict[str, np.ndarray]:
        p, u = self.num_players, self.num_units
        units = np.zeros((p, u, 2), np.int32)
        # spread starting positions deterministically
        units[..., 0] = (np.arange(u)[None, :] * 5 + np.arange(p)[:, None] * 17) & GRID_MASK
        units[..., 1] = (np.arange(u)[None, :] * 11 + np.arange(p)[:, None] * 29) & GRID_MASK
        return {
            "units": units,
            "res": np.full(p, BUILD_COST, np.int32),
            "built": np.zeros(p, np.int32),
        }

    def init_state(self, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """One unbatched initial state as tensors on ``device``."""
        return from_numpy(self.init_state_np(), device)

    # -- advance: numpy oracle over decoded commands --------------------

    def advance_np(self, state: Dict[str, np.ndarray],
                   streams: Sequence[Sequence[Tuple]]) -> Dict[str, np.ndarray]:
        """One frame from *decoded* command tuples, one stream per player.
        Orders apply in stream order; players apply in handle order."""
        units = state["units"].copy()
        res = state["res"].copy()
        built = state["built"].copy()
        for p, stream in enumerate(streams):
            for cmd in stream:
                if cmd[0] == "move":
                    unit = cmd[1] % self.num_units
                    units[p, unit, 0] = (units[p, unit, 0] + cmd[2]) & GRID_MASK
                    units[p, unit, 1] = (units[p, unit, 1] + cmd[3]) & GRID_MASK
                elif cmd[0] == "gather":
                    unit = cmd[1] % self.num_units
                    x, y = units[p, unit]
                    res[p] += 1 + ((int(x) ^ int(y)) & 7)
                elif cmd[0] == "build":
                    if res[p] >= BUILD_COST:
                        res[p] -= BUILD_COST
                        built[p] += 1 + (((cmd[1] ^ cmd[2]) & 3) == 0)
        return {"units": units, "res": res, "built": built}

    # -- advance: torch, batch-native, branchless, from envelope bytes --

    def advance(self, state: Any, envelopes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One frame for B sessions from raw varrec envelope bytes
        ``u8 (B, P, S)``.

        The command count comes from the u16 envelope header.  Players are
        independent within a frame, so all (session, player) pairs run at
        once; within a player the stream is sequential (``res`` and
        ``built`` carry from slot to slot), so the ``max_cmds`` slots run in
        order.  Bytes past the count are never read as live orders."""
        lanes = _unit_lanes(self.num_units, envelopes.device)
        env = envelopes.to(torch.int32)  # u8 -> i32 once: no u8 wraparound below
        n_cmds = (env[..., 0] | (env[..., 1] << 8)) // CMD_BYTES  # (B, P)
        cells = env[..., VARREC_HEADER_BYTES:].unflatten(-1, (self.max_cmds, CMD_BYTES))
        units, res, built = state["units"], state["res"], state["built"]
        for slot in range(self.max_cmds):
            tag, op0, op1, op2 = cells[:, :, slot].unbind(-1)  # (B, P) each
            live = n_cmds > slot
            step = torch.stack([
                torch.where(op1 >= 128, op1 - 256, op1),  # u8 -> i8
                torch.where(op2 >= 128, op2 - 256, op2),
            ], dim=-1)
            sel = lanes == (op0 % self.num_units).unsqueeze(-1)  # (B, P, U) one-hot

            moved = (units + step.unsqueeze(2)) & GRID_MASK
            move = (live & (tag == CMD_MOVE)).unsqueeze(-1) & sel
            units = torch.where(move.unsqueeze(-1), moved, units)

            # the unit's cell, read through the one-hot mask
            ux = torch.amax(torch.where(sel, units[..., 0], 0), dim=-1)
            uy = torch.amax(torch.where(sel, units[..., 1], 0), dim=-1)
            res = torch.where(live & (tag == CMD_GATHER), res + 1 + ((ux ^ uy) & 7), res)

            can = live & (tag == CMD_BUILD) & (res >= BUILD_COST)
            res = torch.where(can, res - BUILD_COST, res)
            bonus = (((op0 ^ op1) & 3) == 0).to(torch.int32)
            built = torch.where(can, built + 1 + bonus, built)
        return {"built": built, "res": res, "units": units}

    # -- helpers for session-driven runs ---------------------------------

    def envelopes_np(self, streams: Sequence[Sequence[Tuple]]) -> np.ndarray:
        """Decoded command streams -> the ``u8 (P, S)`` envelopes of one
        session, what ``advance`` reads for it."""
        rows = [
            np.frombuffer(envelope_pack(encode_commands(s), self.capacity), np.uint8)
            for s in streams
        ]
        return np.stack(rows)


class RtsCmdGame:
    """Host-game adapter (snapshot / restore / advance over session
    requests) running the NumPy oracle: the independent reference a session
    drive is checked against."""

    def __init__(self, game: RtsCmd) -> None:
        self._game = game
        self.state = game.init_state_np()
        self.frame = 0

    def snapshot(self):
        return (self.frame, {k: np.copy(v) for k, v in self.state.items()})

    def restore(self, snap) -> None:
        self.frame = snap[0]
        self.state = {k: np.copy(v) for k, v in snap[1].items()}

    def checksum(self) -> int:
        flat = np.concatenate(
            [np.asarray(v, np.int64).ravel() for v in
             (self.state["units"], self.state["res"], self.state["built"])]
        )
        acc = np.int64(2166136261)
        for v in flat:
            acc = np.int64((int(acc) * 16777619 + int(v)) & 0x7FFFFFFF)
        return int(acc)

    def handle_requests(self, requests) -> None:
        for request in requests:
            if isinstance(request, LoadGameState):
                self.restore(request.cell.load())
            elif isinstance(request, SaveGameState):
                if self.frame != request.frame:
                    raise ValueError(
                        f"saving frame {request.frame} while the game is at frame {self.frame}"
                    )
                request.cell.save(request.frame, self.snapshot(), self.checksum())
            elif isinstance(request, AdvanceFrame):
                streams = [value for value, _status in request.inputs]
                self.state = self._game.advance_np(self.state, streams)
                self.frame += 1
