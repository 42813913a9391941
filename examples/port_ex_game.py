"""Shared example-game harness of the PyTorch / CUDA port: BoxGame fulfilled
on the card, driven from a fixed-timestep loop.

The twin of ``examples/ex_game.py`` over ``ggrs_tpu_torch``: the same
``Game``, ``FrameClock``, bot inputs and terminal renderer (each ship a
letter on an 80x24 grid; pass --render to watch), with the state on the
CUDA card.  ``device=None`` means the card and raises without CUDA; pass
``device="cpu"`` (the examples' ``--device cpu``) to run on the CPU.
"""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np
import torch

from ggrs_tpu_torch.core.device import DeviceLike
from ggrs_tpu_torch.games import BoxGame, boxgame_config
from ggrs_tpu_torch.games.boxgame import WINDOW_H, WINDOW_W, _FP  # fixed-point consts
from ggrs_tpu_torch.ops import DeviceRequestExecutor

FPS = 60
# prediction window shared by the example sessions and the executor warmup --
# sessions built by the drivers leave the builder default (8) untouched
MAX_PREDICTION = 8

box_config = boxgame_config


def inputs_to_array(pairs) -> np.ndarray:
    """A request's ``[(buttons, status), ...]`` as the (P,) u8 array
    ``BoxGame.advance`` takes for one session (numpy: the executor uploads
    it without a synchronisation)."""
    return np.asarray([p[0] for p in pairs], np.uint8)


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device of the game state (default: the CUDA card; "
                         "'cpu' runs on the CPU)")


class Game:
    """Owns the device executor and renders / reports state."""

    def __init__(
        self,
        num_players: int,
        render: bool = False,
        rollbacks: bool = True,
        max_prediction: int = MAX_PREDICTION,
        device: DeviceLike = None,
    ) -> None:
        self.box = BoxGame(num_players)
        self.num_players = num_players
        self.render = render
        self.executor = DeviceRequestExecutor(
            self.box.advance, self.box.init_state_np(), inputs_to_array, device=device
        )
        self.device = self.executor.device
        # build the digest kernel and run every burst depth the session can
        # ask for before its loop starts: a pause inside the loop stalls the
        # poll/ack pump long enough to trip peers' disconnect timers.
        # Spectators never roll back (rollbacks=False skips the bursts).  The
        # deepest burst is max_prediction resim pairs + the trailing live
        # advance.
        self.executor.warmup(
            np.zeros((num_players,), np.uint8),
            burst_depths=range(2, max_prediction + 2) if rollbacks else (),
        )
        self.frames_run = 0

    def handle_requests(self, requests: List) -> None:
        self.executor.run(requests)
        self.frames_run += 1

    def bot_input(self, handle: int, frame: int) -> int:
        """Deterministic per-player 'AI': thrust always, turn in a pattern."""
        phase = (frame // 30 + handle * 7) % 4
        return 0b0001 | (0b0100 if phase in (1, 3) else 0b1000 if phase == 2 else 0)

    def draw(self) -> None:
        if not self.render:
            return
        pos = self.executor.state["pos"]
        pos = pos.cpu().numpy() / _FP if pos.dtype == torch.int32 else pos.cpu().numpy()
        cols, rows = 78, 22
        grid = [[" "] * cols for _ in range(rows)]
        for p in range(self.num_players):
            x = int(pos[p, 0] / (WINDOW_W / _FP) * cols) % cols
            y = int(pos[p, 1] / (WINDOW_H / _FP) * rows) % rows
            grid[y][x] = chr(ord("A") + p)
        sys.stdout.write("\x1b[H\x1b[2J")
        for row in grid:
            sys.stdout.write("".join(row) + "\n")
        sys.stdout.write(f"frame {self.frames_run}\n")
        sys.stdout.flush()


class FrameClock:
    """Fixed-timestep accumulator with skip support (the reference's loop,
    ex_game_p2p.rs:110-136)."""

    def __init__(self, fps: int = FPS) -> None:
        self.dt = 1.0 / fps
        self.acc = 0.0
        self.last = time.perf_counter()
        self.skip_until = 0.0

    def ready_frames(self, max_frames: int = 5) -> int:
        now = time.perf_counter()
        self.acc += now - self.last
        self.last = now
        # drop backlog beyond one burst: after a long pause a game resumes at
        # real-time cadence rather than fast-forwarding hundreds of frames --
        # which would outrun remote peers' input rings (a spectator follows
        # at most 60 frames behind)
        self.acc = min(self.acc, max_frames * self.dt)
        n = 0
        while self.acc >= self.dt and n < max_frames:
            self.acc -= self.dt
            if now >= self.skip_until:
                n += 1
        return n

    def skip(self, frames: int) -> None:
        """Honor a WaitRecommendation by sitting out ``frames`` frames."""
        self.skip_until = time.perf_counter() + frames * self.dt
