"""EcsWorld: a bevy_ggrs-style entity-component world as one state tree.

The port of ``ggrs_tpu/games/ecs_world.py`` (BASELINE config 4: 4 players,
16-frame rollback).  The rolled-back state is a set of component tables over
an entity axis, batched over sessions, all 16.16 fixed-point int32::

    pos (B, E, 2)   vel (B, E, 2)   health (B, E)   rally (B, P, 2)   owner (B, E)

so the simulation is bitwise identical on the card, on the CPU, in the JAX
package and in the NumPy oracle.  Systems per frame:

  1. steering -- each unit accelerates toward its player's rally point, which
     the player's input (a 4-way bitmask, ``(B, P)`` u8) moves;
  2. integration -- velocity damping, position wrap;
  3. contact -- a unit loses 1 health per living enemy unit in range (the
     dense O(E^2) masked distance check, ``(B, E, E)`` temporaries kept in
     int32 and bool);
  4. respawn -- dead units return to their player's spawn with full health.

``owner`` is static but part of the state, so it is digested (as int32).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..convert import from_numpy
from ..core.device import DeviceLike

_FP = 16
_ONE = 1 << _FP
WORLD_W = 1024 * _ONE
WORLD_H = 1024 * _ONE
_ACCEL = int(0.08 * _ONE)
_MAX_V = 4 * _ONE
_FRICTION_NUM = 248  # vel *= 248/256
_RALLY_STEP = 2 * _ONE
_CONTACT_RANGE = 24 * _ONE
_CONTACT_RANGE_SQ = (_CONTACT_RANGE >> _FP) ** 2  # compare in whole pixels
_MAX_HEALTH = 100


def _init_np(num_players: int, epp: int) -> Dict[str, np.ndarray]:
    """Units in an 8-wide grid at their player's corner, at rest."""
    P, E = num_players, num_players * epp
    owner = np.repeat(np.arange(P, dtype=np.int32), epp)
    corners = np.asarray(
        [
            [WORLD_W // 4, WORLD_H // 4],
            [3 * WORLD_W // 4, 3 * WORLD_H // 4],
            [3 * WORLD_W // 4, WORLD_H // 4],
            [WORLD_W // 4, 3 * WORLD_H // 4],
        ],
        np.int64,
    )[:P]
    lane = np.arange(E, dtype=np.int64) % epp
    pos = corners[owner] + np.stack([(lane % 8) * 4 * _ONE, (lane // 8) * 4 * _ONE], axis=1)
    return {
        "pos": pos.astype(np.int32),
        "vel": np.zeros((E, 2), np.int32),
        "health": np.full((E,), _MAX_HEALTH, np.int32),
        "rally": corners.astype(np.int32).copy(),
        "owner": owner,  # static, but part of the world for checksums
    }


@functools.lru_cache(maxsize=8)
def _device_consts(num_players: int, epp: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spawn positions (E, 2), world size (2,)) int32 on ``device``, copied
    there once."""
    spawn = torch.from_numpy(_init_np(num_players, epp)["pos"]).to(device)
    window = torch.tensor([WORLD_W, WORLD_H], dtype=torch.int32, device=device)
    return spawn, window


class EcsWorld:
    """``init_state`` / batch-native ``advance`` in torch, and the NumPy
    oracle ``init_state_np`` / ``advance_np`` (one unbatched state)."""

    def __init__(self, num_players: int = 4, entities_per_player: int = 32) -> None:
        if not 2 <= num_players <= 4:
            raise ValueError("EcsWorld supports 2-4 players")
        self.num_players = num_players
        self.epp = entities_per_player
        self.E = num_players * entities_per_player

    # -- state ---------------------------------------------------------

    def init_state_np(self) -> Dict[str, np.ndarray]:
        return _init_np(self.num_players, self.epp)

    def init_state(self, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """One unbatched initial state as tensors on ``device``."""
        return from_numpy(self.init_state_np(), device)

    # -- advance: torch, batch-native ------------------------------------

    def advance(self, state: Any, inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One frame for B worlds.  ``inputs``: (B, P) u8 bitmasks."""
        spawn, window = _device_consts(self.num_players, self.epp, inputs.device)
        inp = inputs.to(torch.int32)
        up = (inp >> 0) & 1
        down = (inp >> 1) & 1
        left = (inp >> 2) & 1
        right = (inp >> 3) & 1
        delta = torch.stack([right - left, down - up], dim=-1) * _RALLY_STEP
        rally = torch.remainder(state["rally"] + delta, window)

        # steering: accelerate toward the owner's rally point, a per-session
        # gather (only the index is int64; owner stays an int32 leaf)
        owner = state["owner"]
        index = owner.to(torch.int64).unsqueeze(-1).expand(*owner.shape, 2)
        target = torch.gather(rally, 1, index)
        vel = state["vel"] + torch.sign(target - state["pos"]) * _ACCEL
        vel = torch.clamp(vel, -_MAX_V, _MAX_V)
        vel = (vel * _FRICTION_NUM) >> 8  # int32 >> is arithmetic, as in JAX
        pos = torch.remainder(state["pos"] + vel, window)

        # contact damage: dense pairwise whole-pixel distance, masked to
        # enemies and living units.  (B, E, E) temporaries in int32 and bool,
        # squared in place; whole pixels are < 1024, so products fit int32
        px = pos >> _FP
        dx = px[..., 0].unsqueeze(2) - px[..., 0].unsqueeze(1)
        dy = px[..., 1].unsqueeze(2) - px[..., 1].unsqueeze(1)
        dist_sq = dx.mul_(dx).add_(dy.mul_(dy))
        del dy
        alive = state["health"] > 0
        touching = dist_sq <= _CONTACT_RANGE_SQ
        del dist_sq, dx
        touching &= owner.unsqueeze(2) != owner.unsqueeze(1)
        touching &= alive.unsqueeze(2)
        touching &= alive.unsqueeze(1)
        hits = touching.sum(dim=2, dtype=torch.int32)
        del touching
        health = torch.where(alive, state["health"] - hits, 0)

        # respawn dead units at the owner's corner with full health
        dead = health <= 0
        pos = torch.where(dead.unsqueeze(-1), spawn, pos)
        vel = torch.where(dead.unsqueeze(-1), 0, vel)
        health = torch.where(dead, _MAX_HEALTH, health)
        return {"health": health, "owner": owner, "pos": pos, "rally": rally, "vel": vel}

    # -- advance: numpy oracle ------------------------------------------

    def advance_np(self, state: Dict[str, np.ndarray], inputs: np.ndarray) -> Dict[str, np.ndarray]:
        """The independent NumPy mirror of ``advance``, one session."""
        inp = inputs.astype(np.int32)
        up = (inp >> 0) & 1
        down = (inp >> 1) & 1
        left = (inp >> 2) & 1
        right = (inp >> 3) & 1
        delta = np.stack([(right - left), (down - up)], axis=1) * _RALLY_STEP
        window = np.asarray([WORLD_W, WORLD_H], np.int32)
        rally = np.remainder(state["rally"] + delta, window).astype(np.int32)

        target = rally[state["owner"]]
        diff = target.astype(np.int64) - state["pos"]
        vel = state["vel"] + np.sign(diff).astype(np.int32) * _ACCEL
        vel = np.clip(vel, -_MAX_V, _MAX_V)
        vel = ((vel * np.int64(_FRICTION_NUM)) >> 8).astype(np.int32)
        pos = np.remainder(state["pos"] + vel, window).astype(np.int32)

        px = pos >> _FP
        d = px[:, None, :].astype(np.int64) - px[None, :, :]
        dist_sq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        alive = state["health"] > 0
        enemy = state["owner"][:, None] != state["owner"][None, :]
        touching = (dist_sq <= _CONTACT_RANGE_SQ) & enemy & alive[:, None] & alive[None, :]
        hits = touching.sum(axis=1).astype(np.int32)
        health = np.where(alive, state["health"] - hits, 0).astype(np.int32)

        spawn = self.init_state_np()["pos"]
        dead = health <= 0
        pos = np.where(dead[:, None], spawn, pos).astype(np.int32)
        vel = np.where(dead[:, None], 0, vel).astype(np.int32)
        health = np.where(dead, _MAX_HEALTH, health).astype(np.int32)
        return {"health": health, "owner": state["owner"], "pos": pos, "rally": rally, "vel": vel}
