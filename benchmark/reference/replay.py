"""What a SyncTest replay's carry must hold after T ticks, from the plain
reference alone.

A SyncTest session of check distance d and ring length R runs frame F each
tick: it reloads frame F - d, resimulates d frames, digests and saves each,
compares each digest with the first one seen for that frame, and advances
live.  The game is deterministic, so every resimulated frame g is the live
frame g: the state s_g reached from the start by g live advances.  After T
ticks (T >= R) the carry therefore holds, for every session:

- live: s_T, and the frame counter T;
- the state ring: for frames g = T - R .. T - 1, slot g mod R holds s_g,
  its digest and the frame number g;
- the input ring: slot g mod R holds frame g's input, for the same frames;
- the first-seen digests: slot g mod R holds the digest of s_g, for
  g = T - R + 1 .. T;
- no mismatch, and no first bad frame (2^31 - 1).

``expected_carry`` computes all of it with the game's reference and the
reference digest, in the layout the program's batched carry has, as int64
tensors on the device the start lies on (the card, where a check compares
there).
"""

from __future__ import annotations

from collections import deque
from types import ModuleType
from typing import Callable, Dict

import torch

from . import digest as ref_digest

I32_MAX = 2**31 - 1


def run_live(game: ModuleType, config: dict, start: Dict[str, torch.Tensor],
             inputs_at: Callable[[int], torch.Tensor], ticks: int, keep: int,
             dtype: torch.dtype = torch.int64) -> list:
    """The states of frames ``ticks - keep + 1 .. ticks``: ``start`` (leaves
    (B, ...)) advanced ``ticks`` times with ``inputs_at(t)`` (B, P)."""
    st = {k: v.to(dtype) for k, v in start.items()}
    last = deque(maxlen=keep)
    for t in range(ticks):
        st = game.advance(st, inputs_at(t), config, dtype)
        last.append(st)
    return list(last)


def expected_carry(game: ModuleType, config: dict, start: Dict[str, torch.Tensor],
                   inputs_at: Callable[[int], torch.Tensor], ticks: int, ring: int) -> dict:
    """The carry after ``ticks`` ticks, on ``start``'s device; ``start``
    leaves are (B, ...) on the device the reference runs on, ``inputs_at(t)``
    is tick t's (B, P) u8 input there."""
    if ticks < ring + 1:
        raise ValueError(f"{ticks} ticks do not fill a ring of {ring}")
    states = run_live(game, config, start, inputs_at, ticks, ring + 1)  # frames T-R .. T
    t_end = ticks
    frames = list(range(t_end - ring, t_end + 1))
    by_frame = dict(zip(frames, states))
    first = next(iter(start.values()))
    b, dev = first.shape[0], first.device

    def wide(x):
        return x.to(torch.int64)

    slots = [None] * ring
    for g in frames[:-1]:
        slots[g % ring] = g
    ring_states = {k: torch.stack([wide(by_frame[g][k]) for g in slots], dim=1)
                   for k in start}
    ring_digest = torch.stack([wide(ref_digest.digest(by_frame[g])) for g in slots], dim=1)
    ring_frames = torch.tensor(slots, dtype=torch.int64, device=dev).expand(b, ring).clone()
    input_ring = torch.stack([wide(inputs_at(g)) for g in slots], dim=1)
    hist_slots = [None] * ring
    for g in frames[1:]:
        hist_slots[g % ring] = g
    hist = torch.stack([wide(ref_digest.digest(by_frame[g])) for g in hist_slots], dim=1)
    return {
        "live": {k: wide(v) for k, v in by_frame[t_end].items()},
        "frame": torch.full((b,), t_end, dtype=torch.int64, device=dev),
        "ring": {"states": ring_states, "checksums": ring_digest, "frames": ring_frames},
        "inputs": input_ring,
        "hist": hist,
        "mismatches": torch.zeros((b,), dtype=torch.int64, device=dev),
        "first_bad": torch.full((b,), I32_MAX, dtype=torch.int64, device=dev),
    }
