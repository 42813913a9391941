"""Runs whose ``correct`` has to come out false: the control and the faults.

- ``control``: the plain reference put in the game's place, computed in
  float32, the nearest precision below the configuration's 32-bit integer
  arithmetic (a 24-bit significand; positions reach 2^26).  The program's
  replay, ring and digest run as they are.
- ``unchanged``: a step that returns its state unchanged.
- ``half``: the game's step on the first half of the batch only; the
  other half keeps its state (a batch of more than one session).
- ``altered``: an answer altered where it is produced: the digest's first
  row has its first lane's low bit flipped, every call.

The exchange between chips has no fault to plant: every cell runs on one
card.  ``variant(name, cell)`` is a context manager that yields the step
to put in the game's place (None: the game's own).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch

from . import spec
from .program import make_game

NAMES = ("control", "unchanged", "half", "altered")


def control_step(cell: spec.Cell) -> Callable:
    reference, config = spec.game_module(cell, "reference"), cell.config

    def step(state, inputs):
        wide = {k: v.to(torch.float32) for k, v in state.items()}
        out = reference.advance(wide, inputs, config, torch.float32)
        return {k: v.to(torch.int32) for k, v in out.items()}

    return step


def half_step(cell: spec.Cell) -> Callable:
    game = make_game(cell.config)

    def step(state, inputs):
        out = game.advance(state, inputs)
        half = inputs.shape[0] // 2
        return {k: torch.cat([out[k][:half], state[k][half:]]) for k in out}

    return step


@contextlib.contextmanager
def _altered_digest() -> Iterator[None]:
    from ggrs_tpu_torch.ops import checksum

    real = checksum.state_digest

    def altered(leaves, salt_mix, batch_dims=1):
        out = real(leaves, salt_mix, batch_dims).clone()
        out[:1, :1] ^= 1
        return out

    checksum.state_digest = altered
    try:
        yield
    finally:
        checksum.state_digest = real


@contextlib.contextmanager
def variant(name: str, cell: spec.Cell) -> Iterator[Optional[Callable]]:
    if name == "control":
        yield control_step(cell)
    elif name == "unchanged":
        yield lambda state, inputs: {k: v.clone() for k, v in state.items()}
    elif name == "half":
        yield half_step(cell)
    elif name == "altered":
        with _altered_digest():
            yield None
    else:
        raise ValueError(f"variant {name!r} is not one of {NAMES}")
