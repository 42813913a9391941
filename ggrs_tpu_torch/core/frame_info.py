"""Frame primitives: a saved game state and one player's input for one frame
(the port's copy of ``ggrs_tpu/core/frame_info.py``; reference: GGRS
src/frame_info.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Generic, Optional, TypeVar

from .types import NULL_FRAME, Frame

I = TypeVar("I")
S = TypeVar("S")


@dataclass
class GameState(Generic[S]):
    """A user game state for a single frame plus an optional checksum
    (reference: frame_info.rs:6-23).  ``data`` may be None."""

    frame: Frame = NULL_FRAME
    data: Optional[S] = None
    checksum: Optional[int] = None


@dataclass(slots=True)
class PlayerInput(Generic[I]):
    """An input for one player at one frame (reference: frame_info.rs:27-52)."""

    frame: Frame
    input: I

    @staticmethod
    def blank(frame: Frame, default_factory: Callable[[], I]) -> "PlayerInput[I]":
        return PlayerInput(frame, default_factory())

    def equal(self, other: "PlayerInput[I]", input_only: bool,
              eq: Callable[[Any, Any], bool] = lambda a, b: a == b) -> bool:
        return (input_only or self.frame == other.frame) and eq(self.input, other.input)
