"""Core vocabulary: frames, players, statuses, requests, events.

The port's own copy of ``ggrs_tpu/core/types.py`` (reference: GGRS
src/lib.rs:44-195).  The command-list contract is the reference's: sessions
hand back an ordered list of requests (save / load / advance), and the user,
or ``ops.DeviceRequestExecutor`` on the card, fulfils them in order.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Generic, Hashable, List, Tuple, TypeVar

# A frame is a single step of execution (reference: src/lib.rs:47-51).
Frame = int
NULL_FRAME: Frame = -1
PlayerHandle = int

I = TypeVar("I")  # input type
A = TypeVar("A", bound=Hashable)  # address type


class InputStatus(enum.Enum):
    """Given together with each player input when asked to advance a frame
    (reference: src/lib.rs:104-113)."""

    CONFIRMED = "confirmed"
    PREDICTED = "predicted"
    DISCONNECTED = "disconnected"


class SessionState(enum.Enum):
    """Session lifecycle state (reference: src/lib.rs:93-102)."""

    SYNCHRONIZING = "synchronizing"
    RUNNING = "running"


@dataclass(frozen=True)
class DesyncDetection:
    """Desync detection by comparing checksums between peers
    (reference: src/lib.rs:57-67)."""

    enabled: bool = False
    interval: int = 0

    @staticmethod
    def off() -> "DesyncDetection":
        return DesyncDetection(False, 0)

    @staticmethod
    def on(interval: int) -> "DesyncDetection":
        if interval <= 0:
            raise ValueError("desync detection interval must be positive")
        return DesyncDetection(True, interval)


# -- player taxonomy (reference: src/lib.rs:69-91) ----------------------------


@dataclass(frozen=True)
class Local:
    """This player plays on the local device."""


@dataclass(frozen=True)
class Remote(Generic[A]):
    """This player plays on a remote device identified by the address."""

    addr: A


@dataclass(frozen=True)
class Spectator(Generic[A]):
    """A remote device that observes but does not contribute input."""

    addr: A


PlayerType = Local | Remote | Spectator


# -- requests (reference: src/lib.rs:170-195) ---------------------------------


@dataclass
class SaveGameState:
    """Save the current gamestate into ``cell``; ``frame`` is a sanity check."""

    cell: Any  # GameStateCell; typed loosely to avoid an import cycle
    frame: Frame


@dataclass
class LoadGameState:
    """Load the gamestate in ``cell``; ``frame`` is a sanity check."""

    cell: Any
    frame: Frame


@dataclass
class AdvanceFrame(Generic[I]):
    """Advance the gamestate with the given per-player ``(input, status)`` pairs.

    Disconnected players get default inputs with DISCONNECTED status."""

    inputs: List[Tuple[I, InputStatus]]


GgrsRequest = SaveGameState | LoadGameState | AdvanceFrame


# -- events (reference: src/lib.rs:115-168) -----------------------------------


@dataclass(frozen=True)
class Synchronizing(Generic[A]):
    """Handshake progress, emitted when the sync handshake is enabled."""

    addr: A
    total: int
    count: int


@dataclass(frozen=True)
class Synchronized(Generic[A]):
    addr: A


@dataclass(frozen=True)
class Disconnected(Generic[A]):
    addr: A


@dataclass(frozen=True)
class NetworkInterrupted(Generic[A]):
    addr: A
    disconnect_timeout: int  # ms until the remote is disconnected


@dataclass(frozen=True)
class NetworkResumed(Generic[A]):
    addr: A


@dataclass(frozen=True)
class WaitRecommendation:
    skip_frames: int


@dataclass(frozen=True)
class DesyncDetected(Generic[A]):
    frame: Frame
    local_checksum: int
    remote_checksum: int
    addr: A


GgrsEvent = (
    Synchronizing
    | Synchronized
    | Disconnected
    | NetworkInterrupted
    | NetworkResumed
    | WaitRecommendation
    | DesyncDetected
)
