"""Error taxonomy: the port's own copy of ``ggrs_tpu/core/errors.py``
(reference: GGRS src/error.rs:8-55)."""

from __future__ import annotations

from typing import List

from .types import Frame


class GgrsError(Exception):
    """Base class for all framework errors."""


class PredictionThreshold(GgrsError):
    """The prediction threshold has been reached; cannot accept more local
    inputs without catching up."""

    def __init__(self) -> None:
        super().__init__(
            "Prediction threshold is reached, cannot proceed without catching up."
        )


class InvalidRequest(GgrsError):
    """An invalid request, usually wrong parameters for an API call."""

    def __init__(self, info: str) -> None:
        super().__init__(f"Invalid Request: {info}")
        self.info = info


class MismatchedChecksum(GgrsError):
    """In a SyncTestSession, resimulated checksums did not match originals."""

    def __init__(self, current_frame: Frame, mismatched_frames: List[Frame]) -> None:
        super().__init__(
            f"Detected checksum mismatch during rollback on frame {current_frame}, "
            f"mismatched frames: {mismatched_frames}"
        )
        self.current_frame = current_frame
        self.mismatched_frames = mismatched_frames


class NotSynchronized(GgrsError):
    """Raised by advance_frame while the opt-in sync handshake is still
    completing."""

    def __init__(self) -> None:
        super().__init__("The session is not yet synchronized with all remote sessions.")


class SpectatorTooFarBehind(GgrsError):
    """The spectator fell so far behind the host that catching up is impossible."""

    def __init__(self) -> None:
        super().__init__(
            "The spectator got so far behind the host that catching up is impossible."
        )


class NetworkStatsError(GgrsError):
    """Network statistics are unavailable or requested for a bad handle
    (reference: src/error.rs:8-13)."""


class StatsUnavailable(NetworkStatsError):
    def __init__(self) -> None:
        super().__init__("Network statistics are unavailable for this player.")


class BadPlayerHandle(NetworkStatsError):
    def __init__(self) -> None:
        super().__init__("Network statistics were requested for an invalid player handle.")


class CrossThreadAccess(GgrsError):
    """A session was driven from a thread other than its owner.

    Sessions are ``Send`` but not ``Sync`` in the reference: one may be
    handed off between threads, but never driven from two at once.  The
    first driving call pins the owning thread; ``transfer_ownership()``
    from the new thread hands a session off."""

    def __init__(self) -> None:
        super().__init__(
            "Session driven from a thread other than its owner. Sessions "
            "are single-threaded (the reference's Send-not-Sync contract); "
            "call transfer_ownership() from the new thread to hand off."
        )
