"""Error taxonomy: the port's own copy of the three classes the device
replay raises (the JAX package's ``ggrs_tpu/core/errors.py`` defines the
full set; reference: GGRS src/error.rs:8-55)."""

from __future__ import annotations

from typing import List

Frame = int


class GgrsError(Exception):
    """Base class for all framework errors."""


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
