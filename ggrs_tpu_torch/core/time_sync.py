"""Frame-advantage averaging for time synchronization between peers
(the port's copy of ``ggrs_tpu/core/time_sync.py``; reference: GGRS
src/time_sync.rs)."""

from __future__ import annotations

from .types import Frame

# Sliding window length in frames (reference: time_sync.rs:3).
FRAME_WINDOW_SIZE = 30


class TimeSync:
    def __init__(self) -> None:
        self._local = [0] * FRAME_WINDOW_SIZE
        self._remote = [0] * FRAME_WINDOW_SIZE
        # running sums so the per-tick average is O(1), not O(window)
        self._local_sum = 0
        self._remote_sum = 0

    def advance_frame(self, frame: Frame, local_adv: int, remote_adv: int) -> None:
        i = frame % FRAME_WINDOW_SIZE
        self._local_sum += local_adv - self._local[i]
        self._local[i] = local_adv
        self._remote_sum += remote_adv - self._remote[i]
        self._remote[i] = remote_adv

    def average_frame_advantage(self) -> int:
        """Average both windows and meet in the middle
        (reference: time_sync.rs:30-39).  The float expression mirrors the
        windowed original term for term so truncation matches bit-exactly."""
        local_avg = self._local_sum / FRAME_WINDOW_SIZE
        remote_avg = self._remote_sum / FRAME_WINDOW_SIZE
        return int((remote_avg - local_avg) / 2.0)
