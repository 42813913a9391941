"""Fluent session builder (the port's copy of ``ggrs_tpu/sessions/
builder.py``; reference: GGRS src/sessions/builder.rs).

Defaults match the reference: 2 players, prediction window 8, FPS 60, input
delay 0, disconnect timeout 2000 ms, notify 500 ms, check distance 2, max
frames behind 10, catchup 1.  The port starts SyncTest sessions so far; the
knobs that only P2P and spectator sessions read are kept for them, and
``add_player`` and the P2P and spectator starts come with the host layer.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Generic, Hashable, Optional, TypeVar

from ..core.config import Config
from ..core.errors import InvalidRequest
from ..core.types import DesyncDetection
from .synctest import SyncTestSession

I = TypeVar("I")
S = TypeVar("S")
A = TypeVar("A", bound=Hashable)

DEFAULT_PLAYERS = 2
DEFAULT_SPARSE_SAVING = False
DEFAULT_INPUT_DELAY = 0
DEFAULT_DISCONNECT_TIMEOUT_MS = 2000
DEFAULT_DISCONNECT_NOTIFY_START_MS = 500
DEFAULT_FPS = 60
DEFAULT_MAX_PREDICTION_FRAMES = 8
DEFAULT_CHECK_DISTANCE = 2
DEFAULT_MAX_FRAMES_BEHIND = 10
DEFAULT_CATCHUP_SPEED = 1
DEFAULT_SYNC_TIMEOUT_MS = 60_000
SPECTATOR_BUFFER_SIZE = 60


def monotonic_ms() -> int:
    return int(time.monotonic() * 1000)


class SessionBuilder(Generic[I, S, A]):
    def __init__(self, config: Config) -> None:
        self._config = config
        self._num_players = DEFAULT_PLAYERS
        self._max_prediction = DEFAULT_MAX_PREDICTION_FRAMES
        self._fps = DEFAULT_FPS
        self._sparse_saving = DEFAULT_SPARSE_SAVING
        self._desync_detection = DesyncDetection.off()
        self._disconnect_timeout_ms = DEFAULT_DISCONNECT_TIMEOUT_MS
        self._disconnect_notify_start_ms = DEFAULT_DISCONNECT_NOTIFY_START_MS
        self._input_delay = DEFAULT_INPUT_DELAY
        self._check_distance = DEFAULT_CHECK_DISTANCE
        self._max_frames_behind = DEFAULT_MAX_FRAMES_BEHIND
        self._catchup_speed = DEFAULT_CATCHUP_SPEED
        self._clock: Callable[[], int] = monotonic_ms
        self._rng: Optional[random.Random] = None
        self._sync_handshake = False
        self._sync_timeout_ms = DEFAULT_SYNC_TIMEOUT_MS

    # -- knobs (all return self for chaining) ---------------------------------

    def with_num_players(self, num_players: int) -> "SessionBuilder[I, S, A]":
        if num_players < 1:
            raise InvalidRequest(f"num_players must be at least 1 (got {num_players})")
        self._num_players = num_players
        return self

    def with_max_prediction_window(self, window: int) -> "SessionBuilder[I, S, A]":
        """0 enables lockstep mode: only advance on fully-confirmed frames,
        never save or roll back (reference: builder.rs:130-147)."""
        self._max_prediction = window
        return self

    def with_input_delay(self, delay: int) -> "SessionBuilder[I, S, A]":
        self._input_delay = delay
        return self

    def with_predictor(self, predictor) -> "SessionBuilder[I, S, A]":
        """Swap the config's input-prediction strategy.  Rebuilds the frozen
        config, so ``PredictDefault``-family strategies rebind their default
        factory exactly as at construction."""
        self._config = dataclasses.replace(self._config, predictor=predictor)
        return self

    def with_sparse_saving_mode(self, sparse_saving: bool) -> "SessionBuilder[I, S, A]":
        """Only save the minimum confirmed frame: fewer saves, longer rollbacks."""
        self._sparse_saving = sparse_saving
        return self

    def with_desync_detection_mode(
        self, desync_detection: DesyncDetection
    ) -> "SessionBuilder[I, S, A]":
        self._desync_detection = desync_detection
        return self

    def with_sync_handshake(self, enabled: bool) -> "SessionBuilder[I, S, A]":
        """Opt into the sync handshake for P2P endpoints (default off)."""
        self._sync_handshake = enabled
        return self

    def with_sync_timeout(self, timeout_ms: int) -> "SessionBuilder[I, S, A]":
        """How long handshaking endpoints probe for a peer before surfacing
        Disconnected (default 60 s)."""
        if timeout_ms <= 0:
            raise InvalidRequest("Sync timeout must be positive.")
        self._sync_timeout_ms = timeout_ms
        return self

    def with_disconnect_timeout(self, timeout_ms: int) -> "SessionBuilder[I, S, A]":
        self._disconnect_timeout_ms = timeout_ms
        return self

    def with_disconnect_notify_delay(self, notify_ms: int) -> "SessionBuilder[I, S, A]":
        self._disconnect_notify_start_ms = notify_ms
        return self

    def with_fps(self, fps: int) -> "SessionBuilder[I, S, A]":
        if fps == 0:
            raise InvalidRequest("FPS should be higher than 0.")
        self._fps = fps
        return self

    def with_check_distance(self, check_distance: int) -> "SessionBuilder[I, S, A]":
        self._check_distance = check_distance
        return self

    def with_max_frames_behind(self, max_frames_behind: int) -> "SessionBuilder[I, S, A]":
        if max_frames_behind < 1:
            raise InvalidRequest("Max frames behind cannot be smaller than 1.")
        if max_frames_behind >= SPECTATOR_BUFFER_SIZE:
            raise InvalidRequest(
                "Max frames behind cannot be larger or equal than the "
                "Spectator buffer size (60)"
            )
        self._max_frames_behind = max_frames_behind
        return self

    def with_catchup_speed(self, catchup_speed: int) -> "SessionBuilder[I, S, A]":
        if catchup_speed < 1:
            raise InvalidRequest("Catchup speed cannot be smaller than 1.")
        if catchup_speed >= self._max_frames_behind:
            raise InvalidRequest(
                "Catchup speed cannot be larger or equal than the allowed "
                "maximum frames behind host"
            )
        self._catchup_speed = catchup_speed
        return self

    def with_clock(self, clock: Callable[[], int]) -> "SessionBuilder[I, S, A]":
        """Inject a millisecond clock for the protocol timers (testing)."""
        self._clock = clock
        return self

    def with_rng(self, rng: random.Random) -> "SessionBuilder[I, S, A]":
        """Inject the RNG used for endpoint magic numbers (testing)."""
        self._rng = rng
        return self

    # -- terminal constructors -------------------------------------------------

    def start_synctest_session(self) -> SyncTestSession[I, S]:
        """Start the determinism harness; checksum comparisons need
        check_distance < max_prediction (reference: builder.rs:346-358)."""
        if self._check_distance >= self._max_prediction:
            raise InvalidRequest("Check distance too big.")
        return SyncTestSession(
            config=self._config,
            num_players=self._num_players,
            max_prediction=self._max_prediction,
            check_distance=self._check_distance,
            input_delay=self._input_delay,
        )
