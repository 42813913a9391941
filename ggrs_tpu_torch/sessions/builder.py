"""Fluent session builder (the port's copy of ``ggrs_tpu/sessions/
builder.py``; reference: GGRS src/sessions/builder.rs).

Validates player handles (local/remote < num_players, spectators >=
num_players), groups players by address into shared endpoints, and
constructs P2P / Spectator / SyncTest sessions.  Defaults match the
reference: 2 players, prediction window 8, FPS 60, input delay 0, disconnect
timeout 2000 ms, notify 500 ms, check distance 2, max frames behind 10,
catchup 1.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Generic, Hashable, List, Optional, TypeVar

from ..core.config import Config
from ..core.errors import InvalidRequest
from ..core.types import DesyncDetection, Local, PlayerHandle, PlayerType, Remote, Spectator
from ..net.protocol import DEFAULT_SYNC_TIMEOUT_MS, PeerProtocol, monotonic_ms
from ..net.sockets import NonBlockingSocket
from .p2p import P2PSession, PlayerRegistry
from .spectator import SPECTATOR_BUFFER_SIZE, SpectatorSession
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


class SessionBuilder(Generic[I, S, A]):
    def __init__(self, config: Config) -> None:
        self._config = config
        self._player_reg: PlayerRegistry[I, A] = PlayerRegistry()
        self._local_players = 0
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

    # -- players ---------------------------------------------------------------

    def add_player(
        self, player_type: PlayerType, player_handle: PlayerHandle
    ) -> "SessionBuilder[I, S, A]":
        """Register one player.  Handles for local/remote players must be in
        [0, num_players); spectator handles must be >= num_players
        (reference: builder.rs:90-128)."""
        if player_handle in self._player_reg.handles:
            raise InvalidRequest("Player handle already in use.")
        if isinstance(player_type, Local):
            self._local_players += 1
            if player_handle >= self._num_players:
                raise InvalidRequest(
                    "The player handle you provided is invalid. For a local "
                    "player, the handle should be between 0 and num_players"
                )
        elif isinstance(player_type, Remote):
            if player_handle >= self._num_players:
                raise InvalidRequest(
                    "The player handle you provided is invalid. For a remote "
                    "player, the handle should be between 0 and num_players"
                )
        elif isinstance(player_type, Spectator):
            if player_handle < self._num_players:
                raise InvalidRequest(
                    "The player handle you provided is invalid. For a "
                    "spectator, the handle should be num_players or higher"
                )
        else:
            raise InvalidRequest(f"Unknown player type {player_type!r}")
        self._player_reg.handles[player_handle] = player_type
        return self

    # -- knobs (all return self for chaining) ---------------------------------

    def with_num_players(self, num_players: int) -> "SessionBuilder[I, S, A]":
        if num_players < 1:
            raise InvalidRequest(f"num_players must be at least 1 (got {num_players})")
        self._num_players = num_players
        return self

    def _check_wire_player_cap(self) -> None:
        # the wire carries one connect status per player in every input
        # message, capped at 64 on decode (messages._MAX_PLAYERS_ON_WIRE):
        # every receiver would drop a bigger session's packets, so the
        # wire-facing constructors refuse (SyncTest sessions are all-local)
        if self._num_players > 64:
            raise InvalidRequest(
                f"networked sessions support at most 64 players (the wire "
                f"carries a connect status per player; got "
                f"{self._num_players})"
            )

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

    def start_p2p_session(self, socket: NonBlockingSocket) -> P2PSession[I, S, A]:
        """Group remote/spectator players by address into shared endpoints and
        start the session (reference: builder.rs:255-308)."""
        self._check_wire_player_cap()
        for player_handle in range(self._num_players):
            if player_handle not in self._player_reg.handles:
                raise InvalidRequest(
                    "Not enough players have been added. Keep registering "
                    "players up to the defined player number."
                )

        remote_by_addr: dict = {}
        spectator_by_addr: dict = {}
        for handle, player_type in self._player_reg.handles.items():
            if isinstance(player_type, Remote):
                remote_by_addr.setdefault(player_type.addr, []).append(handle)
            elif isinstance(player_type, Spectator):
                spectator_by_addr.setdefault(player_type.addr, []).append(handle)

        for addr, handles in remote_by_addr.items():
            self._player_reg.remotes[addr] = self._create_endpoint(
                handles, addr, self._local_players
            )
        for addr, handles in spectator_by_addr.items():
            # the host sends spectators the inputs of ALL players
            self._player_reg.spectators[addr] = self._create_endpoint(
                handles, addr, self._num_players
            )

        return P2PSession(
            config=self._config,
            num_players=self._num_players,
            max_prediction=self._max_prediction,
            socket=socket,
            players=self._player_reg,
            sparse_saving=self._sparse_saving,
            desync_detection=self._desync_detection,
            input_delay=self._input_delay,
        )

    def start_spectator_session(
        self, host_addr: A, socket: NonBlockingSocket
    ) -> SpectatorSession[I, A]:
        """Connect to a host that broadcasts all confirmed inputs
        (reference: builder.rs:314-338)."""
        self._check_wire_player_cap()
        host = PeerProtocol(
            config=self._config,
            handles=list(range(self._num_players)),
            peer_addr=host_addr,
            num_players=self._num_players,
            local_players=1,  # irrelevant: the spectator never sends inputs
            max_prediction=self._max_prediction,
            disconnect_timeout_ms=self._disconnect_timeout_ms,
            disconnect_notify_start_ms=self._disconnect_notify_start_ms,
            fps=self._fps,
            desync_detection=DesyncDetection.off(),
            clock=self._clock,
            rng=self._rng,
            sync_required=self._sync_handshake,
            sync_timeout_ms=self._sync_timeout_ms,
        )
        return SpectatorSession(
            config=self._config,
            num_players=self._num_players,
            socket=socket,
            host=host,
            max_frames_behind=self._max_frames_behind,
            catchup_speed=self._catchup_speed,
        )

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

    def _create_endpoint(
        self, handles: List[PlayerHandle], peer_addr: A, local_players: int
    ) -> PeerProtocol[I, A]:
        return PeerProtocol(
            config=self._config,
            handles=handles,
            peer_addr=peer_addr,
            num_players=self._num_players,
            local_players=local_players,
            max_prediction=self._max_prediction,
            disconnect_timeout_ms=self._disconnect_timeout_ms,
            disconnect_notify_start_ms=self._disconnect_notify_start_ms,
            fps=self._fps,
            desync_detection=self._desync_detection,
            clock=self._clock,
            rng=self._rng,
            sync_required=self._sync_handshake,
            sync_timeout_ms=self._sync_timeout_ms,
        )
