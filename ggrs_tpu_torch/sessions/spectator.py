"""Spectator session: follows a host, replaying confirmed inputs only (the
port's copy of ``ggrs_tpu/sessions/spectator.py``).

Receives every player's confirmed inputs from one host endpoint into a
60-slot ring; advances one frame per tick, or ``catchup_speed`` frames when
more than ``max_frames_behind`` behind (reference:
GGRS src/sessions/p2p_spectator_session.rs).  Spectators never
roll back — their inputs are always Confirmed or Disconnected.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Generic, Hashable, List, TypeVar

from ..core.config import Config
from ..core.errors import (
    NotSynchronized,
    PredictionThreshold,
    SpectatorTooFarBehind,
)
from ..core.frame_info import PlayerInput
from ..core.types import (
    AdvanceFrame,
    Disconnected,
    Frame,
    GgrsEvent,
    GgrsRequest,
    InputStatus,
    NetworkInterrupted,
    NetworkResumed,
    NULL_FRAME,
    SessionState,
    Synchronized,
    Synchronizing,
)
from ..net.messages import ConnectionStatus
from ..net.protocol import (
    EvDisconnected,
    EvInput,
    EvNetworkInterrupted,
    EvNetworkResumed,
    EvSynchronized,
    EvSynchronizing,
    PeerProtocol,
    ProtocolEvent,
)
from ..net.sockets import NonBlockingSocket
from ..net.stats import NetworkStats
from ..utils.ownership import ThreadOwned

I = TypeVar("I")
A = TypeVar("A", bound=Hashable)

NORMAL_SPEED = 1
# One second's worth of inputs at the default 60 FPS
# (reference: p2p_spectator_session.rs:18).
SPECTATOR_BUFFER_SIZE = 60
MAX_EVENT_QUEUE_SIZE = 100


class SpectatorSession(ThreadOwned, Generic[I, A]):
    # the thread-affinity surface (ggrs-verify own/* lint)
    _DRIVING_METHODS = ("events", "advance_frame", "poll_remote_clients")

    def __init__(
        self,
        config: Config,
        num_players: int,
        socket: NonBlockingSocket,
        host: PeerProtocol[I, A],
        max_frames_behind: int,
        catchup_speed: int,
    ) -> None:
        self._config = config
        self._num_players = num_players
        self._socket = socket
        self._host = host
        self._max_frames_behind = max_frames_behind
        self._catchup_speed = catchup_speed

        self.host_connect_status = [ConnectionStatus() for _ in range(num_players)]
        self._inputs: List[List[PlayerInput[I]]] = [
            [PlayerInput.blank(NULL_FRAME, config.input_default) for _ in range(num_players)]
            for _ in range(SPECTATOR_BUFFER_SIZE)
        ]
        self._event_queue: Deque[GgrsEvent] = deque()
        self._current_frame: Frame = NULL_FRAME
        self._last_recv_frame: Frame = NULL_FRAME

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def frames_behind_host(self) -> int:
        diff = self._last_recv_frame - self._current_frame
        assert diff >= 0
        return diff

    def network_stats(self) -> NetworkStats:
        return self._host.network_stats()

    def events(self) -> List[GgrsEvent]:
        self._check_owner()  # drains the queue: a driving call
        out = list(self._event_queue)
        self._event_queue.clear()
        return out

    def advance_frame(self) -> List[GgrsRequest]:
        """Advance 1 frame (or catchup_speed when too far behind); raises
        PredictionThreshold while waiting for host input and
        SpectatorTooFarBehind when the ring has been lapped
        (reference: p2p_spectator_session.rs:103-129)."""
        self._check_owner()
        self.poll_remote_clients()

        if self.current_state() is SessionState.SYNCHRONIZING:
            raise NotSynchronized()

        requests: List[GgrsRequest] = []
        frames_to_advance = (
            self._catchup_speed
            if self.frames_behind_host() > self._max_frames_behind
            else NORMAL_SPEED
        )

        for _ in range(frames_to_advance):
            frame_to_grab = self._current_frame + 1
            synced_inputs = self._inputs_at_frame(frame_to_grab)
            requests.append(AdvanceFrame(inputs=synced_inputs))
            self._current_frame += 1

        return requests

    def poll_remote_clients(self) -> None:
        self._check_owner()
        recv_raw = getattr(self._socket, "receive_all_datagrams", None)
        if recv_raw is not None:
            for from_addr, data in recv_raw():
                if self._host.is_handling_message(from_addr):
                    self._host.handle_datagram(data)
        else:
            for from_addr, msg in self._socket.receive_all_messages():
                if self._host.is_handling_message(from_addr):
                    self._host.handle_message(msg)

        addr = self._host.peer_addr
        for event in self._host.poll(self.host_connect_status):
            self._handle_event(event, addr)

        self._host.send_all_messages(self._socket)

    def current_state(self) -> SessionState:
        """RUNNING, unless the opt-in sync handshake (builder
        ``with_sync_handshake``) is still completing against the host."""
        if self._host.is_synchronizing():
            return SessionState.SYNCHRONIZING
        return SessionState.RUNNING

    @property
    def current_frame(self) -> Frame:
        return self._current_frame

    @property
    def num_players(self) -> int:
        return self._num_players

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _inputs_at_frame(self, frame_to_grab: Frame):
        player_inputs = self._inputs[frame_to_grab % SPECTATOR_BUFFER_SIZE]

        if player_inputs[0].frame < frame_to_grab:
            # the host's input hasn't arrived yet: wait
            raise PredictionThreshold()
        if player_inputs[0].frame > frame_to_grab:
            # the host lapped the ring: the input we need is gone forever
            raise SpectatorTooFarBehind()

        out = []
        for handle, player_input in enumerate(player_inputs):
            if (
                self.host_connect_status[handle].disconnected
                and self.host_connect_status[handle].last_frame < frame_to_grab
            ):
                out.append((player_input.input, InputStatus.DISCONNECTED))
            else:
                out.append((player_input.input, InputStatus.CONFIRMED))
        return out

    def _handle_event(self, event: ProtocolEvent, addr: A) -> None:
        if isinstance(event, EvNetworkInterrupted):
            self._push_event(
                NetworkInterrupted(addr=addr, disconnect_timeout=event.disconnect_timeout)
            )
        elif isinstance(event, EvNetworkResumed):
            self._push_event(NetworkResumed(addr=addr))
        elif isinstance(event, EvSynchronizing):
            self._push_event(
                Synchronizing(addr=addr, total=event.total, count=event.count)
            )
        elif isinstance(event, EvSynchronized):
            self._push_event(Synchronized(addr=addr))
        elif isinstance(event, EvDisconnected):
            self._push_event(Disconnected(addr=addr))
        elif isinstance(event, EvInput):
            player_input = event.input
            idx = player_input.frame % SPECTATOR_BUFFER_SIZE
            assert player_input.frame >= self._last_recv_frame
            self._last_recv_frame = player_input.frame
            self._inputs[idx][event.player] = player_input

            self._host.update_local_frame_advantage(self._last_recv_frame)
            for i in range(self._num_players):
                status = self._host.peer_connect_status[i]
                self.host_connect_status[i] = ConnectionStatus(
                    status.disconnected, status.last_frame
                )

    def _push_event(self, event: GgrsEvent) -> None:
        self._event_queue.append(event)
        while len(self._event_queue) > MAX_EVENT_QUEUE_SIZE:
            self._event_queue.popleft()
