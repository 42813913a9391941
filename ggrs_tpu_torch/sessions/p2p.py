"""The peer-to-peer session: the heart of rollback netcode (the port's
copy of ``ggrs_tpu/sessions/p2p.py``).

Behavior-parity reimplementation of the reference's P2PSession
(GGRS src/sessions/p2p_session.rs): per tick it drains the
network, detects desyncs, rolls back and resimulates on mispredictions,
forwards confirmed inputs to spectators, recommends waits when running ahead,
registers and broadcasts local inputs, and advances — returning the ordered
request list the game must fulfill.  Includes lockstep mode
(max_prediction == 0), sparse saving, and rollback-on-disconnect.

With ``ops.DeviceRequestExecutor`` fulfilling the lists on the card, each
saved cell holds a lazy ``DeviceChecksum``; the desync exchange reads one
(one device-to-host read) at each interval frame and sends it to the peers.
``adopt_spectator_endpoint`` grafts a spectator endpoint onto a live
session: a ``broadcast.JournalTap`` attaches there to record the match.
``enable_request_pooling`` reuses one ``SaveGameState`` / ``AdvanceFrame`` /
list per tick for drivers that fulfil every list before the next tick (a
``parallel.BatchedRequestExecutor`` pool).  The JAX package's
prediction-plane binding and fleet resume seams (``bind_prediction_plane``,
``adopt_resume_state``) are not ported.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Callable, Deque, Dict, Generic, Hashable, List, Optional, TypeVar

from ..core.config import Config
from ..core.errors import (
    BadPlayerHandle,
    GgrsError,
    InvalidRequest,
    NotSynchronized,
)
from ..core.frame_info import PlayerInput
from ..core.sync_layer import SyncLayer
from ..core.types import (
    AdvanceFrame,
    DesyncDetected,
    DesyncDetection,
    Disconnected,
    Frame,
    GgrsEvent,
    GgrsRequest,
    SaveGameState,
    Local,
    NetworkInterrupted,
    NetworkResumed,
    NULL_FRAME,
    PlayerHandle,
    PlayerType,
    Remote,
    SessionState,
    Spectator,
    Synchronized,
    Synchronizing,
    WaitRecommendation,
)
from ..net.messages import ConnectionStatus
from ..net.protocol import (
    EvDisconnected,
    EvInput,
    EvNetworkInterrupted,
    EvNetworkResumed,
    EvSynchronized,
    EvSynchronizing,
    MAX_CHECKSUM_HISTORY_SIZE,
    PeerProtocol,
    ProtocolEvent,
    encode_local_inputs,
)
from ..net.sockets import NonBlockingSocket
from ..net.stats import NetworkStats
from ..obs.forensics import MAX_REPORTS, DesyncReport, build_desync_report
from ..obs.recorder import ChecksumHistory, EV_DESYNC, FlightRecorder
from ..obs.registry import default_registry
from ..obs.trace import NULL_TRACER
from ..utils.ownership import ThreadOwned

logger = logging.getLogger(__name__)

I = TypeVar("I")
S = TypeVar("S")
A = TypeVar("A", bound=Hashable)

RECOMMENDATION_INTERVAL = 60  # frames between WaitRecommendation events
MIN_RECOMMENDATION = 3  # minimum frames-ahead before recommending a wait
MAX_EVENT_QUEUE_SIZE = 100

# process-wide rollback counters: observational only, never consulted by
# the tick
_OBS_ROLLBACKS = default_registry().counter(
    "ggrs_session_rollbacks_total",
    "rollbacks executed by Python-path sessions",
)
_OBS_ROLLBACK_DEPTH = default_registry().histogram(
    "ggrs_session_rollback_depth_frames",
    "frames resimulated per Python-path rollback",
    buckets=(1, 2, 4, 8, 16, 32),
)


class PlayerRegistry(Generic[I, A]):
    """Maps player handles to types and addresses to shared endpoints
    (reference: p2p_session.rs:24-115).  Multiple players can share one
    endpoint (several players behind one address)."""

    def __init__(self) -> None:
        self.handles: Dict[PlayerHandle, PlayerType] = {}
        self.remotes: Dict[A, PeerProtocol[I, A]] = {}
        self.spectators: Dict[A, PeerProtocol[I, A]] = {}

    def local_player_handles(self) -> List[PlayerHandle]:
        return sorted(h for h, t in self.handles.items() if isinstance(t, Local))

    def remote_player_handles(self) -> List[PlayerHandle]:
        return sorted(h for h, t in self.handles.items() if isinstance(t, Remote))

    def spectator_handles(self) -> List[PlayerHandle]:
        return sorted(h for h, t in self.handles.items() if isinstance(t, Spectator))

    def num_players(self) -> int:
        return sum(1 for t in self.handles.values() if isinstance(t, (Local, Remote)))

    def num_spectators(self) -> int:
        return sum(1 for t in self.handles.values() if isinstance(t, Spectator))

    def handles_by_address(self, addr: A) -> List[PlayerHandle]:
        return sorted(
            h
            for h, t in self.handles.items()
            if isinstance(t, (Remote, Spectator)) and t.addr == addr
        )


class P2PSession(ThreadOwned, Generic[I, S, A]):
    # the thread-affinity surface (ggrs-verify own/* lint): exactly the
    # methods that drive session state and therefore pin the owning
    # thread.  The public advance/poll wrappers delegate to the _impl
    # methods, which carry the guard.
    _DRIVING_METHODS = (
        "add_local_input",
        "_advance_frame_impl",
        "_poll_remote_clients_impl",
        "events",
    )

    def __init__(
        self,
        config: Config,
        num_players: int,
        max_prediction: int,
        socket: NonBlockingSocket,
        players: PlayerRegistry[I, A],
        sparse_saving: bool,
        desync_detection: DesyncDetection,
        input_delay: int,
    ) -> None:
        self._config = config
        self._num_players = num_players
        self._max_prediction = max_prediction
        self._socket = socket
        self._player_reg = players

        self.local_connect_status = [ConnectionStatus() for _ in range(num_players)]

        self._sync_layer: SyncLayer[I, S] = SyncLayer(config, num_players, max_prediction)
        for handle, player_type in players.handles.items():
            if isinstance(player_type, Local):
                self._sync_layer.set_frame_delay(handle, input_delay)

        if max_prediction == 0 and sparse_saving:
            # In lockstep mode no saving happens, but the last-saved frame
            # gates frame confirmation under sparse saving — so frames would
            # never confirm and the game would never advance.
            logger.warning(
                "Sparse saving setting is ignored because lockstep mode is on "
                "(max_prediction set to 0), so no saving will take place"
            )
            sparse_saving = False
        self._sparse_saving = sparse_saving

        self._disconnect_frame: Frame = NULL_FRAME
        self._next_spectator_frame: Frame = 0
        self._next_recommended_sleep: Frame = 0
        self._frames_ahead = 0

        self._event_queue: Deque[GgrsEvent] = deque()
        self._local_inputs: Dict[PlayerHandle, PlayerInput[I]] = {}

        self._desync_detection = desync_detection
        self._local_checksum_history: Dict[Frame, int] = {}
        self._last_sent_checksum_frame: Frame = NULL_FRAME

        # forensics & tracing, observational only.  The per-peer checksum
        # window accumulates the desync-interval reports
        # (``pending_checksums`` entries are consumed by the compare); on a
        # mismatch a DesyncReport is synthesized from both windows via
        # first-divergent-frame bisection and kept alongside the event.
        # The window lives on the attached flight recorder when there is
        # one; ``_remote_checksum_history`` is the recorder-less fallback
        # store (see ``_remote_hist`` — one store, never both).
        self.tracer = NULL_TRACER
        self.recorder: Optional[FlightRecorder] = None
        self.desync_reports: List[DesyncReport] = []
        self._forensics_journal = None
        self._remote_checksum_history: Dict[A, ChecksumHistory] = {}

        # obs: per-session counters (observational only)
        self._stat_ticks = 0
        self._stat_rollbacks = 0
        self._stat_rollback_frames = 0
        self._stat_max_rollback = 0

        # pooled requests (off by default): reuse one SaveGameState /
        # AdvanceFrame / list per tick instead of allocating them.  See
        # enable_request_pooling for the validity contract.
        self._pooled_save: Optional[SaveGameState] = None
        self._pooled_adv: Optional[AdvanceFrame] = None
        self._pooled_list: Optional[List[GgrsRequest]] = None

        # the registry is fixed once the session exists (players are added
        # through the builder only), so cache the per-tick iteration targets
        self._local_handles = players.local_player_handles()
        self._local_handle_set = set(self._local_handles)
        self._remote_endpoints = list(players.remotes.values())
        self._all_endpoints = self._remote_endpoints + list(
            players.spectators.values()
        )

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def add_local_input(self, player_handle: PlayerHandle, input: I) -> None:
        """Register local input for the current frame; must be called for
        every local player before advance_frame()."""
        self._check_owner()
        if player_handle not in self._local_handle_set:
            raise InvalidRequest(
                "The player handle you provided is not referring to a local player."
            )
        self._local_inputs[player_handle] = PlayerInput(
            self._sync_layer.current_frame, input
        )

    def current_state(self) -> SessionState:
        """RUNNING, unless the opt-in sync handshake (builder
        ``with_sync_handshake``) is still in flight on any endpoint.  With
        the handshake off this is always RUNNING, like the reference fork
        (p2p_session.rs:250-252)."""
        if any(e.is_synchronizing() for e in self._all_endpoints):
            return SessionState.SYNCHRONIZING
        return SessionState.RUNNING

    def validate_local_inputs(self) -> None:
        """Raise ``InvalidRequest`` unless every local player has staged an
        input: ``advance_frame``'s precondition, exposed so a caller can
        check it before any destructive step (socket drains)."""
        for handle in self._local_handles:
            if handle not in self._local_inputs:
                raise InvalidRequest(
                    f"Missing local input for handle {handle} while calling "
                    "advance_frame()."
                )

    def enable_request_pooling(self) -> None:
        """Reuse one ``SaveGameState``/``AdvanceFrame``/list across ticks
        instead of allocating them per ``advance_frame``.

        Contract change: the returned request list and its pooled objects
        are then valid only until the NEXT ``advance_frame`` call; fulfil
        them before ticking again.  Off by default -- only drivers that
        consume requests tick-synchronously opt in.  Request values are the
        unpooled path's (``tests/test_torch_session_pool.py``)."""
        self._pooled_save = SaveGameState(cell=None, frame=NULL_FRAME)
        self._pooled_adv = AdvanceFrame(inputs=[])
        self._pooled_list = []

    def advance_frame(self) -> List[GgrsRequest]:
        """The main entry point; see the reference call stack
        (p2p_session.rs:265-426).  Returns the ordered request list."""
        with self.tracer.span("session.tick"):
            return self._advance_frame_impl()

    def _advance_frame_impl(self) -> List[GgrsRequest]:
        self._check_owner()
        self.poll_remote_clients()

        if self.current_state() is SessionState.SYNCHRONIZING:
            raise NotSynchronized()

        self.validate_local_inputs()
        self._stat_ticks += 1

        # DESYNC DETECTION — must run before any frame can be newly marked
        # confirmed this tick: the comparison looks at the current confirmed
        # frame, and a frame re-confirmed after a rollback wouldn't have its
        # fresh checksum stored yet (reference comment: p2p_session.rs:280-288).
        if self._desync_detection.enabled:
            self._check_checksum_send_interval()
            self._compare_local_checksums_against_peers()

        if self._pooled_list is not None:
            # pooled mode: the list (and the pooled save/advance refilled
            # below) are valid until the next advance_frame
            requests = self._pooled_list
            requests.clear()
        else:
            requests = []

        # In lockstep mode we only advance on fully-confirmed frames; no
        # rollback, hence no saving at all.
        lockstep = self.in_lockstep_mode()

        if self._sync_layer.current_frame == 0 and not lockstep:
            requests.append(self._sync_layer.save_current_state())

        self._update_player_disconnects()

        confirmed_frame = self.confirmed_frame()

        if not lockstep:
            # the disconnect frame forces a rollback to erase predictions made
            # for a player we now know disconnected earlier
            first_incorrect = self._sync_layer.check_simulation_consistency(
                self._disconnect_frame
            )
            if first_incorrect != NULL_FRAME:
                if first_incorrect < self._sync_layer.current_frame:
                    self._adjust_gamestate(
                        first_incorrect, confirmed_frame, requests
                    )
                # else: nothing has been simulated past the incorrect frame —
                # possible only via a disconnect at the current frame (e.g. a
                # peer that vanished before sending any input, where
                # disconnect_frame == current_frame == 0).  There is no wrong
                # state to rewind and no request to emit; disconnect-dummy
                # inputs apply from this frame on.  Prediction tracking is
                # deliberately left untouched: other players' outstanding
                # predictions still need reconciling when their real inputs
                # arrive.  The reference panics in its load-frame window
                # assert on this edge (GGRS src/sync_layer.rs:229-249);
                # we treat the empty rollback as the no-op it is.
                self._disconnect_frame = NULL_FRAME

            last_saved = self._sync_layer.last_saved_frame
            if self._sparse_saving:
                self._check_last_saved_state(last_saved, confirmed_frame, requests)
            else:
                # the steady-state save: refilled in place when pooled
                # (_pooled_save appears at most once per list -- the frame-0
                # and rollback-resim saves above stay freshly allocated)
                requests.append(self._sync_layer.save_current_state(self._pooled_save))

        # send confirmed inputs to spectators before discarding them
        self._send_confirmed_inputs_to_spectators(confirmed_frame)
        self._sync_layer.set_last_confirmed_frame(confirmed_frame, self._sparse_saving)

        self._check_wait_recommendation()

        # hot-path locals: this method runs once per session-tick for every
        # hosted session, and the attribute chains below dominated its own
        # profile time
        sync = self._sync_layer
        local_inputs = self._local_inputs
        connect_status = self.local_connect_status

        # register local inputs and send them
        all_landed = True
        for handle in self._local_handles:
            player_input = local_inputs[handle]
            actual_frame = sync.add_local_input(handle, player_input)
            player_input.frame = actual_frame
            if actual_frame != NULL_FRAME:
                connect_status[handle].last_frame = actual_frame
            else:
                all_landed = False

        if all_landed and self._remote_endpoints:
            # every remote endpoint carries the same local inputs: join
            # the per-player payload once, push it to each endpoint
            frame, payload = encode_local_inputs(self._config, local_inputs)
            socket = self._socket
            for endpoint in self._remote_endpoints:
                endpoint.send_encoded_input(frame, payload, connect_status)
                endpoint.send_all_messages(socket)

        # advance decision
        current = sync.current_frame
        last_confirmed = sync.last_confirmed_frame
        if lockstep:
            can_advance = last_confirmed == current
        else:
            frames_ahead = (
                current if last_confirmed == NULL_FRAME
                else current - last_confirmed
            )
            can_advance = frames_ahead < self._max_prediction

        if can_advance:
            inputs = sync.synchronized_inputs(connect_status)
            sync.advance_frame()
            local_inputs.clear()
            if self._pooled_adv is not None:
                self._pooled_adv.inputs = inputs
                requests.append(self._pooled_adv)
            else:
                requests.append(AdvanceFrame(inputs=inputs))
        else:
            logger.debug(
                "Prediction threshold reached, skipping on frame %d", current
            )

        return requests

    def poll_remote_clients(self) -> None:
        """Drain the socket, route messages to endpoints, run timers, handle
        events, and flush outgoing packets (reference: p2p_session.rs:430-478)."""
        with self.tracer.span("session.poll"):
            self._poll_remote_clients_impl()

    def _poll_remote_clients_impl(self) -> None:
        self._check_owner()
        remotes = self._player_reg.remotes
        spectators = self._player_reg.spectators
        recv_raw = getattr(self._socket, "receive_all_datagrams", None)
        if recv_raw is not None:
            # raw path: endpoints decode (undecodable datagrams are dropped
            # at the endpoint, same behavior as socket-level drops)
            for from_addr, data in recv_raw():
                ep = remotes.get(from_addr)
                if ep is not None:
                    ep.handle_datagram(data)
                ep = spectators.get(from_addr)
                if ep is not None:
                    ep.handle_datagram(data)
        else:
            # user-provided sockets may only implement the message trait
            for from_addr, msg in self._socket.receive_all_messages():
                ep = remotes.get(from_addr)
                if ep is not None:
                    ep.handle_message(msg)
                ep = spectators.get(from_addr)
                if ep is not None:
                    ep.handle_message(msg)

        current_frame = self._sync_layer.current_frame
        for endpoint in self._remote_endpoints:
            if endpoint.is_running():
                endpoint.update_local_frame_advantage(current_frame)

        # stage events before handling: _handle_event may disconnect
        # endpoints, which must not perturb the poll iteration
        connect_status = self.local_connect_status
        events: List = []
        append = events.append
        for endpoint in self._all_endpoints:
            for event in endpoint.poll(connect_status):
                append((event, endpoint.handles, endpoint.peer_addr))

        handle_event = self._handle_event
        for event, handles, addr in events:
            handle_event(event, handles, addr)

        socket = self._socket
        for endpoint in self._all_endpoints:
            endpoint.send_all_messages(socket)

    def disconnect_player(self, player_handle: PlayerHandle) -> None:
        """Disconnect a remote player (and everyone sharing their address)
        (reference: p2p_session.rs:485-511)."""
        player_type = self._player_reg.handles.get(player_handle)
        if player_type is None:
            raise InvalidRequest("Invalid Player Handle.")
        if isinstance(player_type, Local):
            raise InvalidRequest("Local Player cannot be disconnected.")
        if isinstance(player_type, Remote):
            if not self.local_connect_status[player_handle].disconnected:
                last_frame = self.local_connect_status[player_handle].last_frame
                self._disconnect_player_at_frame(player_handle, last_frame)
                return
            raise InvalidRequest("Player already disconnected.")
        # spectators are simpler
        self._disconnect_player_at_frame(player_handle, NULL_FRAME)

    def network_stats(self, player_handle: PlayerHandle) -> NetworkStats:
        player_type = self._player_reg.handles.get(player_handle)
        if isinstance(player_type, Remote):
            stats = self._player_reg.remotes[player_type.addr].network_stats()
        elif isinstance(player_type, Spectator):
            stats = self._player_reg.spectators[
                player_type.addr
            ].network_stats()
        else:
            raise BadPlayerHandle()
        # socket-level counter: transient OS send failures the socket
        # swallowed as loss (UdpNonBlockingSocket.stats); sockets without
        # the counter (fakes, user transports) report 0
        sock_stats = getattr(self._socket, "stats", None)
        if sock_stats is not None:
            stats.send_errors = sock_stats.send_errors
        return stats

    def confirmed_frame(self) -> Frame:
        """Minimum last-received frame over all connected players
        (reference: p2p_session.rs:542-553)."""
        confirmed = 2**31 - 1
        for status in self.local_connect_status:
            if not status.disconnected:
                confirmed = min(confirmed, status.last_frame)
        assert confirmed < 2**31 - 1
        return confirmed

    @property
    def current_frame(self) -> Frame:
        return self._sync_layer.current_frame

    @property
    def max_prediction(self) -> int:
        return self._max_prediction

    def in_lockstep_mode(self) -> bool:
        return self._max_prediction == 0

    def events(self) -> List[GgrsEvent]:
        self._check_owner()  # drains the queue: a driving call
        out = list(self._event_queue)
        self._event_queue.clear()
        return out

    @property
    def num_players(self) -> int:
        return self._player_reg.num_players()

    @property
    def num_spectators(self) -> int:
        return self._player_reg.num_spectators()

    def local_player_handles(self) -> List[PlayerHandle]:
        return self._player_reg.local_player_handles()

    def remote_player_handles(self) -> List[PlayerHandle]:
        return self._player_reg.remote_player_handles()

    def spectator_handles(self) -> List[PlayerHandle]:
        return self._player_reg.spectator_handles()

    def handles_by_address(self, addr: A) -> List[PlayerHandle]:
        return self._player_reg.handles_by_address(addr)

    def frames_ahead(self) -> int:
        return self._frames_ahead

    def desync_detection(self) -> DesyncDetection:
        return self._desync_detection

    def attach_forensics(self, recorder: Optional[FlightRecorder] = None,
                         tracer=None, journal=None) -> None:
        """Attach observability sinks (every argument optional, everything
        observational only): a ``FlightRecorder`` that receives checksum
        history and desync events, a ``Tracer`` whose window rides
        DesyncReports (and that times this session's ticks), and a journal
        whose in-memory ``tail`` provides the frames around a divergence."""
        if recorder is not None:
            self.recorder = recorder
        if tracer is not None:
            self.tracer = tracer
        if journal is not None:
            self._forensics_journal = journal

    def adopt_spectator_endpoint(self, addr: A, endpoint) -> None:
        """Graft a spectator endpoint onto a LIVE session: the relay seam
        through which a ``broadcast.JournalTap`` receives the confirmed-input
        stream this session sends its spectators.  The endpoint joins both
        the registry (inbound routing + fan-out) and the cached poll list
        (timers + flushes)."""
        if addr in self._player_reg.spectators:
            raise InvalidRequest(f"spectator address {addr!r} already bound")
        self._player_reg.spectators[addr] = endpoint
        self._all_endpoints.append(endpoint)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _disconnect_player_at_frame(
        self, player_handle: PlayerHandle, last_frame: Frame
    ) -> None:
        """Mark everyone at the player's endpoint disconnected; schedule a
        rollback to the disconnect frame so wrong predictions are erased
        (reference: p2p_session.rs:618-655)."""
        player_type = self._player_reg.handles[player_handle]
        if isinstance(player_type, Remote):
            endpoint = self._player_reg.remotes[player_type.addr]
            for handle in endpoint.handles:
                self.local_connect_status[handle].disconnected = True
            endpoint.disconnect()
            if self._sync_layer.current_frame > last_frame:
                # resimulate from the disconnect with correct disconnect flags
                self._disconnect_frame = last_frame + 1
        elif isinstance(player_type, Spectator):
            self._player_reg.spectators[player_type.addr].disconnect()

    def _adjust_gamestate(
        self,
        first_incorrect: Frame,
        min_confirmed: Frame,
        requests: List[GgrsRequest],
    ) -> None:
        """Roll back and resimulate with up-to-date inputs
        (reference: p2p_session.rs:658-714)."""
        current_frame = self._sync_layer.current_frame
        if self._sparse_saving:
            # only the last saved state survives under sparse saving
            frame_to_load = self._sync_layer.last_saved_frame
        else:
            frame_to_load = first_incorrect

        assert frame_to_load <= first_incorrect
        count = current_frame - frame_to_load

        self._stat_rollbacks += 1
        self._stat_rollback_frames += count
        if count > self._stat_max_rollback:
            self._stat_max_rollback = count
        _OBS_ROLLBACKS.inc()
        _OBS_ROLLBACK_DEPTH.observe(count)

        requests.append(self._sync_layer.load_frame(frame_to_load))
        assert self._sync_layer.current_frame == frame_to_load
        self._sync_layer.reset_prediction()

        for i in range(count):
            inputs = self._sync_layer.synchronized_inputs(self.local_connect_status)
            if self._sparse_saving:
                # save exactly the min_confirmed frame on the way forward
                if self._sync_layer.current_frame == min_confirmed:
                    requests.append(self._sync_layer.save_current_state())
            else:
                # save every state except the one just loaded
                if i > 0:
                    requests.append(self._sync_layer.save_current_state())
            self._sync_layer.advance_frame()
            requests.append(AdvanceFrame(inputs=inputs))

        assert self._sync_layer.current_frame == current_frame

    def _send_confirmed_inputs_to_spectators(self, confirmed_frame: Frame) -> None:
        """Forward every newly-confirmed frame's inputs (for all players) to
        each spectator endpoint (reference: p2p_session.rs:717-744)."""
        if not self._player_reg.spectators:
            return

        while self._next_spectator_frame <= confirmed_frame:
            inputs = self._sync_layer.confirmed_inputs(
                self._next_spectator_frame, self.local_connect_status
            )
            assert len(inputs) == self._num_players
            input_map: Dict[PlayerHandle, PlayerInput[I]] = {}
            for handle, player_input in enumerate(inputs):
                assert (
                    player_input.frame == NULL_FRAME
                    or player_input.frame == self._next_spectator_frame
                )
                input_map[handle] = player_input

            for endpoint in self._player_reg.spectators.values():
                if endpoint.is_running():
                    endpoint.send_input(input_map, self.local_connect_status)

            self._next_spectator_frame += 1

    def _update_player_disconnects(self) -> None:
        """Cross-peer disconnect consensus: adopt any peer's knowledge of an
        earlier disconnect (reference: p2p_session.rs:748-783)."""
        n = self._num_players
        queue_connected = [True] * n
        queue_min_confirmed = [2**31 - 1] * n
        # endpoint-outer loop: one is_running() probe per endpoint, not per
        # (player, endpoint) pair — same consensus as the reference
        for endpoint in self._remote_endpoints:
            if not endpoint.is_running():
                continue
            for handle, status in enumerate(endpoint.peer_connect_status):
                if status.disconnected:
                    queue_connected[handle] = False
                if status.last_frame < queue_min_confirmed[handle]:
                    queue_min_confirmed[handle] = status.last_frame

        for handle in range(n):
            local_status = self.local_connect_status[handle]
            local_connected = not local_status.disconnected
            local_min_confirmed = local_status.last_frame
            min_confirmed = queue_min_confirmed[handle]
            if local_connected:
                min_confirmed = min(min_confirmed, local_min_confirmed)

            if not queue_connected[handle]:
                # A peer saw the disconnect earlier than we did: re-adjust.
                if local_connected or local_min_confirmed > min_confirmed:
                    self._disconnect_player_at_frame(handle, min_confirmed)

    def _max_frame_advantage(self) -> int:
        interval = None
        for endpoint in self._player_reg.remotes.values():
            for handle in endpoint.handles:
                if not self.local_connect_status[handle].disconnected:
                    adv = endpoint.average_frame_advantage()
                    interval = adv if interval is None else max(interval, adv)
        return 0 if interval is None else interval

    def _check_wait_recommendation(self) -> None:
        """Emit WaitRecommendation when well ahead of the slowest remote, at
        most every RECOMMENDATION_INTERVAL frames
        (reference: p2p_session.rs:804-817)."""
        self._frames_ahead = self._max_frame_advantage()
        if (
            self._sync_layer.current_frame > self._next_recommended_sleep
            and self._frames_ahead >= MIN_RECOMMENDATION
        ):
            self._next_recommended_sleep = (
                self._sync_layer.current_frame + RECOMMENDATION_INTERVAL
            )
            self._push_event(WaitRecommendation(skip_frames=self._frames_ahead))

    def _check_last_saved_state(
        self, last_saved: Frame, confirmed_frame: Frame, requests: List[GgrsRequest]
    ) -> None:
        """Sparse saving: before the save slides out of the prediction window,
        either save the (confirmed) current frame or roll back to resave
        (reference: p2p_session.rs:819-843)."""
        if self._sync_layer.current_frame - last_saved >= self._max_prediction:
            if confirmed_frame >= self._sync_layer.current_frame:
                requests.append(self._sync_layer.save_current_state())
            else:
                self._adjust_gamestate(last_saved, confirmed_frame, requests)

            assert confirmed_frame == NULL_FRAME or self._sync_layer.last_saved_frame == min(
                confirmed_frame, self._sync_layer.current_frame
            )

    def _handle_event(
        self, event: ProtocolEvent, player_handles: List[PlayerHandle], addr: A
    ) -> None:
        """Translate protocol events into user events / session actions
        (reference: p2p_session.rs:846-902)."""
        if isinstance(event, EvInput):
            # first: inputs outnumber every other event by orders of magnitude
            player = event.player
            assert player < self._num_players
            status = self.local_connect_status[player]
            if not status.disconnected:
                current_remote_frame = status.last_frame
                assert (
                    current_remote_frame == NULL_FRAME
                    or current_remote_frame + 1 == event.input.frame
                )
                status.last_frame = event.input.frame
                self._sync_layer.add_remote_input(player, event.input)
        elif isinstance(event, EvNetworkInterrupted):
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
            for handle in player_handles:
                last_frame = (
                    self.local_connect_status[handle].last_frame
                    if handle < self._num_players
                    else NULL_FRAME  # spectator
                )
                self._disconnect_player_at_frame(handle, last_frame)
            self._push_event(Disconnected(addr=addr))

    def _push_event(self, event: GgrsEvent) -> None:
        self._event_queue.append(event)
        while len(self._event_queue) > MAX_EVENT_QUEUE_SIZE:
            self._event_queue.popleft()

    # ------------------------------------------------------------------
    # desync detection (reference: p2p_session.rs:904-975)
    # ------------------------------------------------------------------

    def _remote_hist(self, addr: A) -> ChecksumHistory:
        """The per-peer checksum window for ``addr`` — held by the attached
        flight recorder when there is one, by the session otherwise; one
        store, never both."""
        store = (
            self.recorder.remote_checksums if self.recorder is not None
            else self._remote_checksum_history
        )
        hist = store.get(addr)
        if hist is None:
            hist = ChecksumHistory()
            store[addr] = hist
        return hist

    def _compare_local_checksums_against_peers(self) -> None:
        for remote in self._player_reg.remotes.values():
            checked = []
            hist: Optional[ChecksumHistory] = None
            for remote_frame, remote_checksum in remote.pending_checksums.items():
                if remote_frame >= self._sync_layer.last_confirmed_frame:
                    continue  # still waiting for inputs for this frame
                local_checksum = self._local_checksum_history.get(remote_frame)
                if local_checksum is None:
                    continue
                # forensics: the compare consumes pending_checksums, so the
                # bisection window must accumulate them here, match or not
                if hist is None:
                    hist = self._remote_hist(remote.peer_addr)
                hist.record(remote_frame, remote_checksum)
                if local_checksum != remote_checksum:
                    self._push_event(
                        DesyncDetected(
                            frame=remote_frame,
                            local_checksum=local_checksum,
                            remote_checksum=remote_checksum,
                            addr=remote.peer_addr,
                        )
                    )
                    self._record_desync(
                        remote.peer_addr, remote_frame, local_checksum,
                        remote_checksum, hist,
                    )
                checked.append(remote_frame)
            for frame in checked:
                del remote.pending_checksums[frame]

    def _record_desync(self, addr: A, frame: Frame, local_checksum: int,
                       remote_checksum: int,
                       remote_history: ChecksumHistory) -> None:
        """Forensics for one ``DesyncDetected``: bisect the
        shared checksum history for the first divergent frame and keep a
        :class:`DesyncReport` next to the event.  Bounded: a real desync
        re-fires every interval until the match is torn down, and the first
        few reports say everything."""
        if len(self.desync_reports) >= MAX_REPORTS:
            return
        # the recorder's local window (256 frames) out-reaches the
        # protocol-pruned history (MAX_CHECKSUM_HISTORY_SIZE): bisect over
        # the deepest window available
        local_history = (
            self.recorder.checksums if self.recorder is not None
            and len(self.recorder.checksums)
            else self._local_checksum_history
        )
        report = build_desync_report(
            detected_frame=frame,
            addr=addr,
            local_checksum=local_checksum,
            remote_checksum=remote_checksum,
            local_history=local_history,
            remote_history=remote_history,
            recorder=self.recorder,
            journal=self._forensics_journal,
            tracer=self.tracer,
            detail="checksum compare at the desync-detection interval "
                   f"(interval={self._desync_detection.interval})",
        )
        self.desync_reports.append(report)
        if self.recorder is not None:
            self.recorder.record(
                self._stat_ticks, EV_DESYNC,
                f"frame {frame}: local {local_checksum:#x} != "
                f"remote {remote_checksum:#x} (first divergent "
                f"{report.first_divergent_frame})",
            )
        self.tracer.add_instant("session.desync", frame=frame)

    def _check_checksum_send_interval(self) -> None:
        interval = self._desync_detection.interval
        if self._last_sent_checksum_frame == NULL_FRAME:
            frame_to_send = interval
        else:
            frame_to_send = self._last_sent_checksum_frame + interval

        if (
            frame_to_send <= self._sync_layer.last_confirmed_frame
            and frame_to_send <= self._sync_layer.last_saved_frame
        ):
            cell = self._sync_layer.saved_state_by_frame(frame_to_send)
            assert cell is not None, f"cell not found!: frame {frame_to_send}"

            checksum = cell.checksum
            if checksum is not None:
                for remote in self._player_reg.remotes.values():
                    remote.send_checksum_report(frame_to_send, checksum)
                self._last_sent_checksum_frame = frame_to_send
                self._local_checksum_history[frame_to_send] = checksum
                if self.recorder is not None:
                    self.recorder.record_checksum(frame_to_send, checksum)

            if len(self._local_checksum_history) > MAX_CHECKSUM_HISTORY_SIZE:
                oldest_to_keep = (
                    frame_to_send - (MAX_CHECKSUM_HISTORY_SIZE - 1) * interval
                )
                self._local_checksum_history = {
                    f: c
                    for f, c in self._local_checksum_history.items()
                    if f >= oldest_to_keep
                }
