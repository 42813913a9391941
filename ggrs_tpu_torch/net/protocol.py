"""Per-peer endpoint protocol: reliability over unreliable datagrams (the
port's copy of ``ggrs_tpu/net/protocol.py``).

Behavior-parity reimplementation of the reference's UdpProtocol
(GGRS src/network/protocol.rs): every frame we redundantly send
*all* unacked inputs (delta+RLE compressed against the last acked input);
acks trim the pending window; timers drive retries, keep-alives, quality
(ping) probes, and the two-phase interrupted→disconnected failure detector;
checksum reports ride the same channel for desync detection.

Deviations from the reference, by design:
- time is injectable (``clock`` returns monotonic milliseconds) so tests can
  drive timers deterministically;
- per-frame multi-player input bytes are length-prefixed per player rather
  than split evenly, so variable-size inputs work with shared endpoints;
- malformed remote data (bad sequence, undecodable compression) drops the
  packet instead of panicking.

A seeded run sends the JAX package's datagrams byte for byte, in the same
order, and raises the same events at the same clock readings: a JAX peer and
a port peer play one match.
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, Generic, Hashable, List, Optional, Sequence, Tuple, TypeVar

from ..core.config import Config
from ..core.frame_info import PlayerInput
from ..core.time_sync import TimeSync
from ..core.types import DesyncDetection, Frame, NULL_FRAME, PlayerHandle
from ..core.errors import StatsUnavailable
from .messages import (
    ChecksumReport,
    ConnectionStatus,
    InputAck,
    InputMessage,
    KeepAlive,
    Message,
    QualityReply,
    QualityReport,
    SyncReply,
    SyncRequest,
)
from .endpoint import make_endpoint_core
from .messages import RawMessage, encode_input_ack, parse_input_ack_frame
from .sockets import NonBlockingSocket
from .stats import NetworkStats
from .wire import WireError, Writer
from ..obs.registry import default_registry

I = TypeVar("I")
A = TypeVar("A", bound=Hashable)

# dropped-packet accounting by reason, process-wide (endpoints are built
# below the session); observational only
_OBS_DROPPED = default_registry().counter(
    "ggrs_protocol_dropped_packets_total",
    "received datagrams dropped instead of applied, by reason",
    labels=("reason",),
)
_DROP_UNDECODABLE = _OBS_DROPPED.labels(reason="undecodable")
_DROP_MALFORMED = _OBS_DROPPED.labels(reason="malformed")
_DROP_BAD_FRAME = _OBS_DROPPED.labels(reason="malformed_frame")
_DROP_BAD_INPUT = _OBS_DROPPED.labels(reason="undecodable_input")
# send windows rewound on a peer's regressive acks, and rewinds refused
# because the sent-payload ring no longer reached back to the requested base
_OBS_REWINDS = default_registry().counter(
    "ggrs_protocol_send_rewinds_total",
    "send windows rewound to a peer's regressed ack frame",
)
_OBS_REWIND_MISSES = default_registry().counter(
    "ggrs_protocol_send_rewind_misses_total",
    "send-window rewinds refused (sent ring too short)",
)

UDP_HEADER_SIZE = 28  # IP + UDP header bytes, for bandwidth estimation
UDP_SHUTDOWN_TIMER_MS = 5000
PENDING_OUTPUT_SIZE = 128
# Send-window rewind.  A peer that resumed from its durable journal holds LESS input history than it
# acked before dying; its post-resume acks therefore REGRESS below our
# send base, and delta-encoded packets against the old base can never
# decode there again.  REWIND_ACK_THRESHOLD identical consecutive
# regressive acks (impossible from mere reordering, where newer acks
# interleave) trigger a rebase to the regressed frame from the sent
# ring — REWIND_RING_FRAMES of recently pushed payloads.  A spurious
# rewind is self-healing: the receiver dup-skips and re-acks its true
# watermark, advancing the base right back.
REWIND_ACK_THRESHOLD = 3
REWIND_RING_FRAMES = 512
# rate limit for re-acking the true receive watermark on undecodable input
# packets (the other half of the seam: an adopted endpoint tells the peer
# where its ring actually ends)
NACK_INTERVAL_MS = 50
RUNNING_RETRY_INTERVAL_MS = 200
KEEP_ALIVE_INTERVAL_MS = 200
QUALITY_REPORT_INTERVAL_MS = 200
MAX_CHECKSUM_HISTORY_SIZE = 32
# opt-in handshake (sync_required=True): round trips to confirm + retry cadence
NUM_SYNC_PACKETS = 5
SYNC_RETRY_INTERVAL_MS = 200
# how long to probe for a peer that hasn't appeared before giving up —
# deliberately generous (peers may spend tens of seconds starting up; that is
# what the handshake exists to tolerate) but bounded, so a dead address still
# surfaces a Disconnected event the application can act on
DEFAULT_SYNC_TIMEOUT_MS = 60_000


def draw_magic(rng: random.Random) -> int:
    """One endpoint wire-magic draw: a nonzero u16, drawn as the JAX package
    draws it, so that a seeded ``with_rng`` gives both packages' endpoints
    the same magic numbers."""
    magic = 0
    while magic == 0:
        magic = rng.randrange(0, 1 << 16)
    return magic


def monotonic_ms() -> int:
    return int(time.monotonic() * 1000)


# ---------------------------------------------------------------------------
# Protocol events (reference: protocol.rs:98-114)
# ---------------------------------------------------------------------------


@dataclass(slots=True)
class EvInput(Generic[I]):
    input: PlayerInput[I]
    player: PlayerHandle


@dataclass
class EvDisconnected:
    pass


@dataclass
class EvNetworkInterrupted:
    disconnect_timeout: int  # ms until disconnect


@dataclass
class EvNetworkResumed:
    pass


@dataclass
class EvSynchronizing:
    """Handshake progress (only with ``sync_required=True``)."""

    total: int
    count: int


@dataclass
class EvSynchronized:
    pass


ProtocolEvent = (
    EvInput
    | EvDisconnected
    | EvNetworkInterrupted
    | EvNetworkResumed
    | EvSynchronizing
    | EvSynchronized
)


class _State:
    SYNCHRONIZING = "synchronizing"
    RUNNING = "running"
    DISCONNECTED = "disconnected"
    SHUTDOWN = "shutdown"


def _encode_player_bytes(per_player: Sequence[bytes]) -> bytes:
    w = Writer()
    for b in per_player:
        w.bytes(b)
    return w.finish()


def encode_local_inputs(config: Config, inputs) -> Tuple[Frame, bytes]:
    """(frame, joined per-player payload) for one tick's local inputs: the
    single definition of the wire payload layout, shared by
    ``PeerProtocol.send_input`` and the session's encode-once-per-tick
    path."""
    frame: Frame = NULL_FRAME
    per_player: List[bytes] = []
    encode = config.input_encode
    for handle in sorted(inputs.keys()):
        pi = inputs[handle]
        assert frame == NULL_FRAME or pi.frame == NULL_FRAME or frame == pi.frame
        if pi.frame != NULL_FRAME:
            frame = pi.frame
        per_player.append(encode(pi.input))
    return frame, _encode_player_bytes(per_player)


def _decode_player_bytes(data: bytes, expected_players: int) -> Optional[List[bytes]]:
    """Split one frame's payload into per-player byte strings (inlined
    uvarint parse — this runs for every received frame; same semantics as
    Reader.bytes ``expected_players`` times + expect_end, with any
    malformation returning None)."""
    out: List[bytes] = []
    pos = 0
    n = len(data)
    for _ in range(expected_players):
        length = 0
        shift = 0
        while True:
            if pos >= n or shift > 63:
                return None
            b = data[pos]
            pos += 1
            length |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        end = pos + length
        if end > n:
            return None
        out.append(data[pos:end])
        pos = end
    if pos != n:
        return None
    return out


class PeerProtocol(Generic[I, A]):
    """The reliability endpoint for one remote address.

    By default it starts in RUNNING with no sync handshake, exactly like the
    reference fork (fork delta #4, protocol.rs:117-121).  With
    ``sync_required=True`` it starts in SYNCHRONIZING and completes
    ``NUM_SYNC_PACKETS`` nonce-echo round trips before entering RUNNING —
    the upstream GGRS/GGPO behavior the fork removed, restored as an opt-in
    because a handshake-free stream cannot distinguish a slow-starting peer
    from a dead one (no input flows until both ends exist, so the disconnect
    timers misfire; see SURVEY fork delta #4 note).  While synchronizing:
    inputs are neither sent nor required, disconnect timers are paused, and
    incoming Sync messages are always answered so the two ends can come up
    in any order."""

    def __init__(
        self,
        config: Config,
        handles: List[PlayerHandle],
        peer_addr: A,
        num_players: int,
        local_players: int,
        max_prediction: int,
        disconnect_timeout_ms: int,
        disconnect_notify_start_ms: int,
        fps: int,
        desync_detection: DesyncDetection,
        clock: Callable[[], int] = monotonic_ms,
        rng: Optional[random.Random] = None,
        sync_required: bool = False,
        sync_timeout_ms: int = DEFAULT_SYNC_TIMEOUT_MS,
    ) -> None:
        self._config = config
        self.handles = sorted(handles)
        self.peer_addr = peer_addr
        self._num_players = num_players
        self._local_players = local_players
        self._max_prediction = max_prediction
        self._disconnect_timeout = disconnect_timeout_ms
        self._disconnect_notify_start = disconnect_notify_start_ms
        self._fps = fps
        self.desync_detection = desync_detection
        self._clock = clock

        rng = rng if rng is not None else random.Random()
        self.magic = draw_magic(rng)

        self._send_queue: Deque[Tuple[Message, int]] = deque()  # (msg, encoded size)
        self._event_queue: Deque[ProtocolEvent] = deque()

        self._rng = rng
        self._state = _State.SYNCHRONIZING if sync_required else _State.RUNNING
        now = clock()
        self._last_quality_report_time = now
        self._last_input_recv_time = now
        self._disconnect_notify_sent = False
        self._disconnect_event_sent = False
        self._shutdown_timeout = now
        self._sync_remaining = NUM_SYNC_PACKETS
        self._sync_random = 0
        self._last_sync_request_time: Optional[int] = None
        self._sync_timeout = sync_timeout_ms
        self._sync_deadline = now + sync_timeout_ms

        self.peer_connect_status: List[ConnectionStatus] = [
            ConnectionStatus() for _ in range(num_players)
        ]

        # the per-tick datapath: pending-output window + its delta base,
        # received-input ring + decode base, datagram build/decode; native
        # (C++) unless the caller switched it off, wire-identical either way
        # (net/endpoint.py)
        default_bytes = config.input_encode(config.input_default())
        self._default_send_base = _encode_player_bytes(
            [default_bytes] * local_players
        )
        self._core = make_endpoint_core(
            send_base=self._default_send_base,
            recv_base=_encode_player_bytes(
                [default_bytes] * len(self.handles)
            ),
            max_prediction=max_prediction,
        )
        self._last_recv_frame: Frame = NULL_FRAME  # mirror of core state
        # fused-datagram receive (native core only; None: the object path)
        self._fused_recv = getattr(self._core, "handle_input_datagram", None)
        # send-window rewind state: a ring of
        # recently pushed payloads by frame, and the regressive-ack
        # detector (see REWIND_ACK_THRESHOLD above)
        self._sent_ring: Dict[Frame, bytes] = {}
        self._sent_tip: Frame = NULL_FRAME
        self._regress_ack: Optional[Frame] = None
        self._regress_count = 0
        self._last_nack_time = now - NACK_INTERVAL_MS
        # nacking undecodable inputs is ADOPTION-ONLY: a fresh endpoint's
        # drops are malformed or hostile packets whose pinned semantic is
        # silence (the native bank drops them silently: wire parity); only
        # a mid-stream resume can create the missing-base case the nack is for
        self._nack_on_drop = False

        self._time_sync = TimeSync()
        self.local_frame_advantage = 0
        self.remote_frame_advantage = 0

        self._stats_start_time = now
        self._packets_sent = 0
        self._bytes_sent = 0
        self._round_trip_time = 0
        self._last_send_time = now
        self._last_recv_time = now

        self.pending_checksums: Dict[Frame, int] = {}

    # ------------------------------------------------------------------
    # state queries
    # ------------------------------------------------------------------

    def is_running(self) -> bool:
        return self._state == _State.RUNNING

    def is_synchronizing(self) -> bool:
        return self._state == _State.SYNCHRONIZING

    def is_handling_message(self, addr: A) -> bool:
        return self.peer_addr == addr

    def average_frame_advantage(self) -> int:
        return self._time_sync.average_frame_advantage()

    def network_stats(self) -> NetworkStats:
        """Raises StatsUnavailable before any time has elapsed or when not
        running (reference: protocol.rs:271-293)."""
        if self._state != _State.RUNNING:
            raise StatsUnavailable()
        seconds = (self._clock() - self._stats_start_time) // 1000
        if seconds == 0:
            raise StatsUnavailable()
        total_bytes_sent = self._bytes_sent + self._packets_sent * UDP_HEADER_SIZE
        bps = total_bytes_sent // seconds
        return NetworkStats(
            ping=self._round_trip_time,
            send_queue_len=self._core.pending_len(),
            kbps_sent=bps // 1024,
            local_frames_behind=self.local_frame_advantage,
            remote_frames_behind=self.remote_frame_advantage,
        )

    def disconnect(self) -> None:
        if self._state == _State.SHUTDOWN:
            return
        self._state = _State.DISCONNECTED
        self._shutdown_timeout = self._clock() + UDP_SHUTDOWN_TIMER_MS

    # ------------------------------------------------------------------
    # frame advantage (reference: protocol.rs:260-269)
    # ------------------------------------------------------------------

    def update_local_frame_advantage(self, local_frame: Frame) -> None:
        if local_frame == NULL_FRAME or self.last_recv_frame() == NULL_FRAME:
            return
        ping = self._round_trip_time // 2
        remote_frame = self.last_recv_frame() + (ping * self._fps) // 1000
        self.local_frame_advantage = remote_frame - local_frame

    # ------------------------------------------------------------------
    # poll: timers (reference: protocol.rs:329-376)
    # ------------------------------------------------------------------

    def poll(self, connect_status: Sequence[ConnectionStatus]) -> List[ProtocolEvent]:
        now = self._clock()
        if self._state == _State.SYNCHRONIZING:
            # (re)send the probe; the normal timers don't run until
            # synchronized — a peer that hasn't appeared yet is not
            # "interrupted" — but the probing itself is bounded so a dead
            # address still surfaces Disconnected
            if now > self._sync_deadline:
                self._event_queue.append(EvDisconnected())
                self._disconnect_event_sent = True
                self.disconnect()
            elif (
                self._last_sync_request_time is None
                or self._last_sync_request_time + SYNC_RETRY_INTERVAL_MS < now
            ):
                self._send_sync_request()
        elif self._state == _State.RUNNING:
            # retry pending inputs if nothing moved for a while
            if self._last_input_recv_time + RUNNING_RETRY_INTERVAL_MS < now:
                self._send_pending_output(connect_status)
                self._last_input_recv_time = now

            if self._last_quality_report_time + QUALITY_REPORT_INTERVAL_MS < now:
                self._send_quality_report()

            if self._last_send_time + KEEP_ALIVE_INTERVAL_MS < now:
                self._queue_message(KeepAlive())

            if (
                not self._disconnect_notify_sent
                and self._last_recv_time + self._disconnect_notify_start < now
            ):
                remaining = self._disconnect_timeout - self._disconnect_notify_start
                self._event_queue.append(EvNetworkInterrupted(remaining))
                self._disconnect_notify_sent = True

            if (
                not self._disconnect_event_sent
                and self._last_recv_time + self._disconnect_timeout < now
            ):
                self._event_queue.append(EvDisconnected())
                self._disconnect_event_sent = True
        elif self._state == _State.DISCONNECTED:
            if self._shutdown_timeout < now:
                self._state = _State.SHUTDOWN

        events = list(self._event_queue)
        self._event_queue.clear()
        return events

    # ------------------------------------------------------------------
    # sending
    # ------------------------------------------------------------------

    def send_all_messages(self, socket: NonBlockingSocket) -> None:
        if self._state == _State.SHUTDOWN:
            self._send_queue.clear()
            return
        while self._send_queue:
            msg, _size = self._send_queue.popleft()
            socket.send_to(msg, self.peer_addr)

    def send_input(
        self,
        inputs: Dict[PlayerHandle, PlayerInput[I]],
        connect_status: Sequence[ConnectionStatus],
    ) -> None:
        """Queue this frame's local inputs and (re)send everything unacked
        (reference: protocol.rs:421-487)."""
        if self._state != _State.RUNNING:
            return

        frame, payload = encode_local_inputs(self._config, inputs)
        self.send_encoded_input(frame, payload, connect_status)

    def send_encoded_input(
        self,
        frame: Frame,
        payload: bytes,
        connect_status: Sequence[ConnectionStatus],
    ) -> None:
        """``send_input`` with the per-player payload already joined — a
        session with several remote endpoints encodes its local inputs once
        and hands every endpoint the same bytes."""
        if self._state != _State.RUNNING:
            return

        self._time_sync.advance_frame(
            frame, self.local_frame_advantage, self.remote_frame_advantage
        )

        pending = self._core.push_input(frame, payload)
        self._remember_sent(frame, payload)
        # A peer that never acks 128 inputs is a stuck spectator: disconnect
        # (reference: protocol.rs:441-445).
        if pending > PENDING_OUTPUT_SIZE:
            self._event_queue.append(EvDisconnected())

        self._send_pending_output(connect_status)

    def _remember_sent(self, frame: Frame, payload: bytes) -> None:
        """Keep recently pushed payloads beyond the ack horizon: a
        journal-resumed peer may regress its acks below our base, and the
        rewind re-pushes from this ring (the core drops acked payloads)."""
        self._sent_ring[frame] = payload
        if frame > self._sent_tip:
            self._sent_tip = frame
        if len(self._sent_ring) > REWIND_RING_FRAMES + 64:
            cutoff = self._sent_tip - REWIND_RING_FRAMES
            for f in [f for f in self._sent_ring if f < cutoff]:
                del self._sent_ring[f]

    def _send_pending_output(self, connect_status: Sequence[ConnectionStatus]) -> None:
        data = self._core.emit_input(
            self.magic,
            connect_status,
            self._state == _State.DISCONNECTED,
        )
        if data is None:
            return  # nothing pending
        self._queue_raw(data)

    def _send_sync_request(self) -> None:
        # The nonce is per ROUND TRIP, not per send: a retry re-sends the
        # same nonce, so a reply that took longer than the retry interval
        # still completes the round (regenerating per send would livelock
        # any link with RTT > SYNC_RETRY_INTERVAL_MS — every reply would
        # look stale).  _on_sync_reply zeroes the nonce to start a new round.
        if self._sync_random == 0:
            # self._rng is always set (__init__ normalizes None to a fresh
            # random.Random before assigning it)
            self._sync_random = self._rng.randrange(1, 1 << 32)
        self._last_sync_request_time = self._clock()
        self._queue_message(SyncRequest(random=self._sync_random))

    def _send_quality_report(self) -> None:
        self._last_quality_report_time = self._clock()
        advantage = max(-32768, min(32767, self.local_frame_advantage))
        self._queue_message(QualityReport(frame_advantage=advantage, ping=self._clock()))

    def send_checksum_report(self, frame: Frame, checksum: int) -> None:
        self._queue_message(ChecksumReport(checksum=checksum, frame=frame))

    def _queue_message(self, body) -> None:
        msg = Message(magic=self.magic, body=body)
        size = len(msg.encode())
        self._packets_sent += 1
        self._last_send_time = self._clock()
        self._bytes_sent += size
        self._send_queue.append((msg, size))

    def _queue_raw(self, data: bytes) -> None:
        """Queue a datagram whose wire bytes are already built (endpoint
        core emissions and the per-packet input ack)."""
        self._packets_sent += 1
        self._last_send_time = self._clock()
        self._bytes_sent += len(data)
        self._send_queue.append((RawMessage(data), len(data)))

    # ------------------------------------------------------------------
    # receiving (reference: protocol.rs:534-682)
    # ------------------------------------------------------------------

    def _mark_alive(self) -> None:
        """Record inbound traffic for the disconnect timers; emit the
        resume event when an interruption warning is standing.  The single
        definition behind every receive entry (object, inline-ack)."""
        self._last_recv_time = self._clock()
        if self._disconnect_notify_sent and self._state == _State.RUNNING:
            self._disconnect_notify_sent = False
            self._event_queue.append(EvNetworkResumed())

    def _handle_ack(self, ack_frame: Frame) -> None:
        """Apply a peer ack, watching for the journal-resume signature:
        REWIND_ACK_THRESHOLD identical consecutive acks strictly below our
        last-acked frame mean the peer genuinely lost input history (its
        process died and it resumed from the durable journal) — rebase the
        send window there so our deltas decode again.  Plain reordering
        can't trip this: interleaved current acks reset the counter."""
        la = self._core.last_acked_frame()
        if la != NULL_FRAME and ack_frame < la:
            if ack_frame == self._regress_ack:
                self._regress_count += 1
                if self._regress_count >= REWIND_ACK_THRESHOLD:
                    self._regress_count = 0
                    if self._rewind_send_window(ack_frame):
                        _OBS_REWINDS.inc()
                    else:
                        _OBS_REWIND_MISSES.inc()
            else:
                self._regress_ack = ack_frame
                self._regress_count = 1
            return  # regressive: the core's ack() would be a no-op
        self._regress_ack = None
        self._regress_count = 0
        self._core.ack(ack_frame)

    def _rewind_send_window(self, ack_frame: Frame) -> bool:
        """Rebase the send window to ``ack_frame`` from the sent ring:
        clear pending, reseed the delta base, re-push every later frame.
        False when the ring no longer reaches back that far: the caller
        counts the miss."""
        tip = self._sent_tip
        if tip == NULL_FRAME:
            return False
        first = 0 if ack_frame == NULL_FRAME else ack_frame + 1
        if first > tip + 1:
            return False  # peer claims MORE than we ever sent: not ours
        base = (
            self._default_send_base if ack_frame == NULL_FRAME
            else self._sent_ring.get(ack_frame)
        )
        if base is None:
            return False
        repush = []
        for f in range(first, tip + 1):
            p = self._sent_ring.get(f)
            if p is None:
                return False
            repush.append((f, p))
        self._core.rewind_send(ack_frame, base)
        for f, p in repush:
            self._core.push_input(f, p)
        return True

    def handle_message(self, msg: Message) -> None:
        if self._state == _State.SHUTDOWN:
            return

        self._mark_alive()

        body = msg.body
        if isinstance(body, SyncRequest):
            # always answer, in any live state: the two ends may come up in
            # either order, and a running endpoint must still echo probes so
            # a restarted/slow peer can finish its own handshake
            self._queue_message(SyncReply(random=body.random))
        elif isinstance(body, SyncReply):
            self._on_sync_reply(body)
        elif isinstance(body, InputMessage):
            self._on_input(body)
        elif isinstance(body, InputAck):
            self._handle_ack(body.ack_frame)
        elif isinstance(body, QualityReport):
            self.remote_frame_advantage = body.frame_advantage
            self._queue_message(QualityReply(pong=body.ping))
        elif isinstance(body, QualityReply):
            now = self._clock()
            if now >= body.pong:
                self._round_trip_time = now - body.pong
        elif isinstance(body, ChecksumReport):
            self._on_checksum_report(body)
        elif isinstance(body, KeepAlive):
            pass

    def _on_sync_reply(self, body) -> None:
        if self._state != _State.SYNCHRONIZING:
            return  # late/duplicate reply after sync completed
        if body.random != self._sync_random or self._sync_random == 0:
            return  # stale reply to an earlier round: ignore
        self._sync_random = 0  # round complete; next send starts a new one
        self._sync_remaining -= 1
        # progress extends the deadline: the timeout bounds true silence, not
        # total handshake duration (5 round trips on a high-RTT link may
        # legitimately take longer than one timeout)
        self._sync_deadline = self._clock() + self._sync_timeout
        self._event_queue.append(
            EvSynchronizing(
                total=NUM_SYNC_PACKETS,
                count=NUM_SYNC_PACKETS - self._sync_remaining,
            )
        )
        if self._sync_remaining == 0:
            self._state = _State.RUNNING
            self._event_queue.append(EvSynchronized())
            # timers start fresh from the moment the link is proven live
            now = self._clock()
            self._last_input_recv_time = now
            self._last_quality_report_time = now
            self._stats_start_time = now
        else:
            self._send_sync_request()  # next round trip immediately

    def _on_input(self, body: InputMessage) -> None:
        self._handle_ack(body.ack_frame)

        if body.disconnect_requested:
            if self._state != _State.DISCONNECTED and not self._disconnect_event_sent:
                self._event_queue.append(EvDisconnected())
                self._disconnect_event_sent = True
        else:
            if len(body.peer_connect_status) != len(self.peer_connect_status):
                return  # malformed: drop
            for theirs in body.peer_connect_status:
                # beyond the i64 wire contract (only reachable through the
                # unbounded Python varint reader): malformed, drop before
                # the merge can poison session state
                if not -(1 << 63) <= theirs.last_frame < (1 << 63):
                    return
            for ours, theirs in zip(self.peer_connect_status, body.peer_connect_status):
                ours.disconnected = theirs.disconnected or ours.disconnected
                ours.last_frame = max(ours.last_frame, theirs.last_frame)

        # The core peeks: sequence-gap / missing-base / undecodable packets
        # come back as None and are silently dropped (reference asserts on
        # the gap, protocol.rs:588-590; we drop instead of crashing).
        staged = self._core.on_input(body.start_frame, body.bytes)
        if staged is None:
            self._nack_current()
            return
        self._finish_input(staged)

    def _finish_input(self, staged) -> None:
        """Validate, commit, and surface the frames staged by the core's
        receive peek (shared by the object path and the fused-datagram
        path)."""
        first_new, payloads = staged

        # validate ALL inner framing before committing, so a packet with any
        # malformed frame is dropped whole with no state advance (an honest
        # peer can never produce one; see endpoint.py docstring)
        n_handles = len(self.handles)
        decoded_inputs: List[List] = []
        for frame_payload in payloads:
            per_player = _decode_player_bytes(frame_payload, n_handles)
            if per_player is None:
                _DROP_BAD_FRAME.inc()
                return  # malformed inner framing: drop the packet
            try:
                decoded_inputs.append(
                    [self._config.input_decode(b) for b in per_player]
                )
            except Exception:
                _DROP_BAD_INPUT.inc()
                return  # undecodable input payload: drop the packet

        self._core.commit()
        if payloads:
            self._last_recv_frame = first_new + len(payloads) - 1
        self._last_input_recv_time = self._clock()

        handles = self.handles
        events = self._event_queue
        for i, player_inputs in enumerate(decoded_inputs):
            frame = first_new + i
            for handle, value in zip(handles, player_inputs):
                events.append(EvInput(PlayerInput(frame, value), handle))

        # ack what we have now (hand-built bytes: this runs once per
        # received input packet)
        self._queue_raw(encode_input_ack(self.magic, self._last_recv_frame))

    def _decode_and_dispatch(self, data: bytes) -> None:
        """The object path for raw datagrams: decode, silently dropping
        anything undecodable (reference: udp_socket.rs:70-72)."""
        try:
            msg = Message.decode(data)
        except WireError:
            _DROP_UNDECODABLE.inc()
            return
        self.handle_message(msg)

    def handle_datagram(self, data: bytes) -> None:
        """Receive entry for raw datagram bytes.  An InputAck is parsed
        inline (the hottest datagram); input packets take the native core's
        fused path (ONE crossing: parse + ack + decode + stage); everything
        else, and every packet when the Python core runs, goes through
        ``Message.decode`` + ``handle_message``.  Undecodable datagrams are
        dropped silently (reference: udp_socket.rs:70-72)."""
        if self._state == _State.SHUTDOWN:
            return
        ack = parse_input_ack_frame(data)
        if ack is not None:
            self._mark_alive()
            self._handle_ack(ack)
            return
        fused = self._fused_recv
        if fused is None or len(data) < 3 or data[2] != 0:  # 0 = input tag
            self._decode_and_dispatch(data)
            return
        res = fused(data)
        if res == "fallback":
            self._decode_and_dispatch(data)
            return
        if res is None:
            _DROP_MALFORMED.inc()
            return  # malformed: dropped whole, nothing applied
        self._mark_alive()
        disconnect_requested, (n_status, disc, frames), staged = res
        if disconnect_requested:
            if self._state != _State.DISCONNECTED and not self._disconnect_event_sent:
                self._event_queue.append(EvDisconnected())
                self._disconnect_event_sent = True
        else:
            pcs = self.peer_connect_status
            if n_status != len(pcs):
                return  # malformed: drop
            for i in range(n_status):
                ours = pcs[i]
                if disc[i]:
                    ours.disconnected = True
                last_frame = frames[i]
                if last_frame > ours.last_frame:
                    ours.last_frame = last_frame
        if staged is not None:
            self._finish_input(staged)
        else:
            # an input packet whose base our ring lacks (or a gap): tell the
            # peer where our ring actually ends
            self._nack_current()

    def _nack_current(self) -> None:
        """An input packet arrived that cannot delta-decode against our
        ring (the endpoint was adopted mid-stream and holds less than the
        peer believes): re-ack the true receive watermark, rate-limited, so
        the peer's regressive-ack detector rewinds its send base to us."""
        if not self._nack_on_drop:
            return  # fresh endpoint: silent drop is the pinned semantic
        now = self._clock()
        if now - self._last_nack_time < NACK_INTERVAL_MS:
            return
        self._last_nack_time = now
        self._queue_raw(encode_input_ack(self.magic, self._last_recv_frame))

    # -- adoption (the host bank's eviction seam) ----------------------------

    def adopt_endpoint_state(
        self,
        *,
        magic: int,
        running: bool,
        peer_connect_status: Sequence[Tuple[bool, Frame]],
        last_recv_frame: Frame,
        recv_entries: Sequence[Tuple[Frame, bytes]],
        last_acked_frame: Frame,
        send_base: bytes,
        pending: Sequence[Tuple[Frame, bytes]],
        pending_checksums: Optional[Dict[Frame, int]] = None,
    ) -> None:
        """Adopt a mid-stream endpoint's peer-visible state: a faulted
        native-bank slot resumes as a Python session, and the peer must see a
        retransmission hiccup, not a brand-new endpoint.

        Adopted: the wire magic, the connect-status mirror, the un-acked
        pending-output window with its delta base (the 200 ms retry timer
        resends it, closing the peer's sequence gap), and the received-frame
        ring in-flight packets delta-decode against.  NOT adopted: timers,
        RTT and the time-sync windows; liveness restarts from ``now`` and the
        advantage estimate re-converges within one FRAME_WINDOW."""
        self.magic = magic
        self._nack_on_drop = True
        for ours, (disc, lf) in zip(self.peer_connect_status, peer_connect_status):
            ours.disconnected = bool(disc)
            ours.last_frame = lf
        self._core.seed_recv(last_recv_frame, recv_entries)
        self._last_recv_frame = last_recv_frame
        self._core.seed_send(last_acked_frame, send_base)
        if last_acked_frame != NULL_FRAME:
            self._remember_sent(last_acked_frame, send_base)
        for frame, payload in pending:
            self._core.push_input(frame, payload)
            self._remember_sent(frame, payload)
        if pending_checksums:
            self.pending_checksums = dict(pending_checksums)
        if running:
            # self-contained even for a sync_required endpoint: the adopted
            # peer already proved itself live mid-match, so no re-handshake
            self._state = _State.RUNNING
        else:
            self.disconnect()

    def _on_checksum_report(self, body: ChecksumReport) -> None:
        interval = self.desync_detection.interval if self.desync_detection.enabled else 1
        if len(self.pending_checksums) >= MAX_CHECKSUM_HISTORY_SIZE:
            oldest_to_keep = body.frame - (MAX_CHECKSUM_HISTORY_SIZE - 1) * interval
            self.pending_checksums = {
                f: c for f, c in self.pending_checksums.items() if f >= oldest_to_keep
            }
        self.pending_checksums[body.frame] = body.checksum

    def last_recv_frame(self) -> Frame:
        # cached: this is called several times per received message, and
        # max() over the ring dict showed up in the session-loop profile
        return self._last_recv_frame
