"""The endpoint core: the per-tick mechanism under ``PeerProtocol`` (the
port's copy of ``ggrs_tpu/net/endpoint.py``'s ``PyEndpointCore``).

``PeerProtocol`` (protocol.py) keeps the reliability *policy*: timers,
events, the state machine, connect-status merging.  The core owns the
per-tick *mechanism* of one endpoint: the unacked pending-output window with
its last-acked delta base (reference: protocol.rs:421-487), the
received-input ring that provides the decode base (reference:
protocol.rs:534-682), and the InputMessage datagram build/decode.  The JAX
package also has a C++ core; both of its cores and this one emit the same
wire bytes.

Receive flow is two-phase: ``on_input`` PEEKS (decodes and stages the new
frames), the protocol validates the inner per-player framing, then
``commit`` applies the staged frames.  A packet with any malformed inner
frame is therefore dropped whole, with no partial state advance.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

from ..core.types import Frame, NULL_FRAME
from . import compression
from .messages import (
    ConnectionStatus,
    InputMessage,
    Message,
    _MAX_PLAYERS_ON_WIRE,
)

# The wire contract for frames is i64 (the reference's Frame type).  Python's
# unbounded varint reader can surface values beyond that; such packets are
# malformed and dropped, with headroom so frame arithmetic (start_frame +
# count, start_frame - 1) stays inside i64 as the JAX package's C++ core
# requires.
_FRAME_SANE_MIN = -(1 << 62)
_FRAME_SANE_MAX = 1 << 62


class PyEndpointCore:
    """Pure-Python endpoint core."""

    def __init__(
        self, send_base: bytes, recv_base: bytes, max_prediction: int
    ) -> None:
        # outbound: all inputs the peer hasn't acked yet, as (frame, payload)
        self._pending: Deque[Tuple[Frame, bytes]] = deque()
        self._last_acked_frame: Frame = NULL_FRAME
        self._last_acked: bytes = send_base
        # inbound: received frame payloads by frame; NULL_FRAME holds the
        # zeroed decode base (reference: protocol.rs:208-209)
        self._recv: dict[Frame, bytes] = {NULL_FRAME: recv_base}
        self._last_recv: Frame = NULL_FRAME
        self._max_prediction = max_prediction
        self._staged: Optional[Tuple[Frame, List[bytes]]] = None

    # ---- send side ----

    def push_input(self, frame: Frame, payload: bytes) -> int:
        self._pending.append((frame, payload))
        return len(self._pending)

    def emit_input(
        self,
        magic: int,
        statuses: Sequence[ConnectionStatus],
        disconnect_requested: bool,
    ) -> Optional[bytes]:
        if not self._pending:
            return None
        # Wire cap (the JAX package's C++ core refuses the same way): the
        # connect-status list is uvarint-counted on the wire but capped at
        # what receivers decode, even for callers that bypass
        # SessionBuilder's player-count validation.
        if len(statuses) > _MAX_PLAYERS_ON_WIRE:
            raise RuntimeError(
                f"emit_input: {len(statuses)} connect statuses exceed the "
                f"{_MAX_PLAYERS_ON_WIRE}-entry wire cap"
            )
        first_frame = self._pending[0][0]
        if not (
            self._last_acked_frame == NULL_FRAME
            or self._last_acked_frame + 1 == first_frame
        ):
            raise RuntimeError(
                f"pending output head {first_frame} does not follow "
                f"last acked frame {self._last_acked_frame}"
            )
        body = InputMessage(
            peer_connect_status=list(statuses),
            disconnect_requested=disconnect_requested,
            start_frame=first_frame,
            ack_frame=self._last_recv,
            bytes=compression.encode(
                self._last_acked, [p for _, p in self._pending]
            ),
        )
        return Message(magic=magic, body=body).encode()

    def ack(self, ack_frame: Frame) -> None:
        while self._pending and self._pending[0][0] <= ack_frame:
            self._last_acked_frame, self._last_acked = self._pending.popleft()

    def pending_len(self) -> int:
        return len(self._pending)

    # ---- receive side ----

    def _base_for(self, start_frame: Frame) -> Optional[bytes]:
        if self._last_recv == NULL_FRAME:
            return self._recv[NULL_FRAME]
        base_frame = start_frame - 1
        # GC-cutoff at lookup time: an entry older than the window counts as
        # collected even if the physical sweep hasn't run yet
        if base_frame != NULL_FRAME and base_frame < (
            self._last_recv - 2 * self._max_prediction
        ):
            return None
        return self._recv.get(base_frame)

    def on_input(
        self, start_frame: Frame, comp: bytes
    ) -> Optional[Tuple[Frame, List[bytes]]]:
        """Peek: decode the packet and stage its NEW frames.  Returns
        ``(first_new_frame, payloads)`` (possibly ``(NULL_FRAME, [])`` for a
        pure-duplicate packet, which the caller still acks) or ``None`` when
        the packet must be silently dropped."""
        if not _FRAME_SANE_MIN <= start_frame <= _FRAME_SANE_MAX:
            return None  # beyond the i64 wire contract: malformed, drop
        lr = self._last_recv
        # a gap between what we have and where the packet starts is
        # unrecoverable — but also impossible from an honest peer, so drop
        # rather than crash (reference asserts here, protocol.rs:588-590)
        if lr != NULL_FRAME and lr + 1 < start_frame:
            return None
        base = self._base_for(start_frame)
        if base is None:
            return None
        try:
            decoded = compression.decode(base, comp)
        except compression.CodecError:
            return None  # malicious or corrupt: drop silently
        payloads: List[bytes] = []
        first_new: Frame = NULL_FRAME
        for i, fp in enumerate(decoded):
            frame = start_frame + i
            if frame <= lr:
                continue  # already have it
            if first_new == NULL_FRAME:
                first_new = frame
            payloads.append(fp)
        self._staged = (first_new, payloads)
        return self._staged

    def commit(self) -> None:
        if self._staged is None:
            return
        first_new, payloads = self._staged
        self._staged = None
        for i, fp in enumerate(payloads):
            frame = first_new + i
            self._recv[frame] = fp
            if frame > self._last_recv:
                self._last_recv = frame
        # physical GC sweep, throttled: correctness comes from the
        # lookup-time cutoff above, so the sweep only bounds memory
        if len(self._recv) > 4 * self._max_prediction + 8:
            cutoff = self._last_recv - 2 * self._max_prediction
            for f in [
                f for f in self._recv if f != NULL_FRAME and f < cutoff
            ]:
                del self._recv[f]

    def last_recv_frame(self) -> Frame:
        return self._last_recv

    def last_acked_frame(self) -> Frame:
        """Newest frame the peer has acked (obs stat surface)."""
        return self._last_acked_frame

    # ---- send-window rewind ----

    def rewind_send(self, frame: Frame, base: bytes) -> None:
        """Rewind the send window to an earlier delta base: the peer resumed
        from its durable journal and holds less than it once acked.  Drops
        the pending window; the caller re-pushes everything after ``frame``
        from its sent-payload ring."""
        self._pending.clear()
        self._last_acked_frame = frame
        self._last_acked = base


def make_endpoint_core(
    send_base: bytes, recv_base: bytes, max_prediction: int
) -> PyEndpointCore:
    """The endpoint core for one ``PeerProtocol``."""
    return PyEndpointCore(send_base, recv_base, max_prediction)
