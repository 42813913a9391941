"""Wire message vocabulary (the port's copy of ``ggrs_tpu/net/messages.py``;
reference: GGRS src/network/messages.rs).

Message = header {magic: u16} + body, where body is one of Input / InputAck /
QualityReport / QualityReply / ChecksumReport / KeepAlive.  As in the
reference fork, the magic is carried but not verified on receive — routing is
purely by source address (reference: p2p_session.rs:433-440); it is kept for
wire-format parity and debugging.

``Message.encode`` and ``Message.decode`` route through the native framing
fast path (``csrc/host/codec.cpp``) as the JAX package's do; the Python writer
and reader here are that package's, byte for byte, and remain the reference
and the path for packets whose varints exceed u64.  A JAX peer and a port
peer read each other's datagrams.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Union

from ..core.types import Frame, NULL_FRAME
from . import _native
from .wire import Reader, WireError, Writer


@dataclass(slots=True)
class ConnectionStatus:
    """Per-player connection knowledge piggybacked on every Input message
    (reference: messages.rs:5-18)."""

    disconnected: bool = False
    last_frame: Frame = NULL_FRAME


@dataclass(slots=True)
class InputMessage:
    """Redundant batch of all unacked inputs, delta+RLE compressed
    (reference: messages.rs:20-39)."""

    peer_connect_status: List[ConnectionStatus] = field(default_factory=list)
    disconnect_requested: bool = False
    start_frame: Frame = NULL_FRAME
    ack_frame: Frame = NULL_FRAME
    bytes: bytes = b""


@dataclass(slots=True)
class InputAck:
    ack_frame: Frame = NULL_FRAME


@dataclass(slots=True)
class QualityReport:
    """frame_advantage is i16, not i8: long pauses (debugger, background tab)
    can push it past +/-127 at common FPS (reference rationale:
    messages.rs:77-93).  ``ping`` is a millisecond timestamp echoed back."""

    frame_advantage: int = 0
    ping: int = 0


@dataclass(slots=True)
class QualityReply:
    pong: int = 0


@dataclass(slots=True)
class ChecksumReport:
    checksum: int = 0
    frame: Frame = NULL_FRAME


@dataclass(slots=True)
class KeepAlive:
    pass


@dataclass(slots=True)
class SyncRequest:
    """Handshake probe (opt-in; see PeerProtocol ``sync_required``).  The
    reference fork removed the handshake entirely (fork delta #4); upstream
    GGRS/GGPO carries a random nonce echoed by the reply so stale replies
    can't complete a new handshake."""

    random: int = 0


@dataclass(slots=True)
class SyncReply:
    random: int = 0


MessageBody = Union[
    InputMessage,
    InputAck,
    QualityReport,
    QualityReply,
    ChecksumReport,
    KeepAlive,
    SyncRequest,
    SyncReply,
]

_TAG_INPUT = 0
_TAG_INPUT_ACK = 1
_TAG_QUALITY_REPORT = 2
_TAG_QUALITY_REPLY = 3
_TAG_CHECKSUM_REPORT = 4
_TAG_KEEP_ALIVE = 5
_TAG_SYNC_REQUEST = 6
_TAG_SYNC_REPLY = 7

# Bound player count on decode so a malicious length prefix can't allocate
# unbounded memory.
_MAX_PLAYERS_ON_WIRE = 64


class RawMessage:
    """A message whose wire bytes are already built (the endpoint core
    emits complete datagrams).  Sockets only ever call ``encode()`` on
    outgoing messages, so this is a drop-in for ``Message`` on the send
    side."""

    __slots__ = ("data", "_decoded")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self._decoded = None

    def encode(self) -> bytes:
        return self.data

    # lazy introspection (tests / debugging peek at queued messages; the
    # hot path never touches these)
    def _decode(self) -> "Message":
        if self._decoded is None:
            self._decoded = Message.decode(self.data)
        return self._decoded

    @property
    def magic(self) -> int:
        return self._decode().magic

    @property
    def body(self) -> "MessageBody":
        return self._decode().body

    def __repr__(self) -> str:  # pragma: no cover
        return f"RawMessage({len(self.data)} bytes)"


def parse_input_ack_frame(data: bytes) -> "int | None":
    """Fast parse of an InputAck datagram's ack_frame (LEB128 + zigzag,
    identical to Reader.svarint).  Returns None for anything irregular —
    the caller falls through to the generic decoder, which owns the exact
    error behavior.  Shared by Message.decode and the protocol's raw
    datagram path so the hot parse exists exactly once."""
    n = len(data)
    if n < 4 or n > 13 or data[2] != _TAG_INPUT_ACK:
        return None
    result = 0
    shift = 0
    pos = 3
    while pos < n and shift <= 63:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            if pos == n:  # no trailing bytes
                return (result >> 1) ^ -(result & 1)
            return None
        shift += 7
    return None


def encode_input_ack(magic: int, ack_frame: int) -> bytes:
    """Wire bytes of ``Message(magic, InputAck(ack_frame))`` without the
    object round trip — the ack is sent for every received input packet, so
    it is the hottest small message."""
    z = (ack_frame << 1) ^ (ack_frame >> 63) if ack_frame >= 0 else (
        (-ack_frame << 1) - 1
    )
    out = bytearray((magic & 0xFF, (magic >> 8) & 0xFF, _TAG_INPUT_ACK))
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    return bytes(out)


@dataclass(slots=True)
class Message:
    """The unit a NonBlockingSocket sends/receives."""

    magic: int
    body: MessageBody
    # memoized wire bytes (see encode); excluded from equality/repr
    _encoded: "bytes | None" = field(
        default=None, repr=False, compare=False
    )

    def encode(self) -> bytes:
        # Memoized: the protocol encodes once for byte accounting and the
        # socket encodes again on send.  Messages must not be mutated after
        # the first encode.
        cached = self._encoded
        if cached is not None:
            return cached
        fast = _native.msg_encode(self)
        if fast is not None:
            self._encoded = fast
            return fast
        w = Writer()
        w.u16(self.magic)
        b = self.body
        if isinstance(b, InputMessage):
            w.u8(_TAG_INPUT)
            w.uvarint(len(b.peer_connect_status))
            for cs in b.peer_connect_status:
                w.bool(cs.disconnected)
                w.svarint(cs.last_frame)
            w.bool(b.disconnect_requested)
            w.svarint(b.start_frame)
            w.svarint(b.ack_frame)
            w.bytes(b.bytes)
        elif isinstance(b, InputAck):
            w.u8(_TAG_INPUT_ACK)
            w.svarint(b.ack_frame)
        elif isinstance(b, QualityReport):
            w.u8(_TAG_QUALITY_REPORT)
            w.i16(b.frame_advantage)
            w.u64(b.ping)
        elif isinstance(b, QualityReply):
            w.u8(_TAG_QUALITY_REPLY)
            w.u64(b.pong)
        elif isinstance(b, ChecksumReport):
            w.u8(_TAG_CHECKSUM_REPORT)
            w.svarint(b.frame)
            w.u128(b.checksum)
        elif isinstance(b, KeepAlive):
            w.u8(_TAG_KEEP_ALIVE)
        elif isinstance(b, SyncRequest):
            w.u8(_TAG_SYNC_REQUEST)
            w.uvarint(b.random)
        elif isinstance(b, SyncReply):
            w.u8(_TAG_SYNC_REPLY)
            w.uvarint(b.random)
        else:  # pragma: no cover
            raise TypeError(f"unknown message body {type(b)}")
        out = w.finish()
        self._encoded = out
        return out

    @staticmethod
    def decode(data: bytes) -> "Message":
        """Decode a datagram; raises WireError on malformed data (callers drop
        undecodable packets, reference: udp_socket.rs:70-72).  Routes through
        the native framing fast path; the Python reader below is the
        reference and the path for packets whose varints exceed u64."""
        # InputAck is the hottest datagram (one per received input packet)
        # and tiny; parse it inline without the ctypes round trip
        ack = parse_input_ack_frame(data)
        if ack is not None:
            return Message(data[0] | (data[1] << 8), InputAck(ack))
        fast = _native.msg_decode(data)
        if fast is not None:
            return fast
        r = Reader(data)
        magic = r.u16()
        tag = r.u8()
        body: MessageBody
        if tag == _TAG_INPUT:
            n = r.uvarint()
            if n > _MAX_PLAYERS_ON_WIRE:
                raise WireError("too many connect statuses")
            statuses = [
                ConnectionStatus(disconnected=r.bool(), last_frame=r.svarint())
                for _ in range(n)
            ]
            body = InputMessage(
                peer_connect_status=statuses,
                disconnect_requested=r.bool(),
                start_frame=r.svarint(),
                ack_frame=r.svarint(),
                bytes=r.bytes(),
            )
        elif tag == _TAG_INPUT_ACK:
            body = InputAck(ack_frame=r.svarint())
        elif tag == _TAG_QUALITY_REPORT:
            body = QualityReport(frame_advantage=r.i16(), ping=r.u64())
        elif tag == _TAG_QUALITY_REPLY:
            body = QualityReply(pong=r.u64())
        elif tag == _TAG_CHECKSUM_REPORT:
            frame = r.svarint()
            checksum = r.u128()
            body = ChecksumReport(checksum=checksum, frame=frame)
        elif tag == _TAG_KEEP_ALIVE:
            body = KeepAlive()
        elif tag == _TAG_SYNC_REQUEST:
            body = SyncRequest(random=r.uvarint())
        elif tag == _TAG_SYNC_REPLY:
            body = SyncReply(random=r.uvarint())
        else:
            raise WireError(f"unknown message tag {tag}")
        r.expect_end()
        return Message(magic=magic, body=body)
