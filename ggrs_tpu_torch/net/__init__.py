from .compression import CodecError, decode, encode
from .messages import (
    ChecksumReport,
    ConnectionStatus,
    InputAck,
    InputMessage,
    KeepAlive,
    Message,
    QualityReply,
    QualityReport,
)
from .protocol import (
    EvDisconnected,
    EvInput,
    EvNetworkInterrupted,
    EvNetworkResumed,
    PeerProtocol,
    ProtocolEvent,
)
from .sockets import (
    FakeSocket,
    IDEAL_MAX_UDP_PACKET_SIZE,
    InMemoryNetwork,
    NonBlockingSocket,
    UdpNonBlockingSocket,
)
from .stats import NetworkStats
from .wire import Reader, WireError, Writer

__all__ = [
    "ChecksumReport",
    "CodecError",
    "ConnectionStatus",
    "EvDisconnected",
    "EvInput",
    "EvNetworkInterrupted",
    "EvNetworkResumed",
    "FakeSocket",
    "IDEAL_MAX_UDP_PACKET_SIZE",
    "InMemoryNetwork",
    "InputAck",
    "InputMessage",
    "KeepAlive",
    "Message",
    "NetworkStats",
    "NonBlockingSocket",
    "PeerProtocol",
    "ProtocolEvent",
    "QualityReply",
    "QualityReport",
    "Reader",
    "UdpNonBlockingSocket",
    "WireError",
    "Writer",
    "decode",
    "encode",
]
