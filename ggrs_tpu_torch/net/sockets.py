"""Transport layer: the pluggable non-blocking socket boundary (the port's
copy of ``ggrs_tpu/net/sockets.py``).

The trait boundary is the reference's (``NonBlockingSocket``, GGRS
src/lib.rs:264-279): unreliable, unordered, UDP-like datagrams; the endpoint
protocol above it provides redundancy and acks.  Besides the real UDP socket
there is an in-memory fault-injecting network (deterministic loss,
duplication, reordering, latency) whose seeded fault stream is the JAX
package's draw for draw, so a seeded run of either package makes the same
faults.
"""

from __future__ import annotations

import errno
import logging
import random
import socket as _socket
from collections import deque
from typing import Deque, Dict, Hashable, List, Optional, Protocol, Tuple, TypeVar

from .messages import Message
from .stats import NetworkStats
from .wire import WireError
from ..obs.registry import default_registry

logger = logging.getLogger(__name__)

# socket-level counters, process-wide (sockets are built below the
# session).  Observational only.
_OBS_SEND_ERRORS = default_registry().counter(
    "ggrs_socket_send_errors_total",
    "transient OS send failures swallowed as packet loss",
)
_OBS_OVERSIZED = default_registry().counter(
    "ggrs_socket_oversized_packets_total",
    "datagrams sent above the ideal fragmentation-safe UDP size",
)
# Syscall accounting: one syscall per datagram, plus the EAGAIN probe per
# drain.  Increments are batched per drain, not per datagram.
_OBS_SYSCALLS = default_registry().counter(
    "ggrs_io_syscalls_total",
    "socket syscalls by kind (sendto/recvfrom: one per datagram)",
    labels=("kind",),
)
_OBS_SENDTO = _OBS_SYSCALLS.labels(kind="sendto")
_OBS_RECVFROM = _OBS_SYSCALLS.labels(kind="recvfrom")

# Transient send failures a UDP socket can surface on Linux (often from a
# previous datagram's ICMP error): the datagram counts as lost — which the
# endpoint protocol's redundant sends already cover — instead of crashing
# the session tick.  Anything else (EBADF after close, EACCES...) is a real
# programming/configuration error and still raises.
_TRANSIENT_SEND_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "ENETUNREACH", "EHOSTUNREACH", "ECONNREFUSED", "ENETDOWN",
        "EHOSTDOWN", "ENOBUFS", "EAGAIN", "EWOULDBLOCK",
    )
    if hasattr(errno, name)
)
# NOT in the set: EMSGSIZE (datagram exceeds the path/socket limit) and
# EPERM (firewall/seccomp rejecting the destination) — deterministic local
# faults that every retransmission would hit identically; swallowing them
# would turn a configuration error into a silent stall instead of an
# actionable raise on the first send.

A = TypeVar("A", bound=Hashable)

RECV_BUFFER_SIZE = 4096
# Packets larger than this risk IP fragmentation (reference: udp_socket.rs:14).
IDEAL_MAX_UDP_PACKET_SIZE = 508


class NonBlockingSocket(Protocol[A]):
    """Send one message; receive everything that arrived since last poll.

    ``send_datagram`` is the raw sibling of ``send_to`` for callers that
    already hold encoded wire bytes: no Message wrapper, no re-encode.
    Implementations that also provide ``receive_all_datagrams`` hand the
    session raw bytes, which its endpoints decode (undecodable datagrams
    are dropped there)."""

    def send_to(self, msg: Message, addr: A) -> None: ...

    def send_datagram(self, data: bytes, addr: A) -> None: ...

    def receive_all_messages(self) -> List[Tuple[A, Message]]: ...


class UdpNonBlockingSocket:
    """Non-blocking UDP socket bound to 0.0.0.0:port
    (reference: udp_socket.rs:16-83).  Addresses are ``(host, port)`` tuples."""

    def __init__(self, port: int) -> None:
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        self._sock.bind(("0.0.0.0", port))
        self._sock.setblocking(False)
        # socket-level counters (send_errors is the live field here; the
        # per-endpoint protocol stats carry their own copy of the rest)
        self.stats = NetworkStats()
        # persistent receive buffer: the drain loop reads into this one
        # bytearray via recvfrom_into instead of allocating a fresh 4 KiB
        # bytes per datagram (the old recvfrom path's per-packet garbage)
        self._recv_buf = bytearray(RECV_BUFFER_SIZE)
        self._recv_view = memoryview(self._recv_buf)
        # per-socket syscall count (sendto + recvfrom attempts), which the
        # process-wide _OBS_SYSCALLS counters cannot isolate
        self.io_syscalls = 0
        # oversized-warning rate limit: one log line per (addr, size-class)
        # per socket; the obs counter still counts every oversized datagram
        self._oversized_warned: set = set()

    @staticmethod
    def bind_to_port(port: int) -> "UdpNonBlockingSocket":
        return UdpNonBlockingSocket(port)

    def fileno(self) -> int:
        """The bound fd: what the host bank's one-crossing send table
        (``ggrs_net_send_table``) writes to."""
        return self._sock.fileno()

    def local_port(self) -> int:
        return self._sock.getsockname()[1]

    def send_to(self, msg: Message, addr: Tuple[str, int]) -> None:
        self.send_datagram(msg.encode(), addr)

    def send_datagram(self, data: bytes, addr: Tuple[str, int]) -> None:
        """Send already-encoded wire bytes: the raw sibling of ``send_to``
        (no Message wrapper, no re-encode)."""
        if len(data) > IDEAL_MAX_UDP_PACKET_SIZE:
            # Occasional large packets usually get through; persistent ones
            # mean the input struct is too big.  Warn, don't fail, and
            # warn ONCE per (addr, size-class).
            _OBS_OVERSIZED.inc()
            key = (addr, len(data) // 512)
            if key not in self._oversized_warned:
                self._oversized_warned.add(key)
                logger.warning(
                    "Sending UDP packet of size %d bytes to %s, larger than "
                    "ideal (%d); further sends in this size class are "
                    "counted, not logged",
                    len(data),
                    addr,
                    IDEAL_MAX_UDP_PACKET_SIZE,
                )
        self.io_syscalls += 1
        _OBS_SENDTO.inc()
        try:
            self._sock.sendto(data, addr)
        except OSError as e:
            # mirror of the receive path's ConnectionResetError handling:
            # transient OS errors count as packet loss, not session death
            if e.errno not in _TRANSIENT_SEND_ERRNOS:
                raise
            self.stats.send_errors += 1
            _OBS_SEND_ERRORS.inc()
            logger.debug("UDP send to %s failed transiently: %s", addr, e)

    def send_datagram_batch(self, items: List[Tuple[bytes, Tuple[str, int]]]) -> None:
        """Flush many raw datagrams in one call: the per-datagram semantics
        are exactly ``send_datagram``'s (transient errnos count as loss and
        the flush continues; anything else raises after the datagrams
        already sent).  A host bank with the fd prefers the native send
        table; this is the portable path."""
        send = self.send_datagram
        for data, addr in items:
            send(bytes(data), addr)

    def receive_all_messages(self) -> List[Tuple[Tuple[str, int], Message]]:
        received: List[Tuple[Tuple[str, int], Message]] = []
        for src, data in self.receive_all_datagrams():
            try:
                received.append((src, Message.decode(data)))
            except WireError:
                # drop undecodable packets (reference: udp_socket.rs:70-72)
                continue
        return received

    def receive_all_datagrams(self) -> List[Tuple[Tuple[str, int], bytes]]:
        """Raw variant of ``receive_all_messages``: undecoded datagram bytes.
        Sessions prefer this; undecodable packets are then dropped at the
        endpoint instead of here (same observable behavior).  Reads land in the persistent buffer
        (``recvfrom_into``); only the datagram's actual bytes are copied
        out, preserving arrival order."""
        received: List[Tuple[Tuple[str, int], bytes]] = []
        sock = self._sock
        view = self._recv_view
        buf = self._recv_buf
        calls = 0
        while True:
            calls += 1  # every attempt is one syscall, the EAGAIN probe too
            try:
                n, src = sock.recvfrom_into(buf, RECV_BUFFER_SIZE)
            except BlockingIOError:
                break
            except ConnectionError:
                # async ICMP errors (port unreachable after a send to a
                # dead peer, reset after send_to on some OSes) surface on
                # the NEXT receive of an unconnected UDP socket — skip
                # them all; one dead peer must not kill the whole drain
                continue
            received.append((src, bytes(view[:n])))
        self.io_syscalls += calls
        _OBS_RECVFROM.inc(calls)
        return received

    def close(self) -> None:
        self._sock.close()

    def __del__(self) -> None:  # pragma: no cover
        try:
            self._sock.close()
        except Exception:
            pass


class InMemoryNetwork:
    """A hub connecting FakeSockets by address, with deterministic fault
    injection: drop probability, duplication, reordering, and fixed latency in
    delivery ticks.  Improvement over the reference's test setup (real
    loopback UDP only)."""

    def __init__(
        self,
        seed: int = 0,
        loss: float = 0.0,
        duplicate: float = 0.0,
        reorder: float = 0.0,
        latency_ticks: int = 0,
    ) -> None:
        self._rng = random.Random(seed)
        self.loss = loss
        self.duplicate = duplicate
        self.reorder = reorder
        self.latency_ticks = latency_ticks
        # address -> deque of (deliver_at_tick, from_addr, encoded_bytes)
        self._queues: Dict[Hashable, Deque[Tuple[int, Hashable, bytes]]] = {}
        self._tick = 0

    def socket(self, addr: Hashable) -> "FakeSocket":
        self._queues.setdefault(addr, deque())
        return FakeSocket(self, addr)

    def tick(self) -> None:
        """Advance simulated time by one delivery tick."""
        self._tick += 1

    def _send(self, from_addr: Hashable, to_addr: Hashable,
              payload: bytes) -> None:
        # callers pass encoded bytes (real sockets don't share references)
        q = self._queues.get(to_addr)
        if q is None:
            return  # unroutable: dropped silently, like real UDP
        if self._faultless:
            # fast path for the common perfect-link configuration: no RNG
            # draws, no reordering checks
            q.append((self._tick, from_addr, payload))
            return
        if self._rng.random() < self.loss:
            return
        deliver_at = self._tick + self.latency_ticks
        q.append((deliver_at, from_addr, payload))
        if self._rng.random() < self.duplicate:
            q.append((deliver_at, from_addr, payload))
        # the reorder random is drawn UNCONDITIONALLY so the rng stream is a
        # pure function of the send sequence: whether a receiver has drained
        # its queue yet must not perturb the fault pattern
        if self._rng.random() < self.reorder and len(q) >= 2:
            q[-1], q[-2] = q[-2], q[-1]

    @property
    def _faultless(self) -> bool:
        return (
            self.loss == 0.0
            and self.duplicate == 0.0
            and self.reorder == 0.0
            and self.latency_ticks == 0
        )

    def _receive_raw(self, addr: Hashable) -> List[Tuple[Hashable, bytes]]:
        q = self._queues.get(addr)
        out: List[Tuple[Hashable, bytes]] = []
        if not q:
            return out
        tick = self._tick
        # single pass; the requeue deque is only materialized when something
        # is actually future-dated (never, on a zero-latency link)
        remaining: Optional[Deque[Tuple[int, Hashable, bytes]]] = None
        for item in q:
            if item[0] > tick:
                if remaining is None:
                    remaining = deque()
                remaining.append(item)
                continue
            out.append((item[1], item[2]))
        if remaining is None:
            q.clear()
        else:
            self._queues[addr] = remaining
        return out

    def _receive(self, addr: Hashable) -> List[Tuple[Hashable, Message]]:
        out: List[Tuple[Hashable, Message]] = []
        for from_addr, payload in self._receive_raw(addr):
            try:
                out.append((from_addr, Message.decode(payload)))
            except WireError:
                continue
        return out


class FakeSocket:
    """A NonBlockingSocket attached to an InMemoryNetwork."""

    def __init__(self, network: InMemoryNetwork, addr: Hashable) -> None:
        self._network = network
        self.addr = addr

    def send_to(self, msg: Message, addr: Hashable) -> None:
        self._network._send(self.addr, addr, msg.encode())

    def send_datagram(self, data: bytes, addr: Hashable) -> None:
        """Raw sibling of ``send_to`` (same fault injection, no Message
        wrapper) — protocol parity with ``UdpNonBlockingSocket``."""
        self._network._send(self.addr, addr, bytes(data))

    def send_datagram_batch(self, items) -> None:
        """One call per tick flushing ``(data, addr)`` datagrams in order,
        through the same fault injection per datagram, so the seeded fault
        stream is identical to per-datagram sends."""
        send = self._network._send
        me = self.addr
        for data, addr in items:
            send(me, addr, bytes(data))

    def receive_all_messages(self) -> List[Tuple[Hashable, Message]]:
        return self._network._receive(self.addr)

    def receive_all_datagrams(self) -> List[Tuple[Hashable, bytes]]:
        return self._network._receive_raw(self.addr)
