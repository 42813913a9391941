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
# Syscall accounting: the Python shuttle pays one syscall per datagram, plus
# the EAGAIN probe per drain; the host bank's kernel-batched datapath counts
# its recvmmsg/sendmmsg calls in the same family.  Increments are batched
# per drain, not per datagram.
_OBS_SYSCALLS = default_registry().counter(
    "ggrs_io_syscalls_total",
    "socket syscalls by kind (sendto/recvfrom = per-datagram Python path; "
    "recvmmsg/sendmmsg = kernel-batched native path)",
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
        """The bound fd: what the host bank hands to the native batched
        datapath (``ggrs_net_attach``, the send and receive tables)."""
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


class DispatchHub:
    """One bound UDP port serving MANY pool slots: the shared *dispatch
    socket* (docs/DESIGN.md §23).

    Where every match slot normally owns a bound fd (and with it about 2
    syscalls per slot per tick), a DispatchHub binds ONE port, plus
    ``siblings`` extra SO_REUSEPORT sockets when the platform has the option, so the kernel spreads inbound load across
    several queues — and hands each slot a :class:`DispatchSocket` view.
    Demux is by *source address*: each view ``claim``\\ s the remote
    addresses that belong to its slot (the pool claims every endpoint and
    spectator address it maps).  The native one-crossing drain
    (``ggrs_net_recv_table``) does the same demux in C through the pool's
    sorted route table; this class carries the reference Python demux so
    the mode degrades per-feature when the native library is absent.

    Datagrams from unclaimed sources are dropped and counted
    (``unroutable``) — exactly what real UDP does to packets nobody
    listens for.  Outbound shares the primary fd (peers see one stable
    source port), with ``UdpNonBlockingSocket``'s transient-errno-as-loss
    semantics.
    """

    def __init__(self, port: int = 0, siblings: int = 0) -> None:
        self.reuseport = hasattr(_socket, "SO_REUSEPORT")
        n = 1 + (siblings if self.reuseport else 0)
        self._socks: List[_socket.socket] = []
        bound_port = port
        for _ in range(n):
            s = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
            if n > 1:
                # must be set on EVERY socket (the first included) before
                # bind, or the siblings' binds fail with EADDRINUSE
                s.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEPORT, 1)
            s.bind(("0.0.0.0", bound_port))
            s.setblocking(False)
            # a shared fd aggregates MANY slots' inbound between drains;
            # the default SO_RCVBUF (~208 KiB) holds only a few hundred
            # skb-padded datagrams, so a B>=256 pool overflows it every
            # tick and the kernel drops are invisible (no errno, no
            # counter).  Ask deep; the kernel clamps to net.core.rmem_max.
            try:
                s.setsockopt(_socket.SOL_SOCKET, _socket.SO_RCVBUF, 8 << 20)
            except OSError:
                pass
            if bound_port == 0:
                bound_port = s.getsockname()[1]
            self._socks.append(s)
        self.gro = False
        self.stats = NetworkStats()
        self.io_syscalls = 0
        self.unroutable = 0
        self._claims: Dict[Hashable, "DispatchSocket"] = {}
        self._views: List["DispatchSocket"] = []
        self._recv_buf = bytearray(RECV_BUFFER_SIZE)
        self._recv_view = memoryview(self._recv_buf)

    def view(self) -> "DispatchSocket":
        v = DispatchSocket(self, primary=not self._views)
        self._views.append(v)
        return v

    def filenos(self) -> List[int]:
        """Every bound fd (primary + SO_REUSEPORT siblings) — ALL must be
        drained; the kernel hashes inbound flows across them."""
        return [s.fileno() for s in self._socks]

    def local_port(self) -> int:
        return self._socks[0].getsockname()[1]

    def enable_gro(self) -> bool:
        """Ask the kernel to coalesce inbound UDP trains (``UDP_GRO``) on
        every sibling fd.  ONLY the pool's native
        one-crossing drain may enable this: the reference Python
        :meth:`drain` reads into a ``RECV_BUFFER_SIZE`` buffer and would
        mis-handle a coalesced train, so the caller flips GRO on exactly
        when ``ggrs_net_recv_table`` (which splits trains back into wire
        datagrams) covers these fds.  Idempotent; returns whether GRO is
        now on."""
        if self.gro:
            return True
        ok = True
        # SOL_UDP=17 / UDP_GRO=104: numeric because pre-3.12 socket
        # modules don't export UDP_GRO
        sol_udp = getattr(_socket, "IPPROTO_UDP", 17)
        udp_gro = getattr(_socket, "UDP_GRO", 104)
        for s in self._socks:
            try:
                s.setsockopt(sol_udp, udp_gro, 1)
            except OSError:
                ok = False
                break
        self.gro = ok
        return ok

    def claim(self, addr: Hashable, view: "DispatchSocket") -> None:
        self._claims[addr] = view

    def release(self, view: "DispatchSocket") -> None:
        """Drop every claim owned by ``view`` (slot detached/evicted)."""
        self._claims = {
            a: v for a, v in self._claims.items() if v is not view
        }

    def send_datagram(self, data: bytes, addr: Tuple[str, int]) -> None:
        if len(data) > IDEAL_MAX_UDP_PACKET_SIZE:
            _OBS_OVERSIZED.inc()
        self.io_syscalls += 1
        _OBS_SENDTO.inc()
        try:
            self._socks[0].sendto(data, addr)
        except OSError as e:
            if e.errno not in _TRANSIENT_SEND_ERRNOS:
                raise
            self.stats.send_errors += 1
            _OBS_SEND_ERRORS.inc()
            logger.debug("dispatch send to %s failed transiently: %s",
                         addr, e)

    def drain(self) -> None:
        """Reference Python demux: sweep every sibling fd dry, bucketing
        datagrams into the claiming view's pending queue in arrival order
        (per fd).  Same errno semantics as
        ``UdpNonBlockingSocket.receive_all_datagrams``."""
        buf, view = self._recv_buf, self._recv_view
        claims = self._claims
        calls = 0
        for s in self._socks:
            while True:
                calls += 1
                try:
                    n, src = s.recvfrom_into(buf, RECV_BUFFER_SIZE)
                except BlockingIOError:
                    break
                except ConnectionError:
                    continue
                owner = claims.get(src)
                if owner is None:
                    self.unroutable += 1
                    continue
                owner._pending.append((src, bytes(view[:n])))
        self.io_syscalls += calls
        _OBS_RECVFROM.inc(calls)

    def close(self) -> None:
        for s in self._socks:
            s.close()

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class DispatchSocket:
    """One slot's view of a :class:`DispatchHub`: a ``NonBlockingSocket``
    whose receive side sees exactly the datagrams whose source address the
    slot claimed.  ``is_dispatch`` marks it for the pool: never attached
    to the in-crossing NetBatch path (the hub's fds are SHARED: per-slot
    fault isolation needs the record-level dispatch flag of the table paths,
    not a whole-fd attach)."""

    is_dispatch = True

    def __init__(self, hub: DispatchHub, primary: bool) -> None:
        self.hub = hub
        self._primary = primary
        self._pending: List[Tuple[Tuple[str, int], bytes]] = []

    @property
    def io_syscalls(self) -> int:
        # the hub's syscalls are shared work: report them once, on the
        # primary view, so summing a pool's sockets stays truthful
        return self.hub.io_syscalls if self._primary else 0

    @property
    def stats(self) -> NetworkStats:
        return self.hub.stats

    def fileno(self) -> int:
        return self.hub.filenos()[0]

    def local_port(self) -> int:
        return self.hub.local_port()

    def claim(self, addr: Hashable) -> None:
        self.hub.claim(addr, self)

    def send_to(self, msg: Message, addr: Tuple[str, int]) -> None:
        self.hub.send_datagram(msg.encode(), addr)

    def send_datagram(self, data: bytes, addr: Tuple[str, int]) -> None:
        self.hub.send_datagram(bytes(data), addr)

    def send_datagram_batch(
        self, items: List[Tuple[bytes, Tuple[str, int]]]
    ) -> None:
        send = self.hub.send_datagram
        for data, addr in items:
            send(bytes(data), addr)

    def receive_all_messages(self) -> List[Tuple[Tuple[str, int], Message]]:
        received: List[Tuple[Tuple[str, int], Message]] = []
        for src, data in self.receive_all_datagrams():
            try:
                received.append((src, Message.decode(data)))
            except WireError:
                continue
        return received

    def receive_all_datagrams(self) -> List[Tuple[Tuple[str, int], bytes]]:
        self.hub.drain()
        out, self._pending = self._pending, []
        return out

    def take_pending(self) -> List[Tuple[Tuple[str, int], bytes]]:
        """Hand over what a prior ``hub.drain()`` already bucketed here
        WITHOUT re-draining the hub — the ingress forwarding pump drains
        once per cycle and then collects every view (one drain sweep for
        N virtual endpoints, not N sweeps)."""
        out, self._pending = self._pending, []
        return out

    def close(self) -> None:
        # the hub owns the fds; a single slot closing must not kill the
        # co-tenants.  Claims are released so late datagrams count as
        # unroutable instead of queueing forever.
        self.hub.release(self)
