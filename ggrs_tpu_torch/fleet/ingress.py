"""Ingress plane: stable virtual match endpoints (DESIGN.md §26).

The port's copy of ``ggrs_tpu/fleet/ingress.py``.

A match's wire address used to be a port pinned by its ``socket_factory``
on whatever host admitted it — so nothing could move.  This module puts a
:class:`~ggrs_tpu_torch.net.sockets.DispatchHub` AT THE EDGE: the ingress owns
one public UDP port (plus SO_REUSEPORT siblings) and hands every match a
*virtual endpoint* — a small integer ``vport`` demuxed by claimed peer
source address, exactly the §23 dispatch demux one level up.  Peers and
spectators talk to ``(ingress_ip, public_port)`` forever; which host
actually serves the match is a ROUTE TABLE entry the placement service
flips after a migration or a §16 journal failover.  The flip is invisible
on the public side: same address, a retransmission hiccup, not a reset.

Fencing (the §25 lesson, applied to routes): every route update carries
the placement-minted ``epoch`` and a monotonically increasing route
``version``.  The ingress refuses anything not strictly newer than the
per-vport floor it has already accepted — a stale supervisor (fenced by a
failover it slept through) can never flip a route back.  The floor
survives route deletion, so a late PUT from a dead epoch stays refused.
The same fence guards the dataplane: host→peer datagrams are accepted
only from the route's registered leg address, so a fenced incarnation
that is still breathing cannot speak AS the virtual endpoint.

Wire formats (pinned in the §20 layout contract table):

- ``FWD_HEADER`` — the forwarded-datagram header wrapping every payload
  on the ingress↔host leg: magic ``GI``, version, flags, vport, and the
  public peer's address (port + IPv4), 12 bytes.
- ``ROUTE_UPDATE`` — the route-update frame: magic, version, op
  (PUT/DEL), epoch, route version, vport, and the serving leg's address,
  28 bytes.  Travels as packed bytes over the §25 authenticated TCP link
  (the ``ingress_route`` RPC op) and through the in-process path — ONE
  decoder (:func:`decode_route_update`) judges both.

Roles:

- :class:`IngressNode` — the dataplane object (ThreadOwned): hub + route
  table + the forwarding pump.  Usable in-process (tests, single-box).
- :class:`IngressRunner` — the §17 runner harness around a node: same
  RPC/heartbeat/GOODBYE plumbing as a shard runner, serving loop selects
  on the dataplane fds, route updates arrive as RPC ops.
- :class:`IngressHandle` — the placement-side proxy over the §25
  :class:`~ggrs_tpu_torch.fleet.transport.ShardLink`: duck-types the node's
  control surface so :class:`~ggrs_tpu_torch.fleet.placement_service.
  PlacementService` drives local and remote ingress identically.
- :class:`VirtualEndpointSocket` — the serving-host leg: a picklable
  ``socket_factory`` product that wraps/unwraps ``FWD_HEADER`` so a
  session bank behind an ingress needs no code changes at all.
"""

from __future__ import annotations

import os
import select
import socket as _socket
import struct
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

from ..core.errors import InvalidRequest
from ..net.messages import Message
from ..net.sockets import (
    DispatchHub,
    DispatchSocket,
    RECV_BUFFER_SIZE,
    UdpNonBlockingSocket,
    _TRANSIENT_SEND_ERRNOS,
)
from ..net.wire import WireError
from ..obs.fleet_obs import RegistryCollector
from ..obs.registry import DEFAULT, Registry
from ..obs.timeline import (
    EV_ROUTE_FLIP,
    ZERO_TRACE_CTX,
    timeline_event,
    unpack_trace_ctx,
)
from ..utils.ownership import ThreadOwned
from ..utils.tracing import get_logger
from .proc import ShardRunner, _GracefulExit
from .rpc import KIND_CALL, KIND_HEARTBEAT, RpcConn, RpcError, RpcTimeout
from .transport import ShardLink
from .tuning import FleetTuning

_logger = get_logger("fleet")

_REPO_ROOT = Path(__file__).resolve().parents[2]
_RUNNER_SCRIPT = _REPO_ROOT / "scripts" / "port_shard_runner.py"


# ----------------------------------------------------------------------
# wire structs (§20 layout contract table: analysis/layout.py parses
# exactly these definitions — keep names/formats in sync with the table)
# ----------------------------------------------------------------------

INGRESS_MAGIC = b"GI"
FWD_VERSION = 1
# v2 (DESIGN.md §28): the route-update frame grew a trailing 16-byte
# trace context (obs/timeline.py TRACE_CTX) — the placement plane's
# causal stamp rides the same fenced bytes as the route itself
ROUTE_WIRE_VERSION = 2

# forwarded-datagram header (ingress<->host leg): magic, version, flags,
# vport, peer_port, peer_ipv4 — the payload follows verbatim
FWD_HEADER = struct.Struct("<2sBBHH4s")

# route-update frame: magic, version, op, epoch, route version, vport,
# dst_port, dst_ipv4, trace_ctx — refused unless (epoch, version) beats
# the floor
ROUTE_UPDATE = struct.Struct("<2sBBQQHH4s16s")

ROUTE_OP_PUT = 1
ROUTE_OP_DEL = 2


def encode_route_update(op: int, epoch: int, version: int, vport: int,
                        dst: Tuple[str, int],
                        ctx: bytes = ZERO_TRACE_CTX) -> bytes:
    """Pack one route update.  ``dst`` is the serving leg's (ipv4, port);
    for a DEL the address still rides along (it names the leg being
    retired, useful in logs) but is not required to resolve.  ``ctx`` is
    the packed 16-byte trace context (``pack_trace_ctx``; all-zero =
    no causal stamp)."""
    host, port = dst
    return ROUTE_UPDATE.pack(
        INGRESS_MAGIC, ROUTE_WIRE_VERSION, op, epoch, version, vport,
        port, _socket.inet_aton(host), ctx,
    )


def decode_route_update(
    data: bytes,
) -> Tuple[int, int, int, int, Tuple[str, int], bytes]:
    """Unpack + validate one route update; raises :class:`WireError` on
    anything malformed (the single judgment both the RPC op and the
    in-process path share).  The last element is the packed 16-byte
    trace context."""
    if len(data) != ROUTE_UPDATE.size:
        raise WireError(
            f"route update: {len(data)} bytes, want {ROUTE_UPDATE.size}")
    magic, ver, op, epoch, version, vport, port, ip4, ctx = \
        ROUTE_UPDATE.unpack(data)
    if magic != INGRESS_MAGIC:
        raise WireError(f"route update: bad magic {magic!r}")
    if ver != ROUTE_WIRE_VERSION:
        raise WireError(f"route update: unsupported version {ver}")
    if op not in (ROUTE_OP_PUT, ROUTE_OP_DEL):
        raise WireError(f"route update: unknown op {op}")
    return op, epoch, version, vport, (_socket.inet_ntoa(ip4), port), ctx


def pack_fwd(vport: int, peer: Tuple[str, int], payload: bytes,
             flags: int = 0) -> bytes:
    """Wrap one datagram for the ingress<->host leg."""
    host, port = peer
    return FWD_HEADER.pack(
        INGRESS_MAGIC, FWD_VERSION, flags, vport, port,
        _socket.inet_aton(host),
    ) + payload


def unpack_fwd(data: bytes) -> Tuple[int, Tuple[str, int], bytes]:
    """Unwrap one forwarded datagram -> (vport, peer_addr, payload)."""
    if len(data) < FWD_HEADER.size:
        raise WireError(f"fwd header: short frame ({len(data)} bytes)")
    magic, ver, _flags, vport, port, ip4 = FWD_HEADER.unpack_from(data)
    if magic != INGRESS_MAGIC:
        raise WireError(f"fwd header: bad magic {magic!r}")
    if ver != FWD_VERSION:
        raise WireError(f"fwd header: unsupported version {ver}")
    return vport, (_socket.inet_ntoa(ip4), port), data[FWD_HEADER.size:]


@dataclass
class RouteEntry:
    """One live route: the serving leg plus the fence that admitted it."""

    dst: Tuple[str, int]
    epoch: int
    version: int


# ======================================================================
# the dataplane: IngressNode
# ======================================================================


class IngressNode(ThreadOwned):
    """The ingress dataplane: one public DispatchHub, a per-vport route
    table, and the forwarding pump.  Single-owner (ThreadOwned): the
    serving loop that calls :meth:`pump` is the only thread allowed to
    mutate routes — route updates arrive through that same loop (RPC op
    or in-process call), never concurrently."""

    _DRIVING_METHODS = ("pump", "allocate_endpoint", "claim_peers",
                        "apply_route_update", "close")

    def __init__(self, *, name: str = "ingress",
                 host: str = "127.0.0.1", port: int = 0,
                 uplink_port: int = 0, siblings: int = 0,
                 metrics: Optional[Registry] = None,
                 tuning: Optional[FleetTuning] = None) -> None:
        self.name = name
        self.host = host
        self.tuning = tuning if tuning is not None else FleetTuning()
        self.metrics = metrics if metrics is not None else Registry()
        # the public face: one port, many virtual endpoints
        self.hub = DispatchHub(port=port, siblings=siblings)
        # the private face: host legs send/receive forwarded datagrams
        # here (separate from the public port so a public peer can never
        # forge a FWD_HEADER into the forwarding path)
        self._uplink = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        self._uplink.bind(("0.0.0.0", uplink_port))
        self._uplink.setblocking(False)
        try:
            self._uplink.setsockopt(
                _socket.SOL_SOCKET, _socket.SO_RCVBUF, 8 << 20)
        except OSError:
            pass
        self._views: Dict[int, DispatchSocket] = {}
        self._peers: Dict[int, Set[Tuple[str, int]]] = {}
        self._routes: Dict[int, RouteEntry] = {}
        # the per-vport (epoch, version) floor — survives DEL, so a
        # fenced writer stays fenced even after its route is retired
        self._fence: Dict[int, Tuple[int, int]] = {}
        self._next_vport = 1
        self._recv_buf = bytearray(RECV_BUFFER_SIZE)
        self._recv_view = memoryview(self._recv_buf)
        # route-flip timeline events (§28): buffered here, ferried by
        # the runner's existing heartbeat obs payload (keyed by the wire
        # trace context's hex — the ingress never learns a match id)
        self._timeline_items: List[Dict[str, Any]] = []
        # plain mirrors for info()/healthz (cheap, no registry walk)
        self.flips = 0
        self.forwarded = {"in": 0, "out": 0}
        self.forwarded_bytes = {"in": 0, "out": 0}
        self.dropped: Dict[str, int] = {}
        self.route_updates: Dict[str, int] = {}
        m = self.metrics
        self._g_routes = m.gauge(
            "ggrs_ingress_routes", "live virtual-endpoint routes")
        self._g_vports = m.gauge(
            "ggrs_ingress_vports", "allocated virtual endpoints")
        self._c_updates = m.counter(
            "ggrs_ingress_route_updates_total",
            "route updates judged, by verdict", labels=("verdict",))
        self._c_flips = m.counter(
            "ggrs_ingress_route_flips_total",
            "accepted PUTs that moved an existing route to a new leg")
        self._c_fwd = m.counter(
            "ggrs_ingress_forwarded_datagrams_total",
            "datagrams forwarded through the ingress, by direction",
            labels=("dir",))
        self._c_fwd_bytes = m.counter(
            "ggrs_ingress_forwarded_bytes_total",
            "payload bytes forwarded through the ingress, by direction",
            labels=("dir",))
        self._c_drop = m.counter(
            "ggrs_ingress_dropped_datagrams_total",
            "datagrams the forwarding pump refused, by reason",
            labels=("reason",))

    # -- addresses -----------------------------------------------------

    def public_addr(self) -> Tuple[str, int]:
        """The address peers and spectators dial — stable for the life
        of the ingress, whatever happens to the hosts behind it."""
        return (self.host, self.hub.local_port())

    def uplink_addr(self) -> Tuple[str, int]:
        """Where host legs send forwarded datagrams."""
        return (self.host, self._uplink.getsockname()[1])

    def filenos(self) -> List[int]:
        return self.hub.filenos() + [self._uplink.fileno()]

    # -- control surface -----------------------------------------------

    def allocate_endpoint(self, peers: Any = ()) -> int:
        """Mint a virtual endpoint: a fresh vport demuxed on the public
        port, optionally pre-claiming the peer source addresses that
        belong to it."""
        self._check_owner()
        vport = self._next_vport
        self._next_vport += 1
        self._views[vport] = self.hub.view()
        self._peers[vport] = set()
        if peers:
            self.claim_peers(vport, peers)
        self._g_vports.set(len(self._views))
        return vport

    def claim_peers(self, vport: int, peers: Any) -> None:
        """Bind public source addresses to a vport (the §23 demux claim,
        one level up).  Late joiners claim as they appear."""
        self._check_owner()
        view = self._views.get(vport)
        if view is None:
            raise InvalidRequest(f"no virtual endpoint {vport}")
        for addr in peers:
            addr = (addr[0], int(addr[1]))
            view.claim(addr)
            self._peers[vport].add(addr)

    def apply_route_update(self, data: bytes) -> str:
        """Judge one packed route update; returns the verdict string
        (``ok`` / ``stale-epoch`` / ``stale-version`` / ``unknown-vport``
        / ``bad-frame``).  The ONE code path both the RPC op and the
        in-process caller go through — there is no unfenced side door."""
        self._check_owner()
        try:
            op, epoch, version, vport, dst, ctx = decode_route_update(data)
        except WireError:
            return self._judge_update("bad-frame")
        if vport not in self._views:
            return self._judge_update("unknown-vport")
        floor = self._fence.get(vport)
        if floor is not None:
            f_epoch, f_version = floor
            if epoch < f_epoch:
                return self._judge_update("stale-epoch")
            if epoch == f_epoch and version <= f_version:
                return self._judge_update("stale-version")
        self._fence[vport] = (epoch, version)
        prev = self._routes.get(vport)
        if op == ROUTE_OP_DEL:
            self._routes.pop(vport, None)
        else:
            self._routes[vport] = RouteEntry(dst, epoch, version)
            if prev is not None and prev.dst != dst:
                self.flips += 1
                self._c_flips.inc()
                # §28: the flip, as witnessed at the dataplane, stamped
                # with the trace context the fenced bytes carried — the
                # cross-host join key is the trace hash, not a match id
                trace, ctx_epoch, span = (
                    unpack_trace_ctx(ctx) if ctx != ZERO_TRACE_CTX
                    else (0, 0, 0))
                ev = timeline_event(
                    EV_ROUTE_FLIP, f"trace:{trace:016x}",
                    origin=self.name, epoch=ctx_epoch, span=span,
                    detail={"vport": vport,
                            "from": f"{prev.dst[0]}:{prev.dst[1]}",
                            "to": f"{dst[0]}:{dst[1]}"},
                )
                ev["trace"] = trace
                self._timeline_items.append(ev)
                del self._timeline_items[:-64]
        self._g_routes.set(len(self._routes))
        return self._judge_update("ok")

    def _judge_update(self, verdict: str) -> str:
        self.route_updates[verdict] = self.route_updates.get(verdict, 0) + 1
        self._c_updates.labels(verdict=verdict).inc()
        return verdict

    # -- the forwarding pump -------------------------------------------

    def pump(self) -> None:
        """One non-blocking forwarding cycle: drain the public hub once,
        relay every claimed datagram to its route's serving leg; drain
        the uplink, relay every fenced-clean reply out the public port
        (so replies leave from the stable public address)."""
        self._check_owner()
        self.hub.drain()
        for vport, view in self._views.items():
            pending = view.take_pending()
            if not pending:
                continue
            route = self._routes.get(vport)
            for peer, payload in pending:
                if route is None:
                    self._drop("no-route")
                    continue
                data = pack_fwd(vport, peer, payload)
                try:
                    self._uplink.sendto(data, route.dst)
                except OSError as e:
                    if e.errno not in _TRANSIENT_SEND_ERRNOS:
                        raise
                    self._drop("uplink-send")
                    continue
                self.forwarded["in"] += 1
                self.forwarded_bytes["in"] += len(payload)
                self._c_fwd.labels(dir="in").inc()
                self._c_fwd_bytes.labels(dir="in").inc(len(payload))
        buf, view = self._recv_buf, self._recv_view
        while True:
            try:
                n, src = self._uplink.recvfrom_into(buf, RECV_BUFFER_SIZE)
            except BlockingIOError:
                break
            except ConnectionError:
                continue
            try:
                vport, peer, payload = unpack_fwd(bytes(view[:n]))
            except WireError:
                self._drop("bad-frame")
                continue
            route = self._routes.get(vport)
            if route is None:
                self._drop("no-route")
                continue
            if src != route.dst:
                # the dataplane fence: only the CURRENT route's leg may
                # speak as this virtual endpoint — a fenced incarnation
                # still breathing is dropped here, not trusted
                self._drop("fenced-sender")
                continue
            if peer not in self._peers.get(vport, ()):
                self._drop("unclaimed-peer")
                continue
            self.hub.send_datagram(payload, peer)
            self.forwarded["out"] += 1
            self.forwarded_bytes["out"] += len(payload)
            self._c_fwd.labels(dir="out").inc()
            self._c_fwd_bytes.labels(dir="out").inc(len(payload))

    def _drop(self, reason: str) -> None:
        self.dropped[reason] = self.dropped.get(reason, 0) + 1
        self._c_drop.labels(reason=reason).inc()

    def drain_timeline(self) -> List[Dict[str, Any]]:
        """Buffered route-flip timeline events, cleared — the runner's
        heartbeat payload ships these (§28 piggyback contract)."""
        out = self._timeline_items
        self._timeline_items = []
        return out

    # -- introspection / teardown --------------------------------------

    def info(self) -> Dict[str, Any]:
        return dict(
            name=self.name,
            public=list(self.public_addr()),
            uplink=list(self.uplink_addr()),
            vports=len(self._views),
            routes=len(self._routes),
            flips=self.flips,
            forwarded=dict(self.forwarded),
            forwarded_bytes=dict(self.forwarded_bytes),
            dropped=dict(self.dropped),
            route_updates=dict(self.route_updates),
            unroutable=self.hub.unroutable,
        )

    def close(self) -> None:
        self._check_owner()
        self.hub.close()
        self._uplink.close()


# ======================================================================
# the serving-host leg: VirtualEndpointSocket
# ======================================================================


class VirtualEndpointSocket:
    """The host-side leg of a virtual endpoint: a ``NonBlockingSocket``
    whose wire peer is the ingress uplink.  Outbound wraps the payload in
    ``FWD_HEADER`` (naming the real public peer); inbound unwraps, so the
    session bank above sees plain (peer_addr, payload) datagrams and
    needs no ingress awareness at all.

    ``is_dispatch`` keeps pools from attaching the leg to the in-crossing
    NetBatch path (the header wrap must happen in Python; the native
    parser would read the FWD bytes as protocol).  Binds an EPHEMERAL
    port by default — failover re-legs never fight EADDRINUSE, because
    the public address lives at the ingress, not here."""

    is_dispatch = True

    def __init__(self, uplink_host: str, uplink_port: int,
                 vport: int, port: int = 0) -> None:
        self._sock = UdpNonBlockingSocket(port)
        self._uplink = (uplink_host, int(uplink_port))
        self.vport = vport

    @property
    def stats(self):
        return self._sock.stats

    @property
    def io_syscalls(self) -> int:
        return self._sock.io_syscalls

    def fileno(self) -> int:
        return self._sock.fileno()

    def local_port(self) -> int:
        return self._sock.local_port()

    def send_to(self, msg: Message, addr: Tuple[str, int]) -> None:
        self.send_datagram(msg.encode(), addr)

    def send_datagram(self, data: bytes, addr: Tuple[str, int]) -> None:
        self._sock.send_datagram(
            pack_fwd(self.vport, addr, bytes(data)), self._uplink)

    def send_datagram_batch(
        self, items: List[Tuple[bytes, Tuple[str, int]]]
    ) -> None:
        self._sock.send_datagram_batch([
            (pack_fwd(self.vport, addr, bytes(data)), self._uplink)
            for data, addr in items
        ])

    def receive_all_messages(self) -> List[Tuple[Tuple[str, int], Message]]:
        received: List[Tuple[Tuple[str, int], Message]] = []
        for src, data in self.receive_all_datagrams():
            try:
                received.append((src, Message.decode(data)))
            except WireError:
                continue
        return received

    def receive_all_datagrams(self) -> List[Tuple[Tuple[str, int], bytes]]:
        out: List[Tuple[Tuple[str, int], bytes]] = []
        for src, data in self._sock.receive_all_datagrams():
            if src != self._uplink:
                continue  # only the ingress may speak to a leg
            try:
                vport, peer, payload = unpack_fwd(data)
            except WireError:
                continue
            if vport != self.vport:
                continue
            out.append((peer, payload))
        return out

    def close(self) -> None:
        self._sock.close()


def virtual_endpoint_socket(uplink_host: str, uplink_port: int,
                            vport: int, port: int = 0
                            ) -> VirtualEndpointSocket:
    """Picklable ``socket_factory`` for ingress-fronted matches:
    ``functools.partial(virtual_endpoint_socket, host, port, vport)`` is
    the shape the placement service admits with — the leg binds IN the
    serving process (in-process shard or runner child alike), so
    migration and failover mint a fresh leg wherever the match lands."""
    return VirtualEndpointSocket(uplink_host, uplink_port, vport,
                                 port=port)


# ======================================================================
# the §17 runner harness: IngressRunner
# ======================================================================


class IngressRunner(ShardRunner):
    """An ingress-role runner: the same framed-RPC/heartbeat/GOODBYE
    plumbing as :class:`~ggrs_tpu_torch.fleet.proc.ShardRunner` (serve(),
    reconnect-or-exit, graceful drain), but the serving loop pumps an
    :class:`IngressNode` dataplane instead of ticking a PoolShard, and
    selects on the dataplane fds so forwarding latency is bounded by
    wire arrival, not the RPC heartbeat cadence."""

    def __init__(self, conn: RpcConn, link=None) -> None:
        super().__init__(conn, link=link)
        self.node: Optional[IngressNode] = None

    def _loop(self) -> None:
        hb_next = time.monotonic() + self.tuning.heartbeat_interval_s
        while True:
            now = time.monotonic()
            if now >= hb_next:
                hb_next = now + self.tuning.heartbeat_interval_s
                if self.node is not None:
                    payload = self._obs_payload(include_spans=False)
                    timeline = self.node.drain_timeline()
                    if timeline:
                        if payload is None:
                            payload = {"now_ns": time.perf_counter_ns()}
                        payload["timeline"] = timeline
                    try:
                        self.conn.send(KIND_HEARTBEAT, dict(
                            info=self.node.info(),
                            obs=payload,
                        ), timeout=5.0)
                    except RpcTimeout:
                        self._requeue_obs(payload)
                        if payload and payload.get("timeline"):
                            self.node._timeline_items[:0] = (
                                payload["timeline"])
                            del self.node._timeline_items[:-64]
            wait = max(0.0, hb_next - now)
            fds = [self.conn.fileno()]
            if self.node is not None:
                # bound the wait so a pump cycle runs even when neither
                # plane is readable (claims/obs mirrors stay fresh)
                wait = min(wait, self.tuning.ingress_select_timeout_s)
                fds += self.node.filenos()
            r, _, _ = select.select(fds, [], [], wait)
            if self.node is not None:
                self.node.pump()
            if self.conn.fileno() not in r:
                continue
            kind, msg = self.conn.recv(timeout=10.0)
            if kind != KIND_CALL:
                continue
            self._dispatch(msg)
            if self._exit_after_reply is not None:
                raise _GracefulExit(self._exit_after_reply)

    # -- ops -----------------------------------------------------------

    def _op_hello(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        cfg = msg["config"]
        if cfg.get("tuning"):
            self.tuning = FleetTuning.from_dict(cfg["tuning"])
            self.conn.max_frame = self.tuning.max_frame_bytes
        if self._link is not None:
            self._link.configure(self.tuning)
            self.conn.enable_retain(self.tuning.link_retain_frames)
        self.node = IngressNode(
            name=cfg.get("shard_id", "ingress"),
            host=cfg.get("host", "127.0.0.1"),
            port=cfg.get("port", 0),
            uplink_port=cfg.get("uplink_port", 0),
            siblings=cfg.get("siblings", 0),
            tuning=self.tuning,
        )
        if self.tuning.obs_harvest:
            self.collector = RegistryCollector(
                self.node.metrics, DEFAULT, gen=os.getpid(),
            )
        return dict(
            pid=os.getpid(), role="ingress", shard_id=self.node.name,
            public=list(self.node.public_addr()),
            uplink=list(self.node.uplink_addr()),
        )

    def _op_ingress_allocate(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        vport = self._require_node().allocate_endpoint(
            peers=[tuple(a) for a in msg.get("peers", ())])
        return dict(vport=vport)

    def _op_ingress_claim(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        self._require_node().claim_peers(
            msg["vport"], [tuple(a) for a in msg.get("peers", ())])
        return {}

    def _op_ingress_route(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return dict(
            verdict=self._require_node().apply_route_update(msg["update"]))

    def _op_ingress_info(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return self._require_node().info()

    def _require_node(self) -> IngressNode:
        if self.node is None:
            raise InvalidRequest("no hello received yet")
        return self.node

    # -- teardown ------------------------------------------------------

    def _graceful_exit(self, reason: str) -> None:
        try:
            super()._graceful_exit(reason)
        finally:
            if self.node is not None:
                self.node.close()

    def _quiet_exit(self, reason: str) -> None:
        try:
            super()._quiet_exit(reason)
        finally:
            if self.node is not None:
                self.node.close()


# ======================================================================
# the placement-side proxy: IngressHandle
# ======================================================================


class IngressHandle:
    """Adopt and drive a remote ``port_shard_runner.py --ingress --tcp`` over
    the §25 authenticated link, presenting the :class:`IngressNode`
    control surface (allocate/claim/route/info/addresses) so the
    placement service is transport-blind.  The epoch the link mints at
    adoption is the SAME fencing domain route updates ride in — one
    mint, two planes."""

    def __init__(self, name: str = "ingress", *,
                 tuning: Optional[FleetTuning] = None,
                 host: str = "127.0.0.1",
                 metrics: Optional[Registry] = None,
                 spawn_child: bool = False) -> None:
        self.name = name
        self.tuning = tuning if tuning is not None else FleetTuning.from_env()
        self.metrics = metrics if metrics is not None else Registry()
        self.link = ShardLink(name, self.tuning, host=host,
                              metrics=self.metrics)
        self._spawn_child = spawn_child
        self._proc: Optional[subprocess.Popen] = None
        self._conn: Optional[RpcConn] = None
        self._public: Optional[Tuple[str, int]] = None
        self._uplink_addr: Optional[Tuple[str, int]] = None
        self.pid: Optional[int] = None
        self.last_heartbeat: Dict[str, Any] = {}
        # armed by the placement service: heartbeat obs land here
        self.obs = None

    @property
    def address(self) -> Tuple[str, int]:
        """The TCP address an external ``--ingress --tcp`` runner dials."""
        return self.link.address

    def adopt(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Mint an epoch, (optionally) fork a local ingress runner, wait
        for the authenticated handshake, and hello it."""
        self.link.reopen()
        self.link.mint_epoch()
        if self._spawn_child:
            host, port = self.link.address
            env = dict(
                os.environ,
                GGRS_FLEET_LINK_AUTH_TOKEN=self.tuning.link_auth_token,
                GGRS_FLEET_LINK_SHARD=self.name,
            )
            self._proc = subprocess.Popen(
                [sys.executable, str(_RUNNER_SCRIPT),
                 "--ingress", "--tcp", f"{host}:{port}"],
                env=env,
            )
        sock = self.link.wait_for_runner(
            timeout if timeout is not None else self.tuning.spawn_timeout_s)
        conn = RpcConn(sock, max_frame=self.tuning.max_frame_bytes)
        conn.enable_retain(self.tuning.link_retain_frames)
        r = conn.call(
            "hello", timeout=self.tuning.spawn_timeout_s,
            config=dict(shard_id=self.name, tuning=self.tuning.as_dict()),
        )
        self.link.established(conn)
        conn.on_heartbeat = self._on_heartbeat
        self._conn = conn
        self.pid = r["pid"]
        self._public = tuple(r["public"])
        self._uplink_addr = tuple(r["uplink"])
        return r

    def _on_heartbeat(self, obj: Any) -> None:
        if not isinstance(obj, dict):
            return
        self.last_heartbeat = obj
        payload = obj.get("obs")
        if payload and self.obs is not None:
            self.obs.ingest(self.name, payload, backend="ingress")

    def _call(self, op: str, **kw: Any) -> Any:
        if self._conn is None:
            raise InvalidRequest(f"ingress {self.name!r} not adopted")
        return self._conn.call(op, timeout=self.tuning.rpc_timeout_s, **kw)

    def pump(self) -> None:
        """Drive the link's accept/handshake machinery and drain any
        heartbeat frames waiting on the conn."""
        self.link.pump()
        if self._conn is not None:
            try:
                self._conn.poll_frames()
            except RpcError:
                pass

    # -- the IngressNode control surface, by proxy ---------------------

    def public_addr(self) -> Optional[Tuple[str, int]]:
        return self._public

    def uplink_addr(self) -> Optional[Tuple[str, int]]:
        return self._uplink_addr

    def allocate_endpoint(self, peers: Any = ()) -> int:
        return self._call(
            "ingress_allocate", peers=[list(a) for a in peers])["vport"]

    def claim_peers(self, vport: int, peers: Any) -> None:
        self._call("ingress_claim", vport=vport,
                   peers=[list(a) for a in peers])

    def apply_route_update(self, data: bytes) -> str:
        return self._call("ingress_route", update=data)["verdict"]

    def info(self) -> Dict[str, Any]:
        return self._call("ingress_info")

    def close(self) -> None:
        """Graceful teardown: shutdown RPC (the runner drains + exits),
        then the link and any forked child."""
        if self._conn is not None:
            try:
                self._conn.call("shutdown", timeout=5.0,
                                reason="ingress close")
            except RpcError:
                pass
            self._conn.close()
            self._conn = None
        self.link.close()
        if self._proc is not None:
            try:
                self._proc.wait(timeout=self.tuning.drain_deadline_s)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._proc = None
