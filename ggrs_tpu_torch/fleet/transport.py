"""The multi-host fleet link: authenticated TCP transport for the
supervisor↔runner RPC (DESIGN.md §25).

The port's copy of ``ggrs_tpu/fleet/transport.py``.

``fleet/rpc.py``'s crc32-framed protocol is transport-agnostic bytes;
this module gives it an AF_INET carrier with the three properties a
cross-host link needs that a socketpair gets for free:

- **authentication** — an HMAC-SHA256 challenge-response handshake
  (shared token from :class:`FleetTuning`) so a runner port exposed on a
  fleet network only talks to its supervisor;
- **reconnect ≠ failover** — a severed link opens a bounded reconnect
  window (jittered-backoff redial + sequence-numbered frame resumption)
  during which failover is FORBIDDEN; only a closed window, a fenced
  goodbye, or a reaped process confirms death (the §25 model's
  invariant: "no failover while a reconnect window is open");
- **split-brain fencing** — every runner incarnation holds an epoch
  token MINTED BY THE SUPERVISOR at handshake; after a failover the
  epoch is bumped, so a resurrected old runner is refused at handshake
  (``HS_REFUSED_FENCE``) and can never ack a tick again.

The supervisor side listens (:class:`ShardLink`, one listener per
``ProcShard``) and the runner dials (:class:`RunnerLink`, behind
``ShardRunner --tcp host:port``): runners dialing in is the natural
direction once runners live on other hosts behind NAT/ingress.  The
server half of the handshake is a non-blocking state machine
(:class:`PendingHandshake`) with a per-connection deadline, so a
slowloris dribble or garbage-before-magic scanner can never wedge the
supervisor's tick loop.

Every ``link_state`` assignment below performs an edge declared in
``LINK_TRANSITIONS`` — the §22 conformance lint proves it, and the
reconnect-vs-failover model (``analysis/machines.py``) validates its
actions against the same parsed table.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import random
import select
import socket
import struct
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from .rpc import RpcConn, RpcError

_logger = logging.getLogger("ggrs_tpu_torch.fleet.transport")

# ----------------------------------------------------------------------
# the link state machine (DESIGN.md §25, §22)
# ----------------------------------------------------------------------

LINK_CONNECTING = "connecting"      # listener armed, no authed runner yet
LINK_UP = "up"                      # authed conn serving frames
LINK_RECONNECTING = "reconnecting"  # severed; reconnect window open
LINK_DOWN = "down"                  # window expired / fenced / torn down

# The declared link transition table: every ``link_state`` assignment
# performs one of these edges (the ggrs-model conformance lint proves
# it), and ``link_model`` in analysis/machines.py validates its action
# edges against this tuple.  DOWN is the only state failover may be
# declared from — RECONNECTING is explicitly NOT confirmed death.
LINK_TRANSITIONS = (
    (LINK_CONNECTING, LINK_UP),        # fresh handshake granted
    (LINK_CONNECTING, LINK_DOWN),      # teardown before any runner
    (LINK_UP, LINK_RECONNECTING),      # sever: EOF while process lives
    (LINK_RECONNECTING, LINK_UP),      # resume inside the window
    (LINK_RECONNECTING, LINK_DOWN),    # window expired / resume fenced
    (LINK_UP, LINK_DOWN),              # goodbye / teardown
    (LINK_DOWN, LINK_CONNECTING),      # re-adoption after failover
)

# ----------------------------------------------------------------------
# handshake wire format (layout contract §20 — mirrored in
# analysis/layout.py, skew-tested in tests/test_verify_layout.py)
# ----------------------------------------------------------------------

HS_VERSION = 1
HS_MAGIC_CHALLENGE = b"GC"
HS_MAGIC_AUTH = b"GA"
HS_MAGIC_VERDICT = b"GV"

NONCE_BYTES = 16
MAC_BYTES = 32
SHARD_ID_BYTES = 16

# server → client: magic, advertised version, flags, nonce
CHALLENGE = struct.Struct("<2sBB16s")
# client → server, pre-MAC prefix: magic, chosen version, flags,
# epoch (supervisor-minted token held by this runner incarnation),
# resume cursor (the client's rx frame sequence), shard id
AUTH_PREFIX = struct.Struct("<2sBBQQ16s")
# the full auth record: prefix + HMAC-SHA256(token, nonce ‖ prefix)
AUTH = struct.Struct("<2sBBQQ16s32s")
# server → client: magic, version, verdict code, granted/current epoch,
# server's rx frame sequence (the client replays retained tx past it)
VERDICT = struct.Struct("<2sBBQQ")

# §28 trace context, as carried inside fleet-link RPC payloads and the
# ingress ROUTE_UPDATE tail: match-id hash u64, placement epoch u32,
# span id u32.  This is a LITERAL mirror of obs/timeline.py TRACE_CTX —
# the §20 layout check parses both definitions and pins them equal.
TRACE_CTX = struct.Struct("<QII")
TRACE_CTX_BYTES = 16

AUTH_FLAG_RESUME = 0x01

# verdict codes
HS_OK_FRESH = 0        # accepted; epoch field is the granted token
HS_OK_RESUME = 1       # accepted; replay retained frames past cursor
HS_REFUSED_AUTH = 2    # bad MAC / wrong shard
HS_REFUSED_VERSION = 3 # unsupported protocol version
HS_REFUSED_FENCE = 4   # stale epoch: a newer incarnation owns the shard
HS_REFUSED_RESUME = 5  # resume impossible (frame gap / no session)
HS_REFUSED_BUSY = 6    # fresh connect while another runner is attached


class HandshakeError(Exception):
    """The handshake could not complete: protocol garbage, a refusal
    verdict, or the peer vanished mid-exchange."""


def handshake_mac(token: str, nonce: bytes, prefix: bytes) -> bytes:
    """HMAC-SHA256 over ``nonce ‖ auth-record-prefix``: binding the MAC
    to the server's fresh nonce makes a captured record worthless on a
    new connection (the replayed-handshake test pins it)."""
    return hmac.new(
        token.encode("utf-8"), nonce + prefix, hashlib.sha256,
    ).digest()


def pack_auth(token: str, nonce: bytes, *, epoch: int, cursor: int,
              shard_id: str, resume: bool) -> bytes:
    flags = AUTH_FLAG_RESUME if resume else 0
    prefix = AUTH_PREFIX.pack(
        HS_MAGIC_AUTH, HS_VERSION, flags, epoch, cursor,
        shard_id.encode("utf-8")[:SHARD_ID_BYTES],
    )
    return prefix + handshake_mac(token, nonce, prefix)


def tune_tcp_socket(sock: socket.socket, keepalive_s: float = 0.0) -> None:
    """TCP_NODELAY always (the frames are latency-bound ticks, not
    throughput), SO_KEEPALIVE when armed so a silently-dead peer
    surfaces as an error instead of an eternal hang."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # AF_UNIX in tests
    if keepalive_s and keepalive_s > 0:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        idle = max(1, int(keepalive_s))
        for opt, val in (("TCP_KEEPIDLE", idle),
                         ("TCP_KEEPINTVL", max(1, idle // 3)),
                         ("TCP_KEEPCNT", 3)):
            if hasattr(socket, opt):
                try:
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    getattr(socket, opt), val)
                except OSError:
                    pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise HandshakeError(
                f"peer closed mid-handshake ({len(buf)}/{n} bytes)"
            )
        buf += chunk
    return buf


def client_handshake(sock: socket.socket, *, token: str, shard_id: str,
                     epoch: int, cursor: int, resume: bool,
                     timeout: float = 2.0) -> Tuple[int, int, int]:
    """The dialing (runner) half: read challenge, answer with the
    MAC'd auth record, read the verdict.  Returns ``(code, epoch,
    server_cursor)``; raises :class:`HandshakeError` on wire garbage or
    a dropped connection (refusals come back as codes, not raises — the
    caller decides whether a fence is fatal)."""
    sock.settimeout(timeout)
    raw = _recv_exact(sock, CHALLENGE.size)
    magic, version, _flags, nonce = CHALLENGE.unpack(raw)
    if magic != HS_MAGIC_CHALLENGE:
        raise HandshakeError(f"bad challenge magic {magic!r}")
    if version != HS_VERSION:
        # version negotiation, v1 edition: one version exists; a client
        # that only speaks it must bail loudly on anything else
        raise HandshakeError(f"server speaks handshake v{version}, "
                             f"this runner speaks v{HS_VERSION}")
    sock.sendall(pack_auth(token, nonce, epoch=epoch, cursor=cursor,
                           shard_id=shard_id, resume=resume))
    raw = _recv_exact(sock, VERDICT.size)
    magic, _version, code, granted_epoch, srv_cursor = VERDICT.unpack(raw)
    if magic != HS_MAGIC_VERDICT:
        raise HandshakeError(f"bad verdict magic {magic!r}")
    return code, granted_epoch, srv_cursor


class PendingHandshake:
    """The accepting (supervisor) half of one in-flight handshake, as a
    non-blocking state machine: the challenge goes out at accept, then
    :meth:`pump` drains whatever bytes have arrived toward one complete
    auth record, against a hard deadline.  A slowloris that dribbles a
    byte a second, or a scanner that sends garbage, costs the
    supervisor one fd until the deadline — never a blocked tick loop."""

    def __init__(self, sock: socket.socket, *, token: str,
                 deadline: float, started: float) -> None:
        self.sock = sock
        self.token = token
        self.deadline = deadline
        self.started = started
        self.nonce = os.urandom(NONCE_BYTES)
        self.auth: Optional[Dict[str, Any]] = None
        self.failed: Optional[str] = None
        self._buf = bytearray()
        try:
            # 20 bytes into a fresh send buffer: never blocks in practice
            sock.settimeout(0.5)
            sock.sendall(CHALLENGE.pack(
                HS_MAGIC_CHALLENGE, HS_VERSION, 0, self.nonce))
            sock.setblocking(False)
        except OSError:
            self.failed = "eof"

    def pump(self, now: float) -> Optional[str]:
        """Returns ``None`` while still reading, ``"auth"`` once a
        well-formed record is parsed (MAC verdict in ``self.auth``), or
        a failure reason (``timeout`` / ``eof`` / ``garbage``)."""
        if self.failed is not None:
            return self.failed
        if self.auth is not None:
            return "auth"
        if now >= self.deadline:
            self.failed = "timeout"
            return self.failed
        while len(self._buf) < AUTH.size:
            try:
                chunk = self.sock.recv(AUTH.size - len(self._buf))
            except (BlockingIOError, InterruptedError):
                return None
            except OSError:
                self.failed = "eof"
                return self.failed
            if not chunk:
                self.failed = "eof"
                return self.failed
            self._buf += chunk
            # fail garbage as soon as the magic is readable — a scanner
            # spraying junk should not hold the fd until its deadline
            if len(self._buf) >= 2 and bytes(self._buf[:2]) != HS_MAGIC_AUTH:
                self.failed = "garbage"
                return self.failed
        prefix = bytes(self._buf[:AUTH_PREFIX.size])
        (_magic, version, flags, epoch, cursor,
         shard_raw, mac) = AUTH.unpack(bytes(self._buf))
        self.auth = dict(
            version=version, flags=flags, epoch=epoch, cursor=cursor,
            shard=shard_raw.rstrip(b"\0").decode("utf-8", "replace"),
            mac_ok=hmac.compare_digest(
                mac, handshake_mac(self.token, self.nonce, prefix)),
        )
        return "auth"

    def _send_verdict(self, code: int, epoch: int, cursor: int) -> bool:
        try:
            self.sock.settimeout(2.0)
            self.sock.sendall(VERDICT.pack(
                HS_MAGIC_VERDICT, HS_VERSION, code, epoch, cursor))
            return True
        except OSError:
            return False

    def grant(self, code: int, epoch: int,
              cursor: int) -> Optional[socket.socket]:
        """Send an accepting verdict and hand the socket over (blocking
        mode restored).  ``None`` if the peer died first."""
        if self._send_verdict(code, epoch, cursor):
            self.sock.setblocking(True)
            return self.sock
        self.close()
        return None

    def refuse(self, code: int, epoch: int = 0) -> None:
        self._send_verdict(code, epoch, 0)
        self.close()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class ShardLink:
    """Supervisor-side link endpoint for one proc shard: the listener,
    the in-flight handshakes, the epoch mint, and the link state
    machine.  Owns every ``link_state`` assignment in the tree (the
    conformance lint scans exactly this file)."""

    # how many concurrent half-open handshakes we will hold fds for;
    # beyond it new connects are dropped at accept (slowloris clamp)
    MAX_PENDING = 8

    def __init__(self, shard_id: str, tuning: Any, *,
                 host: str = "127.0.0.1", port: int = 0,
                 metrics: Any = None) -> None:
        self.shard_id = shard_id
        self.tuning = tuning
        self.link_state = LINK_CONNECTING
        self.epoch = 0
        self.window_deadline: Optional[float] = None
        self.conn: Optional[RpcConn] = None
        self.reconnects = 0
        self.window_expiries = 0
        self.refusals: Dict[str, int] = {}
        self._fresh_granted = False
        self._pending: List[PendingHandshake] = []
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(
            socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(self.MAX_PENDING)
        self._listener.setblocking(False)
        self.address: Tuple[str, int] = self._listener.getsockname()[:2]
        if metrics is None:
            from ..obs.registry import Registry
            metrics = Registry()
        self._m_reconnects = metrics.counter(
            "ggrs_fleet_link_reconnects_total",
            "severed links resumed inside the reconnect window",
            labels=("shard",))
        self._m_refusals = metrics.counter(
            "ggrs_fleet_link_refusals_total",
            "handshakes refused or abandoned, by reason",
            labels=("shard", "reason"))
        self._m_expiries = metrics.counter(
            "ggrs_fleet_link_window_expiries_total",
            "reconnect windows that closed without a resume",
            labels=("shard",))
        self._h_handshake = metrics.histogram(
            "ggrs_fleet_link_handshake_seconds",
            "accept → verdict latency per handshake attempt",
            buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0),
            labels=("shard",))
        self._g_epoch = metrics.gauge(
            "ggrs_fleet_link_epoch",
            "current supervisor-minted epoch per shard link",
            labels=("shard",))

    # -- epoch mint + state verbs --------------------------------------

    def mint_epoch(self) -> int:
        """Supervisor-minted fencing token: bumped on every (re)spawn
        and every confirmed-death teardown, so any runner holding an
        older epoch is refused at handshake."""
        self.epoch += 1
        self._g_epoch.labels(shard=self.shard_id).set(self.epoch)
        return self.epoch

    def established(self, conn: RpcConn) -> None:
        """A fresh handshake's conn passed hello: the link is serving."""
        self.conn = conn
        self._fresh_granted = False
        self.window_deadline = None
        # ggrs-model: transitions(connecting->up)
        self.link_state = LINK_UP

    def sever(self, now: Optional[float] = None) -> None:
        """EOF while the process (for all we know) lives: open the
        reconnect window.  Failover is forbidden until it closes."""
        now = time.monotonic() if now is None else now
        self.window_deadline = now + self.tuning.link_reconnect_window_s
        # ggrs-model: transitions(up->reconnecting)
        self.link_state = LINK_RECONNECTING
        _logger.warning(
            "shard %s link severed; reconnect window %.2fs (epoch %d)",
            self.shard_id, self.tuning.link_reconnect_window_s, self.epoch,
        )

    def expire(self, now: Optional[float] = None) -> None:
        """The window closed without a resume: the runner is CONFIRMED
        unreachable — count it, fence it, and let failover proceed."""
        self.window_expiries += 1
        self._m_expiries.labels(shard=self.shard_id).inc()
        self.down("reconnect window expired")

    def down(self, reason: str) -> None:
        """Terminal for this incarnation: drop pending handshakes,
        forget the conn, bump the epoch so the old runner stays fenced."""
        for hs in self._pending:
            hs.close()
        self._pending = []
        self.conn = None
        self._fresh_granted = False
        self.window_deadline = None
        if self.link_state != LINK_DOWN:
            # ggrs-model: transitions(connecting->down, reconnecting->down, up->down)
            self.link_state = LINK_DOWN
            self.mint_epoch()
            _logger.info("shard %s link down (%s); epoch now %d",
                         self.shard_id, reason, self.epoch)

    def reopen(self) -> None:
        """Arm for the next incarnation (respawn / re-adoption)."""
        if self.link_state == LINK_DOWN:
            # ggrs-model: transitions(down->connecting)
            self.link_state = LINK_CONNECTING
        self._fresh_granted = False

    # -- the accept/handshake pump -------------------------------------

    def pump(self, now: Optional[float] = None) -> Optional[Tuple[str, Any]]:
        """One non-blocking step: accept new connections, advance every
        in-flight handshake, judge the completed ones.  Returns the
        first significant event — ``("fresh", sock)`` for a granted
        fresh handshake (caller builds the conn + hello), ``("resumed",
        None)`` after an in-place resume — else ``None``."""
        now = time.monotonic() if now is None else now
        while True:
            try:
                s, _addr = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break
            if len(self._pending) >= self.MAX_PENDING:
                s.close()
                self._count_refusal("overflow")
                continue
            tune_tcp_socket(s, self.tuning.link_keepalive_s)
            self._pending.append(PendingHandshake(
                s, token=self.tuning.link_auth_token,
                deadline=now + self.tuning.link_handshake_timeout_s,
                started=now))
        event: Optional[Tuple[str, Any]] = None
        still: List[PendingHandshake] = []
        for hs in self._pending:
            r = hs.pump(now)
            if r is None:
                still.append(hs)
                continue
            if r != "auth":
                # timeout / eof / garbage: no verdict owed — close and
                # count (feeding scanners a protocol answer helps them)
                hs.close()
                self._count_refusal(r)
                continue
            ev = self._judge(hs, now)
            if event is None and ev is not None:
                event = ev
        self._pending = still
        return event

    def _count_refusal(self, reason: str) -> None:
        self.refusals[reason] = self.refusals.get(reason, 0) + 1
        self._m_refusals.labels(shard=self.shard_id, reason=reason).inc()

    def _judge(self, hs: PendingHandshake,
               now: float) -> Optional[Tuple[str, Any]]:
        a = hs.auth or {}
        self._h_handshake.labels(shard=self.shard_id).observe(
            max(0.0, now - hs.started))
        if a.get("version") != HS_VERSION:
            hs.refuse(HS_REFUSED_VERSION)
            self._count_refusal("version")
            return None
        if not a.get("mac_ok"):
            hs.refuse(HS_REFUSED_AUTH)
            self._count_refusal("auth")
            return None
        if a["shard"] and a["shard"] != self.shard_id[:SHARD_ID_BYTES]:
            hs.refuse(HS_REFUSED_AUTH)
            self._count_refusal("auth")
            return None
        if a["flags"] & AUTH_FLAG_RESUME:
            # THE fencing rule: an epoch that is not the current mint is
            # a dead incarnation talking — refuse before any state moves
            if a["epoch"] != self.epoch:
                hs.refuse(HS_REFUSED_FENCE, self.epoch)
                self._count_refusal("fence")
                _logger.warning(
                    "shard %s: fenced stale runner (epoch %d, current "
                    "%d)", self.shard_id, a["epoch"], self.epoch)
                return None
            if self.link_state == LINK_UP:
                # half-open: the runner saw an EOF we have not — its
                # authed, epoch-current resume IS the sever signal
                self.sever(now)
            if self.link_state != LINK_RECONNECTING or self.conn is None:
                hs.refuse(HS_REFUSED_RESUME, self.epoch)
                self._count_refusal("resume")
                return None
            if not self.conn.can_resume(a["cursor"]):
                # resume impossible: explicit epoch bump + full
                # re-adopt (down() mints) instead of a silent gap
                hs.refuse(HS_REFUSED_RESUME, self.epoch)
                self._count_refusal("resume")
                self.down("resume impossible: frame gap past the "
                          "retain ring")
                return None
            sock = hs.grant(HS_OK_RESUME, self.epoch, self.conn.rx_seq)
            if sock is None:
                return None
            try:
                self.conn.reattach(sock)
                self.conn.replay_from(a["cursor"])
            except (RpcError, OSError) as e:
                _logger.warning("shard %s resume replay failed (%s); "
                                "window stays open", self.shard_id, e)
                return None
            self.reconnects += 1
            self._m_reconnects.labels(shard=self.shard_id).inc()
            self.window_deadline = None
            # ggrs-model: transitions(reconnecting->up)
            self.link_state = LINK_UP
            _logger.info("shard %s link resumed (epoch %d)",
                         self.shard_id, self.epoch)
            return ("resumed", None)
        # fresh connect
        if self.link_state != LINK_CONNECTING or self._fresh_granted:
            hs.refuse(HS_REFUSED_BUSY, self.epoch)
            self._count_refusal("busy")
            return None
        sock = hs.grant(HS_OK_FRESH, self.epoch, 0)
        if sock is None:
            return None
        self._fresh_granted = True
        return ("fresh", sock)

    def wait_for_runner(self, timeout: float) -> socket.socket:
        """Blocking pump until a fresh handshake is granted (the spawn /
        adoption path).  Raises ``TimeoutError`` past ``timeout``."""
        deadline = time.monotonic() + timeout
        while True:
            now = time.monotonic()
            ev = self.pump(now)
            if ev is not None and ev[0] == "fresh":
                return ev[1]
            if now >= deadline:
                raise TimeoutError(
                    f"shard {self.shard_id}: no runner handshake within "
                    f"{timeout:.1f}s on {self.address[0]}:{self.address[1]}"
                )
            rl = [self._listener] + [h.sock for h in self._pending]
            try:
                select.select(rl, [], [], min(0.05, deadline - now))
            except (OSError, ValueError):
                pass

    def info(self) -> Dict[str, Any]:
        return dict(
            state=self.link_state,
            epoch=self.epoch,
            address=f"{self.address[0]}:{self.address[1]}",
            reconnects=self.reconnects,
            window_expiries=self.window_expiries,
            refusals=dict(self.refusals),
            pending=len(self._pending),
        )

    def close(self) -> None:
        for hs in self._pending:
            hs.close()
        self._pending = []
        self.conn = None
        try:
            self._listener.close()
        except OSError:
            pass


class RunnerLink:
    """Runner-side dialer: the fresh connect at startup and the
    jittered-backoff resume loop inside the runner's own reconnect
    window.  Holds the supervisor-granted epoch token."""

    def __init__(self, host: str, port: int, *, token: str,
                 shard_id: str = "") -> None:
        self.host = host
        self.port = port
        self.token = token
        self.shard_id = shard_id
        self.epoch = 0
        # pre-hello defaults; configure() re-reads them from the
        # supervisor's FleetTuning once hello delivers it
        self.window_s = 3.0
        self.backoff_s = 0.05
        self.handshake_timeout_s = 2.0
        self.keepalive_s = 5.0
        self._rng = random.Random(
            zlib.crc32((shard_id or host).encode()) ^ 0x71CB)

    def configure(self, tuning: Any) -> None:
        self.window_s = tuning.link_reconnect_window_s
        self.backoff_s = tuning.link_backoff_s
        self.handshake_timeout_s = tuning.link_handshake_timeout_s
        self.keepalive_s = tuning.link_keepalive_s

    def _dial(self, *, epoch: int, cursor: int,
              resume: bool) -> Tuple[int, int, int, socket.socket]:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.handshake_timeout_s)
        try:
            tune_tcp_socket(sock, self.keepalive_s)
            code, granted, srv_cursor = client_handshake(
                sock, token=self.token, shard_id=self.shard_id,
                epoch=epoch, cursor=cursor, resume=resume,
                timeout=self.handshake_timeout_s)
        except BaseException:
            sock.close()
            raise
        if code not in (HS_OK_FRESH, HS_OK_RESUME):
            sock.close()
        return code, granted, srv_cursor, sock

    def dial_fresh(self, timeout: float = 30.0) -> socket.socket:
        """Startup connect, retried with jittered backoff until the
        supervisor's listener answers (it may not be pumping yet)."""
        deadline = time.monotonic() + timeout
        attempt = 0
        last: Optional[BaseException] = None
        while time.monotonic() < deadline:
            try:
                code, granted, _cur, sock = self._dial(
                    epoch=0, cursor=0, resume=False)
            except (OSError, HandshakeError) as e:
                last = e
            else:
                if code == HS_OK_FRESH:
                    self.epoch = granted
                    return sock
                if code in (HS_REFUSED_AUTH, HS_REFUSED_VERSION,
                            HS_REFUSED_FENCE):
                    raise HandshakeError(
                        f"supervisor refused fresh handshake "
                        f"(code {code})")
                last = HandshakeError(f"verdict code {code}")
            delay = (self.backoff_s * (2 ** min(attempt, 6))
                     * (0.5 + self._rng.random()))
            attempt += 1
            time.sleep(min(delay, max(
                0.0, deadline - time.monotonic())))
        raise HandshakeError(
            f"no supervisor on {self.host}:{self.port} within "
            f"{timeout:.1f}s: {last}")

    def reconnect(self, conn: RpcConn) -> str:
        """The runner half of the reconnect window: redial with
        jittered backoff, present the granted epoch + rx cursor, resume
        the conn in place on success.  Returns ``"resumed"``,
        ``"fenced"`` (a newer incarnation owns the shard — exit, do not
        fail over the supervisor's decision), ``"refused"``, or
        ``"gave-up"`` (window exhausted)."""
        if conn.poisoned is not None:
            return "refused"  # a poisoned stream must not be resumed
        deadline = time.monotonic() + self.window_s
        attempt = 0
        while True:
            try:
                code, _granted, srv_cursor, sock = self._dial(
                    epoch=self.epoch, cursor=conn.rx_seq, resume=True)
            except (OSError, HandshakeError):
                code, sock = None, None
            if code in (HS_OK_RESUME, HS_OK_FRESH) and sock is not None:
                try:
                    conn.reattach(sock)
                    conn.replay_from(srv_cursor)
                    return "resumed"
                except (RpcError, OSError):
                    try:
                        sock.close()
                    except OSError:
                        pass
            elif code == HS_REFUSED_FENCE:
                return "fenced"
            elif code in (HS_REFUSED_AUTH, HS_REFUSED_VERSION):
                return "refused"
            # HS_REFUSED_RESUME / HS_REFUSED_BUSY / no answer: the
            # supervisor may still be noticing the sever — keep trying
            now = time.monotonic()
            if now >= deadline:
                return "gave-up"
            delay = (self.backoff_s * (2 ** min(attempt, 6))
                     * (0.5 + self._rng.random()))
            attempt += 1
            time.sleep(min(delay, max(0.0, deadline - now)))
