"""Out-of-process shards: the subprocess shard runner and the
supervisor-side process backend (DESIGN.md §17).

The port's copy of ``ggrs_tpu/fleet/proc.py``.

The fleet made a running match a portable object; this module makes the shard
a real OS process, so a segfault in one shard's native bank, a wedged
GIL, or an OOM kill is a FAULT DOMAIN, not a fleet outage:

- :class:`ShardRunner` — the child side: one :class:`PoolShard` serving
  loop driven entirely over the :mod:`~ggrs_tpu_torch.fleet.rpc` frame
  protocol (one ``tick`` call per fleet tick carries the clock and the
  staged inputs; the reply carries frames/events/health/identities).
  Requests are fulfilled IN the runner by per-match games built from the
  shipped ``game_factory`` — request lists hold live state cells and can
  never cross a process boundary.  SIGTERM/SIGINT run a graceful drain
  (admission off, journals flushed+fsynced+closed, a final GOODBYE
  frame) so an orderly shutdown leaves journals durable to the last
  served frame.
- :class:`ProcShard` — the supervisor side: spawn (socketpair) or adopt
  (UNIX socket) a runner, present the same surface as the in-process
  :class:`~ggrs_tpu_torch.fleet.shard.PoolShard` (one supervisor interface,
  mixed fleets allowed), and own the liveness story: heartbeat-age
  tracking, crash detection (waitpid/EOF), and a hang watchdog DISTINCT
  from crash detection — wedged ≠ dead.  A hung runner (tick RPC
  timeout, stale heartbeats, poisoned stream) is escalated
  SIGTERM → drain deadline → SIGKILL, and only a CONFIRMED-dead process
  is failed over: a wedged process may still be sending to peers, and
  re-adopting its matches while it breathes would put two incarnations
  on the wire.  After death, a jittered-backoff restart policy respawns
  the shard — bounded by a restart-storm budget so a crash loop cannot
  melt the host.

Match descriptions for process-backed shards must be PICKLABLE: the
``builder_factory`` / ``socket_factory`` / ``game_factory`` a match is
admitted with are shipped to the runner and called there (module-level
callables and :func:`functools.partial` over plain data qualify —
enforced naturally by the transport).  Builders use
:func:`runner_clock` so the supervisor's tick clock reaches the child:
each ``tick`` RPC ships the clock value and the runner stores it in the
module cell before ticking, which keeps a process-backed run
bit-identical to the same matches served in-process (the parity pin in
``tests/test_fleet_proc.py``).
"""

from __future__ import annotations

import os
import random
import select
import signal
import socket
import subprocess
import sys
import time
import traceback
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.errors import InvalidRequest
from ..obs.fleet_obs import FleetObs, RegistryCollector
from ..obs.registry import DEFAULT, Registry, default_registry
from ..obs.trace import NULL_TRACER, Tracer
from ..utils.tracing import get_logger
from .rpc import (
    FrameError,
    KIND_CALL,
    KIND_ERR,
    KIND_GOODBYE,
    KIND_HEARTBEAT,
    KIND_REPLY,
    RpcClosed,
    RpcConn,
    RpcError,
    RpcRemoteError,
    RpcTimeout,
)
from .shard import (
    PoolShard,
    SHARD_ACTIVE,
    SHARD_DEAD,
    SHARD_DRAINING,
    SHARD_RETIRED,
)
from .transport import (
    HandshakeError,
    LINK_DOWN,
    LINK_RECONNECTING,
    LINK_UP,
    RunnerLink,
    ShardLink,
)
from .tuning import FleetTuning

_logger = get_logger("fleet")

_REPO_ROOT = Path(__file__).resolve().parents[2]
_RUNNER_SCRIPT = _REPO_ROOT / "scripts" / "port_shard_runner.py"

# remote exception types the proxy re-raises as their local class (the
# supervisor's control flow catches InvalidRequest around evict/admit)
_REMOTE_TYPES = {"InvalidRequest": InvalidRequest}

_RPC_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 1.0, 5.0)


# ----------------------------------------------------------------------
# the runner-side clock cell
# ----------------------------------------------------------------------

# Builders for process-placeable matches read their session clock from
# this module cell: the supervisor ships the clock VALUE with every tick
# RPC, and in-process runs drive the same cell locally — one builder
# description serves both backends bit-identically.
_RUNNER_CLOCK = [0]


def runner_clock() -> int:
    """The session clock for process-placeable matches (see module
    docstring) — picklable by reference, readable in either process."""
    return _RUNNER_CLOCK[0]


def set_runner_clock(value: int) -> None:
    """Drive :func:`runner_clock` locally (in-process shards / tests);
    the shard runner calls this with every tick RPC's clock field."""
    _RUNNER_CLOCK[0] = value


def proc_match_builder(seed: int, me: int, peer_addr, peer_handle=None,
                       desync_interval: int = 0, input_bits: int = 16):
    """A fully-picklable 2-peer match description for process-backed
    shards: ``functools.partial(proc_match_builder, seed, me, addr)`` is
    the ``builder_factory`` shape the proc chaos/test topologies admit
    with.  Uses :func:`runner_clock` (see module docstring) and a
    seed-derived rng so both backends build bit-identical sessions."""
    from ..core import Local, Remote
    from ..core.config import Config
    from ..core.types import DesyncDetection
    from ..sessions import SessionBuilder

    addr = tuple(peer_addr) if isinstance(peer_addr, (list, tuple)) \
        else peer_addr
    b = (
        SessionBuilder(Config.for_uint(input_bits))
        .with_clock(runner_clock)
        .with_rng(random.Random(seed))
        .add_player(Local(), me)
        .add_player(Remote(addr),
                    peer_handle if peer_handle is not None else 1 - me)
    )
    if desync_interval:
        b = b.with_desync_detection_mode(
            DesyncDetection.on(desync_interval)
        )
    return b


def udp_socket_factory(port: int = 0):
    """Picklable ``socket_factory`` for process-backed matches: binds a
    real UDP socket IN the serving process (the supervisor learns the
    chosen port from the admit reply)."""
    from ..net.sockets import UdpNonBlockingSocket

    return UdpNonBlockingSocket(port)


def _discard_stub_journal(journal) -> None:
    """Remove a journal whose admission/adoption failed before any match
    data was written: leaving the header-only file would make every
    retry of the same incarnation path fail the exclusive-create
    contract (FileExistsError) — one transient failure must not cascade
    into a permanently unplaceable match.  Only record-free stubs are
    ever unlinked; a journal with data is a durable artifact."""
    if journal is None:
        return
    if journal.next_frame != 0 or journal.tail:
        return  # real records: never destroy a durable artifact
    try:
        journal._f.close()
    except Exception:
        pass
    try:
        os.unlink(journal.path)
    except OSError:
        pass


def _fulfill_default(requests) -> None:
    """Fallback request fulfillment when a match ships no game_factory:
    saves store the frame number (the chaos harness convention), loads
    validate.  Real deployments ship a game; this keeps a spec-less
    match's session machinery alive rather than wedging it."""
    for r in requests:
        k = type(r).__name__
        if k == "SaveGameState":
            r.cell.save(r.frame, r.frame, None)
        elif k == "LoadGameState":
            assert r.cell.data() is not None


# ======================================================================
# the child side: ShardRunner
# ======================================================================


class _GracefulExit(Exception):
    """Raised by the SIGTERM/SIGINT handlers to unwind into the drain."""


class ShardRunner:
    """One shard subprocess: a :class:`PoolShard` serving loop spoken to
    over framed RPC.  Single-threaded; heartbeats ride the idle gaps of
    the same loop (no threads to wedge independently of the serving
    path — if this loop is stuck, heartbeats stop, which is exactly the
    signal the supervisor's watchdog wants)."""

    def __init__(self, conn: RpcConn, link=None) -> None:
        self.conn = conn
        # the TCP dialer (fleet.transport.RunnerLink) when serving over
        # --tcp: owns the reconnect window; None on fd/uds transports
        self._link = link
        self.shard: Optional[PoolShard] = None
        self.tuning = FleetTuning()
        self._games: Dict[str, Any] = {}
        self._exit_after_reply: Optional[str] = None
        # fleet observability plane (DESIGN.md §18): armed by hello
        self.tracer: Tracer = NULL_TRACER
        self.collector: Optional[RegistryCollector] = None
        self._spans_shipped = 0
        # snapshots drained into a heartbeat whose send then failed:
        # re-shipped (in seq order, bounded) ahead of the next fresh one
        self._unsent_snaps: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def serve(self) -> int:
        def _on_signal(signum, frame):
            raise _GracefulExit(signal.Signals(signum).name.lower())

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
        while True:
            try:
                self._loop()
                return 0
            except _GracefulExit as e:
                self._graceful_exit(str(e))
                return 0
            except RpcClosed as e:
                # over TCP an EOF is a LINK failure, not a death
                # sentence: redial inside the reconnect window and
                # resume the frame stream in place (DESIGN.md §25).
                # A fence verdict means a newer incarnation owns the
                # shard — exit without a fight.
                if self._link is not None and self.conn.poisoned is None:
                    r = self._link.reconnect(self.conn)
                    if r == "resumed":
                        continue
                    if r == "fenced":
                        self._quiet_exit(
                            f"fenced at reconnect (stale epoch): {e}")
                        return 1
                self._quiet_exit(str(e))
                return 1
            except (FrameError, RpcTimeout) as e:
                # the stream is poisoned or a frame never completed:
                # corruption cannot be resumed — leave the journals
                # durable and exit nonzero so an init system knows
                # this was not a drain
                self._quiet_exit(str(e))
                return 1

    def _loop(self) -> None:
        hb_next = time.monotonic() + self.tuning.heartbeat_interval_s
        while True:
            now = time.monotonic()
            if now >= hb_next:
                # re-arm unconditionally (a pre-hello runner must idle in
                # select, not busy-spin); send only once serving
                hb_next = now + self.tuning.heartbeat_interval_s
                if self.shard is not None:
                    # the harvest piggyback: metric deltas (and any
                    # ferried forensics) ride the heartbeat too, so an
                    # idle or rarely-ticked shard still exports (§18)
                    payload = self._obs_payload(include_spans=False)
                    try:
                        self.conn.send(KIND_HEARTBEAT, dict(
                            ticks=self.shard.ticks,
                            matches=self.shard.live_matches(),
                            obs=payload,
                        ), timeout=5.0)
                    except RpcTimeout:
                        # supervisor slow to drain; ticks prove life —
                        # but the drained payload is one-shot state:
                        # requeue it for the next ship attempt
                        self._requeue_obs(payload)
            wait = max(0.0, hb_next - now)
            r, _, _ = select.select([self.conn.fileno()], [], [], wait)
            if not r:
                continue
            kind, msg = self.conn.recv(timeout=10.0)
            if kind != KIND_CALL:
                continue
            self._dispatch(msg)
            if self._exit_after_reply is not None:
                raise _GracefulExit(self._exit_after_reply)

    def _dispatch(self, msg: Dict[str, Any]) -> None:
        op = msg.get("op")
        # the call's correlation id is echoed in the reply envelope so
        # a supervisor that abandoned the call (link sever mid-RPC, then
        # a TCP resume replaying this reply) can drop it instead of
        # mistaking it for a later call's answer
        cid = msg.get("_cid")
        handler = getattr(self, f"_op_{op}", None)
        try:
            if handler is None:
                raise InvalidRequest(f"unknown rpc op {op!r}")
            result = handler(msg)
        except _GracefulExit:
            raise
        except Exception as e:
            err = dict(
                type=type(e).__name__, msg=str(e),
                traceback=traceback.format_exc(),
            )
            if cid is not None:
                err["_cid"] = cid
            self.conn.send(KIND_ERR, err)
        else:
            if cid is not None:
                self.conn.send(KIND_REPLY, dict(_cid=cid, _r=result))
            else:
                self.conn.send(KIND_REPLY, result)

    def _graceful_exit(self, reason: str) -> None:
        """The drain: admission off, journals flushed + fsynced + closed
        (durable to the last served frame), one final GOODBYE."""
        frames: Dict[str, int] = {}
        try:
            if self.shard is not None:
                if self.shard.state == SHARD_ACTIVE:
                    self.shard.state = SHARD_DRAINING  # admission off
                for mid in self.shard.match_ids():
                    try:
                        frames[mid] = self.shard.current_frame(mid)
                    except Exception:
                        pass
                self.shard.flush_journals(close=True)
        finally:
            try:
                self.conn.send(KIND_GOODBYE, dict(
                    reason=reason, frames=frames,
                    shard=None if self.shard is None
                    else self.shard.shard_id,
                ), timeout=2.0)
            except RpcError:
                pass
            self.conn.close()

    def _quiet_exit(self, reason: str) -> None:
        try:
            if self.shard is not None:
                self.shard.flush_journals(close=True)
        finally:
            self.conn.close()
        _logger.error("shard runner exiting without supervisor: %s", reason)

    # ------------------------------------------------------------------
    # ops
    # ------------------------------------------------------------------

    def _op_hello(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        cfg = msg["config"]
        if cfg.get("tuning"):
            self.tuning = FleetTuning.from_dict(cfg["tuning"])
            self.conn.max_frame = self.tuning.max_frame_bytes
        if self._link is not None:
            # serving over TCP: adopt the supervisor's reconnect policy
            # and start retaining sent frames so a severed link can
            # resume instead of failing over
            self._link.configure(self.tuning)
            self.conn.enable_retain(self.tuning.link_retain_frames)
        if cfg.get("trace"):
            # the supervisor is tracing: arm a local ring whose spans
            # ship back in tick replies (fleet trace correlation, §18)
            self.tracer = Tracer(capacity=4096)
        self.shard = PoolShard(
            cfg["shard_id"],
            capacity=cfg.get("capacity", 64),
            metrics=Registry(),
            tracer=self.tracer if self.tracer.enabled else None,
            checkpoint_every=cfg.get("checkpoint_every", 32),
            p99_budget_ms=cfg.get("p99_budget_ms"),
            stale_after_s=cfg.get("stale_after_s"),
            native_io=cfg.get("native_io", False),
            retire_dead_matches=cfg.get("retire_dead_matches", False),
            tuning=self.tuning,
        )
        if self.tuning.obs_harvest:
            # the shard's private registry PLUS the process-wide DEFAULT
            # (protocol drops, socket errors) — everything this child
            # measures becomes harvestable
            self.collector = RegistryCollector(
                self.shard.metrics, DEFAULT, gen=os.getpid(),
            )
        return dict(pid=os.getpid(), shard_id=self.shard.shard_id)

    def _obs_payload(self, include_spans: bool,
                     req_ns: Optional[int] = None
                     ) -> Optional[Dict[str, Any]]:
        """The piggybacked obs payload for one reply/heartbeat: metric
        deltas, ferried forensics, new trace spans, and the runner's
        clock samples for the offset estimate (``req_ns`` = request
        receipt, ``now_ns`` = reply build — the NTP T2/T3 pair).  None
        when the harvest is off or nothing happened — idle shards cost
        nothing."""
        if self.collector is None and not self.tracer.enabled:
            return None
        payload: Dict[str, Any] = {}
        snaps = self._unsent_snaps
        self._unsent_snaps = []
        if self.collector is not None:
            snap = self.collector.collect()
            if snap is not None:
                snaps = snaps + [snap]
        if snaps:
            payload["metrics"] = snaps[0] if len(snaps) == 1 else snaps
        if self.shard is not None:
            forensics = self.shard.drain_forensics()
            if forensics:
                payload["forensics"] = forensics
            timeline = self.shard.drain_timeline()
            if timeline:
                payload["timeline"] = timeline
        if include_spans and self.tracer.enabled:
            spans = self._new_spans()
            if spans:
                payload["spans"] = spans
        if not payload:
            return None
        if req_ns is not None:
            payload["req_ns"] = req_ns
        payload["now_ns"] = time.perf_counter_ns()
        return payload

    def _requeue_obs(self, payload: Optional[Dict[str, Any]]) -> None:
        """A drained-but-unsent payload's one-shot pieces go back in the
        queue: forensics to the shard's ferry buffer (its 32-item bound
        still applies), metric snapshots to ``_unsent_snaps`` (bounded;
        a dropped snapshot surfaces as a seq gap at the supervisor)."""
        if not payload:
            return
        forensics = payload.get("forensics")
        if forensics and self.shard is not None:
            self.shard._forensic_items[:0] = forensics
            del self.shard._forensic_items[:-32]
        timeline = payload.get("timeline")
        if timeline and self.shard is not None:
            self.shard._timeline_items[:0] = timeline
            del self.shard._timeline_items[:-64]
        snaps = payload.get("metrics")
        if snaps:
            if not isinstance(snaps, list):
                snaps = [snaps]
            self._unsent_snaps.extend(snaps)
            del self._unsent_snaps[:-8]

    def _new_spans(self) -> List[tuple]:
        """Ring events recorded since the last ship, capped per reply —
        the OLDEST unshipped first, and the cursor advances only past
        what actually shipped, so a burst defers to the next reply
        instead of silently dropping; only spans the ring itself evicted
        before shipping are lost (the ring's bound caps total lag)."""
        unshipped = self.tracer.recorded - self._spans_shipped
        if unshipped <= 0:
            return []
        avail = min(unshipped, len(self.tracer))
        lost = unshipped - avail  # evicted by the ring before shipping
        cap = max(1, int(self.tuning.obs_max_spans_per_reply))
        ship = self.tracer.events(last=avail)[:cap]
        self._spans_shipped += lost + len(ship)
        return ship

    def _op_ping(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return dict(pid=os.getpid())

    def _op_tick(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        t_req = time.perf_counter_ns()  # NTP T2 for the offset estimate
        shard = self._require_shard()
        if msg.get("clock") is not None:
            set_runner_clock(msg["clock"])
        state = msg.get("state")
        if state in (SHARD_ACTIVE, SHARD_DRAINING):
            # ggrs-model: transitions(active->draining, draining->active)
            shard.state = state
        for mid, handle, value in msg.get("inputs", ()):
            shard.add_local_input(mid, handle, value)
        # the fleet tick id threads through the RPC: the runner's tick
        # span carries it, so one Perfetto export correlates this
        # crossing with the supervisor's fleet.tick span (§18)
        with self.tracer.span("runner.tick", cat="fleet",
                              tick=msg.get("fleet_tick"),
                              shard=shard.shard_id):
            out = shard.advance_all()
            n_requests = {}
            for mid, reqs in out.items():
                game = self._games.get(mid)
                if game is not None:
                    game.fulfill(reqs)
                else:
                    _fulfill_default(reqs)
                n_requests[mid] = len(reqs)
        if self.tuning.obs_scrape_every and shard.ticks and (
            shard.ticks % self.tuning.obs_scrape_every == 0
        ):
            try:
                shard.scrape()  # refresh ggrs_io_* / per-slot gauges
            except Exception:
                pass
        mids = shard.match_ids()
        events = {mid: shard.events(mid) for mid in mids}
        frames: Dict[str, int] = {}
        identities: Dict[str, Any] = {}
        for mid in mids:
            try:
                frames[mid] = shard.current_frame(mid)
            except Exception:
                pass
            try:
                identities[mid] = shard.wire_identity(mid)
            except Exception:
                pass  # e.g. pool not started; next tick catches it
        return dict(
            frames=frames, events=events, n_requests=n_requests,
            identities=identities,
            healthz=shard.healthz(),
            refusal=shard.admission_refusal(),
            journal_failed=shard.journal_failed_matches(),
            obs=self._obs_payload(include_spans=True, req_ns=t_req),
        )

    def _open_journal(self, spec: Optional[Dict[str, Any]]):
        if spec is None:
            return None
        from ..broadcast.journal import MatchJournal

        return MatchJournal(
            spec["path"], spec["num_players"], spec["input_size"],
            meta=spec.get("meta"),
            fsync_every=spec.get("fsync_every", 0),
            tail_window=spec.get("tail_window", 128),
            metrics=self._require_shard().metrics,
        )

    def _register_game(self, match_id: str, game_factory) -> None:
        self._games[match_id] = (
            game_factory() if game_factory is not None else None
        )

    def _op_admit(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        shard = self._require_shard()
        mid = msg["match_id"]
        builder = msg["builder_factory"]()
        sock = msg["socket_factory"]()
        journal = self._open_journal(msg.get("journal"))
        try:
            tier = shard.admit(mid, builder, sock, journal=journal)
        except Exception:
            _discard_stub_journal(journal)
            raise
        self._register_game(mid, msg.get("game_factory"))
        return dict(tier=tier, port=shard.match_port(mid))

    def _op_adopt(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        shard = self._require_shard()
        mid = msg["match_id"]
        builder = msg["builder_factory"]()
        sock = msg["socket_factory"]()
        journal = self._open_journal(msg.get("journal"))
        try:
            shard.adopt_match(
                mid, builder, sock, msg["bundle"],
                saved_states=msg.get("saved_states"),
                prelude=msg.get("prelude"),
                journal=journal,
                replay_local=msg.get("replay_local"),
            )
        except Exception:
            _discard_stub_journal(journal)
            raise
        self._register_game(mid, msg.get("game_factory"))
        return dict(port=shard.match_port(mid))

    def _op_evict(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        bundle = self._require_shard().evict_match(msg["match_id"])
        self._games.pop(msg["match_id"], None)
        return bundle

    def _op_drop(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        self._require_shard().drop_match(
            msg["match_id"], msg.get("reason", "dropped")
        )
        self._games.pop(msg["match_id"], None)
        return {}

    def _op_identity(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return self._require_shard().wire_identity(msg["match_id"])

    def _op_healthz(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        return self._require_shard().healthz()

    def _op_metrics(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Direct registry query (debug/verification — the steady-state
        harvest rides the tick/heartbeat piggyback, never this op): the
        runner's full registries as JSON snapshots."""
        from ..obs.exporters import json_snapshot

        shard = self._require_shard()
        return dict(
            shard=json_snapshot(shard.metrics),
            default=json_snapshot(DEFAULT),
        )

    def _op_inject(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Chaos/test seam: native slot fault injection into one match
        (exercises quarantine → forensics ferry end-to-end)."""
        self._require_shard().inject_match_error(
            msg["match_id"], msg.get("code")
        )
        return {}

    def _op_retire(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        self._require_shard().retire()
        return {}

    def _op_shutdown(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        # reply first, THEN drain and exit (the caller's RPC completes)
        self._exit_after_reply = msg.get("reason", "shutdown")
        return dict(ok=True)

    def _require_shard(self) -> PoolShard:
        if self.shard is None:
            raise InvalidRequest("no hello received yet")
        return self.shard


def runner_main(argv: Optional[List[str]] = None) -> int:
    """Entry point behind ``scripts/port_shard_runner.py``: attach the frame
    transport (an inherited socketpair fd, or accept one connection on a
    UNIX socket path) and serve until drained or disconnected."""
    import argparse

    ap = argparse.ArgumentParser(description="ggrs_tpu_torch fleet shard runner")
    ap.add_argument("--fd", type=int, default=None,
                    help="inherited socketpair fd (spawned runners)")
    ap.add_argument("--uds", default=None, metavar="PATH",
                    help="UNIX socket path to listen on (adopted runners)")
    ap.add_argument("--tcp", default=None, metavar="HOST:PORT",
                    help="dial a supervisor's authenticated TCP link "
                         "(multi-host runners, DESIGN.md §25); the "
                         "shared token rides GGRS_FLEET_LINK_AUTH_TOKEN")
    ap.add_argument("--ingress", action="store_true",
                    help="serve the ingress role (DESIGN.md §26): a "
                         "virtual-endpoint forwarding dataplane instead "
                         "of a PoolShard, same RPC/heartbeat plumbing")
    args = ap.parse_args(argv)
    if sum(a is not None for a in (args.fd, args.uds, args.tcp)) != 1:
        ap.error("exactly one of --fd / --uds / --tcp is required")
    link = None
    if args.fd is not None:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM,
                             fileno=args.fd)
    elif args.uds is not None:
        listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            os.unlink(args.uds)
        except FileNotFoundError:
            pass
        listener.bind(args.uds)
        listener.listen(1)
        sock, _ = listener.accept()
        listener.close()
    else:
        host, _, port = args.tcp.rpartition(":")
        if not port.isdigit():
            ap.error(f"--tcp wants HOST:PORT, got {args.tcp!r}")
        link = RunnerLink(
            host or "127.0.0.1", int(port),
            token=os.environ.get("GGRS_FLEET_LINK_AUTH_TOKEN", ""),
            shard_id=os.environ.get("GGRS_FLEET_LINK_SHARD", ""),
        )
        try:
            sock = link.dial_fresh()
        except (HandshakeError, OSError) as e:
            _logger.error("runner: TCP link handshake failed: %s", e)
            return 1
    if args.ingress:
        # imported here, not at module top: ingress.py imports this
        # module (ShardRunner is its base), so the role dispatch must
        # not close the cycle at import time
        from .ingress import IngressRunner

        return IngressRunner(RpcConn(sock), link=link).serve()
    return ShardRunner(RpcConn(sock), link=link).serve()


# ======================================================================
# the supervisor side: ProcShard
# ======================================================================

# internal process status (orthogonal to the SHARD_* lifecycle states)
PROC_RUNNING = "running"
PROC_TERMINATING = "terminating"  # SIGTERM sent, drain deadline armed
PROC_EXITED = "exited"

# The declared watchdog transition table (DESIGN.md §17, §22): every
# ``self._status`` assignment performs an edge from this table — the
# ggrs-model conformance lint proves it, and the §17 watchdog model
# (analysis/machines.py) parses this tuple to validate its supervisor
# edges.  EXITED is the initial AND the respawn-source status: a shard
# is only failed over once its status reaches EXITED (confirmed death),
# never straight from TERMINATING.
PROC_TRANSITIONS = (
    (PROC_EXITED, PROC_RUNNING),       # spawn / respawn
    (PROC_RUNNING, PROC_TERMINATING),  # wedge detected: SIGTERM sent
    (PROC_RUNNING, PROC_EXITED),       # crash / clean exit, reaped
    (PROC_TERMINATING, PROC_EXITED),   # drained, or SIGKILL past deadline
)


class ProcShard:
    """Supervisor-side proxy for one shard subprocess.

    Presents the :class:`PoolShard` surface the supervisor drives
    (``admission_refusal`` / ``advance_all`` / ``events`` /
    ``wire_identity`` / ``healthz`` / migration verbs), answering from
    the caches the per-tick RPC refreshes wherever a live call could
    block on a wedged child — admission and health checking must never
    wedge the supervisor.  The liveness state machine
    (:meth:`poll_lifecycle`) is driven by the supervisor's control plane
    once per fleet tick.
    """

    backend = "proc"

    def __init__(
        self,
        shard_id: str,
        *,
        capacity: int = 64,
        metrics: Optional[Registry] = None,
        tuning: Optional[FleetTuning] = None,
        clock: Optional[Callable[[], int]] = None,
        checkpoint_every: int = 32,
        p99_budget_ms: Optional[float] = None,
        stale_after_s: Optional[float] = None,
        native_io: bool = False,
        retire_dead_matches: bool = False,
        spawn: bool = True,
        uds_path: Optional[str] = None,
        fleet_obs: Optional[FleetObs] = None,
        tcp: bool = False,
        tcp_host: str = "127.0.0.1",
    ) -> None:
        self.shard_id = shard_id
        self.capacity = capacity
        self.metrics = metrics if metrics is not None else default_registry()
        self.tuning = tuning if tuning is not None else FleetTuning.from_env()
        # the fleet observability sink (DESIGN.md §18): shared when the
        # supervisor owns one (one merged view for the whole fleet),
        # private for a standalone ProcShard
        self.obs = fleet_obs if fleet_obs is not None else FleetObs(
            metrics=self.metrics,
        )
        self.state = SHARD_ACTIVE
        self.killed = False
        self.ticks = 0
        self.pid: Optional[int] = None
        self.restarts = 0
        self.last_exit: Optional[str] = None
        self._clock = clock
        self._config = dict(
            shard_id=shard_id, capacity=capacity,
            checkpoint_every=checkpoint_every,
            p99_budget_ms=p99_budget_ms, stale_after_s=stale_after_s,
            native_io=native_io, retire_dead_matches=retire_dead_matches,
            tuning=self.tuning.as_dict(),
            trace=bool(self.obs.tracer.enabled),
        )
        self._fleet_tick: Optional[int] = None
        # RTT-estimated clock offset between this process's and the
        # runner's perf_counter clocks (runner_ns - supervisor_ns),
        # refined toward the lowest-RTT sample; reset on respawn
        self._clock_offset_ns = 0
        self._offset_rtt_ns: Optional[int] = None
        self._uds_path = uds_path
        self._proc: Optional[subprocess.Popen] = None
        self._conn: Optional[RpcConn] = None
        self._all_procs: List[subprocess.Popen] = []
        self._status = PROC_EXITED
        self._hung_reason: Optional[str] = None
        self._term_deadline: Optional[float] = None
        self._expected_exit = False
        self._respawn_at: Optional[float] = None
        self._restart_times: List[float] = []
        self._rng = random.Random(zlib.crc32(shard_id.encode()) ^ 0x5EED)
        self._inputs: List[Tuple[str, int, Any]] = []
        self._matches: Dict[str, str] = {}          # mid -> tier
        self._ports: Dict[str, Optional[int]] = {}
        self._events: Dict[str, List[Any]] = {}
        self._frames: Dict[str, int] = {}
        self._identities: Dict[str, Dict[str, Any]] = {}
        self._healthz_inner: Dict[str, Any] = {}
        self._refusal_inner: Optional[str] = None
        self._journal_failed: List[str] = []
        m = self.metrics
        self._h_rpc = m.histogram(
            "ggrs_fleet_proc_rpc_seconds",
            "supervisor→runner rpc round-trip latency, by op",
            buckets=_RPC_BUCKETS, labels=("op",))
        self._g_hb_age = m.gauge(
            "ggrs_fleet_proc_heartbeat_age_s",
            "seconds since the runner's last frame of any kind",
            labels=("shard",))
        self._m_restarts = m.counter(
            "ggrs_fleet_proc_restarts_total",
            "shard runner respawns after a death", labels=("shard",))
        self._m_watchdog = m.counter(
            "ggrs_fleet_proc_watchdog_total",
            "hang-watchdog escalation steps", labels=("shard", "stage"))
        self._m_rpc_errors = m.counter(
            "ggrs_fleet_proc_rpc_errors_total",
            "rpcs that timed out / hit a poisoned or closed stream",
            labels=("shard", "kind"))
        self._g_orphans = m.gauge(
            "ggrs_fleet_proc_orphans",
            "spawned runner processes alive past their shard's lifetime")
        # multi-host TCP link (DESIGN.md §25): the supervisor listens and
        # the runner dials in; None for socketpair/uds shards
        self._link: Optional["ShardLink"] = None
        # spawn=True with tcp means we still fork the runner locally, but
        # it connects back over TCP like a remote host would; spawn=False
        # waits for an external `ShardRunner --tcp` to dial in (adopt_tcp)
        self._tcp_spawn_child = spawn
        if tcp:
            self._link = ShardLink(shard_id, self.tuning,
                                   host=tcp_host, metrics=self.metrics)
        if spawn:
            self._spawn()

    # ------------------------------------------------------------------
    # spawn / adopt
    # ------------------------------------------------------------------

    def _spawn(self) -> None:
        if self._link is not None:
            sup_sock = self._spawn_tcp()
        elif self._uds_path is not None:
            sup_sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sup_sock.connect(self._uds_path)  # adopt a running runner
        else:
            sup_sock, run_sock = socket.socketpair()
            try:
                self._proc = subprocess.Popen(
                    [sys.executable, str(_RUNNER_SCRIPT),
                     "--fd", str(run_sock.fileno())],
                    pass_fds=(run_sock.fileno(),),
                )
                self._all_procs.append(self._proc)
            finally:
                run_sock.close()
        self._conn = RpcConn(sup_sock,
                             max_frame=self.tuning.max_frame_bytes)
        if self._link is not None:
            # arm the resume ring before any frame is sent so the hello
            # itself is replayable across a reconnect
            self._conn.enable_retain(self.tuning.link_retain_frames)
        try:
            r = self._conn.call("hello",
                                timeout=self.tuning.spawn_timeout_s,
                                config=self._config)
        except RpcError:
            self._teardown_proc(expect_exit=False)
            raise
        if self._link is not None:
            self._link.established(self._conn)
        self.pid = r["pid"]
        # ggrs-model: transitions(exited->running)
        self._status = PROC_RUNNING
        self._hung_reason = None
        self._term_deadline = None
        self._expected_exit = False
        # a fresh incarnation = a fresh runner clock: forget the offset
        self._clock_offset_ns = 0
        self._offset_rtt_ns = None
        self._conn.on_heartbeat = self._on_heartbeat

    def _spawn_tcp(self) -> socket.socket:
        """Mint a fresh epoch, (optionally) fork a local runner pointed
        at our listener, and block until one completes the authenticated
        handshake (DESIGN.md §25)."""
        link = self._link
        assert link is not None
        link.reopen()
        link.mint_epoch()
        if self._tcp_spawn_child:
            host, port = link.address
            env = dict(
                os.environ,
                GGRS_FLEET_LINK_AUTH_TOKEN=self.tuning.link_auth_token,
                GGRS_FLEET_LINK_SHARD=self.shard_id,
            )
            self._proc = subprocess.Popen(
                [sys.executable, str(_RUNNER_SCRIPT),
                 "--tcp", f"{host}:{port}"],
                env=env,
            )
            self._all_procs.append(self._proc)
        try:
            return link.wait_for_runner(self.tuning.spawn_timeout_s)
        except TimeoutError as e:
            self._teardown_proc(expect_exit=False)
            raise RpcTimeout(str(e)) from e

    def adopt_tcp(self, timeout: Optional[float] = None) -> None:
        """Adopt an external ``ShardRunner --tcp`` that dials in over
        the fleet link — the multi-host analogue of uds adoption.  Only
        valid for a tcp shard constructed with ``spawn=False``."""
        if self._link is None:
            raise InvalidRequest(
                f"shard {self.shard_id} has no TCP link to adopt on")
        if self._status == PROC_RUNNING:
            raise InvalidRequest(
                f"shard {self.shard_id} already has a live runner")
        if timeout is not None:
            # one-shot override for the handshake wait only
            saved = self.tuning.spawn_timeout_s
            self.tuning.spawn_timeout_s = timeout
            try:
                self._spawn()
            finally:
                self.tuning.spawn_timeout_s = saved
        else:
            self._spawn()

    def _teardown_proc(self, expect_exit: bool,
                       kill_process: bool = True) -> None:
        """Close the conn and reap the child (SIGKILL if still alive) —
        the no-leak contract: no zombie, no parent-held fd survives.
        Adopted runners (no Popen handle) are signalled by pid and left
        to their own parent/init to reap.  ``kill_process=False`` is the
        fencing path (§25): a TCP runner whose reconnect window expired
        is declared dead *for this epoch* without being signalled —
        a remote host's process is not ours to kill, the stale epoch
        refuses it at re-handshake instead."""
        if self._link is not None:
            self._link.down("teardown")
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        if not kill_process:
            self.last_exit = "fenced: reconnect window expired"
        elif self._proc is not None:
            if self._proc.poll() is None:
                if expect_exit:
                    try:
                        self._proc.wait(timeout=self.tuning.drain_deadline_s)
                    except subprocess.TimeoutExpired:
                        pass
                if self._proc.poll() is None:
                    self._proc.kill()
                try:
                    self._proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    pass  # unreapable child: counted as an orphan below
            else:
                self._proc.wait()
            self.last_exit = f"exit code {self._proc.returncode}"
        elif self.pid is not None:
            if self._child_alive() and not expect_exit:
                self._send_signal(signal.SIGKILL)
            self.last_exit = "adopted runner gone"
        # ggrs-model: transitions(running->exited, terminating->exited)
        self._status = PROC_EXITED
        self._update_orphan_gauge()

    def _child_alive(self) -> Optional[bool]:
        """Whether the runner process is alive: by waitpid for spawned
        children, by signal-0 probe for adopted (uds) runners.  None
        when unknowable (no pid yet)."""
        if self._proc is not None:
            return self._proc.poll() is None
        if self.pid is None:
            return None
        try:
            os.kill(self.pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True  # exists, just not ours to signal

    def _send_signal(self, sig: int) -> None:
        try:
            if self._proc is not None:
                self._proc.send_signal(sig)
            elif self.pid is not None:
                os.kill(self.pid, sig)
        except (OSError, ProcessLookupError):
            pass

    def orphan_count(self) -> int:
        """Spawned runners still alive past their shard lifetime — the
        leak-check observable (must be 0 after close/failover)."""
        return sum(
            1 for p in self._all_procs
            if p.poll() is None and (
                p is not self._proc or self._status == PROC_EXITED
            )
        )

    def _update_orphan_gauge(self) -> None:
        self._g_orphans.set(self.orphan_count())

    # ------------------------------------------------------------------
    # rpc plumbing
    # ------------------------------------------------------------------

    def _alive(self) -> bool:
        return (
            self._status == PROC_RUNNING
            and self._conn is not None and not self._conn.closed
            and (self._proc is None or self._proc.poll() is None)
        )

    def _mark_hung(self, reason: str) -> None:
        if self._hung_reason is None:
            self._hung_reason = reason
            _logger.error("proc shard %s hang-suspect: %s",
                          self.shard_id, reason)

    def _call(self, op: str, timeout: Optional[float] = None,
              **kw: Any) -> Any:
        if self._conn is None or self._conn.closed:
            raise RpcClosed(f"shard {self.shard_id}: no runner connection")
        t0 = time.perf_counter()
        try:
            return self._conn.call(
                op,
                timeout=(timeout if timeout is not None
                         else self.tuning.rpc_timeout_s),
                **kw,
            )
        except RpcTimeout:
            self._m_rpc_errors.labels(
                shard=self.shard_id, kind="timeout").inc()
            self._mark_hung(f"{op} rpc exceeded "
                            f"{self.tuning.rpc_timeout_s}s")
            raise
        except FrameError as e:
            self._m_rpc_errors.labels(
                shard=self.shard_id, kind="poisoned").inc()
            self._mark_hung(f"{op}: stream poisoned: {e}")
            raise
        except RpcClosed:
            self._m_rpc_errors.labels(
                shard=self.shard_id, kind="closed").inc()
            raise
        except RpcRemoteError as e:
            cls = _REMOTE_TYPES.get(e.type_name)
            if cls is not None:
                raise cls(e.msg) from e
            raise
        finally:
            self._h_rpc.labels(op=op).observe(time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # the PoolShard surface (serving)
    # ------------------------------------------------------------------

    def live_matches(self) -> int:
        return len(self._matches)

    def match_ids(self) -> List[str]:
        return list(self._matches)

    def has_match(self, match_id: str) -> bool:
        return match_id in self._matches

    def is_bank_match(self, match_id: str) -> bool:
        return self._matches.get(match_id) == "bank"

    def journal_failed_matches(self) -> List[str]:
        return list(self._journal_failed)

    def match_port(self, match_id: str) -> Optional[int]:
        return self._ports.get(match_id)

    def admission_refusal(self) -> Optional[str]:
        """Local-first: everything answerable without touching the child
        (a wedged runner must not wedge admission), then the runner's
        own last-reported verdict (p99 budget / staleness)."""
        if self.killed or self.state == SHARD_DEAD:
            return "dead"
        if self.state == SHARD_DRAINING:
            return "draining"
        if self.state == SHARD_RETIRED:
            return "retired"
        if self._hung_reason is not None:
            return "suspect"
        if not self._alive():
            return "down"
        if len(self._matches) >= self.capacity:
            return "full"
        return self._refusal_inner

    def add_local_input(self, match_id: str, handle: int, value) -> None:
        if match_id not in self._matches or not self._alive():
            return  # dead/unknown matches swallow inputs, like dead slots
        self._inputs.append((match_id, handle, value))

    def set_fleet_tick(self, tick: Optional[int]) -> None:
        """The supervisor's tick id, threaded through the next tick RPC
        so one Perfetto export correlates both processes (§18)."""
        self._fleet_tick = tick

    def _on_heartbeat(self, obj: Any) -> None:
        """Heartbeat payloads carry the idle-path harvest (no RTT pair
        here, so the last tick RPC's offset estimate stands)."""
        if isinstance(obj, dict):
            self._ingest_obs(obj.get("obs"))

    def _ingest_obs(self, payload: Optional[Dict[str, Any]],
                    t0_ns: Optional[int] = None,
                    t1_ns: Optional[int] = None) -> None:
        if not payload:
            return
        now_ns = payload.get("now_ns")
        req_ns = payload.get("req_ns", now_ns)
        if (t0_ns is not None and t1_ns is not None
                and isinstance(now_ns, int) and isinstance(req_ns, int)):
            # the NTP 4-timestamp offset: T1=t0 (call sent), T2=req_ns
            # (runner received), T3=now_ns (reply built), T4=t1 (reply
            # received) — offset = ((T2-T1)+(T3-T4))/2.  The runner's
            # processing time cancels out, so the error bound is the
            # NETWORK asymmetry (sub-µs on a socketpair), not RTT/2.
            # Kept only when this sample's network delay beats the best
            # so far; reset on respawn (a new process, a new clock).
            net_ns = (t1_ns - t0_ns) - (now_ns - req_ns)
            if self._offset_rtt_ns is None or net_ns <= self._offset_rtt_ns:
                self._offset_rtt_ns = net_ns
                self._clock_offset_ns = (
                    (req_ns - t0_ns) + (now_ns - t1_ns)
                ) // 2
        self.obs.ingest(self.shard_id, payload, backend="proc",
                        offset_ns=self._clock_offset_ns)

    def advance_all(self) -> Dict[str, List[Any]]:
        """One shard tick over RPC: ships the clock + staged inputs,
        returns ``{match_id: []}`` (requests are fulfilled in-runner —
        they cannot cross the process boundary).  A hung/dead runner
        returns {} immediately; the control plane escalates.  The reply
        piggybacks the runner's obs payload — metric deltas, span ring,
        ferried forensics — at zero extra round trips (§18)."""
        if (self.killed or self.state in (SHARD_RETIRED, SHARD_DEAD)
                or self._hung_reason is not None or not self._alive()):
            self._inputs = []
            return {}
        t0_ns = time.perf_counter_ns()
        try:
            r = self._call(
                "tick",
                clock=None if self._clock is None else self._clock(),
                inputs=self._inputs,
                state=self.state,
                fleet_tick=self._fleet_tick,
            )
        except RpcError:
            self._inputs = []
            return {}  # poll_lifecycle owns the consequence
        self._inputs = []
        self.ticks += 1
        self._ingest_obs(r.get("obs"), t0_ns, time.perf_counter_ns())
        self._healthz_inner = r.get("healthz") or self._healthz_inner
        self._refusal_inner = r.get("refusal")
        self._journal_failed = list(r.get("journal_failed", ()))
        self._frames.update(r.get("frames", {}))
        for mid, evs in r.get("events", {}).items():
            if evs:
                self._events.setdefault(mid, []).extend(evs)
        self._identities.update(r.get("identities", {}))
        return {mid: [] for mid in self._matches}

    def events(self, match_id: str) -> List[Any]:
        return self._events.pop(match_id, [])

    def current_frame(self, match_id: str) -> int:
        if match_id not in self._matches:
            raise InvalidRequest(f"no match {match_id!r} on this shard")
        return self._frames.get(match_id, -1)

    def wire_identity(self, match_id: str) -> Dict[str, Any]:
        ident = self._identities.get(match_id)
        if ident is not None:
            return ident
        return self._call("identity", match_id=match_id)

    def inject_match_error(self, match_id: str,
                          code: Optional[int] = None) -> None:
        """Chaos/test seam mirroring ``PoolShard.inject_match_error`` —
        the fault lands in the RUNNER's native bank; the resulting
        quarantine forensics ferry back on the next tick reply."""
        self._call("inject", match_id=match_id, code=code)

    # ------------------------------------------------------------------
    # the PoolShard surface (admission + migration)
    # ------------------------------------------------------------------

    def admit_spec(self, match_id: str, builder_factory, socket_factory,
                   game_factory, journal_spec=None) -> str:
        """Ship one match description to the runner (the factories must
        be picklable — the transport enforces the contract the
        bundle tests pinned).  Returns the tier like ``PoolShard.admit``;
        the bound UDP port (if any) lands in :meth:`match_port`."""
        r = self._call(
            "admit", match_id=match_id,
            builder_factory=builder_factory,
            socket_factory=socket_factory,
            game_factory=game_factory,
            journal=journal_spec,
        )
        self._matches[match_id] = r["tier"]
        self._ports[match_id] = r.get("port")
        return r["tier"]

    def adopt_spec(self, match_id: str, builder_factory, socket_factory,
                   game_factory, bundle, *, saved_states=None,
                   prelude=None, journal_spec=None,
                   replay_local=None) -> None:
        r = self._call(
            "adopt", match_id=match_id,
            builder_factory=builder_factory,
            socket_factory=socket_factory,
            game_factory=game_factory,
            bundle=bundle, saved_states=saved_states, prelude=prelude,
            journal=journal_spec, replay_local=replay_local,
        )
        self._matches[match_id] = "adopted"
        self._ports[match_id] = r.get("port")

    def evict_match(self, match_id: str) -> Dict[str, Any]:
        bundle = self._call("evict", match_id=match_id)
        self._forget(match_id)
        return bundle

    def drop_match(self, match_id: str, reason: str) -> None:
        if self._alive() and self._hung_reason is None:
            try:
                self._call("drop", match_id=match_id, reason=reason)
            except RpcError:
                pass
        self._forget(match_id)

    def _forget(self, match_id: str) -> None:
        self._matches.pop(match_id, None)
        self._ports.pop(match_id, None)
        self._frames.pop(match_id, None)
        self._events.pop(match_id, None)
        self._identities.pop(match_id, None)

    # ------------------------------------------------------------------
    # liveness: crash detection + hang watchdog + restarts
    # ------------------------------------------------------------------

    def heartbeat_age_s(self) -> Optional[float]:
        if self._conn is None:
            return None
        return max(0.0, time.monotonic() - self._conn.last_frame_at)

    def _drive_link(self, now: float) -> None:
        """One control-plane step of the TCP link machine (§25):
        UP + conn EOF → sever (open the reconnect window); while UP or
        RECONNECTING, pump the listener (refuse garbage, judge resume
        handshakes — a half-open peer's epoch-current resume severs
        implicitly); past the window deadline → expire (→ DOWN, which
        :meth:`poll_lifecycle` turns into confirmed-dead + fencing)."""
        link = self._link
        assert link is not None
        if (link.link_state == LINK_UP
                and self._conn is not None and self._conn.closed):
            link.sever(now)
        if link.link_state in (LINK_UP, LINK_RECONNECTING):
            link.pump(now)
        if (link.link_state == LINK_RECONNECTING
                and link.window_deadline is not None
                and now >= link.window_deadline):
            link.expire(now)

    def poll_lifecycle(self) -> Optional[str]:
        """One control-plane step of the liveness state machine.  Returns
        ``"died"`` exactly once — on the step where the child is
        CONFIRMED dead and reaped (only then may the supervisor fail its
        matches over: a merely-wedged process can still be sending).

        Crash detection (waitpid / EOF) and the hang watchdog are
        distinct paths: a crash is final immediately; a hang (rpc
        timeout, stale heartbeats, poisoned stream) escalates
        SIGTERM → drain deadline → SIGKILL first."""
        if self._status == PROC_EXITED:
            return None
        conn = self._conn
        if conn is not None:
            try:
                conn.poll_frames()  # heartbeats / goodbye between rpcs
            except FrameError as e:
                self._mark_hung(f"stream poisoned: {e}")
        now = time.monotonic()
        hb_age = self.heartbeat_age_s()
        if hb_age is not None:
            self._g_hb_age.labels(shard=self.shard_id).set(hb_age)
        if self._child_alive() is False:
            # crash (or the tail of an escalation/goodbye): reap + close
            self._teardown_proc(expect_exit=True)
            if self._expected_exit:
                return None
            return "died"
        if self._status == PROC_RUNNING and self._link is not None:
            self._drive_link(now)
            if self._link.link_state == LINK_DOWN:
                # reconnect window expired (or resume was impossible):
                # confirmed dead for this epoch.  The process — possibly
                # on another host — is fenced, not signalled: its stale
                # epoch is refused at any future handshake (§25).
                self._teardown_proc(expect_exit=True, kill_process=False)
                return None if self._expected_exit else "died"
            if self._link.link_state == LINK_RECONNECTING:
                # link down ≠ shard dead: failover is FORBIDDEN while
                # the reconnect window is open, and the EOF/heartbeat
                # wedge escalations below would be exactly that
                return None
        if self._status == PROC_RUNNING:
            wedged = self._hung_reason
            if wedged is None and conn is not None and conn.closed:
                # EOF usually beats waitpid noticing the exit by a beat:
                # give the kernel a breath before calling it a wedge
                if self._proc is not None:
                    try:
                        self._proc.wait(timeout=0.05)
                    except subprocess.TimeoutExpired:
                        pass
                if self._child_alive() is False:
                    self._teardown_proc(expect_exit=True)
                    return None if self._expected_exit else "died"
                wedged = "connection EOF while process alive"
            if wedged is None and conn is not None and conn.goodbye:
                # drained itself (SIGTERM from outside us): exit imminent
                return None
            if (wedged is None and hb_age is not None
                    and hb_age > self.tuning.heartbeat_deadline_s):
                wedged = (f"no heartbeat for {hb_age:.2f}s "
                          f"(> {self.tuning.heartbeat_deadline_s}s)")
                self._mark_hung(wedged)
            if wedged is not None and self.pid is not None:
                _logger.error(
                    "proc shard %s wedged (%s): SIGTERM, drain deadline "
                    "%.2fs", self.shard_id, wedged,
                    self.tuning.drain_deadline_s,
                )
                self._m_watchdog.labels(
                    shard=self.shard_id, stage="sigterm").inc()
                self._send_signal(signal.SIGTERM)
                self._status = PROC_TERMINATING
                self._term_deadline = now + self.tuning.drain_deadline_s
        elif self._status == PROC_TERMINATING:
            if self._term_deadline is not None and now >= self._term_deadline:
                # wedged ≠ dead, but past the drain deadline it must BE
                # dead before failover: SIGKILL works on stopped procs
                _logger.error(
                    "proc shard %s ignored SIGTERM past the drain "
                    "deadline: SIGKILL", self.shard_id,
                )
                self._m_watchdog.labels(
                    shard=self.shard_id, stage="sigkill").inc()
                self._send_signal(signal.SIGKILL)
                self._teardown_proc(expect_exit=True)
                return "died"
        return None

    def kill(self) -> None:
        """The chaos verb: for a process-backed shard this is a REAL
        SIGKILL — no flush, no goodbye; recovery must come from the
        durable journals alone."""
        self.killed = True
        if self._child_alive():
            self._send_signal(signal.SIGKILL)

    # --- restart policy (jittered backoff + storm budget) ---

    def schedule_respawn(self, now: Optional[float] = None) -> bool:
        """Arm a respawn after a death.  Returns False when the
        restart-storm budget (``restart_max`` within
        ``restart_window_s``) is exhausted — the shard then stays dead,
        loudly, instead of crash-looping."""
        now = time.monotonic() if now is None else now
        if self.tuning.restart_max <= 0:
            return False
        self._restart_times = [
            t for t in self._restart_times
            if now - t <= self.tuning.restart_window_s
        ]
        if len(self._restart_times) >= self.tuning.restart_max:
            _logger.error(
                "proc shard %s: restart-storm budget exhausted "
                "(%d restarts in %.0fs); staying dead",
                self.shard_id, len(self._restart_times),
                self.tuning.restart_window_s,
            )
            return False
        attempt = len(self._restart_times)
        delay = (self.tuning.restart_backoff_s * (2 ** attempt)
                 * (1.0 + 0.5 * self._rng.random()))
        self._respawn_at = now + delay
        _logger.info("proc shard %s: respawn scheduled in %.2fs "
                     "(attempt %d)", self.shard_id, delay, attempt + 1)
        return True

    def respawn_due(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return self._respawn_at is not None and now >= self._respawn_at

    def try_respawn(self) -> bool:
        """Spawn a fresh runner for this shard id.  The old incarnation's
        matches were already failed over; the new one starts empty and
        re-enters admission."""
        self._respawn_at = None
        self._restart_times.append(time.monotonic())
        try:
            self._spawn()
        except Exception as e:
            _logger.error("proc shard %s respawn failed: %s",
                          self.shard_id, e)
            self.last_exit = f"respawn failed: {e}"
            return False
        self.restarts += 1
        self._m_restarts.labels(shard=self.shard_id).inc()
        self.killed = False
        # ggrs-model: transitions(dead->active)
        self.state = SHARD_ACTIVE
        self._matches.clear()
        self._ports.clear()
        self._events.clear()
        self._frames.clear()
        self._identities.clear()
        self._healthz_inner = {}
        self._refusal_inner = None
        self._journal_failed = []
        self._inputs = []
        _logger.info("proc shard %s respawned (pid %s, restart %d)",
                     self.shard_id, self.pid, self.restarts)
        return True

    # ------------------------------------------------------------------
    # lifecycle verbs + health
    # ------------------------------------------------------------------

    def retire(self) -> None:
        # ggrs-model: transitions(active->retired, draining->retired)
        self.state = SHARD_RETIRED
        self._expected_exit = True
        self._shutdown_runner()

    def close(self) -> None:
        """Graceful teardown: drain RPC → SIGTERM → SIGKILL ladder, then
        reap and close — after this no child survives and no fd leaks
        (the SIGKILL-only leak-check test pins it)."""
        self._expected_exit = True
        self._shutdown_runner()
        if self._link is not None:
            self._link.close()  # the listener fd
        self._update_orphan_gauge()

    def _shutdown_runner(self) -> None:
        if self._alive():
            try:
                self._call("shutdown",
                           timeout=self.tuning.drain_deadline_s)
            except RpcError:
                if self._child_alive():
                    self._send_signal(signal.SIGTERM)
        self._teardown_proc(expect_exit=True)

    def watchdog_stage(self) -> str:
        """Where the liveness state machine stands: ``ok`` (running,
        no suspicion), ``reconnecting`` (TCP link severed, resume window
        open — failover forbidden, §25), ``suspect`` (hang-marked,
        SIGTERM not yet sent), ``terminating`` (SIGTERM sent, drain
        deadline armed), or ``exited`` — surfaced into ``healthz``
        aggregates so a stale runner pages BEFORE it is confirmed dead
        (§18)."""
        if self._status == PROC_EXITED:
            return "exited"
        if self._status == PROC_TERMINATING:
            return "terminating"
        if (self._link is not None
                and self._link.link_state == LINK_RECONNECTING):
            return "reconnecting"
        if self._hung_reason is not None:
            return "suspect"
        return "ok"

    def link_info(self) -> Optional[Dict[str, Any]]:
        """The TCP link's state/epoch/counters dict, or None for
        socketpair/uds shards (§25)."""
        return None if self._link is None else self._link.info()

    def chaos_sever_link(self, how: str = "rdwr") -> None:
        """Chaos verb: sever the supervisor→runner TCP stream at the
        socket layer without telling either endpoint (``how`` as in
        ``RpcConn.chaos_sever``: ``rdwr`` full sever, ``wr``/``rd``
        half-open)."""
        if self._link is None:
            raise InvalidRequest(
                f"shard {self.shard_id} has no TCP link to sever")
        if self._conn is not None:
            self._conn.chaos_sever(how)

    def healthz(self) -> Dict[str, Any]:
        alive = self._alive()
        hb_age = self.heartbeat_age_s()
        state = SHARD_DEAD if self.killed else self.state
        ok = (
            alive
            and not self.killed
            and self._hung_reason is None
            and self.state in (SHARD_ACTIVE, SHARD_DRAINING)
            and (hb_age is None
                 or hb_age <= self.tuning.heartbeat_deadline_s)
        )
        inner = self._healthz_inner
        return dict(
            shard=self.shard_id,
            state=state,
            ok=ok,
            backend="proc",
            pid=self.pid,
            alive=alive,
            hung=self._hung_reason,
            watchdog=self.watchdog_stage(),
            heartbeat_age_s=hb_age,
            restarts=self.restarts,
            exit=self.last_exit,
            matches=len(self._matches),
            bank_matches=sum(
                1 for t in self._matches.values() if t == "bank"
            ),
            adopted_matches=sum(
                1 for t in self._matches.values() if t != "bank"
            ),
            journal_failed=len(self._journal_failed),
            capacity=self.capacity,
            ticks=self.ticks,
            last_tick_age_s=inner.get("last_tick_age_s"),
            tick_p99_ms=inner.get("tick_p99_ms", 0.0),
            link=self.link_info(),
        )
