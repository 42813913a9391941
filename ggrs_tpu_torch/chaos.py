"""Pool-scale chaos harness for the supervised session bank: the SHARED
driver behind ``scripts/chaos.py`` and ``tests/test_bank_faults.py``
(DESIGN.md §9).

The port's copy of ``ggrs_tpu/chaos.py``.  Its fleet drivers also take
game factories, so the port's executors can fulfil the matches on the card:
:class:`ExecutorGame` is the picklable one a process-fleet runner builds.

The topology under test: ``2 * n_matches`` in-bank slots — each 2-peer
match on its OWN fault-isolated ``InMemoryNetwork``, so no fault-rng stream
couples matches — plus one targeted slot whose peer is an EXTERNAL
``P2PSession``.  Faults are driven through the pool's REAL tick path
(``inject_datagram`` splices raw bytes into the slot's inbound routing,
``inject_slot_error`` rides the ctrl-op channel, blackouts silence the
external peer), and every observable needed for a bit-exact comparison
against a fault-free control leg is recorded: per-slot wire bytes, request
lists, and events.
"""

from __future__ import annotations

import atexit
import json
import os
import random
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .core import Local, Remote
from .core.config import Config
from .core.types import DesyncDetected, DesyncDetection
from .net import InMemoryNetwork
from .obs.recorder import FlightRecorder
from .obs.registry import Registry
from .obs.trace import Tracer
from .parallel.host_bank import HostSessionPool, SLOT_NATIVE
from .sessions import SessionBuilder
from .utils.tree import tree_leaves


class RecordingSocket:
    """Wraps a socket, recording every (addr, wire bytes) sent."""

    def __init__(self, inner):
        self.inner = inner
        self.sent = []

    def send_to(self, msg, addr):
        self.sent.append((addr, msg.encode()))
        self.inner.send_to(msg, addr)

    def receive_all_datagrams(self):
        return self.inner.receive_all_datagrams()

    def receive_all_messages(self):
        return self.inner.receive_all_messages()


class RecvRecordingSocket:
    """Wraps a socket, recording every datagram's BYTES as received —
    the observer for hosts whose sends happen in another process (the
    proc-fleet legs compare what the peer actually decoded, port-free so
    two legs with different ephemeral ports still compare equal)."""

    def __init__(self, inner):
        self.inner = inner
        self.received = []

    def receive_all_datagrams(self):
        out = self.inner.receive_all_datagrams()
        self.received.extend(data for _, data in out)
        return out

    def receive_all_messages(self):
        out = self.inner.receive_all_messages()
        self.received.extend(msg.encode() for _, msg in out)
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def two_peer_builder(clock, rng_seed, me, other_name, other_handle=None):
    """One side of a 2-peer uint16 match on a frozen list-clock."""
    return (
        SessionBuilder(Config.for_uint(16))
        .with_clock(lambda: clock[0])
        .with_rng(random.Random(rng_seed))
        .add_player(Local(), me)
        .add_player(
            Remote(other_name),
            other_handle if other_handle is not None else 1 - me,
        )
    )


def fulfill(requests) -> None:
    """Fulfill saves with the frame itself as state; validate loads."""
    for r in requests:
        k = type(r).__name__
        if k == "SaveGameState":
            r.cell.save(r.frame, r.frame, None)
        elif k == "LoadGameState":
            assert r.cell.data() is not None, (
                f"load of unfulfilled cell at frame {r.frame}"
            )


def req_summary(requests) -> List:
    """Comparable summary of a request list (kind + frame / inputs)."""
    out = []
    for r in requests:
        k = type(r).__name__
        if k == "AdvanceFrame":
            out.append(("adv", tuple(r.inputs)))
        else:
            out.append((k, r.frame))
    return out


# Datagrams every path must drop at parse, before any state advance
MALFORMED_BURST = [
    b"",                          # empty
    b"\x01",                      # shorter than a header
    b"\xaa\xbb\xff",              # unknown tag 0xff
    b"\xaa\xbb\x00\x01",          # input tag, truncated body
    b"\xaa\xbb\x01\x02\x03\x04",  # input-ack with trailing garbage
    b"\xaa\xbb\x02\x00",          # quality report, truncated
    b"\xaa\xbb\x05\x00",          # keep-alive with trailing garbage
    bytes(64),                    # zeros (input tag, malformed statuses)
]


def drive_chaos(
    ticks: int,
    n_matches: int = 4,
    seed: int = 0,
    inject: Optional[Callable[[int, Dict[str, Any]], Any]] = None,
    ext_alive: Optional[Callable[[int], bool]] = None,
    retire: bool = False,
    fault_cfg: Optional[Dict[str, Any]] = None,
    metrics: Optional[Registry] = None,
    tracer: Optional[Tracer] = None,
) -> Dict[str, Any]:
    """Build the chaos topology and drive ``ticks`` pool ticks.

    ``inject(i, ctx)`` runs at the top of tick ``i`` (``ctx`` carries
    ``pool``, ``ext``, ``target``, ``seed``); ``ext_alive(i)`` gates driving
    the external peer (its blackout switch).  Identical arguments produce a
    bit-identical run — the control/chaos comparison contract; metrics
    must never perturb it (``metrics=Registry(enabled=False)`` runs the
    same pool with the obs layer compiled out, and tests pin the wire
    bytes identical either way).  ``tracer`` rides the same contract: a
    live ``Tracer`` arms the native in-crossing phase timers, and the
    trace suite pins wire bytes bit-identical tracer on vs off with zero
    extra tick crossings.  The run's registry and a final
    ``pool.scrape()`` snapshot land in the returned ctx (``registry``,
    ``scrape``).
    """
    base = seed * 1000
    clock = [0]
    nets = []
    registry = metrics if metrics is not None else Registry()
    pool = HostSessionPool(retire_dead_matches=retire, metrics=registry,
                           tracer=tracer)
    socks = []
    for m in range(n_matches):
        cfg = dict(fault_cfg or {"latency_ticks": 1})
        cfg.setdefault("seed", base + 100 + m)
        net = InMemoryNetwork(**cfg)
        nets.append(net)
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            s = RecordingSocket(net.socket(names[me]))
            socks.append(s)
            pool.add_session(
                two_peer_builder(clock, base + 3 + 5 * m + me, me,
                                 names[1 - me]),
                s,
            )
    cfg = dict(fault_cfg or {"latency_ticks": 1})
    cfg.setdefault("seed", base + 99)
    net_t = InMemoryNetwork(**cfg)
    nets.append(net_t)
    target = len(socks)
    ts = RecordingSocket(net_t.socket("T"))
    socks.append(ts)
    pool.add_session(two_peer_builder(clock, base + 71, 0, "X"), ts)
    ext = two_peer_builder(clock, base + 72, 1, "T",
                           other_handle=0).start_p2p_session(
        net_t.socket("X")
    )
    if not pool.native_active:
        raise RuntimeError("native session bank unavailable")

    n = len(pool)
    reqs_log: List[List] = [[] for _ in range(n)]
    events_log: List[List] = [[] for _ in range(n)]

    def sched(i, idx):
        return ((i + 2 * idx) // (2 + idx % 3)) % 16

    ctx: Dict[str, Any] = dict(
        pool=pool, ext=ext, target=target, nets=nets, clock=clock, seed=seed,
    )
    for i in range(ticks):
        clock[0] += 16
        if inject is not None:
            inject(i, ctx)
        if ext_alive is None or ext_alive(i):
            ext.add_local_input(1, (i * 5) % 16)
            fulfill(ext.advance_frame())
        for idx in range(n):
            pool.add_local_input(idx, idx % 2, sched(i, idx))
        for idx, reqs in enumerate(pool.advance_all()):
            fulfill(reqs)
            reqs_log[idx].append(req_summary(reqs))
        for idx in range(n):
            events_log[idx].extend(pool.events(idx))
        for net in nets:
            net.tick()
    ctx.update(
        wire=[s.sent for s in socks],
        reqs=reqs_log,
        events=events_log,
        states=[pool.slot_state(i) for i in range(n)],
        frames=[pool.current_frame(i) for i in range(n)],
        registry=registry,
        scrape=pool.scrape(),
        tracer=tracer,
    )
    return ctx


def drive_socket_chaos(
    ticks: int,
    n_matches: int = 3,
    seed: int = 0,
    inject: Optional[Callable[[int, Dict[str, Any]], Any]] = None,
    metrics: Optional[Registry] = None,
) -> Dict[str, Any]:
    """The batched-datapath sibling of :func:`drive_chaos` (DESIGN.md
    §15): ``n_matches + 1`` host slots over REAL loopback UDP with
    ``native_io=True``, each matched against an external Python
    ``P2PSession`` on a frozen list-clock (loopback UDP is reliable and
    ordered at this volume, so identical arguments produce a bit-identical
    run — the control/chaos comparison contract).  The last slot is the
    target; ``inject(i, ctx)`` typically fires
    ``pool.inject_socket_errno`` storms at it.  Every slot's outbound
    wire bytes are recorded through the NetBatch capture tee (exact
    sendmmsg order), so survivors can be pinned bit-identical to a
    fault-free control leg.

    Raises ``RuntimeError`` when the kernel-batched datapath is
    unavailable on this platform — callers skip the scenario.
    """
    from .net import _native
    from .net.sockets import UdpNonBlockingSocket

    if _native.net_lib() is None:
        raise RuntimeError("kernel-batched socket datapath unavailable")
    base = seed * 1000
    clock = [0]
    registry = metrics if metrics is not None else Registry()
    pool = HostSessionPool(metrics=registry, native_io=True)
    peers = []
    n = n_matches + 1
    for m in range(n):
        host_sock = UdpNonBlockingSocket(0)
        peer_sock = UdpNonBlockingSocket(0)
        pool.add_session(
            two_peer_builder(
                clock, base + 3 + 5 * m, 0,
                ("127.0.0.1", peer_sock.local_port()),
            ),
            host_sock,
        )
        peers.append(two_peer_builder(
            clock, base + 4 + 5 * m, 1,
            ("127.0.0.1", host_sock.local_port()),
        ).start_p2p_session(peer_sock))
    if not pool.native_active:
        raise RuntimeError("native session bank unavailable")
    if not pool.native_io_active:
        raise RuntimeError("batched datapath did not attach")
    target = n - 1
    for m in range(n):
        pool._io_set_capture(m)

    wire: List[List[bytes]] = [[] for _ in range(n)]
    reqs_log: List[List] = [[] for _ in range(n)]
    events_log: List[List] = [[] for _ in range(n)]

    def sched(i, idx):
        return ((i + 2 * idx) // (2 + idx % 3)) % 16

    ctx: Dict[str, Any] = dict(
        pool=pool, peers=peers, target=target, clock=clock, seed=seed,
    )
    for i in range(ticks):
        clock[0] += 16
        if inject is not None:
            inject(i, ctx)
        for m, peer in enumerate(peers):
            peer.add_local_input(1, sched(i, m))
            fulfill(peer.advance_frame())
        for idx in range(n):
            pool.add_local_input(idx, 0, sched(i, idx))
        for idx, reqs in enumerate(pool.advance_all()):
            fulfill(reqs)
            reqs_log[idx].append(req_summary(reqs))
        for idx in range(n):
            events_log[idx].extend(pool.events(idx))
            # evicted slots leave the capture tee (their sends ride the
            # Python socket again); drain what the tee still holds
            if pool.io_state(idx) == "native":
                wire[idx].extend(
                    data for _, data in pool._io_drain_capture(idx)
                )
    ctx.update(
        wire=wire,
        reqs=reqs_log,
        events=events_log,
        states=[pool.slot_state(i) for i in range(n)],
        io_states=[pool.io_state(i) for i in range(n)],
        frames=[pool.current_frame(i) for i in range(n)],
        peer_frames=[p.current_frame for p in peers],
        io=pool.io_stats(),
        registry=registry,
        scrape=pool.scrape(),
    )
    return ctx


def drive_dispatch_chaos(
    ticks: int,
    n_matches: int = 3,
    seed: int = 0,
    inject: Optional[Callable[[int, Dict[str, Any]], Any]] = None,
    siblings: int = 1,
    metrics: Optional[Registry] = None,
) -> Dict[str, Any]:
    """The shared-dispatch-socket sibling of :func:`drive_socket_chaos`
    (DESIGN.md §23): ``n_matches + 1`` host slots all served by ONE
    ``DispatchHub`` port (plus SO_REUSEPORT siblings), inbound drained by
    the one-crossing ``ggrs_net_recv_table`` with native (ip,port)->slot
    demux, outbound on the shared fd through ``ggrs_net_send_table``
    dispatch-flagged records.  Each slot is matched against an external
    Python ``P2PSession`` on a frozen list-clock.

    The TARGET is slot 0: ``inject(i, ctx)`` typically arms
    ``ggrs_net_inject_table_errno(err, 0, 1)``, which fails the FIRST
    record of the next tick's send table — slot 0's, since the table is
    packed in slot order — exercising the §9 contract that a fatal errno
    on the shared fd faults exactly the owning slot, never the co-tenant
    pool.  The wire observable is each PEER's received datagram bytes
    (:class:`RecvRecordingSocket`) — the dispatch slots are not
    NetBatch-attached, so there is no capture tee; peer-observed bytes
    are the port-free comparison the proc-fleet legs already use.

    Raises ``RuntimeError`` when the gen-2 datapath is unavailable on
    this platform — callers skip the scenario.
    """
    from .net import _native
    from .net.sockets import DispatchHub, UdpNonBlockingSocket

    lib = _native.net_lib()
    if lib is None or not hasattr(lib, "ggrs_net_recv_table"):
        raise RuntimeError("gen-2 shared-dispatch datapath unavailable")
    base = seed * 1000
    clock = [0]
    registry = metrics if metrics is not None else Registry()
    pool = HostSessionPool(metrics=registry)
    hub = DispatchHub(siblings=siblings)
    peers = []
    peer_socks = []
    n = n_matches + 1
    for m in range(n):
        peer_sock = RecvRecordingSocket(UdpNonBlockingSocket(0))
        pool.add_session(
            two_peer_builder(
                clock, base + 3 + 5 * m, 0,
                ("127.0.0.1", peer_sock.local_port()),
            ),
            hub.view(),
        )
        peers.append(two_peer_builder(
            clock, base + 4 + 5 * m, 1,
            ("127.0.0.1", hub.local_port()),
        ).start_p2p_session(peer_sock))
        peer_socks.append(peer_sock)
    if not pool.native_active:
        raise RuntimeError("native session bank unavailable")
    target = 0

    reqs_log: List[List] = [[] for _ in range(n)]
    events_log: List[List] = [[] for _ in range(n)]

    def sched(i, idx):
        return ((i + 2 * idx) // (2 + idx % 3)) % 16

    ctx: Dict[str, Any] = dict(
        pool=pool, hub=hub, peers=peers, target=target, clock=clock,
        seed=seed, lib=lib,
    )
    for i in range(ticks):
        clock[0] += 16
        if inject is not None:
            inject(i, ctx)
        for m, peer in enumerate(peers):
            peer.add_local_input(1, sched(i, m))
            fulfill(peer.advance_frame())
        for idx in range(n):
            pool.add_local_input(idx, 0, sched(i, idx))
        for idx, reqs in enumerate(pool.advance_all()):
            fulfill(reqs)
            reqs_log[idx].append(req_summary(reqs))
        for idx in range(n):
            events_log[idx].extend(pool.events(idx))
    ctx.update(
        wire=[list(s.received) for s in peer_socks],
        reqs=reqs_log,
        events=events_log,
        states=[pool.slot_state(i) for i in range(n)],
        frames=[pool.current_frame(i) for i in range(n)],
        peer_frames=[p.current_frame for p in peers],
        io=pool.io_stats(),
        capabilities=pool.io_capabilities(),
        hub_fds=len(hub.filenos()),
        registry=registry,
        scrape=pool.scrape(),
    )
    hub.close()
    return ctx


def drive_desync_forensics(
    ticks: int,
    fault_frame: int,
    seed: int = 0,
    interval: int = 1,
    fault_cfg: Optional[Dict[str, Any]] = None,
    tracer: Optional[Tracer] = None,
) -> Dict[str, Any]:
    """The reference desync-detection path under a seeded state fault: two
    Python ``P2PSession`` peers with ``DesyncDetection.on(interval)``,
    where peer B's simulation silently diverges from frame ``fault_frame``
    on (its saves carry perturbed checksums from that frame forward — the
    classic nondeterminism bug).  The checksum interval traffic then turns
    the divergence into ``DesyncDetected`` events on both ends, and the
    forensics layer (DESIGN.md §14) synthesizes ``DesyncReport``s whose
    first-divergent-frame bisection should land exactly on ``fault_frame``
    when ``interval == 1``.

    Flight recorders and the optional ``tracer`` are attached to both
    sessions; the returned ctx carries both sessions (``a``, ``b``), their
    drained events, and both report lists (``reports_a``, ``reports_b``).
    """
    base = seed * 1000
    clock = [0]
    cfg = dict(fault_cfg or {"latency_ticks": 1})
    cfg.setdefault("seed", base + 1)
    net = InMemoryNetwork(**cfg)
    sessions = []
    recorders = []
    names = ("A", "B")
    for me in (0, 1):
        builder = two_peer_builder(
            clock, base + 7 + me, me, names[1 - me]
        ).with_desync_detection_mode(DesyncDetection.on(interval))
        s = builder.start_p2p_session(net.socket(names[me]))
        rec = FlightRecorder()
        s.attach_forensics(recorder=rec, tracer=tracer)
        sessions.append(s)
        recorders.append(rec)

    def checksum_for(me: int, frame: int) -> int:
        # deterministic "state digest": both peers agree until B's
        # simulation diverges at fault_frame
        if me == 1 and frame >= fault_frame:
            return (frame * 2654435761 + 1) & 0xFFFFFFFF
        return (frame * 2654435761) & 0xFFFFFFFF

    events: List[List[Any]] = [[], []]
    for i in range(ticks):
        clock[0] += 16
        for me, s in enumerate(sessions):
            s.add_local_input(me, (i * (me + 3)) % 16)
            for r in s.advance_frame():
                k = type(r).__name__
                if k == "SaveGameState":
                    r.cell.save(r.frame, r.frame,
                                checksum_for(me, r.frame))
                elif k == "LoadGameState":
                    assert r.cell.data() is not None
            events[me].extend(s.events())
        net.tick()
    desyncs = [
        [e for e in evs if isinstance(e, DesyncDetected)] for evs in events
    ]
    return dict(
        a=sessions[0], b=sessions[1],
        recorders=recorders,
        events=events, desyncs=desyncs,
        reports_a=sessions[0].desync_reports,
        reports_b=sessions[1].desync_reports,
        fault_frame=fault_frame,
        tracer=tracer,
    )


def drive_broadcast(
    ticks: int,
    use_hub: bool = True,
    seed: int = 0,
    n_spectators: int = 1,
    n_side_matches: int = 0,
    fault_cfg: Optional[Dict[str, Any]] = None,
    journal_path=None,
    journal_fsync: int = 0,
    inject: Optional[Callable[[int, Dict[str, Any]], Any]] = None,
    sabotage_harvest: bool = False,
    metrics: Optional[Registry] = None,
    scrape_every: int = 0,
) -> Dict[str, Any]:
    """Drive one broadcast world: a 2-peer match whose host declares
    ``n_spectators`` spectator players, followed by that many real Python
    ``SpectatorSession`` viewers, plus ``n_side_matches`` unrelated in-bank
    matches (the blast-radius survivors), all on seeded fault networks.

    ``use_hub=True`` hosts the match on a ``HostSessionPool`` +
    ``SpectatorHub`` (native fan-out); ``use_hub=False`` hosts it on a
    plain ``P2PSession`` — the per-session semantic reference the parity
    fuzz compares against.  Identical arguments produce a bit-identical
    run either way (that IS the fuzz contract).

    ``journal_path`` attaches a ``MatchJournal`` (hub mode);
    ``sabotage_harvest`` breaks the native harvest so an eviction must
    recover from the journal tail; ``inject(i, ctx)`` runs at the top of
    tick ``i`` (``ctx`` carries ``pool``/``hub``/``target``).  Returns the
    per-viewer observed streams, the host's wire bytes, and the side
    matches' observables for control/chaos comparison.
    """
    from .core.errors import (
        NotSynchronized,
        PredictionThreshold,
        SpectatorTooFarBehind,
    )
    from .core.types import Spectator

    base = seed * 1000
    clock = [0]
    cfg_kwargs = dict(fault_cfg or {"latency_ticks": 1})
    cfg_kwargs.setdefault("seed", base + 1)
    net = InMemoryNetwork(**cfg_kwargs)
    config = Config.for_uint(16)

    viewer_names = [f"V{k}" for k in range(n_spectators)]
    hb = two_peer_builder(clock, base + 10, 0, "P")
    for k, vname in enumerate(viewer_names):
        hb = hb.add_player(Spectator(vname), 2 + k)
    peer = two_peer_builder(clock, base + 20, 1, "H",
                            other_handle=0).start_p2p_session(
        net.socket("P")
    )
    viewers = []
    for k, vname in enumerate(viewer_names):
        vb = (
            SessionBuilder(config)
            .with_clock(lambda: clock[0])
            .with_rng(random.Random(base + 30 + k))
        )
        viewers.append(vb.start_spectator_session("H", net.socket(vname)))

    host_sock = RecordingSocket(net.socket("H"))
    registry = metrics if metrics is not None else Registry()
    pool = hub = journal = host = None
    side_socks: List[RecordingSocket] = []
    side_nets: List[InMemoryNetwork] = []
    if use_hub:
        from .broadcast import MatchJournal, SpectatorHub

        pool = HostSessionPool(metrics=registry)
        hub = SpectatorHub(pool, rng=random.Random(base + 40))
        pool.add_session(hb, host_sock)
        for m in range(n_side_matches):
            s_cfg = dict(fault_cfg or {"latency_ticks": 1})
            s_cfg.setdefault("seed", base + 100 + m)
            s_net = InMemoryNetwork(**s_cfg)
            side_nets.append(s_net)
            names = (f"A{m}", f"B{m}")
            for me in (0, 1):
                s = RecordingSocket(s_net.socket(names[me]))
                side_socks.append(s)
                pool.add_session(
                    two_peer_builder(clock, base + 50 + 5 * m + me, me,
                                     names[1 - me]),
                    s,
                )
        if not pool.native_active:
            raise RuntimeError("native broadcast bank unavailable")
        if journal_path is not None:
            journal = MatchJournal(
                journal_path, 2, config.native_input_size,
                fsync_every=journal_fsync, metrics=registry,
            )
            hub.attach_journal(0, journal)
        if sabotage_harvest:
            def broken(index):
                raise RuntimeError("simulated dead native state")

            pool._harvest = broken
    else:
        host = hb.start_p2p_session(host_sock)

    n_slots = 1 + 2 * n_side_matches
    reqs_log: List[List] = [[] for _ in range(n_slots)]
    events_log: List[List] = [[] for _ in range(n_slots)]
    viewer_streams: List[List] = [[] for _ in viewers]
    viewer_frames: List[List[int]] = [[] for _ in viewers]
    hub_events: List = []

    def sched(i, idx):
        return ((i + 2 * idx) // (2 + idx % 3)) % 16

    ctx: Dict[str, Any] = dict(
        pool=pool, hub=hub, host=host, peer=peer, viewers=viewers,
        target=0, clock=clock, seed=seed, journal=journal,
    )
    for i in range(ticks):
        clock[0] += 16
        if inject is not None:
            inject(i, ctx)
        peer.add_local_input(1, (i * 5) % 16)
        fulfill(peer.advance_frame())
        if use_hub:
            for idx in range(n_slots):
                pool.add_local_input(idx, (idx - 1) % 2 if idx else 0,
                                     sched(i, idx))
            for idx, reqs in enumerate(pool.advance_all()):
                fulfill(reqs)
                reqs_log[idx].append(req_summary(reqs))
            for idx in range(n_slots):
                events_log[idx].extend(pool.events(idx))
            hub_events.extend(hub.events(0))
            if scrape_every and i % scrape_every == 0:
                pool.scrape()
        else:
            host.add_local_input(0, sched(i, 0))
            reqs = host.advance_frame()
            fulfill(reqs)
            reqs_log[0].append(req_summary(reqs))
            events_log[0].extend(host.events())
        for k, viewer in enumerate(viewers):
            try:
                for r in viewer.advance_frame():
                    viewer_streams[k].append(
                        (viewer.current_frame, tuple(r.inputs))
                    )
            except (NotSynchronized, PredictionThreshold,
                    SpectatorTooFarBehind):
                pass
            viewer_frames[k].append(viewer.current_frame)
        net.tick()
        for s_net in side_nets:
            s_net.tick()
    ctx.update(
        host_wire=host_sock.sent,
        side_wire=[s.sent for s in side_socks],
        reqs=reqs_log,
        events=events_log,
        viewer_streams=viewer_streams,
        viewer_frames=viewer_frames,
        hub_events=hub_events,
        registry=registry,
        states=(
            [pool.slot_state(i) for i in range(n_slots)] if use_hub
            else ["native"] * n_slots
        ),
        frames=(
            [pool.current_frame(i) for i in range(n_slots)] if use_hub
            else [host.current_frame]
        ),
        peer_frame=peer.current_frame,
    )
    return ctx


class CrcGame:
    """A minimal deterministic 'simulation' whose state is a crc32 chain
    over every advanced frame's inputs — cheap, rollback-correct (save and
    load round-trip the int state), and divergence-sensitive: any two ends
    that ever advance a frame with different inputs disagree on every
    checksum afterwards, which ``DesyncDetection.on(1)`` turns into
    ``DesyncDetected`` events.  The fleet chaos legs use one per
    participant so a failover that re-sends different inputs cannot hide."""

    def __init__(self) -> None:
        import zlib

        self._crc32 = zlib.crc32
        self.state = 0

    def fulfill(self, requests) -> None:
        for r in requests:
            k = type(r).__name__
            if k == "AdvanceFrame":
                # hash the input VALUES only: a correctly-predicted frame
                # never rolls back, so its saved state keeps the PREDICTED
                # status the peer's CONFIRMED copy lacks — hashing statuses
                # would desync every match at frame 1
                values = tuple(v for v, _status in r.inputs)
                self.state = self._crc32(repr(values).encode(), self.state)
            elif k == "SaveGameState":
                r.cell.save(r.frame, self.state, self.state)
            elif k == "LoadGameState":
                data = r.cell.data()
                assert data is not None, (
                    f"load of unfulfilled cell at frame {r.frame}"
                )
                self.state = data


# per process: (game, players, device) -> (game object, shared ExecutorPrograms),
# warmed up by the first ExecutorGame built for that key
_EXECUTOR_PROGRAMS: Dict[Tuple[str, int, str], Tuple[Any, Any]] = {}
# per process: the card ExecutorGames' digest launches and their prediction,
# and every ExecutorGame's Loads of a host tree
EXECUTOR_COUNTS: Dict[str, int] = {"launches": 0, "predicted": 0, "host_loads": 0}
_COUNTS_DIRS: set = set()


def _u8_inputs(pairs) -> np.ndarray:
    """A request's ``[(input, status), ...]`` as the (P,) u8 buttons array."""
    return np.asarray([v for v, _status in pairs], np.uint8)


def predicted_digest_launches(requests) -> int:
    """Digest launches a request list makes on the card: one per burst (two
    or more Advances, each maybe followed by a Save) that saves, and one per
    Save outside a burst."""
    from .core.types import AdvanceFrame, SaveGameState

    launches, i, n = 0, 0, len(requests)
    while i < n:
        if not isinstance(requests[i], AdvanceFrame):
            launches += isinstance(requests[i], SaveGameState)
            i += 1
            continue
        advances = saves = 0
        while i < n and isinstance(requests[i], AdvanceFrame):
            advances, i = advances + 1, i + 1
            if i < n and isinstance(requests[i], SaveGameState):
                saves, i = saves + 1, i + 1
        launches += (1 if saves else 0) if advances >= 2 else saves
    return launches


def _write_counts(counts_dir: str) -> None:
    if os.path.isdir(counts_dir):
        path = os.path.join(counts_dir, f"executor_game-{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump(EXECUTOR_COUNTS, f)


class ExecutorGame:
    """A match's request lists fulfilled by a ``DeviceRequestExecutor``
    (checksums on) for a bundled game, in whatever process builds it: the
    picklable ``game_factory`` of the process-fleet drivers, passed as
    ``functools.partial(ExecutorGame, "boxgame", 2, device=...)``.

    Each process keeps one ``ExecutorPrograms`` a game and device, and the
    first ExecutorGame built for them warms it up (the game's device
    constants, the digest and every burst depth up to the default
    prediction window) outside any guard, so later constructions and runs
    pay neither.  ``device=None`` is the card and raises without CUDA.  On
    the card every ``run`` is under ``torch.cuda.set_sync_debug_mode(
    "error")``, and the game adds the digest launches it made and their
    prediction from the request lists to ``EXECUTOR_COUNTS``.  Loads of a
    host (numpy) tree, a journal checkpoint after a failover, count in
    ``host_loads``, the game's and the process's.  With ``counts_dir`` the
    process writes its counts to ``counts_dir/executor_game-<pid>.json``
    when it exits (a runner exits at ``sup.close()``).  ``last_save`` is
    the newest saved cell."""

    MAX_PREDICTION = 8  # the session builder's default window

    def __init__(self, game: str = "boxgame", players: int = 2, device=None,
                 counts_dir: Optional[str] = None) -> None:
        from .core.device import resolve_device
        from .games import BoxGame
        from .ops.executor import DeviceRequestExecutor, ExecutorPrograms

        if game != "boxgame":
            raise ValueError(f"ExecutorGame serves 'boxgame', not {game!r}")
        dev = resolve_device(device)
        key = (game, players, str(dev))
        entry = _EXECUTOR_PROGRAMS.get(key)
        if entry is None:
            g = BoxGame(players)
            entry = (g, ExecutorPrograms(g.advance))
        g, programs = entry
        self.ex = DeviceRequestExecutor(g.advance, g.init_state_np(), _u8_inputs,
                                        programs=programs, device=dev)
        if key not in _EXECUTOR_PROGRAMS:
            self.ex.warmup(np.zeros(players, np.uint8),
                           burst_depths=range(2, self.MAX_PREDICTION + 2))
            _EXECUTOR_PROGRAMS[key] = entry
        self.card = self.ex.device.type == "cuda"
        self.host_loads = 0
        self.last_save = None
        if counts_dir is not None and counts_dir not in _COUNTS_DIRS:
            _COUNTS_DIRS.add(counts_dir)
            atexit.register(_write_counts, counts_dir)

    def fulfill(self, requests) -> None:
        from .core.types import LoadGameState, SaveGameState
        from .ops.digest import state_digest

        for r in requests:
            if isinstance(r, LoadGameState):
                host_tree = not isinstance(tree_leaves(r.cell.data())[0], torch.Tensor)
                self.host_loads += host_tree
                EXECUTOR_COUNTS["host_loads"] += host_tree
            elif isinstance(r, SaveGameState):
                self.last_save = r.cell
        if not self.card:
            self.ex.run(requests)
            return
        EXECUTOR_COUNTS["predicted"] += predicted_digest_launches(requests)
        before = state_digest.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            self.ex.run(requests)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            EXECUTOR_COUNTS["launches"] += state_digest.launches - before

    @property
    def state(self):
        return self.ex.state


def drive_fleet_chaos(
    ticks: int,
    matches_per_shard: int = 4,
    seed: int = 0,
    inject: Optional[Callable[[int, Dict[str, Any]], Any]] = None,
    n_spectators: int = 0,
    spectate_match: str = "m0",
    fault_cfg: Optional[Dict[str, Any]] = None,
    journal_dir=None,
    checkpoint_every: int = 8,
    desync_interval: int = 1,
    capacity: int = 64,
    metrics: Optional[Registry] = None,
    tracer=None,
    *,
    game_factory: Optional[Callable[[str], Any]] = None,
    peer_game_factory: Optional[Callable[[str], Any]] = None,
    state_template: Any = 0,
) -> Dict[str, Any]:
    """The fleet-scale chaos world (DESIGN.md §16): a two-shard
    ``ShardSupervisor`` serving ``2 * matches_per_shard`` journaled 2-peer
    matches — ``m0..`` pinned to shard ``s0``, the rest to ``s1`` so
    placement is identical across legs — each against an external Python
    ``P2PSession`` peer on its own seeded fault network, every participant
    running a :class:`CrcGame` with per-frame desync detection.
    ``n_spectators`` real ``SpectatorSession`` viewers watch
    ``spectate_match``.

    ``inject(i, ctx)`` runs at the top of tick ``i`` and drives the fleet
    verbs under test: ``ctx['sup'].kill('s1')``, ``.drain('s1')``,
    ``.migrate(mid)``.  Identical arguments produce a bit-identical run —
    the control/chaos comparison contract — so a leg with an inject is
    compared against one without, match by match.

    ``game_factory(mid)`` and ``peer_game_factory(mid)`` build what fulfils
    a host's and its peer's request lists: an object with
    ``fulfill(requests)`` and a ``state``, a :class:`CrcGame` by default.
    A device game (a ``DeviceRequestExecutor`` behind ``fulfill``) passes
    its game's numpy initial state as ``state_template``: journal failover
    validates the checkpoint it loads against it.  ``ctx['host_ms']`` holds
    each tick's host milliseconds in ``sup.advance_all()`` and in the
    hosts' fulfilment, in that order.
    """
    import tempfile
    import time

    from .core.types import Spectator
    from .core.errors import (
        NotSynchronized,
        PredictionThreshold,
        SpectatorTooFarBehind,
    )
    from .fleet import ShardSupervisor

    base = seed * 1000
    clock = [0]
    registry = metrics if metrics is not None else Registry()
    if journal_dir is None:
        journal_dir = tempfile.mkdtemp(prefix="ggrs_fleet_chaos_")
    sup = ShardSupervisor(
        ("s0", "s1"), capacity=capacity, metrics=registry,
        journal_dir=journal_dir, checkpoint_every=checkpoint_every,
        journal_tail_window=8 * checkpoint_every,
        identity_refresh_every=4, seed=base + 1,
        tracer=tracer,
    )
    n = 2 * matches_per_shard
    match_ids = [f"m{k}" for k in range(n)]
    nets: Dict[str, InMemoryNetwork] = {}
    peers: Dict[str, Any] = {}
    host_socks: Dict[str, RecordingSocket] = {}
    games: Dict[str, CrcGame] = {}
    peer_games: Dict[str, CrcGame] = {}
    viewers: List[Any] = []
    viewer_names = [f"V{v}" for v in range(n_spectators)]
    for k, mid in enumerate(match_ids):
        cfg = dict(fault_cfg or {"latency_ticks": 1})
        cfg.setdefault("seed", base + 100 + k)
        net = InMemoryNetwork(**cfg)
        nets[mid] = net
        host_sock = RecordingSocket(net.socket(f"H{k}"))
        host_socks[mid] = host_sock

        def builder_factory(k=k, mid=mid):
            b = two_peer_builder(clock, base + 3 + 7 * k, 0, f"P{k}")
            if desync_interval:
                b = b.with_desync_detection_mode(
                    DesyncDetection.on(desync_interval)
                )
            if mid == spectate_match:
                for v, vname in enumerate(viewer_names):
                    b = b.add_player(Spectator(vname), 2 + v)
            return b

        sup.admit(
            mid, builder_factory, (lambda s=host_sock: s),
            state_template=state_template,
            shard="s0" if k < matches_per_shard else "s1",
        )
        pb = two_peer_builder(
            clock, base + 4 + 7 * k, 1, f"H{k}", other_handle=0
        )
        if desync_interval:
            pb = pb.with_desync_detection_mode(
                DesyncDetection.on(desync_interval)
            )
        peers[mid] = pb.start_p2p_session(net.socket(f"P{k}"))
        games[mid] = game_factory(mid) if game_factory else CrcGame()
        peer_games[mid] = (peer_game_factory(mid) if peer_game_factory
                           else CrcGame())
    k_spec = match_ids.index(spectate_match) if n_spectators else None
    for v, vname in enumerate(viewer_names):
        vb = (
            SessionBuilder(Config.for_uint(16))
            .with_clock(lambda: clock[0])
            .with_rng(random.Random(base + 900 + v))
        )
        viewers.append(vb.start_spectator_session(
            f"H{k_spec}", nets[spectate_match].socket(vname)
        ))

    reqs_log: Dict[str, List] = {mid: [] for mid in match_ids}
    host_events: Dict[str, List] = {mid: [] for mid in match_ids}
    peer_events: Dict[str, List] = {mid: [] for mid in match_ids}
    viewer_streams: List[List] = [[] for _ in viewers]
    host_ms: List[tuple] = []

    def sched(i, k):
        return ((i + 2 * k) // (2 + k % 3)) % 16

    ctx: Dict[str, Any] = dict(
        sup=sup, peers=peers, nets=nets, clock=clock, seed=seed,
        match_ids=match_ids, viewers=viewers, journal_dir=journal_dir,
    )
    for i in range(ticks):
        clock[0] += 16
        if inject is not None:
            inject(i, ctx)
        for mid, peer in peers.items():
            try:
                peer.add_local_input(1, (i * 5) % 16)
                peer_games[mid].fulfill(peer.advance_frame())
            except (NotSynchronized, PredictionThreshold):
                pass  # host mid-migration: backpressure, not a fault
            peer_events[mid].extend(peer.events())
        for k, mid in enumerate(match_ids):
            sup.add_local_input(mid, 0, sched(i, k))
        t0 = time.perf_counter()
        out = sup.advance_all()
        t1 = time.perf_counter()
        for mid, reqs in out.items():
            games[mid].fulfill(reqs)
        host_ms.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        for mid, reqs in out.items():
            reqs_log[mid].append(req_summary(reqs))
        for mid in match_ids:
            host_events[mid].extend(sup.events(mid))
        for v, viewer in enumerate(viewers):
            try:
                for r in viewer.advance_frame():
                    viewer_streams[v].append(
                        (viewer.current_frame, tuple(r.inputs))
                    )
            except (NotSynchronized, PredictionThreshold,
                    SpectatorTooFarBehind):
                pass
        for net in nets.values():
            net.tick()
    ctx.update(
        wire={mid: s.sent for mid, s in host_socks.items()},
        reqs=reqs_log,
        host_events=host_events,
        peer_events=peer_events,
        viewer_streams=viewer_streams,
        locations={mid: sup.match_location(mid) for mid in match_ids},
        lost=sup.lost_matches(),
        frames={
            mid: (sup.current_frame(mid)
                  if sup.match_location(mid) is not None else None)
            for mid in match_ids
        },
        peer_frames={mid: p.current_frame for mid, p in peers.items()},
        states={mid: games[mid].state for mid in match_ids},
        peer_states={mid: g.state for mid, g in peer_games.items()},
        healthz=sup.healthz(),
        registry=registry,
        host_ms=host_ms,
    )
    return ctx


def drive_proc_fleet(
    ticks: int,
    matches_per_shard: int = 4,
    seed: int = 0,
    backend: str = "proc",
    inject: Optional[Callable[[int, Dict[str, Any]], Any]] = None,
    tuning=None,
    journal_dir=None,
    checkpoint_every: int = 8,
    desync_interval: int = 1,
    capacity: int = 64,
    tick_sleep_s: float = 0.0,
    metrics: Optional[Registry] = None,
    tracer=None,
    *,
    game_factory: Optional[Callable[[], Any]] = None,
    peer_game_factory: Optional[Callable[[], Any]] = None,
    state_template: Any = 0,
) -> Dict[str, Any]:
    """The out-of-process sibling of :func:`drive_fleet_chaos`
    (DESIGN.md §17): a two-shard ``ShardSupervisor`` where ``s0`` is
    always in-process and ``s1`` is a real subprocess when
    ``backend="proc"`` (``"inproc"`` runs the IDENTICAL topology fully
    in-process — the backend-parity comparison leg; ``"tcp"`` is
    ``"proc"`` with the supervisor↔runner control plane carried over
    the §25 authenticated TCP fleet link instead of a socketpair).
    ``2 *
    matches_per_shard`` journaled 2-peer matches over REAL loopback UDP,
    ``m0..`` pinned to ``s0``, the rest to ``s1``; every match is
    described by picklable factories (``fleet.proc.proc_match_builder``
    + ``udp_socket_factory`` + :class:`CrcGame`) so it can serve on —
    and fail over between — either backend.  External Python peers run
    in THIS process either way; each peer's received datagram bytes are
    recorded (:class:`RecvRecordingSocket`) as the port-free wire
    observable two legs are compared on.

    ``inject(i, ctx)`` runs at the top of tick ``i`` with ``ctx``
    carrying ``sup``/``peers``/``clock``; proc scenarios typically
    ``os.kill(ctx['sup'].shards['s1'].pid, SIGKILL/SIGSTOP)``.
    ``tick_sleep_s`` stretches real time per tick so the (wall-clock)
    watchdog deadlines can elapse while the logical clock stays small
    enough that no peer hits its disconnect timeout.

    The supervisor is returned live in ``ctx["sup"]`` — callers MUST
    ``sup.close()`` (the tests/chaos script do it in ``finally``); on an
    exception mid-run the driver closes it before re-raising.

    ``game_factory()`` and ``peer_game_factory()`` build what fulfils a
    host's and its peer's request lists (``fulfill(requests)`` and a
    ``state``), a :class:`CrcGame` by default.  ``game_factory`` is shipped
    to the runner, so it must be picklable (an :class:`ExecutorGame`
    partial); this process builds one per match too, for the matches it
    serves and adopts.  A device game passes its numpy initial state as
    ``state_template``.  ``ctx['host_ms']`` holds each tick's host
    milliseconds in ``sup.advance_all()`` and in this process's fulfilment.
    """
    import functools
    import tempfile

    from .core.errors import NotSynchronized, PredictionThreshold
    from .fleet import ShardSupervisor
    from .fleet.proc import (
        proc_match_builder,
        set_runner_clock,
        udp_socket_factory,
    )
    from .net.sockets import UdpNonBlockingSocket

    if backend not in ("proc", "inproc", "tcp"):
        raise ValueError(f"backend {backend!r}")
    if game_factory is None:
        game_factory = CrcGame
    if peer_game_factory is None:
        peer_game_factory = CrcGame
    base = seed * 1000
    clock = [0]
    registry = metrics if metrics is not None else Registry()
    if journal_dir is None:
        journal_dir = tempfile.mkdtemp(prefix="ggrs_proc_fleet_")
    sup = ShardSupervisor(
        ("s0", "s1"), capacity=capacity, metrics=registry,
        journal_dir=journal_dir, checkpoint_every=checkpoint_every,
        journal_tail_window=8 * checkpoint_every,
        identity_refresh_every=4, seed=base + 1,
        proc_shards=("s1",) if backend in ("proc", "tcp") else (),
        tcp_shards=("s1",) if backend == "tcp" else (),
        proc_clock=lambda: clock[0],
        tuning=tuning,
        tracer=tracer,
    )
    n = 2 * matches_per_shard
    match_ids = [f"m{k}" for k in range(n)]
    peers: Dict[str, Any] = {}
    peer_socks: Dict[str, RecvRecordingSocket] = {}
    games: Dict[str, Any] = {}
    peer_games: Dict[str, Any] = {}
    import socket as _socket

    def _free_udp_port() -> int:
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    try:
        for k, mid in enumerate(match_ids):
            pin = "s0" if k < matches_per_shard else "s1"
            peer_sock = RecvRecordingSocket(UdpNonBlockingSocket(0))
            peer_socks[mid] = peer_sock
            bf = functools.partial(
                proc_match_builder, base + 3 + 7 * k, 0,
                ("127.0.0.1", peer_sock.local_port()),
                desync_interval=desync_interval,
            )
            # the match's wire address must be STABLE across
            # incarnations — the peer only knows this port — so the
            # socket_factory is the match's durable address (the fleet's
            # migration contract).  Matches pinned to the subprocess shard ship a
            # picklable rebind-the-port factory (the dying incarnation's
            # process releases the port before the next one binds);
            # matches served in THIS process reuse one long-lived socket
            # object, exactly like the in-memory fleet topologies.
            if backend in ("proc", "tcp") and pin == "s1":
                host_port = _free_udp_port()
                sf = functools.partial(udp_socket_factory, host_port)
            else:
                host_sock = UdpNonBlockingSocket(0)
                host_port = host_sock.local_port()
                sf = lambda s=host_sock: s  # noqa: E731
            sup.admit(
                mid, bf, sf,
                state_template=state_template, game_factory=game_factory,
                shard=pin,
            )
            assert sup.shards[pin].match_port(mid) == host_port
            pb = two_peer_builder(
                clock, base + 4 + 7 * k, 1, ("127.0.0.1", host_port),
                other_handle=0,
            )
            if desync_interval:
                pb = pb.with_desync_detection_mode(
                    DesyncDetection.on(desync_interval)
                )
            peers[mid] = pb.start_p2p_session(peer_sock)
            games[mid] = game_factory()
            peer_games[mid] = peer_game_factory()

        reqs_log: Dict[str, List] = {mid: [] for mid in match_ids}
        host_events: Dict[str, List] = {mid: [] for mid in match_ids}
        peer_events: Dict[str, List] = {mid: [] for mid in match_ids}
        host_ms: List[tuple] = []

        def sched(i, k):
            return ((i + 2 * k) // (2 + k % 3)) % 16

        ctx: Dict[str, Any] = dict(
            sup=sup, peers=peers, clock=clock, seed=seed,
            match_ids=match_ids, journal_dir=journal_dir,
        )
        import time as _time

        for i in range(ticks):
            clock[0] += 16
            # drive the shared clock cell for every match this process
            # serves (in-proc shards + failover adoptions); proc shards
            # get the same value shipped with their tick RPC
            set_runner_clock(clock[0])
            if inject is not None:
                inject(i, ctx)
            for mid, peer in peers.items():
                try:
                    peer.add_local_input(1, (i * 5) % 16)
                    peer_games[mid].fulfill(peer.advance_frame())
                except (NotSynchronized, PredictionThreshold):
                    pass  # host mid-failover: backpressure, not a fault
                peer_events[mid].extend(peer.events())
            for k, mid in enumerate(match_ids):
                sup.add_local_input(mid, 0, sched(i, k))
            t0 = _time.perf_counter()
            out = sup.advance_all()
            t1 = _time.perf_counter()
            for mid, reqs in out.items():
                games[mid].fulfill(reqs)
            host_ms.append(((t1 - t0) * 1e3,
                            (_time.perf_counter() - t1) * 1e3))
            for mid, reqs in out.items():
                reqs_log[mid].append(req_summary(reqs))
            for mid in match_ids:
                host_events[mid].extend(sup.events(mid))
            if tick_sleep_s:
                _time.sleep(tick_sleep_s)
    except BaseException:
        sup.close()
        raise
    ctx.update(
        wire={mid: list(s.received) for mid, s in peer_socks.items()},
        reqs=reqs_log,
        host_events=host_events,
        peer_events=peer_events,
        locations={mid: sup.match_location(mid) for mid in match_ids},
        lost=sup.lost_matches(),
        frames={
            mid: (sup.current_frame(mid)
                  if sup.match_location(mid) is not None else None)
            for mid in match_ids
        },
        peer_frames={mid: p.current_frame for mid, p in peers.items()},
        peer_states={mid: g.state for mid, g in peer_games.items()},
        healthz=sup.healthz(),
        registry=registry,
        host_ms=host_ms,
    )
    return ctx


def placement_match_builder(seed, me, peer_addr, viewer_addrs=(),
                            desync_interval: int = 0):
    """:func:`~ggrs_tpu_torch.fleet.proc.proc_match_builder` plus real UDP
    spectators — the fully-picklable match description the placement
    chaos legs admit with (``viewer_addrs`` are the viewers' wire
    source addresses, known before admission because the driver binds
    their sockets first).  Picklable by reference like its proc sibling,
    so the same description survives ``export_transfer`` bytes and
    journal failover onto another supervisor."""
    from .core.types import Spectator
    from .fleet.proc import proc_match_builder

    b = proc_match_builder(
        seed, me, peer_addr, desync_interval=desync_interval)
    for v, addr in enumerate(viewer_addrs):
        b = b.add_player(Spectator(tuple(addr)), 2 + v)
    return b


def drive_placement_fleet(
    ticks: int,
    matches_per_host: int = 2,
    seed: int = 0,
    inject: Optional[Callable[[int, Dict[str, Any]], Any]] = None,
    n_spectators: int = 0,
    spectate_match: str = "m0",
    tuning=None,
    journal_dir=None,
    checkpoint_every: int = 8,
    desync_interval: int = 1,
    capacity: int = 64,
    metrics: Optional[Registry] = None,
    tracer=None,
    *,
    game_factory: Optional[Callable[[], Any]] = None,
    peer_game_factory: Optional[Callable[[], Any]] = None,
    state_template: Any = 0,
) -> Dict[str, Any]:
    """The cross-host chaos world (DESIGN.md §26): a
    ``PlacementService`` fronting two single-shard ``ShardSupervisor``
    "hosts" (``h0``/``h1``, sharing one journal directory — the shared
    storage a real fleet mounts) behind one in-process ``IngressNode``
    that owns every public address.  ``2 * matches_per_host`` journaled
    2-peer matches, ``m0..`` pinned to ``h0`` and the rest to ``h1`` so
    placement is identical across legs; every external peer (and every
    ``n_spectators`` viewer of ``spectate_match``) talks ONLY to the
    match's virtual endpoint — the ingress public address — over real
    loopback UDP, and records its received bytes
    (:class:`RecvRecordingSocket`) as the wire observable.

    The tick order makes runs bit-identical for identical arguments
    (loopback ``sendto`` is synchronous, so each pump sees exactly the
    datagrams sent since the last one): peers/viewers advance → ingress
    pump (peer → serving leg) → hosts tick → ingress pump (leg replies →
    peers).  At ``inject`` time the legs' buffers are therefore EMPTY —
    an in-tick ``ctx['placement'].migrate(mid)`` or
    ``.kill_host('h1')`` strands no in-flight datagram, which is what
    lets the migrated-leg wire compare bit-identical to control.

    Callers MUST run ``ctx['close']()`` (tests do it in ``finally``);
    on an exception mid-run the driver closes everything before
    re-raising.

    ``game_factory``, ``peer_game_factory`` and ``state_template`` are
    :func:`drive_proc_fleet`'s (every game here lives in this process);
    ``ctx['host_ms']`` holds each tick's ms in ``placement.advance_all()``
    and in the hosts' fulfilment."""
    import functools
    import tempfile
    import time

    from .core.errors import (
        NotSynchronized,
        PredictionThreshold,
        SpectatorTooFarBehind,
    )
    from .fleet import PlacementService, ShardSupervisor
    from .fleet.ingress import IngressNode
    from .fleet.proc import set_runner_clock
    from .net.sockets import UdpNonBlockingSocket

    if game_factory is None:
        game_factory = CrcGame
    if peer_game_factory is None:
        peer_game_factory = CrcGame
    base = seed * 1000
    clock = [0]
    registry = metrics if metrics is not None else Registry()
    if journal_dir is None:
        journal_dir = tempfile.mkdtemp(prefix="ggrs_placement_")
    hosts = {}
    for hn, (hid, sid) in enumerate((("h0", "a0"), ("h1", "b0"))):
        hosts[hid] = ShardSupervisor(
            (sid,), capacity=capacity, metrics=registry,
            journal_dir=journal_dir, checkpoint_every=checkpoint_every,
            journal_tail_window=8 * checkpoint_every,
            identity_refresh_every=4, seed=base + 1 + hn,
            tuning=tuning, tracer=tracer,
        )
    ingress = IngressNode(metrics=registry, tuning=tuning)
    placement = PlacementService(
        hosts, ingress=ingress, tuning=tuning, metrics=registry)
    public = ingress.public_addr()

    n = 2 * matches_per_host
    match_ids = [f"m{k}" for k in range(n)]
    peers: Dict[str, Any] = {}
    peer_socks: Dict[str, RecvRecordingSocket] = {}
    games: Dict[str, Any] = {}
    peer_games: Dict[str, Any] = {}
    viewers: List[Any] = []
    viewer_socks: List[Any] = []

    def close_all() -> None:
        placement.close()  # live hosts only; dead ones it left alone
        for hid in placement._dead:
            try:
                hosts[hid].close()
            except Exception:
                pass
        ingress.close()
        for s in viewer_socks:
            s.close()
        for s in peer_socks.values():
            s.close()

    try:
        for v in range(n_spectators):
            vs = RecvRecordingSocket(UdpNonBlockingSocket(0))
            viewer_socks.append(vs)
        viewer_addrs = tuple(
            ("127.0.0.1", vs.local_port()) for vs in viewer_socks)
        for k, mid in enumerate(match_ids):
            pin = "h0" if k < matches_per_host else "h1"
            peer_sock = RecvRecordingSocket(UdpNonBlockingSocket(0))
            peer_socks[mid] = peer_sock
            peer_addr = ("127.0.0.1", peer_sock.local_port())
            vaddrs = viewer_addrs if mid == spectate_match else ()
            bf = functools.partial(
                placement_match_builder, base + 3 + 7 * k, 0,
                peer_addr, vaddrs, desync_interval=desync_interval,
            )
            placement.admit(
                mid, bf, peer_addrs=(peer_addr,) + vaddrs,
                state_template=state_template, game_factory=game_factory,
                host=pin,
            )
            # the peer's whole world is the virtual endpoint: the
            # ingress public address, never the serving leg's port
            pb = two_peer_builder(
                clock, base + 4 + 7 * k, 1, tuple(public),
                other_handle=0,
            )
            if desync_interval:
                pb = pb.with_desync_detection_mode(
                    DesyncDetection.on(desync_interval)
                )
            peers[mid] = pb.start_p2p_session(peer_sock)
            games[mid] = game_factory()
            peer_games[mid] = peer_game_factory()
        for v, vs in enumerate(viewer_socks):
            vb = (
                SessionBuilder(Config.for_uint(16))
                .with_clock(lambda: clock[0])
                .with_rng(random.Random(base + 900 + v))
            )
            viewers.append(
                vb.start_spectator_session(tuple(public), vs))

        reqs_log: Dict[str, List] = {mid: [] for mid in match_ids}
        host_events: Dict[str, List] = {mid: [] for mid in match_ids}
        peer_events: Dict[str, List] = {mid: [] for mid in match_ids}
        viewer_streams: List[List] = [[] for _ in viewers]
        host_ms: List[tuple] = []

        def sched(i, k):
            return ((i + 2 * k) // (2 + k % 3)) % 16

        ctx: Dict[str, Any] = dict(
            placement=placement, ingress=ingress, hosts=hosts,
            peers=peers, clock=clock, seed=seed, match_ids=match_ids,
            journal_dir=journal_dir, close=close_all,
        )
        for i in range(ticks):
            clock[0] += 16
            set_runner_clock(clock[0])
            if inject is not None:
                inject(i, ctx)
            for mid, peer in peers.items():
                try:
                    peer.add_local_input(1, (i * 5) % 16)
                    peer_games[mid].fulfill(peer.advance_frame())
                except (NotSynchronized, PredictionThreshold):
                    pass  # host mid-transfer: backpressure, not a fault
                peer_events[mid].extend(peer.events())
            for v, viewer in enumerate(viewers):
                try:
                    for r in viewer.advance_frame():
                        viewer_streams[v].append(
                            (viewer.current_frame, tuple(r.inputs))
                        )
                except (NotSynchronized, PredictionThreshold,
                        SpectatorTooFarBehind):
                    pass
            ingress.pump()  # peers/viewers -> serving legs
            for k, mid in enumerate(match_ids):
                if mid in placement.lost_matches():
                    continue
                placement.add_local_input(mid, 0, sched(i, k))
            t0 = time.perf_counter()
            out = placement.advance_all()
            t1 = time.perf_counter()
            for hout in out.values():
                for mid, reqs in hout.items():
                    games[mid].fulfill(reqs)
            host_ms.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
            for hout in out.values():
                for mid, reqs in hout.items():
                    reqs_log[mid].append(req_summary(reqs))
            lost_now = placement.lost_matches()
            for mid in match_ids:
                if mid not in lost_now:
                    host_events[mid].extend(placement.events(mid))
            ingress.pump()  # leg replies -> peers/viewers
    except BaseException:
        close_all()
        raise
    lost = placement.lost_matches()
    ctx.update(
        wire={mid: list(s.received) for mid, s in peer_socks.items()},
        reqs=reqs_log,
        host_events=host_events,
        peer_events=peer_events,
        viewer_streams=viewer_streams,
        viewer_wire=[list(s.received) for s in viewer_socks],
        locations={
            mid: (
                None if mid in lost
                else (placement.match_host(mid),
                      hosts[placement.match_host(mid)].match_location(mid))
            )
            for mid in match_ids
        },
        vports={
            mid: placement.virtual_endpoint(mid)[1] for mid in match_ids
        },
        public=tuple(public),
        lost=lost,
        frames={
            mid: (None if mid in lost
                  else placement.current_frame(mid))
            for mid in match_ids
        },
        peer_frames={mid: p.current_frame for mid, p in peers.items()},
        states={mid: games[mid].state for mid in match_ids},
        peer_states={mid: g.state for mid, g in peer_games.items()},
        healthz=placement.healthz(),
        registry=registry,
        host_ms=host_ms,
    )
    return ctx


def fleet_survivor_violations(
    chaos: Dict[str, Any],
    control: Dict[str, Any],
    survivors: List[str],
) -> List[str]:
    """Fleet acceptance, part 1: matches on the un-touched shard must be
    bit-identical — wire bytes, request lists, events — between the chaos
    leg and the fault-free control leg, and stay where they were placed."""
    out = []
    for mid in survivors:
        if chaos["locations"][mid] != control["locations"][mid]:
            out.append(
                f"{mid}: moved to {chaos['locations'][mid]} "
                f"(control {control['locations'][mid]})"
            )
        for field in ("wire", "reqs", "host_events"):
            if chaos[field][mid] != control[field][mid]:
                out.append(f"{mid}: {field} diverged from control")
    return out


def fleet_recovery_violations(
    ctx: Dict[str, Any],
    affected: List[str],
    dead_shards: List[str] = (),
    max_lag: int = 40,
) -> List[str]:
    """Fleet acceptance, part 2 (within the chaos leg): every affected
    match recovered — placed on a live shard, peer still connected, no
    desync on either end, and caught back up to within ``max_lag`` frames
    of its external peer."""

    out = []
    for mid, reason in ctx["lost"].items():
        out.append(f"{mid}: LOST ({reason})")
    for mid in affected:
        loc = ctx["locations"][mid]
        if loc is None:
            continue  # already reported as lost
        if loc in dead_shards:
            out.append(f"{mid}: still on dead shard {loc}")
        peer_frame = ctx["peer_frames"][mid]
        frame = ctx["frames"][mid]
        if frame is None or peer_frame - frame > max_lag:
            out.append(
                f"{mid}: stalled at frame {frame} (peer {peer_frame})"
            )
    for mid in ctx["match_ids"]:
        for side in ("host_events", "peer_events"):
            desyncs = [
                e for e in ctx[side][mid] if isinstance(e, DesyncDetected)
            ]
            if desyncs:
                out.append(f"{mid}: {side} desync {desyncs[:2]}")
        discs = [
            e for e in ctx["peer_events"][mid]
            if type(e).__name__ == "Disconnected"
        ]
        if discs:
            out.append(f"{mid}: peer disconnected {discs}")
    return out


def blast_radius_violations(
    chaos: Dict[str, Any],
    control: Dict[str, Any],
    survivors: Optional[List[int]] = None,
) -> List[str]:
    """The acceptance check: every surviving slot must stay bank-resident
    and bit-identical — wire bytes, request lists, events — to the control
    leg, and the crossing count must stay one per pool tick.  Returns the
    (hopefully empty) violation list so callers can assert or report."""
    target = chaos["target"]
    if survivors is None:
        survivors = [i for i in range(len(chaos["states"])) if i != target]
    out = []
    for idx in survivors:
        if chaos["states"][idx] != SLOT_NATIVE:
            out.append(f"slot {idx} left native: {chaos['states'][idx]}")
        for field in ("wire", "reqs", "events"):
            if chaos[field][idx] != control[field][idx]:
                out.append(f"slot {idx}: {field} diverged from control")
    ticks = len(chaos["reqs"][0])
    if chaos["pool"].crossings != ticks:
        out.append(
            f"crossing count {chaos['pool'].crossings} != {ticks} pool ticks"
        )
    return out
