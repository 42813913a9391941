"""The port's kernel-batched socket datapath against the JAX package's, on the
CPU over loopback UDP.

Mirrors ``tests/test_native_io.py``: with ``native_io=True`` every attached
slot's datagrams flow socket -> ``ggrs_bank_pump`` -> socket through
recvmmsg/sendmmsg.  The port's pool (``ggrs_tpu_torch.parallel.host_bank``,
the port's own ``csrc/host/*.cpp`` compiled into its host library) and the JAX
package's pool are driven with the same seeded matches, peers and seeded
loss, duplication and reordering, and must capture the same wire bytes (the
NetBatch capture tee, ephemeral ports mapped to roles), reach the same
frames and return the same request lists and events tick by tick.  Also held
against the JAX pool: one crossing a tick, the io counters, ``ENOBUFS``
storms that fault nothing, ``EPERM`` that evicts exactly one slot, and the
per-slot shuttle fallback (``FakeSocket``, wrapped sockets,
``GGRS_TPU_NO_NATIVE_IO=1``).  Tolerance: exact equality throughout (wire
bytes and the request grammar are integers).

The harness here (``PKGS``, ``udp_leg``) is shared by the port's dispatch,
decode-plane and broadcast tests."""

from __future__ import annotations

import errno
import random
from types import SimpleNamespace

import pytest

import ggrs_tpu.broadcast as jbroadcast
import ggrs_tpu.core as jcore
import ggrs_tpu.core.errors as jerrors
import ggrs_tpu.net.sockets as jsockets
import ggrs_tpu.obs as jobs
import ggrs_tpu.parallel.host_bank as jbank
import ggrs_tpu.sessions as jsessions
from ggrs_tpu.core.config import Config as JConfig
from ggrs_tpu.net import _native as jnative

import ggrs_tpu_torch.broadcast as tbroadcast
import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.core.errors as terrors
import ggrs_tpu_torch.net.sockets as tsockets
import ggrs_tpu_torch.obs as tobs
import ggrs_tpu_torch.parallel.host_bank as tbank
import ggrs_tpu_torch.sessions as tsessions
from ggrs_tpu_torch.core.config import Config as TConfig
from ggrs_tpu_torch.net import _native as tnative

PKGS = {
    "jax": SimpleNamespace(core=jcore, errors=jerrors, sockets=jsockets, obs=jobs,
                           bank=jbank, sessions=jsessions, broadcast=jbroadcast,
                           Config=JConfig, native=jnative),
    "port": SimpleNamespace(core=tcore, errors=terrors, sockets=tsockets, obs=tobs,
                            bank=tbank, sessions=tsessions, broadcast=tbroadcast,
                            Config=TConfig, native=tnative),
}
LOSSY = dict(loss=0.05, duplicate=0.03, reorder=0.03)


class RecordingUdpSocket:
    """Wraps a UdpNonBlockingSocket, recording every raw datagram sent (the
    shuttle leg's capture).  It exposes no ``fileno``, so no pool attaches it
    (also the wrapped-socket fallback case)."""

    def __init__(self, inner):
        self.inner = inner
        self.sent = []

    def send_datagram(self, data, addr) -> None:
        self.sent.append((addr, bytes(data)))
        self.inner.send_datagram(data, addr)

    def send_to(self, msg, addr) -> None:
        self.send_datagram(msg.encode(), addr)

    def receive_all_datagrams(self):
        return self.inner.receive_all_datagrams()

    def receive_all_messages(self):
        return self.inner.receive_all_messages()

    def local_port(self) -> int:
        return self.inner.local_port()


class FaultingUdpSocket:
    """Peer-side socket: real UDP underneath, with seeded loss, duplication
    and reordering applied to its sends (staged per tick, flushed by the
    tick loop).  The three draws happen unconditionally, so the fault schedule
    is a function of the send sequence alone, the same in every leg.  It
    also tapes every datagram it receives (the host's bytes on the wire)."""

    def __init__(self, inner, seed: int, loss=0.0, duplicate=0.0, reorder=0.0):
        self.inner = inner
        self._rng = random.Random(seed)
        self.loss, self.duplicate, self.reorder = loss, duplicate, reorder
        self._staged = []
        self.tape = []

    def send_to(self, msg, addr) -> None:
        payload = msg.encode()
        rng = self._rng
        drop = rng.random() < self.loss
        dup = rng.random() < self.duplicate
        swap = rng.random() < self.reorder
        if drop:
            return
        self._staged.append((addr, payload))
        if dup:
            self._staged.append((addr, payload))
        if swap and len(self._staged) >= 2:
            self._staged[-1], self._staged[-2] = self._staged[-2], self._staged[-1]

    def flush(self) -> None:
        for addr, payload in self._staged:
            self.inner.send_datagram(payload, addr)
        self._staged.clear()

    def receive_all_datagrams(self):
        got = self.inner.receive_all_datagrams()
        self.tape.extend(data for _, data in got)
        return got

    def receive_all_messages(self):
        return self.inner.receive_all_messages()

    def close(self) -> None:
        self.inner.close()


def fulfill(requests):
    for r in requests:
        if type(r).__name__ == "SaveGameState":
            r.cell.save(r.frame, None, None)


def summary(requests):
    """A package-neutral value of one request list."""
    out = []
    for r in requests:
        kind = type(r).__name__
        if kind == "AdvanceFrame":
            out.append((kind, tuple((v, st.name) for v, st in r.inputs)))
        else:
            out.append((kind, r.frame))
    return out


def event_summary(events, roles):
    """Package-neutral events, addresses mapped to roles."""
    out = []
    for e in events:
        fields = dict(vars(e))
        if "addr" in fields:
            fields["addr"] = roles.get(fields["addr"], "?")
        out.append((type(e).__name__, tuple(sorted(fields.items()))))
    return out


def builder(pkg, cfg, clock, seed, me, other_addr):
    p = PKGS[pkg]
    return (
        p.sessions.SessionBuilder(cfg)
        .with_clock(lambda: clock[0])
        .with_rng(random.Random(seed))
        .add_player(p.core.Local(), me)
        .add_player(p.core.Remote(other_addr), 1 - me)
    )


def sched(i, m):
    return ((i + 2 * m) // (2 + m % 3)) % 16


def udp_leg(pkg, native_io, seed, ticks, n_matches, faults=None, n_viewers=0,
            metrics=None, host="private", hub_rng=None, journals=None,
            before_tick=None, blackout=(), record=None):
    """One leg over real loopback UDP: ``n_matches`` host slots in one pool
    (two players, one out-of-pool peer each whose sends pass a seeded fault
    stage), optionally ``n_viewers`` real ``SpectatorSession``s per match
    attached through a ``SpectatorHub``.  ``host`` is "private" (one
    ``UdpNonBlockingSocket(0)`` per slot; on the shuttle leg wrapped in a
    recorder), or "dispatch" (every slot a view on one
    ``DispatchHub(siblings=1)``); ``record=False`` leaves the shuttle leg's
    private sockets unwrapped (fd-backed: the send and receive tables cover
    them).  ``journals`` maps match -> a journal the
    hub taps.  ``before_tick(i, pool)`` runs before each tick's staging.
    Ticks in ``blackout`` jump the clock by 300 ms and drop the peers' and
    viewers' sends (the event-heavy path).  Records per tick every slot's
    request summary and events; returns the captured sends (roles), the
    peers' receive tapes, frames and the pool."""
    p = PKGS[pkg]
    if record is None:
        record = not native_io and host == "private"
    cfg = p.Config.for_uint(16)
    clock = [0]
    pool = p.bank.HostSessionPool(native_io=native_io, metrics=metrics)
    shub = None
    if n_viewers or journals:
        shub = p.broadcast.SpectatorHub(pool, rng=random.Random(hub_rng or 9000 + seed))
    dhub = p.sockets.DispatchHub(siblings=1) if host == "dispatch" else None
    peers, peer_socks, host_socks, raws, viewers, viewer_socks, roles = [], [], [], [], [], [], []
    for m in range(n_matches):
        if dhub is not None:
            raw = sock = dhub.view()
        else:
            raw = p.sockets.UdpNonBlockingSocket(0)
            sock = RecordingUdpSocket(raw) if record else raw
        host_port = raw.local_port()
        peer_inner = p.sockets.UdpNonBlockingSocket(0)
        peer_addr = ("127.0.0.1", peer_inner.local_port())
        peer_sock = FaultingUdpSocket(peer_inner, seed * 101 + m, **(faults or {}))
        pool.add_session(builder(pkg, cfg, clock, 3 + 5 * m, 0, peer_addr), sock)
        peers.append(builder(pkg, cfg, clock, 4 + 5 * m, 1, ("127.0.0.1", host_port))
                     .start_p2p_session(peer_sock))
        peer_socks.append(peer_sock)
        host_socks.append(sock)
        raws.append(raw)
        roles.append({peer_addr: "peer"})
    # viewers attach after every session is registered (attach finalizes the
    # pool) but before the first tick confirms frame 0
    for m in range(n_matches):
        host_port = raws[m].local_port()
        for v in range(n_viewers):
            inner = p.sockets.UdpNonBlockingSocket(0)
            vsock = FaultingUdpSocket(inner, 50 + 7 * m + v)
            vaddr = ("127.0.0.1", inner.local_port())
            viewer = (
                p.sessions.SessionBuilder(cfg).with_clock(lambda: clock[0])
                .with_rng(random.Random(7000 + 13 * m + v))
            ).start_spectator_session(("127.0.0.1", host_port), vsock)
            viewers.append(viewer)
            viewer_socks.append(vsock)
            roles[m][vaddr] = f"viewer{v}"
            shub.attach(m, vaddr)
        if journals and m in journals:
            shub.attach_journal(m, journals[m])
    assert pool.native_active, "native bank did not engage"
    if native_io and host == "private":
        assert pool.native_io_active, "batched datapath did not attach"
        for m in range(n_matches):
            pool._io_set_capture(m)
    sent = [[] for _ in range(n_matches)]
    trace = []
    stream = [[] for _ in viewers]
    for i in range(ticks):
        dark = i in blackout
        clock[0] += 316 if dark else 16
        for m, peer in enumerate(peers):
            peer.add_local_input(1, sched(i, m))
            fulfill(peer.advance_frame())
        for sock in peer_socks + viewer_socks:
            # the peers' faulted sends reach the host before its crossing
            if dark:
                sock._staged.clear()
            else:
                sock.flush()
        if before_tick is not None:
            before_tick(i, pool)
        for m in range(n_matches):
            pool.add_local_input(m, 0, sched(i, m))
        reqs = pool.advance_all()
        row = []
        for m in range(n_matches):
            fulfill(reqs[m])
            row.append((summary(reqs[m]), pool.current_frame(m),
                        event_summary(pool.events(m), roles[m])))
        trace.append(row)
        for k, viewer in enumerate(viewers):
            try:
                got = viewer.advance_frame()
            except (p.errors.NotSynchronized, p.errors.PredictionThreshold):
                continue
            fulfill(got)
            stream[k].extend(summary(got))
        if native_io and host == "private":
            for m in range(n_matches):
                if pool.io_state(m) == "native":
                    sent[m].extend(pool._io_drain_capture(m))
    for sock in peer_socks + viewer_socks:
        sock.receive_all_datagrams()  # the last tick's sends onto the tapes
    if record:
        for m in range(n_matches):
            sent[m] = list(host_socks[m].sent)
    return dict(
        sent=[[(roles[m].get(addr, f"?{addr}"), data) for addr, data in sent[m]]
              for m in range(n_matches)],
        tapes=[s.tape for s in peer_socks],
        viewer_tapes=[s.tape for s in viewer_socks],
        frames=[pool.current_frame(m) for m in range(n_matches)],
        trace=trace, crossings=pool.crossings, pool=pool, hub=shub, dispatch=dhub,
        viewers=viewers, viewer_frames=[v.current_frame for v in viewers],
        viewer_streams=stream, host_socks=raws,
        close=lambda: [s.close() for s in peer_socks + viewer_socks],
    )


@pytest.mark.parametrize("faults,blackout", [(None, ()), (LOSSY, ()), (LOSSY, range(40, 52))],
                         ids=["clean", "lossy", "lossy_blackout"])
def test_wire_bytes_frames_requests_events_equal_jax(faults, blackout):
    ticks, n = 110, 2
    jax = udp_leg("jax", True, 23, ticks, n, faults, blackout=blackout)
    port = udp_leg("port", True, 23, ticks, n, faults, blackout=blackout)
    if blackout:
        assert any(ev for row in port["trace"] for _, _, ev in row), "no events"
    for m in range(n):
        assert port["sent"][m] == jax["sent"][m], f"match {m}: wire bytes differ"
    assert port["trace"] == jax["trace"]
    assert port["tapes"] == jax["tapes"]
    assert port["frames"] == jax["frames"]
    assert min(port["frames"]) >= ticks - 64 - len(blackout)
    assert min(len(s) for s in port["sent"]) > ticks
    assert port["pool"].crossings == jax["pool"].crossings == ticks


def test_pump_equals_the_python_shuttle():
    ticks, n = 100, 2
    shuttle = udp_leg("port", False, 7, ticks, n, LOSSY)
    pump = udp_leg("port", True, 7, ticks, n, LOSSY)
    assert pump["sent"] == shuttle["sent"]
    assert pump["trace"] == shuttle["trace"]
    assert shuttle["pool"].io_state(0) == "python"
    assert not shuttle["pool"].native_io_active


def test_viewer_fanout_equal_jax():
    ticks, n = 90, 2
    jax = udp_leg("jax", True, 7, ticks, n, LOSSY, n_viewers=2)
    port = udp_leg("port", True, 7, ticks, n, LOSSY, n_viewers=2)
    assert port["sent"] == jax["sent"]
    assert port["viewer_tapes"] == jax["viewer_tapes"]
    assert port["viewer_streams"] == jax["viewer_streams"]
    assert port["trace"] == jax["trace"]
    assert all(f > ticks - 60 for f in port["viewer_frames"]), port["viewer_frames"]
    assert port["pool"].io_stats()["send_datagrams"] > ticks * n


def test_one_crossing_and_batching_equal_jax():
    ticks, n = 60, 2
    jax = udp_leg("jax", True, 5, ticks, n, metrics=jobs.Registry())
    port = udp_leg("port", True, 5, ticks, n, metrics=tobs.Registry())
    pool = port["pool"]
    assert port["crossings"] == ticks
    st, jst = pool.io_stats(), jax["pool"].io_stats()
    for k in tnative.IO_STAT_FIELDS:
        assert st[k] == jst[k], k
    assert st["recv_datagrams"] > 0 and st["send_datagrams"] > 0
    # the shuttle would pay about one syscall per datagram
    assert st["recv_calls"] + st["send_calls"] < st["recv_datagrams"] + st["send_datagrams"]
    assert st["recv_calls"] <= 2 * ticks * n and st["send_calls"] <= 2 * ticks * n
    reg = pool.metrics
    assert reg.value("ggrs_io_syscalls_total", kind="recvmmsg") == st["recv_calls"]
    assert reg.value("ggrs_io_datagrams_total", dir="out") == st["send_datagrams"]
    assert pool.io_capabilities() == jax["pool"].io_capabilities()


def _storm(pkg, err, count, at=30, ticks=100):
    def inject(i, pool):
        if i == at:
            pool.inject_socket_errno(0, err, count)

    leg = udp_leg(pkg, True, 11, ticks, 2, before_tick=inject)
    pool = leg["pool"]
    return leg, dict(
        states=[pool.slot_state(m) for m in range(2)],
        io=[pool.io_state(m) for m in range(2)],
        codes=[[f.code for f in pool.fault_log(m)] for m in range(2)],
        frames=leg["frames"], trace=leg["trace"],
        send_errors=pool.io_stats()["send_errors"],
    )


def test_enobufs_storm_faults_nothing_as_in_jax():
    port_leg, port = _storm("port", errno.ENOBUFS, 10)
    _, jax = _storm("jax", errno.ENOBUFS, 10)
    assert port == jax
    assert port["states"] == ["native", "native"] and port["io"] == ["native", "native"]
    assert port["send_errors"] >= 10
    assert min(port["frames"]) > 60


def test_eperm_evicts_exactly_one_slot_as_in_jax():
    port_leg, port = _storm("port", errno.EPERM, 1)
    _, jax = _storm("jax", errno.EPERM, 1)
    assert port == jax
    assert port["states"] == ["evicted", "native"]
    assert tnative.BANK_ERR_IO in port["codes"][0]
    assert port["io"] == ["python", "native"]
    assert port["frames"][0] > 40 and port["frames"][1] > 60
    st = port_leg["pool"].io_stats()
    assert st["recv_calls"] > 30 and st["send_calls"] > 30  # the detached slot's totals stay


def _fallback(pkg, kind, monkeypatch):
    p = PKGS[pkg]
    cfg = p.Config.for_uint(16)
    clock = [0]
    pool = p.bank.HostSessionPool(native_io=True)
    if kind == "in_memory":
        net = p.sockets.InMemoryNetwork(latency_ticks=1)
        for me in (0, 1):
            names = ("X", "Y")
            pool.add_session(builder(pkg, cfg, clock, me, me, names[1 - me]),
                             net.socket(names[me]))
        drive = [None]
    else:
        if kind == "env":
            monkeypatch.setenv("GGRS_TPU_NO_NATIVE_IO", "1")
        raw = p.sockets.UdpNonBlockingSocket(0)
        host = RecordingUdpSocket(raw) if kind == "wrapped" else raw
        peer_sock = p.sockets.UdpNonBlockingSocket(0)
        pool.add_session(builder(pkg, cfg, clock, 1, 0, ("127.0.0.1", peer_sock.local_port())),
                         host)
        drive = [builder(pkg, cfg, clock, 2, 1, ("127.0.0.1", raw.local_port()))
                 .start_p2p_session(peer_sock)]
    assert pool.native_active and not pool.native_io_active
    trace = []
    for i in range(40):
        clock[0] += 16
        if drive[0] is not None:
            drive[0].add_local_input(1, i % 16)
            fulfill(drive[0].advance_frame())
            pool.add_local_input(0, 0, i % 16)
        else:
            for idx in range(2):
                pool.add_local_input(idx, idx, (i + idx) % 16)
        reqs = pool.advance_all()
        for r in reqs:
            fulfill(r)
        trace.append([summary(r) for r in reqs])
        if drive[0] is None:
            net.tick()
    stats = pool.io_stats()
    return dict(io_state=[pool.io_state(i) for i in range(len(pool))], trace=trace,
                io=[stats[k] for k in p.native.IO_STAT_FIELDS],
                drained=stats["drain"]["datagrams"] if kind == "in_memory" else None,
                caps=pool.io_capabilities())


@pytest.mark.parametrize("kind", ["in_memory", "wrapped", "env"])
def test_unattachable_slots_keep_the_shuttle_as_in_jax(kind, monkeypatch):
    port = _fallback("port", kind, monkeypatch)
    jax = _fallback("jax", kind, monkeypatch)
    assert port == jax
    assert set(port["io_state"]) == {"python"}
    assert port["io"] == [0] * len(tnative.IO_STAT_FIELDS)
    assert len(port["trace"][-1][0]) > 0
    if kind == "env":
        assert tnative.net_lib() is None and not port["caps"]["native_io"]


def test_native_tables_pinned_to_jax():
    for name in ("IO_STAT_FIELDS", "IO_BATCH_BUCKETS", "IO_STAT_WORDS", "NET_SEND_FLAG_DISPATCH",
                 "NET_FD_FIELDS", "NET_FD_STRIDE", "NET_ROUTE_FIELDS", "NET_ROUTE_STRIDE",
                 "NET_RECV_FIELDS", "NET_RECV_STRIDE", "NET_RECV_TABLE_STATS",
                 "NET_RECV_TABLE_STAT_FIELDS", "NET_SEND_STATS"):
        assert getattr(tnative, name) == getattr(jnative, name), name
    lib = tnative.net_lib()
    assert lib.ggrs_net_recv_stride() == tnative.NET_RECV_STRIDE
    assert lib.ggrs_net_route_stride() == tnative.NET_ROUTE_STRIDE
    assert lib.ggrs_net_fd_stride() == tnative.NET_FD_STRIDE
    assert lib.ggrs_net_recv_stats_len() == tnative.NET_RECV_TABLE_STATS
    assert lib.ggrs_net_send_stats_len() == tnative.NET_SEND_STATS
    assert tnative.broadcast_lib() is lib
    # the two packages load separate libraries: each has its own process-wide
    # GSO and GRO posture
    assert lib._handle != jnative.net_lib()._handle
