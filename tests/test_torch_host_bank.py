"""The port's HostSessionPool against the JAX package's, on the CPU.

Mirrors ``tests/test_session_bank.py`` and ``tests/test_policy_plane.py``:
the same seeded matches, on identically seeded fault networks, through the
JAX package's native bank and the port's (``ggrs_tpu_torch.parallel.
host_bank``, over the port's own copy of the bank,
``ggrs_tpu_torch/csrc/host/session_bank.cpp``, compiled into its host
library) must send the same wire bytes and produce the same frames,
events and request lists, tick by tick, under loss, duplication and
reordering, with the descriptor plane on and with the reference decoder
(``GGRS_TPU_NO_FASTPATH=1``).  The port's bank, its Python fallback and
plain per-session port ``P2PSession``s agree with one another; the bank
makes exactly one ``ggrs_bank_tick`` crossing per tick; the packed tables
are pinned to the library and to the JAX package's copy.  Tolerance: exact
equality throughout (the wire and the request grammar are integers)."""

from __future__ import annotations

import ctypes
import random
from types import SimpleNamespace

import numpy as np
import pytest

import ggrs_tpu.core as jcore
import ggrs_tpu.obs.trace as jtrace
import ggrs_tpu.net as jnet
import ggrs_tpu.obs as jobs
import ggrs_tpu.parallel.host_bank as jbank
import ggrs_tpu.sessions as jsessions
from ggrs_tpu.core.config import Config as JConfig
from ggrs_tpu.net import _native as jnative

import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.obs.trace as ttrace
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.obs as tobs
import ggrs_tpu_torch.parallel.host_bank as tbank
import ggrs_tpu_torch.sessions as tsessions
from ggrs_tpu_torch.core.config import Config as TConfig
from ggrs_tpu_torch.net import _native as tnative

PKGS = {
    "jax": SimpleNamespace(core=jcore, net=jnet, sessions=jsessions, bank=jbank,
                           Config=JConfig, native=jnative, trace=jtrace, obs=jobs),
    "port": SimpleNamespace(core=tcore, net=tnet, sessions=tsessions, bank=tbank,
                            Config=TConfig, native=tnative, trace=ttrace, obs=tobs),
}
LOSSY = dict(seed=77, loss=0.08, duplicate=0.04, reorder=0.15, latency_ticks=1)


class RecordingSocket:
    """Wraps a FakeSocket, recording every (addr, wire bytes) it sends,
    through whichever send entry the pool picks (per datagram or batched)."""

    def __init__(self, inner):
        self.inner = inner
        self.sent = []

    def send_to(self, msg, addr):
        self.sent.append((addr, msg.encode()))
        self.inner.send_to(msg, addr)

    def send_datagram(self, data, addr):
        self.sent.append((addr, bytes(data)))
        self.inner.send_datagram(data, addr)

    def send_datagram_batch(self, items):
        self.sent.extend((addr, bytes(data)) for data, addr in items)
        self.inner.send_datagram_batch(items)

    def receive_all_datagrams(self):
        return self.inner.receive_all_datagrams()

    def receive_all_messages(self):
        return self.inner.receive_all_messages()


def builder(pkg, clock, seed, me, other, cfg=None, tweak=None, other_handle=None):
    p = PKGS[pkg]
    b = (
        p.sessions.SessionBuilder(cfg or p.Config.for_uint(16))
        .with_clock(lambda: clock[0])
        .with_rng(random.Random(seed))
        .add_player(p.core.Local(), me)
        .add_player(p.core.Remote(other), 1 - me if other_handle is None else other_handle)
    )
    return tweak(b) if tweak is not None else b


def match_builders(pkg, net, clock, n_matches, tweak=None):
    """2 * n_matches sessions (n_matches two-peer matches) over ``net``."""
    out = []
    for m in range(n_matches):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            b = builder(pkg, clock, 3 + 5 * m + me, me, names[1 - me], tweak=tweak)
            out.append((b, RecordingSocket(net.socket(names[me]))))
    return out


def fulfill_saves(requests):
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


def sched(i, idx):
    return (i * 7 + 3 * idx) % 16


def drive(pkg, ticks, faults=None, n_matches=3, mode="pool", stage=False,
          tweak=None, blackout=(), scrape=False, pool_kwargs=None):
    """Drive ``n_matches`` seeded matches for ``ticks`` ticks and record,
    per tick, every session's requests, events, frames and sent bytes.
    ``mode`` is "pool" (a HostSessionPool) or "sessions" (plain per-session
    P2PSessions, the semantic reference).  Ticks in ``blackout`` jump the
    clock and deliver nothing (the event-heavy path)."""
    p = PKGS[pkg]
    clock = [0]
    net = p.net.InMemoryNetwork(**(faults or {}))
    bs = match_builders(pkg, net, clock, n_matches, tweak)
    n = len(bs)
    if mode == "pool":
        pool = p.bank.HostSessionPool(**(pool_kwargs or {}))
        for b, s in bs:
            pool.add_session(b, s)
        pool.native_active  # finalize at clock 0, where the sessions start
    else:
        pool = None
        sessions = [b.start_p2p_session(s) for b, s in bs]
    trace = []
    for i in range(ticks):
        if i in blackout:
            clock[0] += 300
        clock[0] += 16
        items = [(idx, idx % 2, sched(i, idx)) for idx in range(n)]
        if pool is None:
            for idx, h, v in items:
                sessions[idx].add_local_input(h, v)
            reqs = [s.advance_frame() for s in sessions]
        else:
            if stage:
                pool.stage_inputs(items)
            else:
                for idx, h, v in items:
                    pool.add_local_input(idx, h, v)
            reqs = pool.advance_all()
        row = []
        for idx in range(n):
            r = reqs[idx]
            fulfill_saves(r)
            if pool is None:
                s = sessions[idx]
                ev, cur, conf = s.events(), s.current_frame, s._sync_layer.last_confirmed_frame
            else:
                ev, cur = pool.events(idx), pool.current_frame(idx)
                conf = pool.last_confirmed_frame(idx)
            row.append((summary(r), [repr(e) for e in ev], cur, conf))
        if scrape and pool is not None:
            pool.scrape()
        trace.append(row)
        if i not in blackout:
            net.tick()
    return SimpleNamespace(pool=pool, trace=trace, sent=[s.sent for _, s in bs], clock=clock)


def assert_runs_equal(a, b):
    for i, (ra, rb) in enumerate(zip(a.trace, b.trace)):
        for idx, (x, y) in enumerate(zip(ra, rb)):
            assert x == y, f"tick {i} session {idx}: {x} != {y}"
    assert len(a.trace) == len(b.trace)
    assert a.sent == b.sent, "wire bytes diverged"


@pytest.fixture
def fastpath(request, monkeypatch):
    """The decoder: the descriptor plane, the reference decoder
    (``GGRS_TPU_NO_FASTPATH=1``), or the reference decoder of a traced pool
    (its in-crossing phase timers armed, a timing tail on every output)."""
    if request.param == "reference":
        monkeypatch.setenv("GGRS_TPU_NO_FASTPATH", "1")
    else:
        monkeypatch.delenv("GGRS_TPU_NO_FASTPATH", raising=False)
    return request.param


def traced(pkg, fastpath):
    return dict(tracer=PKGS[pkg].trace.Tracer()) if fastpath == "traced" else None


# -- the port's bank against the JAX package's --------------------------------


@pytest.mark.parametrize("fastpath", ["descriptor", "reference", "traced"], indirect=True)
@pytest.mark.parametrize("faults", [None, LOSSY], ids=["clean", "lossy"])
def test_bank_matches_jax_bank(fastpath, faults):
    jx = drive("jax", 70, faults, scrape=True, pool_kwargs=traced("jax", fastpath))
    pt = drive("port", 70, faults, scrape=True, pool_kwargs=traced("port", fastpath))
    assert jx.pool.native_active and pt.pool.native_active
    assert_runs_equal(jx, pt)
    assert pt.pool.crossings == jx.pool.crossings == 70
    if fastpath == "descriptor":
        assert pt.pool.fast_slot_ticks == jx.pool.fast_slot_ticks > 0
        assert pt.pool.plan_ticks == 70
    else:
        assert pt.pool.fast_slot_ticks == 0 and pt.pool.plan_ticks == 0
    if fastpath == "traced":
        # the native phase timings ride the tick and stats outputs
        assert set(pt.pool.last_tick_phases()) == set(tnative.BANK_PHASES)
        assert pt.pool.native_phase_totals()[0] == 70
        names = {e[1] for e in pt.pool.tracer.events()}
        assert {"bank.crossing", "pool.slot", "pool.tick"} <= names


@pytest.mark.parametrize("fastpath", ["descriptor", "reference"], indirect=True)
def test_event_heavy_blackout_matches_jax(fastpath):
    # clock jumps with nothing delivered: interrupt and resume events, retry
    # volleys, the slow-slot decode
    blackout = {30, 31, 32, 60}
    jx = drive("jax", 90, None, n_matches=2, blackout=blackout)
    pt = drive("port", 90, None, n_matches=2, blackout=blackout)
    assert_runs_equal(jx, pt)
    assert any(ev for row in pt.trace for _, ev, _, _ in row)


@pytest.mark.parametrize("leg", ["bank", "fallback"])
def test_bank_and_fallback_match_plain_sessions(leg, monkeypatch):
    if leg == "fallback":
        monkeypatch.setenv("GGRS_TPU_NO_NATIVE", "1")
    ref = drive("port", 80, LOSSY, mode="sessions")
    got = drive("port", 80, LOSSY)
    assert got.pool.native_active == (leg == "bank")
    assert_runs_equal(ref, got)
    assert got.pool.crossings == (80 if leg == "bank" else 0)


def test_one_crossing_per_tick_and_scrapes_add_none():
    from ggrs_tpu_torch.obs import Registry

    run = drive("port", 40, LOSSY, n_matches=4, scrape=True,
                pool_kwargs=dict(metrics=Registry()))
    pool = run.pool
    assert pool.crossings == 40, "the tick path made more than one crossing"
    assert pool.stat_crossings == 40
    pool.scrape()  # cached within the tick
    assert pool.stat_crossings == 40 and pool.crossings == 40
    assert pool.harvests == 0
    assert pool.metrics.value("ggrs_pool_crossings_total", kind="tick") == 40
    assert pool.metrics.value("ggrs_pool_crossings_total", kind="stats") == 40
    assert pool.metrics.value("ggrs_pool_ticks_total") == 40


INELIGIBLE = {
    "no_native": None,
    "sparse_saving": lambda b: b.with_sparse_saving_mode(True),
    "lockstep": lambda b: b.with_max_prediction_window(0),
    "desync_detection": lambda b: b.with_desync_detection_mode(
        type(b._desync_detection).on(4)),
    "handshake": lambda b: b.with_sync_handshake(True),
}


@pytest.mark.parametrize("shape", sorted(INELIGIBLE))
def test_ineligible_shapes_fall_back_like_jax(shape, monkeypatch):
    if shape == "no_native":
        monkeypatch.setenv("GGRS_TPU_NO_NATIVE", "1")
    tweak = INELIGIBLE[shape]
    if shape == "handshake":
        # handshaking sessions raise NotSynchronized until the handshake
        # completes; the pools must agree on when that is
        for pkg in ("jax", "port"):
            p = PKGS[pkg]
            clock = [0]
            net = p.net.InMemoryNetwork()
            pool = p.bank.HostSessionPool()
            for b, s in match_builders(pkg, net, clock, 1, tweak):
                pool.add_session(b, s)
            assert not pool.native_active
        return
    jx = drive("jax", 40, LOSSY, n_matches=2, tweak=tweak)
    pt = drive("port", 40, LOSSY, n_matches=2, tweak=tweak)
    assert not pt.pool.native_active
    assert pt.pool.crossings == 0
    assert_runs_equal(jx, pt)


def test_spectator_matches_run_as_python_sessions():
    # no hub in this slice: a match with spectators is ineligible
    clock = [0]
    net = tnet.InMemoryNetwork()
    pool = tbank.HostSessionPool()
    for me in (0, 1):
        b = builder("port", clock, me, me, ("Y", "X")[me])
        b = b.add_player(tcore.Spectator(f"S{me}"), 2)
        pool.add_session(b, net.socket(("X", "Y")[me]))
    assert not pool.native_active


def test_mixed_timebases_fall_back():
    from ggrs_tpu_torch.net.protocol import monotonic_ms

    net = tnet.InMemoryNetwork()
    pool = tbank.HostSessionPool()
    for me, clock in ((0, lambda: 0), (1, monotonic_ms)):
        b = (tsessions.SessionBuilder(TConfig.for_uint(16)).with_clock(clock)
             .with_rng(random.Random(me)).add_player(tcore.Local(), me)
             .add_player(tcore.Remote(("Y", "X")[me]), 1 - me))
        pool.add_session(b, net.socket(("X", "Y")[me]))
    assert not pool.native_active


def _variable_size_run(pkg):
    p = PKGS[pkg]
    clock = [0]
    net = p.net.InMemoryNetwork()
    pool = p.bank.HostSessionPool()
    for me in (0, 1):
        b = builder(pkg, clock, me, me, ("Y", "X")[me], cfg=p.Config.for_bytes())
        pool.add_session(b, net.socket(("X", "Y")[me]))
    assert not pool.native_active
    trace = []
    for i in range(20):
        clock[0] += 16
        pool.add_local_input(0, 0, bytes([i % 7]))
        pool.add_local_input(1, 1, bytes([i % 5, 1]))
        reqs = pool.advance_all()
        for r in reqs:
            fulfill_saves(r)
        net.tick()
        trace.append(([summary(r) for r in reqs], pool.current_frame(0), pool.current_frame(1)))
    return trace


def test_variable_size_inputs_fall_back():
    port = _variable_size_run("port")
    assert port[-1][1] > 10
    assert port == _variable_size_run("jax")


def test_empty_pool_and_lazy_observables():
    assert tbank.HostSessionPool().advance_all() == []
    assert not tbank.HostSessionPool().native_active
    net = tnet.InMemoryNetwork()
    pool = tbank.HostSessionPool()
    clock = [0]
    for b, s in match_builders("port", net, clock, 1):
        pool.add_session(b, s)
    assert pool.current_frame(0) == 0
    assert pool.last_confirmed_frame(1) == -1
    assert pool.frames_ahead(0) == 0
    assert pool.events(0) == []
    assert pool.native_active


def _c2_run(pkg, **pool_kwargs):
    """Two slots fault on one tick under the given pool keywords; returns the
    slot-0 recorder length and the supervision transitions."""
    p = PKGS[pkg]
    clock = [0]
    net = p.net.InMemoryNetwork(latency_ticks=1)
    pool = p.bank.HostSessionPool(metrics=p.obs.Registry(), **pool_kwargs)
    for b, s in match_builders(pkg, net, clock, 2):
        pool.add_session(b, s)
    assert pool.native_active
    for i in range(40):
        clock[0] += 16
        if i == 20:
            pool.inject_slot_error(0)
            pool.inject_slot_error(2)
        for idx in range(len(pool)):
            pool.add_local_input(idx, idx % 2, sched(i, idx))
        for reqs in pool.advance_all():
            fulfill_saves(reqs)
        net.tick()
    return len(pool.flight_recorder(1)), pool.drain_state_transitions()


@pytest.mark.parametrize("kwargs", [dict(flight_recorder_size=8), dict(evict_max_per_tick=1), {}],
                         ids=["flight_recorder_size", "evict_max_per_tick", "defaults"])
def test_pool_keywords_match_jax(kwargs):
    """The JAX constructor's ``flight_recorder_size`` (the recorder's
    capacity) and ``evict_max_per_tick`` (the eviction storm clamp, None =
    EVICT_MAX_PER_TICK) take the JAX semantics."""
    port = _c2_run("port", **kwargs)
    assert port == _c2_run("jax", **kwargs)
    recorded, transitions = port
    evicted = {slot: tick for slot, _, new, tick in transitions if new == "evicted"}
    assert set(evicted) == {0, 2}
    if kwargs.get("evict_max_per_tick") == 1:
        assert evicted[0] != evicted[2]
    else:
        assert evicted[0] == evicted[2]
    if "flight_recorder_size" in kwargs:
        assert recorded == 8


def _growth_run(pkg, shrink_at):
    p = PKGS[pkg]
    clock = [0]
    net = p.net.InMemoryNetwork(latency_ticks=1)
    pool = p.bank.HostSessionPool()
    bs = match_builders(pkg, net, clock, 2)
    for b, s in bs:
        pool.add_session(b, s)
    assert pool.native_active
    trace = []
    for i in range(30):
        clock[0] += 16
        if i == shrink_at:
            pool._out_buf = ctypes.create_string_buffer(8)
        for idx in range(len(pool)):
            pool.add_local_input(idx, idx % 2, sched(i, idx))
        reqs = pool.advance_all()
        trace.append([summary(r) for r in reqs])
        for r in reqs:
            fulfill_saves(r)
        net.tick()
    assert len(pool._out_buf) > 8
    assert all(pool.current_frame(i) >= 20 for i in range(len(pool)))
    return trace, [s.sent for _, s in bs]


@pytest.mark.parametrize("shrink_at", [1, 10])
def test_undersized_output_buffer_grows_and_keeps_running(shrink_at):
    """kErrBufferTooSmall is a grow-and-fetch (one extra crossing), not a
    poisoned pool; the run stays equal to the JAX package's."""
    assert _growth_run("port", shrink_at) == _growth_run("jax", shrink_at)


@pytest.mark.parametrize("fastpath", ["descriptor", "reference"], indirect=True)
def test_silent_peer_disconnect_matches_jax(fastpath):
    """A peer goes silent: NetworkInterrupted, then Disconnected, then the
    session runs on; the native path reacts one tick late (the JAX
    package's documented behaviour) and the port reproduces it."""
    runs = {}
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        clock = [0]
        net = p.net.InMemoryNetwork(latency_ticks=1)
        pool = p.bank.HostSessionPool()

        def tweak(b):
            return b.with_disconnect_timeout(400).with_disconnect_notify_delay(100)

        pool.add_session(builder(pkg, clock, 1, 0, "R", tweak=tweak),
                         RecordingSocket(net.socket("L")))
        peer = builder(pkg, clock, 2, 1, "L", tweak=tweak).start_p2p_session(net.socket("R"))
        assert pool.native_active
        trace = []
        for i in range(120):
            clock[0] += 16
            if i < 40:
                peer.add_local_input(1, i % 16)
                fulfill_saves(peer.advance_frame())
            pool.add_local_input(0, 0, i % 16)
            reqs = pool.advance_all()
            for r in reqs:
                fulfill_saves(r)
            trace.append((summary(reqs[0]), [repr(e) for e in pool.events(0)],
                          pool.current_frame(0)))
            net.tick()
        runs[pkg] = trace
        kinds = " ".join(ev for _, evs, _ in trace for ev in evs)
        assert "NetworkInterrupted" in kinds and "Disconnected" in kinds
        assert trace[-1][2] > 80
    assert runs["jax"] == runs["port"]


def _scrub(stats):
    return [{k: v for k, v in rec.items()} for rec in stats]


@pytest.mark.parametrize("fastpath", ["descriptor", "reference"], indirect=True)
def test_scrape_and_network_stats_match_jax(fastpath):
    out = {}
    for pkg in ("jax", "port"):
        run = drive(pkg, 120, LOSSY, n_matches=2)
        pool = run.pool
        stats = pool.scrape()
        net_stats = []
        for idx in range(len(pool)):
            ns = pool.network_stats(idx, 1 - idx % 2)
            net_stats.append((ns.ping, ns.send_queue_len, ns.kbps_sent,
                              ns.local_frames_behind, ns.remote_frames_behind))
        local = PKGS[pkg].core.errors.BadPlayerHandle
        with pytest.raises(local):
            pool.network_stats(0, 0)
        out[pkg] = (_scrub(stats), net_stats)
    assert out["jax"] == out["port"]


# -- the packed tables --------------------------------------------------------


TABLES = ("BANK_HDR_FIELDS", "BANK_REQ_FIELDS", "BANK_STAGE_FIELDS", "NET_SEND_FIELDS")


@pytest.mark.parametrize("table", TABLES)
def test_packed_tables_match_jax(table):
    assert getattr(tnative, table) == getattr(jnative, table)


def test_packed_tables_match_the_library():
    lib = tnative.bank_lib()
    assert np.dtype(list(tnative.BANK_HDR_FIELDS)).itemsize == lib.ggrs_bank_hdr_stride()
    assert np.dtype(list(tnative.BANK_REQ_FIELDS)).itemsize == lib.ggrs_bank_req_stride()
    assert np.dtype(list(tnative.BANK_STAGE_FIELDS)).itemsize == lib.ggrs_bank_stage_stride()
    send = np.dtype(list(tnative.NET_SEND_FIELDS)).itemsize
    assert send == tnative.NET_SEND_STRIDE
    # net_batch.cpp has no stride probe for the send table: read its constant
    src = (tnative._build.HOST_DIR / "net_batch.cpp").read_text()
    assert f"constexpr size_t kSendStride = {send};" in src
    assert tnative.BANK_REQ_STRIDE == lib.ggrs_bank_req_stride()
    assert tnative.BANK_STAGE_STRIDE == lib.ggrs_bank_stage_stride()


@pytest.mark.parametrize("name", [
    "CMD_FLAG_INPUTS", "CMD_FLAG_SKIP", "CMD_FLAG_STAGED", "BANK_PHASES", "BANK_ERR_NAMES",
    "REQ_OTHER", "REQ_QUIET", "REQ_RESIM", "REQ_SAVE_ONLY", "REQ_FLAG_TRAILING_ADV",
    "BANK_HDR_LIVE", "BANK_HDR_SKIP", "BANK_HDR_DIRTY", "BANK_ERR_INJECTED", "NET_SEND_STATS",
])
def test_bank_constants_match_jax(name):
    assert getattr(tnative, name) == getattr(jnative, name)


def test_host_library_holds_all_five_sources():
    names = {p.name for p in tnative._build.HOST_SOURCES}
    assert names == {"codec.cpp", "endpoint.cpp", "sync_core.cpp", "session_bank.cpp",
                     "net_batch.cpp"}
    lib = tnative.bank_lib()
    for sym in ("ggrs_bank_tick", "ggrs_bank_stage_inputs", "ggrs_net_send_table",
                "ggrs_sync_seed", "ggrs_ep_seed_send"):
        assert hasattr(lib, sym)


def _plane_pool_run(pkg, with_plane):
    p = PKGS[pkg]
    if pkg == "jax":
        from ggrs_tpu.predict import BatchedRepeatLast, DevicePredictionPlane
    else:
        from ggrs_tpu_torch.predict import BatchedRepeatLast, DevicePredictionPlane
    cfg = p.Config.for_uint(8, predictor=BatchedRepeatLast())
    clock = [0]
    net = p.net.InMemoryNetwork(**LOSSY)
    bs = []
    for m in range(2):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            bs.append((builder(pkg, clock, 3 + 5 * m + me, me, names[1 - me], cfg=cfg),
                       RecordingSocket(net.socket(names[me]))))
    pool = p.bank.HostSessionPool()
    for b, s in bs:
        pool.add_session(b, s)
    assert not pool.native_active  # batched predictors are not bank-eligible
    plane = None
    if with_plane:
        extra = {} if pkg == "jax" else {"device": "cpu"}
        plane = DevicePredictionPlane(cfg, capacity=len(bs), **extra)
        pool.attach_prediction_plane(plane)
        assert pool.prediction_plane() is plane
    trace = []
    for i in range(60):
        clock[0] += 16
        for idx in range(len(bs)):
            pool.add_local_input(idx, idx % 2, sched(i, idx))
        reqs = pool.advance_all()
        for r in reqs:
            fulfill_saves(r)
        trace.append([summary(r) for r in reqs])
        net.tick()
    return (trace, [s.sent for _, s in bs]), plane


def test_prediction_plane_on_a_fallback_pool():
    """A pool of batched-predictor sessions runs the Python fallback, and
    ``attach_prediction_plane`` makes ``advance_all`` run the plane's
    ``begin_tick`` each tick: the same run as without the plane, and the
    JAX package's plane statistics."""
    off, _ = _plane_pool_run("port", False)
    on, plane = _plane_pool_run("port", True)
    jx, jplane = _plane_pool_run("jax", True)
    assert on == off == jx
    stats = plane.stats()
    assert stats == jplane.stats() and stats["ticks"] == 60 and stats["registered"] == 4
    native = drive("port", 2, None, n_matches=1).pool
    with pytest.raises(tcore.errors.InvalidRequest):
        native.attach_prediction_plane(plane)
