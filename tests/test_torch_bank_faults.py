"""Slot supervision of the port's HostSessionPool, against the JAX
package's, on the CPU.

Mirrors ``tests/test_bank_faults.py``: faults driven through the pool's real
tick path (simulated native slot errors on the control-op channel, junk
datagrams, an unfulfilled save, a fault before anything is committed) cost
at most the one slot they hit.  The survivors stay bitwise equal to a
fault-free run (wire bytes, request lists, events) with one crossing per
tick; the faulted slot is quarantined, harvested and evicted to a Python
``P2PSession`` that resumes the same match through the adoption seam, with
the JAX package's wire bytes and request lists, on either sync and endpoint
core.  Also: eviction bit-consistent with the peer, the fallback to the
previous committed frame, DEAD after bounded retries, eviction feeding the
batched executor, the Python fallback's own containment, an export bundle
adopted by a fresh session, ``demote_to_lockstep``, and the seams alone
(``InputQueue.seed``, ``SyncLayer.adopt_resume_state`` on both cores).
Tolerance: exact equality throughout."""

from __future__ import annotations

import pickle
from types import SimpleNamespace

import pytest

import ggrs_tpu.core.input_queue as jiq
import ggrs_tpu.core.sync_layer as jsl
import ggrs_tpu.net.messages as jmsg
import ggrs_tpu.core.frame_info as jfi
import ggrs_tpu_torch.core.input_queue as tiq
import ggrs_tpu_torch.core.sync_layer as tsl
import ggrs_tpu_torch.net.messages as tmsg
import ggrs_tpu_torch.core.frame_info as tfi
import ggrs_tpu_torch.net.protocol as tprotocol
from ggrs_tpu_torch.core.errors import InvalidRequest
from ggrs_tpu_torch.net.endpoint import PyEndpointCore
from ggrs_tpu_torch.parallel.host_bank import (
    EVICT_MAX_ATTEMPTS,
    SLOT_DEAD,
    SLOT_EVICTED,
    SLOT_NATIVE,
    SLOT_QUARANTINED,
    adopt_resume_bundle,
)

from test_torch_host_bank import PKGS, RecordingSocket, builder, summary
from test_torch_hosted_pool import assert_executors_equal, hosted, pool_sched

MALFORMED_BURST = [
    b"", b"\x01", b"\xaa\xbb\xff", b"\xaa\xbb\x00\x01", b"\xaa\xbb\x01\x02\x03\x04",
    b"\xaa\xbb\x02\x00", b"\xaa\xbb\x05\x00", bytes(64),
]


def fulfill(requests):
    """Saves hold the frame itself as state; loads must find theirs."""
    for r in requests:
        kind = type(r).__name__
        if kind == "SaveGameState":
            r.cell.save(r.frame, r.frame, None)
        elif kind == "LoadGameState":
            assert r.cell.data() is not None, f"load of unfulfilled cell {r.frame}"


@pytest.fixture
def evicted_core(request, monkeypatch):
    """The core an evicted slot's fresh Python session runs: the native sync
    and endpoint cores (the default), or the Python ones."""
    if request.param == "python":
        monkeypatch.setattr(tsl, "_native_sync_eligible", lambda config: False)
        monkeypatch.setattr(tprotocol, "make_endpoint_core", PyEndpointCore)
    return request.param


def chaos_drive(pkg, ticks, inject=None, n_matches=3, retire=False, ext_alive=None,
                after_finalize=None):
    """``n_matches`` in-bank matches, each on its own seeded network, plus a
    target slot whose peer is an external P2PSession, so that no fault stream
    couples the matches.  ``inject(i, ctx)`` runs at the top of tick i."""
    p = PKGS[pkg]
    clock = [0]
    nets, socks = [], []
    pool = p.bank.HostSessionPool(retire_dead_matches=retire)
    for m in range(n_matches):
        net = p.net.InMemoryNetwork(latency_ticks=1, seed=100 + m)
        nets.append(net)
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            s = RecordingSocket(net.socket(names[me]))
            socks.append(s)
            pool.add_session(builder(pkg, clock, 3 + 5 * m + me, me, names[1 - me]), s)
    net_t = p.net.InMemoryNetwork(latency_ticks=1, seed=99)
    nets.append(net_t)
    target = len(socks)
    socks.append(RecordingSocket(net_t.socket("T")))
    pool.add_session(builder(pkg, clock, 71, 0, "X"), socks[-1])
    ext = builder(pkg, clock, 72, 1, "T", other_handle=0).start_p2p_session(net_t.socket("X"))
    assert pool.native_active
    if after_finalize is not None:
        after_finalize()
    ctx = dict(pool=pool, target=target, ext=ext)
    n = len(socks)
    reqs_log = [[] for _ in range(n)]
    events = [[] for _ in range(n)]
    for i in range(ticks):
        clock[0] += 16
        if inject is not None:
            inject(i, ctx)
        if ext_alive is None or ext_alive(i):
            ext.add_local_input(1, (i * 5) % 16)
            fulfill(ext.advance_frame())
        for idx in range(n):
            pool.add_local_input(idx, idx % 2 if idx != target else 0, (i + idx) % 16)
        reqs = pool.advance_all()
        for idx in range(n):
            fulfill(reqs[idx])
            reqs_log[idx].append(summary(reqs[idx]))
            events[idx].extend(repr(e) for e in pool.events(idx))
        for net in nets:
            net.tick()
    return SimpleNamespace(pool=pool, ext=ext, target=target, reqs=reqs_log, events=events,
                           sent=[s.sent for s in socks],
                           states=[pool.slot_state(i) for i in range(n)])


def assert_survivors_identical(run, control, survivors):
    for i in survivors:
        assert run.sent[i] == control.sent[i], f"slot {i}: wire bytes diverged"
        assert run.reqs[i] == control.reqs[i], f"slot {i}: request lists diverged"
        assert run.events[i] == control.events[i], f"slot {i}: events diverged"


def _inject_at(tick, code=None):
    def inject(i, ctx):
        if i == tick:
            ctx["pool"].inject_slot_error(ctx["target"], code)
    return inject


@pytest.mark.parametrize("evicted_core", ["native", "python"], indirect=True)
@pytest.mark.parametrize("code", ["injected", "sync"])
def test_slot_fault_costs_one_slot_and_matches_jax(code, evicted_core):
    codes = {"injected": None, "sync": PKGS["port"].native.BANK_ERR_SYNC}
    control = chaos_drive("port", 200)
    run = chaos_drive("port", 200, _inject_at(60, codes[code]))
    jx = chaos_drive("jax", 200, _inject_at(60, codes[code]))
    t = run.target
    survivors = [i for i in range(len(run.states)) if i != t]
    assert run.states[t] == SLOT_EVICTED
    assert all(run.states[i] == SLOT_NATIVE for i in survivors)
    assert_survivors_identical(run, control, survivors)
    # one crossing per tick; the eviction cost one harvest crossing, once
    assert run.pool.crossings == 200 and run.pool.harvests == 1
    # the evicted slot resumed the SAME match, exactly as the JAX pool's
    assert run.pool.current_frame(t) > 160 and run.ext.current_frame > 160
    assert_survivors_identical(run, jx, range(len(run.states)))
    sess = run.pool.session(t)
    kinds = {type(sess._sync_layer._native).__name__ if sess._sync_layer._native else "queues"}
    kinds |= {type(ep._core).__name__ for ep in sess._player_reg.remotes.values()}
    want = ({"_NativeSyncCore", "NativeEndpointCore"} if evicted_core == "native"
            else {"queues", "PyEndpointCore"})
    assert kinds == want
    named = [f.code for f in run.pool.fault_log(t)]
    assert (codes[code] or PKGS["port"].native.BANK_ERR_INJECTED) in named
    if code == "sync":
        assert run.pool.desync_report(t) is not None


def test_malformed_datagram_burst_has_radius_zero():
    control = chaos_drive("port", 150)

    def inject(i, ctx):
        if 40 <= i < 50:
            for junk in MALFORMED_BURST:
                ctx["pool"].inject_datagram(ctx["target"], "X", junk)

    run = chaos_drive("port", 150, inject)
    assert all(s == SLOT_NATIVE for s in run.states)
    assert run.pool.fault_log(run.target) == []
    assert_survivors_identical(run, control, range(len(run.states)))


def test_peer_blackout_retires_only_the_target():
    control = chaos_drive("port", 220, retire=True)
    run = chaos_drive("port", 220, retire=True, ext_alive=lambda i: i < 60)
    t = run.target
    survivors = [i for i in range(len(run.states)) if i != t]
    assert run.states[t] == SLOT_DEAD
    assert all(run.states[i] == SLOT_NATIVE for i in survivors)
    assert_survivors_identical(run, control, survivors)
    assert "Disconnected" in " ".join(run.events[t])
    assert run.reqs[t][-1] == []


def _peer_pair(delay, faults):
    p = PKGS["port"]
    clock = [0]
    net = p.net.InMemoryNetwork(**(faults or {"latency_ticks": 1}))
    pool = p.bank.HostSessionPool()
    tweak = lambda b: b.with_input_delay(delay)  # noqa: E731
    pool.add_session(builder("port", clock, 1, 0, "R", tweak=tweak), net.socket("L"))
    peer = builder("port", clock, 2, 1, "L", tweak=tweak).start_p2p_session(net.socket("R"))
    assert pool.native_active

    def tick(i):
        clock[0] += 16
        peer.add_local_input(1, (i * 3) % 16)
        fulfill(peer.advance_frame())
        pool.add_local_input(0, 0, (i * 7) % 16)
        for reqs in pool.advance_all():
            fulfill(reqs)
        net.tick()

    return pool, peer, tick


@pytest.mark.parametrize("evicted_core", ["native", "python"], indirect=True)
@pytest.mark.parametrize("delay,faults", [
    (0, None), (2, None),
    (0, dict(seed=5, loss=0.1, duplicate=0.05, reorder=0.05, latency_ticks=1)),
], ids=["plain", "delay2", "lossy"])
def test_eviction_is_bit_consistent_with_the_peer(delay, faults, evicted_core):
    pool, peer, tick = _peer_pair(delay, faults)
    for i in range(50):
        tick(i)
    pool.inject_slot_error(0)
    for i in range(50, 260):
        tick(i)
    assert pool.slot_state(0) == SLOT_EVICTED
    sess = pool.session(0)
    horizon = peer._sync_layer.last_confirmed_frame
    for f in range(max(0, horizon - 60), horizon):
        assert (peer._sync_layer.confirmed_input(0, f).input
                == sess._sync_layer.confirmed_input(0, f).input), f
    assert pool.current_frame(0) > 240 and peer.current_frame > 240


def test_eviction_falls_back_to_the_previous_committed_frame():
    pool, peer, tick = _peer_pair(0, None)
    for i in range(60):
        tick(i)
    # the watermark's save unfulfilled (a fault tick suppressed it)
    w = pool._harvest(0)["last_confirmed"]
    assert w > 1
    pool._mirrors[0].saved_states.get_cell(w).save(w + 10 ** 6, None, None)
    pool.inject_slot_error(0)
    for i in range(60, 200):
        tick(i)
    assert pool.slot_state(0) == SLOT_EVICTED, pool.fault_log(0)
    assert any(f"resuming from frame {w - 1}" in f.detail for f in pool.fault_log(0))
    assert pool.current_frame(0) > 180 and peer.current_frame > 180


def _in_bank_match(ticks_before, inject=True):
    p = PKGS["port"]
    clock = [0]
    net = p.net.InMemoryNetwork(latency_ticks=1)
    pool = p.bank.HostSessionPool()
    for me, name, other in ((0, "L", "R"), (1, "R", "L")):
        pool.add_session(builder("port", clock, 10 + me, me, other), net.socket(name))
    assert pool.native_active

    def tick(i, include=(0, 1)):
        clock[0] += 16
        for idx in include:
            pool.add_local_input(idx, idx, (i + idx) % 16)
        for reqs in pool.advance_all():
            fulfill(reqs)
        net.tick()

    for i in range(ticks_before):
        tick(i)
    return pool, tick, clock


def test_unrecoverable_slot_goes_dead_after_bounded_retries():
    pool, tick, _ = _in_bank_match(0)
    pool.inject_slot_error(0)  # fires before anything is committed
    tick(0)
    assert pool.slot_state(0) == SLOT_QUARANTINED
    for i in range(1, 200):
        tick(i)
    assert pool.slot_state(0) == SLOT_DEAD
    attempts = [f for f in pool.fault_log(0) if "eviction attempt" in f.detail]
    assert len(attempts) == EVICT_MAX_ATTEMPTS
    assert pool.current_frame(1) > 60


def test_missing_input_for_an_evicted_slot_raises_before_the_crossing():
    pool, tick, clock = _in_bank_match(40)
    pool.inject_slot_error(0)
    for i in range(40, 60):
        tick(i)
    assert pool.slot_state(0) == SLOT_EVICTED
    crossings = pool.crossings
    clock[0] += 16
    pool.add_local_input(1, 1, 3)
    with pytest.raises(InvalidRequest):
        pool.advance_all()
    assert pool.crossings == crossings
    pool.add_local_input(0, 0, 3)
    for reqs in pool.advance_all():
        fulfill(reqs)
    assert pool.slot_state(1) == SLOT_NATIVE


def test_eviction_feeds_the_batched_executor_like_jax():
    """HostedPool end to end: the evicted slot's Load-leading request list
    parses through BatchedRequestExecutor's grammar, and every session's
    live state equals the JAX HostedPool's under the same fault."""
    runs = {}
    for pkg in ("jax", "port"):
        clock, net, host, ex, hp = hosted(pkg, n_matches=2, faults=dict(latency_ticks=1))
        lead = None
        for i in range(120):
            clock[0] += 16
            if i == 40:
                host.inject_slot_error(1)
            hp.tick([(idx, idx % 2, pool_sched(i, idx)) for idx in range(len(host))])
            if host.slot_state(1) == SLOT_EVICTED and lead is None:
                lead = summary(host._plan[1] if host._plan is not None else [])
            net.tick()
        hp.block_until_ready()
        assert host.slot_state(1) == SLOT_EVICTED
        assert all(host.current_frame(i) >= 96 for i in range(len(host)))
        runs[pkg] = (host, ex, lead)
    (hj, ej, lead_j), (ht, et, lead_t) = runs["jax"], runs["port"]
    assert lead_t == lead_j and lead_t[0][0] == "LoadGameState"
    assert_executors_equal(et, ej, ht, True)


def test_python_fallback_contains_slot_faults(monkeypatch):
    monkeypatch.setenv("GGRS_TPU_NO_NATIVE", "1")
    p = PKGS["port"]
    clock = [0]
    net = p.net.InMemoryNetwork(latency_ticks=1)
    pool = p.bank.HostSessionPool()

    class FaultySocket(RecordingSocket):
        explode = False

        def __getattribute__(self, name):
            if name.startswith("send") and object.__getattribute__(self, "explode"):
                raise OSError("wire cut")
            return object.__getattribute__(self, name)

    faulty = FaultySocket(net.socket("A0"))
    pool.add_session(builder("port", clock, 1, 0, "B0"), faulty)
    pool.add_session(builder("port", clock, 2, 1, "A0"), net.socket("B0"))
    for m in range(1, 3):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            pool.add_session(builder("port", clock, 3 + 2 * m + me, me, names[1 - me]),
                             net.socket(names[me]))
    assert not pool.native_active
    for i in range(110):
        clock[0] += 16
        faulty.explode = i >= 30
        for idx in range(len(pool)):
            pool.add_local_input(idx, idx % 2, (i + idx) % 16)
        for reqs in pool.advance_all():
            fulfill(reqs)
        net.tick()
    assert pool.slot_state(0) == SLOT_DEAD and pool.fault_log(0)
    for idx in range(2, len(pool)):
        assert pool.slot_state(idx) == SLOT_NATIVE
        assert pool.current_frame(idx) > 100


def test_export_bundle_adopted_by_a_fresh_session():
    """Export slot 0's resume bundle (equal to the JAX pool's), carry it
    through pickle, release the slot and resume its match in a fresh session
    on the same socket: the match goes on with its in-bank peer, both sides
    agreeing on every confirmed input."""
    bundles = {}
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        clock = [0]
        net = p.net.InMemoryNetwork(latency_ticks=1)
        socks = {n: net.socket(n) for n in ("L", "R")}
        pool = p.bank.HostSessionPool()
        for me, name, other in ((0, "L", "R"), (1, "R", "L")):
            pool.add_session(builder(pkg, clock, 10 + me, me, other), socks[name])
        assert pool.native_active
        for i in range(50):
            clock[0] += 16
            for idx in range(2):
                pool.add_local_input(idx, idx, (i + idx) % 16)
            for reqs in pool.advance_all():
                fulfill(reqs)
            net.tick()
        pool.add_local_input(0, 0, 5)  # staged, not yet consumed
        bundle = pickle.loads(pickle.dumps(pool.export_resume_state(0)))
        bundles[pkg] = bundle
    assert bundles["port"] == bundles["jax"]
    bundle = bundles["port"]
    pool.release_slot(0)
    assert pool.slot_state(0) == "migrated"
    sess, load = adopt_resume_bundle(builder("port", clock, 10, 0, "R"), socks["L"], bundle)
    assert load.frame == bundle["resume_frame"] and load.cell.data() == load.frame
    for i in range(50, 200):
        clock[0] += 16
        if i > 50:
            sess.add_local_input(0, i % 16)
        fulfill(sess.advance_frame())
        pool.add_local_input(1, 1, (i + 1) % 16)
        pool.add_local_input(0, 0, 0)  # released: accepted and dropped
        for reqs in pool.advance_all():
            fulfill(reqs)
        net.tick()
    assert sess.current_frame > 180 and pool.current_frame(1) > 180
    assert pool.advance_all is not None and pool.slot_state(0) == "migrated"


def test_demote_to_lockstep_matches_jax():
    runs = {}
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        clock = [0]
        net = p.net.InMemoryNetwork(latency_ticks=1)
        pool = p.bank.HostSessionPool()
        for me, name, other in ((0, "L", "R"), (1, "R", "L")):
            pool.add_session(builder(pkg, clock, 10 + me, me, other), net.socket(name))
        assert pool.native_active
        sink = []
        pool.timeline_sink = lambda etype, slot, detail: sink.append((etype, slot, detail))
        trace = []
        for i in range(120):
            clock[0] += 16
            if i == 40:
                frame = pool.demote_to_lockstep(0)
                assert pool.in_lockstep(0) and pool.lockstep_slots() == {0: 40}
            for idx in range(2):
                pool.add_local_input(idx, idx, (i + idx) % 16)
            reqs = pool.advance_all()
            for r in reqs:
                fulfill(r)
            trace.append([summary(r) for r in reqs])
            net.tick()
        assert pool.slot_state(0) == SLOT_EVICTED
        assert pool.session(0).in_lockstep_mode()
        assert sink == [("DEMOTE_LOCKSTEP", 0, {"frame": frame})]
        # the one-time adoption load, then never another save or load
        assert trace[40][0][0] == ("LoadGameState", frame)
        assert all(kind == "AdvanceFrame" for row in trace[41:] for kind, _ in row[0])
        runs[pkg] = trace
    assert runs["port"] == runs["jax"]


# -- the seams on their own ---------------------------------------------------


def test_input_queue_seed_matches_jax():
    from ggrs_tpu.core.config import Config as JConfig
    from ggrs_tpu_torch.core.config import Config as TConfig

    out = {}
    for name, iq, cfg, fi in (("jax", jiq, JConfig, jfi), ("port", tiq, TConfig, tfi)):
        q = iq.InputQueue(cfg.for_uint(16))
        q.seed(300, [(300 + k) % 16 for k in range(20)])
        got = [q.confirmed_input(f).input for f in range(300, 320)]
        # predictions past the seeded tail, then a wrong real input
        preds = [q.input(f) for f in range(320, 324)]
        q.add_input(fi.PlayerInput(320, 9))
        q.add_input(fi.PlayerInput(321, 1))
        got += [q.first_incorrect_frame, q.mispredicts, q.mispredict_depth_frames,
                q.last_added_frame, q.length]
        out[name] = (got, [(v, s.name) for v, s in preds])
    assert out["port"] == out["jax"]
    assert out["port"][0][-4] == 1  # one mispredict episode counted


@pytest.mark.parametrize("use_native", [True, False], ids=["native_core", "python_queues"])
def test_sync_layer_adopt_resume_state_matches_jax(use_native):
    from ggrs_tpu.core.config import Config as JConfig
    from ggrs_tpu_torch.core.config import Config as TConfig

    out = {}
    for name, sl, cfg, msg, fi in (("jax", jsl, JConfig, jmsg, jfi),
                                   ("port", tsl, TConfig, tmsg, tfi)):
        config = cfg.for_uint(16)
        layer = sl.SyncLayer(config, 2, 8, use_native=use_native)
        saved = sl.SavedStates(8)
        saved.get_cell(100).save(100, "state@100", None)
        enc = config.input_encode
        layer.adopt_resume_state(100, 100, saved, [
            (100, [enc(v) for v in (1, 2, 3)]),
            (100, [enc(v) for v in (7, 8)]),
        ])
        assert (layer._native is not None) == use_native
        status = [msg.ConnectionStatus(), msg.ConnectionStatus()]
        for s, last in zip(status, (102, 101)):
            s.last_frame = last
        seen = [layer.current_frame, layer.last_confirmed_frame, layer.last_saved_frame]
        seen += [layer.confirmed_input(p, f).input for p, f in ((0, 101), (1, 101))]
        seen.append(tuple((v, s.name) for v, s in layer.synchronized_inputs(status)))
        layer.add_remote_input(1, fi.PlayerInput(102, 4))
        layer.advance_frame()
        seen.append(tuple((v, s.name) for v, s in layer.synchronized_inputs(status)))
        seen.append(layer.check_simulation_consistency(-1))
        out[name] = seen
    assert out["port"] == out["jax"]
