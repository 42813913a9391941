"""The port's P2P rollback path against the JAX package's, on the CPU.

- Parity: a seeded pair of port P2P sessions, each fulfilled by a port
  ``DeviceRequestExecutor`` (``device="cpu"``), runs beside the same pair of
  JAX sessions and executors.  Every frame's request list, every saved u128
  checksum, every event, every datagram and the final live states must be
  equal.
- The cross-package desync gate: a JAX peer plays a port peer, each with its
  own package's executor, over a byte bridge (each side encodes and decodes
  with its own ``Message``) and over loopback UDP.  With desync detection at
  interval 1 neither side may see ``DesyncDetected``, the checksums both
  sides computed for the same frames must be equal, and the final live
  states bitwise equal.  Corrupting either side's live state must be
  detected by the other.
- A port spectator of a port host receives what a JAX spectator of a JAX
  host receives.

The parity cases and the gate run the port peers on both of its cores: the
native ones (the default for ``boxgame_config()``, as in the JAX package)
and the Python ones (``SyncLayer`` input queues and ``PyEndpointCore``).
The JAX peers run the JAX package's default, its native cores.

Tolerance: exact equality (integer game math, integer digest)."""

import dataclasses
import random
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggrs_tpu.core as jcore
import ggrs_tpu.games as jgames
import ggrs_tpu.net as jnet
import ggrs_tpu.net.messages as jmsg
import ggrs_tpu.obs as jobs
import ggrs_tpu.ops as jops
import ggrs_tpu.sessions as jsessions
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM

import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.core.sync_layer as tsync
import ggrs_tpu_torch.net.protocol as tproto
import ggrs_tpu_torch.games as tgames
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.net.messages as tmsg
import ggrs_tpu_torch.obs as tobs
import ggrs_tpu_torch.ops as tops
import ggrs_tpu_torch.sessions as tsessions
from ggrs_tpu_torch import to_numpy
from ggrs_tpu_torch.net.endpoint import NativeEndpointCore, PyEndpointCore
from ggrs_tpu_torch.ops import digest as tdg
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

from chip_smoke import predicted_digest_launches
from test_torch_checksum import _emulated_launch, _FakeCuda

PKGS = {
    "jax": SimpleNamespace(core=jcore, games=jgames, net=jnet, msg=jmsg, obs=jobs, ops=jops,
                           sessions=jsessions, chipvm=JaxChipVM),
    "port": SimpleNamespace(core=tcore, games=tgames, net=tnet, msg=tmsg, obs=tobs, ops=tops,
                            sessions=tsessions, chipvm=tgames.ChipVM),
}
TICK_MS = 16
DRAIN = 20


def _sched(handle, i):
    """Inputs that change every few frames, so rollbacks come regularly."""
    return (i // 4) % 16 if handle == 0 else (i // 3) % 16


def _inputs_np(pairs):
    return np.asarray([p[0] for p in pairs], np.uint8)


def _executor(pkg, game):
    if pkg == "jax":
        return jops.DeviceRequestExecutor(game.advance, game.init_state(),
                                          lambda pairs: jnp.asarray(_inputs_np(pairs)))
    return tops.DeviceRequestExecutor(game.advance, game.init_state_np(), _inputs_np,
                                      device="cpu")


def _state_np(pkg, ex):
    return to_numpy(ex.state) if pkg == "port" else jax.device_get(ex.state)


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _builder(pkg, handle, other, clock, *, interval=1, sparse=False, max_prediction=8,
             input_delay=0):
    m = PKGS[pkg]
    b = (m.sessions.SessionBuilder(m.games.boxgame_config())
         .with_clock(clock)
         .with_rng(random.Random(41 + handle))
         .with_max_prediction_window(max_prediction)
         .with_sparse_saving_mode(sparse)
         .with_input_delay(input_delay))
    if interval:
        b = b.with_desync_detection_mode(m.core.DesyncDetection.on(interval))
    return b.add_player(m.core.Local(), handle).add_player(m.core.Remote(other), 1 - handle)


def _request_plain(r):
    kind = type(r).__name__
    if kind == "AdvanceFrame":
        return (kind, tuple((int(v), s.name) for v, s in r.inputs))
    return (kind, r.frame)


def _event_plain(e):
    return (type(e).__name__,) + dataclasses.astuple(e)


class Peer:
    """One session, its executor and everything it did."""

    def __init__(self, pkg, session, executor, handle):
        self.pkg, self.session, self.ex, self.handle = pkg, session, executor, handle
        self.requests, self.saved, self.events = [], [], []

    def frame(self, i, on_requests=None):
        s = self.session
        s.poll_remote_clients()
        s.add_local_input(self.handle, _sched(self.handle, i))
        reqs = s.advance_frame()
        self.requests.append([_request_plain(r) for r in reqs])
        self.ex.run(reqs)
        if on_requests is not None:
            on_requests(self, reqs)
        self.saved.append([(r.frame, r.cell.checksum) for r in reqs
                           if type(r).__name__ == "SaveGameState"])
        self.events.extend(_event_plain(e) for e in s.events())

    def desyncs(self):
        return [e for e in self.events if e[0] == "DesyncDetected"]


def _play(peers, ticks, tick_fn, on_requests=None):
    """``ticks`` frames of the schedule, then ``DRAIN`` frames holding each
    player's last input, so every prediction is right at the end."""
    for i in range(ticks + DRAIN):
        for p in peers:
            p.frame(min(i, ticks - 1), on_requests)
        tick_fn()


def _pair(pkg, *, seed=5, loss=0.0, duplicate=0.0, reorder=0.0, latency=0, blackout=(0, 0),
          game=None, **kw):
    """Two peers of one package over its seeded ``InMemoryNetwork``, which
    drops every datagram during the ``blackout`` ticks."""
    m = PKGS[pkg]
    net = m.net.InMemoryNetwork(seed=seed, loss=loss, duplicate=duplicate, reorder=reorder,
                                latency_ticks=latency)
    wire = []
    send = net._send

    def recording_send(frm, to, payload):
        wire.append((frm, to, bytes(payload)))
        send(frm, to, payload)

    net._send = recording_send
    now = [0]
    game = game or m.games.BoxGame(2)
    peers = []
    for me, other, h in (("A", "B", 0), ("B", "A", 1)):
        sess = _builder(pkg, h, other, lambda: now[0], **kw).start_p2p_session(net.socket(me))
        peers.append(Peer(pkg, sess, _executor(pkg, game), h))

    def tick():
        net.tick()
        now[0] += TICK_MS
        net.loss = 1.0 if blackout[0] <= net._tick < blackout[1] else loss

    return peers, tick, wire


PARITY_CASES = {
    "interval_1": dict(interval=1),
    "interval_10": dict(interval=10),
    "sparse_saving": dict(interval=0, sparse=True),
    "lockstep": dict(interval=1, max_prediction=0),
    "input_delay_2": dict(interval=1, input_delay=2),
    "loss_and_latency": dict(interval=5, loss=0.05, duplicate=0.02, reorder=0.05, latency=3),
    "blackout": dict(interval=1, latency=1, blackout=(60, 100)),
}


@pytest.fixture(params=["native", "python"])
def port_core(request, monkeypatch):
    """Which cores the port's sessions run: the native default, or the
    Python input queues and endpoint core (the JAX tests' own switch, the
    endpoint factory, plus the sync layer's eligibility gate)."""
    if request.param == "python":
        monkeypatch.setattr(tsync, "_native_sync_eligible", lambda config: False)
        monkeypatch.setattr(tproto, "make_endpoint_core", PyEndpointCore)
    return request.param


def _assert_cores(session, kind):
    """Every core of a port ``P2PSession`` is the requested kind."""
    native = kind == "native"
    layer = session._sync_layer
    assert isinstance(layer._native, tsync._NativeSyncCore) if native else layer._native is None
    assert bool(layer.input_queues) is not native
    eps = list(session._player_reg.remotes.values()) + list(session._player_reg.spectators.values())
    assert eps and all(
        isinstance(ep._core, NativeEndpointCore if native else PyEndpointCore) for ep in eps
    )


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
def test_p2p_pair_matches_jax(case, port_core):
    kw = PARITY_CASES[case]
    runs = {}
    for pkg in ("jax", "port"):
        peers, tick, wire = _pair(pkg, **kw)
        _play(peers, 160, tick)
        runs[pkg] = peers, wire
    (jpeers, jwire), (tpeers, twire) = runs["jax"], runs["port"]
    for p in tpeers:
        _assert_cores(p.session, port_core)
    assert twire == jwire
    for jp, tp in zip(jpeers, tpeers):
        assert tp.requests == jp.requests
        assert tp.saved == jp.saved
        assert tp.events == jp.events
        assert tp.desyncs() == []
        assert tp.session.current_frame == jp.session.current_frame
        _assert_states_equal(_state_np("port", tp.ex), _state_np("jax", jp.ex))
    # the two port peers agree with each other at the end, and the schedule
    # made real rollbacks wherever the session may predict
    a, b = tpeers
    assert a.session.current_frame == b.session.current_frame
    _assert_states_equal(_state_np("port", a.ex), _state_np("port", b.ex))
    loads = sum(1 for p in tpeers for f in p.requests for r in f if r[0] == "LoadGameState")
    if kw.get("max_prediction", 8) and not kw.get("input_delay"):
        assert loads > 10
    if kw.get("interval") and kw.get("max_prediction", 8):
        assert all(p.session._last_sent_checksum_frame > 100 for p in tpeers)
    if case == "blackout":
        names = {e[0] for p in tpeers for e in p.events}
        assert {"NetworkInterrupted", "NetworkResumed"} <= names


def test_boxgame_p2p_matches_numpy_oracle():
    peers, tick, _ = _pair("port", interval=1, latency=2)
    _play(peers, 120, tick)
    game = tgames.BoxGame(2)
    ref = game.init_state_np()
    for i in range(peers[0].session.current_frame):
        j = min(i, 119)
        ref = game.advance_np(ref, np.asarray([_sched(0, j), _sched(1, j)], np.uint8))
    for p in peers:
        _assert_states_equal(_state_np("port", p.ex), ref)


def test_chipvm_p2p_matches_jax():
    runs = {}
    for pkg in ("jax", "port"):
        peers, tick, wire = _pair(pkg, interval=1, latency=2, game=PKGS[pkg].chipvm(2))
        _play(peers, 40, tick)
        runs[pkg] = peers, wire
    assert runs["port"][1] == runs["jax"][1]
    for jp, tp in zip(runs["jax"][0], runs["port"][0]):
        assert tp.requests == jp.requests and tp.saved == jp.saved and tp.desyncs() == []
        _assert_states_equal(_state_np("port", tp.ex), _state_np("jax", jp.ex))


# -- the executor on P2P lists ------------------------------------------------------


@pytest.fixture
def card_digest(monkeypatch):
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    return calls


@pytest.mark.parametrize("case", ["interval_1", "sparse_saving", "lockstep", "loss_and_latency"])
def test_digest_launches_follow_the_request_lists(card_digest, case):
    """On the card's wrapper path (emulated on the CPU) the digest launches
    once per saving burst and once per lone Save, the saved checksums still
    equal the CPU path's, and no saved state is ever written in place."""
    kept, predicted = [], [0]

    def on_requests(peer, reqs):
        predicted[0] += predicted_digest_launches(reqs)
        for r in reqs:
            if type(r).__name__ == "SaveGameState":
                kept.append((r.cell.data(), tree_map(torch.clone, r.cell.data())))

    peers, tick, _ = _pair("port", **PARITY_CASES[case])
    before = tdg.state_digest.launches
    _play(peers, 80, tick, on_requests)
    assert tdg.state_digest.launches - before == len(card_digest) == predicted[0]
    if case != "lockstep":
        assert predicted[0] > 0
    if case == "loss_and_latency":
        assert max(card_digest) > 1  # deep rollbacks digest several rows at once
    for live, copy in kept:
        for x, y in zip(tree_leaves(live), tree_leaves(copy)):
            assert torch.equal(x, y)
    jax_peers, jax_tick, _ = _pair("jax", **PARITY_CASES[case])
    _play(jax_peers, 80, jax_tick)
    for p, q in zip(peers, jax_peers):
        assert p.saved == q.saved


def test_predicted_launches_of_known_lists():
    A, S, L = (tcore.AdvanceFrame(inputs=[]), tcore.SaveGameState(None, 0),
               tcore.LoadGameState(None, 0))
    assert predicted_digest_launches([S, A]) == 1
    assert predicted_digest_launches([A]) == 0
    assert predicted_digest_launches([L, A, S, A, S, A]) == 1
    assert predicted_digest_launches([L, A, A, A, S, A]) == 1
    assert predicted_digest_launches([L, A, A]) == 0
    assert predicted_digest_launches([S, L, A, S, A, S, A]) == 2
    assert predicted_digest_launches([L, A, S]) == 1


# -- the cross-package desync gate ----------------------------------------------------


class _Bridge:
    """Carries bytes only, with a fixed latency in ticks: each socket encodes
    with its own package's ``Message.encode`` and decodes with its own
    ``Message.decode``."""

    def __init__(self, latency):
        self.latency, self.now, self.queues = latency, 0, {}

    def socket(self, addr, msg_mod):
        self.queues.setdefault(addr, [])
        return _BridgeSocket(self, addr, msg_mod)

    def tick(self):
        self.now += 1


class _BridgeSocket:
    def __init__(self, bridge, addr, msg_mod):
        self.bridge, self.addr, self.msg = bridge, addr, msg_mod

    def send_to(self, msg, addr):
        self.bridge.queues[addr].append((self.bridge.now + self.bridge.latency, self.addr,
                                         msg.encode()))

    def receive_all_messages(self):
        q = self.bridge.queues[self.addr]
        due = [x for x in q if x[0] <= self.bridge.now]
        q[:] = [x for x in q if x[0] > self.bridge.now]
        return [(src, self.msg.Message.decode(data)) for _, src, data in due]


def _mixed_pair(transport, pkgs=("jax", "port"), interval=1):
    """Peer A of package ``pkgs[0]`` against peer B of ``pkgs[1]``."""
    now = [0]
    if transport == "bridge":
        bridge = _Bridge(latency=2)
        addrs = ("A", "B")
        sockets = [bridge.socket(a, PKGS[pkg].msg) for a, pkg in zip(addrs, pkgs)]

        def tick():
            bridge.tick()
            now[0] += TICK_MS
    else:
        sockets = [PKGS[pkg].net.UdpNonBlockingSocket.bind_to_port(0) for pkg in pkgs]
        addrs = tuple(("127.0.0.1", s.local_port()) for s in sockets)

        def tick():
            now[0] += TICK_MS
    peers = []
    for h, pkg in enumerate(pkgs):
        m = PKGS[pkg]
        sess = _builder(pkg, h, addrs[1 - h], lambda: now[0], interval=interval)
        sess = sess.start_p2p_session(sockets[h])
        sess.attach_forensics(recorder=m.obs.FlightRecorder())
        peers.append(Peer(pkg, sess, _executor(pkg, m.games.BoxGame(2)), h))
    return peers, tick, sockets


def _close(sockets):
    for s in sockets:
        if hasattr(s, "close"):
            s.close()


def _udp_settle(peers, sockets):
    """Bounded draining: poll both sides until no datagram is in flight."""
    for _ in range(50):
        time.sleep(0.002)
        for p in peers:
            p.session.poll_remote_clients()
            p.events.extend(_event_plain(e) for e in p.session.events())


@pytest.mark.parametrize("transport", ["bridge", "udp"])
def test_jax_peer_and_port_peer_never_desync(transport, port_core):
    peers, tick, sockets = _mixed_pair(transport)
    _assert_cores(peers[1].session, port_core)
    assert peers[0].session._sync_layer._native is not None
    try:
        for i in range(300 + DRAIN):
            for p in peers:
                p.frame(min(i, 299))
            tick()
            if transport == "udp" and i % 50 == 0:
                _udp_settle(peers, sockets)
    finally:
        _close(sockets)
    jax_peer, port_peer = peers
    assert jax_peer.desyncs() == [] and port_peer.desyncs() == []
    # both sides computed, sent and compared a checksum for every frame
    for p in peers:
        assert p.session._last_sent_checksum_frame > 250
    local = [dict(p.session.recorder.checksums.items()) for p in peers]
    common = sorted(set(local[0]) & set(local[1]))
    assert len(common) > 200
    assert all(local[0][f] == local[1][f] for f in common)
    remote = [dict(h.items()) for p in peers for h in p.session.recorder.remote_checksums.values()]
    assert len(remote) == 2 and len(remote[0]) > 200 and len(remote[1]) > 200
    loads = sum(1 for p in peers for f in p.requests for r in f if r[0] == "LoadGameState")
    assert loads > 20
    assert jax_peer.session.current_frame == port_peer.session.current_frame
    _assert_states_equal(_state_np("jax", jax_peer.ex), _state_np("port", port_peer.ex))


@pytest.mark.parametrize("corrupted", ["port", "jax"])
def test_corruption_is_detected_across_packages(corrupted):
    """Corrupt one peer's live state from frame 30 on: the OTHER package's
    peer must raise DesyncDetected with unequal checksums.  The corruption
    is repeated for ten frames, past the depth of any rollback, since a
    rollback loads a clean saved state over the live one."""
    peers, tick, _ = _mixed_pair("bridge", interval=1)
    victim = peers[0] if corrupted == "jax" else peers[1]
    witness = peers[1] if corrupted == "jax" else peers[0]
    one = jnp.int32(1) if corrupted == "jax" else 1
    for i in range(60):
        for p in peers:
            p.frame(i)
        if 30 <= i < 40:
            state = victim.ex.state
            victim.ex._state = {**state, "pos": state["pos"] + one}
        tick()
    found = witness.desyncs()
    assert found, f"the {witness.pkg} peer missed the corruption of the {corrupted} peer"
    assert all(e[2] != e[3] for e in found)  # (name, frame, local, remote, addr)
    assert witness.session.desync_reports


# -- spectators -----------------------------------------------------------------------


def _spectated(pkg):
    """A host (A) with a spectator (S) playing B; returns what S received."""
    m = PKGS[pkg]
    net = m.net.InMemoryNetwork(seed=9, loss=0.05, latency_ticks=1)
    now = [0]
    clock = lambda: now[0]
    hosts = []
    for me, other, h in (("A", "B", 0), ("B", "A", 1)):
        b = _builder(pkg, h, other, clock, interval=0)
        if me == "A":
            b = b.add_player(m.core.Spectator("S"), 2)
        hosts.append(Peer(pkg, b.start_p2p_session(net.socket(me)),
                          _executor(pkg, m.games.BoxGame(2)), h))
    spec = (m.sessions.SessionBuilder(m.games.boxgame_config()).with_clock(clock)
            .with_rng(random.Random(7)).start_spectator_session("A", net.socket("S")))
    seen = []
    for i in range(150):
        for p in hosts:
            p.frame(i)
        try:
            for r in spec.advance_frame():
                seen.append(tuple((int(v), s.name) for v, s in r.inputs))
        except m.core.PredictionThreshold:
            seen.append("wait")
        net.tick()
        now[0] += TICK_MS
    return seen, spec.current_frame


def test_port_spectator_sees_what_a_jax_spectator_sees():
    port_seen, port_frame = _spectated("port")
    jax_seen, jax_frame = _spectated("jax")
    assert port_seen == jax_seen and port_frame == jax_frame
    advances = [s for s in port_seen if s != "wait"]
    assert len(advances) > 100
    assert advances[20] == ((_sched(0, 20), "CONFIRMED"), (_sched(1, 20), "CONFIRMED"))


# -- session surface --------------------------------------------------------------------


def test_builder_validation_matches_jax():
    for pkg in ("jax", "port"):
        m = PKGS[pkg]
        cfg = m.games.boxgame_config()
        B = m.sessions.SessionBuilder
        with pytest.raises(m.core.InvalidRequest):
            B(cfg).add_player(m.core.Local(), 5)
        with pytest.raises(m.core.InvalidRequest):
            B(cfg).add_player(m.core.Spectator("S"), 0)
        with pytest.raises(m.core.InvalidRequest):
            B(cfg).add_player(m.core.Local(), 0).add_player(m.core.Local(), 0)
        with pytest.raises(m.core.InvalidRequest):
            B(cfg).add_player(m.core.Local(), 0).start_p2p_session(
                m.net.InMemoryNetwork().socket("me"))
        with pytest.raises(m.core.InvalidRequest):
            B(cfg).with_num_players(65).start_spectator_session(
                "H", m.net.InMemoryNetwork().socket("me"))


def test_disconnect_and_stats_match_jax():
    out = {}
    for pkg in ("jax", "port"):
        m = PKGS[pkg]
        peers, tick, _ = _pair(pkg, interval=0)
        _play(peers, 80, tick)
        a = peers[0].session
        stats = dataclasses.astuple(a.network_stats(1))
        with pytest.raises(m.core.InvalidRequest):
            a.disconnect_player(0)
        a.disconnect_player(1)
        with pytest.raises(m.core.InvalidRequest):
            a.disconnect_player(1)
        reqs = []
        for i in range(5):
            a.poll_remote_clients()
            a.add_local_input(0, 3)
            reqs.append([_request_plain(r) for r in a.advance_frame()])
        out[pkg] = (stats, reqs, [_event_plain(e) for e in a.events()], a.confirmed_frame(),
                    a.num_players, a.num_spectators, a.frames_ahead())
    assert out["port"] == out["jax"]
    assert any(s == "DISCONNECTED" for f in out["port"][1] for r in f if r[0] == "AdvanceFrame"
               for _, s in r[1])


def test_tracer_spans_and_rollback_counters():
    """The session times its ticks and polls on an attached tracer, and
    counts its rollbacks into the port's own process-wide registry (a
    before/after difference: the JAX package's registry is separate)."""
    reg = tobs.default_registry()
    assert reg is not jobs.default_registry()
    before = reg.value("ggrs_session_rollbacks_total") or 0.0
    depth_before = reg.value("ggrs_session_rollback_depth_frames") or 0.0
    peers, tick, _ = _pair("port", interval=1, latency=2)
    tracer = tobs.Tracer()
    peers[0].session.attach_forensics(tracer=tracer)
    _play(peers, 60, tick)
    rollbacks = sum(p.session._stat_rollbacks for p in peers)
    assert rollbacks > 0
    assert reg.value("ggrs_session_rollbacks_total") - before == rollbacks
    assert reg.value("ggrs_session_rollback_depth_frames") - depth_before == rollbacks
    summary = tracer.summary()
    frames = 60 + DRAIN
    assert summary["session.tick"]["count"] == frames
    assert summary["session.poll"]["count"] == 2 * frames  # explicit, and inside the tick
    trace = tracer.chrome_trace()
    assert {e["name"] for e in trace["traceEvents"]} == {"session.tick", "session.poll"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in trace["traceEvents"])


def test_desync_report_matches_jax():
    """Both packages build the same forensic report for the same desync."""
    reports = {}
    for pkg in ("jax", "port"):
        peers, tick, _ = _pair(pkg, interval=1, latency=1)
        peers[0].session.attach_forensics(recorder=PKGS[pkg].obs.FlightRecorder())
        for i in range(50):
            for p in peers:
                p.frame(i)
            if 20 <= i < 30:
                st = peers[1].ex.state
                one = jnp.int32(1) if pkg == "jax" else 1
                peers[1].ex._state = {**st, "vel": st["vel"] + one}
            tick()
        reports[pkg] = peers[0].session.desync_reports[0].to_dict()
    assert reports["port"] == reports["jax"]
    assert reports["port"]["first_divergent_frame"] >= 20
