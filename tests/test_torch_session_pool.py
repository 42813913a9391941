"""The port's BatchedRequestExecutor against the JAX package's, on the CPU.

Mirrors ``tests/test_session_pool.py`` (all but the mesh-sharded case, whose
``mesh=`` is not ported): a pool of B sessions fulfilled by ONE
``BatchedRequestExecutor`` must be bit-identical to the same B sessions each
fulfilled by its own ``DeviceRequestExecutor``.  Then the cross-package
drive: the same seeded matches through the JAX pool and the port's pool, per
session on live states and on every ring checksum the sessions saved; and
``P2PSession.enable_request_pooling``, value-identical to the unpooled path.
Tolerance: exact equality (integer game math, integer digest)."""

import contextlib
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import ggrs_tpu.core as jcore
import ggrs_tpu.games as jgames
import ggrs_tpu.net as jnet
import ggrs_tpu.ops as jops
import ggrs_tpu.parallel as jpar
import ggrs_tpu.sessions as jsessions

import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.games as tgames
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.ops as tops
import ggrs_tpu_torch.parallel as tpar
import ggrs_tpu_torch.sessions as tsessions
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.ops import digest as tdg

from chip_smoke import pool_predicted
from test_torch_checksum import _emulated_launch, _FakeCuda

PKGS = {
    "jax": SimpleNamespace(core=jcore, games=jgames, net=jnet, ops=jops, par=jpar,
                           sessions=jsessions),
    "port": SimpleNamespace(core=tcore, games=tgames, net=tnet, ops=tops, par=tpar,
                            sessions=tsessions),
}


def _to_arr(pairs):
    return np.asarray([p[0] for p in pairs], np.uint8)


def _np_state(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else jax.device_get(v))
            for k, v in tree.items()}


def _pool(pkg, game, batch_size, ring_length=10, max_burst=9, **kw):
    p = PKGS[pkg]
    extra = {} if pkg == "jax" else {"device": "cpu"}
    init = game.init_state() if pkg == "jax" else game.init_state_np()
    pool = p.par.BatchedRequestExecutor(game.advance, init, _to_arr, batch_size=batch_size,
                                        ring_length=ring_length, max_burst=max_burst, **kw,
                                        **extra)
    pool.warmup(np.zeros((2,), np.uint8))
    return pool


def _make_matches(pkg, n_matches, seed, sparse=False, desync_interval=0, pooling=False):
    """n_matches 2-peer BoxGame matches over one in-memory net: session 2m
    is match m's peer A.  Returns (sessions, schedules)."""
    p = PKGS[pkg]
    net = p.net.InMemoryNetwork()
    sessions, schedules = [], []
    for m in range(n_matches):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            b = (p.sessions.SessionBuilder(p.games.boxgame_config()).with_clock(lambda: 0)
                 .with_rng(random.Random(seed + 7 * m + me)).with_sparse_saving_mode(sparse))
            if desync_interval:
                b = b.with_desync_detection_mode(p.core.DesyncDetection(True, desync_interval))
            b = b.add_player(p.core.Local(), me).add_player(p.core.Remote(names[1 - me]), 1 - me)
            s = b.start_p2p_session(net.socket(names[me]))
            if pooling:
                s.enable_request_pooling()
            sessions.append(s)
            schedules.append(lambda i, m=m, me=me: ((i + 2 * m + me) // (2 + m % 3)) % 16)
    return sessions, schedules


def _drive(sessions, schedules, fulfill, ticks, drain=14, on_tick=None):
    for i in range(ticks + drain):
        for s in sessions:
            s.poll_remote_clients()
        all_reqs = []
        for h, (s, sched) in enumerate(zip(sessions, schedules)):
            s.add_local_input(h % 2, sched(min(i, ticks - 1)))
            all_reqs.append(s.advance_frame())
        fulfill(all_reqs)
        if on_tick is not None:
            on_tick(i, all_reqs)


def _run_pool(pkg, n_matches, ticks, seed, sparse=False, desync_interval=0, on_tick=None,
              pool_kw=None):
    sessions, schedules = _make_matches(pkg, n_matches, seed, sparse=sparse,
                                        desync_interval=desync_interval)
    game = PKGS[pkg].games.BoxGame(2)
    pool = _pool(pkg, game, len(sessions), **(pool_kw or {}))
    _drive(sessions, schedules, pool.run, ticks,
           on_tick=None if on_tick is None else (lambda i, reqs: on_tick(i, reqs, pool)))
    states = [_np_state(pool.live_state(b)) for b in range(len(sessions))]
    frames = [s.current_frame for s in sessions]
    events = [list(s.events()) for s in sessions]
    return states, frames, events, pool


def _run_individual(pkg, n_matches, ticks, seed, sparse=False, desync_interval=0):
    sessions, schedules = _make_matches(pkg, n_matches, seed, sparse=sparse,
                                        desync_interval=desync_interval)
    p = PKGS[pkg]
    game = p.games.BoxGame(2)
    programs = p.ops.ExecutorPrograms(game.advance)
    if pkg == "jax":
        executors = [p.ops.DeviceRequestExecutor(game.advance, game.init_state(), _to_arr,
                                                 programs=programs) for _ in sessions]
    else:
        executors = [p.ops.DeviceRequestExecutor(game.advance, game.init_state_np(), _to_arr,
                                                 programs=programs, device="cpu")
                     for _ in sessions]

    def fulfill(all_reqs):
        for ex, reqs in zip(executors, all_reqs):
            ex.run(reqs)

    _drive(sessions, schedules, fulfill, ticks)
    states = [_np_state(ex.state) for ex in executors]
    return states, [s.current_frame for s in sessions], [list(s.events()) for s in sessions]


def _assert_states_equal(got, want, label):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{label}: session {b} key {k}")


# -- tests/test_session_pool.py, run in the port ------------------------------


def test_pool_matches_individual_executors():
    pool_states, pool_frames, _, _ = _run_pool("port", 4, 40, seed=11)
    ind_states, ind_frames, _ = _run_individual("port", 4, 40, seed=11)
    assert pool_frames == ind_frames
    _assert_states_equal(pool_states, ind_states, "pool-vs-individual")


def test_peers_converge_within_each_match():
    states, frames, _, _ = _run_pool("port", 3, 36, seed=23)
    for m in range(3):
        assert frames[2 * m] == frames[2 * m + 1]
        _assert_states_equal([states[2 * m]], [states[2 * m + 1]], f"match {m}")


def test_sparse_saving_through_the_pool():
    pool_states, pool_frames, _, _ = _run_pool("port", 2, 36, seed=31, sparse=True)
    ind_states, ind_frames, _ = _run_individual("port", 2, 36, seed=31, sparse=True)
    assert pool_frames == ind_frames
    _assert_states_equal(pool_states, ind_states, "sparse")


def test_desync_detection_rides_lazy_ring_checksums():
    _, _, events, _ = _run_pool("port", 2, 40, seed=43, desync_interval=8)
    for evs in events:
        assert not any(type(e).__name__ == "DesyncDetected" for e in evs), evs
    # the checksums the sessions sent equal the individual executors' path
    pooled = _make_matches("port", 2, 43, desync_interval=8)
    single = _make_matches("port", 2, 43, desync_interval=8)
    game = tgames.BoxGame(2)
    pool = _pool("port", game, 4)
    exs = [tops.DeviceRequestExecutor(game.advance, game.init_state_np(), _to_arr, device="cpu")
           for _ in range(4)]
    _drive(*pooled, pool.run, 40)
    _drive(*single, lambda reqs: [ex.run(r) for ex, r in zip(exs, reqs)], 40)
    for a, b in zip(pooled[0], single[0]):
        assert a._local_checksum_history == b._local_checksum_history
        assert len(a._local_checksum_history) > 3


def test_ring_accessors_validate_frames():
    states, frames, _, pool = _run_pool("port", 1, 20, seed=5)
    f = frames[0] - 1
    st = pool.ring_state(0, f)
    assert set(st) == set(states[0])
    cs = pool.ring_checksum(0, f)
    assert isinstance(cs, int) and cs > 0
    with pytest.raises(RuntimeError):
        pool.ring_state(0, max(0, f - 50))


def test_undersized_ring_fails_loudly():
    net = tnet.InMemoryNetwork(latency_ticks=4)
    sessions = []
    for me, other, h in (("A", "B", 0), ("B", "A", 1)):
        sessions.append(
            tsessions.SessionBuilder(tgames.boxgame_config()).with_clock(lambda: 0)
            .with_rng(random.Random(11 + h)).add_player(tcore.Local(), h)
            .add_player(tcore.Remote(other), 1 - h).start_p2p_session(net.socket(me))
        )
    pool = _pool("port", tgames.BoxGame(2), 2, ring_length=3)
    with pytest.raises(RuntimeError, match="too small"):
        for i in range(40):
            net.tick()
            for s in sessions:
                s.poll_remote_clients()
            reqs = []
            for h, s in enumerate(sessions):
                s.add_local_input(h, (i // 2) % 16)
                reqs.append(s.advance_frame())
            pool.run(reqs)
    with pytest.raises(RuntimeError, match="invalidated"):
        pool.run([[] for _ in range(2)])
    with pytest.raises(RuntimeError, match="invalidated"):
        pool.ring_state(0, 0)


def test_spectator_follows_through_the_pool():
    net = tnet.InMemoryNetwork()
    clock = lambda: 0
    B = tsessions.SessionBuilder
    host = (B(tgames.boxgame_config()).with_clock(clock).with_rng(random.Random(7))
            .add_player(tcore.Local(), 0).add_player(tcore.Remote("B"), 1)
            .add_player(tcore.Spectator("SPEC"), 2).start_p2p_session(net.socket("A")))
    peer = (B(tgames.boxgame_config()).with_clock(clock).with_rng(random.Random(8))
            .add_player(tcore.Remote("A"), 0).add_player(tcore.Local(), 1)
            .start_p2p_session(net.socket("B")))
    spec = B(tgames.boxgame_config()).with_clock(clock).start_spectator_session(
        "A", net.socket("SPEC"))
    pool = _pool("port", tgames.BoxGame(2), 3)
    for i in range(60):
        host.poll_remote_clients()
        peer.poll_remote_clients()
        host.add_local_input(0, (min(i, 45) // 4) % 16)
        reqs = [host.advance_frame()]
        peer.add_local_input(1, (min(i, 45) // 3) % 16)
        reqs.append(peer.advance_frame())
        try:
            reqs.append(spec.advance_frame())
        except tcore.PredictionThreshold:
            reqs.append([])
        pool.run(reqs)
    assert spec.current_frame > 40, "spectator never followed"
    f = spec.current_frame
    _assert_states_equal([pool.live_state(2)], [pool.ring_state(0, f + 1)], "spectator")


def test_disconnect_mid_match_through_the_pool():
    sessions, schedules = _make_matches("port", 2, seed=17)
    pool = _pool("port", tgames.BoxGame(2), 4)
    for i in range(50):
        for s in sessions:
            s.poll_remote_clients()
        reqs = []
        for h, (s, sched) in enumerate(zip(sessions, schedules)):
            if h == 1 and i >= 30:
                reqs.append([])
                continue
            if h == 0 and i == 32:
                s.disconnect_player(1)
            s.add_local_input(h % 2, sched(min(i, 39)))
            reqs.append(s.advance_frame())
        pool.run(reqs)
    assert sessions[0].current_frame > 35
    assert sessions[2].current_frame == sessions[3].current_frame
    _assert_states_equal([pool.live_state(2)], [pool.live_state(3)], "match 1")


def test_lockstep_and_input_delay_through_the_pool():
    net = tnet.InMemoryNetwork()
    sessions = []
    variants = [lambda b: b.with_max_prediction_window(0), lambda b: b.with_input_delay(2),
                lambda b: b]
    for m, variant in enumerate(variants):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            b = (tsessions.SessionBuilder(tgames.boxgame_config()).with_clock(lambda: 0)
                 .with_rng(random.Random(71 + 3 * m + me)))
            b = variant(b).add_player(tcore.Local(), me).add_player(
                tcore.Remote(names[1 - me]), 1 - me)
            sessions.append(b.start_p2p_session(net.socket(names[me])))
    pool = _pool("port", tgames.BoxGame(2), 6)
    for i in range(50):
        for s in sessions:
            s.poll_remote_clients()
        reqs = []
        for h, s in enumerate(sessions):
            s.add_local_input(h % 2, (min(i, 39) // (2 + h // 2)) % 16)
            reqs.append(s.advance_frame())
        pool.run(reqs)
    for m in range(3):
        a, b = sessions[2 * m], sessions[2 * m + 1]
        assert a.current_frame == b.current_frame, (m, a.current_frame, b.current_frame)
        _assert_states_equal([pool.live_state(2 * m)], [pool.live_state(2 * m + 1)], f"match {m}")


def test_one_dispatch_per_tick():
    sessions, schedules = _make_matches("port", 3, seed=3)
    pool = _pool("port", tgames.BoxGame(2), 6)
    calls = {"n": 0}
    real_tick = pool._tick

    def counting(desc):
        calls["n"] += 1
        return real_tick(desc)

    pool._tick = counting
    reg = default_registry()
    before = reg.value("ggrs_executor_dispatches_total")
    empty_before = reg.value("ggrs_executor_empty_ticks_total")
    _drive(sessions, schedules, pool.run, 20, drain=0)
    assert calls["n"] == 20
    pool.run([[] for _ in range(6)])
    assert calls["n"] == 20, "an all-empty tick must do no device work"
    assert reg.value("ggrs_executor_dispatches_total") - before == 20
    assert reg.value("ggrs_executor_empty_ticks_total") - empty_before == 1


# -- the port against the JAX package ---------------------------------------


@pytest.mark.parametrize("sparse", [False, True])
def test_pool_matches_the_jax_pool_every_tick(sparse):
    """The same seeded matches through both packages' pools: every tick the
    live states are equal per session, and every ring checksum the
    sessions' saves hold is equal."""
    per = {}
    for pkg in PKGS:
        rec = []

        def on_tick(i, reqs, pool, rec=rec):
            saved = []
            for b, rs in enumerate(reqs):
                saved += [(b, r.frame) for r in rs if type(r).__name__ == "SaveGameState"]
            rec.append(([_np_state(pool.live_state(b)) for b in range(pool.batch_size)],
                        [(b, f, pool.ring_checksum(b, f)) for b, f in saved]))

        # (desync detection needs every interval frame saved: not sparse)
        _, frames, events, pool = _run_pool(pkg, 3, 36, seed=19, sparse=sparse,
                                            desync_interval=0 if sparse else 4,
                                            on_tick=on_tick)
        per[pkg] = (rec, frames, events)
    (rp, fp, ep), (rj, fj, ej) = per["port"], per["jax"]
    assert fp == fj
    assert len(rp) == len(rj)
    for i, ((sp, cp), (sj, cj)) in enumerate(zip(rp, rj)):
        _assert_states_equal(sp, sj, f"tick {i}")
        assert cp == cj, f"tick {i}"
    assert sum(len(c) for _, c in rp) > 60
    for a, b in zip(ep, ej):
        assert [type(e).__name__ for e in a] == [type(e).__name__ for e in b]


def test_pool_warmup_is_required_and_leaves_state_alone():
    game = tgames.BoxGame(2)
    pool = tpar.BatchedRequestExecutor(game.advance, game.init_state_np(), _to_arr,
                                       batch_size=3, ring_length=4, max_burst=2, device="cpu")
    with pytest.raises(RuntimeError, match="warmup"):
        pool._blank_desc()
    before = [_np_state(pool.live_state(b)) for b in range(3)]
    pool.warmup(np.zeros((2,), np.uint8))
    _assert_states_equal([_np_state(pool.live_state(b)) for b in range(3)], before, "warmup")
    assert (pool._carry["ring"]["frames"] == -1).all()


class _DeviceRead(AssertionError):
    pass


def test_pooled_tick_reads_nothing_from_the_device(monkeypatch):
    sessions, schedules = _make_matches("port", 3, seed=13, desync_interval=0)
    pool = _pool("port", tgames.BoxGame(2), 6)

    def refuse(*args, **kwargs):
        raise _DeviceRead("a tensor was read to the host")

    @contextlib.contextmanager
    def spy():
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__index__",
                         "__float__"):
                m.setattr(torch.Tensor, name, refuse)
            yield

    with pytest.raises(_DeviceRead), spy():
        torch.ones(2).tolist()

    def fulfill(reqs):
        with spy():
            pool.run(reqs)

    _drive(sessions, schedules, fulfill, 30)
    assert default_registry().value("ggrs_executor_rollback_loads_total") > 0


def test_pool_digest_launches_are_predicted_from_descriptors(monkeypatch):
    # the card's wrapper route, emulated: each masked write some row takes is
    # one launch over the B rows
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    sessions, schedules = _make_matches("port", 3, seed=11)
    pool = _pool("port", tgames.BoxGame(2), 6)
    predicted = {"n": 0}
    real_tick = pool._tick

    def tick(desc):
        predicted["n"] += pool_predicted(desc)
        return real_tick(desc)

    pool._tick = tick
    before = tdg.state_digest.launches
    calls.clear()
    _drive(sessions, schedules, pool.run, 30)
    assert tdg.state_digest.launches - before == predicted["n"] == len(calls) > 30
    assert set(calls) == {6}  # every launch digests all B rows


def test_request_pooling_is_value_identical():
    """enable_request_pooling changes object lifetimes, not values: two
    identically seeded matches, one pooled, compare every tick's requests,
    events, frames and sent bytes (after tests/test_policy_plane.py:279,
    without the native bank)."""

    class Recording:
        def __init__(self, inner):
            self.inner, self.sent = inner, []

        def send_to(self, msg, addr):
            self.sent.append((addr, msg.encode()))
            self.inner.send_to(msg, addr)

        def receive_all_messages(self):
            return self.inner.receive_all_messages()

    def build(pool_requests):
        clock = [0]
        net = tnet.InMemoryNetwork(loss=0.05, reorder=0.1, seed=99)
        sessions = []
        for me in (0, 1):
            names = ("A", "B")
            s = (tsessions.SessionBuilder(tcore.Config.for_uint(16)).with_clock(lambda: clock[0])
                 .with_rng(random.Random(5 + me)).add_player(tcore.Local(), me)
                 .add_player(tcore.Remote(names[1 - me]), 1 - me)
                 .start_p2p_session(Recording(net.socket(names[me]))))
            if pool_requests:
                s.enable_request_pooling()
            sessions.append(s)
        return net, clock, sessions

    net_a, clock_a, plain = build(False)
    net_b, clock_b, pooled = build(True)
    seen = set()
    for i in range(150):
        clock_a[0] += 16
        clock_b[0] += 16
        for me in (0, 1):
            plain[me].add_local_input(me, (i + me) % 16)
            pooled[me].add_local_input(me, (i + me) % 16)
        for me in (0, 1):
            ra, rb = plain[me].advance_frame(), pooled[me].advance_frame()
            assert len(ra) == len(rb), (i, me)
            for a, b in zip(ra, rb):
                assert type(a) is type(b)
                if isinstance(a, tcore.AdvanceFrame):
                    assert a.inputs == b.inputs
                else:
                    assert a.frame == b.frame
                seen.add(type(a).__name__)
            for r in ra + rb:
                if isinstance(r, tcore.SaveGameState):
                    r.cell.save(r.frame, None, None)
            if rb and isinstance(rb[-1], tcore.AdvanceFrame):
                assert rb[-1] is pooled[me]._pooled_adv
                assert pooled[me].advance_frame.__self__._pooled_list is rb
        net_a.tick()
        net_b.tick()
        for me in (0, 1):
            assert plain[me].events() == pooled[me].events()
            assert plain[me].current_frame == pooled[me].current_frame
            assert plain[me]._socket.sent == pooled[me]._socket.sent
    assert seen >= {"SaveGameState", "LoadGameState", "AdvanceFrame"}


def test_pooled_requests_through_the_pool_match_unpooled():
    # a pool fulfils pooled-request sessions tick-synchronously: the same
    # states as the unpooled sessions
    got = {}
    for pooling in (False, True):
        sessions, schedules = _make_matches("port", 2, seed=61, pooling=pooling)
        pool = _pool("port", tgames.BoxGame(2), 4)
        _drive(sessions, schedules, pool.run, 36)
        got[pooling] = [_np_state(pool.live_state(b)) for b in range(4)]
    _assert_states_equal(got[True], got[False], "pooled requests")
