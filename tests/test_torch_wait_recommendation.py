"""The port's WaitRecommendation through a live P2P pair, held against the
JAX package's: the twin of tests/test_wait_recommendation.py.

The same scenarios run on both packages' sessions at the same seeds and must
give the same recommendations (frame, ``skip_frames``), the same
``frames_ahead`` and the same game states; then the JAX file's checks hold
on the port's run: the emission threshold, the 60-frame cadence, the
``skip_frames`` magnitude and the throttling loop consuming the
recommendation.  Tolerance: exact equality.
"""

import random
from types import SimpleNamespace

import pytest

import ggrs_tpu.core as jcore
import ggrs_tpu.net as jnet
import ggrs_tpu.sessions as jsessions
import ggrs_tpu.sessions.p2p as jp2p

import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.sessions as tsessions
import ggrs_tpu_torch.sessions.p2p as tp2p

from test_torch_sessions import _describe, _Stub

PKGS = {
    "jax": SimpleNamespace(core=jcore, net=jnet, sessions=jsessions, p2p=jp2p),
    "port": SimpleNamespace(core=tcore, net=tnet, sessions=tsessions, p2p=tp2p),
}


def make_pair(m, clock):
    net = m.net.InMemoryNetwork()
    sessions = []
    for me, other, local_handle in (("A", "B", 0), ("B", "A", 1)):
        sessions.append(
            m.sessions.SessionBuilder(m.core.Config.for_uint(32))
            .with_clock(clock)
            .with_rng(random.Random(71 + local_handle))
            .add_player(m.core.Local(), local_handle)
            .add_player(m.core.Remote(other), 1 - local_handle)
            .start_p2p_session(net.socket(me))
        )
    return sessions


def run_scenario(pkg, iterations, throttle):
    """A ticks every iteration; B starts 12 iterations late, then runs at the
    same rate, so A runs ahead until the prediction window caps it.  With
    ``throttle`` A honors each recommendation by skipping ``skip_frames``
    ticks, letting B catch up (the example's slow-down loop).  Returns what
    the JAX file checks and what the two packages must share."""
    m = PKGS[pkg]
    now = [0]
    sess_a, sess_b = make_pair(m, lambda: now[0])
    stub_a, stub_b = _Stub(m.core), _Stub(m.core)
    recs, rec_frames, lists = [], [], []
    b_ticks = skip = 0
    for i in range(iterations):
        now[0] += 100  # generous: quality reports flow every other tick
        sess_a.poll_remote_clients()
        sess_b.poll_remote_clients()
        for e in sess_a.events():
            if isinstance(e, m.core.WaitRecommendation):
                recs.append(e.skip_frames)
                rec_frames.append(sess_a.current_frame)
                if throttle:
                    skip = e.skip_frames
        if skip > 0:
            skip -= 1
        else:
            sess_a.add_local_input(0, i % 4)
            reqs = sess_a.advance_frame()
            lists.append(_describe(m.core, reqs))
            stub_a.handle(reqs)
        if i >= 12:
            sess_b.add_local_input(1, b_ticks % 4)
            reqs = sess_b.advance_frame()
            lists.append(_describe(m.core, reqs))
            stub_b.handle(reqs)
            b_ticks += 1
    return {"recs": recs, "rec_frames": rec_frames, "frames_ahead": sess_a.frames_ahead(),
            "states": [(stub_a.frame, stub_a.value), (stub_b.frame, stub_b.value)],
            "lists": lists}


def test_constants_match_jax():
    assert tp2p.MIN_RECOMMENDATION == jp2p.MIN_RECOMMENDATION
    assert tp2p.RECOMMENDATION_INTERVAL == jp2p.RECOMMENDATION_INTERVAL == 60


@pytest.mark.parametrize("throttle", [False, True], ids=["free", "throttled"])
def test_scenario_matches_jax(throttle):
    assert run_scenario("port", 300, throttle) == run_scenario("jax", 300, throttle)


def test_recommendations_fire_with_threshold_and_cadence():
    run = run_scenario("port", 300, throttle=False)
    recs, rec_frames = run["recs"], run["rec_frames"]
    assert len(recs) >= 3, "a peer running ahead must be told to wait"
    # magnitude: always at least the minimum advantage that triggers it
    assert all(r >= tp2p.MIN_RECOMMENDATION for r in recs)
    # cadence: at most one recommendation per 60-frame interval
    gaps = [b - a for a, b in zip(rec_frames, rec_frames[1:])]
    assert all(g >= tp2p.RECOMMENDATION_INTERVAL for g in gaps), gaps
    # the session's own ahead-ness metric agrees
    assert run["frames_ahead"] >= tp2p.MIN_RECOMMENDATION


def test_throttling_consumes_recommendation():
    run = run_scenario("port", 300, throttle=True)
    # honoring the waits lets the late peer catch up: after the initial
    # transient, recommendations stop and the advantage falls below threshold
    assert 1 <= len(run["recs"]) <= 2, run["recs"]
    assert run["frames_ahead"] < tp2p.MIN_RECOMMENDATION


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_no_recommendation_when_in_sync(pkg):
    m = PKGS[pkg]
    now = [0]
    sess_a, sess_b = make_pair(m, lambda: now[0])
    stub_a, stub_b = _Stub(m.core), _Stub(m.core)
    recs = []
    for i in range(150):
        now[0] += 100
        sess_a.poll_remote_clients()
        sess_b.poll_remote_clients()
        for s in (sess_a, sess_b):
            recs += [e for e in s.events() if isinstance(e, m.core.WaitRecommendation)]
        sess_a.add_local_input(0, i % 4)
        stub_a.handle(sess_a.advance_frame())
        sess_b.add_local_input(1, i % 3)
        stub_b.handle(sess_b.advance_frame())
    assert recs == []
    assert stub_a.frame == stub_b.frame == 150
