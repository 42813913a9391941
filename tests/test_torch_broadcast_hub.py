"""The port's ``SpectatorHub``, the bank's spectator fan-out and confirmed-
stream tap, and the journal's crash recovery, against the JAX package's.

Mirrors ``tests/test_broadcast.py`` and ``ggrs_tpu/chaos.py``'s
``drive_broadcast``: one two-peer match whose host declares spectators,
real ``SpectatorSession`` viewers, optional side matches, all over seeded
fault networks, hosted on a ``HostSessionPool`` + ``SpectatorHub`` (native
fan-out) or on a plain ``P2PSession`` (the per-session reference).  The port
and the JAX package give the same host wire bytes, viewer streams, request
lists, events, spectator states and journals (byte for byte); fan-out and
the journal tap add no crossing; ``ReplaySession`` reproduces a viewer's
stream from the port's journal; ``recovery_harvest`` and
``resume_from_file`` give the JAX package's resume dicts; an evicted slot
keeps its viewers (grafted) and its journal; a slot whose harvest is dead
resumes from the journal tail; ``adopt_resume_bundle`` carries spectators
and a journal tap.  Tolerance: exact equality throughout."""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest

import ggrs_tpu.broadcast as jbroadcast
import ggrs_tpu.core as jcore
import ggrs_tpu.core.errors as jerrors
import ggrs_tpu.core.types as jtypes
import ggrs_tpu.net as jnet
import ggrs_tpu.obs as jobs
import ggrs_tpu.parallel.host_bank as jbank
import ggrs_tpu.sessions as jsessions
from ggrs_tpu.core.config import Config as JConfig

import ggrs_tpu_torch.broadcast as tbroadcast
import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.core.errors as terrors
import ggrs_tpu_torch.core.types as ttypes
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.obs as tobs
import ggrs_tpu_torch.parallel.host_bank as tbank
import ggrs_tpu_torch.sessions as tsessions
from ggrs_tpu_torch.broadcast.journal import _window_resume
from ggrs_tpu_torch.core.config import Config as TConfig

PKGS = {
    "jax": SimpleNamespace(core=jcore, errors=jerrors, types=jtypes, net=jnet, obs=jobs,
                           bank=jbank, sessions=jsessions, broadcast=jbroadcast, Config=JConfig),
    "port": SimpleNamespace(core=tcore, errors=terrors, types=ttypes, net=tnet, obs=tobs,
                            bank=tbank, sessions=tsessions, broadcast=tbroadcast, Config=TConfig),
}
FAULTS = dict(loss=0.05, duplicate=0.03, reorder=0.03, latency_ticks=1)


class RecordingSocket:
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
        self.sent.extend((addr, bytes(d)) for d, addr in items)
        self.inner.send_datagram_batch(items)

    def receive_all_datagrams(self):
        return self.inner.receive_all_datagrams()

    def receive_all_messages(self):
        return self.inner.receive_all_messages()


def fulfill(requests):
    """Saves hold the frame itself as state; loads are checked against it."""
    for r in requests:
        k = type(r).__name__
        if k == "SaveGameState":
            r.cell.save(r.frame, r.frame, None)
        elif k == "LoadGameState":
            assert r.cell.data() == r.frame


def req_summary(reqs):
    out = []
    for r in reqs:
        k = type(r).__name__
        if k == "AdvanceFrame":
            out.append((k, tuple((v, s.name) for v, s in r.inputs)))
        else:
            out.append((k, r.frame))
    return out


def ev_summary(events):
    return [(type(e).__name__, tuple(sorted(vars(e).items()))) for e in events]


def two_peer(pkg, clock, seed, me, other, other_handle=None):
    p = PKGS[pkg]
    return (
        p.sessions.SessionBuilder(p.Config.for_uint(16))
        .with_clock(lambda: clock[0])
        .with_rng(random.Random(seed))
        .add_player(p.core.Local(), me)
        .add_player(p.core.Remote(other), other_handle if other_handle is not None else 1 - me)
    )


def drive_broadcast(pkg, ticks, use_hub=True, seed=0, n_spectators=1, n_side_matches=0,
                    fault_cfg=None, journal_path=None, inject=None, sabotage_harvest=False,
                    scrape_every=0, dynamic_viewer=False):
    """The JAX package's ``chaos.drive_broadcast``, for either package."""
    p = PKGS[pkg]
    base = seed * 1000
    clock = [0]
    cfg_kwargs = dict(fault_cfg or {"latency_ticks": 1})
    cfg_kwargs.setdefault("seed", base + 1)
    net = p.net.InMemoryNetwork(**cfg_kwargs)
    config = p.Config.for_uint(16)
    names = [f"V{k}" for k in range(n_spectators)]
    hb = two_peer(pkg, clock, base + 10, 0, "P")
    if not dynamic_viewer:
        for k, vname in enumerate(names):
            hb = hb.add_player(p.types.Spectator(vname), 2 + k)
    peer = two_peer(pkg, clock, base + 20, 1, "H", other_handle=0).start_p2p_session(
        net.socket("P"))
    viewers = [
        p.sessions.SessionBuilder(config).with_clock(lambda: clock[0])
        .with_rng(random.Random(base + 30 + k)).start_spectator_session("H", net.socket(v))
        for k, v in enumerate(names)
    ]
    host_sock = RecordingSocket(net.socket("H"))
    registry = p.obs.Registry()
    pool = hub = journal = host = None
    side_socks, side_nets = [], []
    if use_hub:
        pool = p.bank.HostSessionPool(metrics=registry)
        hub = p.broadcast.SpectatorHub(pool, rng=random.Random(base + 40))
        pool.add_session(hb, host_sock)
        for m in range(n_side_matches):
            s_cfg = dict(fault_cfg or {"latency_ticks": 1})
            s_cfg.setdefault("seed", base + 100 + m)
            s_net = p.net.InMemoryNetwork(**s_cfg)
            side_nets.append(s_net)
            for me, nm in enumerate((f"A{m}", f"B{m}")):
                s = RecordingSocket(s_net.socket(nm))
                side_socks.append(s)
                pool.add_session(two_peer(pkg, clock, base + 50 + 5 * m + me, me,
                                          (f"A{m}", f"B{m}")[1 - me]), s)
        assert pool.native_active
        if dynamic_viewer:
            for v in names:
                hub.attach(0, v)
        if journal_path is not None:
            journal = p.broadcast.MatchJournal(journal_path, 2, config.native_input_size,
                                               metrics=registry)
            hub.attach_journal(0, journal)
        if sabotage_harvest:
            def broken(index):
                raise RuntimeError("simulated dead native state")

            pool._harvest = broken
    else:
        host = hb.start_p2p_session(host_sock)
    n_slots = 1 + 2 * n_side_matches
    reqs_log = [[] for _ in range(n_slots)]
    events_log = [[] for _ in range(n_slots)]
    streams = [[] for _ in viewers]
    vframes = [[] for _ in viewers]
    hub_events, spec_states = [], []

    def sched(i, idx):
        return ((i + 2 * idx) // (2 + idx % 3)) % 16

    ctx = dict(pool=pool, hub=hub, host=host, peer=peer, viewers=viewers, journal=journal)
    for i in range(ticks):
        clock[0] += 16
        if inject is not None:
            inject(i, ctx)
        peer.add_local_input(1, (i * 5) % 16)
        fulfill(peer.advance_frame())
        if use_hub:
            for idx in range(n_slots):
                pool.add_local_input(idx, (idx - 1) % 2 if idx else 0, sched(i, idx))
            for idx, reqs in enumerate(pool.advance_all()):
                fulfill(reqs)
                reqs_log[idx].append(req_summary(reqs))
            for idx in range(n_slots):
                events_log[idx].extend(ev_summary(pool.events(idx)))
            hub_events.extend(ev_summary(hub.events(0)))
            spec_states.append(hub.spectators(0))
            if scrape_every and i % scrape_every == 0:
                pool.scrape()
        else:
            host.add_local_input(0, sched(i, 0))
            reqs = host.advance_frame()
            fulfill(reqs)
            reqs_log[0].append(req_summary(reqs))
            events_log[0].extend(ev_summary(host.events()))
        for k, viewer in enumerate(viewers):
            try:
                for r in viewer.advance_frame():
                    streams[k].append((viewer.current_frame, req_summary([r])[0]))
            except (p.errors.NotSynchronized, p.errors.PredictionThreshold,
                    p.errors.SpectatorTooFarBehind):
                pass
            vframes[k].append(viewer.current_frame)
        net.tick()
        for s_net in side_nets:
            s_net.tick()
    ctx.update(
        host_wire=host_sock.sent, side_wire=[s.sent for s in side_socks], reqs=reqs_log,
        events=events_log, viewer_streams=streams, viewer_frames=vframes,
        hub_events=hub_events, spec_states=spec_states, registry=registry,
        states=[pool.slot_state(i) for i in range(n_slots)] if use_hub else ["native"],
        frames=[pool.current_frame(i) for i in range(n_slots)] if use_hub
        else [host.current_frame],
        peer_frame=peer.current_frame,
    )
    return ctx


OBSERVED = ("host_wire", "side_wire", "reqs", "events", "viewer_streams", "viewer_frames",
            "hub_events", "spec_states", "states", "frames", "peer_frame")


def same(a, b, keys=OBSERVED):
    return [k for k in keys if a[k] != b[k]]


@pytest.mark.parametrize("seed", [1, 23])
def test_fanout_equals_jax_and_the_per_session_relay(seed):
    kw = dict(seed=seed, n_spectators=3, fault_cfg=dict(FAULTS, seed=seed), scrape_every=1)
    port = drive_broadcast("port", 160, **kw)
    jax = drive_broadcast("jax", 160, **kw)
    ref = drive_broadcast("port", 160, use_hub=False, **kw)
    assert not same(port, jax)
    assert not same(port, ref, ("host_wire", "viewer_streams", "viewer_frames"))
    assert port["reqs"][0] == ref["reqs"][0]
    pool = port["pool"]
    assert pool.crossings == 160 and pool.stat_crossings == 160 and pool.harvests == 0
    assert min(f[-1] for f in port["viewer_frames"]) > 120
    assert port["registry"].value("ggrs_spectators_attached", slot="0") == 3
    assert port["hub"].metrics_digest() == jax["hub"].metrics_digest()


def test_dynamic_viewers_and_journal_equal_jax(tmp_path):
    kw = dict(seed=5, n_spectators=2, dynamic_viewer=True, scrape_every=4)
    port = drive_broadcast("port", 120, journal_path=tmp_path / "p.ggjl", **kw)
    jax = drive_broadcast("jax", 120, journal_path=tmp_path / "j.ggjl", **kw)
    assert not same(port, jax)
    port["journal"].close()
    jax["journal"].close()
    assert (tmp_path / "p.ggjl").read_bytes() == (tmp_path / "j.ggjl").read_bytes()
    assert port["pool"].crossings == 120
    # the port's ReplaySession plays the journal back as the viewer saw it
    rs = tsessions.ReplaySession(tmp_path / "p.ggjl", TConfig.for_uint(16))
    replayed = []
    while rs.frames_remaining():
        replayed.extend(req_summary(rs.advance_frame()))
    viewed = [r for _, r in port["viewer_streams"][0]]
    assert len(viewed) > 90 and replayed[: len(viewed)] == viewed


def _lifecycle(pkg, tmp_path):
    p = PKGS[pkg]
    clock = [0]
    net = p.net.InMemoryNetwork(latency_ticks=1)
    cfg = p.Config.for_uint(16)
    peer = two_peer(pkg, clock, 2, 1, "H", other_handle=0).start_p2p_session(net.socket("P"))
    viewer = (p.sessions.SessionBuilder(cfg).with_clock(lambda: clock[0])
              .with_rng(random.Random(3)).start_spectator_session("H", net.socket("V")))
    hb = two_peer(pkg, clock, 1, 0, "P").add_player(p.types.Spectator("MUTE"), 2)
    pool = p.bank.HostSessionPool()
    hub = p.broadcast.SpectatorHub(pool, rng=random.Random(4))
    pool.add_session(hb, net.socket("H"))
    assert pool.native_active
    hub.attach(0, "V")  # a dynamic join before frame 0; "MUTE" never acks
    out = dict(refused=[], events=[], frames=[], states=[])
    for i in range(200):
        clock[0] += 16
        peer.add_local_input(1, i % 16)
        fulfill(peer.advance_frame())
        pool.add_local_input(0, 0, i % 16)
        for reqs in pool.advance_all():
            fulfill(reqs)
        try:
            viewer.advance_frame()
        except (p.errors.NotSynchronized, p.errors.PredictionThreshold):
            pass
        net.tick()
        out["events"].extend(ev_summary(hub.events(0)))
        out["states"].append(hub.spectators(0))
        out["frames"].append(viewer.current_frame)
        if i == 60:
            # a late viewer is refused (the journal is the catch-up story);
            # a late journal tap is accepted exactly where the JAX pool
            # accepts it (the fan-out cursor started at frame 0)
            for attach in (lambda: hub.attach(0, "LATE"), lambda: hub.attach_journal(
                    0, p.broadcast.MatchJournal(tmp_path / f"late-{pkg}", 2, 2))):
                try:
                    attach()
                    out["refused"].append(False)
                except p.errors.InvalidRequest:
                    out["refused"].append(True)
            hub.detach(0, "V")
    out["slot"] = pool.slot_state(0)
    out["frame"] = pool.current_frame(0)
    return out


def test_viewer_lifecycle_and_128_unacked_rule_equal_jax(tmp_path):
    port = _lifecycle("port", tmp_path)
    assert port == _lifecycle("jax", tmp_path)
    assert port["refused"][0]
    assert port["frames"][60] > 30 and port["frames"][-1] <= port["frames"][61] + 12
    kinds = [k for k, _ in port["events"]]
    assert "Disconnected" in kinds and "NetworkInterrupted" in kinds
    assert not port["states"][-1][1]["running"] and port["slot"] == "native"
    assert port["frame"] > 170


def test_hubless_spectator_match_runs_per_session():
    clock = [0]
    b = two_peer("port", clock, 1, 0, "P").add_player(ttypes.Spectator("V"), 2)
    assert not tbank._bank_eligible(b) and tbank._bank_eligible(b, hub_active=True)
    pool = tbank.HostSessionPool()
    pool.add_session(b, tnet.InMemoryNetwork().socket("H"))
    assert not pool.native_active


def test_eviction_keeps_viewers_fed_as_in_jax():
    def inject(i, ctx):
        if i == 80:
            ctx["pool"].inject_slot_error(0)

    kw = dict(seed=11, n_spectators=2, inject=inject)
    port = drive_broadcast("port", 220, **kw)
    assert not same(port, drive_broadcast("jax", 220, **kw))
    assert port["states"][0] == "evicted"
    assert port["viewer_frames"][0][-1] > port["viewer_frames"][0][80] + 100


def test_dead_harvest_recovers_from_the_journal_as_in_jax(tmp_path):
    def inject(i, ctx):
        if i == 100:
            ctx["pool"].inject_slot_error(0)

    kw = dict(seed=17, n_side_matches=2)
    control = drive_broadcast("port", 260, journal_path=tmp_path / "c.ggjl", **kw)
    port = drive_broadcast("port", 260, journal_path=tmp_path / "p.ggjl", inject=inject,
                           sabotage_harvest=True, **kw)
    jax = drive_broadcast("jax", 260, journal_path=tmp_path / "j.ggjl", inject=inject,
                          sabotage_harvest=True, **kw)
    assert not same(port, jax)
    assert port["states"][0] == "evicted"
    assert any("journal tail" in f.detail for f in port["pool"].fault_log(0))
    for k in ("p", "j"):
        (port if k == "p" else jax)["journal"].close()
    assert (tmp_path / "p.ggjl").read_bytes() == (tmp_path / "j.ggjl").read_bytes()
    parsed = tbroadcast.read_journal(tmp_path / "p.ggjl")
    assert not parsed["truncated"] and parsed["frames"][-1][0] > 200
    assert port["frames"][0] > port["peer_frame"] - 20
    # the side matches are bit for bit the fault-free run's
    for idx in range(1, 5):
        assert port["states"][idx] == "native"
        assert port["reqs"][idx] == control["reqs"][idx]
        assert port["events"][idx] == control["events"][idx]
    assert port["side_wire"] == control["side_wire"]


def test_recovery_harvest_and_resume_from_file_equal_jax(tmp_path):
    kw = dict(seed=3, n_spectators=2, fault_cfg=dict(FAULTS, seed=3))
    runs = {pkg: drive_broadcast(pkg, 150, journal_path=tmp_path / f"{pkg}.ggjl", **kw)
            for pkg in PKGS}
    pool, jpool = runs["port"]["pool"], runs["jax"]["pool"]
    got = runs["port"]["journal"].recovery_harvest(pool, 0)
    assert got == runs["jax"]["journal"].recovery_harvest(jpool, 0)
    assert got["last_confirmed"] > 100 and len(got["spectators"]) == 2
    for pkg in PKGS:
        runs[pkg]["journal"].close()
    topo = dict(local_handles=[0], endpoints=[([1], True)], spectators=[True, False])
    port_file = tbroadcast.resume_from_file(tmp_path / "port.ggjl", **topo, tail_window=40)
    jax_file = jbroadcast.resume_from_file(tmp_path / "jax.ggjl", **topo, tail_window=40)
    assert port_file == jax_file
    assert len(port_file["window"]) == 40 and port_file["checkpoint"] is None
    # the window core from frame 0 (the NULL_FRAME ack base)
    window = [(f, b"\0\0", bytes([f % 7, 0, f % 5, 0])) for f in range(4)]
    args = dict(num_players=2, input_size=2, local_handles=[0], endpoints=[([1], True)],
                spectators=[True], disc=[False, False], last=[3, 3], current=3)
    from ggrs_tpu.broadcast.journal import _window_resume as j_window_resume

    assert _window_resume(window, **args) == j_window_resume(window, **args)


def _bundle_roundtrip(pkg, tmp_path):
    """Export a spectated, journaled slot at tick 60 and adopt it on a fresh
    Python session with a journal tap; drive both sides on."""
    p = PKGS[pkg]
    ctx = drive_broadcast(pkg, 60, seed=9, n_spectators=2, journal_path=tmp_path / f"{pkg}-a")
    pool = ctx["pool"]
    bundle = pool.export_resume_state(0)
    assert len(bundle["spectators"]) == 2
    pool.release_slot(0)
    assert pool.slot_state(0) == "migrated" and 0 not in pool._journal_sinks
    clock = [60 * 16]
    net = p.net.InMemoryNetwork(latency_ticks=1, seed=4)
    b = two_peer(pkg, clock, 9010, 0, "P")
    for k in range(2):
        b = b.add_player(p.types.Spectator(f"V{k}"), 2 + k)
    journal = p.broadcast.MatchJournal(tmp_path / f"{pkg}-b", 2, 2)
    sock = RecordingSocket(net.socket("H"))
    session, load = p.bank.adopt_resume_bundle(b, sock, bundle, journal=journal)
    out = [req_summary([load])]
    for i in range(30):
        clock[0] += 16
        session.add_local_input(0, i % 16)
        reqs = session.advance_frame()
        fulfill(reqs)
        out.append(req_summary(reqs))
    journal.close()
    return out, sock.sent, sorted(map(repr, session._player_reg.spectators)), bundle["spectators"]


def test_adopt_resume_bundle_with_spectators_and_journal_equals_jax(tmp_path):
    port = _bundle_roundtrip("port", tmp_path)
    assert port == _bundle_roundtrip("jax", tmp_path)
    assert port[0][0][0][0] == "LoadGameState"
    assert {"'V0'", "'V1'"} <= set(port[2]) and len(port[2]) == 3  # + the journal tap
    assert (tmp_path / "port-b").read_bytes() == (tmp_path / "jax-b").read_bytes()
