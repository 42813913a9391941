"""The port's process fleet (``fleet/proc.py``: ``ShardRunner``,
``runner_main`` and ``ProcShard``, and ``chaos.drive_proc_fleet``) against
the JAX package's, on the CPU.

Mirrors ``tests/test_fleet_proc.py``.  The JAX test pins its in-process
backend equal to its process backend, so here the port's process backend
(``s1`` in a runner spawned from ``scripts/port_shard_runner.py``) is held
to the JAX package's in-process run of the same world (2 matches a shard,
48 ticks, seed 7): the peers' received bytes, states and events, frames,
placements and journals, exactly.  Then ``sup.kill("s1")`` (a real
SIGKILL of the runner, whose journals keep only what reached the disk)
against the JAX in-process kill, and the kill again with the runner's
matches fulfilled by ``ExecutorGame(device="cpu")`` against JAX
executors: the survivors exactly, the failed-over matches on the
invariants (recovered onto ``s0``, nothing lost, no desync, the journal
written before the fault a prefix of the JAX one).  The lifecycle cases
(graceful drain, no orphans or leaked fds, the hang watchdog, the restart
budget) run on the port alone.
The tunings are the JAX tests' own.  Nothing here reads a verdict derived
from the wall clock (``healthz()["ok"]``, heartbeat ages)."""

from __future__ import annotations

import functools
import json
import os
import signal
import time

import jax
import numpy as np
import pytest

import ggrs_tpu.chaos as jchaos
import ggrs_tpu.fleet.supervisor as jsup
import ggrs_tpu_torch.chaos as tchaos
from ggrs_tpu.broadcast.journal import read_journal as jax_read_journal
from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu_torch import to_numpy
from ggrs_tpu_torch.broadcast.journal import read_journal
from ggrs_tpu_torch.chaos import (
    CrcGame,
    drive_proc_fleet,
    fleet_recovery_violations,
    fleet_survivor_violations,
    two_peer_builder,
)
from ggrs_tpu_torch.core.errors import NotSynchronized, PredictionThreshold
from ggrs_tpu_torch.fleet import SHARD_DEAD, FleetTuning, ProcShard
from ggrs_tpu_torch.fleet.proc import proc_match_builder, udp_socket_factory
from ggrs_tpu_torch.net.sockets import UdpNonBlockingSocket
from ggrs_tpu_torch.obs import Registry

from test_torch_fleet import neutral
from test_torch_placement import _JaxHost

TICKS = 48
PER_SHARD = 2
SURVIVORS = [f"m{k}" for k in range(PER_SHARD)]              # on s0
AFFECTED = [f"m{k}" for k in range(PER_SHARD, 2 * PER_SHARD)]  # on s1
# tests/test_fleet_proc.py's tuning
TUNING = FleetTuning(
    heartbeat_interval_s=0.05,
    heartbeat_deadline_s=1.0,
    rpc_timeout_s=5.0,
    spawn_timeout_s=120.0,
    drain_deadline_s=0.5,
    restart_max=0,
)
# what the peers observe, identical across backends and packages; the
# request lists too, for the matches this process fulfils (a runner's stay
# in the runner: the parent logs an empty list a tick for them)
PEER_FIELDS = ("wire", "peer_events", "peer_states", "peer_frames", "host_events", "frames",
               "locations")


def _kill_at_half(i, ctx):
    if i == TICKS // 2:
        ctx["sup"].kill("s1")


def _run(pkg, backend, tmp, inject=None, **kw):
    chaos = {"jax": jchaos, "port": tchaos}[pkg]
    jdir = os.path.join(tmp, f"{pkg}-{backend}-{'kill' if inject else 'control'}")
    os.makedirs(jdir)
    ctx = chaos.drive_proc_fleet(TICKS, matches_per_shard=PER_SHARD, seed=7, backend=backend,
                                 tuning=TUNING, inject=inject, journal_dir=jdir, **kw)
    ctx["sup"].close()
    return ctx


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("proc_fleet"))
    return {
        ("jax", "control"): _run("jax", "inproc", tmp),
        ("port", "control"): _run("port", "proc", tmp),
        ("jax", "kill"): _run("jax", "inproc", tmp, _kill_at_half),
        ("port", "kill"): _run("port", "proc", tmp, _kill_at_half),
    }


def _assert_same_world(port, jax_ctx, mids, reqs_of=SURVIVORS):
    assert not port["lost"] and not jax_ctx["lost"]
    for field in PEER_FIELDS:
        for mid in mids:
            assert neutral(port[field][mid]) == neutral(jax_ctx[field][mid]), (field, mid)
    for mid in reqs_of:
        assert neutral(port["reqs"][mid]) == neutral(jax_ctx["reqs"][mid]), mid


def test_proc_backend_matches_jax_inproc(runs):
    port, jax_ctx = runs[("port", "control")], runs[("jax", "control")]
    assert port["sup"].shards["s1"].backend == "proc"
    _assert_same_world(port, jax_ctx, port["match_ids"])
    # the runner's matches: one empty list a tick in this process
    assert all(port["reqs"][m] == [[]] * TICKS for m in AFFECTED)
    assert not port["lost"] and all(f == TICKS for f in port["frames"].values())


def test_journal_streams_match_jax(runs):
    """The runner journals its matches in its own process, at the paths the
    supervisor composes: record for record the JAX in-process journals.
    After the SIGKILL, the killed runner's journals hold a prefix of the
    JAX ones (what reached the disk) and the survivors' are equal."""
    for scenario in ("control", "kill"):
        port, jax_ctx = runs[("port", scenario)], runs[("jax", scenario)]
        files = sorted(os.listdir(jax_ctx["journal_dir"]))
        assert sorted(os.listdir(port["journal_dir"])) == files
        for f in files:
            got = read_journal(os.path.join(port["journal_dir"], f))
            want = jax_read_journal(os.path.join(jax_ctx["journal_dir"], f))
            if scenario == "kill" and f.startswith(tuple(AFFECTED)):
                if f.endswith(".000.ggjl"):  # the killed runner's
                    n = len(got["frames"])
                    assert n and neutral(got["frames"]) == neutral(want["frames"][:n]), f
                continue
            assert neutral(got["frames"]) == neutral(want["frames"]), (scenario, f)
            assert neutral(got["checkpoints"]) == neutral(want["checkpoints"]), (scenario, f)


def test_healthz_reports_proc_backend(runs):
    h = runs[("port", "control")]["healthz"]["shards"]["s1"]
    assert h["backend"] == "proc" and h["pid"] and h["alive"]
    assert h["state"] == "active" and h["matches"] == PER_SHARD


def test_kill_matches_jax_inproc_kill(runs):
    """``sup.kill("s1")``: a chaos switch in the JAX in-process run, a
    real SIGKILL of the port's runner.  Survivors equal their control and
    the JAX kill's, every affected match recovered onto ``s0`` from its
    journal in both packages."""
    port, jax_ctx = runs[("port", "kill")], runs[("jax", "kill")]
    _assert_same_world(port, jax_ctx, SURVIVORS)
    assert neutral(port["locations"]) == neutral(jax_ctx["locations"])
    assert not port["lost"] and not jax_ctx["lost"]
    assert jchaos.fleet_recovery_violations(jax_ctx, AFFECTED, dead_shards=["s1"]) == []
    assert fleet_survivor_violations(port, runs[("port", "control")], SURVIVORS) == []
    assert fleet_recovery_violations(port, AFFECTED, dead_shards=["s1"]) == []
    assert all(port["locations"][m] == "s0" for m in AFFECTED)
    sup = port["sup"]
    assert sup.shards["s1"].healthz()["state"] == SHARD_DEAD
    assert port["registry"].value("ggrs_fleet_migrations_total", reason="failover") == \
        jax_ctx["registry"].value("ggrs_fleet_migrations_total", reason="failover") == len(AFFECTED)
    assert sup.shards["s1"].orphan_count() == 0
    assert runs[("port", "control")]["sup"].shards["s1"].orphan_count() == 0


class _PortPeer(tchaos.ExecutorGame):
    """The parent's ``ExecutorGame`` on the CPU, recording what the world
    builds: host games first, then peer games, per match."""

    made = []

    def __init__(self):
        super().__init__("boxgame", 2, device="cpu")
        _PortPeer.made.append(self)


def test_runner_executors_match_jax_executors(tmp_path, monkeypatch):
    """The runner fulfils its matches through ``ExecutorGame(device="cpu")``
    built from the shipped partial; the JAX in-process world through JAX
    executors.  The kill fails them over onto ``s0``, whose executors load
    the journals' numpy checkpoints.  The survivors' wire (the hosts'
    checksum reports included), events, frames, peer states and the peers'
    newest saved checksums agree bit for bit; every affected match
    recovered with no desync between its executors."""
    template = JaxBoxGame(2).init_state_np()
    admit = jsup.ShardSupervisor.admit
    monkeypatch.setattr(jsup.ShardSupervisor, "admit",
                        lambda self, *a, **kw: admit(self, *a, **dict(kw, state_template=template)))
    monkeypatch.setattr(jchaos, "CrcGame", _JaxHost)
    monkeypatch.setattr(_JaxHost, "made", [])
    monkeypatch.setattr(_PortPeer, "made", [])
    jax_ctx = _run("jax", "inproc", str(tmp_path), _kill_at_half)
    counts = tmp_path / "counts"
    counts.mkdir()
    shipped = functools.partial(tchaos.ExecutorGame, "boxgame", 2, device="cpu",
                                counts_dir=str(counts))
    port = _run("port", "proc", str(tmp_path), _kill_at_half, game_factory=shipped,
                peer_game_factory=_PortPeer, state_template=template)
    for field in ("wire", "peer_events", "host_events", "frames"):
        for mid in SURVIVORS:
            assert neutral(port[field][mid]) == neutral(jax_ctx[field][mid]), (field, mid)
    assert neutral(port["locations"]) == neutral(jax_ctx["locations"])
    assert not port["lost"]
    assert fleet_recovery_violations(port, AFFECTED, dead_shards=["s1"]) == []
    jax_peers = dict(zip(jax_ctx["match_ids"], _JaxHost.made[1::2]))
    peers = dict(zip(port["match_ids"], _PortPeer.made))
    for mid in SURVIVORS:
        got, want = to_numpy(port["peer_states"][mid]), jax.device_get(jax_ctx["peer_states"][mid])
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{mid} {k}")
        assert (peers[mid].last_save.frame, peers[mid].last_save.checksum) == \
            jax_peers[mid].saved[-1]
    # the killed runner wrote nothing; no runner outlived the run
    assert os.listdir(counts) == []
    assert port["sup"].shards["s1"].orphan_count() == 0


def test_runner_writes_its_counts_at_close(tmp_path):
    counts = tmp_path / "counts"
    counts.mkdir()
    shipped = functools.partial(tchaos.ExecutorGame, "boxgame", 2, device="cpu",
                                counts_dir=str(counts))
    peer = functools.partial(tchaos.ExecutorGame, "boxgame", 2, device="cpu")
    ctx = drive_proc_fleet(12, matches_per_shard=1, seed=5, backend="proc", tuning=TUNING,
                           journal_dir=str(tmp_path), game_factory=shipped, peer_game_factory=peer,
                           state_template=JaxBoxGame(2).init_state_np())
    pid = ctx["sup"].shards["s1"].pid
    ctx["sup"].close()
    assert fleet_recovery_violations(ctx, ctx["match_ids"]) == []
    # CPU runs launch no kernel and predict none
    with open(counts / f"executor_game-{pid}.json") as f:
        assert json.load(f) == {"launches": 0, "predicted": 0, "host_loads": 0}


# -- lifecycle (the port alone) --------------------------------------------------------


def _count_fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_sigstop_escalates_sigterm_then_sigkill_then_recovers():
    t = FleetTuning(heartbeat_interval_s=0.05, heartbeat_deadline_s=0.4, rpc_timeout_s=0.3,
                    drain_deadline_s=0.3, spawn_timeout_s=120.0, restart_max=0)

    def inject(i, ctx):
        if i == 20:
            os.kill(ctx["sup"].shards["s1"].pid, signal.SIGSTOP)

    chaos = drive_proc_fleet(90, matches_per_shard=1, seed=11, backend="proc", tuning=t,
                             inject=inject, tick_sleep_s=0.01)
    try:
        reg = chaos["registry"]
        assert reg.value("ggrs_fleet_proc_watchdog_total", shard="s1", stage="sigterm") >= 1
        assert reg.value("ggrs_fleet_proc_watchdog_total", shard="s1", stage="sigkill") >= 1
        assert fleet_recovery_violations(chaos, ["m1"], dead_shards=["s1"]) == []
        assert chaos["locations"]["m1"] == "s0"
        assert chaos["sup"].shards["s1"].state == SHARD_DEAD
    finally:
        chaos["sup"].close()
    assert chaos["sup"].shards["s1"].orphan_count() == 0


def test_sigterm_runs_graceful_drain(tmp_path):
    clock = [0]
    shard = ProcShard("g0", capacity=2, metrics=Registry(), tuning=TUNING,
                      clock=lambda: clock[0])
    try:
        peer_sock = UdpNonBlockingSocket(0)
        path = tmp_path / "g0.m0.ggjl"
        shard.admit_spec(
            "m0", functools.partial(proc_match_builder, 301, 0,
                                    ("127.0.0.1", peer_sock.local_port())),
            functools.partial(udp_socket_factory, 0), CrcGame,
            journal_spec=dict(path=str(path), num_players=2, input_size=2, fsync_every=1,
                              tail_window=32),
        )
        peer = two_peer_builder(clock, 302, 1, ("127.0.0.1", shard.match_port("m0")),
                                other_handle=0).start_p2p_session(peer_sock)
        game = CrcGame()
        for i in range(30):
            clock[0] += 16
            try:
                peer.add_local_input(1, i % 7)
                game.fulfill(peer.advance_frame())
            except (NotSynchronized, PredictionThreshold):
                pass
            shard.add_local_input("m0", 0, i % 5)
            shard.advance_all()
        assert shard.current_frame("m0") > 10
        conn = shard._conn
        os.kill(shard.pid, signal.SIGTERM)
        shard._proc.wait(timeout=30)
        assert shard._proc.returncode == 0
        for _ in range(50):
            if shard.poll_lifecycle() is not None or conn.goodbye:
                break
            time.sleep(0.01)
        assert conn.goodbye is not None and conn.goodbye["reason"] == "sigterm"
        assert conn.goodbye["frames"]["m0"] > 10
        parsed = read_journal(path)
        assert parsed["closed"] and not parsed["truncated"] and parsed["frames"]
    finally:
        shard.close()
    assert shard.orphan_count() == 0


def test_sigkill_leaves_no_orphans_or_leaked_fds():
    fd_base = _count_fds()
    shard = ProcShard("leak0", capacity=2, metrics=Registry(), tuning=TUNING)
    pid = shard.pid
    assert _count_fds() > fd_base
    os.kill(pid, signal.SIGKILL)
    died = None
    for _ in range(200):
        died = shard.poll_lifecycle()
        if died == "died":
            break
        time.sleep(0.01)
    assert died == "died"
    shard.close()
    assert _count_fds() == fd_base
    assert shard.orphan_count() == 0 and shard.last_exit == "exit code -9"
    with pytest.raises(ChildProcessError):
        os.waitpid(pid, os.WNOHANG)


def test_shutdown_rpc_closes_cleanly():
    shard = ProcShard("c0", capacity=2, metrics=Registry(), tuning=TUNING)
    shard.close()
    assert shard.last_exit == "exit code 0" and shard.orphan_count() == 0
    shard.close()


def test_restart_after_crash_then_storm_budget():
    t = FleetTuning(heartbeat_interval_s=0.05, heartbeat_deadline_s=0.5, rpc_timeout_s=2.0,
                    drain_deadline_s=0.3, spawn_timeout_s=120.0, restart_backoff_s=0.05,
                    restart_max=2, restart_window_s=60.0)
    kills = {"n": 0}

    def inject(i, ctx):
        s1 = ctx["sup"].shards["s1"]
        if i >= 20 and kills["n"] < 5 and s1.pid and s1._alive():
            kills["n"] += 1
            os.kill(s1.pid, signal.SIGKILL)

    chaos = drive_proc_fleet(240, matches_per_shard=1, seed=3, backend="proc", tuning=t,
                             inject=inject, tick_sleep_s=0.01)
    sup = chaos["sup"]
    try:
        s1 = sup.shards["s1"]
        assert kills["n"] >= 3 and s1.restarts == 2 and s1.state == SHARD_DEAD
        assert chaos["registry"].value("ggrs_fleet_proc_restarts_total", shard="s1") == 2
        assert not chaos["lost"] and chaos["locations"]["m1"] == "s0"
        assert fleet_recovery_violations(chaos, ["m1"], dead_shards=["s1"]) == []
    finally:
        sup.close()
    assert sup.shards["s1"].orphan_count() == 0
