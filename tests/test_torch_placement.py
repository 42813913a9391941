"""The port's placement plane (``fleet/placement_service.py`` and
``chaos.drive_placement_fleet``) against the JAX package's, on the CPU.

Mirrors ``tests/test_placement.py``: the scheduling and refusal policy over
stub hosts, then the cross-host chaos world (two ``ShardSupervisor`` hosts
behind one ``IngressNode``, peers and two viewers over loopback UDP, 2
matches a host, 48 ticks, seed 11) run as a control, a live migration of
``m2`` and a kill of host ``h1``, in both packages.  The world runs on a
logical clock and the faults are injected at a tick, so everything a run
records is compared exactly across the packages: wire bytes, request
lists, events, viewer streams, placements, frames, game states and
journals.  Then the host kill again with every match fulfilled by
executors (the port's ``ExecutorGame`` on the CPU against the JAX
executor): the failed-over matches load numpy checkpoints.  Nothing here
reads a verdict derived from the wall clock (``healthz()["ok"]``, its SLO,
tick ages)."""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ggrs_tpu.chaos as jchaos
import ggrs_tpu.fleet.supervisor as jsup
import ggrs_tpu_torch.chaos as tchaos
from ggrs_tpu.broadcast.journal import read_journal as jax_read_journal
from ggrs_tpu.fleet import PlacementService as JaxPlacement
from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.ops import DeviceRequestExecutor as JaxExecutor
from ggrs_tpu.obs import Registry as JaxRegistry
from ggrs_tpu.ops import ExecutorPrograms as JaxPrograms
from ggrs_tpu_torch import to_numpy
from ggrs_tpu_torch.broadcast.journal import read_journal
from ggrs_tpu_torch.core.errors import InvalidRequest
from ggrs_tpu_torch.fleet import FleetTuning, PlacementService
from ggrs_tpu_torch.fleet.ingress import ROUTE_OP_PUT, IngressNode, encode_route_update
from ggrs_tpu_torch.fleet.supervisor import FleetError
from ggrs_tpu_torch.obs import Registry, json_snapshot

from test_torch_fleet import neutral

TICKS = 48
SEED = 11
MIGRATE_AT = 10
KILL_AT = 14
H0_MATCHES = ["m0", "m1"]
H1_MATCHES = ["m2", "m3"]
WORLD = dict(matches_per_host=2, seed=SEED, n_spectators=2, spectate_match="m2")
FIELDS = ("wire", "reqs", "host_events", "peer_events", "viewer_streams", "viewer_wire",
          "locations", "vports", "lost", "frames", "peer_frames", "states", "peer_states")
# healthz fields that come from the wall clock or a process's ports
CLOCK_FIELDS = ("last_tick_age_s", "tick_p99_ms", "ok", "slo", "max_proc_heartbeat_age_s",
                "public", "uplink")
CHAOS = {"jax": jchaos, "port": tchaos}


# -- scheduling and refusal over stub hosts ----------------------------------------


class _StubShard:
    def __init__(self, refusal=None):
        self._refusal = refusal

    def admission_refusal(self):
        return self._refusal


class _StubHost:
    def __init__(self, refusal=None, p99=None):
        self.shards = {"s0": _StubShard(refusal)}
        self._p99 = p99

    def healthz(self):
        return {"shards": {"s0": {"tick_p99_ms": self._p99}}}


def _service(hosts, **kw):
    return PlacementService(hosts, ingress=object(), metrics=Registry(), **kw)


class TestScheduling:
    def test_ring_walk_skips_refusing_hosts(self):
        svc = _service({"h0": _StubHost(refusal="full"), "h1": _StubHost()})
        for mid in ("a", "b", "c", "z9"):
            assert svc.choose_host(mid) == "h1"
        assert svc.metrics.value("ggrs_placement_refusals_total", reason="full") >= 1

    def test_ring_walk_matches_jax(self):
        hosts = {f"h{k}": _StubHost() for k in range(5)}
        port = _service(hosts)
        jax_svc = JaxPlacement(hosts, ingress=object(), metrics=JaxRegistry())
        mids = [f"m{k}" for k in range(200)]
        assert [port.choose_host(m) for m in mids] == [jax_svc.choose_host(m) for m in mids]

    def test_dead_host_never_chosen(self):
        svc = _service({"h0": _StubHost(), "h1": _StubHost()})
        svc.kill_host("h0")
        assert svc.host_refusal("h0") == "dead"
        for mid in ("a", "b", "c"):
            assert svc.choose_host(mid) == "h1"

    def test_p99_budget_refuses_overloaded(self):
        svc = _service({"h0": _StubHost(p99=50.0), "h1": _StubHost(p99=1.0)},
                       tuning=FleetTuning(placement_p99_budget_ms=5.0))
        assert svc.host_refusal("h0") == "overloaded"
        assert svc.host_refusal("h1") is None

    def test_no_host_accepts_raises(self):
        svc = _service({"h0": _StubHost(refusal="full"), "h1": _StubHost(refusal="full")})
        with pytest.raises(FleetError, match="no host accepts"):
            svc.choose_host("m0")

    def test_kill_host_mints_route_epoch(self):
        svc = _service({"h0": _StubHost(), "h1": _StubHost()})
        assert svc.route_epoch == 1
        svc.kill_host("h1")
        svc.kill_host("h1")
        assert svc.route_epoch == 2
        svc.kill_host("h0")
        assert svc.route_epoch == 3
        assert svc.metrics.value("ggrs_placement_hosts", state="dead") == 2

    def test_needs_at_least_one_host(self):
        with pytest.raises(InvalidRequest, match="at least one host"):
            _service({})

    def test_stale_supervisor_route_refused_at_ingress(self):
        node = IngressNode(metrics=Registry())
        try:
            svc = _service({"h0": _StubHost(), "h1": _StubHost()})
            vport = node.allocate_endpoint()
            stale_epoch = svc.route_epoch
            svc.kill_host("h1")
            assert node.apply_route_update(encode_route_update(
                ROUTE_OP_PUT, svc.route_epoch, 1, vport, ("127.0.0.1", 40000))) == "ok"
            assert node.apply_route_update(encode_route_update(
                ROUTE_OP_PUT, stale_epoch, 2, vport, ("127.0.0.1", 40666))) == "stale-epoch"
        finally:
            node.close()


# -- the cross-host world, both packages -----------------------------------------------


def _inject(scenario, record):
    def inject(i, ctx):
        if scenario == "migrate" and i == MIGRATE_AT:
            record["before"] = ctx["placement"].virtual_endpoint("m2")
            ctx["placement"].migrate("m2", "h0")
            record["after"] = ctx["placement"].virtual_endpoint("m2")
        elif scenario == "host_kill" and i == KILL_AT:
            ctx["placement"].kill_host("h1")
    return None if scenario == "control" else inject


def _world(pkg, scenario, tmp, **kw):
    record = {}
    jdir = os.path.join(tmp, f"{pkg}-{scenario}")
    os.makedirs(jdir)
    ctx = CHAOS[pkg].drive_placement_fleet(TICKS, inject=_inject(scenario, record),
                                           journal_dir=jdir, **WORLD, **kw)
    ctx["close"]()
    ctx["endpoints"] = record
    return ctx


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("placement"))
    return {(pkg, sc): _world(pkg, sc, tmp)
            for pkg in CHAOS for sc in ("control", "migrate", "host_kill")}


def _healthz(ctx):
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items() if k not in CLOCK_FIELDS}
        return x
    return neutral(strip(ctx["healthz"]))


@pytest.mark.parametrize("scenario", ["control", "migrate", "host_kill"])
def test_world_matches_jax(worlds, scenario):
    port, jax_ctx = worlds[("port", scenario)], worlds[("jax", scenario)]
    for field in FIELDS:
        assert neutral(port[field]) == neutral(jax_ctx[field]), field
    assert _healthz(port) == _healthz(jax_ctx)
    for name in ("ggrs_placement_host_failovers_total", "ggrs_ingress_route_flips_total"):
        assert port["registry"].value(name) == jax_ctx["registry"].value(name), name
    # the journals, record for record
    files = sorted(os.listdir(jax_ctx["journal_dir"]))
    assert sorted(os.listdir(port["journal_dir"])) == files
    for f in files:
        got = read_journal(os.path.join(port["journal_dir"], f))
        want = jax_read_journal(os.path.join(jax_ctx["journal_dir"], f))
        assert neutral(got["frames"]) == neutral(want["frames"]), f


def test_control_world_is_clean(worlds):
    control = worlds[("port", "control")]
    assert not control["lost"]
    for mid in H0_MATCHES:
        assert control["locations"][mid] == ("h0", "a0")
    for mid in H1_MATCHES:
        assert control["locations"][mid] == ("h1", "b0")
    assert all(frame == TICKS for frame in control["frames"].values())
    assert all(control["wire"].values())
    assert tchaos.fleet_recovery_violations(control, control["match_ids"]) == []


def test_migration_keeps_the_virtual_endpoint(worlds):
    migrated, control = worlds[("port", "migrate")], worlds[("port", "control")]
    assert migrated["locations"]["m2"] == ("h0", "a0")
    assert migrated["endpoints"]["before"] == migrated["endpoints"]["after"] \
        == (migrated["public"], migrated["vports"]["m2"])
    assert tchaos.fleet_survivor_violations(migrated, control, ["m0", "m1", "m3"]) == []
    assert tchaos.fleet_recovery_violations(migrated, ["m2"]) == []
    assert migrated["registry"].value("ggrs_placement_migrations_total", reason="manual") == 1


def test_host_kill_fails_over_behind_unchanged_endpoints(worlds):
    killed, control = worlds[("port", "host_kill")], worlds[("port", "control")]
    assert not killed["lost"]
    for mid in H1_MATCHES:
        assert killed["locations"][mid] == ("h0", "a0")
        assert 0 <= killed["peer_frames"][mid] - killed["frames"][mid] <= 12
    assert tchaos.fleet_survivor_violations(killed, control, H0_MATCHES) == []
    assert tchaos.fleet_recovery_violations(killed, H1_MATCHES) == []
    assert killed["vports"] == control["vports"]
    hz = killed["healthz"]
    assert hz["route_epoch"] == 2
    assert hz["hosts"]["h1"] == {"ok": False, "state": "dead"}
    for v, stream in enumerate(killed["viewer_streams"]):
        frames = [f for f, _ in stream]
        assert frames == sorted(set(frames)) and frames[-1] >= KILL_AT + 12, v


def test_placement_healthz_renders_in_fleet_top(worlds):
    killed = worlds[("port", "host_kill")]
    spec = importlib.util.spec_from_file_location(
        "fleet_top", Path(__file__).resolve().parents[1] / "scripts" / "fleet_top.py")
    fleet_top = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fleet_top)
    frame = fleet_top.render(killed["healthz"], json_snapshot(killed["registry"]))
    assert "INGRESS" in frame and "h0/a0" in frame and "h1/b0" in frame
    assert "route_epoch=2" in frame
    assert killed["healthz"]["shards"]["h0/a0"]["ingress_routes"] == 4


# -- the host kill with executors -----------------------------------------------------


class _JaxHost:
    """The JAX executor behind the world's ``fulfill`` interface."""

    programs = None
    made = []

    def __init__(self):
        _JaxHost.made.append(self)
        if _JaxHost.programs is None:
            game = JaxBoxGame(2)
            _JaxHost.programs = (game, JaxPrograms(game.advance))
        game, programs = _JaxHost.programs
        self.ex = JaxExecutor(game.advance, game.init_state(),
                              lambda pairs: jnp.asarray(np.asarray([v for v, _ in pairs], np.uint8)),
                              programs=programs)
        self.saved = []

    def fulfill(self, requests):
        self.ex.run(requests)
        self.saved += [(r.frame, r.cell.checksum) for r in requests
                       if type(r).__name__ == "SaveGameState"]

    @property
    def state(self):
        return self.ex.state


class _PortGame(tchaos.ExecutorGame):
    """``ExecutorGame`` on the CPU, recording what the world builds (a
    module-level class: journal failover pickles the factory)."""

    made = []

    def __init__(self):
        super().__init__("boxgame", 2, device="cpu")
        _PortGame.made.append(self)


def test_host_kill_with_executors_matches_jax(tmp_path, monkeypatch):
    template = JaxBoxGame(2).init_state_np()
    admit = jsup.ShardSupervisor.admit
    monkeypatch.setattr(jsup.ShardSupervisor, "admit",
                        lambda self, *a, **kw: admit(self, *a, **dict(kw, state_template=template)))
    monkeypatch.setattr(jchaos, "CrcGame", _JaxHost)
    monkeypatch.setattr(_JaxHost, "made", [])
    jax_ctx = _world("jax", "host_kill", str(tmp_path))
    monkeypatch.setattr(_PortGame, "made", [])
    port = _world("port", "host_kill", str(tmp_path), game_factory=_PortGame,
                  peer_game_factory=_PortGame, state_template=template)
    hosts = dict(zip(port["match_ids"], _PortGame.made[0::2]))
    peers = dict(zip(port["match_ids"], _PortGame.made[1::2]))
    jax_hosts = dict(zip(jax_ctx["match_ids"], _JaxHost.made[0::2]))
    jax_peers = dict(zip(jax_ctx["match_ids"], _JaxHost.made[1::2]))
    # every failed-over match resumed through a numpy checkpoint Load
    assert {m: h.host_loads for m, h in hosts.items()} == \
        {m: int(m in H1_MATCHES) for m in port["match_ids"]}
    for mine, theirs in ((hosts, jax_hosts), (peers, jax_peers)):
        for mid, game in mine.items():
            assert (game.last_save.frame, game.last_save.checksum) == theirs[mid].saved[-1], mid
    for field in ("wire", "reqs", "host_events", "peer_events", "viewer_streams", "locations",
                  "lost", "frames"):
        assert neutral(port[field]) == neutral(jax_ctx[field]), field
    assert tchaos.fleet_recovery_violations(port, H1_MATCHES) == []
    for mid in port["match_ids"]:
        for got, want in ((port["states"][mid], jax_ctx["states"][mid]),
                          (port["peer_states"][mid], jax_ctx["peer_states"][mid])):
            got, want = to_numpy(got), jax.device_get(want)
            for k in want:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{mid} {k}")
