"""The port's in-process fleet (``fleet/placement``, ``tuning``, ``rpc``,
``shard``, ``supervisor`` and ``chaos.drive_fleet_chaos``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_fleet.py`` and ``tests/test_fleet_rpc.py``: the same
seeded inputs go through both packages and everything that comes out is
compared exactly (wire bytes, request lists, events, viewer streams,
placements, frames, game states).  The fleet worlds run at 2 matches a
shard for 48 ticks: control, kill ``s1``, drain ``s1`` and a live migration
of ``m0`` under loss with one viewer.  Then the kill again with every match
fulfilled by executors (the port's ``DeviceRequestExecutor`` on the CPU
against the JAX executor): failover loads a numpy checkpoint into the
executor, and the two packages must agree bit for bit.  No test reads a
verdict derived from the wall clock (``healthz()["ok"]``, tick ages, tick
p99): those fields are left out of every comparison."""

from __future__ import annotations

import dataclasses
import enum
import importlib
import importlib.util
import inspect
import pickle
import random
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggrs_tpu.chaos as jchaos
import ggrs_tpu.fleet as jfleet
import ggrs_tpu.fleet.rpc as jrpc
import ggrs_tpu.fleet.supervisor as jsup
import ggrs_tpu.broadcast.journal as jjournal
import ggrs_tpu.core.errors as jerrors
import ggrs_tpu.obs as jobs
import ggrs_tpu_torch
import ggrs_tpu_torch.chaos as tchaos
import ggrs_tpu_torch.fleet as tfleet
import ggrs_tpu_torch.fleet.rpc as trpc
import ggrs_tpu_torch.broadcast.journal as tjournal
import ggrs_tpu_torch.core.errors as terrors
import ggrs_tpu_torch.obs as tobs
from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.ops import DeviceRequestExecutor as JaxExecutor
from ggrs_tpu.ops import ExecutorPrograms as JaxPrograms
from ggrs_tpu_torch import to_numpy

PKGS = {
    "jax": dict(chaos=jchaos, fleet=jfleet, rpc=jrpc, journal=jjournal, obs=jobs, errors=jerrors),
    "port": dict(chaos=tchaos, fleet=tfleet, rpc=trpc, journal=tjournal, obs=tobs,
                 errors=terrors),
}
TICKS, PER_SHARD = 48, 2
LOSSY = dict(latency_ticks=1, loss=0.05, duplicate=0.02, reorder=0.05)
FIELDS = ("wire", "reqs", "host_events", "peer_events", "viewer_streams", "locations", "lost",
          "frames", "states", "peer_states")
# healthz fields that come from the wall clock
CLOCK_FIELDS = ("last_tick_age_s", "tick_p99_ms", "ok", "slo", "max_proc_heartbeat_age_s")


def neutral(x):
    """A package-neutral value: enums by name, events and other objects by
    class name and fields, arrays and tensors by dtype, shape and bytes."""
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, dict):
        return {neutral(k): neutral(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [neutral(v) for v in x]
    if isinstance(x, torch.Tensor):
        return neutral(x.numpy())
    if isinstance(x, jax.Array):
        return neutral(np.asarray(x))
    if isinstance(x, np.ndarray):
        if x.ndim == 0:
            return x.item()
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return x.item()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, neutral({f.name: getattr(x, f.name)
                                           for f in dataclasses.fields(x)}))
    if isinstance(x, (int, float, str, bytes, bool)) or x is None:
        return x
    return (type(x).__name__, neutral(vars(x)))


# -- placement, tuning, rpc framing ------------------------------------------------


@pytest.mark.parametrize("shards", [("s0", "s1"), tuple(f"shard{k}" for k in range(7))])
def test_hash_ring_places_1000_keys_like_jax(shards):
    keys = [f"m{k}" for k in range(1000)]
    out = {}
    for name, p in PKGS.items():
        ring = p["fleet"].HashRing(shards)
        owners = [ring.owner(k) for k in keys]
        prefs = [list(ring.preference(k)) for k in keys[:100]]
        ring.remove(shards[0])
        moved = [ring.owner(k) for k in keys]
        ring.add("late")
        out[name] = (owners, prefs, moved, [ring.owner(k) for k in keys], ring.shards(), len(ring))
    assert out["port"] == out["jax"]
    assert len(set(out["port"][0])) == len(shards)


def test_fleet_tuning_from_the_same_environment():
    env = {"GGRS_FLEET_HEARTBEAT_INTERVAL_S": "0.25", "GGRS_FLEET_RESTART_MAX": "7",
           "GGRS_FLEET_LINK_AUTH_TOKEN": "tok", "GGRS_FLEET_UNRELATED": "x"}
    got = {name: p["fleet"].FleetTuning.from_env(env, drain_deadline_s=3.5).as_dict()
           for name, p in PKGS.items()}
    assert got["port"] == got["jax"] and got["port"]["restart_max"] == 7
    assert tfleet.FleetTuning.from_dict(got["port"]).as_dict() == got["port"]
    errors = {}
    for name, p in PKGS.items():
        with pytest.raises(ValueError) as e:
            p["fleet"].FleetTuning.from_env({"GGRS_FLEET_RESTART_MAX": "many"})
        errors[name] = str(e.value)
    assert errors["port"] == errors["jax"]


def test_rpc_frames_are_the_jax_bytes():
    rng = random.Random(5)
    payloads = [bytes(rng.randrange(256) for _ in range(n)) for n in (0, 1, 17, 4096)]
    for kind in (trpc.KIND_CALL, trpc.KIND_REPLY, trpc.KIND_ERR, trpc.KIND_HEARTBEAT,
                 trpc.KIND_GOODBYE):
        for payload in payloads:
            assert trpc.encode_frame(kind, payload) == jrpc.encode_frame(kind, payload)
    assert trpc.PICKLE_PROTOCOL == jrpc.PICKLE_PROTOCOL and trpc.HEADER_SIZE == jrpc.HEADER_SIZE
    for name, p in PKGS.items():
        with pytest.raises(p["rpc"].FrameError):
            p["rpc"].encode_frame(99, b"")
        with pytest.raises(p["rpc"].FrameError):
            p["rpc"].encode_frame(p["rpc"].KIND_CALL, bytes(9), max_frame=8)


@pytest.mark.parametrize("client,server", [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_rpc_call_and_error_over_a_socketpair(client, server):
    a, b = socket.socketpair()
    conn, peer = PKGS[client]["rpc"].RpcConn(a), PKGS[server]["rpc"].RpcConn(b)
    srpc = PKGS[server]["rpc"]

    def serve():
        for _ in range(2):
            kind, msg = peer.recv(timeout=10)
            assert kind == srpc.KIND_CALL
            peer.send(srpc.KIND_HEARTBEAT, dict(ticks=1))
            if msg["op"] == "tick":
                peer.send(srpc.KIND_REPLY, dict(_cid=msg["_cid"], _r={"frames": {"m0": 31}}))
            else:
                peer.send(srpc.KIND_ERR, dict(_cid=msg["_cid"], type="InvalidRequest",
                                              msg="nope", traceback="tb"))

    t = threading.Thread(target=serve)
    t.start()
    try:
        assert conn.call("tick", timeout=10, inputs=[("m0", 0, 7)]) == {"frames": {"m0": 31}}
        with pytest.raises(PKGS[client]["rpc"].RpcRemoteError) as e:
            conn.call("admit", timeout=10)
        assert (e.value.type_name, e.value.msg, e.value.traceback_text) == ("InvalidRequest", "nope", "tb")
        assert conn.rx_seq == 4 and conn.tx_seq == 2 and conn.poisoned is None
    finally:
        t.join(timeout=10)
        conn.close(), peer.close()
    assert not t.is_alive()


# -- the shard ------------------------------------------------------------------------


def _shard_world(pkg, tmp_path, ticks=40):
    """Two journaled bank matches on one PoolShard, then a late admission,
    a checkpoint, the wire identity and an eviction."""
    p = PKGS[pkg]
    chaos, clock = p["chaos"], [0]
    shard = p["fleet"].PoolShard("x", capacity=4, metrics=p["obs"].Registry(),
                                 checkpoint_every=8)
    peers, nets, games, peer_games = {}, {}, {}, {}
    tiers = []
    for k, mid in enumerate(("m0", "m1")):
        net = chaos.InMemoryNetwork(latency_ticks=1, seed=40 + k)
        host = chaos.RecordingSocket(net.socket(f"H{k}"))
        journal = p["journal"].MatchJournal(tmp_path / f"{pkg}-{mid}.ggjl", 2, 2)
        tiers.append(shard.admit(mid, chaos.two_peer_builder(clock, 3 + k, 0, f"P{k}"), host,
                                 journal=journal))
        peers[mid] = chaos.two_peer_builder(clock, 9 + k, 1, f"H{k}", other_handle=0) \
            .start_p2p_session(net.socket(f"P{k}"))
        nets[mid], games[mid], peer_games[mid] = net, chaos.CrcGame(), chaos.CrcGame()
    sealed_before = shard.sealed
    reqs = []
    for i in range(ticks):
        clock[0] += 16
        for k, (mid, peer) in enumerate(peers.items()):
            try:
                peer.add_local_input(1, (i * 3 + k) % 16)
                peer_games[mid].fulfill(peer.advance_frame())
            except (p["errors"].NotSynchronized, p["errors"].PredictionThreshold):
                pass
            shard.add_local_input(mid, 0, (i // (2 + k)) % 16)
        out = shard.advance_all()
        for mid, r in sorted(out.items()):
            games[mid].fulfill(r)
            reqs.append((mid, chaos.req_summary(r)))
        for net in nets.values():
            net.tick()
    shard.checkpoint_now("m0")
    identity = shard.wire_identity("m0")
    late = shard.admit("m2", chaos.two_peer_builder(clock, 20, 0, "P2"),
                       chaos.InMemoryNetwork(seed=1).socket("H2"))
    bundle = shard.evict_match("m1")
    shard.flush_journals()
    health = {k: v for k, v in shard.healthz().items() if k not in CLOCK_FIELDS}
    out = dict(tiers=tiers, sealed=(sealed_before, shard.sealed), late=late, reqs=reqs,
               identity=identity, bundle=bundle, health=health,
               frames={m: shard.current_frame(m) for m in ("m0", "m2")},
               events={m: shard.events(m) for m in ("m0",)},
               match_ids=shard.match_ids(), live=shard.live_matches(),
               states={m: g.state for m, g in games.items()},
               journal=(tmp_path / f"{pkg}-m0.ggjl").read_bytes())
    shard.close()
    return out


def test_pool_shard_admission_sealing_eviction_checkpoints_and_identity(tmp_path):
    jax_world = _shard_world("jax", tmp_path)
    port_world = _shard_world("port", tmp_path)
    assert port_world["tiers"] == ["bank", "bank"] and port_world["late"] == "standalone"
    assert port_world["sealed"] == (False, True)
    jb, pb = jax_world.pop("bundle"), port_world.pop("bundle")
    assert pb.keys() == jb.keys()
    assert pickle.loads(pb["state_blob"]) == pickle.loads(jb["state_blob"])
    assert neutral({k: v for k, v in pb.items() if k != "state_blob"}) == neutral(
        {k: v for k, v in jb.items() if k != "state_blob"})
    for key in jax_world:
        assert neutral(port_world[key]) == neutral(jax_world[key]), key
    parsed = tjournal.read_journal(tmp_path / "port-m0.ggjl")
    assert parsed["checkpoints"] and parsed["frames"]


# -- the fleet worlds ---------------------------------------------------------------


def _scenario(name):
    """(inject, drive_fleet_chaos keywords) of one fleet scenario."""
    def inject(i, ctx):
        if name == "kill" and i == TICKS // 2:
            ctx["sup"].kill("s1")
        elif name == "drain" and i == TICKS // 3:
            ctx["sup"].drain("s1")
        elif name == "migrate" and i == TICKS // 3:
            ctx["sup"].migrate("m0")

    kw = dict(fault_cfg=dict(LOSSY), n_spectators=1) if name in ("lossy", "migrate") else {}
    return (inject if name in ("kill", "drain", "migrate") else None), kw


def _fleet(pkg, name, tmp_path, **extra):
    inject, kw = _scenario(name)
    jdir = tmp_path / f"{pkg}-{name}"
    jdir.mkdir()
    ctx = PKGS[pkg]["chaos"].drive_fleet_chaos(TICKS, matches_per_shard=PER_SHARD, seed=7,
                                                 inject=inject, journal_dir=str(jdir), **kw,
                                                 **extra)
    ctx["sup"].close()
    return ctx


def _assert_fields_equal(port, jax_ctx):
    for field in FIELDS:
        assert neutral(port[field]) == neutral(jax_ctx[field]), field
    assert port["peer_frames"] == jax_ctx["peer_frames"]
    assert port["match_ids"] == jax_ctx["match_ids"]


@pytest.fixture(scope="module")
def controls(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet_controls")
    return {(pkg, name): _fleet(pkg, name, tmp) for pkg in PKGS for name in ("control", "lossy")}


@pytest.mark.parametrize("name", ["control", "lossy"])
def test_fleet_controls_match_jax(controls, name):
    port, jax_ctx = controls[("port", name)], controls[("jax", name)]
    _assert_fields_equal(port, jax_ctx)
    assert tchaos.fleet_recovery_violations(port, port["match_ids"]) == []
    assert port["lost"] == {} and all(f == TICKS for f in port["frames"].values())


@pytest.mark.parametrize("name", ["kill", "drain", "migrate"])
def test_fleet_scenario_matches_jax(controls, name, tmp_path):
    runs = {pkg: _fleet(pkg, name, tmp_path) for pkg in PKGS}
    _assert_fields_equal(runs["port"], runs["jax"])
    survivors = [f"m{k}" for k in range(PER_SHARD)]
    affected = [f"m{k}" for k in range(PER_SHARD, 2 * PER_SHARD)]
    for pkg, p in PKGS.items():
        ctx = runs[pkg]
        if name == "migrate":
            base = controls[(pkg, "lossy")]
            untouched = [m for m in ctx["match_ids"] if m != "m0"]
            bad = p["chaos"].fleet_survivor_violations(ctx, base, untouched)
            bad += p["chaos"].fleet_recovery_violations(ctx, ["m0"])
            assert ctx["locations"]["m0"] != base["locations"]["m0"]
            frames = [f for f, _ in ctx["viewer_streams"][0]]
            assert frames == sorted(set(frames)) and frames[-1] > TICKS // 3
        else:
            base = controls[(pkg, "control")]
            bad = p["chaos"].fleet_survivor_violations(ctx, base, survivors)
            bad += p["chaos"].fleet_recovery_violations(
                ctx, affected, dead_shards=["s1"] if name == "kill" else [])
        assert bad == [], (pkg, bad)
    if name == "drain":
        assert runs["port"]["sup"].shards["s1"].state == "retired"
    health = {k: v for k, v in runs["port"]["healthz"].items() if k not in CLOCK_FIELDS + ("shards",)}
    assert health == {k: v for k, v in runs["jax"]["healthz"].items()
                      if k not in CLOCK_FIELDS + ("shards",)}


def test_fleet_exposition_and_digest_match_jax(controls):
    texts = {}
    for pkg, p in PKGS.items():
        ctx = controls[(pkg, "control")]
        text = p["obs"].prometheus_text(ctx["sup"].merged_registry())
        assert p["obs"].validate_exposition(text) == []
        # the tick-time families hold wall-clock observations
        texts[pkg] = [ln for ln in text.splitlines()
                      if "seconds" not in ln and "_ms" not in ln and "slo_" not in ln]
    assert texts["port"] == texts["jax"]
    digests = {pkg: p["obs"].fleet_metrics_digest(controls[(pkg, "control")]["sup"])
               for pkg, p in PKGS.items()}
    assert digests["port"] == digests["jax"]


# -- the kill with executors: a journal checkpoint loaded into the executor -------


class _JaxHost:
    """The JAX executor behind the chaos world's ``fulfill`` interface; the
    world makes one per host and one per peer, in match order."""

    programs = None
    made = []

    def __init__(self):
        _JaxHost.made.append(self)
        game = JaxBoxGame(2)
        if _JaxHost.programs is None:
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


class _PortHost(tchaos.ExecutorGame):
    def __init__(self):
        super().__init__("boxgame", 2, device="cpu")
        self.saved = []

    def fulfill(self, requests):
        super().fulfill(requests)
        self.saved += [(r.frame, r.cell.checksum) for r in requests
                       if type(r).__name__ == "SaveGameState"]


def test_kill_with_executors_matches_jax(tmp_path, monkeypatch):
    # the JAX world hard-codes its CrcGame and a scalar state template; the
    # test swaps in JAX executors and BoxGame's numpy initial state
    template = JaxBoxGame(2).init_state_np()
    admit = jsup.ShardSupervisor.admit
    monkeypatch.setattr(jsup.ShardSupervisor, "admit",
                        lambda self, *a, **kw: admit(self, *a, **dict(kw, state_template=template)))
    monkeypatch.setattr(jchaos, "CrcGame", _JaxHost)
    monkeypatch.setattr(_JaxHost, "made", [])
    jax_ctx = _fleet("jax", "kill", tmp_path)
    jax_hosts = dict(zip(jax_ctx["match_ids"], _JaxHost.made[0::2]))
    jax_peers = dict(zip(jax_ctx["match_ids"], _JaxHost.made[1::2]))

    port_hosts, peer_hosts = {}, {}

    def host(mid):
        port_hosts[mid] = _PortHost()
        return port_hosts[mid]

    def peer(mid):
        peer_hosts[mid] = _PortHost()
        return peer_hosts[mid]

    port = _fleet("port", "kill", tmp_path, game_factory=host, peer_game_factory=peer,
                  state_template=template)
    for field in ("wire", "reqs", "host_events", "peer_events", "locations", "lost", "frames"):
        assert neutral(port[field]) == neutral(jax_ctx[field]), field
    affected = [f"m{k}" for k in range(PER_SHARD, 2 * PER_SHARD)]
    assert tchaos.fleet_recovery_violations(port, affected, dead_shards=["s1"]) == []
    assert jchaos.fleet_recovery_violations(jax_ctx, affected, dead_shards=["s1"]) == []
    # every failed-over match resumed through a numpy checkpoint Load
    assert all(port_hosts[m].host_loads == 1 for m in affected)
    assert all(port_hosts[m].host_loads == 0 for m in port["match_ids"] if m not in affected)
    for mid in port["match_ids"]:
        got, want = to_numpy(port["states"][mid]), jax.device_get(jax_ctx["states"][mid])
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{mid} {k}")
        peer_got = to_numpy(port["peer_states"][mid])
        peer_want = jax.device_get(jax_ctx["peer_states"][mid])
        for k in peer_want:
            np.testing.assert_array_equal(peer_got[k], np.asarray(peer_want[k]))
    # the saved checksums, host and peer, as the JAX executors computed them
    assert {m: h.saved for m, h in port_hosts.items()} == {m: h.saved for m, h in jax_hosts.items()}
    assert {m: h.saved for m, h in peer_hosts.items()} == {m: h.saved for m, h in jax_peers.items()}
    assert all(len(h.saved) > TICKS for h in port_hosts.values())


def test_process_backed_shard_is_refused_naming_the_next_slice():
    """Once the stub that refused ``proc_shards`` until the process fleet
    was ported; now a ``proc_shards`` supervisor spawns the port's runner
    and closes with no orphan, and ``tcp_shards`` must still be a subset of
    ``proc_shards`` (the twin of ``tests/test_fleet_link.py``'s check)."""
    sup = tfleet.ShardSupervisor(("s0", "s1"), proc_shards=("s1",), metrics=tobs.Registry())
    shard = sup.shards["s1"]
    try:
        assert isinstance(shard, tfleet.ProcShard) and shard.backend == "proc"
        assert shard.pid and shard._proc.poll() is None
        with open(f"/proc/{shard.pid}/cmdline", "rb") as f:
            assert b"port_shard_runner.py" in f.read()
    finally:
        sup.close()
    assert shard.orphan_count() == 0 and shard.last_exit == "exit code 0"
    with pytest.raises(ValueError, match="subset of proc_shards"):
        tfleet.ShardSupervisor(("s0",), tcp_shards=("s0",))


# -- the package's public names (C4) -------------------------------------------------

# names the port leaves out on purpose: the Pallas kernel's (its port is
# ``csrc/digest.cu`` behind ``state_digest``)
EXCLUDED = {"ops": {"leaf_digest_pallas", "use_pallas_checksums"}}
SUBPACKAGES = ("", "analysis", "broadcast", "core", "fleet", "games", "net", "obs", "ops",
               "parallel", "predict", "sessions", "utils")


def _kind(obj):
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "callable" if callable(obj) else "value"


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_public_names_cover_jax(sub):
    jax_mod = importlib.import_module("ggrs_tpu" + (f".{sub}" if sub else ""))
    port_mod = importlib.import_module("ggrs_tpu_torch" + (f".{sub}" if sub else ""))
    want = set(jax_mod.__all__) - EXCLUDED.get(sub, set())
    assert want <= set(port_mod.__all__), sorted(want - set(port_mod.__all__))
    for name in sorted(want):
        assert hasattr(port_mod, name), name
        assert _kind(getattr(port_mod, name)) == _kind(getattr(jax_mod, name)), name


# -- every module's public members (C6) --------------------------------------------

# module-level functions and class members of the JAX package that the port
# leaves out, each with its reason
MEMBER_EXCLUDED = {
    # jax.shard_map's check flags (parallel/batch.py:35): no torch counterpart
    "ggrs_tpu.parallel.batch::shard_map_check_kwargs",
}
# JAX modules with no twin module: the Pallas kernel's, whose port is
# csrc/digest.cu behind ops/digest.py's state_digest
MODULE_EXCLUDED = {"ggrs_tpu.ops.pallas_checksum"}


def _jax_modules():
    import pkgutil

    import ggrs_tpu

    for info in pkgutil.walk_packages(ggrs_tpu.__path__, "ggrs_tpu."):
        spec = importlib.util.find_spec(info.name)
        # Python sources only: the package's built extension modules are not API
        if spec.origin and spec.origin.endswith(".py") and info.name not in MODULE_EXCLUDED:
            yield info.name


def _public_members(cls) -> list:
    """The public methods and properties of ``cls``, inherited ones too."""
    out = []
    for name in dir(cls):
        if name.startswith("_"):
            continue
        raw = inspect.getattr_static(cls, name)
        if isinstance(raw, (property, staticmethod, classmethod)) or callable(raw):
            out.append(name)
    return out


def member_gaps(jax_name: str) -> list:
    """What the port's twin of module ``jax_name`` lacks: public functions
    defined in the module, and public methods and properties of the public
    classes defined there, less ``MEMBER_EXCLUDED``."""
    jax_mod = importlib.import_module(jax_name)
    port_mod = importlib.import_module("ggrs_tpu_torch" + jax_name[len("ggrs_tpu"):])
    gaps = []
    for name, obj in vars(jax_mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != jax_name:
            continue
        if inspect.isfunction(obj):
            wanted = [name]
        elif inspect.isclass(obj):
            twin = getattr(port_mod, name, None)
            if not inspect.isclass(twin):
                gaps.append(name)
                continue
            wanted = [f"{name}.{m}" for m in _public_members(obj)
                      if not hasattr(twin, m)]
            gaps += [w for w in wanted if f"{jax_name}::{w}" not in MEMBER_EXCLUDED]
            continue
        else:
            continue
        gaps += [w for w in wanted if not hasattr(port_mod, w)
                 and f"{jax_name}::{w}" not in MEMBER_EXCLUDED]
    return gaps


@pytest.mark.parametrize("jax_name", sorted(_jax_modules()))
def test_public_members_cover_jax(jax_name):
    assert member_gaps(jax_name) == []


def test_member_exclusions_are_still_needed():
    # an exclusion the port has since added, or one the JAX package dropped,
    # would hide nothing: keep the table honest
    for entry in MEMBER_EXCLUDED:
        mod, member = entry.split("::")
        assert hasattr(importlib.import_module(mod), member), entry
        port = importlib.import_module("ggrs_tpu_torch" + mod[len("ggrs_tpu"):])
        assert not hasattr(port, member), entry


def test_top_level_reexports_the_core():
    from ggrs_tpu_torch import NULL_FRAME, SyncLayer, TimeSync  # noqa: F401
    import ggrs_tpu_torch.core as tcore

    for name in tcore.__all__:
        assert getattr(ggrs_tpu_torch, name) is getattr(tcore, name), name
