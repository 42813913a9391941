"""The port's operator scripts (``scripts/port_fleet_top.py``,
``port_match_timeline.py``, ``port_floor_probe.py``, ``port_profile_tick.py``)
against the JAX ones.

Each JAX script is loaded by ``importlib`` under its own module name and
given the same inputs as its twin: the dashboards and timelines must print
the same text, the floor probe's loop bodies must leave bitwise the JAX
``lax.scan`` bodies' state, accumulator and ring, and the bank profile must
name the same phases.  Everything runs on the CPU.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ggrs_tpu.chaos import drive_fleet_chaos as jax_drive_fleet_chaos
from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.obs import json_snapshot as jax_json_snapshot
from ggrs_tpu.ops.checksum import CHECKSUM_LANES as JAX_LANES
from ggrs_tpu.ops.checksum import checksum_device as jax_checksum_device
from ggrs_tpu.ops.ring import DeviceStateRing as JaxRing

from ggrs_tpu_torch import BoxGame, to_numpy
from ggrs_tpu_torch.chaos import drive_fleet_chaos
from ggrs_tpu_torch.obs import json_snapshot
from ggrs_tpu_torch.obs.timeline import match_trace_id, timeline_event
from ggrs_tpu_torch.ops.checksum import CHECKSUM_LANES
from ggrs_tpu_torch.ops.ring import DeviceStateRing
from ggrs_tpu_torch.utils.tree import tree_map

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kill_s1(i, ctx):
    if i == 12:
        ctx["sup"].kill("s1")


@pytest.fixture(scope="module")
def fleet_docs(tmp_path_factory):
    """(healthz, metrics JSON snapshot, timelines) of a JAX and of a port
    in-process fleet, each after 24 ticks of 2 matches a shard with shard
    ``s1`` killed at tick 12 (its matches fail over onto ``s0``)."""
    docs = {}
    for name, drive, snapshot in (("jax", jax_drive_fleet_chaos, jax_json_snapshot),
                                  ("port", drive_fleet_chaos, json_snapshot)):
        ctx = drive(24, matches_per_shard=2, seed=5, inject=kill_s1,
                    journal_dir=str(tmp_path_factory.mktemp(name)))
        sup = ctx["sup"]
        try:
            docs[name] = (sup.healthz(), snapshot(sup.merged_registry()),
                          sup.fleet_obs.timelines.to_dict())
        finally:
            sup.close()
    return docs


# -- port_fleet_top ---------------------------------------------------------------


@pytest.mark.parametrize("source", ["jax", "port"])
def test_fleet_top_renders_like_jax(fleet_docs, source):
    fleet_top, port_fleet_top = load_script("fleet_top"), load_script("port_fleet_top")
    healthz, metrics, timelines = fleet_docs[source]
    frame = port_fleet_top.render(healthz, metrics)
    assert frame == fleet_top.render(healthz, metrics)
    assert "s0" in frame and "s1" in frame and "admissions=" in frame
    with_timelines = port_fleet_top.render(healthz, metrics, phases_per_shard=2,
                                           timelines=timelines)
    assert with_timelines == fleet_top.render(healthz, metrics, phases_per_shard=2,
                                              timelines=timelines)
    assert "match timelines (latest events):" in with_timelines


# -- port_match_timeline ------------------------------------------------------------


def timeline_artifact(tmp_path, timelines):
    """A chaos-style artifact: the timelines nested under a leg, plus an
    ingress ROUTE_FLIP keyed on m2's wire trace id (folded into m2)."""
    t0 = min(e["ts_ns"] for evs in timelines.values() for e in evs)
    alias = f"trace:{match_trace_id('m2'):x}"
    flip = timeline_event("ROUTE_FLIP", alias, origin="ingress:i0", tick=7, ts_ns=t0 + 1)
    doc = {"leg": {"timelines": {**timelines, alias: [flip]}}, "seed": 5}
    path = tmp_path / "artifact.json"
    path.write_text(json.dumps(doc))
    return path


def run_main(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [mod.__name__ + ".py", *argv])
    rc = mod.main()
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_match_timeline_prints_like_jax(fleet_docs, tmp_path, monkeypatch, capsys):
    jax_tl, port_tl = load_script("match_timeline"), load_script("port_match_timeline")
    artifact = str(timeline_artifact(tmp_path, fleet_docs["port"][2]))
    listing = run_main(port_tl, ["--artifact", artifact, "--list"], monkeypatch, capsys)
    assert listing == run_main(jax_tl, ["--artifact", artifact, "--list"], monkeypatch, capsys)
    assert listing[0] == 0 and "ADMIT->FAILOVER" in listing[1] and "trace:" not in listing[1]
    args = ["--artifact", artifact, "-m", "m2", "--perfetto"]
    port = run_main(port_tl, args + [str(tmp_path / "port.json")], monkeypatch, capsys)
    want = run_main(jax_tl, args + [str(tmp_path / "jax.json")], monkeypatch, capsys)
    assert port[0] == want[0] == 0
    assert port[1].replace("port.json", "x") == want[1].replace("jax.json", "x")
    assert "ROUTE_FLIP" in port[1] and "origin=ingress:i0" in port[1]
    assert "FAILOVER" in port[1] and "perfetto trace written" in port[1]
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    missing = run_main(port_tl, ["--artifact", artifact, "-m", "nope"], monkeypatch, capsys)
    assert missing == run_main(jax_tl, ["--artifact", artifact, "-m", "nope"], monkeypatch,
                               capsys)
    assert missing[0] == 1


# -- port_floor_probe ------------------------------------------------------------------


@pytest.fixture(scope="module")
def floor_probe():
    return load_script("port_floor_probe")


def probe_inputs(fp):
    steps = 3 * (fp.D + 1)
    return np.random.default_rng(11).integers(0, 16, size=(steps, fp.PLAYERS), dtype=np.uint8)


def jax_scans(fp, inputs):
    """The JAX floor probe's three ``lax.scan`` bodies, as
    ``scripts/floor_probe.py`` writes them, over ``inputs``."""
    game = JaxBoxGame(fp.PLAYERS)
    st0 = jax.tree_util.tree_map(jnp.asarray, game.init_state())
    ring = JaxRing(fp.D + 2)

    def bare_body(st, inp):
        return game.advance(st, inp), None

    def digest_body(carry, inp):
        st, acc = carry
        st = game.advance(st, inp)
        return (st, acc ^ jax_checksum_device(st)), None

    def ring_body(carry, xs):
        st, rbufs = carry
        inp, f = xs
        st = game.advance(st, inp)
        rbufs = ring.save(rbufs, f, st, jax_checksum_device(st))
        return (st, rbufs), None

    inps = jnp.asarray(inputs)
    frames = jnp.arange(len(inputs), dtype=jnp.int32)
    acc0 = jnp.zeros((JAX_LANES,), jnp.uint32)
    return jax.device_get({
        "bare": jax.lax.scan(bare_body, st0, inps)[0],
        "digest": jax.lax.scan(digest_body, (st0, acc0), inps)[0],
        "ring": jax.lax.scan(ring_body, (st0, ring.init(game.init_state())), (inps, frames))[0],
    })


def unbatch(tree):
    return tree_map(lambda a: a[0], to_numpy(tree))


def assert_state_equal(got, want):
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k


def test_floor_probe_bodies_match_jax_scans(floor_probe):
    fp = floor_probe
    inputs = probe_inputs(fp)
    want = jax_scans(fp, inputs)
    game = BoxGame(fp.PLAYERS)
    st0 = tree_map(lambda a: torch.from_numpy(a[None]), game.init_state_np())
    inps = torch.from_numpy(inputs).unsqueeze(1)

    assert_state_equal(unbatch(fp.bare_loop(game, st0, inps)), want["bare"])

    st, acc = fp.digest_loop(game, (st0, torch.zeros((1, CHECKSUM_LANES), dtype=torch.int32)),
                             inps)
    assert_state_equal(unbatch(st), want["digest"][0])
    np.testing.assert_array_equal(acc[0].numpy().view(np.uint32), want["digest"][1])

    ring = DeviceStateRing(fp.D + 2)
    st, rbufs = fp.ring_loop(game, ring, (st0, ring.init(st0)), inps)
    want_st, want_ring = want["ring"]
    assert_state_equal(unbatch(st), want_st)
    assert_state_equal(unbatch(rbufs["states"]), want_ring["states"])
    np.testing.assert_array_equal(rbufs["checksums"][0].numpy().view(np.uint32),
                                  want_ring["checksums"])
    np.testing.assert_array_equal(rbufs["frames"][0].numpy(), want_ring["frames"])


def test_floor_probe_main_prints_rows_and_gate(floor_probe, capsys):
    results = floor_probe.main(ticks_per_dispatch=2, dispatches=1, repeats=1, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "backend=cpu device=cpu"
    assert [line.split()[0] for line in out[1:5]] == list(floor_probe.VARIANTS)
    assert all("us/advance-step" in line for line in out[1:5])
    assert out[5].startswith("verdict: bare loop resim-credit ")
    assert out[-1] == "desync gate green"
    assert sorted(results) == sorted(floor_probe.VARIANTS)


def test_floor_probe_refuses_a_missing_card(floor_probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        floor_probe.main(ticks_per_dispatch=1, dispatches=1, repeats=1)


# -- port_profile_tick ----------------------------------------------------------------

PHASE_LINE = re.compile(r"^\s*((?:pool|bank)\.[a-z_]+|other)\b")


def phase_names(text):
    return sorted(m.group(1) for m in map(PHASE_LINE.match, text.splitlines()) if m)


def test_profile_tick_names_the_jax_phases(monkeypatch, capsys):
    argv = ["--matches", "8", "--ticks", "20"]
    rc, port_out, _ = run_main(load_script("port_profile_tick"), argv, monkeypatch, capsys)
    jax_rc, jax_out, _ = run_main(load_script("profile_tick"), argv, monkeypatch, capsys)
    assert rc == jax_rc == 0
    names = phase_names(port_out)
    assert names == phase_names(jax_out)
    assert {"pool.tick", "bank.crossing", "pool.slot", "other"} <= set(names)
    assert len([n for n in names if n.startswith("bank.") and n != "bank.crossing"]) >= 8
    assert port_out.startswith("# host-bank tick profile: B=8 matches (16 sessions), 20 ticks")
