"""The port's in-process chaos worlds (``chaos.py``) against the JAX
package's, on the CPU.

``drive_chaos`` (``tests/test_bank_faults.py``), ``drive_socket_chaos`` and
``drive_dispatch_chaos`` (``scripts/chaos.py --fault socket``),
``drive_desync_forensics`` (``tests/test_desync_detection.py``) and
``drive_broadcast`` (``tests/test_broadcast.py``) run in both packages on
the same arguments, shrunk: the returned wire bytes, request summaries,
events, slot states, frames and viewer streams must be equal, and the
blast-radius verdicts empty in both.  Tolerance: exact equality."""

from __future__ import annotations

import errno
import random

import pytest

import ggrs_tpu.chaos as jchaos
import ggrs_tpu.net._native as jnative
import ggrs_tpu_torch.chaos as tchaos
import ggrs_tpu_torch.net._native as tnative

from test_torch_fleet import neutral

PKGS = {"jax": (jchaos, jnative), "port": (tchaos, tnative)}
FAULTS = dict(loss=0.05, duplicate=0.03, reorder=0.03, latency_ticks=1)
POOL_KEYS = ("wire", "reqs", "events", "states", "frames")


def both(fn, keys):
    """``fn(chaos module, native module)`` in each package; the ``keys`` of
    the returned contexts must be equal.  Returns both contexts."""
    out = {name: fn(*mods) for name, mods in PKGS.items()}
    for key in keys:
        assert neutral(out["port"][key]) == neutral(out["jax"][key]), key
    return out


def _slot_error(code_name=None, tick=30):
    def make(chaos, native):
        def inject(i, ctx):
            if i == tick:
                if code_name is None:
                    ctx["pool"].inject_slot_error(ctx["target"])
                else:
                    ctx["pool"].inject_slot_error(ctx["target"], getattr(native, code_name))
        return inject
    return make


def _junk(chaos, native):
    rng = random.Random(1234)
    junk = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40))) for _ in range(120)]

    def inject(i, ctx):
        if 20 <= i < 40:
            for j in range(3):
                ctx["pool"].inject_datagram(ctx["target"], "X", junk[(i * 3 + j) % len(junk)])
        if i == 45:
            for blob in chaos.MALFORMED_BURST:
                ctx["pool"].inject_datagram(ctx["target"], "X", blob)
    return inject


@pytest.mark.parametrize("case", ["control", "slot_error", "sync_error", "junk", "blackout"])
def test_drive_chaos_matches_jax(case):
    # the blackout needs the peers' 2,000 ms disconnect timer to fire
    ticks = 180 if case == "blackout" else 120

    def run(chaos, native):
        kw = {}
        if case == "slot_error":
            kw["inject"] = _slot_error()(chaos, native)
        elif case == "sync_error":
            kw["inject"] = _slot_error("BANK_ERR_SYNC")(chaos, native)
        elif case == "junk":
            kw["inject"] = _junk(chaos, native)
        elif case == "blackout":
            kw.update(retire=True, ext_alive=lambda i: i < 20)
        ctx = chaos.drive_chaos(ticks, n_matches=3, seed=2, **kw)
        control = chaos.drive_chaos(ticks, n_matches=3, seed=2, retire=case == "blackout")
        target = ctx["target"]
        survivors = [i for i in range(len(ctx["states"])) if i != target]
        ctx["violations"] = chaos.blast_radius_violations(ctx, control, survivors)
        ctx["crossings"] = (ctx["pool"].crossings, ctx["pool"].harvests)
        ctx["faults"] = [f.code for f in ctx["pool"].fault_log(target)]
        ctx["ext_frame"] = ctx["ext"].current_frame
        return ctx

    out = both(run, POOL_KEYS + ("violations", "crossings", "faults", "ext_frame"))
    ctx = out["port"]
    assert ctx["violations"] == [] and ctx["crossings"][0] == ticks
    if case in ("slot_error", "sync_error"):
        assert ctx["states"][ctx["target"]] == "evicted"
    if case == "blackout":
        assert ctx["states"][ctx["target"]] == "dead"


@pytest.mark.parametrize("storm", ["control", "transient", "fatal"])
def test_drive_socket_chaos_matches_jax(storm):
    ticks = 90

    def run(chaos, native):
        def inject(i, ctx):
            if storm == "transient" and 30 <= i < 40:
                ctx["pool"].inject_socket_errno(ctx["target"], errno.ENOBUFS, 4)
            elif storm == "transient" and 40 <= i < 45:
                ctx["pool"].inject_socket_errno(ctx["target"], errno.EAGAIN, 4)
            elif storm == "fatal" and i == 35:
                ctx["pool"].inject_socket_errno(ctx["target"], errno.EPERM, 1)

        ctx = chaos.drive_socket_chaos(ticks, n_matches=2, seed=4, inject=inject)
        ctx["faults"] = [f.code for f in ctx["pool"].fault_log(ctx["target"])]
        ctx["send_errors"] = ctx["io"]["send_errors"]
        return ctx

    out = both(run, POOL_KEYS + ("io_states", "peer_frames", "faults", "send_errors"))
    ctx = out["port"]
    want = {"control": "native", "transient": "native", "fatal": "evicted"}[storm]
    assert ctx["states"][ctx["target"]] == want
    if storm == "transient":
        assert ctx["send_errors"] >= 20


@pytest.mark.parametrize("storm", ["control", "fatal"])
def test_drive_dispatch_chaos_matches_jax(storm):
    ticks = 90

    def run(chaos, native):
        def inject(i, ctx):
            if storm == "fatal" and i == 35:
                ctx["lib"].ggrs_net_inject_table_errno(errno.EPERM, 0, 1)

        ctx = chaos.drive_dispatch_chaos(ticks, n_matches=2, seed=5, inject=inject)
        ctx["faults"] = [f.code for f in ctx["pool"].fault_log(ctx["target"])]
        return ctx

    out = both(run, ("wire", "reqs", "events", "states", "frames", "faults"))
    ctx = out["port"]
    assert ctx["states"][ctx["target"]] == ("evicted" if storm == "fatal" else "native")
    assert all(s == "native" for i, s in enumerate(ctx["states"]) if i != ctx["target"])


@pytest.mark.parametrize("fault_frame,interval", [(1 << 30, 3), (40, 1), (42, 4)])
def test_drive_desync_forensics_matches_jax(fault_frame, interval):
    def run(chaos, native):
        ctx = chaos.drive_desync_forensics(100, fault_frame=fault_frame, interval=interval, seed=1,
                                           fault_cfg=dict(FAULTS, seed=9))
        ctx["reports"] = [[r.to_dict() if hasattr(r, "to_dict") else vars(r) for r in reps]
                          for reps in (ctx["reports_a"], ctx["reports_b"])]
        ctx["grid"] = [sorted(s._local_checksum_history) for s in (ctx["a"], ctx["b"])]
        return ctx

    out = both(run, ("events", "desyncs", "grid"))
    reports = {k: [[{f: v for f, v in r.items() if f not in ("created_at", "wall_time")}
                    for r in reps] for reps in out[k]["reports"]] for k in out}
    assert neutral(reports["port"]) == neutral(reports["jax"])
    if fault_frame < 1 << 30:
        assert out["port"]["desyncs"][0] and out["port"]["desyncs"][1]
    else:
        assert out["port"]["desyncs"] == [[], []]


@pytest.mark.parametrize("case", ["hub", "per_session", "eviction", "journal_kill"])
def test_drive_broadcast_matches_jax(case, tmp_path):
    keys = ("host_wire", "side_wire", "reqs", "events", "viewer_streams", "viewer_frames",
            "states", "frames", "peer_frame")

    def run(chaos, native):
        name = chaos.__name__.split(".")[0]
        kw = dict(fault_cfg=dict(FAULTS, seed=7), n_spectators=2)
        if case == "per_session":
            kw["use_hub"] = False
        elif case == "eviction":
            kw["inject"] = lambda i, ctx: i == 40 and ctx["pool"].inject_slot_error(0)
        elif case == "journal_kill":
            kw = dict(n_side_matches=2, journal_path=tmp_path / f"{name}.ggjl",
                      sabotage_harvest=True,
                      inject=lambda i, ctx: i == 50 and ctx["pool"].inject_slot_error(0))
        ctx = chaos.drive_broadcast(130, seed=3, **kw)
        if ctx.get("journal") is not None:
            ctx["journal"].close()
            ctx["journal_bytes"] = (tmp_path / f"{name}.ggjl").read_bytes()
        return ctx

    out = both(run, keys + (("journal_bytes",) if case == "journal_kill" else ()))
    ctx = out["port"]
    assert ctx["viewer_frames"][0][-1] > 80, "viewer stalled"
    if case in ("eviction", "journal_kill"):
        assert ctx["states"][0] == "evicted"
