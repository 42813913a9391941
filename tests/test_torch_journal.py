"""The port's match journal, replay session and scrub against the JAX
package's, on the CPU.

- ``MatchJournal`` files are byte-identical to the JAX package's for the same
  FRAME, GAP, LOCAL and CLOSE records (a checkpoint's npz blob carries zip
  timestamps, so checkpoints are compared after ``loads_pytree``), also
  when a write fault degrades the journal mid-match;
- each package's ``read_journal`` reads the other's files, and both recover
  the same prefix of a torn or bit-flipped file;
- ``ReplaySession`` re-emits the JAX ``ReplaySession``'s stream, and seeks to
  the same embedded checkpoint;
- ``build_scrub_program`` equals per-frame playback and the JAX scrub;
- a ``JournalTap`` grafted onto a port ``P2PSession`` writes the bytes a JAX
  tap writes on the JAX session under the same seeds, and the recorded
  match replays to the live peer's state.

Tolerance: exactly 0 (bytes, integer states)."""

import random
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ggrs_tpu.broadcast.journal as jjournal
import ggrs_tpu.core as jcore
import ggrs_tpu.games as jgames
import ggrs_tpu.net as jnet
import ggrs_tpu.sessions as jsessions
from ggrs_tpu.obs.registry import Registry as JaxRegistry
from ggrs_tpu.ops.replay import build_scrub_program as jax_build_scrub_program
from ggrs_tpu.utils.checkpoint import loads_pytree as jax_loads_pytree

import ggrs_tpu_torch.broadcast.journal as tjournal
import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.games as tgames
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.sessions as tsessions
from ggrs_tpu_torch import DeviceRequestExecutor, build_scrub_program, from_numpy, to_numpy
from ggrs_tpu_torch.obs.registry import Registry
from ggrs_tpu_torch.utils.checkpoint import loads_pytree

from test_torch_p2p import _assert_states_equal
from test_torch_rtscmd import schedule

PKGS = {
    "jax": dict(journal=jjournal, core=jcore, games=jgames, net=jnet, sessions=jsessions,
                registry=JaxRegistry),
    "port": dict(journal=tjournal, core=tcore, games=tgames, net=tnet, sessions=tsessions,
                 registry=Registry),
}
ISIZE = 2  # Config.for_uint(16)


def _u16(v):
    return int(v).to_bytes(2, "little")


def _write_script(pkg, path, checkpoint=None, fault_after=None):
    """The same records through either package: frames with a disconnected
    player, a duplicate delivery, a gap, staged LOCAL inputs, an optional
    checkpoint, a close."""
    m = PKGS[pkg]
    j = m["journal"].MatchJournal(path, 2, ISIZE, meta={"game": "box", "seed": 7},
                                  metrics=m["registry"](), tail_window=8)
    if fault_after is not None:
        count = [0]

        def fault(stage):
            count[0] += stage == "write"
            if count[0] > fault_after:
                raise OSError(28, "No space left on device")
        j._inject_fault = fault
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 2**16, size=(40, 2))
    for f in range(10):
        j.append_frames(f, [(bytes(2), _u16(rows[f, 0]) + _u16(rows[f, 1]))])
    j.append_frames(8, [(bytes(2), b"\0" * 4)] * 3)  # 8, 9 again, then 10
    j.append_local_input(11, 0, _u16(rows[11, 0]))
    j.append_local_input(12, 0, _u16(rows[12, 0]))
    j.flush_local()
    if checkpoint is not None:
        j.append_checkpoint(11, checkpoint, meta={"who": pkg})
    j.append_frames(11, [(bytes([0, 1]), _u16(rows[f, 0]) + b"\0\0") for f in range(11, 20)])
    j.append_frames(24, [(bytes(2), _u16(rows[f, 0]) + _u16(rows[f, 1])) for f in range(24, 40)])
    j.flush(fsync=True)
    j.close()
    j.close()  # idempotent
    return j


def test_journal_bytes_identical_to_jax(tmp_path):
    jj = _write_script("jax", tmp_path / "j.ggjl")
    tj = _write_script("port", tmp_path / "t.ggjl")
    assert (tmp_path / "t.ggjl").read_bytes() == (tmp_path / "j.ggjl").read_bytes()
    assert list(tj.tail) == list(jj.tail) and tj.next_frame == jj.next_frame == 40
    assert tj._disc == jj._disc and tj._last == jj._last
    assert tj.failed is None and jj.failed is None


def test_journal_metrics_count_what_was_written(tmp_path):
    reg = Registry()
    j = tjournal.MatchJournal(tmp_path / "m.ggjl", 2, ISIZE, metrics=reg)
    j.append_frames(0, [(bytes(2), b"\1\0\2\0")] * 3)
    j.append_frames(5, [(bytes(2), b"\1\0\2\0")])
    j.append_checkpoint(6, {"a": np.arange(3)})
    j.close()
    assert reg.value("ggrs_journal_frames_total") == 4
    assert reg.value("ggrs_journal_gaps_total") == 1
    assert reg.value("ggrs_journal_checkpoints_total") == 1
    assert reg.value("ggrs_journal_bytes_total") == (tmp_path / "m.ggjl").stat().st_size
    assert reg.value("ggrs_journal_write_failures_total") == 0


@pytest.mark.parametrize("fault_after", [0, 3, 12])
def test_write_failure_degrades_like_jax(tmp_path, fault_after):
    jj = _write_script("jax", tmp_path / "j.ggjl", fault_after=fault_after)
    tj = _write_script("port", tmp_path / "t.ggjl", fault_after=fault_after)
    assert tj.failed is not None and jj.failed is not None
    assert (tmp_path / "t.ggjl").read_bytes() == (tmp_path / "j.ggjl").read_bytes()
    parsed = tjournal.read_journal(tmp_path / "t.ggjl")
    assert not parsed["closed"] and len(parsed["frames"]) == min(fault_after, 11)


def test_checkpoints_cross_load(tmp_path):
    state = {"pos": np.arange(6, dtype=np.int32).reshape(3, 2), "rot": np.float32(1.5)}
    _write_script("jax", tmp_path / "j.ggjl", checkpoint=jax.tree_util.tree_map(jnp.asarray, state))
    _write_script("port", tmp_path / "t.ggjl", checkpoint=from_numpy(state, "cpu"))
    for reader in (tjournal.read_journal, jjournal.read_journal):
        (jf, jblob), = reader(tmp_path / "j.ggjl")["checkpoints"]
        (tf, tblob), = reader(tmp_path / "t.ggjl")["checkpoints"]
        assert jf == tf == 11
        for load in (loads_pytree, jax_loads_pytree):
            for blob, who in ((jblob, "jax"), (tblob, "port")):
                got, meta = load(blob, state)
                assert meta == {"who": who, "frame": 11}
                _assert_states_equal(got, state)
    # everything but the checkpoint payload is the same bytes
    j, t = (jjournal.read_journal(tmp_path / n) for n in ("j.ggjl", "t.ggjl"))
    assert {k: v for k, v in j.items() if k != "checkpoints"} == \
           {k: v for k, v in t.items() if k != "checkpoints"}


def _damaged(data, how):
    if how.startswith("cut"):
        return data[: len(data) * int(how[3:]) // 100]
    out = bytearray(data)
    out[len(out) * int(how[4:]) // 100] ^= 0xFF
    return bytes(out)


@pytest.mark.parametrize("how", ["cut35", "cut70", "cut99", "flip40", "flip80", "flip99"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_readers_recover_the_same_prefix(tmp_path, writer, how):
    _write_script(writer, tmp_path / "w.ggjl")
    path = tmp_path / "d.ggjl"
    path.write_bytes(_damaged((tmp_path / "w.ggjl").read_bytes(), how))
    got, want = tjournal.read_journal(path), jjournal.read_journal(path)
    assert got == want
    assert got["truncated"] and not got["closed"] and got["frames"]
    clean = tjournal.read_journal(tmp_path / "w.ggjl")
    assert got["frames"] == clean["frames"][: len(got["frames"])]


def test_reader_errors_match_jax(tmp_path):
    cases = {"magic": b"not a journal", "header": tjournal.MAGIC + b"\x10\0\0\0{}"}
    for name, data in cases.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(jjournal.JournalError) as want:
            jjournal.read_journal(tmp_path / name)
        with pytest.raises(tjournal.JournalError, match=re.escape(str(want.value))):
            tjournal.read_journal(tmp_path / name)
    _write_script("port", tmp_path / "x.ggjl")
    with pytest.raises(FileExistsError):
        tjournal.MatchJournal(tmp_path / "x.ggjl", 2, ISIZE)


def _plain(stream):
    return [(f, tuple((v, s.name) for v, s in inputs)) for f, inputs in stream]


def _drain(rs, exhausted):
    out = []
    try:
        while True:
            for r in rs.advance_frame():
                out.append((rs.current_frame - 1, tuple(r.inputs)))
    except exhausted:
        pass
    return out


def test_replay_session_streams_match_jax(tmp_path):
    state = {"acc": np.arange(2, dtype=np.int64)}
    _write_script("port", tmp_path / "t.ggjl", checkpoint=from_numpy(state, "cpu"))
    rs = tsessions.ReplaySession(tmp_path / "t.ggjl", tcore.Config.for_uint(16))
    jrs = jsessions.ReplaySession(tmp_path / "t.ggjl", jcore.Config.for_uint(16))
    assert (rs.first_frame, rs.last_frame, rs.gaps, rs.closed, rs.truncated) == \
           (jrs.first_frame, jrs.last_frame, jrs.gaps, jrs.closed, jrs.truncated) == (0, 39, [24], True, False)
    assert rs.frames_remaining() == jrs.frames_remaining() == 20
    stream = _drain(rs, tjournal.JournalExhausted)
    assert _plain(stream) == _plain(_drain(jrs, jjournal.JournalExhausted))
    assert len(stream) == 20 and stream[12][1][1] == (0, tcore.InputStatus.DISCONNECTED)
    # seek lands on the embedded checkpoint and replays the same suffix
    assert rs.checkpoint_frames() == jrs.checkpoint_frames() == [11]
    cf, restored, meta = rs.seek(15, template={"acc": np.zeros(2, np.int64)})
    jcf, jrestored, jmeta = jrs.seek(15, template={"acc": np.zeros(2, np.int64)})
    assert cf == jcf == 11 and meta == jmeta == {"who": "port", "frame": 11}
    _assert_states_equal(restored, jrestored)
    _assert_states_equal(restored, state)
    assert _plain(_drain(rs, tjournal.JournalExhausted)) == _plain(_drain(jrs, jjournal.JournalExhausted))
    assert rs.seek(5) == jrs.seek(5) == (0, None, None)
    # a window across the gap raises with the cursor unmoved
    with pytest.raises(tjournal.JournalExhausted):
        rs.stacked_inputs(21)
    assert rs.current_frame == 0
    inputs, statuses = rs.stacked_inputs()
    jinputs, jstatuses = jrs.stacked_inputs()
    assert inputs == jinputs and len(inputs) == 20 == rs.current_frame
    assert [[s.name for s in row] for row in statuses] == [[s.name for s in row] for row in jstatuses]


def test_scrub_matches_per_frame_playback_and_jax(tmp_path):
    """``tests/test_replay_journal.py``'s fused-scrub pin, on the port, and
    the same window through the JAX scrub."""
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 16, size=(96, 2))
    path = tmp_path / "s.ggjl"
    j = tjournal.MatchJournal(path, 2, ISIZE, metrics=Registry(enabled=False))
    for f, row in enumerate(frames):
        j.append_frames(f, [(bytes(2), _u16(row[0]) + _u16(row[1]))])
    j.close()

    def advance(state, inp):  # batch-native: leaves (1, ...)
        return {"pos": state["pos"] + inp.to(torch.int32), "tick": state["tick"] + 1}

    scrub = build_scrub_program(advance, device="cpu")
    init = {"pos": np.zeros(2, np.int32), "tick": np.int32(0)}
    rs = tsessions.ReplaySession(path, tcore.Config.for_uint(16))
    inputs, statuses = rs.stacked_inputs(64)
    assert rs.current_frame == 64
    window = np.asarray(inputs, np.int32)
    fused = scrub(init, window)
    assert fused["tick"].shape == () and int(fused["tick"]) == 64
    ref = {"pos": np.zeros(2, np.int64), "tick": 0}
    rs2 = tsessions.ReplaySession(path, tcore.Config.for_uint(16))
    for _ in range(64):
        (req,) = rs2.advance_frame()
        ref = {"pos": ref["pos"] + np.asarray([v for v, _ in req.inputs]), "tick": ref["tick"] + 1}
    np.testing.assert_array_equal(fused["pos"].numpy(), ref["pos"])
    assert all(s is tcore.InputStatus.CONFIRMED for row in statuses for s in row)
    jscrub = jax_build_scrub_program(
        lambda s, i: {"pos": s["pos"] + i.astype(jnp.int32), "tick": s["tick"] + 1}, donate=False)
    jfused = jscrub(jax.tree_util.tree_map(jnp.asarray, init), jnp.asarray(window))
    _assert_states_equal(to_numpy(fused), jax.device_get(jfused))
    # the argument state is never written
    init_t = from_numpy(init, "cpu")
    scrub(init_t, window)
    assert int(init_t["tick"]) == 0 and not init_t["pos"].any()


# -- a live match, recorded through a JournalTap ---------------------------------


def record_match(pkg, path, frames=120, drain=20, executors=False, net_kw=None):
    """Two peers of one package play RtsCmd over its seeded in-memory network;
    peer A carries a ``JournalTap``.  Each peer's requests are fulfilled by
    its ``RtsCmdGame`` (or, with ``executors``, by an executor: the port's on
    the CPU).  Returns (journal, peers [(session, fulfiller)], live states of
    A by frame over the drain)."""
    m = PKGS[pkg]
    core, games, sessions = m["core"], m["games"], m["sessions"]
    rts = games.RtsCmd(2, num_units=4, max_cmds=4)
    net = m["net"].InMemoryNetwork(**(net_kw or dict(seed=2026, loss=0.05, reorder=0.05,
                                                     latency_ticks=3)))
    now = [0]
    journal = m["journal"].MatchJournal(path, 2, rts.config().native_input_size,
                                        metrics=m["registry"](enabled=False))
    peers = []
    for me, other, h in (("A", "B", 0), ("B", "A", 1)):
        sess = (sessions.SessionBuilder(rts.config()).with_clock(lambda: now[0])
                .with_rng(random.Random(41 + h))
                .with_desync_detection_mode(core.DesyncDetection.on(1))
                .add_player(core.Local(), h).add_player(core.Remote(other), 1 - h)
                .start_p2p_session(net.socket(me)))
        if executors and pkg == "port":
            ful = DeviceRequestExecutor(rts.advance, rts.init_state_np(),
                                        lambda pairs: rts.envelopes_np([v for v, _ in pairs]),
                                        device="cpu")
        else:
            ful = games.RtsCmdGame(rts)
        peers.append((sess, ful))
    peers[0][0].adopt_spectator_endpoint(m["journal"].JournalTap.ADDR,
                                         m["journal"].JournalTap(journal, rts.config()))
    with pytest.raises(core.InvalidRequest):
        peers[0][0].adopt_spectator_endpoint(m["journal"].JournalTap.ADDR, None)
    states = {}
    for i in range(frames + drain):
        for h, (sess, ful) in enumerate(peers):
            sess.poll_remote_clients()
            sess.add_local_input(h, schedule(h, min(sess.current_frame, frames - 1)))
            reqs = sess.advance_frame()
            ful.run(reqs) if hasattr(ful, "run") else ful.handle_requests(reqs)
            assert not any(type(e).__name__ == "DesyncDetected" for e in sess.events())
            if h == 0 and i >= frames:
                states[sess.current_frame] = (to_numpy(ful.state) if hasattr(ful, "run")
                                              else {k: v.copy() for k, v in ful.state.items()})
        net.tick()
        now[0] += 16
    journal.close()
    return journal, peers, states


def test_journal_tap_writes_the_jax_bytes(tmp_path):
    jj, jpeers, _ = record_match("jax", tmp_path / "j.ggjl")
    tj, tpeers, _ = record_match("port", tmp_path / "t.ggjl")
    data = (tmp_path / "t.ggjl").read_bytes()
    assert data == (tmp_path / "j.ggjl").read_bytes()
    assert tj.next_frame == jj.next_frame > 100
    assert [s.current_frame for s, _ in tpeers] == [s.current_frame for s, _ in jpeers]
    parsed = tjournal.read_journal(tmp_path / "t.ggjl")
    assert parsed["closed"] and not parsed["gaps"] and len(parsed["frames"]) == tj.next_frame
    # every record decodes to the schedule's commands
    isize = tgames.RtsCmd(2, 4, 4).config().native_input_size
    decode = tgames.RtsCmd(2, 4, 4).config().input_decode
    for f, flags, blob in parsed["frames"]:
        assert flags == b"\0\0"
        for h in (0, 1):
            assert decode(blob[h * isize:(h + 1) * isize]) == schedule(h, min(f, 119))


def test_recorded_match_replays_to_the_live_state(tmp_path):
    """The port records a match played by CPU executors, then replays it two
    ways -- 64-frame scrub windows and per-frame executor playback -- and
    both reach peer A's live state at the frame the journal ends."""
    journal, peers, states = record_match("port", tmp_path / "m.ggjl", executors=True)
    rts = tgames.RtsCmd(2, 4, 4)
    rs = tsessions.ReplaySession(tmp_path / "m.ggjl", rts.config())
    end = rs.last_frame + 1
    assert end in states  # the drain confirmed every frame of the schedule
    scrub = build_scrub_program(rts.advance, device="cpu")
    state = rts.init_state_np()
    oracle = rts.init_state_np()
    while rs.frames_remaining():
        inputs, _ = rs.stacked_inputs(min(64, rs.frames_remaining()))
        state = scrub(state, np.stack([rts.envelopes_np(row) for row in inputs]))
        for row in inputs:
            oracle = rts.advance_np(oracle, row)
        _assert_states_equal(to_numpy(state), oracle)
    _assert_states_equal(to_numpy(state), states[end])
    rs2 = tsessions.ReplaySession(tmp_path / "m.ggjl", rts.config())
    ex = DeviceRequestExecutor(rts.advance, rts.init_state_np(),
                               lambda pairs: rts.envelopes_np([v for v, _ in pairs]), device="cpu")
    while rs2.frames_remaining():
        ex.run(rs2.advance_frame())
    _assert_states_equal(to_numpy(ex.state), states[end])
