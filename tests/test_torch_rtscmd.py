"""The port's RtsCmd (command streams in varrec envelopes) against the JAX
package's, on the CPU.

- the command codec and the varrec config give the JAX package's bytes;
- ``advance`` over raw envelope bytes equals the JAX ``advance`` for every
  session of a batch, including streams of 0..max orders, negative dx/dy,
  unknown tags in live slots, odd and oversized length headers and garbage
  past the command count;
- ``advance_np`` and ``RtsCmdGame`` equal the JAX package's;
- a ``SyncTestSession`` fulfilled by the port's ``DeviceRequestExecutor``
  saves the JAX executor's checksums and ends in its state;
- a JAX peer and a port peer play one RtsCmd match over a byte bridge with
  desync detection at every frame, and never desync.

Tolerance: exactly 0 (integer game, integer digest)."""

import random
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ggrs_tpu.core as jcore
import ggrs_tpu.games as jgames
import ggrs_tpu.net.messages as jmsg
import ggrs_tpu.ops as jops
import ggrs_tpu.sessions as jsessions

import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.games as tgames
import ggrs_tpu_torch.net.messages as tmsg
import ggrs_tpu_torch.ops as tops
import ggrs_tpu_torch.sessions as tsessions
from ggrs_tpu_torch import from_numpy, to_numpy

from test_torch_p2p import _Bridge, _assert_states_equal

PKGS = {"jax": (jcore, jgames, jops, jsessions, jmsg), "port": (tcore, tgames, tops, tsessions, tmsg)}


def commands(rng, units=4, most=3, board=64):
    """0..``most`` orders: moves of -2..2 per axis, gathers, builds."""
    out = []
    for _ in range(rng.randrange(0, most + 1)):
        kind = rng.randrange(3)
        if kind == 0:
            out.append(("move", rng.randrange(units), rng.randrange(-2, 3), rng.randrange(-2, 3)))
        elif kind == 1:
            out.append(("gather", rng.randrange(units)))
        else:
            out.append(("build", rng.randrange(board), rng.randrange(board)))
    return tuple(out)


def schedule(handle, frame, most=3):
    return commands(random.Random(9000 + 613 * handle + frame), most=most)


STREAMS = [
    (),
    (("move", 0, -2, 2),),
    (("move", 3, -128, 127), ("gather", 255), ("build", 63, 0)),
    (("build", 7, 9), ("build", 4, 8), ("gather", 1), ("move", 2, 1, -1)),
    (("gather", 0),) * 7,
]


@pytest.mark.parametrize("stream", STREAMS, ids=range(len(STREAMS)))
def test_command_codec_matches_jax(stream):
    blob = tgames.encode_commands(stream)
    assert blob == jgames.encode_commands(stream)
    assert tgames.decode_commands(blob) == jgames.decode_commands(blob)
    for max_cmds in (4, 7):
        if len(stream) > max_cmds:
            continue
        port, jx = tgames.RtsCmd(2, 4, max_cmds), jgames.RtsCmd(2, 4, max_cmds)
        cfg, jcfg = port.config(), jx.config()
        assert cfg.native_input_size == jcfg.native_input_size == 2 + 4 * max_cmds
        assert cfg.input_encode(stream) == jcfg.input_encode(stream)
        assert cfg.input_decode(cfg.input_encode(stream)) == jcfg.input_decode(jcfg.input_encode(stream))
        assert cfg.input_encode(cfg.input_default()) == bytes(cfg.native_input_size)
        pair = [stream, STREAMS[1]]
        np.testing.assert_array_equal(port.envelopes_np(pair), jx.envelopes_np(pair))


@pytest.mark.parametrize("blob", [b"\x01\x00\x00", b"\x09\x00\x00\x00"])
def test_command_decode_errors_match_jax(blob):
    with pytest.raises(ValueError) as want:
        jgames.decode_commands(blob)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        tgames.decode_commands(blob)


def garbage_envelopes(rng, b, players, max_cmds):
    """Raw envelopes ``u8 (b, P, S)``: length headers 0..capacity (odd ones
    included) and sometimes past it, tags 0..5 (unknown ones in live slots),
    random operands (negative i8 steps) and random bytes past the count."""
    cap = 4 * max_cmds
    env = rng.integers(0, 256, size=(b, players, 2 + cap), dtype=np.uint8)
    n = rng.integers(0, cap + 1, size=(b, players))
    n[rng.random((b, players)) < 0.1] = 0xFFFF  # a header claiming too much
    env[..., 0], env[..., 1] = n & 0xFF, n >> 8
    env[..., 2::4] = rng.integers(0, 6, size=env[..., 2::4].shape)  # tags
    return env


@pytest.mark.parametrize("max_cmds", [4, 7])
def test_advance_over_envelopes_matches_jax(max_cmds):
    players, b, frames = 3, 5, 40
    port, jx = tgames.RtsCmd(players, 4, max_cmds), jgames.RtsCmd(players, 4, max_cmds)
    rng = np.random.default_rng(max_cmds)
    init = port.init_state_np()
    st = {k: v.unsqueeze(0).expand(b, *v.shape).clone() for k, v in from_numpy(init, "cpu").items()}
    runs = [jx.init_state() for _ in range(b)]
    adv = jax.jit(jx.advance)
    for f in range(frames):
        env = garbage_envelopes(rng, b, players, max_cmds)
        if f % 2:  # every other frame: well-formed streams of 0..max orders
            pyr = random.Random(f)
            env = np.stack([port.envelopes_np([commands(pyr, most=max_cmds) for _ in range(players)])
                            for _ in range(b)])
        st = port.advance(st, torch.from_numpy(env))
        runs = [adv(s, jnp.asarray(env[i])) for i, s in enumerate(runs)]
    got = to_numpy(st)
    for i, s in enumerate(runs):
        _assert_states_equal({k: v[i] for k, v in got.items()}, jax.device_get(s))
    assert len({int(v) for v in got["built"].ravel()}) > 1  # builds happened, unevenly


def test_oracles_and_game_adapter_match_jax():
    port, jx = tgames.RtsCmd(2, 4, 4), jgames.RtsCmd(2, 4, 4)
    s_t = {k: v.unsqueeze(0) for k, v in from_numpy(port.init_state_np(), "cpu").items()}
    s_o, s_jo = port.init_state_np(), jx.init_state_np()
    game, jgame = tgames.RtsCmdGame(port), jgames.RtsCmdGame(jx)
    for f in range(80):
        streams = [schedule(0, f), schedule(1, f)]
        s_t = port.advance(s_t, torch.from_numpy(port.envelopes_np(streams)[None]))
        s_o, s_jo = port.advance_np(s_o, streams), jx.advance_np(s_jo, streams)
        game.state, jgame.state = s_o, s_jo
        assert game.checksum() == jgame.checksum()
    _assert_states_equal(s_o, s_jo)
    _assert_states_equal({k: v[0] for k, v in to_numpy(s_t).items()}, s_o)


def _executor(pkg, game):
    if pkg == "jax":
        return jops.DeviceRequestExecutor(
            game.advance, game.init_state(),
            lambda pairs: jnp.asarray(game.envelopes_np([v for v, _ in pairs])))
    return tops.DeviceRequestExecutor(
        game.advance, game.init_state_np(),
        lambda pairs: game.envelopes_np([v for v, _ in pairs]), device="cpu")


def _synctest(pkg, check_distance, frames, oracle=False):
    """A SyncTest drive fulfilled by the package's executor, or (``oracle``)
    by its ``RtsCmdGame``: a request list's cells hold one fulfiller's
    states, so each fulfiller gets its own session."""
    core, games, _, sessions, _ = PKGS[pkg]
    game = games.RtsCmd(2, 4, 4)
    sess = (sessions.SessionBuilder(game.config()).with_check_distance(check_distance)
            .start_synctest_session())
    ex = games.RtsCmdGame(game) if oracle else _executor(pkg, game)
    saved = []
    for f in range(frames):
        for h in range(2):
            sess.add_local_input(h, schedule(h, f))
        reqs = sess.advance_frame()
        if oracle:
            ex.handle_requests(reqs)
        else:
            ex.run(reqs)
        saved.append([(r.frame, r.cell.checksum) for r in reqs
                      if isinstance(r, core.SaveGameState)])
    if oracle:
        return saved, ex
    return saved, to_numpy(ex.state) if pkg == "port" else jax.device_get(ex.state)


@pytest.mark.parametrize("check_distance", [1, 4, 7])
def test_synctest_executor_matches_jax(check_distance):
    saved, state = _synctest("port", check_distance, 50)
    jsaved, jstate = _synctest("jax", check_distance, 50)
    assert saved == jsaved
    assert sum(len(s) for s in saved) == (check_distance + 1) + (50 - check_distance - 1) * check_distance
    _assert_states_equal(state, jstate)
    # the host games: the same frames saved, the same end state and checksum
    osaved, game = _synctest("port", check_distance, 50, oracle=True)
    josaved, jgame = _synctest("jax", check_distance, 50, oracle=True)
    assert osaved == josaved
    assert [[f for f, _ in s] for s in osaved] == [[f for f, _ in s] for s in saved]
    _assert_states_equal(state, game.state)
    assert game.frame == 50 and game.checksum() == jgame.checksum()


def test_jax_peer_and_port_peer_play_rtscmd_without_desync():
    """The cross-package gate on variable-size inputs: the varrec envelopes
    cross the bridge in each package's own input codec."""
    bridge, now = _Bridge(latency=2), [0]
    peers = []
    for h, pkg in enumerate(("jax", "port")):
        core, games, _, sessions, msg = PKGS[pkg]
        game = games.RtsCmd(2, 4, 4)
        sess = (sessions.SessionBuilder(game.config()).with_clock(lambda: now[0])
                .with_rng(random.Random(41 + h))
                .with_desync_detection_mode(core.DesyncDetection.on(1))
                .add_player(core.Local(), h).add_player(core.Remote("AB"[1 - h]), 1 - h)
                .start_p2p_session(bridge.socket("AB"[h], msg)))
        peers.append((h, pkg, sess, _executor(pkg, game), core))
    frames, drain, events, loads = 200, 20, [], 0
    for i in range(frames + drain):
        for h, pkg, sess, ex, core in peers:
            sess.poll_remote_clients()
            sess.add_local_input(h, schedule(h, min(sess.current_frame, frames - 1)))
            reqs = sess.advance_frame()
            loads += sum(isinstance(r, core.LoadGameState) for r in reqs)
            ex.run(reqs)
            events += [type(e).__name__ for e in sess.events()]
        bridge.tick()
        now[0] += 16
    assert "DesyncDetected" not in events
    assert loads > 10  # the varrec inputs were mispredicted and rolled back
    (_, _, js, jex, _), (_, _, ts, tex, _) = peers
    assert js.current_frame == ts.current_frame == frames + drain
    assert js._last_sent_checksum_frame > frames and ts._last_sent_checksum_frame > frames
    _assert_states_equal(jax.device_get(jex.state), to_numpy(tex.state))
    oracle = tgames.RtsCmd(2, 4, 4)
    ref = oracle.init_state_np()
    for f in range(frames + drain):
        ref = oracle.advance_np(ref, [schedule(0, min(f, frames - 1)), schedule(1, min(f, frames - 1))])
    _assert_states_equal(to_numpy(tex.state), ref)
