"""The plain references equal the port at small sizes on the CPU: the games'
start and step, the digest, and the replay's whole carry."""

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.reference import boxgame, digest, replay
from ggrs_tpu_torch.games.boxgame import BoxGame
from ggrs_tpu_torch.ops.checksum import checksum_device
from ggrs_tpu_torch.parallel.batch import BatchedSessions

BOX = {"players": 2}
GAMES = [
    ("boxgame", boxgame, BOX, lambda: BoxGame(2)),
    ("boxgame4", boxgame, {"players": 4}, lambda: BoxGame(4)),
]


def _i32(state):
    return {k: v.to(torch.int32) for k, v in state.items()}


@pytest.mark.parametrize("name,ref,config,make", GAMES, ids=[g[0] for g in GAMES])
def test_start_equals_the_port(name, ref, config, make):
    port = make().init_state_np()
    mine = ref.init_state(config)
    assert sorted(port) == sorted(mine)
    for k in port:
        assert np.array_equal(port[k], mine[k].numpy().astype(np.int32)), k


@pytest.mark.parametrize("name,ref,config,make", GAMES, ids=[g[0] for g in GAMES])
def test_steps_equal_the_port(name, ref, config, make):
    game = make()
    rng = np.random.default_rng(7)
    b, p = 6, config["players"]
    st = {k: v.expand(b, *v.shape).clone() for k, v in ref.init_state(config).items()}
    port = _i32(st)
    turn = np.asarray([9, 5, 6, 10][:p], np.uint8)
    for f in range(160):
        inp = turn[None].repeat(b, 0) if f < 120 else rng.integers(0, 16, (b, p), dtype=np.uint8)
        inp = torch.from_numpy(np.ascontiguousarray(inp))
        st = ref.advance(st, inp, config)
        port = game.advance(port, inp)
        for k in st:
            assert torch.equal(st[k].to(torch.int32), port[k]), (f, k)


@pytest.mark.parametrize("name,ref,config,make", GAMES, ids=[g[0] for g in GAMES])
def test_digest_equals_the_port(name, ref, config, make):
    rng = np.random.default_rng(11)
    st = {k: torch.from_numpy(rng.integers(-2**31, 2**31, (5, *v.shape), dtype=np.int64))
          for k, v in ref.init_state(config).items()}
    want = checksum_device(_i32(st), device="cpu").to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(digest.digest(st), want)


@pytest.mark.parametrize("ticks", [18, 19, 27, 40])
def test_expected_carry_equals_the_ports_carry(ticks):
    config = {"players": 2}
    b, d, r = 3, 8, 9
    rng = np.random.default_rng(ticks)
    inputs = rng.integers(0, 16, (ticks, b, 2), dtype=np.uint8)
    start = boxgame.init_state(config)
    sess = BatchedSessions(BoxGame(2).advance, _i32(start), np.zeros(2, np.uint8),
                           batch_size=b, check_distance=d, max_prediction=8, device="cpu")
    for t in range(ticks):
        sess.run_ticks(inputs[t][:, None], check=False)
    got = sess.carry
    want = replay.expected_carry(boxgame, config, {k: v.expand(b, *v.shape) for k, v in start.items()},
                                 lambda t: torch.from_numpy(inputs[t]), ticks, r)

    def same(g, w):
        if isinstance(w, dict):
            return all(same(g[k], w[k]) for k in w)
        return torch.equal(g.to(torch.int64) & 0xFFFFFFFF, w & 0xFFFFFFFF)

    assert same(got, want)


def test_float32_control_departs_from_the_reference():
    """The control's arithmetic loses bits: within a second of play the
    float32 step leaves the integer one."""
    config = {"players": 2}
    st = {k: v[None] for k, v in boxgame.init_state(config).items()}
    lo = {k: v.to(torch.float32) for k, v in st.items()}
    inp = torch.tensor([[1, 9]], dtype=torch.uint8)
    differ = 0
    for _ in range(60):
        st = boxgame.advance(st, inp, config)
        lo = boxgame.advance(lo, inp, config, torch.float32)
        differ += any(not torch.equal(st[k], lo[k].to(torch.int64)) for k in st)
    assert differ > 0
