"""VectorWar on the CPU: the port's eager body against the benchmark's plain
reference (``benchmark/reference/vectorwar.py``), bitwise, over random
frames and hand-built cases of each rule; GGPO's start; ``BatchedSessions``
over VectorWar against the reference replay's expected carry; and the
kernel route's wrapper (the route, the counter, the layout it hands the
library) with CPU tensors standing in for the card's."""

import ctypes
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import replay as ref_replay
from benchmark.reference import vectorwar as ref
from ggrs_tpu_torch import _build as tbuild
from ggrs_tpu_torch.games import VectorWar, _card
from ggrs_tpu_torch.games import vectorwar as vw
from ggrs_tpu_torch.obs.registry import default_registry
from ggrs_tpu_torch.parallel.batch import BatchedSessions

ROOT = Path(__file__).resolve().parents[1]
CONFIG = {"players": 4}
ONE = 1 << 16
THRUST, BRAKE, LEFT, RIGHT, FIRE = 1, 2, 4, 8, 16


def _batch(b):
    return {k: v.unsqueeze(0).expand(b, *v.shape).clone() for k, v in ref.init_state(CONFIG).items()}


def _i32(state):
    return {k: v.to(torch.int32) for k, v in state.items()}


def _step_both(state, inputs):
    """One frame of the reference (int64) and of the port's eager body
    (int32) from the same state; asserts they agree and returns the
    reference's."""
    inputs = torch.as_tensor(np.asarray(inputs, np.uint8))
    want = ref.advance({k: v.to(torch.int64) for k, v in state.items()}, inputs, CONFIG)
    got = VectorWar()._advance_eager(_i32(state), inputs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.int32, k
        assert torch.equal(got[k].to(torch.int64), want[k].to(torch.int64)), k
    return want


def test_tables_and_constants_equal_the_reference():
    assert vw._SIN_FP.tolist() == list(ref.SINE_TABLE)
    assert ref.players(CONFIG) == vw.SHIPS
    assert (vw.SLOTS, vw._ROTATE, vw._RADIUS, vw._THRUST, vw._MAX_THRUST) == \
        (ref.SLOTS, ref.ROTATE, ref.RADIUS * ONE, ref.THRUST, ref.MAX_THRUST)
    assert (vw._BULLET_SPEED, vw._COOLDOWN, vw._DAMAGE, vw._HEALTH) == \
        (ref.BULLET_SPEED, ref.COOLDOWN, ref.DAMAGE, ref.HEALTH)
    assert vw._BOUNDS == (*(c * ONE for c in ref.LO), *(c * ONE for c in ref.HI))


def test_start_is_ggpos():
    port = VectorWar().init_state_np()
    mine = ref.init_state(CONFIG)
    assert list(port) == sorted(port) == sorted(mine) == list(vw.LEAVES)
    for k in port:
        assert port[k].dtype == np.int32 and np.array_equal(port[k], mine[k].numpy()), k
    # (312 + 116 cos t, 232 + 116 sin t), heading t + 180, t = 90 i
    assert (port["pos"] // ONE).tolist() == [[428, 232], [312, 348], [196, 232], [312, 116]]
    assert port["heading"].tolist() == [180, 270, 0, 90]
    assert port["health"].tolist() == [100] * 4
    assert not port["bullet_active"].any() and not port["vel"].any()


def test_eager_body_equals_the_reference_over_600_frames():
    rng = np.random.default_rng(2**31 + 600)
    st = _batch(16)
    for _ in range(600):
        st = _step_both(st, rng.integers(0, 32, (16, 4)))
    # the frames exercised what they are meant to: shots, hits, live bullets
    assert int(st["score"].sum()) > 0 and int(st["health"].min()) < 100
    assert int(st["bullet_active"].sum()) > 0


def test_every_input_byte_equals_the_reference():
    # all 256 input bytes (bomb and the unused high bits too) on one ship at a time
    st = _batch(256)
    for ship in range(4):
        inputs = np.zeros((256, 4), np.uint8)
        inputs[:, ship] = np.arange(256)
        for _ in range(12):
            st = _step_both(st, inputs)


def _still():
    """One session at GGPO's start, the ships parked out of each other's way
    (no input moves them)."""
    return _batch(1)


def test_fire_takes_the_first_free_slot_and_a_full_set_ignores_fire():
    st = _still()
    st["bullet_active"][0, 0, :5] = torch.tensor([1, 1, 0, 1, 0])
    st["bullet_pos"][0, 0, :5] = 20 * ONE  # live bullets far from every ship
    out = _step_both(st, [[FIRE, 0, 0, 0]])
    assert out["bullet_active"][0, 0, :5].tolist() == [1, 1, 1, 1, 0]
    assert int(out["cooldown"][0, 0]) == 7
    # the new bullet: 15 px ahead of the ship, moved once at 5 px (heading 180)
    assert out["bullet_pos"][0, 0, 2].tolist() == [(428 - 15 - 5) * ONE, 232 * ONE]
    assert out["bullet_vel"][0, 0, 2].tolist() == [-5 * ONE, 0]
    full = _still()
    full["bullet_active"][0, 1] = 1
    full["bullet_pos"][0, 1] = 20 * ONE
    full["bullet_vel"][0, 1] = 0
    out = _step_both(full, [[0, FIRE, 0, 0]])
    assert int(out["bullet_active"][0, 1].sum()) == 30 and int(out["cooldown"][0, 1]) == 0


def test_cooldown_holds_fire_for_eight_frames():
    st = _still()
    shots = []
    for _ in range(20):
        before = int(st["bullet_active"][0, 2].sum())
        st = _step_both(st, [[0, 0, FIRE, 0]])
        shots.append(int(st["bullet_active"][0, 2].sum()) - before)
    # a shot, 7 frames of cooldown, a shot on the 9th frame
    assert shots[:17] == [1, 0, 0, 0, 0, 0, 0, 0] * 2 + [1]


@pytest.mark.parametrize("wall", ["left", "right", "top", "bottom"])
def test_wall_bounce(wall):
    st = _still()
    x, y = {"left": (31, 200), "right": (609, 200), "top": (300, 31), "bottom": (300, 449)}[wall]
    vx, vy = {"left": (-3, 0), "right": (3, 0), "top": (0, -3), "bottom": (0, 3)}[wall]
    st["pos"][0, 0] = torch.tensor([x * ONE, y * ONE])
    st["vel"][0, 0] = torch.tensor([vx * ONE, vy * ONE])
    out = _step_both(st, [[0, 0, 0, 0]])
    # moved into the wall, the axis negated and added twice
    assert out["vel"][0, 0].tolist() == [-vx * ONE, -vy * ONE]
    assert out["pos"][0, 0].tolist() == [(x - vx) * ONE, (y - vy) * ONE]


def test_speed_limit():
    st = _still()
    st["heading"][0, 0] = 30  # a thrust along 30 degrees from 4 px at 45 degrees
    st["vel"][0, 0] = torch.tensor([185363, 185363])
    out = _step_both(st, [[THRUST, 0, 0, 0]])
    vx, vy = out["vel"][0, 0].tolist()
    # scaled back to 4 px, to within the integer root's and division's rounding
    assert abs((vx * vx + vy * vy) ** 0.5 - 4 * ONE) < 2
    # braking clamps too, and no thrust never clamps
    st["vel"][0, 0] = torch.tensor([5 * ONE, 0])
    _step_both(st, [[BRAKE, 0, 0, 0]])
    out = _step_both(st, [[0, 0, 0, 0]])
    assert out["vel"][0, 0].tolist() == [5 * ONE, 0]


def test_a_bullet_leaving_the_bounds_dies():
    st = _still()
    st["bullet_active"][0, 3, 7] = 1
    st["bullet_pos"][0, 3, 7] = torch.tensor([18 * ONE, 100 * ONE])
    st["bullet_vel"][0, 3, 7] = torch.tensor([-3 * ONE, 0])
    out = _step_both(st, [[0, 0, 0, 0]])
    assert int(out["bullet_active"][0, 3, 7]) == 0
    assert out["bullet_pos"][0, 3, 7].tolist() == [15 * ONE, 100 * ONE]  # where it left


def _bullet(st, ship, slot, at, vel=(0, 0)):
    st["bullet_active"][0, ship, slot] = 1
    st["bullet_pos"][0, ship, slot] = torch.tensor([at[0], at[1]])
    st["bullet_vel"][0, ship, slot] = torch.tensor([vel[0], vel[1]])


def test_hits_test_earlier_ships_after_and_later_ships_before_they_move():
    # ship 1 (i) shoots at ship 0 (j < i, already moved) and ship 3 (j > i,
    # not moved yet); ships 0 and 3 thrust this frame
    base = _still()
    base["vel"][0, 0] = torch.tensor([4 * ONE, 0])  # ship 0 moves 4 px right
    base["vel"][0, 3] = torch.tensor([0, 4 * ONE])  # ship 3 moves 4 px down
    p0, p3 = base["pos"][0, 0].tolist(), base["pos"][0, 3].tolist()
    # 13 px right of ship 0's old place: 9 px from its new one (a hit), and
    # a bullet 13 px above ship 3's old place: 17 px from its new one
    st = {k: v.clone() for k, v in base.items()}
    _bullet(st, 1, 0, (p0[0] + 13 * ONE, p0[1]))
    _bullet(st, 1, 1, (p3[0], p3[1] - 13 * ONE))
    out = _step_both(st, [[0, 0, 0, 0]])
    assert out["bullet_active"][0, 1, :2].tolist() == [0, 0]
    assert out["health"][0].tolist() == [90, 100, 100, 90]
    assert int(out["score"][0, 1]) == 2
    # 17 px left of ship 0's old place: 21 px from its new one (a miss); 17 px
    # below ship 3's old place: 13 px from where it will be (still a miss)
    st = {k: v.clone() for k, v in base.items()}
    _bullet(st, 1, 0, (p0[0] - 17 * ONE, p0[1]))
    _bullet(st, 1, 1, (p3[0], p3[1] + 17 * ONE))
    out = _step_both(st, [[0, 0, 0, 0]])
    assert out["bullet_active"][0, 1, :2].tolist() == [1, 1]
    assert out["health"][0].tolist() == [100] * 4


def test_a_bullet_hits_its_own_ship_and_the_first_ship_in_order():
    st = _still()
    p2 = st["pos"][0, 2].tolist()
    _bullet(st, 2, 4, (p2[0] + 5 * ONE, p2[1]))
    out = _step_both(st, [[0, 0, 0, 0]])
    assert out["health"][0].tolist() == [100, 100, 90, 100] and int(out["score"][0, 2]) == 1
    # two ships within reach of one bullet: the first in ship order is hit
    st = _still()
    st["pos"][0, 1] = torch.tensor([300 * ONE, 200 * ONE])
    st["pos"][0, 3] = torch.tensor([310 * ONE, 200 * ONE])
    _bullet(st, 0, 0, (305 * ONE, 200 * ONE))
    out = _step_both(st, [[0, 0, 0, 0]])
    assert out["health"][0].tolist() == [100, 90, 100, 100]


def test_two_ships_bullets_hit_one_ship_in_the_same_frame():
    st = _still()
    p3 = st["pos"][0, 3].tolist()
    _bullet(st, 0, 9, (p3[0] - 10 * ONE, p3[1]))
    _bullet(st, 2, 29, (p3[0] + 10 * ONE, p3[1]))
    _bullet(st, 2, 28, (p3[0], p3[1] + 10 * ONE))
    out = _step_both(st, [[0, 0, 0, 0]])
    assert out["health"][0].tolist() == [100, 100, 100, 70]
    assert out["score"][0].tolist() == [1, 0, 2, 0]


def test_batched_sessions_equal_the_reference_replay():
    game, b, d = VectorWar(), 8, 8
    rng = np.random.default_rng(2**31 + 88)
    ticks = 40
    inputs = rng.integers(0, 32, (ticks, b, 4)).astype(np.uint8)
    sess = BatchedSessions(game.advance, game.init_state_np(), np.zeros(4, np.uint8),
                           batch_size=b, check_distance=d, max_prediction=d, device="cpu")
    for t in range(ticks):
        stats = sess.run_ticks(np.ascontiguousarray(inputs[t][:, None]), check=True)
    assert stats["mismatches"] == 0
    start = {k: v.expand(b, *v.shape) for k, v in ref.init_state(CONFIG).items()}
    block = torch.from_numpy(inputs)
    want = ref_replay.expected_carry(ref, CONFIG, start, lambda t: block[t], ticks,
                                     sess.programs.ring.length)
    got = sess.carry
    for k in want["live"]:
        assert torch.equal(got["live"][k].to(torch.int64), want["live"][k]), k
        assert torch.equal(got["ring"]["states"][k].to(torch.int64), want["ring"]["states"][k]), k
    assert torch.equal(got["ring"]["checksums"].to(torch.int64) & 0xFFFFFFFF, want["ring"]["checksums"])
    assert torch.equal(got["hist"].to(torch.int64) & 0xFFFFFFFF, want["hist"])
    assert torch.equal(got["inputs"].to(torch.int64), want["inputs"])
    assert torch.equal(got["frame"].to(torch.int64), want["frame"])


# -- the kernel route's wrapper, with CPU tensors standing in for the card's --


def _advances(route):
    return default_registry().value("ggrs_game_advance_total", game="vectorwar", route=route) or 0.0


class _FakeCard:
    """The library's entry records its arguments and writes ``want`` (the
    eager body's result) through the output pointers, or returns ``err``."""

    def __init__(self, monkeypatch):
        self.calls, self.want, self.err = [], None, 0
        lib = type("Lib", (), {"ggrs_vectorwar_advance": staticmethod(self.launch)})
        monkeypatch.setattr(_card, "on_card", lambda *tensors: True)
        monkeypatch.setattr(vw, "_lib", lambda: lib)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: type("S", (), {"cuda_stream": 0})())
        monkeypatch.setattr(torch.cuda, "current_device", lambda: None)

    def launch(self, rows, leaves, strides, inp, inp_stride, item, outs, lut, stream):
        self.calls.append({"rows": rows, "leaves": list(leaves),
                           "strides": list(strides), "inp": (inp, inp_stride, item)})
        if self.err:
            return self.err
        for ptr, key in zip(outs, vw.LEAVES):
            src = self.want[key].contiguous()
            ctypes.memmove(ptr, src.data_ptr(), src.numel() * src.element_size())
        return 0


def test_cpu_tensors_take_the_eager_route():
    game, st = VectorWar(), _i32(_batch(3))
    inputs = torch.full((3, 4), FIRE, dtype=torch.uint8)
    assert not _card.on_card(inputs, *st.values())
    before = (_advances("kernel"), _advances("eager"), vw._advance_kernel.launches)
    out = game.advance(st, inputs)
    assert (_advances("kernel"), _advances("eager"), vw._advance_kernel.launches) == \
        (before[0], before[1] + 1, before[2])
    want = game._advance_eager(st, inputs)
    assert list(out) == list(want) == list(vw.LEAVES)
    for k in want:
        assert torch.equal(out[k], want[k])


def test_kernel_route_counts_reads_in_place_and_raises(monkeypatch):
    game, b, r = VectorWar(), 5, 9
    rng = np.random.default_rng(2**31 + 9)
    ring = {k: torch.from_numpy(np.stack([v.numpy()] * r, 1)).to(torch.int32).clone()
            for k, v in _batch(b).items()}
    window = torch.from_numpy(rng.integers(0, 32, (b, r, 4)).astype(np.uint8))
    st, inp = {k: v[:, 3] for k, v in ring.items()}, window[:, 4]
    fake = _FakeCard(monkeypatch)
    fake.want = game._advance_eager(st, inp)
    before = (_advances("kernel"), vw._advance_kernel.launches)
    out = game.advance(st, inp)
    call = fake.calls[-1]
    assert call["rows"] == b
    assert call["leaves"] == [st[k].data_ptr() for k in vw.LEAVES]
    assert call["strides"] == [r * st[k][0].numel() * 4 for k in vw.LEAVES]
    assert call["inp"] == (inp.data_ptr(), r * 4, 1)
    assert (_advances("kernel"), vw._advance_kernel.launches) == (before[0] + 1, before[1] + 1)
    for k in fake.want:
        assert torch.equal(out[k], fake.want[k])
    # a leaf whose inner dimensions are not contiguous is copied once
    odd = dict(st, bullet_vel=st["bullet_vel"].transpose(2, 3).contiguous().transpose(2, 3))
    game.advance(odd, inp)
    assert fake.calls[-1]["leaves"][2] != odd["bullet_vel"].data_ptr()
    assert fake.calls[-1]["strides"][2] == 4 * 30 * 2 * 4
    # an empty batch launches nothing, whatever its leaves' strides
    empty = {k: torch.empty_strided((0, *v.shape[1:]), (0,) * v.dim(), dtype=torch.int32)
             for k, v in st.items()}
    shapes = {k: tuple(v.shape) for k, v in game.advance(empty, inp[:0]).items()}
    assert shapes["bullet_pos"] == (0, 4, 30, 2) and len(fake.calls) == 2
    # what the kernel cannot read raises and launches nothing
    with pytest.raises(TypeError, match="int32"):
        game.advance({k: v.to(torch.int64) for k, v in st.items()}, inp)
    with pytest.raises(TypeError, match="integer dtype"):
        game.advance(st, inp.to(torch.float32))
    with pytest.raises(ValueError, match="shapes"):
        game.advance(st, torch.zeros((b, 5), dtype=torch.uint8))
    with pytest.raises(ValueError, match="shapes"):
        game.advance({k: v[0] for k, v in st.items()}, inp)
    with pytest.raises(ValueError, match="several devices"):
        game.advance(st, torch.zeros((b, 4), dtype=torch.uint8, device="meta"))
    shifted = torch.zeros(b * 4 * 30 * 2 + 1, dtype=torch.int32)[1:].view(b, 4, 30, 2)
    with pytest.raises(ValueError, match="8-byte aligned"):
        game.advance(dict(st, bullet_pos=shifted), inp)
    assert len(fake.calls) == 2
    # a launch that fails raises and counts nothing
    fake.err = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        game.advance(st, inp)
    assert vw._advance_kernel.launches == before[1] + 2


def test_build_names_and_hashes_the_kernel_source():
    src = ROOT / "ggrs_tpu_torch" / "csrc" / "vectorwar.cu"
    assert tbuild.SOURCES["vectorwar"] == src and src.exists()
    digest = hashlib.sha256(src.read_bytes() + " ".join(tbuild.NVCC_FLAGS).encode())
    assert tbuild.library_path("vectorwar") == \
        tbuild.BUILD_DIR / f"libvectorwar-{digest.hexdigest()[:12]}.so"


def test_kernel_source_states_the_wrappers_constants():
    # the kernel's constexprs, as its source writes them, are the rules'
    text = (ROOT / "ggrs_tpu_torch" / "csrc" / "vectorwar.cu").read_text()
    for name, value in (("kShips", "4"), ("kSlots", "30"), ("kRotate", "3"), ("kRadius", "15 << kFp"),
                        ("kThrust", str(vw._THRUST)), ("kMaxThrust", "4 << kFp"),
                        ("kBulletSpeed", "5"), ("kCooldown", "8"), ("kDamage", "10"),
                        ("kLeft", "16 << kFp"), ("kTop", "16 << kFp"),
                        ("kRight", "624 << kFp"), ("kBottom", "464 << kFp")):
        assert f"constexpr int {name} = {value};" in text, name
