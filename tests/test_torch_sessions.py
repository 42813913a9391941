"""The port's host SyncTest path against the JAX package's.

``SessionBuilder(...).start_synctest_session()`` of both packages get the
same numpy-seeded inputs; their request lists must be equal frame by frame
as (type, frame, inputs, statuses), warm-up frames and input delay included.
The JAX package runs its sync layer on the native sync core for these
configs, the port on the Python input queues.  Then the cases of
``tests/test_synctest_session.py`` and ``tests/test_input_queue.py`` that use
no network, against the port's modules with the same expectations."""

import pickle
import random
import struct
import threading

import numpy as np
import pytest

import ggrs_tpu.core as jcore
from ggrs_tpu.core import sync_layer as jsync
from ggrs_tpu.games import boxgame_config as jax_boxgame_config
from ggrs_tpu.sessions import SessionBuilder as JaxSessionBuilder

import ggrs_tpu_torch.core as tcore
from ggrs_tpu_torch.core import (
    INPUT_QUEUE_LENGTH,
    AdvanceFrame,
    Config,
    CrossThreadAccess,
    GameStateCell,
    InputQueue,
    InputStatus,
    InvalidRequest,
    LoadGameState,
    MismatchedChecksum,
    NULL_FRAME,
    PlayerInput,
    PredictCustom,
    PredictDefault,
    SaveGameState,
    SyncLayer,
)
from ggrs_tpu_torch.games import boxgame_config
from ggrs_tpu_torch.net import ConnectionStatus
from ggrs_tpu_torch.sessions import SessionBuilder


def _fnv(frame, state):
    acc = 0xCBF29CE484222325
    for b in struct.pack("<qq", frame, state):
        acc = ((acc ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return acc


class _Stub:
    """A tiny deterministic game over one package's request types: the
    state is (frame, value); an advance adds 2 when the inputs' sum is even
    and subtracts 1 otherwise (as ``tests/stubs.py`` does)."""

    def __init__(self, core, random_checksums=False):
        self.core = core
        self.frame, self.value = 0, 0
        self._rng = random.Random(3) if random_checksums else None

    def handle(self, requests):
        for req in requests:
            if isinstance(req, self.core.LoadGameState):
                self.frame, self.value = req.cell.load()
            elif isinstance(req, self.core.SaveGameState):
                assert self.frame == req.frame
                cs = self._rng.getrandbits(128) if self._rng else _fnv(self.frame, self.value)
                req.cell.save(req.frame, (self.frame, self.value), cs)
            elif isinstance(req, self.core.AdvanceFrame):
                total = sum(v for v, _ in req.inputs)
                self.value += 2 if total % 2 == 0 else -1
                self.frame += 1


def _describe(core, requests):
    out = []
    for r in requests:
        if isinstance(r, core.SaveGameState):
            out.append(("save", r.frame))
        elif isinstance(r, core.LoadGameState):
            out.append(("load", r.frame))
        else:
            out.append(("advance", tuple(int(v) for v, _ in r.inputs),
                        tuple(s.value for _, s in r.inputs)))
    return out


# -- request lists against the JAX package -----------------------------------


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("check_distance", [0, 1, 2, 4, 7])
def test_request_lists_match_jax(check_distance, delay):
    assert jsync._native_sync_eligible(jax_boxgame_config())  # the JAX side's default core
    frames = 60
    inputs = np.random.default_rng(100 + 10 * check_distance + delay).integers(
        0, 16, size=(frames, 2)).astype(np.uint8)
    port = (SessionBuilder(boxgame_config()).with_check_distance(check_distance)
            .with_input_delay(delay).start_synctest_session())
    jx = (JaxSessionBuilder(jax_boxgame_config()).with_check_distance(check_distance)
          .with_input_delay(delay).start_synctest_session())
    port_game, jax_game = _Stub(tcore), _Stub(jcore)
    for f in range(frames):
        for h in range(2):
            port.add_local_input(h, int(inputs[f, h]))
            jx.add_local_input(h, int(inputs[f, h]))
        got, want = port.advance_frame(), jx.advance_frame()
        assert _describe(tcore, got) == _describe(jcore, want), f"frame {f}"
        port_game.handle(got)
        jax_game.handle(want)
        assert port.current_frame == jx.current_frame == f + 1
    assert (port_game.frame, port_game.value) == (jax_game.frame, jax_game.value)


def test_delayed_inputs_reach_the_advance_late():
    # with delay 2, frames 0 and 1 advance on the blank input the queue
    # replicates into the gap, confirmed; then each input arrives 2 late
    seen = []
    for builder in (SessionBuilder(boxgame_config()), JaxSessionBuilder(jax_boxgame_config())):
        sess = builder.with_check_distance(0).with_input_delay(2).start_synctest_session()
        frames = []
        for f in range(6):
            sess.add_local_input(0, f + 1)
            sess.add_local_input(1, 10 + f)
            (adv,) = sess.advance_frame()
            frames.append(tuple((v, s.value) for v, s in adv.inputs))
        seen.append(frames)
    c = "confirmed"
    assert seen[0] == seen[1] == [((0, c), (0, c)), ((0, c), (0, c)), ((1, c), (10, c)),
                                  ((2, c), (11, c)), ((3, c), (12, c)), ((4, c), (13, c))]


# -- tests/test_synctest_session.py on the port --------------------------------


def test_create_session():
    SessionBuilder(Config.for_uint(32)).start_synctest_session()


def test_advance_frame_no_rollbacks():
    stub = _Stub(tcore)
    sess = SessionBuilder(Config.for_uint(32)).with_check_distance(0).start_synctest_session()
    for i in range(200):
        sess.add_local_input(0, i)
        sess.add_local_input(1, i)
        requests = sess.advance_frame()
        assert len(requests) == 1
        stub.handle(requests)
        assert stub.frame == i + 1


def test_advance_frame_with_rollbacks():
    d = 2
    stub = _Stub(tcore)
    sess = SessionBuilder(Config.for_uint(32)).with_check_distance(d).start_synctest_session()
    for i in range(200):
        sess.add_local_input(0, i)
        sess.add_local_input(1, i)
        requests = sess.advance_frame()
        kinds = [type(r) for r in requests]
        if i <= d:
            assert kinds == [SaveGameState, AdvanceFrame]
        else:
            assert kinds == [LoadGameState, AdvanceFrame, SaveGameState, AdvanceFrame,
                             SaveGameState, AdvanceFrame]
        stub.handle(requests)
        assert stub.frame == i + 1


def test_advance_frames_with_delayed_input():
    stub = _Stub(tcore)
    sess = (SessionBuilder(Config.for_uint(32)).with_check_distance(7).with_input_delay(2)
            .start_synctest_session())
    for i in range(200):
        sess.add_local_input(0, i)
        sess.add_local_input(1, i)
        stub.handle(sess.advance_frame())
        assert stub.frame == i + 1


def test_advance_frames_with_random_checksums():
    stub = _Stub(tcore, random_checksums=True)
    sess = SessionBuilder(Config.for_uint(32)).with_input_delay(2).start_synctest_session()
    with pytest.raises(MismatchedChecksum):
        for i in range(200):
            sess.add_local_input(0, i)
            sess.add_local_input(1, i)
            stub.handle(sess.advance_frame())


def test_check_distance_must_be_less_than_max_prediction():
    with pytest.raises(InvalidRequest, match="Check distance too big."):
        SessionBuilder(Config.for_uint(32)).with_check_distance(8).start_synctest_session()
    with pytest.raises(InvalidRequest, match="Check distance too big."):
        (SessionBuilder(Config.for_uint(32)).with_max_prediction_window(4)
         .with_check_distance(4).start_synctest_session())


@pytest.mark.parametrize("d", [1, 3, 5])
def test_requests_per_tick_match_2d_plus_2(d):
    stub = _Stub(tcore)
    sess = (SessionBuilder(Config.for_uint(32)).with_check_distance(d)
            .with_max_prediction_window(8).start_synctest_session())
    for i in range(50):
        sess.add_local_input(0, i)
        sess.add_local_input(1, i)
        requests = sess.advance_frame()
        if i > d:
            assert len(requests) == 2 * d + 2
        stub.handle(requests)


def test_missing_input_and_bad_handle_raise():
    sess = SessionBuilder(Config.for_uint(8)).start_synctest_session()
    with pytest.raises(InvalidRequest, match="not valid"):
        sess.add_local_input(2, 0)
    sess.add_local_input(0, 1)
    with pytest.raises(InvalidRequest, match="Missing local input"):
        sess.advance_frame()


def test_session_is_pinned_to_its_driving_thread():
    sess = SessionBuilder(Config.for_uint(8)).start_synctest_session()
    sess.add_local_input(0, 1)
    errors = []

    def other():
        try:
            sess.add_local_input(1, 1)
        except CrossThreadAccess as e:
            errors.append(e)

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and len(errors) == 1
    sess.add_local_input(1, 1)
    sess.advance_frame()


@pytest.mark.parametrize(
    "setter,arg,match",
    [
        ("with_num_players", 0, "at least 1"),
        ("with_fps", 0, "FPS"),
        ("with_max_frames_behind", 0, "smaller than 1"),
        ("with_max_frames_behind", 60, "Spectator buffer"),
        ("with_catchup_speed", 0, "smaller than 1"),
        ("with_catchup_speed", 10, "maximum frames behind"),
        ("with_sync_timeout", 0, "positive"),
    ],
)
def test_builder_setters_validate_as_jax_does(setter, arg, match):
    with pytest.raises(InvalidRequest, match=match):
        getattr(SessionBuilder(Config.for_uint(8)), setter)(arg)
    with pytest.raises(jcore.InvalidRequest, match=match):
        getattr(JaxSessionBuilder(jcore.Config.for_uint(8)), setter)(arg)


def test_builder_defaults_match_jax():
    port, jx = SessionBuilder(Config.for_uint(8)), JaxSessionBuilder(jcore.Config.for_uint(8))
    for attr in ("_num_players", "_max_prediction", "_fps", "_sparse_saving",
                 "_disconnect_timeout_ms", "_disconnect_notify_start_ms", "_input_delay",
                 "_check_distance", "_max_frames_behind", "_catchup_speed",
                 "_sync_handshake", "_sync_timeout_ms"):
        assert getattr(port, attr) == getattr(jx, attr), attr
    assert port._desync_detection == tcore.DesyncDetection.off()


def test_with_predictor_rebinds_predict_default():
    # repeat-last would predict 5; a rebound PredictDefault predicts the
    # config's default (0) while the input is unconfirmed
    sess = (SessionBuilder(Config.for_uint(8)).with_predictor(PredictDefault())
            .with_check_distance(0).with_input_delay(1).start_synctest_session())
    sess.add_local_input(0, 5)
    sess.add_local_input(1, 5)
    (adv,) = sess.advance_frame()
    assert [v for v, _ in adv.inputs] == [0, 0]


# -- the config constructors against the JAX package ---------------------------


@pytest.mark.parametrize("bits", [8, 16, 32, 64])
def test_for_uint_encoding_matches_jax(bits):
    port, jx = Config.for_uint(bits), jcore.Config.for_uint(bits)
    for v in (0, 1, 2 ** bits - 1, 2 ** (bits - 1) + 3):
        assert port.input_encode(v) == jx.input_encode(v)
        assert port.input_decode(port.input_encode(v)) == v
    assert port.native_input_size == jx.native_input_size == bits // 8
    with pytest.raises(ValueError):
        Config.for_uint(12)


@pytest.mark.parametrize("fmt", ["<hhB", "<f", "<2s", "<qx"])
def test_for_struct_matches_jax(fmt):
    port, jx = Config.for_struct(fmt), jcore.Config.for_struct(fmt)
    assert port.input_default() == jx.input_default()
    assert port.native_input_size == jx.native_input_size
    value = jx.input_default()
    assert port.input_encode(value) == jx.input_encode(value)


def test_for_varrec_and_for_bytes_match_jax():
    port, jx = Config.for_varrec(6), jcore.Config.for_varrec(6)
    for rec in (b"", b"a", b"abc\x00", b"123456"):
        assert port.input_encode(rec) == jx.input_encode(rec)
        assert port.input_decode(port.input_encode(rec)) == rec
    assert port.native_input_size == jx.native_input_size == 8
    with pytest.raises(ValueError):
        port.input_encode(b"1234567")
    with pytest.raises(ValueError):
        port.input_decode(b"\x01\x00ab\x00\x00\x00\x00")  # nonzero padding
    with pytest.raises(ValueError):
        Config.for_varrec(4, default=lambda: b"x")
    port_b = Config.for_bytes()
    assert port_b.input_encode(b"xy") == b"xy" and port_b.native_input_size is None


def test_predictors():
    assert PredictCustom(lambda v: v + 1).predict(3) == 4
    with pytest.raises(TypeError):
        PredictDefault(7)
    with pytest.raises(ValueError):
        PredictDefault().predict(1)
    assert Config.for_uint(8, predictor=PredictDefault()).predictor.predict(9) == 0


# -- tests/test_input_queue.py on the port -------------------------------------


def _queue() -> InputQueue:
    return InputQueue(Config.for_uint(8))


def test_add_input_wrong_frame():
    q = _queue()
    assert q.add_input(PlayerInput(0, 0)) == 0
    assert q.add_input(PlayerInput(3, 0)) == NULL_FRAME


def test_add_input_twice():
    q = _queue()
    assert q.add_input(PlayerInput(0, 0)) == 0
    assert q.add_input(PlayerInput(0, 0)) == NULL_FRAME


def test_add_input_sequentially():
    q = _queue()
    for i in range(10):
        q.add_input(PlayerInput(i, 0))
        assert q.last_added_frame == i
        assert q.length == i + 1


def test_input_sequentially():
    q = _queue()
    for i in range(10):
        q.add_input(PlayerInput(i, i))
        assert q.last_added_frame == i
        assert q.length == i + 1
        assert q.input(i) == (i, InputStatus.CONFIRMED)


def test_delayed_inputs():
    q = _queue()
    delay = 2
    q.set_frame_delay(delay)
    for i in range(10):
        q.add_input(PlayerInput(i, i))
        assert q.last_added_frame == i + delay
        assert q.length == i + delay + 1
        value, _status = q.input(i)
        assert value == max(0, i - delay)


def test_prediction_repeat_last():
    q = _queue()
    q.add_input(PlayerInput(0, 7))
    assert q.input(1) == (7, InputStatus.PREDICTED)
    q.add_input(PlayerInput(1, 7))
    assert q.first_incorrect_frame == NULL_FRAME


def test_prediction_mismatch_recorded():
    q = _queue()
    q.add_input(PlayerInput(0, 7))
    assert q.input(1) == (7, InputStatus.PREDICTED)
    q.add_input(PlayerInput(1, 9))
    assert q.first_incorrect_frame == 1
    q.reset_prediction()
    assert q.first_incorrect_frame == NULL_FRAME


def test_prediction_without_previous_input_uses_default():
    q = _queue()
    assert q.input(0) == (0, InputStatus.PREDICTED)


def test_discard_confirmed_frames():
    q = _queue()
    for i in range(10):
        q.add_input(PlayerInput(i, i))
    q.input(9)
    q.discard_confirmed_frames(5)
    assert q.length == 5
    assert q.confirmed_input(5).input == 5


def test_confirmed_input_missing_raises():
    q = _queue()
    q.add_input(PlayerInput(0, 0))
    with pytest.raises(AssertionError):
        q.confirmed_input(5)


def test_queue_wraps_its_ring_as_jax_does():
    # past INPUT_QUEUE_LENGTH frames with discards, mispredictions and
    # delay changes; every read and bookkeeping field equal to the JAX queue
    rng = np.random.default_rng(4)
    port, jx = _queue(), jcore.InputQueue(jcore.Config.for_uint(8))
    assert INPUT_QUEUE_LENGTH == jcore.INPUT_QUEUE_LENGTH
    for f in range(3 * INPUT_QUEUE_LENGTH):
        if f % 50 == 25:
            for q in (port, jx):
                q.set_frame_delay(int(rng.integers(0, 3)))
        v = int(rng.integers(0, 4))
        assert port.add_input(PlayerInput(f, v)) == jx.add_input(jcore.PlayerInput(f, v))
        ask = max(port.last_added_frame, 0) + int(rng.integers(0, 3))
        if port.first_incorrect_frame == NULL_FRAME:
            got, want = port.input(ask), jx.input(ask)
            assert (got[0], got[1].value) == (want[0], want[1].value)
        else:
            port.reset_prediction()
            jx.reset_prediction()
        if f % 7 == 0:
            port.discard_confirmed_frames(f - 3)
            jx.discard_confirmed_frames(f - 3)
        for field in ("head", "tail", "length", "last_added_frame",
                      "first_incorrect_frame", "last_requested_frame"):
            assert getattr(port, field) == getattr(jx, field), (f, field)


# -- tests/test_sync_layer.py on the port, and against the JAX sync core -----------


def _status(n):
    return [ConnectionStatus() for _ in range(n)]


def test_different_delays():
    sl = SyncLayer(Config.for_uint(8), num_players=2, max_prediction=8)
    sl.set_frame_delay(0, 2)
    sl.set_frame_delay(1, 0)
    status = _status(2)
    for i in range(20):
        sl.add_remote_input(0, PlayerInput(i, i))
        sl.add_remote_input(1, PlayerInput(i, i))
        status[0].last_frame = status[1].last_frame = i
        if i >= 3:
            inputs = sl.synchronized_inputs(status)
            assert inputs[0][0] == i - 2 and inputs[1][0] == i
        sl.advance_frame()


def test_save_load_round_trip():
    sl = SyncLayer(Config.for_uint(8), num_players=1, max_prediction=4)
    req = sl.save_current_state()
    assert req.frame == 0
    req.cell.save(0, {"hp": 100}, checksum=42)
    assert sl.last_saved_frame == 0
    for _ in range(3):
        sl.advance_frame()
        sl.save_current_state().cell.save(sl.current_frame, {"hp": 90}, None)
    load = sl.load_frame(0)
    assert load.frame == 0 and load.cell.load() == {"hp": 100} and sl.current_frame == 0


def test_load_frame_window_asserts():
    sl = SyncLayer(Config.for_uint(8), num_players=1, max_prediction=2)
    for _ in range(5):
        req = sl.save_current_state()
        req.cell.save(req.frame, None, None)
        sl.advance_frame()
    for frame in (1, 5, NULL_FRAME):  # outside the window, not in the past, null
        with pytest.raises(AssertionError):
            sl.load_frame(frame)


def test_set_last_confirmed_discards_inputs():
    sl = SyncLayer(Config.for_uint(8), num_players=1, max_prediction=8)
    status = _status(1)
    for i in range(10):
        sl.add_remote_input(0, PlayerInput(i, i))
        status[0].last_frame = i
        sl.synchronized_inputs(status)
        sl.advance_frame()
    sl.set_last_confirmed_frame(8, sparse_saving=False)
    assert sl.last_confirmed_frame == 8
    assert sl.confirmed_input(0, 8).input == 8


def test_disconnected_player_gets_default_input():
    sl = SyncLayer(Config.for_uint(8), num_players=2, max_prediction=8)
    status = [ConnectionStatus(), ConnectionStatus(disconnected=True, last_frame=NULL_FRAME)]
    sl.add_remote_input(0, PlayerInput(0, 5))
    status[0].last_frame = 0
    assert sl.synchronized_inputs(status) == [(5, InputStatus.CONFIRMED),
                                              (0, InputStatus.DISCONNECTED)]
    assert sl.confirmed_inputs(0, status)[1].frame == NULL_FRAME


@pytest.mark.parametrize("use_native", [True, False])
def test_sync_layer_with_late_remote_inputs_matches_jax(use_native):
    # player 1's inputs arrive 3 frames late and change every 5 frames, so
    # predictions go wrong; every synchronized read, first-incorrect frame,
    # rollback and confirmed read must equal the JAX sync layer's (its native
    # core, and its Python queues)
    rng = np.random.default_rng(12)
    port = SyncLayer(Config.for_uint(8), num_players=2, max_prediction=8)
    jx = jsync.SyncLayer(jcore.Config.for_uint(8), num_players=2, max_prediction=8,
                         use_native=use_native)
    assert (jx._native is not None) == use_native
    from ggrs_tpu.net.messages import ConnectionStatus as JaxConnectionStatus
    st_port, st_jax = _status(2), [JaxConnectionStatus() for _ in range(2)]
    remote = [int(v) for v in np.repeat(rng.integers(0, 4, size=12), 5)]
    lag = 3
    rollbacks = 0
    for f in range(50):
        v0 = int(rng.integers(0, 256))
        assert port.add_local_input(0, PlayerInput(f, v0)) == \
            jx.add_local_input(0, jcore.PlayerInput(f, v0))
        if f >= lag:
            port.add_remote_input(1, PlayerInput(f - lag, remote[f - lag]))
            jx.add_remote_input(1, jcore.PlayerInput(f - lag, remote[f - lag]))
        for sts in (st_port, st_jax):
            sts[0].last_frame, sts[1].last_frame = f, f - lag
        bad_p = port.check_simulation_consistency(NULL_FRAME)
        bad_j = jx.check_simulation_consistency(NULL_FRAME)
        assert bad_p == bad_j, f
        if bad_p != NULL_FRAME:
            # roll back to the first incorrect frame, as P2P does
            rollbacks += 1
            for sl in (port, jx):
                sl._current_frame = bad_p
                sl.reset_prediction()
            while port.current_frame < f:
                got, want = port.synchronized_inputs(st_port), jx.synchronized_inputs(st_jax)
                assert [(v, s.value) for v, s in got] == [(v, s.value) for v, s in want]
                port.advance_frame()
                jx.advance_frame()
        got, want = port.synchronized_inputs(st_port), jx.synchronized_inputs(st_jax)
        assert [(v, s.value) for v, s in got] == [(v, s.value) for v, s in want], f
        for sl in (port, jx):
            sl.advance_frame()
            sl.set_last_confirmed_frame(f - lag, sparse_saving=False)
        assert port.last_confirmed_frame == jx.last_confirmed_frame
        if f - lag >= 1:
            c_p = port.confirmed_inputs(f - lag, st_port)
            c_j = jx.confirmed_inputs(f - lag, st_jax)
            assert [(c.frame, c.input) for c in c_p] == [(c.frame, c.input) for c in c_j]
    assert rollbacks >= 5


# -- GameStateCell and lazy checksums (tests/test_lazy_checksum.py on the port) ----


def test_cell_materializes_a_lazy_checksum_once():
    class Lazy:
        reads = 0

        def materialize(self):
            Lazy.reads += 1
            return 123

    cell = GameStateCell()
    cell.save(7, "state", Lazy())
    assert "123" not in repr(cell)  # repr does not read the device
    assert cell.checksum == 123 and cell.checksum == 123 and Lazy.reads == 1


def test_cell_validates_the_u128_range():
    cell = GameStateCell()
    with pytest.raises(ValueError):
        cell.save(1, None, 1 << 128)
    with pytest.raises(ValueError):
        cell.save(1, None, -1)

    class TooBig:
        def materialize(self):
            return 1 << 128

    cell.save(1, None, TooBig())
    with pytest.raises(ValueError):
        cell.checksum
    cell.save(2, None, np.uint64(5))
    assert cell.checksum == 5 and isinstance(cell.checksum, int)


def test_cell_pickles_without_its_lock():
    cell = GameStateCell()
    cell.save(3, {"hp": 1}, 9)
    back = pickle.loads(pickle.dumps(cell))
    assert (back.frame, back.data(), back.checksum) == (3, {"hp": 1}, 9)
    back.save(4, None, None)  # a fresh lock works


def test_desync_detection_interval_must_be_positive():
    assert tcore.DesyncDetection.on(3) == tcore.DesyncDetection(True, 3)
    with pytest.raises(ValueError):
        tcore.DesyncDetection.on(0)
