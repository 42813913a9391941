"""The port's device prediction plane against the JAX package's, on the CPU.

``DevicePredictionPlane`` (``ggrs_tpu_torch/predict/batched.py``) predicts
every registered session's missing inputs in one device call per tick, and
the input queues take its table instead of the scalar predictor when the
base they predict from is the one gathered.  Prediction only fills frames
that are not confirmed yet, and the table must give what the scalar
strategy gives, so:

- with the plane on and off, and in the JAX package with its own plane, the
  same seeded matches give the same request lists (every input and status),
  the same wire bytes and the same final states, for ``BatchedRepeatLast``
  and ``BatchedDefault``, on a clean and on a lossy network; the plane serves
  real predictions (hits > 0) and its hit/fallback split and the queues'
  ``plane_mispredicts`` equal the JAX plane's;
- the confirmed stream (the journal a ``JournalTap`` records, and the frame
  cadence) does not depend on the prediction strategy;
- batched strategies are never native-eligible, and a session on the native
  sync core refuses the plane.

The oracle is ``tests/test_input_plane.py::TestPredictorParity``, which
drives the plane through the JAX package's ``HostSessionPool``; here the P2P
sessions are bound to the plane directly, and each drive calls
``begin_tick()`` once per tick, after the local inputs and before the
sessions advance, as that pool does.  Tolerance: exact equality.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ggrs_tpu.broadcast.journal as jjournal
import ggrs_tpu.core as jcore
import ggrs_tpu.net as jnet
import ggrs_tpu.predict as jpredict
import ggrs_tpu.sessions as jsessions

import ggrs_tpu_torch.broadcast.journal as tjournal
import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.predict as tpredict
import ggrs_tpu_torch.sessions as tsessions
from ggrs_tpu_torch.games import boxgame_config

PKGS = {
    "jax": SimpleNamespace(core=jcore, net=jnet, predict=jpredict, sessions=jsessions,
                           journal=jjournal),
    "port": SimpleNamespace(core=tcore, net=tnet, predict=tpredict, sessions=tsessions,
                            journal=tjournal),
}
FUZZ = dict(loss=0.08, duplicate=0.05, reorder=0.1, latency_ticks=1)
CLEAN = dict(latency_ticks=1)
TICKS, DRAIN, MATCHES = 40, 12, 4


def _sched(m, me, i):
    return ((i * (3 + me) + 5 * m) // (2 + m % 3)) % 16


class _Fold:
    """Host fulfilment: a u61 fold of every advance's inputs and statuses."""

    def __init__(self):
        self.state = 0

    def run(self, requests):
        for r in requests:
            kind = type(r).__name__
            if kind == "SaveGameState":
                r.cell.save(r.frame, self.state, None)
            elif kind == "LoadGameState":
                self.state = r.cell.load()
            else:
                for p, (v, st) in enumerate(r.inputs):
                    self.state = (self.state * 1_000_003 + (v + 1) * (p + 7) + len(st.name)) % 2**61


def _summary(requests):
    out = []
    for r in requests:
        kind = type(r).__name__
        if kind == "AdvanceFrame":
            out.append(("adv", tuple((v, st.name) for v, st in r.inputs)))
        else:
            out.append((kind, r.frame))
    return out


def _predictor(pkg, name):
    m = PKGS[pkg]
    return {
        "repeat": lambda: None,
        "default": lambda: m.core.PredictDefault(),
        "batched_repeat": lambda: m.predict.BatchedRepeatLast(),
        "batched_default": lambda: m.predict.BatchedDefault(),
    }[name]()


def _drive(pkg, predictor, plane, fault, tmp_path=None):
    """MATCHES two-peer matches over one seeded in-memory network, every
    session bound to one plane when ``plane`` is set."""
    m = PKGS[pkg]
    cfg = m.core.Config.for_uint(8, predictor=_predictor(pkg, predictor))
    net = m.net.InMemoryNetwork(seed=17, **fault)
    wire = []
    send = net._send

    def recording_send(frm, to, payload):
        wire.append((frm, to, bytes(payload)))
        send(frm, to, payload)

    net._send = recording_send
    sessions, journals = [], []
    for k in range(MATCHES):
        names = (f"A{k}", f"B{k}")
        for me in (0, 1):
            s = (m.sessions.SessionBuilder(cfg).with_clock(lambda: 0)
                 .with_rng(random.Random(3 + 5 * k + me))
                 .add_player(m.core.Local(), me).add_player(m.core.Remote(names[1 - me]), 1 - me)
                 .start_p2p_session(net.socket(names[me])))
            if tmp_path is not None and me == 0:
                journal = m.journal.MatchJournal(tmp_path / f"{pkg}-{predictor}-{k}.ggjl", 2, 1)
                s.adopt_spectator_endpoint(m.journal.JournalTap.ADDR,
                                           m.journal.JournalTap(journal, cfg))
                journals.append(journal)
            sessions.append(s)
    pl = None
    if plane:
        kw = {"device": "cpu"} if pkg == "port" else {}
        pl = m.predict.DevicePredictionPlane(cfg, capacity=len(sessions), **kw)
        for slot, s in enumerate(sessions):
            s.bind_prediction_plane(pl, slot)
    folds = [_Fold() for _ in sessions]
    record = []
    for i in range(TICKS + DRAIN):
        net.tick()
        for s in sessions:
            s.poll_remote_clients()
        for b, s in enumerate(sessions):
            s.add_local_input(b % 2, _sched(b // 2, b % 2, min(i, TICKS - 1)))
        if pl is not None:
            pl.begin_tick()
        for s, f in zip(sessions, folds):
            reqs = s.advance_frame()
            f.run(reqs)
            record.append(_summary(reqs))
    for j in journals:
        j.close()
    return SimpleNamespace(
        sessions=sessions, plane=pl, record=record, wire=wire,
        states=[f.state for f in folds], frames=[s.current_frame for s in sessions],
        plane_mispredicts=[q.plane_mispredicts for s in sessions
                           for q in s._sync_layer.input_queues],
        journals=[m.journal.read_journal(j.path)["frames"] for j in journals]
        if tmp_path is not None else None,
    )


@pytest.mark.parametrize("fault", ["clean", "fuzz"])
@pytest.mark.parametrize("predictor", ["batched_repeat", "batched_default"])
def test_plane_on_off_bit_identical_and_equal_to_jax(predictor, fault):
    fault = FUZZ if fault == "fuzz" else CLEAN
    off = _drive("port", predictor, False, fault)
    on = _drive("port", predictor, True, fault)
    jon = _drive("jax", predictor, True, fault)
    # batched strategies are never native-eligible: every leg runs the
    # Python input queues, which the plane serves
    assert all(s._sync_layer._native is None for s in off.sessions + on.sessions)
    for leg in (on, jon):
        assert leg.record == off.record
        assert leg.wire == off.wire
        assert leg.states == off.states
        assert leg.frames == off.frames
    stats = on.plane.stats()
    assert stats == jon.plane.stats()
    assert stats["ticks"] == TICKS + DRAIN and stats["registered"] == 2 * MATCHES
    assert stats["hits"] > 0, "the plane never served a prediction"
    assert on.plane_mispredicts == jon.plane_mispredicts
    assert any(r[0] == "LoadGameState" for rec in off.record for r in rec)


def test_plane_mispredicts_are_counted():
    on = _drive("port", "batched_default", True, FUZZ)
    assert sum(on.plane_mispredicts) > 0
    off = _drive("port", "batched_default", False, FUZZ)
    assert sum(off.plane_mispredicts) == 0


def test_confirmed_stream_is_predictor_independent(tmp_path):
    """Prediction only fills unconfirmed frames: whatever the strategy (and
    however differently it mispredicts under the fuzz), the journal of
    confirmed frames and the frame cadence are the same."""
    legs = [
        _drive("port", "repeat", False, FUZZ, tmp_path),
        _drive("port", "default", False, FUZZ, tmp_path),
        _drive("port", "batched_repeat", True, FUZZ, tmp_path),
        _drive("port", "batched_default", True, FUZZ, tmp_path),
        _drive("jax", "batched_default", True, FUZZ, tmp_path),
    ]
    ref = legs[0]
    assert ref.sessions[0]._sync_layer._native is not None  # repeat-last: native core
    assert all(len(j) > TICKS // 2 for j in ref.journals)
    for leg in legs[1:]:
        assert leg.journals == ref.journals
        assert leg.frames == ref.frames


def test_batched_strategies_are_not_native_eligible():
    from ggrs_tpu_torch.core.sync_layer import _native_sync_eligible
    from ggrs_tpu_torch.net.endpoint import NativeEndpointCore

    for predictor in (tpredict.BatchedRepeatLast(), tpredict.BatchedDefault()):
        cfg = tcore.Config.for_uint(8, predictor=predictor)
        assert not _native_sync_eligible(cfg)
        s = (tsessions.SessionBuilder(cfg).add_player(tcore.Local(), 0)
             .add_player(tcore.Remote("B"), 1).start_p2p_session(tnet.InMemoryNetwork().socket("A")))
        assert s._sync_layer._native is None and len(s._sync_layer.input_queues) == 2
        # the endpoint core does not depend on the predictor
        assert all(isinstance(ep._core, NativeEndpointCore)
                   for ep in s._player_reg.remotes.values())
    assert isinstance(tpredict.BatchedRepeatLast(), tpredict.PredictRepeatLast) is False
    assert issubclass(tpredict.BatchedDefault, tpredict.PredictDefault)


def test_native_session_refuses_the_plane():
    cfg = tcore.Config.for_uint(8, predictor=tpredict.BatchedRepeatLast())
    plane = tpredict.DevicePredictionPlane(cfg, capacity=2, device="cpu")
    s = (tsessions.SessionBuilder(boxgame_config()).add_player(tcore.Local(), 0)
         .add_player(tcore.Remote("B"), 1).start_p2p_session(tnet.InMemoryNetwork().socket("A")))
    assert s._sync_layer._native is not None
    with pytest.raises(tcore.InvalidRequest, match="Python input-queue"):
        s.bind_prediction_plane(plane, 0)
    with pytest.raises(ValueError, match="native sync core"):
        plane.register(0, s)
    assert plane.num_registered == 0


def test_plane_refuses_scalar_or_variable_size_configs():
    with pytest.raises(ValueError, match="BatchedInputPredictor"):
        tpredict.DevicePredictionPlane(tcore.Config.for_uint(8), 4, device="cpu")
    with pytest.raises(ValueError, match="fixed-size"):
        tpredict.DevicePredictionPlane(
            tcore.Config.for_bytes(predictor=tpredict.BatchedRepeatLast()), 4, device="cpu")
    plane = tpredict.DevicePredictionPlane(
        tcore.Config.for_uint(8, predictor=tpredict.BatchedRepeatLast()), 4, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        plane.register(4, None)


def test_unbound_and_unregistered_queues_fall_back():
    cfg = tcore.Config.for_uint(8, predictor=tpredict.BatchedRepeatLast())
    plane = tpredict.DevicePredictionPlane(cfg, capacity=2, device="cpu")
    plane.begin_tick()  # nothing registered: no table, no tick counted
    assert plane.stats() == {"ticks": 0, "registered": 0, "hits": 0, "fallbacks": 0}
    assert plane.predict_at(0, 0, 5) == (False, None)
    s = (tsessions.SessionBuilder(cfg).add_player(tcore.Local(), 0)
         .add_player(tcore.Remote("B"), 1).start_p2p_session(tnet.InMemoryNetwork().socket("A")))
    s.bind_prediction_plane(plane, 1)
    queues = s._sync_layer.input_queues
    assert all(q._plane is plane for q in queues)
    queues[1].add_input(tcore.PlayerInput(0, 9))
    plane.begin_tick()
    assert plane.predict_at(1, 1, 9) == (True, 9)  # base as gathered
    assert plane.predict_at(1, 1, 8) == (False, None)  # base moved: decline
    assert plane.predict_at(1, 0, 0) == (False, None)  # empty queue: no row
    plane.unregister(1)
    assert plane.num_registered == 0 and all(q._plane is None for q in queues)


@pytest.mark.parametrize("name", ["BatchedRepeatLast", "BatchedDefault"])
def test_kernel_matches_jax(name):
    base = np.random.default_rng(5).integers(0, 256, size=(6, 3, 4)).astype(np.uint8)
    got = getattr(tpredict, name)().kernel(torch.from_numpy(base))
    want = np.asarray(getattr(jpredict, name)().kernel(jnp.asarray(base)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


def test_plane_defaults_to_the_card():
    cfg = tcore.Config.for_uint(8, predictor=tpredict.BatchedRepeatLast())
    if torch.cuda.is_available():
        assert tpredict.DevicePredictionPlane(cfg, 1).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpredict.DevicePredictionPlane(cfg, 1)
