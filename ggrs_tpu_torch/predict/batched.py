"""Device-batched input prediction: all B slots' missing inputs in one call
(the port's copy of ``ggrs_tpu/predict/batched.py``).

The reference predicts per input queue, per player, in scalar Rust.  A pool
hosting hundreds of matches re-enters that scalar path B x P times a tick.
Here the prediction *strategy itself* is vectorized: a
``BatchedInputPredictor`` exposes

    kernel(base: u8[B, P, S]) -> u8[B, P, S]

mapping every (slot, player)'s last-known encoded input to its predicted
next encoded input, as a plain torch function on the plane's device.  The
``DevicePredictionPlane`` drives it: once per pool tick it gathers each
registered slot's per-player last inputs on the host, sends them to the
device in one copy, runs the kernel once and reads the table back in one
copy, then serves the table to the per-slot ``InputQueue``s when they enter
prediction mode.

Correctness does not depend on the table: ``predict_at`` answers only when
the queue's actual prediction base equals the gathered base row
(encoded-byte equality); on any mismatch (a datagram landed between the
gather and the queue's ask, an unregistered slot, no tick begun) the queue
falls back to the strategy's scalar ``predict``, the semantic reference the
kernel must agree with.  Either path yields the same value, so confirmed
streams are bit-identical with the plane on or off.

Batched strategies are deliberately NOT native-core eligible
(``core.sync_layer._native_sync_semantics_ok`` tests ``type(predictor) is
PredictRepeatLast``): a session configured with one keeps the Python input
queues, which the plane serves.  A ``parallel.HostSessionPool`` given the
plane (``attach_prediction_plane``) runs ``begin_tick()`` in each
``advance_all``; a caller driving the sessions itself runs it once per tick,
after the tick's local inputs are added and before the sessions advance, as
that pool does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import Config, InputPredictor, PredictDefault
from ..core.device import DeviceLike, resolve_device
from ..ops.graphs import KeyedGraphs

__all__ = [
    "BatchedDefault",
    "BatchedInputPredictor",
    "BatchedRepeatLast",
    "DevicePredictionPlane",
]


class BatchedInputPredictor(InputPredictor):
    """A prediction strategy with both a scalar and a device-batched form.

    ``predict(previous)`` is the scalar semantics (the reference and the
    fallback); ``kernel(base)`` must compute, for every row, exactly
    ``encode(predict(decode(row)))``, over the config's fixed-size encoding
    (``native_input_size`` set), so byte-level agreement is value-level
    agreement."""

    def kernel(self, base: torch.Tensor) -> torch.Tensor:
        """u8[B, P, S] last-known encoded inputs -> u8[B, P, S] predicted
        encoded inputs, on ``base``'s device."""
        raise NotImplementedError


class BatchedRepeatLast(BatchedInputPredictor):
    """Repeat-last, batched: the kernel is the identity."""

    def predict(self, previous):
        return previous

    def kernel(self, base: torch.Tensor) -> torch.Tensor:
        return base


class BatchedDefault(BatchedInputPredictor, PredictDefault):
    """Always-default, batched: the kernel is zeros, sound because every
    fixed-envelope config encodes its default input as all-zero bytes (the
    contract the native core's blank inputs rely on too)."""

    def kernel(self, base: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(base)


class DevicePredictionPlane:
    """Runs a :class:`BatchedInputPredictor` for a pool of sessions.

    Lifecycle::

        plane = DevicePredictionPlane(config, capacity=B)
        session.bind_prediction_plane(plane, slot)   # each Python-path session
        # per tick: add the local inputs, then
        plane.begin_tick()
        # then advance every session

    ``begin_tick`` gathers u8[B, P, S] prediction bases from every
    registered slot's input queues and runs the kernel once; ``predict_at``
    then answers queue prediction requests from the table (or declines,
    sending the queue to the scalar fallback).  ``stats()`` reports the
    hit/fallback split.  ``device`` is the card by default; ``"cpu"`` runs
    the kernel on the CPU."""

    def __init__(self, config: Config, capacity: int, device: DeviceLike = None) -> None:
        predictor = config.predictor
        if not isinstance(predictor, BatchedInputPredictor):
            raise ValueError(
                "DevicePredictionPlane requires a BatchedInputPredictor "
                f"strategy, got {type(predictor).__name__}"
            )
        if config.native_input_size is None:
            raise ValueError(
                "DevicePredictionPlane requires a fixed-size encoding "
                "(native_input_size set: for_uint/for_struct/for_varrec)"
            )
        self.device = resolve_device(device)
        self._config = config
        self._predictor = predictor
        self._size = config.native_input_size
        self._capacity = capacity
        self._encode = config.input_encode
        self._decode = config.input_decode
        self._queues: Dict[int, List[Any]] = {}  # slot -> per-player queues
        self._base: Optional[np.ndarray] = None  # u8[B, P, S] gather
        self._valid: Optional[np.ndarray] = None  # bool[B, P]
        self._table: Optional[np.ndarray] = None  # u8[B, P, S] predictions
        self.ticks = 0
        self.hits = 0
        self.fallbacks = 0
        self._graphs: Optional[KeyedGraphs] = None

    def graphs(self) -> Optional[KeyedGraphs]:
        """The kernel's graphs on the plane's device, made at first use when
        it is a CUDA device; None elsewhere (the eager route)."""
        if self._graphs is None and self.device.type == "cuda":
            self._graphs = KeyedGraphs(self.device, "predict")
        return self._graphs

    # -- registration ---------------------------------------------------

    def register(self, slot: int, session) -> None:
        """Bind one Python-path session's input queues to this plane.
        (Sessions on the native core never ask Python queues for
        predictions, so there is nothing to serve them.)"""
        if not 0 <= slot < self._capacity:
            raise ValueError(f"slot {slot} outside plane capacity {self._capacity}")
        queues = session._sync_layer.input_queues
        if not queues:
            raise ValueError(
                "session runs the native sync core; the device plane only "
                "serves Python input queues"
            )
        self._queues[slot] = list(queues)
        for player, q in enumerate(queues):
            q.bind_prediction_plane(self, slot, player)

    def unregister(self, slot: int) -> None:
        for q in self._queues.pop(slot, ()):
            q.bind_prediction_plane(None, 0, 0)

    @property
    def num_registered(self) -> int:
        return len(self._queues)

    # -- per tick -------------------------------------------------------

    def begin_tick(self) -> None:
        """Gather every registered queue's prediction base and run the
        kernel: one upload, one kernel call (a graph replay on the card),
        one read-back predict all slots' missing inputs."""
        if not self._queues:
            self._table = None
            return
        players = max(len(qs) for qs in self._queues.values())
        base = np.zeros((self._capacity, players, self._size), np.uint8)
        valid = np.zeros((self._capacity, players), bool)
        for slot, queues in self._queues.items():
            for player, q in enumerate(queues):
                prev = q.last_added_input()
                if prev is None:
                    continue
                base[slot, player] = np.frombuffer(self._encode(prev.input), np.uint8)
                valid[slot, player] = True
        self._base = base
        self._valid = valid
        self._table = self._predict(base)
        self.ticks += 1

    def _predict(self, base: np.ndarray) -> np.ndarray:
        """``kernel(base)`` as a host table: one graph replay between one
        copy up and one copy down on a CUDA device, the kernel eagerly
        elsewhere."""
        kernel = self._predictor.kernel
        g = self.graphs()
        if g is None:
            return kernel(torch.from_numpy(base).to(self.device)).to(torch.uint8).cpu().numpy()

        def build(views, _):
            table = torch.empty(base.shape, dtype=torch.uint8, device=g.device)
            return lambda: table.copy_(kernel(views[0])), table

        return g.replay(("kernel", base.shape), [base], None, build).cpu().numpy()

    def predict_at(self, slot: int, player: int, previous) -> Tuple[bool, Any]:
        """Serve one queue's prediction from the table.  Returns ``(True,
        value)`` on a base match, ``(False, None)`` when the queue must fall
        back to the scalar strategy."""
        table = self._table
        if table is None or self._valid is None or not self._valid[slot, player]:
            self.fallbacks += 1
            return False, None
        if self._encode(previous) != self._base[slot, player].tobytes():
            # the queue's base moved since the gather (an input landed
            # mid-tick): the table row predicts from stale state, decline
            self.fallbacks += 1
            return False, None
        self.hits += 1
        return True, self._decode(table[slot, player].tobytes())

    def stats(self) -> Dict[str, int]:
        return {
            "ticks": self.ticks,
            "registered": len(self._queues),
            "hits": self.hits,
            "fallbacks": self.fallbacks,
        }
