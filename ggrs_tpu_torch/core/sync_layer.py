"""The rollback core: state ring, per-player input queues, confirmed-frame
bookkeeping (the port's copy of ``ggrs_tpu/core/sync_layer.py``; reference:
GGRS src/sync_layer.rs).

``GameStateCell`` is the host-side handle handed to the user inside
Save/Load requests.  With ``ops.DeviceRequestExecutor`` a cell holds the
state's tensors on the card (no copy) and a lazy checksum that is read back
only when the ``checksum`` property is read.

``SyncLayer`` runs the input-queue and watermark mechanism on the native
sync core (``csrc/host/sync_core.cpp``, one ctypes crossing per operation) by
default for configs with a fixed-size injective encoding, repeat-last
prediction and default equality, as the JAX package does; every other
config, and any ``SyncLayer(use_native=False)`` or ``GGRS_TPU_NO_NATIVE=1``,
runs the pure-Python ``InputQueue`` bank, the reference.  Both give the same
request lists.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Generic, List, Optional, Sequence, Tuple, TypeVar

from .config import Config, PredictRepeatLast, _default_eq
from .frame_info import GameState, PlayerInput
from .input_queue import InputQueue
from .types import (
    NULL_FRAME,
    Frame,
    InputStatus,
    LoadGameState,
    PlayerHandle,
    SaveGameState,
)

I = TypeVar("I")
S = TypeVar("S")

_U128 = 1 << 128


class GameStateCell(Generic[S]):
    """A shared, lock-protected slot holding one saved game state
    (reference: sync_layer.rs:14-111).

    ``load()`` returns the stored object itself, with no clone; ``data()``
    is the same no-copy accessor under the fork's name.  Users who mutate
    their state in place should save copies."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._state: GameState[S] = GameState()

    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def save(self, frame: Frame, data: Optional[S], checksum) -> None:
        """``checksum`` is a non-negative u128 int, None, or a lazy object
        with a ``materialize() -> int`` method (``ops.DeviceChecksum``),
        which keeps device->host reads off the save; the value is fetched
        the first time the ``checksum`` property is read."""
        assert frame != NULL_FRAME
        if checksum is not None and not hasattr(checksum, "materialize"):
            checksum = int(checksum)  # accept numpy integers etc.
            if not 0 <= checksum < _U128:
                # the wire carries u128: never truncate silently on send
                raise ValueError("checksum must fit in an unsigned 128-bit integer")
        with self._lock:
            self._state.frame = frame
            self._state.data = data
            self._state.checksum = checksum

    def load(self) -> Optional[S]:
        with self._lock:
            return self._state.data

    # no-copy access (reference: sync_layer.rs:130-142); do not mutate
    data = load

    @property
    def frame(self) -> Frame:
        with self._lock:
            return self._state.frame

    @property
    def checksum(self) -> Optional[int]:
        with self._lock:
            cs = self._state.checksum
            if cs is not None and not isinstance(cs, int):
                cs = int(cs.materialize())  # the first read pays the device fetch
                if not 0 <= cs < _U128:
                    raise ValueError("checksum must fit in an unsigned 128-bit integer")
                self._state.checksum = cs
            return cs

    def __repr__(self) -> str:  # pragma: no cover
        # the raw stored checksum: the property would read a lazy one back
        with self._lock:
            cs = self._state.checksum
            frame = self._state.frame
        return f"GameStateCell(frame={frame}, checksum={cs!r})"


class SavedStates(Generic[S]):
    """Ring of ``max_prediction + 1`` cells indexed by ``frame % len``
    (reference: sync_layer.rs:144-166)."""

    def __init__(self, max_prediction: int) -> None:
        self.cells: List[GameStateCell[S]] = [
            GameStateCell() for _ in range(max_prediction + 1)
        ]

    def get_cell(self, frame: Frame) -> GameStateCell[S]:
        assert frame >= 0
        return self.cells[frame % len(self.cells)]


def _native_sync_semantics_ok(config: Config) -> bool:
    """Byte-wise semantics are EXACTLY the Python value semantics: a
    fixed-size injective encoding (for_uint / integer-only for_struct set
    ``native_input_size``), repeat-last prediction, default equality.  The
    predictor's type is tested exactly: a batched strategy subclasses
    ``PredictRepeatLast`` but is not eligible."""
    return (
        config.native_input_size is not None
        and type(config.predictor) is PredictRepeatLast
        and config.input_eq is _default_eq
    )


def _native_sync_eligible(config: Config) -> bool:
    """Default-on gate for the native sync core: the semantics must hold and
    the global kill switch must be off."""
    return _native_sync_semantics_ok(config) and not os.environ.get("GGRS_TPU_NO_NATIVE")


# native status codes (sync_core.cpp kStatus*) -> InputStatus
_NATIVE_STATUS = (
    InputStatus.CONFIRMED,
    InputStatus.PREDICTED,
    InputStatus.DISCONNECTED,
)


class _NativeSyncCore:
    """ctypes facade over ``csrc/host/sync_core.cpp``: the input-queue bank and
    confirmed-frame watermark with ONE crossing per operation, storing
    Config-encoded fixed-size input bytes.  ``SyncLayer`` decides
    eligibility; the Python ``InputQueue`` bank is the reference."""

    def __init__(self, lib, config: Config, num_players: int) -> None:
        self._lib = lib
        self._config = config
        self._size = config.native_input_size
        self._players = num_players
        self._ptr = lib.ggrs_sync_new(num_players, self._size)
        if not self._ptr:
            raise MemoryError("ggrs_sync_new failed")
        self._in_buf = ctypes.create_string_buffer(self._size * num_players)
        self._status = (ctypes.c_int32 * num_players)()
        self._disc = ctypes.create_string_buffer(num_players)
        self._lastf = (ctypes.c_int64 * num_players)()
        self._out_frames = (ctypes.c_int64 * num_players)()
        # pre-bound: these run several times per session tick
        self._fn_add = lib.ggrs_sync_add_input
        self._fn_sync = lib.ggrs_sync_synchronized_inputs
        self._encode = config.input_encode
        self._decode = config.input_decode

    def __del__(self) -> None:  # pragma: no cover
        try:
            if self._ptr:
                self._lib.ggrs_sync_free(self._ptr)
                self._ptr = None
        except Exception:
            pass

    def _pack_status(self, connect_status) -> None:
        for i, st in enumerate(connect_status):
            self._disc[i] = 1 if st.disconnected else 0
            self._lastf[i] = st.last_frame

    def add_input(self, player: int, frame: Frame, value) -> Frame:
        rc = self._fn_add(self._ptr, player, frame, self._encode(value))
        if rc < NULL_FRAME:
            raise AssertionError(f"native sync add_input failed: {rc}")
        return rc

    def synchronized_inputs(self, frame: Frame, connect_status):
        self._pack_status(connect_status)
        rc = self._fn_sync(self._ptr, frame, self._disc, self._lastf, self._in_buf, self._status)
        if rc != 0:
            raise AssertionError(f"native sync synchronized_inputs: {rc}")
        decode, size = self._decode, self._size
        raw = self._in_buf.raw
        status = self._status
        return [
            (decode(raw[p * size:(p + 1) * size]), _NATIVE_STATUS[status[p]])
            for p in range(self._players)
        ]

    def confirmed_inputs(self, frame: Frame, connect_status):
        self._pack_status(connect_status)
        rc = self._lib.ggrs_sync_confirmed_inputs(
            self._ptr, frame, self._disc, self._lastf, self._in_buf, self._out_frames
        )
        if rc != 0:
            raise AssertionError(f"There is no confirmed input for the requested frame {frame}")
        decode, size = self._decode, self._size
        raw = self._in_buf.raw
        out = []
        for p in range(self._players):
            if self._out_frames[p] == NULL_FRAME:
                out.append(PlayerInput.blank(NULL_FRAME, self._config.input_default))
            else:
                out.append(PlayerInput(frame, decode(raw[p * size:(p + 1) * size])))
        return out

    def confirmed_input(self, player: int, frame: Frame):
        rc = self._lib.ggrs_sync_confirmed_input(self._ptr, player, frame, self._in_buf)
        if rc != 0:
            raise AssertionError(f"There is no confirmed input for the requested frame {frame}")
        return PlayerInput(frame, self._decode(self._in_buf.raw[: self._size]))

    def set_frame_delay(self, player: int, delay: int) -> None:
        self._lib.ggrs_sync_set_frame_delay(self._ptr, player, delay)

    def reset_prediction(self) -> None:
        self._lib.ggrs_sync_reset_prediction(self._ptr)

    def set_last_confirmed(self, frame: Frame) -> None:
        rc = self._lib.ggrs_sync_set_last_confirmed(self._ptr, frame)
        if rc != 0:
            raise AssertionError(
                "confirming past the first incorrect frame would discard "
                "inputs still needed for the pending rollback"
            )

    def check_consistency(self, first_incorrect: Frame) -> Frame:
        return self._lib.ggrs_sync_check_consistency(self._ptr, first_incorrect)

    def first_incorrect(self, player: int) -> Frame:
        return self._lib.ggrs_sync_first_incorrect(self._ptr, player)


class SyncLayer(Generic[I, S]):
    """Owns the state ring and input queues; emits Save/Load requests and
    merges per-player inputs (reference: sync_layer.rs:168-375).

    ``use_native`` picks the input-queue mechanism: None (the default) runs
    the native sync core when the config is eligible and the kill switch is
    off, True insists on it (a ValueError for an ineligible config), False
    runs the Python ``InputQueue`` bank, whose ``input_queues`` are then the
    session's (empty on the native core)."""

    def __init__(
        self,
        config: Config,
        num_players: int,
        max_prediction: int,
        use_native: Optional[bool] = None,
    ) -> None:
        self._config = config
        self.num_players = num_players
        self.max_prediction = max_prediction
        self.saved_states: SavedStates[S] = SavedStates(max_prediction)
        self._last_confirmed_frame: Frame = NULL_FRAME
        self._last_saved_frame: Frame = NULL_FRAME
        self._current_frame: Frame = 0
        self._native: Optional[_NativeSyncCore] = None
        if use_native is None:
            use_native = _native_sync_eligible(config)
        elif use_native and not _native_sync_semantics_ok(config):
            # forcing the native core on a config whose byte semantics differ
            # from its value semantics would change prediction and equality
            raise ValueError(
                "use_native=True requires a fixed-size injective input "
                "encoding with repeat-last prediction and default equality"
            )
        if use_native:
            from ..net import _native as _native_mod

            lib = _native_mod.sync_lib()
            if lib is not None:
                self._native = _NativeSyncCore(lib, config, num_players)
        self.input_queues: List[InputQueue[I]] = (
            [] if self._native is not None else [InputQueue(config) for _ in range(num_players)]
        )

    # -- frame counters ------------------------------------------------------

    @property
    def current_frame(self) -> Frame:
        return self._current_frame

    @property
    def last_saved_frame(self) -> Frame:
        return self._last_saved_frame

    @property
    def last_confirmed_frame(self) -> Frame:
        return self._last_confirmed_frame

    def advance_frame(self) -> None:
        self._current_frame += 1

    # -- save / load ---------------------------------------------------------

    def save_current_state(self, into: Optional[SaveGameState] = None) -> SaveGameState:
        self._last_saved_frame = self._current_frame
        cell = self.saved_states.get_cell(self._current_frame)
        if into is not None:
            # pooled-request mode (P2PSession.enable_request_pooling):
            # refill the caller's object instead of allocating
            into.cell = cell
            into.frame = self._current_frame
            return into
        return SaveGameState(cell=cell, frame=self._current_frame)

    def load_frame(self, frame_to_load: Frame) -> LoadGameState:
        """Rewind to a past frame within the prediction window
        (reference: sync_layer.rs:229-255)."""
        assert frame_to_load != NULL_FRAME, "cannot load null frame"
        assert frame_to_load < self._current_frame, (
            f"must load frame in the past (frame to load is {frame_to_load}, "
            f"current frame is {self._current_frame})"
        )
        assert frame_to_load >= self._current_frame - self.max_prediction, (
            "cannot load frame outside of prediction window; "
            f"(frame to load is {frame_to_load}, current frame is "
            f"{self._current_frame}, max prediction is {self.max_prediction})"
        )

        cell = self.saved_states.get_cell(frame_to_load)
        assert cell.frame == frame_to_load
        self._current_frame = frame_to_load
        return LoadGameState(cell=cell, frame=frame_to_load)

    def saved_state_by_frame(self, frame: Frame) -> Optional[GameStateCell[S]]:
        cell = self.saved_states.get_cell(frame)
        return cell if cell.frame == frame else None

    # -- inputs --------------------------------------------------------------

    def set_frame_delay(self, player_handle: PlayerHandle, delay: int) -> None:
        assert player_handle < self.num_players
        if self._native is not None:
            self._native.set_frame_delay(player_handle, delay)
        else:
            self.input_queues[player_handle].set_frame_delay(delay)

    def reset_prediction(self) -> None:
        if self._native is not None:
            self._native.reset_prediction()
            return
        for q in self.input_queues:
            q.reset_prediction()

    def add_local_input(self, player_handle: PlayerHandle, input: PlayerInput[I]) -> Frame:
        assert input.frame == self._current_frame
        if self._native is not None:
            return self._native.add_input(player_handle, input.frame, input.input)
        return self.input_queues[player_handle].add_input(input)

    def add_remote_input(self, player_handle: PlayerHandle, input: PlayerInput[I]) -> None:
        if self._native is not None:
            self._native.add_input(player_handle, input.frame, input.input)
            return
        self.input_queues[player_handle].add_input(input)

    def synchronized_inputs(self, connect_status: Sequence) -> List[Tuple[I, InputStatus]]:
        """Inputs for all players at the current frame; predictions where
        confirmed input hasn't arrived; defaults for disconnected players
        (reference: sync_layer.rs:280-293)."""
        if self._native is not None:
            return self._native.synchronized_inputs(self._current_frame, connect_status)
        inputs: List[Tuple[I, InputStatus]] = []
        for i, status in enumerate(connect_status):
            if status.disconnected and status.last_frame < self._current_frame:
                inputs.append((self._config.input_default(), InputStatus.DISCONNECTED))
            else:
                inputs.append(self.input_queues[i].input(self._current_frame))
        return inputs

    def confirmed_input(self, player_handle: PlayerHandle, frame: Frame) -> PlayerInput[I]:
        """One player's confirmed input at ``frame``; raises if not stored."""
        if self._native is not None:
            return self._native.confirmed_input(player_handle, frame)
        return self.input_queues[player_handle].confirmed_input(frame)

    def confirmed_inputs(self, frame: Frame, connect_status: Sequence) -> List[PlayerInput[I]]:
        """Confirmed inputs for all players at ``frame``; blanks for
        disconnected players (reference: sync_layer.rs:296-310)."""
        if self._native is not None:
            return self._native.confirmed_inputs(frame, connect_status)
        inputs: List[PlayerInput[I]] = []
        for i, status in enumerate(connect_status):
            if status.disconnected and status.last_frame < frame:
                inputs.append(PlayerInput.blank(NULL_FRAME, self._config.input_default))
            else:
                inputs.append(self.input_queues[i].confirmed_input(frame))
        return inputs

    # -- adoption (the host bank's eviction seam) ----------------------------

    def adopt_resume_state(
        self,
        current_frame: Frame,
        last_confirmed: Frame,
        saved_states: SavedStates[S],
        player_inputs: Sequence[Tuple[Frame, List[bytes]]],
    ) -> None:
        """Fast-forward a FRESH sync layer to a mid-stream position: a
        faulted native-bank slot resumes as a Python session from its last
        committed frame.

        ``player_inputs[p]`` is ``(start_frame, encoded_blobs)``: the
        consecutive confirmed inputs the bank harvest recovered for player
        ``p`` (fixed-size ``Config`` encoding, frames ``start ..
        start+len-1``).  ``saved_states`` is adopted by reference, so the
        resumed session's rollback cells are the ones the game already
        fulfilled."""
        assert self._current_frame == 0 and self._last_confirmed_frame == (
            NULL_FRAME
        ), "adopt_resume_state() requires a fresh sync layer"
        self.saved_states = saved_states
        self._current_frame = current_frame
        cell = saved_states.get_cell(current_frame) if current_frame >= 0 else None
        self._last_saved_frame = (
            current_frame if cell is not None and cell.frame == current_frame
            else NULL_FRAME
        )
        if self._native is not None:
            lib = self._native._lib
            for p, (start, blobs) in enumerate(player_inputs):
                if not blobs:
                    continue
                rc = lib.ggrs_sync_seed(
                    self._native._ptr, p, start, len(blobs), b"".join(blobs)
                )
                if rc != 0:
                    raise RuntimeError(f"ggrs_sync_seed failed: {rc}")
            if last_confirmed != NULL_FRAME:
                self._native.set_last_confirmed(last_confirmed)
        else:
            decode = self._config.input_decode
            for p, (start, blobs) in enumerate(player_inputs):
                if not blobs:
                    continue  # nothing harvested (start is NULL_FRAME)
                self.input_queues[p].seed(start, [decode(b) for b in blobs])
            # no discard pass: the harvest already starts at the watermark
        self._last_confirmed_frame = last_confirmed

    # -- confirmation / consistency ------------------------------------------

    def set_last_confirmed_frame(self, frame: Frame, sparse_saving: bool) -> None:
        """Raise the confirmed-frame watermark and discard older inputs
        (reference: sync_layer.rs:313-340)."""
        # with sparse saving, never confirm past the last save: the rollback
        # target would have been discarded
        if sparse_saving:
            frame = min(frame, self._last_saved_frame)

        # never delete anything ahead of the current frame
        frame = min(frame, self._current_frame)

        if self._native is not None:
            # the native core verifies the first-incorrect invariant, stores
            # and discards; the policy above stays here
            self._native.set_last_confirmed(frame)
            self._last_confirmed_frame = frame
            return

        first_incorrect: Frame = NULL_FRAME
        for q in self.input_queues:
            first_incorrect = max(first_incorrect, q.first_incorrect_frame)

        # confirming past the first incorrect frame would discard inputs
        # still needed for the pending rollback
        assert first_incorrect == NULL_FRAME or first_incorrect >= frame

        self._last_confirmed_frame = frame
        if self._last_confirmed_frame > 0:
            for q in self.input_queues:
                q.discard_confirmed_frames(frame - 1)

    def check_simulation_consistency(self, first_incorrect: Frame) -> Frame:
        """Earliest incorrect frame across all input queues
        (reference: sync_layer.rs:343-353)."""
        if self._native is not None:
            return self._native.check_consistency(first_incorrect)
        for q in self.input_queues:
            incorrect = q.first_incorrect_frame
            if incorrect != NULL_FRAME and (
                first_incorrect == NULL_FRAME or incorrect < first_incorrect
            ):
                first_incorrect = incorrect
        return first_incorrect
