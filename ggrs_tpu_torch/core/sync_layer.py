"""The rollback core: state ring, per-player input queues, confirmed-frame
bookkeeping (the port's copy of ``ggrs_tpu/core/sync_layer.py``; reference:
GGRS src/sync_layer.rs).

``GameStateCell`` is the host-side handle handed to the user inside
Save/Load requests.  With ``ops.DeviceRequestExecutor`` a cell holds the
state's tensors on the card (no copy) and a lazy checksum that is read back
only when the ``checksum`` property is read.

``SyncLayer`` runs the pure-Python ``InputQueue`` bank.  The JAX package
runs the same mechanism on its native sync core by default (for configs with
a fixed-size encoding, repeat-last prediction and default equality); the
two give identical request lists, and the native core comes to the port
with the host layer.
"""

from __future__ import annotations

import threading
from typing import Generic, List, Optional, Sequence, Tuple, TypeVar

from .config import Config
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


class SyncLayer(Generic[I, S]):
    """Owns the state ring and input queues; emits Save/Load requests and
    merges per-player inputs (reference: sync_layer.rs:168-375)."""

    def __init__(self, config: Config, num_players: int, max_prediction: int) -> None:
        self._config = config
        self.num_players = num_players
        self.max_prediction = max_prediction
        self.saved_states: SavedStates[S] = SavedStates(max_prediction)
        self._last_confirmed_frame: Frame = NULL_FRAME
        self._last_saved_frame: Frame = NULL_FRAME
        self._current_frame: Frame = 0
        self.input_queues: List[InputQueue[I]] = [
            InputQueue(config) for _ in range(num_players)
        ]

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

    def save_current_state(self) -> SaveGameState:
        self._last_saved_frame = self._current_frame
        cell = self.saved_states.get_cell(self._current_frame)
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
        self.input_queues[player_handle].set_frame_delay(delay)

    def reset_prediction(self) -> None:
        for q in self.input_queues:
            q.reset_prediction()

    def add_local_input(self, player_handle: PlayerHandle, input: PlayerInput[I]) -> Frame:
        assert input.frame == self._current_frame
        return self.input_queues[player_handle].add_input(input)

    def add_remote_input(self, player_handle: PlayerHandle, input: PlayerInput[I]) -> None:
        self.input_queues[player_handle].add_input(input)

    def synchronized_inputs(self, connect_status: Sequence) -> List[Tuple[I, InputStatus]]:
        """Inputs for all players at the current frame; predictions where
        confirmed input hasn't arrived; defaults for disconnected players
        (reference: sync_layer.rs:280-293)."""
        inputs: List[Tuple[I, InputStatus]] = []
        for i, status in enumerate(connect_status):
            if status.disconnected and status.last_frame < self._current_frame:
                inputs.append((self._config.input_default(), InputStatus.DISCONNECTED))
            else:
                inputs.append(self.input_queues[i].input(self._current_frame))
        return inputs

    def confirmed_input(self, player_handle: PlayerHandle, frame: Frame) -> PlayerInput[I]:
        """One player's confirmed input at ``frame``; raises if not stored."""
        return self.input_queues[player_handle].confirmed_input(frame)

    def confirmed_inputs(self, frame: Frame, connect_status: Sequence) -> List[PlayerInput[I]]:
        """Confirmed inputs for all players at ``frame``; blanks for
        disconnected players (reference: sync_layer.rs:296-310)."""
        inputs: List[PlayerInput[I]] = []
        for i, status in enumerate(connect_status):
            if status.disconnected and status.last_frame < frame:
                inputs.append(PlayerInput.blank(NULL_FRAME, self._config.input_default))
            else:
                inputs.append(self.input_queues[i].confirmed_input(frame))
        return inputs

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
        for q in self.input_queues:
            incorrect = q.first_incorrect_frame
            if incorrect != NULL_FRAME and (
                first_incorrect == NULL_FRAME or incorrect < first_incorrect
            ):
                first_incorrect = incorrect
        return first_incorrect
