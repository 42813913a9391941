"""SyncTest session: the determinism harness on the host.

The port's copy of ``ggrs_tpu/sessions/synctest.py`` (reference: GGRS
src/sessions/sync_test_session.rs).  Every frame past the warm-up it rolls
the game back ``check_distance`` frames and resimulates, comparing the
saved checksums of the whole window with the first-seen value of each
frame.  A mismatch means the game's save/load/advance is not deterministic.

Per frame the game runs ``2*check_distance + 2`` requests.  Feed each
request list to ``ops.DeviceRequestExecutor`` to run them on the card.
"""

from __future__ import annotations

from typing import Dict, Generic, List, Optional, TypeVar

from ..core.config import Config
from ..core.errors import InvalidRequest, MismatchedChecksum
from ..core.frame_info import PlayerInput
from ..core.sync_layer import SyncLayer
from ..core.types import AdvanceFrame, Frame, GgrsRequest, PlayerHandle
from ..net.messages import ConnectionStatus
from ..utils.ownership import ThreadOwned

I = TypeVar("I")
S = TypeVar("S")


class SyncTestSession(ThreadOwned, Generic[I, S]):
    _DRIVING_METHODS = ("add_local_input", "advance_frame")

    def __init__(
        self,
        config: Config,
        num_players: int,
        max_prediction: int,
        check_distance: int,
        input_delay: int,
    ) -> None:
        self._config = config
        self._num_players = num_players
        self._max_prediction = max_prediction
        self._check_distance = check_distance
        self._dummy_connect_status = [ConnectionStatus() for _ in range(num_players)]
        self._sync_layer: SyncLayer[I, S] = SyncLayer(config, num_players, max_prediction)
        for handle in range(num_players):
            self._sync_layer.set_frame_delay(handle, input_delay)
        self._checksum_history: Dict[Frame, Optional[int]] = {}
        self._local_inputs: Dict[PlayerHandle, PlayerInput[I]] = {}

    # -- public API (reference: sync_test_session.rs:61-170) -----------------

    def add_local_input(self, player_handle: PlayerHandle, input: I) -> None:
        """In a sync test all players are local; call once per player per frame."""
        self._check_owner()
        if player_handle >= self._num_players:
            raise InvalidRequest("The player handle you provided is not valid.")
        self._local_inputs[player_handle] = PlayerInput(self._sync_layer.current_frame, input)

    def advance_frame(self) -> List[GgrsRequest]:
        """Advance one frame; every frame past the warm-up also rolls back
        ``check_distance`` frames and resimulates, verifying checksums."""
        self._check_owner()
        requests: List[GgrsRequest] = []

        current_frame = self._sync_layer.current_frame
        if self._check_distance > 0 and current_frame > self._check_distance:
            # compare the whole window against first-seen checksums
            oldest = current_frame - self._check_distance
            mismatched = [
                f for f in range(oldest, current_frame + 1)
                if not self._checksums_consistent(f)
            ]
            if mismatched:
                raise MismatchedChecksum(current_frame, mismatched)

            # forced rollback every frame
            self._adjust_gamestate(current_frame - self._check_distance, requests)

        if len(self._local_inputs) != self._num_players:
            raise InvalidRequest("Missing local input while calling advance_frame().")
        for handle, player_input in self._local_inputs.items():
            self._sync_layer.add_local_input(handle, player_input)
        self._local_inputs.clear()

        # saving is pointless if we never roll back
        if self._check_distance > 0:
            requests.append(self._sync_layer.save_current_state())

        inputs = self._sync_layer.synchronized_inputs(self._dummy_connect_status)
        requests.append(AdvanceFrame(inputs=inputs))
        self._sync_layer.advance_frame()

        # fake confirmation at current - check_distance so the sync layer
        # never waits for remote inputs
        safe_frame = self._sync_layer.current_frame - self._check_distance
        self._sync_layer.set_last_confirmed_frame(safe_frame, sparse_saving=False)

        for status in self._dummy_connect_status:
            status.last_frame = self._sync_layer.current_frame

        return requests

    @property
    def current_frame(self) -> Frame:
        return self._sync_layer.current_frame

    @property
    def num_players(self) -> int:
        return self._num_players

    @property
    def max_prediction(self) -> int:
        return self._max_prediction

    @property
    def check_distance(self) -> int:
        return self._check_distance

    # -- internals -----------------------------------------------------------

    def _checksums_consistent(self, frame_to_check: Frame) -> bool:
        """Record the first-seen checksum per frame; later saves of the same
        frame must match it (reference: sync_test_session.rs:173-190)."""
        oldest_allowed = self._sync_layer.current_frame - self._check_distance
        self._checksum_history = {
            f: c for f, c in self._checksum_history.items() if f >= oldest_allowed
        }

        cell = self._sync_layer.saved_state_by_frame(frame_to_check)
        if cell is None:
            return True
        if cell.frame in self._checksum_history:
            return self._checksum_history[cell.frame] == cell.checksum
        self._checksum_history[cell.frame] = cell.checksum
        return True

    def _adjust_gamestate(self, frame_to: Frame, requests: List[GgrsRequest]) -> None:
        """Load a past frame and resimulate forward to where we were
        (reference: sync_test_session.rs:192-217)."""
        start_frame = self._sync_layer.current_frame
        count = start_frame - frame_to

        requests.append(self._sync_layer.load_frame(frame_to))
        self._sync_layer.reset_prediction()
        assert self._sync_layer.current_frame == frame_to

        for i in range(count):
            inputs = self._sync_layer.synchronized_inputs(self._dummy_connect_status)
            # skip the save on the first step: that state was just loaded
            if i > 0:
                requests.append(self._sync_layer.save_current_state())
            self._sync_layer.advance_frame()
            requests.append(AdvanceFrame(inputs=inputs))
        assert self._sync_layer.current_frame == start_frame
