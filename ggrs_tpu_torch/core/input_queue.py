"""Per-player circular input queue with prediction and misprediction tracking.

The port's own copy of ``ggrs_tpu/core/input_queue.py`` (reference: GGRS
src/input_queue.rs): a 128-slot ring holding confirmed inputs between tail
and head, frame-delay insertion (replicating the last input when the delay
grows, dropping when it shrinks), prediction through the config's
predictor, and the first-incorrect-frame bookkeeping that drives rollbacks.
The device prediction plane and the host bank's ``seed`` are not ported
yet.
"""

from __future__ import annotations

from typing import Generic, List, Optional, Tuple, TypeVar

from .config import Config
from .frame_info import PlayerInput
from .types import NULL_FRAME, Frame, InputStatus

I = TypeVar("I")

# Number of inputs the queue can hold per player (reference: input_queue.rs:6).
INPUT_QUEUE_LENGTH = 128


class InputQueue(Generic[I]):
    def __init__(self, config: Config) -> None:
        self._config = config
        self.head = 0
        self.tail = 0
        self.length = 0
        self.first_frame = True

        self.last_added_frame: Frame = NULL_FRAME
        self.first_incorrect_frame: Frame = NULL_FRAME
        self.last_requested_frame: Frame = NULL_FRAME

        self.frame_delay = 0

        self._inputs: List[PlayerInput[I]] = [
            PlayerInput.blank(NULL_FRAME, config.input_default)
            for _ in range(INPUT_QUEUE_LENGTH)
        ]
        self._prediction: PlayerInput[I] = PlayerInput.blank(
            NULL_FRAME, config.input_default
        )

    # -- bookkeeping -------------------------------------------------------

    def set_frame_delay(self, delay: int) -> None:
        self.frame_delay = delay

    def reset_prediction(self) -> None:
        """Drop out of prediction mode after a rollback
        (reference: input_queue.rs:63-67)."""
        self._prediction.frame = NULL_FRAME
        self.first_incorrect_frame = NULL_FRAME
        self.last_requested_frame = NULL_FRAME

    # -- reads ---------------------------------------------------------------

    def confirmed_input(self, requested_frame: Frame) -> PlayerInput[I]:
        """The confirmed input for a frame; raises if it isn't stored
        (reference: input_queue.rs:71-80)."""
        slot = self._inputs[requested_frame % INPUT_QUEUE_LENGTH]
        if slot.frame == requested_frame:
            return PlayerInput(slot.frame, slot.input)
        raise AssertionError(
            f"There is no confirmed input for the requested frame {requested_frame}"
        )

    def input(self, requested_frame: Frame) -> Tuple[I, InputStatus]:
        """The input for a frame, or a prediction if not yet confirmed
        (reference: input_queue.rs:104-167)."""
        # grabbing input while a known misprediction is pending would walk
        # further down the wrong timeline
        assert self.first_incorrect_frame == NULL_FRAME

        # needed in add_input() to decide when to drop out of prediction mode
        self.last_requested_frame = requested_frame

        assert requested_frame >= self._inputs[self.tail].frame

        if self._prediction.frame < 0:
            # a frame in the confirmed range is served from the ring
            offset = requested_frame - self._inputs[self.tail].frame
            if offset < self.length:
                pos = (offset + self.tail) % INPUT_QUEUE_LENGTH
                assert self._inputs[pos].frame == requested_frame
                return (self._inputs[pos].input, InputStatus.CONFIRMED)

            # otherwise enter prediction mode, based on the most recently
            # added input (if any)
            previous: Optional[PlayerInput[I]] = None
            if requested_frame != 0 and self.last_added_frame != NULL_FRAME:
                previous = self._inputs[(self.head - 1) % INPUT_QUEUE_LENGTH]

            if previous is not None:
                predicted = self._config.predictor.predict(previous.input)
                base_frame = previous.frame
            else:
                predicted = self._config.input_default()
                base_frame = self._prediction.frame

            self._prediction = PlayerInput(base_frame + 1, predicted)

        assert self._prediction.frame != NULL_FRAME
        return (self._prediction.input, InputStatus.PREDICTED)

    # -- writes --------------------------------------------------------------

    def add_input(self, input: PlayerInput[I]) -> Frame:
        """Add an input, applying frame delay.  Returns the frame it landed on,
        or NULL_FRAME if dropped for being non-sequential
        (reference: input_queue.rs:170-186)."""
        if (
            self.last_added_frame != NULL_FRAME
            and input.frame + self.frame_delay != self.last_added_frame + 1
        ):
            return NULL_FRAME

        new_frame = self._advance_queue_head(input.frame)
        if new_frame != NULL_FRAME:
            self._add_input_by_frame(input, new_frame)
        return new_frame

    def _add_input_by_frame(self, input: PlayerInput[I], frame_number: Frame) -> None:
        """Store an input at an exact frame and reconcile it against any
        outstanding prediction (reference: input_queue.rs:190-230)."""
        prev_pos = (self.head - 1) % INPUT_QUEUE_LENGTH

        assert (
            self.last_added_frame == NULL_FRAME
            or frame_number == self.last_added_frame + 1
        )
        assert frame_number == 0 or self._inputs[prev_pos].frame == frame_number - 1

        # compare prediction with reality before the input enters the ring
        prediction_matches = self._prediction.equal(
            input, input_only=True, eq=self._config.input_eq
        )

        self._inputs[self.head] = PlayerInput(frame_number, input.input)
        self.head = (self.head + 1) % INPUT_QUEUE_LENGTH
        self.length += 1
        assert self.length <= INPUT_QUEUE_LENGTH
        self.first_frame = False
        self.last_added_frame = frame_number

        if self._prediction.frame != NULL_FRAME:
            assert frame_number == self._prediction.frame

            # record the first incorrect prediction so the session can roll back
            if self.first_incorrect_frame == NULL_FRAME and not prediction_matches:
                self.first_incorrect_frame = frame_number

            # exit prediction mode once reality has caught up with the last
            # frame the session asked for, but only if nothing was wrong
            if (
                self._prediction.frame == self.last_requested_frame
                and self.first_incorrect_frame == NULL_FRAME
            ):
                self._prediction.frame = NULL_FRAME
            else:
                self._prediction.frame += 1

    def _advance_queue_head(self, input_frame: Frame) -> Frame:
        """Apply frame delay; replicate inputs if the delay grew, drop if it
        shrank (reference: input_queue.rs:233-265)."""
        prev_pos = (self.head - 1) % INPUT_QUEUE_LENGTH
        expected_frame = 0 if self.first_frame else self._inputs[prev_pos].frame + 1

        input_frame += self.frame_delay

        # delay shrank since the last insert: no room, toss the input
        if expected_frame > input_frame:
            return NULL_FRAME

        # delay grew: replicate the last input to fill the gap
        while expected_frame < input_frame:
            replicate = self._inputs[(self.head - 1) % INPUT_QUEUE_LENGTH]
            self._add_input_by_frame(
                PlayerInput(replicate.frame, replicate.input), expected_frame
            )
            expected_frame += 1

        prev_pos = (self.head - 1) % INPUT_QUEUE_LENGTH
        assert input_frame == 0 or input_frame == self._inputs[prev_pos].frame + 1
        return input_frame

    # -- discard -------------------------------------------------------------

    def discard_confirmed_frames(self, frame: Frame) -> None:
        """Drop confirmed inputs up to ``frame``: they are synchronized
        across players and no longer needed (reference: input_queue.rs:83-101)."""
        if self.last_requested_frame != NULL_FRAME:
            frame = min(frame, self.last_requested_frame)

        if frame >= self.last_added_frame:
            # delete all but the most recent
            self.tail = self.head
            self.length = 1
        elif frame <= self._inputs[self.tail].frame:
            pass  # nothing to delete
        else:
            offset = frame - self._inputs[self.tail].frame
            self.tail = (self.tail + offset) % INPUT_QUEUE_LENGTH
            self.length -= offset
