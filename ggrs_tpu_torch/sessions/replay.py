"""Replay session: deterministic playback of a match journal.

The port's own copy of ``ggrs_tpu/sessions/replay.py``.  The confirmed-input
stream a ``MatchJournal`` holds determines the match, so replaying it is
spectating without a network: per frame, ``advance_frame`` emits the same
``AdvanceFrame`` request a ``SpectatorSession`` following the live host
would have emitted -- bit-identical inputs and statuses.  Never a save, load
or rollback: every input is confirmed.

Two playback speeds:

- **request-list playback** (``advance_frame``): one frame per call, the
  drop-in replacement for a live session in a request loop (a
  ``DeviceRequestExecutor`` fulfils it on the card);
- **fast-forward** (``stacked_inputs`` + ``ops.replay.build_scrub_program``):
  the whole window's inputs go to the card in one upload and the advances
  run back to back with the state resident there, as one CUDA graph
  replay a window.

``seek`` lands on the newest embedded checkpoint at or below the target
frame (``utils.checkpoint`` npz blobs, validated against the caller's state
template) and positions playback there, so scrubbing deep into a long match
costs checkpoint-interval frames, not the whole prefix.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..broadcast.journal import JournalExhausted, read_journal
from ..core.config import Config
from ..core.errors import InvalidRequest
from ..core.types import AdvanceFrame, Frame, GgrsRequest, InputStatus


class ReplaySession:
    """Deterministic playback of one journal file.

    ``config`` decodes the journaled input bytes back into the game's input
    values (the same ``Config`` the recorded session used); without it,
    inputs are handed back as raw bytes.
    """

    def __init__(self, path, config: Optional[Config] = None) -> None:
        parsed = read_journal(path)
        self.meta: Dict[str, Any] = parsed["meta"]
        self.num_players: int = int(self.meta["num_players"])
        self.input_size: int = int(self.meta["input_size"])
        if config is not None and config.native_input_size != self.input_size:
            raise InvalidRequest(
                f"journal holds {self.input_size}-byte inputs; the config "
                f"encodes {config.native_input_size}-byte inputs"
            )
        self._decode = config.input_decode if config is not None else bytes
        self.closed: bool = parsed["closed"]
        self.truncated: bool = parsed["truncated"]
        self.gaps: List[Frame] = parsed["gaps"]
        self._frames: Dict[Frame, Tuple[bytes, bytes]] = {
            f: (flags, blob) for f, flags, blob in parsed["frames"]
        }
        self._checkpoints: List[Tuple[Frame, bytes]] = sorted(parsed["checkpoints"])
        frames = sorted(self._frames)
        self.first_frame: Frame = frames[0] if frames else 0
        self.last_frame: Frame = frames[-1] if frames else -1
        self._cursor: Frame = self.first_frame

    # ------------------------------------------------------------------
    # playback
    # ------------------------------------------------------------------

    @property
    def current_frame(self) -> Frame:
        """The next frame ``advance_frame`` will emit."""
        return self._cursor

    def frames_remaining(self) -> int:
        """Frames playable from the cursor WITHOUT crossing a gap: the
        contiguous run, not the span to the journal's last frame."""
        n = 0
        while (self._cursor + n) in self._frames:
            n += 1
        return n

    def _inputs_at(self, frame: Frame):
        rec = self._frames.get(frame)
        if rec is None:
            raise JournalExhausted(
                f"no journaled frame {frame} "
                f"(journal covers {self.first_frame}..{self.last_frame}"
                f"{' with gaps' if self.gaps else ''})"
            )
        flags, blob = rec
        isize = self.input_size
        decode = self._decode
        return [
            (
                decode(blob[p * isize : (p + 1) * isize]),
                InputStatus.DISCONNECTED if flags[p] else InputStatus.CONFIRMED,
            )
            for p in range(self.num_players)
        ]

    def advance_frame(self) -> List[GgrsRequest]:
        """Re-emit the next frame's request list: exactly one
        ``AdvanceFrame`` whose inputs and statuses are bit-identical to what
        a live spectator following the recorded host observed.  Raises
        :class:`JournalExhausted` past the end (or across a recorded gap)."""
        requests = [AdvanceFrame(inputs=self._inputs_at(self._cursor))]
        self._cursor += 1
        return requests

    # ------------------------------------------------------------------
    # checkpoint seek + fast-forward
    # ------------------------------------------------------------------

    def checkpoint_frames(self) -> List[Frame]:
        return [f for f, _ in self._checkpoints]

    def seek(self, frame: Frame, template: Any = None):
        """Position playback at the newest checkpoint at or below ``frame``
        and return ``(checkpoint_frame, state, meta)``: the state from which
        ``checkpoint_frame`` is the next frame to simulate.  With
        ``template`` the embedded npz blob is rebuilt into that tree
        (``utils.checkpoint.loads_pytree``, validation included; numpy
        leaves); without it the raw blob is returned.  Returns
        ``(first_frame, None, None)`` when no checkpoint lies at or below
        ``frame`` (play from the journal's start)."""
        best: Optional[Tuple[Frame, bytes]] = None
        for cf, blob in self._checkpoints:
            if cf <= frame:
                best = (cf, blob)
        if best is None:
            self._cursor = self.first_frame
            return self.first_frame, None, None
        cf, blob = best
        self._cursor = cf
        if template is None:
            return cf, blob, None
        from ..utils.checkpoint import loads_pytree

        state, meta = loads_pytree(blob, template)
        return cf, state, meta

    def stacked_inputs(self, n: Optional[int] = None):
        """Consume the next ``n`` frames (default: all remaining) as the
        fast-forward form: ``(inputs, statuses)`` lists stacked on the
        leading axis -- stack ``inputs`` as the game reads them and feed
        them to ``ops.replay.build_scrub_program``.  Playback advances past
        the consumed window, so a later ``advance_frame`` continues from
        there.

        The window is validated BEFORE anything is consumed: asking past the
        end (or across a recorded gap) raises :class:`JournalExhausted` with
        the cursor unmoved."""
        available = self.frames_remaining()
        if n is None:
            n = available
        elif n > available:
            raise JournalExhausted(
                f"asked for {n} frames but only {available} are playable "
                f"from frame {self._cursor} (end of journal or a recorded gap)"
            )
        inputs: List[List[Any]] = []
        statuses: List[List[InputStatus]] = []
        for _ in range(n):
            row = self._inputs_at(self._cursor)
            self._cursor += 1
            inputs.append([v for v, _ in row])
            statuses.append([s for _, s in row])
        return inputs, statuses
