"""The SyncTest replay, shared by its two entries: ``single.py`` (one
``DeviceSyncTestSession``, a game client's own match) and ``batched.py`` (B
sessions in ``BatchedSessions``, a match host).

One call is ``run_ticks`` with ``check=True``: it returns once the mismatch
count is on the host.  A tick reloads frame F - d, resimulates d frames,
digests and saves each, compares each digest with the first one seen, and
advances live; so every tick rolls back exactly d frames, and a window of
``calls`` calls resimulates B × d × ``ticks_per_call`` × ``calls`` frames,
whatever the inputs.

The check holds the program's whole carry, session by session and exactly
(the game and the digest are integer arithmetic), against
``reference/replay.py``'s expected carry after every tick the program ran.
Each count is the sessions that differ, and every limit is 0:

- ``live_rows_off``: the live state or the frame counter differs (the game
  advance);
- ``ring_rows_off``: a saved ring slot differs in its state, digest or
  frame number, or the input ring differs (the ring and the digest kernel);
- ``digest_rows_off``: the first-seen digest history differs, or the
  mismatch count is not 0, or a first bad frame is named (the digests the
  replay tick's compare reads, and its verdict).

The control (the reference in float32 in the program's place) makes every
session differ in all three; a float step is as repeatable as an integer
one, so the control alone never trips the compare's counters, and they are
read inside ``digest_rows_off``, which the control separates.

From ``ON_CARD_FROM`` sessions the reference runs on the card, and the
comparison with it: the program's carry stays where it lies, and only the
counts come to the host.  Below, both run on the CPU.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from benchmark import check
from benchmark.program import make_game
from benchmark.reference import replay

ON_CARD_FROM = 64


class SyncTest:
    """The SyncTest session of the cell, on ``device``; a subclass makes the
    session (``session``) and drives it (``call``, ``launch``'s layout in
    ``inputs``, ``read``, ``carry``).

    ``advance`` replaces the game's own step (the control and the faults put
    theirs in its place); None runs the game's."""

    limits = {"live_rows_off": 0, "ring_rows_off": 0, "digest_rows_off": 0}

    def __init__(self, config: dict, traffic: dict, start: Dict[str, np.ndarray],
                 device: str, advance: Optional[Callable] = None) -> None:
        self.config, self.device = config, device
        self.game = make_game(config)
        self.sessions = int(traffic["sessions"])
        self.ticks_per_call = int(traffic["ticks_per_call"])
        self.check_distance = int(config["check_distance"])
        step = self.game.advance if advance is None else advance
        template = np.zeros(int(config["players"]), np.uint8)
        self.sess = self.session(step, start, template, self.check_distance,
                                 int(config["max_prediction"]), device)
        programs = self.sess.programs
        self.ring_length = programs.ring.length
        # the replay's warmup ticks, then two ring periods of steady ticks
        # (the first captures each phase's CUDA graph)
        self.warmup_calls = -(-(programs.warmup_ticks + 2 * self.ring_length)
                              // self.ticks_per_call)

    def session(self, step: Callable, start: Dict[str, np.ndarray], template: np.ndarray,
                d: int, max_prediction: int, device: str) -> Any:
        raise NotImplementedError

    def inputs(self, rows: np.ndarray) -> np.ndarray:
        """A call's ``(n, B, P)`` rows in the session's layout."""
        raise NotImplementedError

    def launch(self, rows: np.ndarray) -> None:
        """The part of ``call`` before its read: ``run_ticks`` with
        ``check=False``.  ``launch`` then ``read`` is ``call``'s work, as
        both entries define ``check=True``."""
        self.sess.run_ticks(self.inputs(rows), check=False)

    def resim_frames(self, calls: int) -> int:
        return self.sessions * self.check_distance * calls * self.ticks_per_call

    def check(self, reference, traffic, calls: int) -> Dict[str, int]:
        """The carry after ``calls`` calls against the reference's, the
        program freed but for its carry."""
        got = self.carry()
        self.close()
        on = "cpu" if self.device == "cpu" or self.sessions < ON_CARD_FROM else self.device
        got = map_tree(lambda leaf: leaf.to(on), got)
        start = {k: v.to(on).expand(self.sessions, *v.shape) for k, v in traffic.start.items()}
        want = replay.expected_carry(reference, self.config, start, traffic.tick_inputs_on(on),
                                     calls * self.ticks_per_call, self.ring_length)
        return compare(got, want)

    def close(self) -> None:
        """Free the program's device memory (the sessions, their graphs and
        pools)."""
        self.sess = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def compare(got: Dict, want: Dict) -> Dict[str, int]:
    """The three counts, from the program's carry and the expected one (in
    the batched layout, on one device)."""
    ring = got["ring"]
    live = check.rows_off(got["live"], want["live"]) | check.rows_off(got["frame"], want["frame"])
    saved = (check.rows_off(ring["states"], want["ring"]["states"])
             | check.rows_off(check.digests(ring["checksums"]), want["ring"]["checksums"])
             | check.rows_off(ring["frames"], want["ring"]["frames"])
             | check.rows_off(got["inputs"], want["inputs"]))
    digests = (check.rows_off(check.digests(got["hist"]), want["hist"])
               | check.rows_off(got["mismatches"], want["mismatches"])
               | check.rows_off(got["first_bad"], want["first_bad"]))
    return {"live_rows_off": int(live.sum()), "ring_rows_off": int(saved.sum()),
            "digest_rows_off": int(digests.sum())}


def map_tree(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)
