"""The system under test: the port's SyncTest replay, through its public
entry points.  This is the only module of the benchmark that imports the
program (``ggrs_tpu_torch``).

A configuration names its game's class (``program.class``, a dotted path
into the port, and ``program.kwargs``).  A traffic mix's ``entry`` picks the
session: ``BatchedSessions`` for a batch, ``DeviceSyncTestSession`` for one
session.  One call is ``run_ticks`` with ``check=True``: it returns once the
mismatch count is on the host.
"""

from __future__ import annotations

import gc
import importlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ggrs_tpu_torch.core.errors import MismatchedChecksum
from ggrs_tpu_torch.parallel.batch import BatchedSessions
from ggrs_tpu_torch.sessions.device_synctest import DeviceSyncTestSession

def make_game(config: dict) -> Any:
    module, _, name = config["program"]["class"].rpartition(".")
    return getattr(importlib.import_module(module), name)(**config["program"].get("kwargs", {}))


class Program:
    """One session (or batch of sessions) of the cell, on ``device``.

    ``advance`` replaces the game's own step (the control and the faults put
    theirs in its place); None runs the game's."""

    def __init__(self, config: dict, entry: str, sessions: int, start: Dict[str, np.ndarray],
                 device: str, advance: Optional[Callable] = None) -> None:
        self.game = make_game(config)
        self.entry = entry
        step = self.game.advance if advance is None else advance
        template = np.zeros(int(config["players"]), np.uint8)
        d, mp = int(config["check_distance"]), int(config["max_prediction"])
        if entry == "single":
            self.sess = DeviceSyncTestSession(step, start, template, check_distance=d,
                                              max_prediction=mp, device=device)
        elif entry == "batched":
            self.sess = BatchedSessions(step, start, template, batch_size=sessions,
                                        check_distance=d, max_prediction=mp, device=device)
        else:
            raise ValueError(f"entry {entry!r} is not known")
        self.mismatches = 0

    @property
    def warmup_ticks(self) -> int:
        return self.sess.programs.warmup_ticks

    @property
    def ring_length(self) -> int:
        return self.sess.programs.ring.length

    def call(self, inputs: np.ndarray) -> bool:
        """One ``run_ticks`` call with ``check=True``; False where it
        reported a new mismatch."""
        if self.entry == "single":
            try:
                self.sess.run_ticks(inputs, check=True)
            except MismatchedChecksum:
                return False
            return True
        return self._seen(self.sess.run_ticks(inputs, check=True))

    def launch(self, inputs: np.ndarray) -> None:
        """The part of ``call`` before its read: ``run_ticks`` with
        ``check=False``.  ``launch`` then ``read`` is ``call``'s work, as
        both entries define ``check=True``."""
        self.sess.run_ticks(inputs, check=False)

    def read(self) -> bool:
        """The rest of ``call``: the session's ``verify``, the read of the
        mismatch count."""
        if self.entry == "single":
            try:
                self.sess.verify()
            except MismatchedChecksum:
                return False
            return True
        return self._seen(self.sess.verify())

    def _seen(self, stats: Dict[str, int]) -> bool:
        ok = stats["mismatches"] == self.mismatches
        self.mismatches = stats["mismatches"]
        return ok

    def carry(self) -> Dict[str, Any]:
        """The carry in the batched layout (leaves (B, ...)), copied to the
        host."""
        carry = self.sess.carry
        if self.entry == "single":
            carry = _tree(lambda leaf: leaf.unsqueeze(0), carry)
        return _tree(lambda leaf: leaf.to("cpu"), carry)

    def close(self) -> None:
        """Free the program's device memory (the sessions, their graphs and
        pools)."""
        self.sess = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def _tree(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)
