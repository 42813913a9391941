"""Entry ``single``: one ``DeviceSyncTestSession``, a game client's own
match (GGRS's ``ex_game_synctest`` runs one session).  A mix of this entry
holds 1 session."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from benchmark.entries.synctest import SyncTest, map_tree
from ggrs_tpu_torch.core.errors import MismatchedChecksum
from ggrs_tpu_torch.sessions.device_synctest import DeviceSyncTestSession


class Entry(SyncTest):
    def __init__(self, config: dict, traffic: dict, start: Dict[str, np.ndarray],
                 device: str, advance: Optional[Callable] = None) -> None:
        if int(traffic["sessions"]) != 1:
            raise ValueError("a single session's traffic has 1 session")
        super().__init__(config, traffic, start, device, advance)

    def session(self, step, start, template, d, max_prediction, device) -> Any:
        return DeviceSyncTestSession(step, start, template, check_distance=d,
                                     max_prediction=max_prediction, device=device)

    def inputs(self, rows: np.ndarray) -> np.ndarray:
        return rows[:, 0]

    def call(self, rows: np.ndarray) -> bool:
        """One ``run_ticks`` call with ``check=True``; False where it raised
        a mismatch."""
        try:
            self.sess.run_ticks(self.inputs(rows), check=True)
        except MismatchedChecksum:
            return False
        return True

    def read(self) -> bool:
        """The rest of ``call``: the session's ``verify``."""
        try:
            self.sess.verify()
        except MismatchedChecksum:
            return False
        return True

    def carry(self) -> Dict[str, Any]:
        """The carry in the batched layout (leaves (1, ...))."""
        return map_tree(lambda leaf: leaf.unsqueeze(0), self.sess.carry)
