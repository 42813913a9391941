"""Entry ``batched``: B sessions in one ``BatchedSessions``, a match host."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from benchmark.entries.synctest import SyncTest
from ggrs_tpu_torch.parallel.batch import BatchedSessions


class Entry(SyncTest):
    mismatches = 0

    def session(self, step, start, template, d, max_prediction, device) -> Any:
        return BatchedSessions(step, start, template, batch_size=self.sessions,
                               check_distance=d, max_prediction=max_prediction, device=device)

    def inputs(self, rows: np.ndarray) -> np.ndarray:
        return rows.transpose(1, 0, 2)

    def call(self, rows: np.ndarray) -> bool:
        """One ``run_ticks`` call with ``check=True``; False where it
        reported a new mismatch."""
        return self._seen(self.sess.run_ticks(self.inputs(rows), check=True))

    def read(self) -> bool:
        """The rest of ``call``: the session's ``verify``, the read of the
        mismatch count."""
        return self._seen(self.sess.verify())

    def _seen(self, stats: Dict[str, int]) -> bool:
        ok = stats["mismatches"] == self.mismatches
        self.mismatches = stats["mismatches"]
        return ok

    def carry(self) -> Dict[str, Any]:
        """The batched carry, leaves (B, ...), where the program holds it."""
        return self.sess.carry
