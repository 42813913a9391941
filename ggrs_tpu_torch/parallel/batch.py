"""Session parallelism: many independent sessions batched on one device.

The port of ``ggrs_tpu/parallel/batch.py``'s ``BatchedSessions`` for one
card and no mesh: the JAX package vmaps a per-session program and shards the
batch over chips with ``shard_map``; here every game ``advance`` is
batch-native, so B sessions are one batched replay, and the health
reductions (``psum`` / ``pmin`` over the mesh there) are a plain ``sum`` /
``min`` on device.  Multi-GPU batching is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..convert import from_numpy, to_numpy
from ..core.device import DeviceLike, resolve_device
from ..core.errors import InvalidRequest
from ..ops.replay import I32_MAX, ReplayPrograms, build_replay_programs
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.tracing import trace_span
from ..utils.tree import tree_leaves, tree_map


class BatchedSessions:
    """B independent device-synctest sessions as one batched program.

    All sessions share the same (advance, check_distance) program but have
    independent states, inputs and desync counters.  The host reads two
    scalars per ``verify``, regardless of B."""

    def __init__(
        self,
        advance: Callable[[Any, Any], Any],
        init_state: Any,
        input_template: Any,
        batch_size: int,
        check_distance: int = 2,
        max_prediction: int = 8,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.batch_size = batch_size
        ring_length = max(max_prediction, check_distance) + 1
        self._programs: ReplayPrograms = build_replay_programs(
            advance, ring_length, check_distance
        )
        self.check_distance = check_distance
        self._ticks_run = 0
        self._last_stats: Optional[Dict[str, torch.Tensor]] = None
        self._carry = self._programs.init_carry(
            init_state, input_template, batch_size=batch_size, device=self.device
        )

    @property
    def carry(self) -> Any:
        """The batched carry, ``(B, R, ...)`` leaves as the JAX package's
        ``BatchedSessions`` stacks it (the device buffers themselves)."""
        return self._carry

    @property
    def current_frame(self) -> int:
        return self._ticks_run

    def run_ticks(self, inputs: Any, check: bool = True) -> Optional[Dict[str, int]]:
        """Advance all sessions ``n`` frames.  ``inputs`` leading axes are
        ``(B, n, ...per-frame...)``.  Returns the global stats: total
        mismatches and earliest bad frame across all sessions.

        ``check=False`` defers the stats fetch (nothing is read back from the
        device) and returns None; read the result later with ``verify()``."""
        inputs = from_numpy(inputs, self.device)
        leaf0 = tree_leaves(inputs)[0]
        if leaf0.shape[0] != self.batch_size:
            raise ValueError(
                f"inputs lead with {leaf0.shape[0]} sessions, batch has {self.batch_size}"
            )
        n = leaf0.shape[1]
        if n == 0:
            return {"mismatches": 0, "first_bad": I32_MAX} if check else None
        n_warm = self._programs.split_at_warmup(self._ticks_run, n)
        with trace_span("ggrs:batch_ticks"):
            if n_warm:
                head = tree_map(lambda a: a[:, :n_warm], inputs)
                self._programs.run_warmup(self._carry, head, self._ticks_run)
            if n > n_warm:
                tail = tree_map(lambda a: a[:, n_warm:], inputs)
                self._programs.run_steady(self._carry, tail, self._ticks_run + n_warm)
        self._ticks_run += n
        self._last_stats = {
            "mismatches": self._carry["mismatches"].sum(),
            "first_bad": self._carry["first_bad"].amin(),
        }
        if not check:
            return None
        return self.verify()

    def verify(self) -> Dict[str, int]:
        """Fetch the deferred global stats (one transfer for both scalars)."""
        if self._last_stats is None:
            return {"mismatches": 0, "first_bad": I32_MAX}
        mismatches, first_bad = torch.stack(
            [self._last_stats["mismatches"], self._last_stats["first_bad"].to(torch.int64)]
        ).tolist()
        return {"mismatches": mismatches, "first_bad": first_bad}

    def live_states(self) -> Any:
        """All B live states, fetched to host (leading axis B)."""
        return to_numpy(self._carry["live"])

    # -- durable checkpoints (the reference keeps its saved states in memory) --

    def save_checkpoint(self, path: str) -> None:
        """Write every session's carry, ``(B, ...)`` leaves, and the tick
        count to ``path``, in the JAX package's ``BatchedSessions`` layout."""
        save_pytree(
            path,
            self._carry,
            {
                "ticks_run": self._ticks_run,
                "check_distance": self.check_distance,
                "batch_size": self.batch_size,
            },
        )

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint written by either package's
        ``save_checkpoint`` into this batch (same game, batch_size and
        check_distance), into its preallocated carry."""
        carry, meta = load_pytree(path, self._carry)
        if meta["check_distance"] != self.check_distance:
            raise InvalidRequest(
                f"checkpoint was taken at check_distance="
                f"{meta['check_distance']}, batch uses {self.check_distance}"
            )
        if meta["batch_size"] != self.batch_size:
            raise InvalidRequest(
                f"checkpoint holds {meta['batch_size']} sessions, batch was "
                f"built for {self.batch_size}"
            )
        tree_map(lambda dst, src: dst.copy_(src), self._carry, from_numpy(carry, self.device))
        self._ticks_run = int(meta["ticks_run"])
        self._last_stats = None

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
