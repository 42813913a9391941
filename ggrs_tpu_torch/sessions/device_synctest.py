"""DeviceSyncTestSession: the determinism harness with device-resident state.

The port of ``ggrs_tpu/sessions/device_synctest.py``.  Semantics mirror
``SyncTestSession`` (forced rollback of ``check_distance`` frames every tick
with first-seen checksum comparison,
GGRS src/sessions/sync_test_session.rs:85-150), with every tick
run on device by ``ops.replay``.  Checksum mismatches surface at the end of a
``run_ticks`` batch (or at ``verify()`` when the check is deferred) as
``MismatchedChecksum`` carrying every divergent frame still in the ring
window plus the earliest offender overall.

The session runs one session of the batch-native replay (B = 1).  Its
``carry`` shows the JAX package's single-session layout, ``(R, ...)``
leaves, as views of the batched buffers.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch

from ..convert import from_numpy, to_numpy
from ..core.device import DeviceLike, resolve_device
from ..core.errors import InvalidRequest, MismatchedChecksum
from ..ops.checksum import checksum_device
from ..ops.graphs import synchronize
from ..ops.replay import I32_MAX, ReplayPrograms, build_replay_programs
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.tracing import trace_span
from ..utils.tree import tree_map


def _one_session(leaf: Any) -> Any:
    """A ``(n, ...)`` input leaf as the batch of one, ``(1, n, ...)``: a view."""
    return leaf.unsqueeze(0) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)[None]


class DeviceSyncTestSession:
    """Determinism harness over a batch-native torch ``advance``.

    ``check_distance`` is the forced-rollback depth; ``max_prediction`` only
    sizes the state ring (``max(max_prediction, check_distance) + 1``
    slots)."""

    def __init__(
        self,
        advance: Callable[[Any, Any], Any],
        init_state: Any,
        input_template: Any,
        check_distance: int = 2,
        max_prediction: int = 8,
        checksum: Callable[[Any], torch.Tensor] = checksum_device,
        device: DeviceLike = None,
    ) -> None:
        if check_distance < 1:
            raise InvalidRequest(
                "DeviceSyncTestSession requires check_distance >= 1; with 0 "
                "there is no rollback to fuse -- use the host SyncTestSession."
            )
        self.device = resolve_device(device)
        ring_length = max(max_prediction, check_distance) + 1
        self._programs: ReplayPrograms = build_replay_programs(
            advance, ring_length, check_distance, checksum=checksum
        )
        self._carry = self._programs.init_carry(
            init_state, input_template, batch_size=1, device=self.device
        )
        self._ticks_run = 0
        self.check_distance = check_distance

    @property
    def programs(self) -> ReplayPrograms:
        return self._programs

    # -- durable checkpoints (the reference keeps its saved states in memory) --

    def save_checkpoint(self, path: str) -> None:
        """Write the whole carry (state, input and digest rings, live state,
        desync counters) and the tick count to ``path``, in the JAX package's
        single-session layout: a JAX ``DeviceSyncTestSession`` loads it."""
        save_pytree(
            path, self.carry,
            {"ticks_run": self._ticks_run, "check_distance": self.check_distance},
        )

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint written by either package's
        ``save_checkpoint`` for the same game and config (leaf shapes and
        dtypes and check_distance are validated), into the session's
        preallocated carry."""
        carry, meta = load_pytree(path, self.carry)
        if meta["check_distance"] != self.check_distance:
            raise InvalidRequest(
                f"checkpoint was taken at check_distance="
                f"{meta['check_distance']}, session uses {self.check_distance}"
            )
        tree_map(lambda dst, src: dst.copy_(src), self.carry, from_numpy(carry, self.device))
        self._ticks_run = int(meta["ticks_run"])

    @property
    def carry(self) -> Any:
        """The session carry in the JAX package's single-session layout:
        views of the device buffers, so writes through them reach the
        session."""
        return tree_map(lambda leaf: leaf[0], self._carry)

    @property
    def current_frame(self) -> int:
        return self._ticks_run

    @property
    def resim_frames_per_tick(self) -> int:
        """Resimulated (rolled-back) frames per steady tick."""
        return self.check_distance

    @property
    def requests_per_tick(self) -> int:
        """Request-list equivalents fused per steady tick (2d+2, the
        reference's per-tick workload -- SURVEY §3.3)."""
        return 2 * self.check_distance + 2

    def run_ticks(self, inputs: Any, check: bool = True) -> None:
        """Advance ``n`` frames with ``inputs`` (leading axis = ticks, then the
        per-frame input shape, e.g. ``(n, P)`` u8 for BoxGame; numpy arrays
        or tensors).

        Splits the batch across the warmup boundary, then raises
        ``MismatchedChecksum`` if any resimulated frame diverged from its
        first-seen checksum.  ``check=False`` defers the check to
        ``verify()``: the call then reads nothing back from the device."""
        with trace_span("ggrs:tick"):
            n = self._programs.run_ticks(self._carry, tree_map(_one_session, inputs),
                                         self._ticks_run)
            self._ticks_run += n
            if check and n:
                self._raise_on_mismatch()

    def verify(self) -> None:
        """Raise ``MismatchedChecksum`` if any deferred ``run_ticks`` batch
        saw a resimulation diverge."""
        self._raise_on_mismatch()

    def live_state(self) -> Any:
        """The current (frame ``current_frame``) game state, fetched to host
        as numpy arrays."""
        return to_numpy(self.carry["live"])

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            synchronize(self.device)

    # ------------------------------------------------------------------

    def _raise_on_mismatch(self) -> None:
        # one transfer for both scalars
        with trace_span("ggrs:tick.read"):
            mismatches, first_bad = torch.stack(
                [self._carry["mismatches"][0], self._carry["first_bad"][0]]
            ).tolist()
        if mismatches:
            raise MismatchedChecksum(
                self._ticks_run, self._window_mismatched_frames(first_bad)
            )

    def _window_mismatched_frames(self, first_bad: int) -> List[int]:
        """Every frame still in the ring whose saved (resimulated) digest
        differs from its first-seen history digest, plus the earliest bad
        frame overall.  Only runs on the failure path.  A slot is comparable
        when it still holds the newest frame for both arrays: ring saves lag
        the history by one frame, so the slot of the current frame is
        history-only and excluded."""
        carry = to_numpy(
            {
                "frames": self._carry["ring"]["frames"][0],
                "checksums": self._carry["ring"]["checksums"][0],
                "hist": self._carry["hist"][0],
            }
        )
        ring_frames, ring_cs, hist = carry["frames"], carry["checksums"], carry["hist"]
        t = self._ticks_run
        r = len(ring_frames)
        frames = set()
        if first_bad != I32_MAX:
            frames.add(first_bad)
        for i in range(r):
            f = int(ring_frames[i])
            if f < 0 or f + r <= t or i == t % r:
                continue  # never saved / stale slot / history is one ahead
            if np.any(ring_cs[i] != hist[i]):
                frames.add(f)
        return sorted(frames)
