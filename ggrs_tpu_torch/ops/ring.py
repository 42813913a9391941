"""Device-resident state ring, batched over sessions.

The JAX package's ``DeviceStateRing`` is functional (every save returns new
buffers; donation makes it in place on the TPU).  Here the ring is a dict of
preallocated tensors updated IN PLACE::

    {"states": pytree of (B, R, ...), "checksums": (B, R, 4) int32,
     "frames": (B, R) int32}

with the session axis first, as ``BatchedSessions`` stacks the JAX carry.
Those are the shapes; the storage behind them may be slot-major (the lockstep
replay's carry, ``ops/replay.py::ReplayPrograms.init_carry``: ``(R, B, ...)``
tensors seen through ``transpose(0, 1)``, so a slot is one contiguous block),
and every method but the per-row ones below works on either.
Slots are host ints (``frame % R``): sessions that tick in lockstep share
one slot, so a ring access is a shared-index slice.  A consecutive window
of frames wraps the ring at most once, so it is at most two slices
(``spans``).  The frame numbers a save writes into ``frames`` may come from
a device tensor instead (``stamp``), as the JAX scan takes its frame as a
traced input: a CUDA graph captured at one frame then writes the right
numbers at every frame of its slot.

Sessions that do not tick in lockstep (the pool of ``parallel.session_pool``,
where each session saves and loads its own frame) use ``save_rows`` and
``load_rows``: a scatter and a gather over flat ``(session, slot)`` indices
that the host builds (``flat_index``), the JAX package's ``vmap`` of
``save_where`` and ``load`` over a per-session frame.  ``save_rows_where``
is the fixed-shape form that the pool's CUDA graphs run: every row writes,
and a row the mask does not take writes back its slot's own contents.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map
from .checksum import CHECKSUM_LANES


class DeviceStateRing:
    def __init__(self, length: int) -> None:
        if length < 1:
            raise ValueError("ring length must be >= 1")
        self.length = length

    # -- construction --------------------------------------------------

    def init(self, template_state: Any) -> Any:
        """Ring buffers with ``template_state`` (leaves ``(B, ...)``) copied
        into every slot; slot frames start as NULL_FRAME = -1."""
        r = self.length
        states = tree_map(
            lambda leaf: leaf.unsqueeze(1).expand(leaf.shape[0], r, *leaf.shape[1:]).clone(),
            template_state,
        )
        leaf0 = tree_leaves(template_state)[0]
        b, dev = leaf0.shape[0], leaf0.device
        return {
            "states": states,
            "checksums": torch.zeros((b, r, CHECKSUM_LANES), dtype=torch.int32, device=dev),
            "frames": torch.full((b, r), -1, dtype=torch.int32, device=dev),
        }

    # -- index math ----------------------------------------------------

    def slot(self, frame: int) -> int:
        """``frame % R`` for a host-int frame (frame >= 0)."""
        return frame % self.length

    def spans(self, first_frame: int, n: int):
        """(ring slice, window slice) pairs covering ``n`` consecutive frames
        from ``first_frame``: one pair, or two where the window wraps."""
        if n > self.length:
            raise ValueError(f"window of {n} frames exceeds ring length {self.length}")
        s = self.slot(first_frame)
        k = min(n, self.length - s)
        spans = [(slice(s, s + k), slice(0, k))]
        if k < n:
            spans.append((slice(0, n - k), slice(k, n)))
        return spans

    # -- save / load (in place) ------------------------------------------

    def save(
        self, ring: Any, frame: int, state: Any, checksum: torch.Tensor,
        stamp: Optional[torch.Tensor] = None,
    ) -> Any:
        """Write ``state`` (leaves ``(B, ...)``) and its ``(B, 4)`` checksum
        into the slot for ``frame``, and the frame number: ``stamp`` (a
        ``(B,)`` int32 tensor) where given, else ``frame``."""
        i = self.slot(frame)
        tree_map(lambda buf, leaf: buf[:, i].copy_(leaf), ring["states"], state)
        ring["checksums"][:, i] = checksum
        ring["frames"][:, i] = frame if stamp is None else stamp
        return ring

    def save_where(
        self, ring: Any, frame: int, state: Any, checksum: torch.Tensor, pred: torch.Tensor
    ) -> Any:
        """Predicated ``save``: session ``b``'s slot keeps its contents where
        ``pred[b]`` (a ``(B,)`` bool tensor) is false."""
        i = self.slot(frame)

        def upd(buf: torch.Tensor, val: Any) -> None:
            cur = buf[:, i]
            p = pred.reshape(pred.shape[0], *([1] * (cur.dim() - 1)))
            cur.copy_(torch.where(p, torch.as_tensor(val, dtype=buf.dtype, device=buf.device), cur))

        tree_map(upd, ring["states"], state)
        upd(ring["checksums"], checksum)
        upd(ring["frames"], frame)
        return ring

    def save_many(
        self, ring: Any, first_frame: int, states: Any, checksums: torch.Tensor
    ) -> Any:
        """Write ``n`` consecutive saves (frames ``first_frame ..
        first_frame + n - 1``, n <= R so the slots are distinct) in at most
        two slice copies per buffer.  ``states`` leaves are ``(B, n, ...)``,
        ``checksums`` is ``(B, n, 4)``."""
        b, n = checksums.shape[:2]
        frames = torch.arange(first_frame, first_frame + n, dtype=torch.int32,
                              device=checksums.device).expand(b, n)

        def write(buf: torch.Tensor, vals: torch.Tensor) -> None:
            for rs, ws in self.spans(first_frame, n):
                buf[:, rs] = vals[:, ws]

        tree_map(write, ring["states"], states)
        write(ring["checksums"], checksums)
        write(ring["frames"], frames)
        return ring

    def load(self, ring: Any, frame: int) -> Any:
        """The state stored in the slot for ``frame``: ``(B, ...)`` VIEWS of
        the ring buffers (valid until the slot is written again)."""
        i = self.slot(frame)
        return tree_map(lambda buf: buf[:, i], ring["states"])

    def load_checksum(self, ring: Any, frame: int) -> torch.Tensor:
        return ring["checksums"][:, self.slot(frame)]

    def frame_at(self, ring: Any, frame: int) -> torch.Tensor:
        """The frame number actually stored in ``frame``'s slot, per session
        (NULL_FRAME if never written)."""
        return ring["frames"][:, self.slot(frame)]

    # -- per-row slots (each session its own frame) ---------------------

    def flat_index(self, rows: np.ndarray, frames: np.ndarray) -> np.ndarray:
        """Host: the flat ``(session, slot)`` index ``row * R + frame % R``
        (int64) of session ``rows[i]``'s slot for ``frames[i]``."""
        rows = np.asarray(rows, np.int64)
        return rows * self.length + np.asarray(frames, np.int64) % self.length

    @staticmethod
    def _slots(buf: torch.Tensor) -> torch.Tensor:
        """``(B, R, ...)`` as a ``(B * R, ...)`` view (raises rather than
        copy, so the writes below always land in the ring)."""
        return buf.view(-1, *buf.shape[2:])

    def save_rows(
        self, ring: Any, index: torch.Tensor, state: Any, checksum: torch.Tensor,
        frames: torch.Tensor, rows: Optional[torch.Tensor] = None,
    ) -> Any:
        """In place, the per-row masked save: session ``rows[i]``'s row of
        ``state`` (leaves ``(B, ...)``) and of ``checksum`` (``(B, 4)``), and
        the frame ``frames[i]``, go to flat slot ``index[i]`` (from
        ``flat_index``).  ``rows`` lists the sessions that save (those the
        mask takes); None means every session, in order.  Each session
        writes one slot of its own ring, so the indices are distinct."""
        pick = (lambda v: v) if rows is None else (lambda v: v.index_select(0, rows))
        tree_map(lambda buf, leaf: self._slots(buf).index_copy_(0, index, pick(leaf)),
                 ring["states"], state)
        self._slots(ring["checksums"]).index_copy_(0, index, pick(checksum))
        ring["frames"].view(-1).index_copy_(0, index, frames)
        return ring

    def save_rows_where(
        self, ring: Any, index: torch.Tensor, state: Any, checksum: torch.Tensor,
        frames: torch.Tensor, mask: torch.Tensor,
    ) -> Any:
        """In place, the fixed-shape per-row masked save, the counterpart of
        the JAX ring's ``save_where`` under ``vmap``: row ``b`` of ``state``
        (leaves ``(B, ...)``), of ``checksum`` (``(B, 4)``) and the frame
        ``frames[b]`` go to flat slot ``index[b]`` where ``mask[b]`` (all
        ``(B,)`` tensors).  Every row writes, so the shapes never depend on
        the mask: a row the mask does not take writes back what its slot
        ``index[b]`` (any slot of its own ring) already holds, which is
        bitwise what skipping it does."""

        def upd(buf: torch.Tensor, val: torch.Tensor) -> None:
            slots = self._slots(buf)
            old = slots.index_select(0, index)
            keep = mask.view(-1, *([1] * (old.dim() - 1)))
            slots.index_copy_(0, index, torch.where(keep, val, old))

        tree_map(upd, ring["states"], state)
        upd(ring["checksums"], checksum)
        upd(ring["frames"], frames)
        return ring

    def load_rows(self, ring: Any, index: torch.Tensor) -> Any:
        """The state in flat slot ``index[b]`` for each row ``b``: ``(B,
        ...)`` COPIES (a later write to the slot leaves them alone)."""
        return tree_map(lambda buf: self._slots(buf).index_select(0, index), ring["states"])
