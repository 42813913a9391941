"""Device-resident state ring, batched over sessions.

The JAX package's ``DeviceStateRing`` is functional (every save returns new
buffers; donation makes it in place on the TPU).  Here the ring is a dict of
preallocated tensors updated IN PLACE::

    {"states": pytree of (B, R, ...), "checksums": (B, R, 4) int32,
     "frames": (B, R) int32}

with the session axis first, as ``BatchedSessions`` stacks the JAX carry.
Frames and slots are host ints (``frame % R``): sessions tick in lockstep, so
every ring access is a shared-index slice, never a per-session scatter.
A consecutive window of frames wraps the ring at most once, so window reads
and writes are at most two slices each.
"""

from __future__ import annotations

from typing import Any

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

    def _spans(self, first_frame: int, n: int):
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

    def read_window(self, buf: torch.Tensor, first_frame: int, n: int) -> torch.Tensor:
        """``(B, n, ...)`` entries of a ``(B, R, ...)`` buffer for ``n``
        consecutive frames (a view when the window does not wrap)."""
        spans = self._spans(first_frame, n)
        if len(spans) == 1:
            return buf[:, spans[0][0]]
        return torch.cat([buf[:, rs] for rs, _ in spans], dim=1)

    def write_window(self, buf: torch.Tensor, first_frame: int, vals: torch.Tensor) -> None:
        """In place: ``buf``'s slots for ``vals.shape[1]`` consecutive
        frames from ``first_frame`` take ``vals`` (``(B, n, ...)``)."""
        for rs, ws in self._spans(first_frame, vals.shape[1]):
            buf[:, rs] = vals[:, ws]

    # -- save / load (in place) ------------------------------------------

    def save(self, ring: Any, frame: int, state: Any, checksum: torch.Tensor) -> Any:
        """Write ``state`` (leaves ``(B, ...)``) and its ``(B, 4)`` checksum
        into the slot for ``frame``."""
        i = self.slot(frame)
        tree_map(lambda buf, leaf: buf[:, i].copy_(leaf), ring["states"], state)
        ring["checksums"][:, i] = checksum
        ring["frames"][:, i] = frame
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
        n = checksums.shape[1]
        tree_map(
            lambda buf, leaf: self.write_window(buf, first_frame, leaf),
            ring["states"],
            states,
        )
        self.write_window(ring["checksums"], first_frame, checksums)
        frames = torch.arange(
            first_frame, first_frame + n, dtype=torch.int32, device=checksums.device
        ).expand(checksums.shape[0], n)
        self.write_window(ring["frames"], first_frame, frames)
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

