"""A call's host inputs on their way into the replay's input ring.

``InputStage`` keeps one persistent host block a leaf of a call's inputs,
laid out ``(n, B, ...)``: row t holds tick t's inputs of every session as
one contiguous ``(B, ...)`` block, the layout of an input ring slot
(``ops/replay.py``).  So a call's inputs reach the host block in one copy a
leaf, and each tick's row goes into its ring slot in one host-to-device
copy, with no device block between.  For a CUDA device the blocks are
pinned, so that copy does not make the host wait.

Each block has two buffers, which calls take in turns, and each buffer a
CUDA event that ``sent`` records after the copies that read it.  A call
waits on its buffer's event only where those copies have not completed:
calls issued back to back with nothing read between them
(``run_ticks(check=False)``) then never overwrite inputs still on their way
to the card.

A block grows only when a call carries more ticks than any call before it
(or a leaf of another layout); ``allocations`` counts the host buffers made.
u32 leaves are staged as int32 of the same bits, as ``convert.py`` sends
them.  A leaf that is already a CUDA tensor is not staged.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import tree_map


def _host_view(leaf: Any) -> torch.Tensor:
    """A host leaf (a numpy array, read-only ones included, or a tensor) as
    a tensor over the same memory: no copy; u32 as int32 of the same bits."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if arr.flags.writeable:
        return torch.from_numpy(arr)
    # only read here: torch warns that the tensor could write the array
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


class InputStage:
    """The persistent host blocks of the inputs bound for ``device``
    (module docstring): pinned for a CUDA device, plain memory otherwise."""

    def __init__(self, device: torch.device) -> None:
        self.pinned = torch.device(device).type == "cuda"
        self.allocations = 0
        # per leaf, in tree order: its two buffers, (capacity, B, ...) each
        self._blocks: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._events: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 1  # the buffer of the current call

    def put(self, inputs: Any) -> Any:
        """``inputs`` (leaves ``(B, n, ...)``) copied into a free buffer, one
        copy a host leaf, and returned as ``(B, n, ...)`` views of its rows:
        tick t's ``leaf[:, t]`` is row t, one contiguous block.  CUDA tensor
        leaves come back as given."""
        self._turn = buf = self._claim()
        leaf_index = itertools.count()

        def stage(leaf: Any) -> Any:
            i = next(leaf_index)
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                return leaf
            src = _host_view(leaf).transpose(0, 1)  # (n, B, ...)
            rows = self._block(i, src)[buf][:src.shape[0]]
            rows.copy_(src)
            return rows.transpose(0, 1)

        return tree_map(stage, inputs)

    def sent(self) -> None:
        """Marks the copies issued so far from the current call's buffer:
        its event, recorded on the current stream."""
        if self.pinned:
            if self._events[self._turn] is None:
                self._events[self._turn] = torch.cuda.Event()
            self._events[self._turn].record()

    def _claim(self) -> int:
        """The buffer a call writes: the one the last call did not write,
        once the copies from it have completed (waiting only where they
        have not)."""
        buf, event = 1 - self._turn, self._events[1 - self._turn]
        if event is not None and not event.query():
            event.synchronize()
        return buf

    def _block(self, i: int, src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Leaf ``i``'s two buffers, made anew where they are missing, too
        short for ``src``'s ticks or of another layout."""
        if i < len(self._blocks):
            have = self._blocks[i][0]
            if (have.shape[0] >= src.shape[0] and have.shape[1:] == src.shape[1:]
                    and have.dtype == src.dtype):
                return self._blocks[i]
        block = tuple(torch.empty(src.shape, dtype=src.dtype, pin_memory=self.pinned)
                      for _ in range(2))
        self.allocations += 2
        if i < len(self._blocks):
            self._blocks[i] = block
        else:
            self._blocks.append(block)
        return block
