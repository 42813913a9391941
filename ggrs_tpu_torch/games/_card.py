"""The games' hand-written advance kernels: their route, their ``out``
contract, their counts, and the checks and the layout of a call on the card.

A game with a kernel makes one ``Kernel`` (``games/boxgame.py``,
``games/vectorwar.py``) from what is its own: its leaf names, its ``read``
(the shape check, then ``check_call`` and ``read_in_place``), its library
entry and the arguments it passes it.  Its ``advance`` is one call of
``Kernel.advance``, which decides the rest:

- the route: a call with a tensor on a CUDA card (``on_card``) takes the
  kernel, others the game's eager body, as does every call of a game
  without a kernel (BoxGame's float variant);
- ``out`` (a ring slot the replay hands the advance to write into): on the
  kernel's route ``outputs`` checks it, or makes the new state where it is
  not given, and the kernel writes it whole; on the eager route the result
  is copied into it;
- the counts: the process registry's ``ggrs_game_advance_total`` (labels
  ``game``, ``route="kernel"`` or ``"eager"``) counts the kernel's launches
  made from Python (a CUDA graph that captured one counts it once; its
  replays launch it with no Python; an empty batch launches nothing) and
  the eager body's calls; the ``Kernel``'s own ``launches`` counts as
  ``ops/kernels.py::count_launches`` does (a graph's capture moves its
  launches onto its replays).

A kernel reads each state leaf and the inputs in place at their own session
stride, so a ring slot view, a slice of the window's inputs and
speculation's expanded branch rows need no copy.  ``check_call`` refuses
what no kernel reads (leaves that are not int32 tensors, inputs that are
not integers, tensors on several devices); ``read_in_place`` gives each
tensor's row stride in bytes, copying a tensor contiguous where its rows are
not evenly strided rows of contiguous inner dimensions, and refuses rows
that a kernel loads in 8-byte pairs where they are not 8-byte aligned.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..obs.registry import default_registry
from ..ops.kernels import call, count_launch, count_launches, row_stride
from ..utils.tree import tree_copy_

ADVANCES = default_registry().counter(
    "ggrs_game_advance_total",
    "Game advances by game and route: kernel launches made from Python, eager calls",
    labels=("game", "route"),
)

# the input dtypes a kernel reads (by the low byte)
INPUT_DTYPES = frozenset({torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64})


def on_card(*tensors: Any) -> bool:
    """Whether any of ``tensors`` is a tensor on a CUDA card (a kernel's
    route)."""
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in tensors)


def check_call(game: str, leaves: Sequence[Any], inputs: Any) -> None:
    """Raises where no kernel reads the call: ``leaves`` and ``inputs`` must
    be tensors on one device, the leaves int32 and the inputs of an integer
    dtype."""
    every = (*leaves, inputs)
    if any(not isinstance(x, torch.Tensor) for x in every):
        raise TypeError(f"{game}.advance on the card: state leaves and inputs must be tensors")
    if len({x.device for x in every}) > 1:
        devices = sorted({str(x.device) for x in every})
        raise ValueError(f"{game}.advance: tensors on several devices {devices}")
    if any(x.dtype != torch.int32 for x in leaves):
        raise TypeError(f"{game}.advance on the card: the state's leaves must be int32, "
                        f"got {[str(x.dtype) for x in leaves]}")
    if inputs.dtype not in INPUT_DTYPES:
        raise TypeError(f"{game}.advance on the card: inputs of {inputs.dtype}, not an integer dtype")


def read_in_place(game: str, tensors: Sequence[torch.Tensor], lead: int,
                  paired: Sequence[int] = (), paired_names: str = "") -> Tuple[tuple, tuple]:
    """``tensors`` as a kernel reads them, and the bytes from one session's
    row to the next of each; ``lead`` is the number of session axes.  A
    tensor whose rows are not evenly strided rows of contiguous inner
    dimensions is made contiguous.  The tensors at the indices ``paired``
    (``paired_names`` in the error) are loaded in 8-byte pairs: raises where
    their rows are not 8-byte aligned."""
    out, strides = [], []
    layouts = tuple((x.shape, x.stride()) for x in tensors)
    for x, stride in zip(tensors, _row_strides(layouts, lead)):
        if stride is None:
            x = x.contiguous()
            stride = row_stride(x.shape, x.stride(), lead)
        out.append(x)
        strides.append(stride * x.element_size())
    if any(out[i].data_ptr() % 8 or strides[i] % 8 for i in paired):
        raise ValueError(f"{game}.advance on the card: {paired_names} rows must be 8-byte aligned")
    return tuple(out), tuple(strides)


@functools.lru_cache(maxsize=256)
def _row_strides(layouts: tuple, lead: int) -> tuple:
    """``row_stride`` of each ``(shape, strides)``, remembered: a replay's
    warmup and captures give the same few layouts again and again."""
    return tuple(row_stride(shape, strides, lead) for shape, strides in layouts)


def _extent(x: torch.Tensor) -> Tuple[int, int]:
    """The bytes ``[start, end)`` that a non-empty tensor's elements span."""
    last = sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    return x.data_ptr(), x.data_ptr() + (last + 1) * x.element_size()


def outputs(game: str, names: Sequence[str], leaves: Sequence[torch.Tensor],
            device: torch.device, out: Optional[Any] = None,
            read: Sequence[torch.Tensor] = ()) -> Dict[str, torch.Tensor]:
    """The new state for the kernel to write whole: an int32 tensor of each
    leaf's shape on ``device``, made here (``torch.empty``, inside a capture
    too); or, where the caller gives ``out`` (a dict of the leaves by
    ``names``), its tensors.  Raises where an ``out`` leaf is not a
    contiguous int32 tensor of its leaf's shape on ``device``, or overlaps
    a tensor of ``read`` (the state and inputs the kernel reads): the
    kernel writes rows back to back while it reads."""
    if out is None:
        return {k: torch.empty(x.shape, dtype=torch.int32, device=device)
                for k, x in zip(names, leaves)}
    got = {k: out[k] for k in names}
    for k, x in zip(names, leaves):
        o = got[k]
        if not isinstance(o, torch.Tensor) or o.dtype != torch.int32 or o.shape != x.shape \
                or o.device != device:
            raise ValueError(f"{game}.advance on the card: out[{k!r}] must be an int32 tensor of "
                             f"shape {tuple(x.shape)} on {device}")
        if not o.is_contiguous():
            raise ValueError(f"{game}.advance on the card: out[{k!r}] of strides {o.stride()} "
                             "is not contiguous rows")
    spans = [_extent(x) for x in read if x.numel()]
    for k, o in got.items():
        if o.numel():
            lo, hi = _extent(o)
            if any(lo < end and start < hi for start, end in spans):
                raise ValueError(f"{game}.advance on the card: out[{k!r}] overlaps the state or "
                                 "inputs it reads")
    return got


class Kernel:
    """A game's advance kernel and its route (module docstring).

    ``game`` names the game in errors, and lowercased in the registry's
    labels; ``names`` are the state's leaves the kernel writes, in its
    order.  ``read(state, inputs)`` gives those leaves and the inputs as the
    kernel reads them and the bytes from one session's row to the next of
    each, or raises where the kernel cannot read the call; ``args(read,
    strides, new, rows)`` the library's arguments but the stream, for
    ``rows`` sessions written into ``new``; ``entry()`` the library's
    function, looked up at each launch."""

    def __init__(self, game: str, names: Sequence[str],
                 read: Callable[[Any, Any], Tuple[tuple, tuple]],
                 args: Callable[[tuple, tuple, Dict[str, torch.Tensor], int], tuple],
                 entry: Callable[[], Callable[..., int]]) -> None:
        self.game = game
        self.names = tuple(names)
        self._read, self._args, self._entry = read, args, entry
        self._launched = ADVANCES.labels(game=game.lower(), route="kernel")
        self._eager = ADVANCES.labels(game=game.lower(), route="eager")
        count_launches(self)

    def __call__(self, state: Any, inputs: torch.Tensor,
                 out: Optional[Any] = None) -> Dict[str, torch.Tensor]:
        """One launch on the inputs' card and current stream: the new state
        in tensors made here, or in ``out``'s (``outputs``), written whole
        by the kernel; no launch for an empty batch."""
        every, strides = self._read(state, inputs)
        inp = every[-1]
        new = outputs(self.game, self.names, every[:-1], inp.device, out, read=every)
        rows = inp.numel() // inp.shape[-1]
        if rows:
            call(f"{self.game} advance", self._entry(), self._args(every, strides, new, rows),
                 inp.device)
            count_launch(self)
            self._launched.inc()
        return new

    def advance(self, eager: Callable[[Any, Any], Dict[str, torch.Tensor]], state: Any,
                inputs: Any, out: Optional[Any] = None,
                kernel: bool = True) -> Dict[str, torch.Tensor]:
        """One step: the kernel where ``kernel`` and the call is on the card,
        else ``eager(state, inputs)``; where ``out`` is given the new state
        is written there and ``out`` returned."""
        if kernel and on_card(inputs, *(state[k] for k in self.names)):
            return self(state, inputs, out)
        self._eager.inc()
        new = eager(state, inputs)
        return new if out is None else tree_copy_(out, new)
