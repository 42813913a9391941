"""What every hand-written kernel's wrapper shares: the library call on a
device's current stream, the row stride at which a kernel reads a tensor's
rows in place, and the launch counts that follow kernels into CUDA graphs.

The wrappers are the digest's (``ops/digest.py``) and the games' advance
kernels' (``games/_card.py``).  Each library entry takes the stream last
and returns a CUDA error code; ``call`` passes the device's current stream,
makes the device current where it is not (the library launches on the
current device), and raises on an error.

A wrapper given to ``count_launches`` has a ``launches`` count of its
kernel's launches on the card, which it adds to by ``count_launch``.  A
wrapper called while a CUDA graph is captured launches nothing yet, and
each replay of the graph launches again without calling it:
``GraphLaunches`` moves the capture's count onto the replays, so the counts
keep meaning kernels the card ran.  A capture takes only its own thread's
launches: what other threads launch meanwhile stays on the counters.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch


def row_stride(shape, strides, batch_dims: int) -> Optional[int]:
    """Elements from one row to the next of a tensor of this shape and these
    strides, where its first ``batch_dims`` axes index evenly strided rows
    whose elements are contiguous; None otherwise."""
    expect = 1
    for size, stride in zip(reversed(shape[batch_dims:]), reversed(strides[batch_dims:])):
        if size != 1 and stride != expect:
            return None
        expect *= size
    row, span = None, 1
    for size, stride in zip(reversed(shape[:batch_dims]), reversed(strides[:batch_dims])):
        if size == 1:
            continue
        if row is None:
            row = stride
        elif stride != row * span:
            return None
        span *= size
    return expect if row is None else row


def call(what: str, fn: Callable[..., int], args: Sequence[Any], device: torch.device) -> None:
    """The library's ``fn(*args, stream)`` on ``device``'s current stream;
    raises, naming the ``what`` kernel, on a CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:  # the library launches on the current device
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


# the wrappers whose ``launches`` follow their kernels into CUDA graphs
_COUNTED: List[Any] = []
# the capture in progress on each thread (by thread id), if any
_captures: Dict[int, "GraphLaunches"] = {}


def count_launches(wrapper: Any) -> Any:
    """Give ``wrapper`` a ``launches`` count, from 0, that ``count_launch``
    adds to and ``GraphLaunches`` moves from a graph's capture onto its
    replays; returns ``wrapper``."""
    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


def count_launch(wrapper: Any) -> None:
    """One launch of ``wrapper``'s kernel.  While another thread captures a
    graph, the launch is noted as foreign to that capture, which then leaves
    it counted."""
    wrapper.launches += 1
    if _captures:
        me = threading.get_ident()
        for tid, graph in list(_captures.items()):
            if tid != me and wrapper in graph.foreign:
                graph.foreign[wrapper] += 1


class GraphLaunches:
    """The counted launches one CUDA graph holds.

    ``capturing()`` wraps the graph's capture: it records how much each
    counter grew on this thread (the launches the graph captured) and sets
    it back, since a capture runs no kernel; launches that other threads
    counted meanwhile (``foreign``) stay counted.  ``replayed()`` adds the
    graph's counts to the counters, once for each replay of the graph."""

    def __init__(self) -> None:
        self.counts: Dict[Any, int] = {}
        self.foreign: Dict[Any, int] = {}

    @contextlib.contextmanager
    def capturing(self) -> Iterator[None]:
        before = {w: w.launches for w in _COUNTED}
        self.foreign = dict.fromkeys(before, 0)
        tid = threading.get_ident()
        outer = _captures.get(tid)
        _captures[tid] = self
        try:
            yield
        finally:
            if outer is None:
                del _captures[tid]
            else:
                _captures[tid] = outer
            f = self.foreign
            self.counts = {w: w.launches - n - f[w] for w, n in before.items()}
            for w, n in before.items():
                w.launches = n + f[w]

    def replayed(self) -> None:
        for w, n in self.counts.items():
            w.launches += n
