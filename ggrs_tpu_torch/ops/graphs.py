"""CUDA graphs of the request path: the counterpart of the JAX package's
``jax.jit`` for ``ops/executor.py``'s programs and the session pool's masked
tick.

A ``GraphSet`` holds the graphs of one device that replay one at a time:
they are captured on one side stream and share one private memory pool.
Each graph writes only into static buffers allocated outside its capture,
so nothing a capture allocates outlives it, and the graphs of a set can
replay in any order.  ``GraphSet.capture(body)`` records ``body`` (a
function of no arguments over those buffers) as a ``Graph``; its
``replay`` runs the recorded kernels again on whatever the buffers then
hold.  The digest launches the capture recorded move onto the replays
(``digest.GraphLaunches``), so ``state_digest.launches`` keeps counting
kernels the card ran.

A capture runs nothing, so whatever ``body`` does once lazily (a game's
device constants, the digest library's first launch) must have run eagerly
before the first capture: each user rehearses its body once first.  A
capture that fails raises; nothing falls back to the eager body.

CUDA refuses a device-wide synchronisation while any stream of the process
captures, and ``torch.cuda.graph`` synchronises the device before it
begins.  So the process captures one graph at a time (``CAPTURE_LOCK``),
and the package's own device synchronisations (``synchronize``) wait for a
capture on another thread to end.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

from .digest import GraphLaunches

# held for each capture, and by ``synchronize``
CAPTURE_LOCK = threading.RLock()


def synchronize(device: torch.device) -> None:
    """``torch.cuda.synchronize(device)``, outside any capture of the
    process's other threads."""
    with CAPTURE_LOCK:
        torch.cuda.synchronize(device)


def _record(graphs: "GraphSet", body: Callable[[], None]) -> torch.cuda.CUDAGraph:
    """Capture ``body`` as a CUDA graph on the set's side stream and pool.

    "thread_local": only this thread is barred from the calls that are
    unsafe during a capture; threads launching on other streams are not."""
    current = torch.cuda.current_stream(graphs.device)
    if graphs.stream is None:
        graphs.stream = torch.cuda.Stream(graphs.device)
    graphs.stream.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    with CAPTURE_LOCK, torch.cuda.graph(graph, pool=graphs.pool, stream=graphs.stream,
                                        capture_error_mode="thread_local"):
        body()
    current.wait_stream(graphs.stream)
    if graphs.pool is None:
        graphs.pool = graph.pool()
    return graph


class Graph:
    """One captured graph of a ``GraphSet`` and the digest launches it holds."""

    def __init__(self, owner: "GraphSet", graph, launches: GraphLaunches) -> None:
        self.owner = owner
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        self.launches.replayed()
        self.owner.replays += 1


class GraphSet:
    """The graphs of one device: a side stream, a private pool shared by
    every capture, and the counts of captures and replays."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = None
        self.pool = None
        self.captures = 0
        self.replays = 0

    def capture(self, body: Callable[[], None]) -> Graph:
        launches = GraphLaunches()
        with launches.capturing():
            graph = _record(self, body)
        self.captures += 1
        return Graph(self, graph, launches)
