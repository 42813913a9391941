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
hold.  The counted launches the capture recorded (the digest's and the
games' advance kernels') move onto the replays
(``kernels.GraphLaunches``), so their ``launches`` keep counting kernels
the card ran.

A capture runs nothing, so whatever ``body`` does once lazily (a game's
device constants, the digest library's first launch) must have run eagerly
before the first capture: each user rehearses its body once first.  A
capture that fails raises; nothing falls back to the eager body.

CUDA refuses a device-wide synchronisation while any stream of the process
captures, and ``torch.cuda.graph`` synchronises the device before it
begins.  So the process captures one graph at a time (``CAPTURE_LOCK``),
and the package's own device synchronisations (``synchronize``) wait for a
capture on another thread to end.

A set built with ``marks=True`` takes layer marks (``utils/tracing.py::
layer``, ``ops/marks.py``): its captures launch each layer's mark kernel
into the graph and keep the marks' nodes, and ``Graph.replay`` keeps the
marks disabled while no profiler runs, so an untraced replay runs the
body's kernels alone, and enables them, one CUDA call a mark, the first
time a graph replays under a profiler (``pin_marks`` holds them on or off
whatever the profiler does).  Every set counts its captures and replays
(``captures``, ``replays``) and adds them to the process registry's
``ggrs_graph_captures_total`` and ``ggrs_graph_replays_total``, labelled
with the set's ``program``; ``ggrs:graph.capture`` spans each capture.
"""

from __future__ import annotations

import gc
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import copy_into, from_numpy
from ..obs.registry import default_registry
from ..utils.tracing import marking, profiling, trace_span
from ..utils.tree import tree_leaves, tree_map
from . import marks as layer_marks
from .kernels import GraphLaunches

# held for each capture, and by ``synchronize``
CAPTURE_LOCK = threading.RLock()

# captures and replays of every set, process-wide, by the program that owns
# the set (``replay``, ``scrub``, ``executor``, ``pool``, ``speculation``,
# ``predict``)
_OBS_CAPTURES = default_registry().counter(
    "ggrs_graph_captures_total", "CUDA graphs captured, by owning program",
    labels=("program",),
)
_OBS_REPLAYS = default_registry().counter(
    "ggrs_graph_replays_total", "CUDA graph replays, by owning program",
    labels=("program",),
)


def synchronize(device: torch.device) -> None:
    """``torch.cuda.synchronize(device)``, outside any capture of the
    process's other threads."""
    with CAPTURE_LOCK:
        torch.cuda.synchronize(device)


def _record(graphs: "GraphSet", body: Callable[[], None]) -> torch.cuda.CUDAGraph:
    """Capture ``body`` as a CUDA graph on the set's side stream and pool,
    instantiated; a set with marks keeps the captured graph, whose nodes
    its marks are.

    "thread_local": only this thread is barred from the calls that are
    unsafe during a capture; threads launching on other streams are not."""
    current = torch.cuda.current_stream(graphs.device)
    if graphs.stream is None:
        graphs.stream = torch.cuda.Stream(graphs.device)
    graphs.stream.wait_stream(current)
    graph = torch.cuda.CUDAGraph(keep_graph=True) if graphs.marks else torch.cuda.CUDAGraph()
    # no cyclic collection inside the capture: one could free a dead
    # program's graphs, and destroying a graph while this thread captures
    # is refused and ends the capture with an error
    collecting = gc.isenabled()
    gc.disable()
    try:
        with CAPTURE_LOCK, torch.cuda.graph(graph, pool=graphs.pool, stream=graphs.stream,
                                            capture_error_mode="thread_local"):
            body()
    finally:
        if collecting:
            gc.enable()
    current.wait_stream(graphs.stream)
    if graphs.marks:
        graph.instantiate()
    if graphs.pool is None:
        graphs.pool = graph.pool()
    return graph


class Graph:
    """One captured graph of a ``GraphSet``, the counted launches it holds
    and the nodes of its layer marks (``marks``; enabled while
    ``marks_on``)."""

    def __init__(self, owner: "GraphSet", graph, launches: GraphLaunches,
                 marks: Tuple[int, ...] = ()) -> None:
        self.owner = owner
        self.graph = graph
        self.launches = launches
        self.marks = marks
        self.marks_on = bool(marks)  # captured enabled
        if marks:
            self.set_marks(False)

    def set_marks(self, on: bool) -> None:
        """Enable or disable every layer mark of the graph, from its next
        replay on."""
        exec_handle = self.graph.raw_cuda_graph_exec()
        for node in self.marks:
            layer_marks.set_enabled(exec_handle, node, on)
        self.marks_on = on

    def replay(self) -> None:
        if self.marks:
            want = self.owner.pin_marks
            if want is None:
                want = profiling()
            if want != self.marks_on:
                self.set_marks(want)
        self.graph.replay()
        self.launches.replayed()
        self.owner.replays += 1
        self.owner._replayed.inc()


class GraphSet:
    """The graphs of one device: a side stream, a private pool shared by
    every capture, and the counts of captures and replays.  ``program``
    labels the set's counts in the registry; ``marks`` says whether its
    captures take layer marks, and ``pin_marks`` (None: follow the
    profiler) holds them on or off."""

    def __init__(self, device: torch.device, program: str, marks: bool = False) -> None:
        self.device = device
        self.marks = marks
        self.pin_marks: Optional[bool] = None
        self.stream = None
        self.pool = None
        self.captures = 0
        self.replays = 0
        self._captured = _OBS_CAPTURES.labels(program=program)
        self._replayed = _OBS_REPLAYS.labels(program=program)

    def capture(self, body: Callable[[], None]) -> Graph:
        with trace_span("ggrs:graph.capture"):
            launches = GraphLaunches()
            nodes: List[int] = []
            if self.marks:
                layer_marks.prime(self.device)
                body = _marked(body, nodes, self.device)
            with launches.capturing():
                graph = _record(self, body)
            self.captures += 1
            self._captured.inc()
            return Graph(self, graph, launches, tuple(nodes))


def _marked(body: Callable[[], None], nodes: List[int],
            device: torch.device) -> Callable[[], None]:
    """``body`` with each ``layer`` it enters launching that layer's mark
    into the capture and its node appended to ``nodes``."""

    def sink(name: str) -> None:
        node = layer_marks.launch(name, device)
        if node is None:
            raise RuntimeError(f"layer mark {name!r} was launched outside a capture")
        nodes.append(node)

    def run() -> None:
        with marking(sink):
            body()

    return run


def torch_dtype(dt: np.dtype) -> torch.dtype:
    """The tensor dtype ``convert.from_numpy`` gives a numpy dtype (u32 as
    int32 bit patterns)."""
    dt = np.dtype(np.int32) if dt == np.uint32 else dt
    return torch.from_numpy(np.zeros(1, dt)).dtype


class Upload:
    """Arrays packed into one byte buffer, each at an 8-byte boundary, sent
    to the device in one copy and read back there as typed views.

    A section may also be a tensor: a CPU tensor is packed as its array; a
    tensor on a device holds a blank section, which ``send_into`` fills by
    one copy on the device after the host block."""

    def __init__(self) -> None:
        self._parts: List[Tuple[int, np.ndarray]] = []
        self._device: List[Tuple[int, torch.Tensor]] = []
        self._size = 0

    def add(self, arr: Any) -> int:
        if isinstance(arr, torch.Tensor):
            if arr.device.type != "cpu":
                self._device.append((len(self._parts), arr))
                arr = np.zeros(tuple(arr.shape), torch.empty((), dtype=arr.dtype).numpy().dtype)
            else:
                arr = arr.numpy()
        arr = np.ascontiguousarray(arr)
        at = self._size
        self._parts.append((at, arr))
        self._size = at + (arr.nbytes + 7) // 8 * 8
        return len(self._parts) - 1

    def pack(self) -> np.ndarray:
        """The sections as one host byte buffer."""
        buf = np.zeros(max(self._size, 8), np.uint8)
        for at, arr in self._parts:
            buf[at:at + arr.nbytes] = arr.reshape(-1).view(np.uint8)
        return buf

    def views(self, dev: torch.Tensor) -> List[torch.Tensor]:
        """Each section as a typed view of ``dev``, a byte buffer that holds
        (or will hold) ``pack()``."""
        out = []
        for at, arr in self._parts:
            t = dev[at:at + arr.nbytes].view(torch_dtype(arr.dtype))
            out.append(t.reshape(arr.shape))
        return out

    def static(self, device: torch.device) -> torch.Tensor:
        """A zeroed byte buffer on ``device`` that holds this layout."""
        return torch.zeros(max(self._size, 8), dtype=torch.uint8, device=device)

    def send(self, device: torch.device) -> List[torch.Tensor]:
        return self.views(from_numpy(self.pack(), device))

    def send_into(self, static: torch.Tensor, views: List[torch.Tensor]) -> None:
        """Fill ``static`` (a buffer of this layout; ``views`` its typed
        views): the host sections in one copy, then each device section."""
        copy_into(static, torch.from_numpy(self.pack()))
        for i, t in self._device:
            views[i].copy_(t)


def host_arrays(tree: Any) -> Any:
    """A call's host inputs as ``Upload`` sections: arrays and tensors pass
    through, scalars become arrays; nothing is read from a device."""
    return tree_map(lambda l: l if isinstance(l, (np.ndarray, torch.Tensor)) else np.asarray(l),
                    tree)


def leaf_dtype(leaf: Any) -> torch.dtype:
    """The tensor dtype of a host array or tensor leaf."""
    return torch_dtype(leaf.dtype) if isinstance(leaf, np.ndarray) else leaf.dtype


def _empty_like(tree: Any, device: torch.device) -> Any:
    return tree_map(lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype, device=device), tree)


class KeyedGraphs:
    """Graphs of one device keyed the way a jit cache is keyed, each over
    static buffers of its own: the route of speculation's programs
    (``parallel/spec_rollback.py``, ``parallel/speculation.py``) and the
    prediction plane's kernel (``predict/batched.py``).

    ``replay(key, sections, state_in, build)`` runs one call: ``sections``
    (trees of host arrays or tensors) go up in one ``Upload`` into the
    key's static byte buffer, ``state_in`` (a tree of tensors on the device,
    or None) into the key's static state by one copy a leaf, and the key's
    graph replays.  At the key's first call ``build(views, state)`` makes
    the body over those buffers (``views``: the sections' trees of typed
    views of the byte buffer) and its static outputs, allocated outside the
    capture; the body is captured and the outputs returned at every call.
    Before the set's first capture, ``rehearse(body)`` runs once eagerly on
    the filled buffers: the body itself, unless a subclass says otherwise."""

    def __init__(self, device: torch.device, program: str) -> None:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.set = GraphSet(device, program)
        self._entries: Dict[tuple, list] = {}
        self._rehearsed = False

    @property
    def captures(self) -> int:
        return self.set.captures

    @property
    def replays(self) -> int:
        return self.set.replays

    def rehearse(self, body: Callable[[], None]) -> None:
        """Whatever the bodies do once lazily on the device (a game's device
        constants, the digest library's first launch), done eagerly."""
        body()

    def replay(self, key: tuple, sections: List[Any], state_in: Any,
               build: Callable[[List[Any], Any], Tuple[Callable[[], None], Any]]) -> Any:
        up = Upload()
        for sec in sections:
            for leaf in tree_leaves(sec):
                up.add(leaf)
        entry = self._entries.get(key)
        if entry is None:
            static = up.static(self.device)
            flat = up.views(static)
            it = iter(flat)
            views = [tree_map(lambda _: next(it), sec) for sec in sections]
            st = None if state_in is None else _empty_like(state_in, self.device)
            entry = [None, static, flat, st, *build(views, st)]
        graph, static, flat, st, body, outs = entry
        if sections:
            up.send_into(static, flat)
        if st is not None:
            copy_into(st, state_in)
        if graph is None:
            if not self._rehearsed:
                self.rehearse(body)
                self._rehearsed = True
            graph = entry[0] = self.set.capture(body)
            self._entries[key] = entry
        graph.replay()
        return outs
