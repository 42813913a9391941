"""The steady tick's layer marks on the card: four empty kernels of
``csrc/digest.cu`` (``ggrs_mark_ring``, ``_advance``, ``_digest``,
``_compare``), loaded with the digest library through ``ctypes``.

``launch(name, device)`` launches layer ``name``'s mark on the device's
current stream and returns its graph node where that stream is being
captured (None otherwise).  ``set_enabled(exec, node, on)`` enables or
disables a captured mark in an instantiated graph
(``cudaGraphNodeSetEnabled``; a disabled node acts as an empty node), from
the graph's next launch on, and ``enabled`` reads that state back.
``prime(device)`` launches each mark once
outside any capture, as the digest's first launch is made before a first
capture.  ``ops/graphs.py`` (``GraphSet`` with ``marks=True``) is the
user; ``utils/tracing.py::layer`` says where the marks go.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Set

import torch

from .. import _build
from ..utils.tracing import LAYERS

_primed: Set[torch.device] = set()


def _lib() -> ctypes.CDLL:
    lib = _build.load("digest")
    fn = lib.ggrs_mark
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        fn.restype = ctypes.c_int
        lib.ggrs_graph_node_set_enabled.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                    ctypes.c_int]
        lib.ggrs_graph_node_set_enabled.restype = ctypes.c_int
        lib.ggrs_graph_node_get_enabled.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                    ctypes.POINTER(ctypes.c_int)]
        lib.ggrs_graph_node_get_enabled.restype = ctypes.c_int
    return lib


def launch(name: str, device: torch.device) -> Optional[int]:
    """Layer ``name``'s mark on ``device``'s current stream; its node (an
    address) while that stream captures, else None."""
    node = ctypes.c_void_p()
    err = _lib().ggrs_mark(LAYERS.index(name), torch.cuda.current_stream(device).cuda_stream,
                           ctypes.byref(node))
    if err != 0:
        raise RuntimeError(f"layer mark {name!r}: CUDA error {err}")
    return node.value


def prime(device: torch.device) -> None:
    """Each mark launched once on ``device``, outside any capture (once a
    process and device)."""
    if device in _primed:
        return
    for name in LAYERS:
        launch(name, device)
    _primed.add(device)


def set_enabled(exec_handle: int, node: int, on: bool) -> None:
    err = _lib().ggrs_graph_node_set_enabled(exec_handle, node, int(on))
    if err != 0:
        raise RuntimeError(f"cudaGraphNodeSetEnabled refused a layer mark: CUDA error {err}")


def enabled(exec_handle: int, node: int) -> bool:
    """Whether ``node`` is enabled in the instantiated graph."""
    on = ctypes.c_int()
    err = _lib().ggrs_graph_node_get_enabled(exec_handle, node, ctypes.byref(on))
    if err != 0:
        raise RuntimeError(f"cudaGraphNodeGetEnabled refused a layer mark: CUDA error {err}")
    return bool(on.value)
