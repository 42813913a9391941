"""Speculative branch execution: K predicted futures advanced as one batch.

The port of ``ggrs_tpu/parallel/speculation.py``.  The reference predicts
remote inputs with one strategy and replays whenever it was wrong (GGRS
src/input_queue.rs:104-167, src/sessions/p2p_session.rs:658-714).  Here K
branches advance under K predicted input sequences, and when the confirmed
inputs arrive the branch whose predictions matched is selected on the device
(no replay).  Only when no branch guessed right does the caller replay.

The port's games are batch-native (a leading session axis), so the K
branches are simply a batch of K rows: the JAX package's
``vmap(scan(advance))`` is W calls of ``advance`` on ``(K, ...)`` states.
States passed in and returned are single (unbatched) states, as in the JAX
package; inputs may be numpy arrays or tensors and go to the state's device.

The JAX package jits each of the five programs.  On a CUDA device each is
one CUDA graph replay keyed by the layouts of its arguments, as the jit
cache is keyed (``BranchGraphs``); the eager bodies (``BranchPrograms``'
``*_eager``) are the graphs' plain versions and what the CPU runs.  Routing
is by the state's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import from_numpy
from ..ops.executor import _layout
from ..ops.graphs import KeyedGraphs, host_arrays
from ..utils.tree import tree_leaves, tree_map

AdvanceFn = Callable[[Any, Any], Any]


def _device(state: Any) -> torch.device:
    return tree_leaves(state)[0].device


@dataclass(frozen=True)
class SpeculativeBranches:
    """The speculation programs for a fixed (advance, K).

    Shapes: branch states carry a leading K axis on every leaf; windowed
    inputs are ``[K, W, ...per-frame-input...]`` (per branch, per frame).
    ``programs`` is the ``BranchPrograms`` behind the five callables."""

    num_branches: int
    init: Callable[[Any], Any]  # state -> K-branch states
    speculate_window: Callable[[Any, Any], Any]  # (state, inputs_KW) -> K final states
    resolve: Callable[[Any, Any, Any], Tuple[Any, torch.Tensor, torch.Tensor]]
    replay_window: Callable[[Any, Any], Any]  # (state, inputs_W) -> state
    collapse: Callable[[Any, torch.Tensor], Any]  # (branches, idx) -> state
    programs: Any = field(default=None, compare=False, repr=False)


class BranchPrograms:
    """The five branch programs over a batch-native ``advance``: each routes
    by its state's device, to the graph of its key on a CUDA device
    (``graphs``) and to its eager body (``*_eager``) elsewhere."""

    def __init__(self, advance: AdvanceFn, num_branches: int) -> None:
        assert num_branches >= 1
        self.advance = advance
        self.K = num_branches
        self._graphs: Dict[torch.device, BranchGraphs] = {}

    def graphs(self, device: torch.device) -> Optional["BranchGraphs"]:
        """The graphs of ``device``, made at its first use there when it is
        a CUDA device; None elsewhere (the eager route)."""
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        g = self._graphs.get(device)
        if g is None and device.type == "cuda":
            g = self._graphs[device] = BranchGraphs(self, device)
        return g

    def branches(self) -> SpeculativeBranches:
        return SpeculativeBranches(
            num_branches=self.K,
            init=self.init,
            speculate_window=self.speculate_window,
            resolve=self.resolve,
            replay_window=self.replay_window,
            collapse=self.collapse,
            programs=self,
        )

    # -- routed ---------------------------------------------------------

    def init(self, state: Any) -> Any:
        g = self.graphs(_device(state))
        return self.init_eager(state) if g is None else g.init(state)

    def speculate_window(self, state: Any, inputs_kw: Any) -> Any:
        g = self.graphs(_device(state))
        if g is None:
            return self.speculate_window_eager(state, inputs_kw)
        return g.speculate_window(state, inputs_kw)

    def resolve(self, branches: Any, inputs_kw: Any, confirmed_w: Any):
        g = self.graphs(_device(branches))
        if g is None:
            return self.resolve_eager(branches, inputs_kw, confirmed_w)
        return g.resolve(branches, inputs_kw, confirmed_w)

    def replay_window(self, state: Any, inputs_w: Any) -> Any:
        g = self.graphs(_device(state))
        return self.replay_window_eager(state, inputs_w) if g is None else g.replay_window(
            state, inputs_w)

    def collapse(self, branches: Any, idx: Any) -> Any:
        g = self.graphs(_device(branches))
        return self.collapse_eager(branches, idx) if g is None else g.collapse(branches, idx)

    # -- the eager bodies -----------------------------------------------

    def _init(self, state: Any) -> Any:
        return tree_map(lambda leaf: leaf.unsqueeze(0).expand(self.K, *leaf.shape), state)

    def init_eager(self, state: Any) -> Any:
        return tree_map(torch.clone, self._init(state))

    def _window_one(self, state: Any, inputs_w: Any) -> Any:
        st = tree_map(lambda leaf: leaf.unsqueeze(0), state)
        for t in range(tree_leaves(inputs_w)[0].shape[0]):
            st = self.advance(st, tree_map(lambda leaf: leaf[t:t + 1], inputs_w))
        return tree_map(lambda leaf: leaf[0], st)

    def replay_window_eager(self, state: Any, inputs_w: Any) -> Any:
        """``state`` advanced through the W frames of ``inputs_w``."""
        return self._window_one(state, from_numpy(inputs_w, _device(state)))

    def _speculate(self, state: Any, inputs_kw: Any) -> Any:
        st = self._init(state)
        for t in range(tree_leaves(inputs_kw)[0].shape[1]):
            st = self.advance(st, tree_map(lambda leaf: leaf[:, t], inputs_kw))
        return st

    def speculate_window_eager(self, state: Any, inputs_kw: Any) -> Any:
        """K branches from one base state through a W-frame window: W
        advances of the K-row batch; returns the K final states."""
        return self._speculate(state, from_numpy(inputs_kw, _device(state)))

    def _match(self, inputs_kw: Any, confirmed_w: Any) -> torch.Tensor:
        K = self.K
        match = None
        for pred, conf in zip(tree_leaves(inputs_kw), tree_leaves(confirmed_w)):
            eq = (pred == conf.unsqueeze(0)).reshape(K, -1).all(dim=1)
            match = eq if match is None else match & eq
        return match

    def resolve_eager(self, branches: Any, inputs_kw: Any, confirmed_w: Any):
        """Select the branch whose input window matches the confirmed inputs.

        Returns ``(state, branch_idx, found)`` on the device; when ``found``
        is False the state is branch 0 and the caller must replay from the
        base state with the confirmed inputs instead."""
        dev = _device(branches)
        match = self._match(from_numpy(inputs_kw, dev), from_numpy(confirmed_w, dev))
        # torch.argmax takes no bool; on ints it returns the first maximum,
        # so this is the first matching branch (0 when none matches)
        idx = torch.argmax(match.to(torch.int32))
        return self._collapse(branches, idx.reshape(1)), idx, match.any()

    def _collapse(self, branches: Any, sel: torch.Tensor) -> Any:
        return tree_map(lambda leaf: leaf.index_select(0, sel)[0], branches)

    def collapse_eager(self, branches: Any, idx: Any) -> Any:
        sel = torch.as_tensor(idx, dtype=torch.int64, device=_device(branches)).reshape(1)
        return self._collapse(branches, sel)


class BranchGraphs(KeyedGraphs):
    """``BranchPrograms``' five programs on one CUDA device as CUDA graphs,
    each keyed by the layouts of its arguments (``KeyedGraphs``): states go
    into static buffers by one copy a leaf, inputs (and ``collapse``'s
    index, an int64 device tensor read through ``index_select``) up in one
    copy, and what a call returns is a clone of the key's static outputs.
    Before the first capture on a device the first call's eager body runs
    once (the game's device constants)."""

    def __init__(self, programs: BranchPrograms, device: torch.device) -> None:
        super().__init__(device, "speculation")
        self.programs = programs

    def _outs(self, tree: Any, lead: tuple = ()) -> Any:
        return tree_map(lambda l: torch.empty((*lead, *l.shape), dtype=l.dtype,
                                              device=self.device), tree)

    def init(self, state: Any) -> Any:
        p = self.programs

        def build(_, st):
            out = self._outs(st, (p.K,))
            return lambda: _copy(out, p._init(st)), out

        return _clone(self.replay(("init", _layout(state)), [], state, build))

    def speculate_window(self, state: Any, inputs_kw: Any) -> Any:
        p, inputs_kw = self.programs, host_arrays(inputs_kw)

        def build(views, st):
            out = self._outs(st, (p.K,))
            return lambda: _copy(out, p._speculate(st, views[0])), out

        key = ("speculate_window", _layout(state), _layout(inputs_kw))
        return _clone(self.replay(key, [inputs_kw], state, build))

    def replay_window(self, state: Any, inputs_w: Any) -> Any:
        p, inputs_w = self.programs, host_arrays(inputs_w)

        def build(views, st):
            out = self._outs(st)
            return lambda: _copy(out, p._window_one(st, views[0])), out

        key = ("replay_window", _layout(state), _layout(inputs_w))
        return _clone(self.replay(key, [inputs_w], state, build))

    def resolve(self, branches: Any, inputs_kw: Any, confirmed_w: Any):
        p = self.programs
        inputs_kw, confirmed_w = host_arrays(inputs_kw), host_arrays(confirmed_w)

        def build(views, br):
            out = (self._outs(tree_map(lambda l: l[0], br)),
                   torch.empty((), dtype=torch.int64, device=self.device),
                   torch.empty((), dtype=torch.bool, device=self.device))

            def body() -> None:
                match = p._match(views[0], views[1])
                idx = torch.argmax(match.to(torch.int32))
                _copy(out[0], p._collapse(br, idx.reshape(1)))
                out[1].copy_(idx)
                out[2].copy_(match.any())

            return body, out

        key = ("resolve", _layout(branches), _layout(inputs_kw), _layout(confirmed_w))
        return _clone(self.replay(key, [inputs_kw, confirmed_w], branches, build))

    def collapse(self, branches: Any, idx: Any) -> Any:
        p = self.programs
        idx = idx.reshape(1).to(torch.int64) if isinstance(idx, torch.Tensor) else np.array(
            [idx], np.int64)

        def build(views, br):
            out = self._outs(tree_map(lambda l: l[0], br))
            return lambda: _copy(out, p._collapse(br, views[0])), out

        return _clone(self.replay(("collapse", _layout(branches)), [idx], branches, build))


def build_speculation_programs(advance: AdvanceFn, num_branches: int) -> SpeculativeBranches:
    """The branch programs over a batch-native ``advance`` (``(B, ...)``
    states and inputs), the same function the replay path uses."""
    return BranchPrograms(advance, num_branches).branches()


def _copy(dst: Any, src: Any) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _clone(tree: Any) -> Any:
    return tree_map(torch.clone, tree)
