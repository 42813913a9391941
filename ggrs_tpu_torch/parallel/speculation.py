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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from ..convert import from_numpy
from ..utils.tree import tree_leaves, tree_map

AdvanceFn = Callable[[Any, Any], Any]


def _device(state: Any) -> torch.device:
    return tree_leaves(state)[0].device


@dataclass(frozen=True)
class SpeculativeBranches:
    """The speculation programs for a fixed (advance, K).

    Shapes: branch states carry a leading K axis on every leaf; windowed
    inputs are ``[K, W, ...per-frame-input...]`` (per branch, per frame)."""

    num_branches: int
    init: Callable[[Any], Any]  # state -> K-branch states
    speculate_window: Callable[[Any, Any], Any]  # (state, inputs_KW) -> K final states
    resolve: Callable[[Any, Any, Any], Tuple[Any, torch.Tensor, torch.Tensor]]
    replay_window: Callable[[Any, Any], Any]  # (state, inputs_W) -> state
    collapse: Callable[[Any, torch.Tensor], Any]  # (branches, idx) -> state


def build_speculation_programs(advance: AdvanceFn, num_branches: int) -> SpeculativeBranches:
    """The branch programs over a batch-native ``advance`` (``(B, ...)``
    states and inputs), the same function the replay path uses."""
    assert num_branches >= 1
    K = num_branches

    def _init(state: Any) -> Any:
        return tree_map(lambda leaf: leaf.unsqueeze(0).expand(K, *leaf.shape).clone(), state)

    def _window_one(state: Any, inputs_w: Any) -> Any:
        """``state`` advanced through the W frames of ``inputs_w``."""
        inputs_w = from_numpy(inputs_w, _device(state))
        st = tree_map(lambda leaf: leaf.unsqueeze(0), state)
        for t in range(tree_leaves(inputs_w)[0].shape[0]):
            st = advance(st, tree_map(lambda leaf: leaf[t:t + 1], inputs_w))
        return tree_map(lambda leaf: leaf[0], st)

    def _speculate_window(state: Any, inputs_kw: Any) -> Any:
        """K branches from one base state through a W-frame window: W
        advances of the K-row batch; returns the K final states."""
        inputs_kw = from_numpy(inputs_kw, _device(state))
        st = _init(state)
        for t in range(tree_leaves(inputs_kw)[0].shape[1]):
            st = advance(st, tree_map(lambda leaf: leaf[:, t], inputs_kw))
        return st

    def _resolve(branches: Any, inputs_kw: Any, confirmed_w: Any):
        """Select the branch whose input window matches the confirmed inputs.

        Returns ``(state, branch_idx, found)`` on the device; when ``found``
        is False the state is branch 0 and the caller must replay from the
        base state with the confirmed inputs instead."""
        dev = _device(branches)
        inputs_kw, confirmed_w = from_numpy(inputs_kw, dev), from_numpy(confirmed_w, dev)
        match = torch.ones((K,), dtype=torch.bool, device=dev)
        for pred, conf in zip(tree_leaves(inputs_kw), tree_leaves(confirmed_w)):
            match = match & (pred == conf.unsqueeze(0)).reshape(K, -1).all(dim=1)
        # torch.argmax takes no bool; on ints it returns the first maximum,
        # so this is the first matching branch (0 when none matches)
        idx = torch.argmax(match.to(torch.int32))
        return _collapse(branches, idx), idx, match.any()

    def _collapse(branches: Any, idx: torch.Tensor) -> Any:
        sel = torch.as_tensor(idx, dtype=torch.int64, device=_device(branches)).reshape(1)
        return tree_map(lambda leaf: leaf.index_select(0, sel)[0], branches)

    return SpeculativeBranches(
        num_branches=K,
        init=_init,
        speculate_window=_speculate_window,
        resolve=_resolve,
        replay_window=_window_one,
        collapse=_collapse,
    )
