"""DeviceRequestExecutor: fulfil a host session's request list on the card.

The port of ``ggrs_tpu/ops/executor.py``.  A host session (``SyncTestSession``
so far) emits the reference's ordered list of Save / Load / Advance requests
and never touches game state (GGRS src/lib.rs:170-195).  The executor holds
the game state as tensors on the card and fulfils the list there:

- a ``SaveGameState`` stores the state's tensors in the request's cell, with
  no copy, plus a lazy ``DeviceChecksum`` computed by the digest kernel;
- a ``LoadGameState`` makes the cell's tensors the live state again;
- an ``(Advance, Save?)*`` run of two or more advances is one burst: the
  inputs of all its steps are stacked on the host and uploaded in one copy,
  the advances run in order, and the states of the steps that are saved are
  digested together in ONE ``checksum_device`` call (one kernel launch).
  The JAX burst digests every step inside its scan; the unsaved digests are
  never read, so the saved values are the same.

``run`` reads nothing back from the card and never synchronises: inputs go
up from pinned memory without blocking, and checksums stay on the card
until ``GameStateCell.checksum`` is read.  A SyncTest frame at
check_distance >= 1 thus makes exactly one digest launch: its lone Save
while warming up, and the burst ``(Adv, Save) x d, Adv`` after the Load
once steady.

The executor never writes a state in place (the replay of ``ops/replay.py``
does, into its ring): a cell holds the very tensors that a later Load makes
live, and ``advance`` returns new tensors.

The port's games are batch-native, with a leading session axis, while a
request list is about one session.  The executor runs ``advance`` and the
digest on ``(1, ...)`` views (``unsqueeze(0)``) and exposes the state, and
what a cell holds, in the JAX package's single-state layout (``[0]`` views of
the advance's output), so that the two packages' states compare leaf for
leaf.  The speculation hooks of the JAX executor are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import from_numpy
from ..core.device import DeviceLike, resolve_device
from ..core.types import AdvanceFrame, GgrsRequest, InputStatus, LoadGameState, SaveGameState
from ..utils.tree import tree_leaves, tree_map
from .checksum import DeviceChecksum, checksum_device

InputsToArray = Callable[[Sequence[Tuple[Any, InputStatus]]], Any]


def _stack_pytrees(trees: Sequence[Any]) -> Any:
    """Stack pytrees on a new leading axis, on the host when every leaf is
    numpy, so that the burst's inputs go to the card in one copy."""

    def stack(*leaves: Any) -> Any:
        if all(isinstance(l, np.ndarray) for l in leaves):
            return np.stack(leaves)
        return torch.stack([torch.as_tensor(l) for l in leaves])

    return tree_map(stack, *trees)


def _one_row(tree: Any) -> Any:
    """One state or input as a batch of one: ``(1, ...)`` views."""
    return tree_map(lambda leaf: leaf.unsqueeze(0), tree)


def _row(tree: Any, i: int = 0) -> Any:
    return tree_map(lambda leaf: leaf[i], tree)


class ExecutorPrograms:
    """The executor's programs for one batch-native ``advance``: a single
    step, a burst, and the digest of one state.  They hold no state, so one
    instance can serve every executor that drives the same game."""

    def __init__(self, advance: Callable[[Any, Any], Any], with_checksums: bool = True) -> None:
        self.with_checksums = with_checksums
        self.raw_advance = advance  # for executor-side identity validation

    def advance(self, state: Any, inputs: Any) -> Any:
        """One step of one unbatched state: the advance's output as ``[0]``
        views."""
        return _row(self.raw_advance(_one_row(state), _one_row(inputs)))

    def checksum(self, state: Any) -> torch.Tensor:
        """The ``(4,)`` digest lanes of one unbatched state: one launch."""
        return checksum_device(_one_row(state))[0]

    def burst(
        self, state: Any, inputs: Any, saved: Sequence[int]
    ) -> Tuple[List[Any], Optional[torch.Tensor]]:
        """``n`` advances from ``state`` with ``inputs`` (leaves ``(n, ...)``).

        Returns ``(steps, sums)``: ``steps[k]`` is the state after step
        ``k``, as ``[0]`` views of the advance's own output, and ``sums`` is
        the ``(len(saved), 4)`` digest of the steps listed in ``saved``,
        made by one ``checksum_device`` call over their stacked rows (None
        without checksums or saves).  The stack is the digest's input only;
        the steps stay the advance's outputs."""
        n = tree_leaves(inputs)[0].shape[0]
        st = _one_row(state)
        outs = []
        for k in range(n):
            st = self.raw_advance(st, tree_map(lambda leaf: leaf[k:k + 1], inputs))
            outs.append(st)
        sums = None
        if self.with_checksums and saved:
            rows = tree_map(lambda *leaves: torch.cat(leaves), *[outs[k] for k in saved])
            sums = checksum_device(rows)
        return [_row(o) for o in outs], sums


class DeviceRequestExecutor:
    """Executes request lists with the game state on ``device``.

    ``advance``         batch-native ``(states (B, ...), inputs (B, ...)) ->
                        states``, pure (it writes neither argument).
    ``init_state``      one unbatched initial state (numpy arrays or tensors).
    ``inputs_to_array`` maps a request's ``[(input, status), ...]`` list to
                        the array ``advance`` takes for one session (e.g. the
                        (P,) u8 bitmask vector of BoxGame), as numpy arrays:
                        those go to the card without a synchronisation.
    ``programs``        optional shared ``ExecutorPrograms`` (same
                        ``advance`` and ``with_checksums``).
    ``device``          the card by default (``None``); pass ``"cpu"`` to
                        run on the CPU.
    """

    def __init__(
        self,
        advance: Callable[[Any, Any], Any],
        init_state: Any,
        inputs_to_array: InputsToArray,
        with_checksums: bool = True,
        programs: Optional[ExecutorPrograms] = None,
        device: DeviceLike = None,
    ) -> None:
        if programs is None:
            programs = ExecutorPrograms(advance, with_checksums)
        assert programs.with_checksums == with_checksums, (
            "shared ExecutorPrograms was built with a different "
            "with_checksums setting"
        )
        # == (not `is`): bound methods compare equal when they bind the same
        # function on the same object, but each attribute access makes a
        # fresh one, so identity would always fail for `game.advance`
        assert programs.raw_advance == advance, (
            "shared ExecutorPrograms was built for a different advance "
            "function -- its programs would silently simulate the wrong game"
        )
        self.device = resolve_device(device)
        self._programs = programs
        self._state = from_numpy(init_state, self.device)
        self._inputs_to_array = inputs_to_array
        self._with_checksums = with_checksums

    @property
    def state(self) -> Any:
        """The live state: unbatched tensors on the device."""
        return self._state

    def warmup(self, example_inputs: Any, burst_depths: Sequence[int] = ()) -> None:
        """Run the single advance, the digest and a burst of each depth in
        ``burst_depths`` once, without touching the live state, then wait for
        the card.  This builds the digest kernel and fills the allocators
        before a live loop instead of inside it.  A full-window rollback of a
        session with ``max_prediction`` groups into a ``max_prediction + 1``
        deep burst, so pass ``range(2, max_prediction + 2)`` to cover every
        depth (depth 1 is the single advance)."""
        self._programs.advance(self._state, from_numpy(example_inputs, self.device))
        if self._with_checksums:
            self._programs.checksum(self._state)
        for n in burst_depths:
            if n < 2:
                continue
            stacked = from_numpy(_stack_pytrees([example_inputs] * n), self.device)
            self._programs.burst(self._state, stacked, range(n - 1))
        self.block_until_ready()

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, requests: List[GgrsRequest]) -> None:
        """Execute a session's request list in order."""
        i = 0
        n = len(requests)
        while i < n:
            req = requests[i]
            if isinstance(req, SaveGameState):
                self._do_save(req)
                i += 1
            elif isinstance(req, LoadGameState):
                pairs, saves, i = self._collect_burst(requests, i + 1)
                self._do_load(req)
                self._run_pairs(pairs, saves)
            elif isinstance(req, AdvanceFrame):
                pairs, saves, i = self._collect_burst(requests, i)
                self._run_pairs(pairs, saves)
            else:
                raise TypeError(f"unknown request {req!r}")

    @staticmethod
    def _collect_burst(
        requests: List[GgrsRequest], start: int
    ) -> Tuple[List[AdvanceFrame], List[Optional[SaveGameState]], int]:
        """Collect the (Advance, Save?)* run starting at ``start``."""
        j = start
        n = len(requests)
        pairs: List[AdvanceFrame] = []
        saves: List[Optional[SaveGameState]] = []
        while j < n and isinstance(requests[j], AdvanceFrame):
            pairs.append(requests[j])
            j += 1
            if j < n and isinstance(requests[j], SaveGameState):
                saves.append(requests[j])
                j += 1
            else:
                saves.append(None)
        return pairs, saves, j

    def _run_pairs(self, pairs: List[AdvanceFrame], saves: List[Optional[SaveGameState]]) -> None:
        """Execute an (Advance, Save?)* run, as one burst when it has two or
        more advances."""
        if not pairs:
            return
        if len(pairs) == 1:
            self._do_advance(pairs[0])
            if saves[0] is not None:
                self._do_save(saves[0])
            return
        self._do_burst(pairs, saves)

    # ------------------------------------------------------------------

    def _do_save(self, req: SaveGameState) -> None:
        cs = DeviceChecksum(self._programs.checksum(self._state)) if self._with_checksums else None
        req.cell.save(req.frame, self._state, cs)

    def _do_load(self, req: LoadGameState) -> None:
        data = req.cell.data()
        assert data is not None, f"loading frame {req.frame} from an empty cell"
        self._state = data

    def _do_advance(self, req: AdvanceFrame) -> None:
        inputs = from_numpy(self._inputs_to_array(req.inputs), self.device)
        self._state = self._programs.advance(self._state, inputs)

    def _do_burst(self, pairs: List[AdvanceFrame], saves: List[Optional[SaveGameState]]) -> None:
        """(Advance, Save?) x N: one upload of the stacked inputs, N advances,
        one digest launch over the saved steps; each save cell gets its
        step's own tensors and a lazy checksum over its row of the digest."""
        stacked = from_numpy(
            _stack_pytrees([self._inputs_to_array(p.inputs) for p in pairs]), self.device
        )
        saved = [k for k, s in enumerate(saves) if s is not None]
        steps, sums = self._programs.burst(self._state, stacked, saved)
        self._state = steps[-1]
        for j, k in enumerate(saved):
            cs = DeviceChecksum(sums[j]) if sums is not None else None
            saves[k].cell.save(saves[k].frame, steps[k], cs)
