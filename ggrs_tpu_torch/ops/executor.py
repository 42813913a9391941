"""DeviceRequestExecutor: fulfil a host session's request list on the card.

The port of ``ggrs_tpu/ops/executor.py``.  A host session (``SyncTestSession``
so far) emits the reference's ordered list of Save / Load / Advance requests
and never touches game state (GGRS src/lib.rs:170-195).  The executor holds
the game state as tensors on the card and fulfils the list there:

- a ``SaveGameState`` stores the state's tensors in the request's cell, with
  no copy, plus a lazy ``DeviceChecksum`` computed by the digest kernel;
- a ``LoadGameState`` makes the cell's tensors the live state again (a
  host tree in the cell, as a journal failover loads one, goes up first);
- an ``(Advance, Save?)*`` run of two or more advances is one burst: the
  inputs of all its steps are stacked on the host and uploaded in one copy,
  the advances run in order, and the saved steps are digested together in
  ONE launch of the digest kernel.  The JAX burst digests every step inside
  its scan; the unsaved digests are never read, so the saved values are the
  same.

The JAX package jits the single advance, the checksum and the scanned burst
(``ExecutorPrograms``).  The port's counterpart on the card is a CUDA graph:
``advance`` and ``burst`` on a CUDA state are each one graph replay between
copies of the state and inputs in and clones of the outputs out
(``ExecutorGraphs``); the lone save's checksum is one direct launch.  The
eager bodies (``advance_eager``, ``burst_eager``) are the graphs' plain
versions and what the CPU runs.  Routing is by the state's device.

``run`` reads nothing back from the card and never synchronises: inputs go
up from pinned memory without blocking, and checksums stay on the card
until ``GameStateCell.checksum`` is read.  A SyncTest frame at
check_distance >= 1 thus makes exactly one digest launch: its lone Save
while warming up, and the burst ``(Adv, Save) x d, Adv`` after the Load
once steady.

The executor never writes a state in place (the replay of ``ops/replay.py``
does, into its ring): a cell holds tensors that no later step writes, which
a later Load makes live again, and every step returns new tensors (the
eager advance's own outputs, or the clones of a graph's).

The port's games are batch-native, with a leading session axis, while a
request list is about one session.  The executor runs ``advance`` and the
digest on ``(1, ...)`` views (``unsqueeze(0)``) and exposes the state, and
what a cell holds, in the JAX package's single-state layout (``[0]`` views),
so that the two packages' states compare leaf for leaf.

With a ``speculation`` strategy (``parallel.SpeculativeRollback``) attached,
the executor keeps K branch trajectories alive between ticks and lets a
rollback be answered by branch selection instead of replay: the first Save
roots the branches, each live advance extends them in the same ``advance``
call (``advance_and_extend``), and a rollback whose window the branches cover
is one ``fulfill_and_refill`` call -- matching, the select or the replay
(both computed, one taken on the card), re-rooting, re-extension and the
trailing live advance -- whose saved steps are digested in one launch.  The
host never reads whether it hit.  On the card each of speculation's calls is
one CUDA graph replay (``parallel.spec_rollback.SpecGraphs``): a plain tick's
``advance_and_extend`` and a covered rollback tick's ``fulfill_and_refill``;
a rollback the branches cannot answer replays through the burst graph, with
one ``extend`` replay for each of its advances.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..convert import copy_into, from_numpy, host_tensors
from ..core.device import DeviceLike, resolve_device
from ..core.types import AdvanceFrame, GgrsRequest, InputStatus, LoadGameState, SaveGameState
from ..utils.tree import tree_leaves, tree_map
from .checksum import CHECKSUM_LANES, DeviceChecksum, checksum_device
from .graphs import Graph, GraphSet, synchronize

if TYPE_CHECKING:
    from ..parallel.spec_rollback import SpeculativeRollback

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


def _device(state: Any) -> torch.device:
    return tree_leaves(state)[0].device


def _layout(tree: Any) -> tuple:
    return tuple((tuple(leaf.shape), leaf.dtype) for leaf in tree_leaves(tree))


class ExecutorPrograms:
    """The executor's programs for one batch-native ``advance``: a single
    step, a burst, and the digest of one state.  They hold no game state,
    so one instance can serve every executor that drives the same game.

    On a CUDA device ``advance`` and ``burst`` are CUDA graph replays
    (``ExecutorGraphs``), the counterpart of the JAX package's jitted
    ``advance`` and scanned ``burst``; ``advance_eager`` and ``burst_eager``
    are their plain versions and what the CPU runs.  ``checksum``, the
    counterpart of the jitted ``checksum``, stays one direct launch of the
    digest kernel on the card: a graph of one node would save nothing.

    The graphs and their static buffers belong to this object, so an
    instance shared by several executors (the in-process fleet's matches in
    ``chaos.ExecutorGame``) serves one thread at a time; the sessions that
    drive them are ``ThreadOwned``, which already holds them to one."""

    def __init__(self, advance: Callable[[Any, Any], Any], with_checksums: bool = True) -> None:
        self.with_checksums = with_checksums
        self.raw_advance = advance  # for executor-side identity validation
        self._graphs: Dict[torch.device, ExecutorGraphs] = {}
        # devices on which the bodies ran eagerly (see ExecutorGraphs)
        self._eager_on: Set[torch.device] = set()

    def graphs(self, device: torch.device) -> Optional["ExecutorGraphs"]:
        """The graphs of ``device``, made at its first use there when it is
        a CUDA device; None elsewhere (the eager route)."""
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        g = self._graphs.get(device)
        if g is None and device.type == "cuda":
            g = self._graphs[device] = ExecutorGraphs(self, device)
        return g

    def advance(self, state: Any, inputs: Any) -> Any:
        """One step of one unbatched state with one step's ``inputs`` (host
        arrays or tensors): the next state, in the same layout."""
        g = self.graphs(_device(state))
        return self.advance_eager(state, inputs) if g is None else g.advance(state, inputs)

    def advance_eager(self, state: Any, inputs: Any) -> Any:
        """``advance``'s plain version: the advance's output as ``[0]``
        views."""
        inputs = from_numpy(inputs, _device(state))
        return _row(self.raw_advance(_one_row(state), _one_row(inputs)))

    def checksum(self, state: Any) -> torch.Tensor:
        """The ``(4,)`` digest lanes of one unbatched state: one launch."""
        return checksum_device(_one_row(state))[0]

    def burst(
        self, state: Any, inputs: Any, saved: Sequence[int]
    ) -> Tuple[List[Any], Optional[List[torch.Tensor]]]:
        """``n`` advances from ``state`` with ``inputs`` (host arrays or
        tensors, leaves ``(n, ...)``).

        Returns ``(steps, sums)``: ``steps[k]`` is the state after step
        ``k`` and ``sums[j]`` the ``(4,)`` digest of step ``saved[j]``, all
        made by one digest launch (None without checksums or saves)."""
        g = self.graphs(_device(state))
        if g is None:
            return self.burst_eager(state, inputs, saved)
        return g.burst(state, inputs, saved)

    def burst_eager(
        self, state: Any, inputs: Any, saved: Sequence[int]
    ) -> Tuple[List[Any], Optional[List[torch.Tensor]]]:
        """``burst``'s plain version: ``n`` advances issued from Python on
        ``(1, ...)`` views, the steps ``[0]`` views of the advance's own
        outputs, and the saved steps digested by one ``checksum_device``
        call over their stacked rows.  The stack is the digest's input
        only; the steps stay the advance's outputs."""
        inputs = from_numpy(inputs, _device(state))
        n = tree_leaves(inputs)[0].shape[0]
        st = _one_row(state)
        outs = []
        for k in range(n):
            st = self.raw_advance(st, tree_map(lambda leaf: leaf[k:k + 1], inputs))
            outs.append(st)
        sums = None
        if self.with_checksums and saved:
            rows = tree_map(lambda *leaves: torch.cat(leaves), *[outs[k] for k in saved])
            sums = list(checksum_device(rows))
        return [_row(o) for o in outs], sums

    def rehearse(self, state: Any, inputs: Any) -> None:
        """One eager advance (with one step's ``inputs``) and, with
        checksums, one digest of ``state``, writing nothing: whatever the
        bodies do once lazily on this device (the game's device constants,
        the digest library's first launch) is then done."""
        self.advance_eager(state, inputs)
        if self.with_checksums:
            self.checksum(state)
        self._eager_on.add(_device(state))

    def warmup(self, state: Any, example_inputs: Any, burst_depths: Sequence[int] = ()) -> None:
        """``rehearse``, then the single advance and a burst of each depth
        in ``burst_depths`` (2 or more; each step but the last saved) from
        ``state``, whose tensors are left as they are: on a CUDA device
        this captures their graphs (and replays each once)."""
        self.rehearse(state, example_inputs)
        self.advance(state, example_inputs)
        for n in burst_depths:
            if n >= 2:
                self.burst(state, _stack_pytrees([example_inputs] * n), range(n - 1))


class ExecutorGraphs:
    """``ExecutorPrograms``' ``advance`` and ``burst`` on one CUDA device as
    CUDA graphs, the counterpart of the JAX package's jit cache.

    A graph is captured at the first call of its key and replayed at every
    later one:

    - the single advance, keyed by the state's and the inputs' layout
      (shapes and dtypes);
    - the burst, keyed by those (the inputs' leading axis is its depth
      ``n``) and by whether it digests (checksums on and some step saved).

    Each graph reads a static state buffer and a static input buffer, and
    writes static outputs: the next state, or the burst's ``(n, ...)``
    stack of every step (row ``k`` is step ``k``) and, when it digests,
    the ``(n, 4)`` digest of that stack's rows in one launch of the digest
    kernel.  A call copies the state in (one copy a leaf) and the inputs
    (one copy a leaf, from a fresh pinned block), replays, and clones the
    outputs once each: the caller gets the clones, never the graph's own
    buffers, which the next replay overwrites.  Burst steps and saved
    digests are ``[k]`` views of the clones, so a cell keeps its burst's
    stack alive.  Every digest is per row, so the saved values are
    bitwise the eager ones, which digest the saved steps alone.

    The graphs of a device share one ``GraphSet`` (side stream, private
    pool).  Before the first capture on a device whose bodies never ran
    eagerly, ``ExecutorPrograms.rehearse`` runs them once (its digest
    launch runs and counts); ``warmup`` does that first."""

    def __init__(self, programs: ExecutorPrograms, device: torch.device) -> None:
        self.programs = programs
        self.device = device
        self.set = GraphSet(device, "executor")
        self._entries: Dict[tuple, tuple] = {}

    @property
    def captures(self) -> int:
        return self.set.captures

    @property
    def replays(self) -> int:
        return self.set.replays

    def _capture(self, body: Callable[[], None], state: Any, step_inputs: Any) -> Graph:
        if self.device not in self.programs._eager_on:
            self.programs.rehearse(state, step_inputs)
        return self.set.capture(body)

    def advance(self, state: Any, inputs: Any) -> Any:
        host = host_tensors(inputs)
        key = ("advance", _layout(state), _layout(host))
        entry = self._entries.get(key)
        if entry is None:
            entry = (None, _empty_like(state), _empty_like(host, self.device), _empty_like(state))
        graph, st, inp, out = entry
        copy_into(st, state)
        copy_into(inp, host)
        if graph is None:
            advance = self.programs.raw_advance

            def body() -> None:
                nxt = advance(_one_row(st), _one_row(inp))
                tree_map(lambda o, x: o.copy_(x[0]), out, nxt)

            graph = self._capture(body, state, host)
            self._entries[key] = (graph, st, inp, out)
        graph.replay()
        return tree_map(torch.clone, out)

    def burst(
        self, state: Any, inputs: Any, saved: Sequence[int]
    ) -> Tuple[List[Any], Optional[List[torch.Tensor]]]:
        host = host_tensors(inputs)
        n = tree_leaves(host)[0].shape[0]
        digest = self.programs.with_checksums and bool(saved)
        key = ("burst", _layout(state), _layout(host), digest)
        entry = self._entries.get(key)
        if entry is None:
            stack = tree_map(lambda leaf: torch.empty((n, *leaf.shape), dtype=leaf.dtype,
                                                      device=self.device), state)
            sums = torch.empty((n, CHECKSUM_LANES), dtype=torch.int32, device=self.device)
            entry = (None, _empty_like(state), _empty_like(host, self.device), stack, sums)
        graph, st, inp, stack, sums = entry
        copy_into(st, state)
        copy_into(inp, host)
        if graph is None:
            advance = self.programs.raw_advance

            def body() -> None:
                x, steps = _one_row(st), []
                for k in range(n):
                    x = advance(x, tree_map(lambda leaf: leaf[k:k + 1], inp))
                    steps.append(x)
                tree_map(lambda o, *xs: torch.cat(xs, out=o), stack, *steps)
                if digest:
                    sums.copy_(checksum_device(stack))

            graph = self._capture(body, state, tree_map(lambda leaf: leaf[0], host))
            self._entries[key] = (graph, st, inp, stack, sums)
        graph.replay()
        outs = tree_map(torch.clone, stack)
        steps = [_row(outs, k) for k in range(n)]
        if not digest:
            return steps, None
        lanes = sums.clone()
        return steps, [lanes[k] for k in saved]


def _empty_like(tree: Any, device: Optional[torch.device] = None) -> Any:
    """Contiguous uninitialised tensors of ``tree``'s shapes and dtypes."""
    return tree_map(lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype,
                                             device=leaf.device if device is None else device),
                    tree)


class DeviceRequestExecutor:
    """Executes request lists with the game state on ``device``.

    ``advance``         batch-native ``(states (B, ...), inputs (B, ...)) ->
                        states``, pure (it writes neither argument).
    ``init_state``      one unbatched initial state (numpy arrays or tensors).
    ``inputs_to_array`` maps a request's ``[(input, status), ...]`` list to
                        the array ``advance`` takes for one session (e.g. the
                        (P,) u8 bitmask vector of BoxGame), as numpy arrays:
                        those go to the card without a synchronisation.
    ``speculation``     optional ``SpeculativeRollback`` on the same device:
                        K branch trajectories that turn a rollback into a
                        select on the device (see the module docstring).  The
                        executor re-anchors the branches at frame ``load + 1``
                        after every rollback and extends them by one
                        hypothesized frame per executed advance.
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
        speculation: Optional["SpeculativeRollback"] = None,
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
        if speculation is not None and speculation.device != self.device:
            raise ValueError(
                f"speculation lives on {speculation.device}, the executor on {self.device}"
            )
        self._spec = speculation
        self._spec_rollbacks = 0  # host-side: rollbacks seen while speculating

    @property
    def state(self) -> Any:
        """The live state: unbatched tensors on the device."""
        return self._state

    def warmup(self, example_inputs: Any, burst_depths: Sequence[int] = ()) -> None:
        """Run the single advance, the digest and a burst of each depth in
        ``burst_depths`` once, without touching the live state, then wait for
        the card.  This builds the digest kernel, the game's device
        constants and, on a CUDA device, captures the programs' graphs
        (``ExecutorPrograms.warmup``) before a live loop instead of inside
        it.  A full-window rollback of a session with ``max_prediction``
        groups into a ``max_prediction + 1`` deep burst, so pass
        ``range(2, max_prediction + 2)`` to cover every depth (depth 1 is
        the single advance).  A burst that saves no step has a graph of its
        own, captured at its first use."""
        self._programs.warmup(self._state, example_inputs, burst_depths)
        self.block_until_ready()
        if self._spec is not None:
            # every speculation path (extend, advance and extend, and
            # fulfill-and-refill at each depth) once, on scratch buffers
            self._spec.warmup(
                self._state, example_inputs, range(1, self._spec.max_window + 1),
                self._with_checksums,
            )

    @property
    def spec_hits(self) -> int:
        """Rollbacks answered by a branch hit.  Reads the device counter:
        call outside timed paths."""
        return 0 if self._spec is None else self._spec.hits

    @property
    def spec_misses(self) -> int:
        """Rollbacks that fell back to replay (including windows the host
        already knew the branches could not answer)."""
        return self._spec_rollbacks - self.spec_hits

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            synchronize(self.device)

    def run(self, requests: List[GgrsRequest]) -> None:
        """Execute a session's request list in order."""
        i = 0
        n = len(requests)
        while i < n:
            req = requests[i]
            if isinstance(req, SaveGameState):
                self._do_save(req)
                if self._spec is not None and self._spec.root_frame is None:
                    self._spec.root(req.frame, self._state)
                i += 1
            elif isinstance(req, LoadGameState):
                pairs, saves, i = self._collect_burst(requests, i + 1)
                if self._spec is not None and pairs:
                    self._run_rollback_spec(req, pairs, saves)
                else:
                    if self._spec is not None:
                        # a rollback we can't answer disproves the predicted
                        # inputs the branch prefixes were validated against
                        self._spec.invalidate()
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

    def _run_pairs(
        self,
        pairs: List[AdvanceFrame],
        saves: List[Optional[SaveGameState]],
        arrays: Optional[List[Any]] = None,
    ) -> List[Tuple[int, SaveGameState, Any]]:
        """Execute an (Advance, Save?)* run, as one burst when it has two or
        more advances.  ``arrays`` are the advances' inputs when the caller
        already converted them.  Returns the fulfilled saves as
        ``(pair_index, request, state)``."""
        if not pairs:
            return []
        if len(pairs) == 1:
            self._do_advance(pairs[0], inputs=arrays[0] if arrays else None)
            if saves[0] is not None:
                self._do_save(saves[0])
                return [(0, saves[0], self._state)]
            return []
        return self._do_burst(pairs, saves, arrays=arrays)

    # ------------------------------------------------------------------

    def _do_save(self, req: SaveGameState) -> None:
        cs = DeviceChecksum(self._programs.checksum(self._state)) if self._with_checksums else None
        req.cell.save(req.frame, self._state, cs)

    def _on_device(self, data: Any) -> Any:
        """A loaded cell's data as a state on ``self.device``.  Tensors there
        already pass through untouched (no copy, no read); a host tree (the
        numpy leaves ``loads_pytree`` gives a journal failover) or tensors on
        another device go up in one ``from_numpy`` call."""
        dev = self.device
        if all(
            isinstance(leaf, torch.Tensor) and leaf.device.type == dev.type
            and (dev.index is None or leaf.device.index == dev.index)
            for leaf in tree_leaves(data)
        ):
            return data
        return from_numpy(data, dev)

    def _do_load(self, req: LoadGameState) -> None:
        data = req.cell.data()
        assert data is not None, f"loading frame {req.frame} from an empty cell"
        self._state = self._on_device(data)

    def _do_advance(self, req: AdvanceFrame, inputs: Any = None) -> None:
        if inputs is None:
            inputs = self._inputs_to_array(req.inputs)
        if self._spec is not None:
            # the live advance and the K branch extensions in one advance
            nxt = self._spec.advance_and_extend(self._state, inputs)
            if nxt is not None:
                self._state = nxt
                return
        self._state = self._programs.advance(self._state, inputs)

    def _do_burst(
        self,
        pairs: List[AdvanceFrame],
        saves: List[Optional[SaveGameState]],
        arrays: Optional[List[Any]] = None,
    ) -> List[Tuple[int, SaveGameState, Any]]:
        """(Advance, Save?) x N: one upload of the stacked inputs, N advances,
        one digest launch over the saved steps; each save cell gets its
        step's tensors and a lazy checksum over its row of the digest.
        Returns the fulfilled saves as ``(pair_index, request, state)``."""
        if arrays is None:
            arrays = [self._inputs_to_array(p.inputs) for p in pairs]
        saved = [k for k, s in enumerate(saves) if s is not None]
        steps, sums = self._programs.burst(self._state, _stack_pytrees(arrays), saved)
        self._state = steps[-1]
        if self._spec is not None:
            # one extension per executed advance (a no-op while unrooted,
            # e.g. on the rollback miss path)
            for arr in arrays:
                self._spec.extend(arr)
        fulfilled = []
        for j, k in enumerate(saved):
            cs = DeviceChecksum(sums[j]) if sums is not None else None
            saves[k].cell.save(saves[k].frame, steps[k], cs)
            fulfilled.append((k, saves[k], steps[k]))
        return fulfilled

    # ------------------------------------------------------------------
    # speculative rollback fulfillment
    # ------------------------------------------------------------------

    def _run_rollback_spec(
        self,
        load: LoadGameState,
        pairs: List[AdvanceFrame],
        saves: List[Optional[SaveGameState]],
    ) -> None:
        """Fulfil ``Load + (Advance, Save?)*`` with one ``fulfill_and_refill``
        call when the speculation window can answer it; otherwise load and
        replay.

        The burst's trailing advance is the live (not resimulated) frame
        exactly when it has no trailing save -- the session always saves the
        current frame before the live advance -- so the resolve window is
        every advance but a saveless last one.  (When every advance has a
        save, treating them all as resim frames is equally right: a branch is
        only selected where its inputs are bit-equal, so its states equal the
        replay's.)"""
        g = load.frame
        m = len(pairs)
        n_resim = m if saves[-1] is not None else m - 1
        arrays = [self._inputs_to_array(p.inputs) for p in pairs]
        self._spec_rollbacks += 1

        if n_resim >= 1 and self._spec.window_valid(g, n_resim):
            # one call for the whole rollback tick: match and select (or the
            # replay; the host never reads which), re-anchor at g + 1,
            # re-hypothesize the unconfirmed tail and, when the burst ends in
            # a saveless live advance, that advance and its extension
            has_live = n_resim < m
            # one digest launch for the window where any of its steps is saved
            digest = self._with_checksums and any(s is not None for s in saves[:n_resim])
            out = self._spec.fulfill_and_refill(
                g, arrays[:n_resim], self._on_device(load.cell.data()), digest,
                live_inputs=arrays[-1] if has_live else None,
            )
            steps, sums = out[0], out[1]
            for j in range(n_resim):
                if saves[j] is not None:
                    cs = DeviceChecksum(sums[j]) if sums is not None else None
                    saves[j].cell.save(saves[j].frame, steps[j], cs)
            self._state = out[2] if has_live else steps[n_resim - 1]
        else:
            # the window cannot answer this rollback (host-known): it
            # disproved the predicted inputs the prefixes were validated
            # against -- invalidate, replay, and re-anchor at the burst's
            # first saved frame
            self._spec.invalidate()
            self._do_load(load)
            fulfilled = self._run_pairs(pairs, saves, arrays=arrays)
            if fulfilled:
                j0, save0, snap0 = fulfilled[0]
                self._spec.root(save0.frame, snap0)
                for arr in arrays[j0 + 1:]:
                    self._spec.extend(arr)
