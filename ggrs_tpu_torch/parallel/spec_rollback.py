"""Speculative rollback: skip the replay when a branch guessed right.

The port of ``ggrs_tpu/parallel/spec_rollback.py``.  The reference rolls
back and resimulates every time a prediction was wrong (GGRS
src/sessions/p2p_session.rs:658-714).  This module keeps K branch
trajectories, extended every tick under K remote-input hypotheses, so that
when confirmed inputs arrive and a rollback is asked for, a matching branch
answers the whole load -> (advance, save)^N replay by a select on the card.
Misses fall back to the replay: correctness never depends on a hit.

No device->host read on the live path.  The host never learns whether a
rollback hit:

- branch states, trajectories, hypothesized inputs and prefix-validity masks
  live on the device in fixed-shape ``[W, K, ...]`` buffers, written in
  place (``buf[t].copy_``) at host-known rows;
- ``fulfill`` computes both answers -- the matched branch's trajectory and
  the replay of the loaded state -- and takes one with ``torch.where`` on
  the device hit flag: the JAX package's ``lax.cond(hit, take_branch,
  replay)`` without its branch;
- ``fulfill_and_refill`` is the executor's one call per rollback tick;
- the hit counter is an int64 device tensor (torch has no general uint32
  arithmetic), read only by ``hits``.

The port's games are batch-native, so the K branches are a batch of K rows;
where a live advance goes with an extension (``advance_and_extend``, the
fused rollback tick) the live state rides the same ``advance`` call as row
0 of K + 1.  Inputs and hypotheses may be numpy arrays (the executor's
``inputs_to_array`` output; ``branch_inputs`` should return numpy too) or
tensors; numpy rows are stacked on the host and go up in one copy.

Aliasing: the states ``fulfill`` returns become save cells and live state,
so they are fresh tensors (the ``where`` output), never views of the
buffers that later extensions overwrite; the window is read before
``fulfill_and_refill`` rewrites rows ``0..m`` of the same buffers.

The JAX package jits each of these programs: ``extend``,
``advance_and_extend``, ``fulfill`` a ``(n, with_checksums)``, the fused
rollback tick a ``(n, with_checksums, with_live)``, ``refill`` a ``m`` and
``resolve`` a ``n``.  On a CUDA device each is one CUDA graph replay keyed the same way
(``SpecGraphs``); the eager bodies are the graphs' plain versions and what
the CPU runs.  Routing is by the object's device.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..convert import from_numpy
from ..core.device import DeviceLike, resolve_device
from ..ops.checksum import CHECKSUM_LANES, checksum_device
from ..ops.executor import _empty_like, _layout, _stack_pytrees
from ..ops.graphs import KeyedGraphs, host_arrays, leaf_dtype, synchronize
from ..utils.tree import tree_leaves, tree_map

AdvanceFn = Callable[[Any, Any], Any]
# branch_inputs(branch_k, frame, tick_inputs_array) -> full inputs array for
# branch k at ``frame`` (local players' real inputs merged with hypothesis
# k's remote inputs; the session's own prediction arrives as ``tick_inputs``
# so the identity function is the "trust the predictor" branch)
BranchInputsFn = Callable[[int, int, Any], Any]


def _swap01(tree: Any) -> Any:
    """Swap the two leading axes of every leaf, on the host when numpy."""
    return tree_map(
        lambda l: np.swapaxes(l, 0, 1) if isinstance(l, np.ndarray) else l.transpose(0, 1),
        tree,
    )


def _prepend(first: Any, rows: Any) -> Any:
    """``first`` (one row) stacked before ``rows`` (``(n, ...)``), on the
    host when both are numpy."""

    def cat(a: Any, b: Any) -> Any:
        if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
            return np.concatenate([a[None], b])
        a = torch.as_tensor(a)
        return torch.cat([a.unsqueeze(0), torch.as_tensor(b).to(a.device)])

    return tree_map(cat, first, rows)


def _rows(tree: Any, start: int, stop: Optional[int] = None) -> Any:
    return tree_map(lambda l: l[start:stop], tree)


class SpeculativeRollback:
    """K incrementally-extended branch trajectories rooted at a saved frame.

    Usage per tick:
      - ``root(frame, state)`` whenever the rollback anchor moves (a Save of
        the confirmed frame);
      - ``extend(local_inputs)`` once per advanced frame: every branch steps
        under its own hypothesis (one ``advance`` call for all K);
      - on rollback to ``frame``: if ``window_valid(frame, n)``, call
        ``fulfill`` then ``refill`` (or ``fulfill_and_refill``); otherwise
        ``invalidate`` and replay normally.

    ``advance`` is batch-native; states given and returned are single
    (unbatched) states on ``device`` (the card by default).  On a CUDA
    device every call but ``root`` and ``invalidate`` is one CUDA graph
    replay (``graphs()``)."""

    def __init__(
        self,
        advance: AdvanceFn,
        num_branches: int,
        branch_inputs: BranchInputsFn,
        max_window: int = 16,
        branch_inputs_all: Optional[Callable[[int, Any], Any]] = None,
        device: DeviceLike = None,
    ) -> None:
        assert num_branches >= 1
        self.K = num_branches
        self.max_window = max_window
        self.device = resolve_device(device)
        self._advance = advance
        self._branch_inputs = branch_inputs
        # optional vectorized hypothesis builder: one call producing the whole
        # [K, ...] stack for a frame instead of K per-branch calls
        self._branch_inputs_all = branch_inputs_all

        self._root_frame: Optional[int] = None
        self._count = 0  # host-tracked window length (never read from device)
        self._states: Any = None  # (K, ...) current branch states
        self._traj_buf: Any = None  # [W, K, ...] post-advance states
        self._inp_buf: Any = None  # [W, K, ...] hypothesized inputs
        self._prefix_buf: Optional[torch.Tensor] = None  # [W, K] cumulative ok
        self._hit_count = torch.zeros((), dtype=torch.int64, device=self.device)
        self._graphs: Optional[SpecGraphs] = None

    def graphs(self) -> Optional["SpecGraphs"]:
        """The graphs of this object's device, made at first use when it
        is a CUDA device; None elsewhere (the eager route)."""
        if self._graphs is None and self.device.type == "cuda":
            self._graphs = SpecGraphs(self)
        return self._graphs

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    def _up(self, tree: Any) -> Any:
        return from_numpy(tree, self.device)

    def _match(self, hyp: Any, target: Any) -> torch.Tensor:
        """(K,) mask: which branches' hypothesis equals ``target`` (one frame)."""
        match = None
        for h, c in zip(tree_leaves(hyp), tree_leaves(target)):
            eq = (h == c.unsqueeze(0)).reshape(self.K, -1).all(dim=1)
            match = eq if match is None else match & eq
        return match

    def _match_window(self, hyps: Any, targets: Any) -> torch.Tensor:
        """(n, K) mask over a window: hypotheses ``(n, K, ...)`` against the
        session's inputs ``(n, ...)``, frame by frame."""
        match = None
        for h, c in zip(tree_leaves(hyps), tree_leaves(targets)):
            n = h.shape[0]
            eq = (h == c.unsqueeze(1)).reshape(n, self.K, -1).all(dim=2)
            match = eq if match is None else match & eq
        return match

    def _root_impl(self, state: Any) -> Any:
        """K branch rows of one state: an expanded view (``advance`` writes
        neither argument, and the buffers take copies)."""
        return tree_map(lambda leaf: leaf.unsqueeze(0).expand(self.K, *leaf.shape), state)

    def _step(self, states: Any, inputs: Any, live: Any = None):
        """Advance the K branch rows; with ``live`` (one state) its row goes
        first in the same ``advance`` call, and ``inputs`` holds K + 1 rows,
        the live inputs first.  Returns (branch states, next live state or
        None)."""
        if live is None:
            return self._advance(states, inputs), None
        st = tree_map(lambda l, b: torch.cat([l.unsqueeze(0), b]), live, states)
        out = self._advance(st, inputs)
        return _rows(out, 1), _row(out, 0)

    def _buffers(self) -> tuple:
        """The window's buffers: (trajectories, hypotheses, prefix masks)."""
        return self._traj_buf, self._inp_buf, self._prefix_buf

    def _write_rows(self, start: int, traj: Any = None, hyps: Any = None,
                    prefix: Optional[torch.Tensor] = None, bufs: Optional[tuple] = None) -> None:
        """In place: rows from ``start`` of the window's buffers (``bufs``,
        or this object's) take the given values."""
        traj_buf, inp_buf, prefix_buf = bufs or self._buffers()
        if traj is not None:
            tree_map(lambda b, v: b[start].copy_(v), traj_buf, traj)
        if hyps is not None:
            n = tree_leaves(hyps)[0].shape[0]
            tree_map(lambda b, v: b[start:start + n].copy_(v), inp_buf, hyps)
        if prefix is not None:
            prefix_buf[start:start + prefix.shape[0]].copy_(prefix)

    def _extend_one(self, t: int, states: Any, rows: Any, live: Any = None) -> Any:
        """Window row ``t``: the branches step under their hypotheses,
        matched against the session's inputs; ``rows`` is ``(K + 1, ...)``,
        the session's inputs first.  Returns the next live state when
        ``live`` rides along (under the session's inputs)."""
        local, hyps = _row(rows, 0), _rows(rows, 1)
        new_states, live_next = self._step(states, hyps if live is None else rows, live)
        ok = self._match(hyps, local)
        if t > 0:
            ok = self._prefix_buf[t - 1] & ok
        self._write_rows(t, traj=new_states, hyps=tree_map(lambda h: h.unsqueeze(0), hyps),
                         prefix=ok.unsqueeze(0))
        self._states = new_states
        return live_next

    def _extend_at(self, t: torch.Tensor, states: Any, rows: Any, live: Any, bufs: tuple):
        """``_extend_one`` at a window row held on the device (``t``, an
        ``(1,)`` int64 tensor), writing nothing but the window's buffers
        ``bufs``: returns (branch states, next live state or None).  The
        graphs' body of ``extend`` and ``advance_and_extend``."""
        traj_buf, inp_buf, prefix_buf = bufs
        local, hyps = _row(rows, 0), _rows(rows, 1)
        new_states, live_next = self._step(states, hyps if live is None else rows, live)
        # row t - 1's prefix, or all true at t = 0
        prev = prefix_buf.index_select(0, (t - 1).clamp(min=0))[0] | (t == 0)
        ok = prev & self._match(hyps, local)
        tree_map(lambda b, v: b.index_copy_(0, t, v.unsqueeze(0)), traj_buf, new_states)
        tree_map(lambda b, v: b.index_copy_(0, t, v.unsqueeze(0)), inp_buf, hyps)
        prefix_buf.index_copy_(0, t, ok.unsqueeze(0))
        return new_states, live_next

    def _extend_scan(self, states: Any, hyps: Any, tail: Any, live: Any = None,
                     bufs: Optional[tuple] = None) -> Any:
        """Rows ``0..m-1`` of the window (``bufs``, or this object's) from
        ``states``: ``m`` steps under ``hyps`` (``(m, K, ...)``), matched
        against the session's ``tail`` (``(m, ...)``).  With ``live``, the
        last step carries the live advance under ``tail[m - 1]``.  Returns
        (branch states, the live state or None)."""
        m = tree_leaves(hyps)[0].shape[0]
        live_next = None
        for t in range(m):
            if live is not None and t == m - 1:
                rows = tree_map(lambda s, h: torch.cat([s[t:t + 1], h[t]]), tail, hyps)
                states, live_next = self._step(states, rows, live)
            else:
                states, _ = self._step(states, _row(hyps, t))
            self._write_rows(t, traj=states, bufs=bufs)
        ok = self._match_window(hyps, tail)
        prefix = ok.to(torch.int32).cumprod(dim=0)
        self._write_rows(0, hyps=hyps, prefix=prefix, bufs=bufs)
        return states, live_next

    def _window(self, offset: int, n: int):
        """The window's rows ``offset..offset + n`` (inputs, trajectories)
        and the prefix mask before it (None at offset 0)."""
        prev = self._prefix_buf[offset - 1] if offset > 0 else None
        return (_rows(self._inp_buf, offset, offset + n),
                _rows(self._traj_buf, offset, offset + n), prev)

    def _window_at(self, index: torch.Tensor, offset: torch.Tensor, bufs: tuple):
        """``_window`` of the buffers ``bufs`` at an offset held on the
        device: ``index`` is the ``(n,)`` int64 rows ``offset..offset + n``,
        ``offset`` an ``(1,)`` int64 tensor; the prefix mask is all true at
        offset 0."""
        traj_buf, inp_buf, prefix_buf = bufs
        prev = prefix_buf.index_select(0, (offset - 1).clamp(min=0))[0] | (offset == 0)
        pick = lambda buf: tree_map(lambda b: b.index_select(0, index), buf)
        return pick(inp_buf), pick(traj_buf), prev

    def _resolve_window(self, window, load_state: Any, confirmed: Any, n: int,
                        with_checksums: bool):
        """Core shared by the fulfill calls: hypothesis matching, branch
        selection and the fallback replay, both computed and one taken on
        the device hit flag.  ``window`` is ``_window``'s or
        ``_window_at``'s.  Returns ``(steps, sums, hit)``: the stacked
        ``(n, ...)`` post-advance states (fresh tensors), their ``(n, 4)``
        digests (one launch; None without checksums), and the hit flag."""
        win_inp, win_traj, prev = window
        match = self._match_window(win_inp, confirmed).all(dim=0)
        if prev is not None:
            match = prev & match
        hit = match.any()
        # torch.argmax takes no bool; on ints it returns the first maximum:
        # the first matching branch
        idx = torch.argmax(match.to(torch.int32)).reshape(1)
        branch = tree_map(lambda l: l.index_select(1, idx).squeeze(1), win_traj)
        st = tree_map(lambda l: l.unsqueeze(0), load_state)
        replayed = []
        for t in range(n):
            st = self._advance(st, _rows(confirmed, t, t + 1))
            replayed.append(st)
        replay = replayed[0] if n == 1 else tree_map(lambda *xs: torch.cat(xs), *replayed)
        steps = tree_map(lambda b, r: torch.where(hit, b, r), branch, replay)
        sums = checksum_device(steps) if with_checksums else None
        return steps, sums, hit

    # ------------------------------------------------------------------
    # buffers and hypotheses
    # ------------------------------------------------------------------

    def _ensure_buffers(self, hyps: Any) -> None:
        if self._traj_buf is not None:
            return
        W = self.max_window
        alloc = lambda tree: tree_map(
            lambda l: torch.zeros((W, *l.shape), dtype=leaf_dtype(l), device=self.device), tree
        )
        self._traj_buf = alloc(self._states)
        self._inp_buf = alloc(hyps)
        self._prefix_buf = torch.zeros((W, self.K), dtype=torch.bool, device=self.device)

    def _hypotheses(self, frame: int, local_inputs: Any) -> Any:
        if self._branch_inputs_all is not None:
            return self._branch_inputs_all(frame, local_inputs)
        return _stack_pytrees(
            [self._branch_inputs(k, frame, local_inputs) for k in range(self.K)]
        )

    def _window_hypotheses(self, frame: int, inputs_seq: Sequence[Any]) -> Any:
        """Hypotheses for a whole window as ``[m, K, ...]``: branch k's
        inputs for frames ``frame + t`` built from ``inputs_seq[t]``."""
        if self._branch_inputs_all is not None:
            return _stack_pytrees(
                [self._branch_inputs_all(frame + t, inputs_seq[t]) for t in range(len(inputs_seq))]
            )
        hyps = _stack_pytrees([
            _stack_pytrees([self._branch_inputs(k, frame + t, inputs_seq[t])
                            for t in range(len(inputs_seq))])
            for k in range(self.K)
        ])
        return _swap01(hyps)  # built as [K, m, ...]

    def _with_hypotheses(self, frame: int, inputs: Any) -> Any:
        """``inputs`` and the K hypotheses for ``frame`` as K + 1 rows on
        the device, uploaded together."""
        return self._up(_prepend(inputs, self._hypotheses(frame, inputs)))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def window(self) -> int:
        return self._count

    @property
    def root_frame(self) -> Optional[int]:
        return self._root_frame

    @property
    def hits(self) -> int:
        """Reads the device hit counter: call only outside timed paths."""
        return int(self._hit_count)

    def invalidate(self) -> None:
        """Drop the anchor and the whole window.  Callers MUST invalidate on
        any rollback that ``fulfill`` + ``refill`` does not answer: such a
        rollback disproves the predicted inputs the prefix masks were
        validated against.  ``extend`` no-ops and ``window_valid`` is false
        until the next ``root``."""
        self._root_frame = None
        self._states = None
        self._count = 0

    def root(self, frame: int, state: Any) -> None:
        """Re-anchor all branches at ``state`` (the save of ``frame``).  On
        the graph route the branch buffer takes ``state`` by one copy a
        leaf: a graph of ``L`` copies would save nothing."""
        self._root_frame = frame
        g = self.graphs()
        self._states = self._root_impl(state) if g is None else g.root(state)
        self._count = 0

    def extend(self, local_inputs: Any) -> None:
        """Advance every branch one frame under its hypothesis.  The frame
        being hypothesized is ``root_frame + window``."""
        if self._root_frame is None or self._count >= self.max_window:
            return
        frame = self._root_frame + self._count
        g = self.graphs()
        if g is None:
            rows = self._with_hypotheses(frame, local_inputs)
            self._ensure_buffers(_rows(rows, 1))
            self._extend_one(self._count, self._states, rows)
        else:
            g.extend(self._count, _prepend(local_inputs, self._hypotheses(frame, local_inputs)))
        self._count += 1

    def advance_and_extend(self, state: Any, inputs: Any) -> Optional[Any]:
        """Advance the live ``state`` AND extend all K branches in one
        ``advance`` call of K + 1 rows.  Returns the new live state, or None
        when the window cannot extend (unrooted / full): the caller must then
        advance the live state itself."""
        if self._root_frame is None or self._count >= self.max_window:
            return None
        frame = self._root_frame + self._count
        g = self.graphs()
        if g is None:
            rows = self._with_hypotheses(frame, inputs)
            self._ensure_buffers(_rows(rows, 1))
            new_state = self._extend_one(self._count, self._states, rows, live=state)
        else:
            new_state = g.advance_and_extend(self._count, state,
                                             _prepend(inputs, self._hypotheses(frame, inputs)))
        self._count += 1
        return new_state

    def window_valid(self, frame: int, n: int) -> bool:
        """Host-side check (no device read): can a rollback to ``frame``
        covering ``n`` resimulated frames be answered from this window?"""
        if self._root_frame is None or n < 1:
            return False
        offset = frame - self._root_frame
        return 0 <= offset and offset + n <= self._count

    def fulfill(
        self, frame: int, confirmed: Sequence[Any], load_state: Any, with_checksums: bool,
    ) -> Tuple[List[Any], Optional[List[torch.Tensor]]]:
        """Resolve-or-replay: returns the ``n`` per-step post-advance states
        for the rollback window and, when asked, their ``(4,)`` digest lanes
        (one launch for the window).  The states come from the matching
        branch when one hypothesized exactly these inputs, else from the
        replay of ``load_state``: the host never reads which.

        Requires ``window_valid(frame, len(confirmed))``.  ``frame`` may lie
        past the root: a branch is valid iff its hypotheses equalled the
        session's own inputs from the root up to ``frame`` (the prefix
        masks) and the confirmed inputs from ``frame`` on."""
        n = len(confirmed)
        assert self.window_valid(frame, n)
        offset = frame - self._root_frame
        g = self.graphs()
        if g is None:
            steps, sums, hit = self._resolve_window(
                self._window(offset, n), load_state, self._up(_stack_pytrees(confirmed)), n,
                with_checksums,
            )
            self._hit_count = self._hit_count + hit
        else:
            steps, sums, _ = g.fulfill(offset, load_state, _stack_pytrees(confirmed), n,
                                       with_checksums)
        return _unstack(steps, n), None if sums is None else list(sums)

    def fulfill_and_refill(
        self,
        frame: int,
        confirmed: Sequence[Any],
        load_state: Any,
        with_checksums: bool,
        live_inputs: Any = None,
    ) -> Union[
        Tuple[List[Any], Optional[List[torch.Tensor]]],
        Tuple[List[Any], Optional[List[torch.Tensor]], Any],
    ]:
        """``fulfill`` plus the post-rollback re-anchor and re-extension:
        resolve-or-replay the window, root the branches at ``frame + 1`` on
        the first step, and re-hypothesize the confirmed tail.  Same return
        value as ``fulfill``; the window afterwards equals ``refill(frame +
        1, steps[0], confirmed[1:])``.

        With ``live_inputs``, the tick's trailing live advance rides along:
        the return gains a third element, the live state ``advance(steps[-1],
        live_inputs)``, and the window extends one more hypothesized frame
        (``frame + n``), as a following ``advance_and_extend`` would."""
        n = len(confirmed)
        assert self.window_valid(frame, n)
        offset = frame - self._root_frame
        with_live = live_inputs is not None
        seq = list(confirmed) + ([live_inputs] if with_live else [])
        tail = seq[1:]
        m_ext = len(tail)
        host_hyps = self._window_hypotheses(frame + 1, tail) if tail else None
        g = self.graphs()
        if g is None:
            session = self._up(_stack_pytrees(seq))  # confirmed (+ live), one copy
            steps, sums, hit = self._resolve_window(
                self._window(offset, n), load_state, _rows(session, 0, n), n, with_checksums,
            )
            # the window was read above; from here rows 0.. are rewritten
            self._hit_count = self._hit_count + hit
            first = tree_map(lambda l: l[0], steps)
            live = None
            if m_ext:
                last = tree_map(lambda l: l[n - 1], steps) if with_live else None
                self._states, live = self._extend_scan(
                    self._root_impl(first), self._up(host_hyps), _rows(session, 1), live=last)
            else:
                self._states = self._root_impl(first)
        else:
            steps, sums, live = g.fulfill(offset, load_state, _stack_pytrees(seq), n,
                                          with_checksums, refill=True, hyps=host_hyps,
                                          with_live=with_live)
            self._states = g.states
        self._root_frame = frame + 1
        self._count = m_ext
        out = (_unstack(steps, n), None if sums is None else list(sums))
        return out + (live,) if with_live else out

    def refill(self, frame: int, state: Any, local_inputs: Sequence[Any]) -> None:
        """Re-anchor at ``(frame, state)`` and re-extend the still-unconfirmed
        tail (``local_inputs``, one per frame from ``frame`` on)."""
        m = min(len(local_inputs), self.max_window)
        local_inputs = list(local_inputs)[:m]
        if m == 0:
            self.root(frame, state)
            return
        self._root_frame = frame
        self._count = 0
        host_hyps = self._window_hypotheses(frame, local_inputs)
        g = self.graphs()
        if g is None:
            self._states = self._root_impl(state)
            hyps = self._up(host_hyps)
            self._ensure_buffers(_row(hyps, 0))
            self._states, _ = self._extend_scan(self._states, hyps,
                                                self._up(_stack_pytrees(local_inputs)))
        else:
            self._states = g.refill(state, host_hyps, _stack_pytrees(local_inputs))
        self._count = m

    def warmup(
        self, state: Any, example_inputs: Any, depths: Sequence[int], with_checksums: bool,
    ) -> None:
        """Run every path a live session can take -- extend, advance and
        extend, and fulfill-and-refill at each depth with and without the
        live advance -- once, then wait for the card.  This builds the
        digest kernel, fills the allocators and, on a CUDA device, captures
        every path's graph before a live loop.  All window state (the hit
        counter too) is restored after.

        The eager route runs on scratch buffers.  The graphs read and write
        the window's own buffers, which are never replaced: their contents
        are kept aside and copied back instead."""
        saved = (self._root_frame, self._count, self._states)
        g = self.graphs()
        if g is None:
            refs = (self._traj_buf, self._inp_buf, self._prefix_buf, self._hit_count)
            self._traj_buf = self._inp_buf = self._prefix_buf = None  # scratch
        else:
            kept = [(b, b.clone()) for b in g.buffers()]
        try:
            self.root(0, state)
            self.advance_and_extend(state, example_inputs)
            for n in sorted(set(depths)):
                if not 1 <= n <= self.max_window:
                    continue
                for live in (None, example_inputs):
                    self.root(0, state)
                    for _ in range(n):
                        self.extend(example_inputs)
                    self.fulfill_and_refill(
                        0, [example_inputs] * n, state, with_checksums, live_inputs=live,
                    )
            if self.device.type == "cuda":
                synchronize(self.device)
        finally:
            self._root_frame, self._count, self._states = saved
            if g is None:
                self._traj_buf, self._inp_buf, self._prefix_buf, self._hit_count = refs
            else:
                for b, copy in kept:
                    b.copy_(copy)

    # ------------------------------------------------------------------
    # diagnostic / test API (reads device->host; not for the live path)
    # ------------------------------------------------------------------

    def resolve(self, frame: int, confirmed: Sequence[Any]) -> Optional[List[Any]]:
        """Match hypotheses against the ``confirmed`` inputs for the frames
        from ``frame`` on; returns the matched branch's per-step states or
        None.  Reads the hit flag back to the host: use ``fulfill`` on live
        paths."""
        n = len(confirmed)
        if not self.window_valid(frame, n):
            return None
        offset = frame - self._root_frame
        g = self.graphs()
        if g is not None:
            hit, traj = g.resolve(offset, _stack_pytrees(confirmed), n)
            return _unstack(traj, n) if hit else None
        win_inp, win_traj, prev = self._window(offset, n)
        match = self._match_window(win_inp, self._up(_stack_pytrees(confirmed))).all(dim=0)
        if prev is not None:
            match = prev & match
        if not bool(match.any()):
            return None
        idx = torch.argmax(match.to(torch.int32)).reshape(1)
        return _unstack(tree_map(lambda l: l.index_select(1, idx).squeeze(1), win_traj), n)


class SpecGraphs(KeyedGraphs):
    """``SpeculativeRollback``'s programs on its CUDA device as CUDA graphs,
    the counterpart of the JAX package's jit caches.

    A graph is captured at the first call of its key and replayed at every
    later one, keyed as the JAX package compiles:

    - ``extend`` and ``advance_and_extend``, one each, keyed by the layouts
      of the live state and the ``K + 1`` input rows;
    - ``fulfill`` per ``(n, with_checksums)``, the fused rollback tick
      (``fulfill_and_refill``) per ``(n, with_checksums, with_live)``,
      ``refill`` per ``m`` and ``resolve`` per ``n`` (and the layouts).

    The window row ``t`` and the rollback ``offset`` are host integers the
    JAX programs trace; here they go up with the call's inputs and
    hypotheses in one ``Upload`` and the bodies read them on the device
    (``_extend_at``, ``_window_at``), so one graph serves every row and
    offset.  The branch states (``states``), the ``[W, K, ...]`` window
    buffers, the prefix masks and the hit counter are allocated once and
    never replaced: the bodies write them in place, and ``warmup`` keeps
    their contents aside instead of swapping them.  A live or load state
    goes into the key's static state by one copy a leaf; what a call
    returns (the live state, the steps and their digests) are clones of
    the key's static outputs, which the next replay overwrites, and the
    steps are ``[k]`` views of their clone.  The window is read before the
    fused tick rewrites its rows ``0..m``, in stream order inside the
    graph.

    A body binds the buffers it reads and writes when it is built, as its
    capture binds their memory.  Before the first capture the bodies' lazy
    work (the game's device constants, the digest library's first launch)
    runs once eagerly: one ``K``-row advance and one digest launch,
    counted."""

    def __init__(self, spec: SpeculativeRollback) -> None:
        super().__init__(spec.device, "speculation")
        self.spec = spec
        self.states: Any = None  # (K, ...) branch states

    def buffers(self) -> List[torch.Tensor]:
        """Every buffer the graphs write that exists so far."""
        spec = self.spec
        return ([spec._hit_count] + tree_leaves(self.states) + tree_leaves(spec._traj_buf)
                + tree_leaves(spec._inp_buf) + tree_leaves(spec._prefix_buf))

    def _alloc(self, state: Any) -> None:
        if self.states is None:
            K = self.spec.K
            self.states = tree_map(lambda l: torch.empty((K, *l.shape), dtype=l.dtype,
                                                         device=self.device), state)

    def rehearse(self, body) -> None:
        """The bodies' lazy work, eagerly: a ``K``-row advance and a digest
        launch, writing nothing (the bodies write the window in place)."""
        spec = self.spec
        spec._advance(self.states, _row(spec._inp_buf, 0))
        checksum_device(self.states)

    def root(self, state: Any) -> Any:
        self._alloc(state)
        tree_map(lambda b, l: b.copy_(l), self.states, state)  # broadcast over the K rows
        return self.states

    def extend(self, t: int, rows: Any) -> None:
        spec, rows = self.spec, host_arrays(rows)
        spec._ensure_buffers(_rows(rows, 1))

        def build(views, _):
            rows_v, t_v = views
            branches, bufs = self.states, spec._buffers()

            def body() -> None:
                states, _ = spec._extend_at(t_v, branches, rows_v, None, bufs)
                _copy(branches, states)

            return body, None

        self.replay(("extend", _layout(rows)), [rows, np.array([t], np.int64)], None, build)

    def advance_and_extend(self, t: int, state: Any, rows: Any) -> Any:
        spec, rows = self.spec, host_arrays(rows)
        spec._ensure_buffers(_rows(rows, 1))

        def build(views, live):
            rows_v, t_v = views
            out = _empty_like(live)
            branches, bufs = self.states, spec._buffers()

            def body() -> None:
                states, nxt = spec._extend_at(t_v, branches, rows_v, live, bufs)
                _copy(branches, states)
                _copy(out, nxt)

            return body, out

        out = self.replay(("advance_and_extend", _layout(state), _layout(rows)),
                           [rows, np.array([t], np.int64)], state, build)
        return tree_map(torch.clone, out)

    def fulfill(self, offset: int, load_state: Any, session: Any, n: int, with_checksums: bool,
                refill: bool = False, hyps: Any = None, with_live: bool = False):
        """``fulfill`` (``refill`` false) or the fused rollback tick: the
        window's ``(n, ...)`` steps, their ``(n, 4)`` digests (None without
        checksums) and the live state (None without ``with_live``), all
        clones.  ``session`` is the confirmed inputs (then the live ones),
        ``hyps`` the tail's ``(m, K, ...)`` hypotheses or None."""
        spec = self.spec
        session = host_arrays(session)
        sections = [session, np.arange(offset, offset + n, dtype=np.int64),
                    np.array([offset], np.int64)]
        if hyps is not None:
            sections.append(host_arrays(hyps))
        key = ("fulfill_and_refill" if refill else "fulfill", n, with_checksums, with_live,
               _layout(load_state), _layout(session))

        def build(views, load):
            sess_v, index, off = views[:3]
            hyps_v = views[3] if hyps is not None else None
            steps_out = tree_map(lambda l: torch.empty((n, *l.shape), dtype=l.dtype,
                                                       device=self.device), load)
            sums_out = (torch.empty((n, CHECKSUM_LANES), dtype=torch.int32, device=self.device)
                        if with_checksums else None)
            live_out = _empty_like(load) if with_live else None
            branches, bufs, hits = self.states, spec._buffers(), spec._hit_count

            def body() -> None:
                steps, sums, hit = spec._resolve_window(
                    spec._window_at(index, off, bufs), load, _rows(sess_v, 0, n), n,
                    with_checksums)
                hits.add_(hit)
                _copy(steps_out, steps)
                if with_checksums:
                    sums_out.copy_(sums)
                if not refill:
                    return
                # the window was read above; from here rows 0.. are rewritten
                first = _row(steps, 0)
                if hyps_v is None:
                    _copy(branches, first)  # broadcast over the K rows
                    return
                last = _row(steps, n - 1) if with_live else None
                states, live = spec._extend_scan(spec._root_impl(first), hyps_v,
                                                 _rows(sess_v, 1), live=last, bufs=bufs)
                _copy(branches, states)
                if with_live:
                    _copy(live_out, live)

            return body, (steps_out, sums_out, live_out)

        steps, sums, live = self.replay(key, sections, load_state, build)
        return (tree_map(torch.clone, steps), None if sums is None else sums.clone(),
                None if live is None else tree_map(torch.clone, live))

    def refill(self, state: Any, hyps: Any, session: Any) -> Any:
        spec = self.spec
        hyps, session = host_arrays(hyps), host_arrays(session)
        self._alloc(state)
        spec._states = self.states  # the window buffers take its layout
        spec._ensure_buffers(_row(hyps, 0))
        m = tree_leaves(hyps)[0].shape[0]

        def build(views, root):
            hyps_v, sess_v = views
            branches, bufs = self.states, spec._buffers()

            def body() -> None:
                states, _ = spec._extend_scan(spec._root_impl(root), hyps_v, sess_v, bufs=bufs)
                _copy(branches, states)

            return body, None

        self.replay(("refill", m, _layout(state), _layout(hyps)), [hyps, session], state, build)
        return self.states

    def resolve(self, offset: int, confirmed: Any, n: int) -> Tuple[bool, Any]:
        """The hit flag, read back, and the first matching branch's ``(n,
        ...)`` trajectory (a clone)."""
        spec = self.spec
        confirmed = host_arrays(confirmed)

        def build(views, _):
            conf_v, index, off = views
            hit = torch.zeros((), dtype=torch.bool, device=self.device)
            traj = tree_map(lambda b: torch.empty((n, *b.shape[2:]), dtype=b.dtype,
                                                  device=self.device), spec._traj_buf)
            bufs = spec._buffers()

            def body() -> None:
                win_inp, win_traj, prev = spec._window_at(index, off, bufs)
                match = prev & spec._match_window(win_inp, conf_v).all(dim=0)
                hit.copy_(match.any())
                idx = torch.argmax(match.to(torch.int32)).reshape(1)
                _copy(traj, tree_map(lambda l: l.index_select(1, idx).squeeze(1), win_traj))

            return body, (hit, traj)

        hit, traj = self.replay(("resolve", n, _layout(confirmed)),
                                 [confirmed, np.arange(offset, offset + n, dtype=np.int64),
                                  np.array([offset], np.int64)], None, build)
        return bool(hit), tree_map(torch.clone, traj)


def _copy(dst: Any, src: Any) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _row(tree: Any, t: int) -> Any:
    return tree_map(lambda l: l[t], tree)


def _unstack(tree: Any, n: int) -> List[Any]:
    return [_row(tree, t) for t in range(n)]
