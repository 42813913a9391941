"""The rollback replay: load -> (advance, digest, save)^d -> advance, per tick,
for a batch of sessions in lockstep.

This is the port of ``ggrs_tpu/ops/replay.py``: the request list a SyncTest
session emits per tick (Load, then ``check_distance`` resimulated
Save/Advance pairs, then the live Save/Advance;
GGRS src/sessions/sync_test_session.rs:85-150) run on device with
state, inputs and digests resident there.  A first-seen digest history is
compared with every resimulated frame's digest, so desyncs are counted on
device and reach the host only when asked.

Where the JAX package donates the carry, the port updates the carry's
preallocated tensors IN PLACE (nothing is returned that the caller did not
pass in).  The carry is batched over sessions; its shapes are the JAX
package's with a leading session axis, as ``BatchedSessions`` stacks it::

    ring       -- DeviceStateRing buffers (states / checksums / frames)
    inputs     -- input ring (B, R, ...), same slotting as the state ring
    hist       -- (B, R, 4) int32 first-seen digest per frame slot
    live       -- the current (unsaved) game state, leaves (B, ...)
    frame      -- (B,) int32, the sessions' current frame
    mismatches -- (B,) int32 count of resimulated frames whose digest diverged
    first_bad  -- (B,) int32 earliest mismatched frame (INT32_MAX if none)

Every ring-indexed buffer (the state ring, its checksums and frames, the
input ring, ``hist``) is STORED slot-major: a ``(R, B, ...)`` tensor that
the carry holds as its ``transpose(0, 1)``, a ``(B, R, ...)`` view.  Whatever
reads the carry sees the shapes above; a slot ``buf[:, i]`` is one
contiguous ``(B, ...)`` block, and k consecutive slots one ``(k*B, ...)``
block.  So the steady tick advances each resimulated frame straight into
its ring slot, digests the window where it lies, one launch a contiguous
span of slots, straight into the checksums' span, and compares the digests
with the history in their slots: no stack, no concatenation and no copy of
the window.  A window of d frames wraps the ring at most once, so a steady
tick makes two digest calls, or three where the window wraps
(``digest_calls``); the JAX scan digests each step inside its body.  Every
digest is per row, so the values are bitwise the same.

Digests are int32 tensors holding u32 bit patterns.  Slots are host ints
(sessions tick in lockstep), so every ring access is a shared-index slice;
the frame NUMBERS a tick writes (the ring's ``frames``, ``first_bad``) come
from the carry's ``frame``, which each tick advances by one, as the JAX
scan takes its frames as traced inputs.  ``run_*`` never reads a value back
to the host and never synchronises, but for ``run_ticks`` where both of the
stage's buffers are still being sent (``ops/stage.py``).

The JAX package jits its scan of ticks into one XLA program.  The port's
counterpart on the card is a CUDA graph: ``run_steady`` on a CUDA carry
runs each steady tick as one input copy and one replay of the graph of its
phase ``frame % R`` (``TickGraphs``).  ``run_ticks``, both SyncTest
entries' call, stages a call's host inputs once in the carry's persistent
pinned block (``ops/stage.py``), so that input copy is one host-to-device
copy from the tick's pinned row straight into its input ring slot.  A
tick's slots depend on its frame only through the phase, and its frame
numbers come from the device, so the graph captured at frame F is the tick
at every frame F + kR.  The eager ``steady_tick`` is the graph's plain
version and what a CPU carry runs.  The warmup ticks stay eager: d + 1 of
them per session, each in another phase.  ``build_scrub_program`` graphs a window of advances the
same way.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Set, Tuple

import torch

from ..convert import from_numpy
from ..core.device import DeviceLike, resolve_device
from ..obs.registry import default_registry
from ..utils.tracing import layer, trace_span
from ..utils.tree import tree_copy_, tree_leaves, tree_map, writing_into
from .checksum import CHECKSUM_LANES, checksum_device
from .graphs import Graph, GraphSet
from .ring import DeviceStateRing
from .stage import InputStage

I32_MAX = 2**31 - 1

UPLOADS = default_registry().counter(
    "ggrs_tick_upload_total",
    "SyncTest ticks by how their inputs reached the input ring: staged (a pinned row "
    "sent into the slot), device (a CUDA tensor copied there), host (a CPU carry)",
    labels=("route",),
)
_UPLOADED = {route: UPLOADS.labels(route=route) for route in ("staged", "device", "host")}

AdvanceFn = Callable[[Any, Any], Any]  # (states (B, ...), inputs (B, ...)) -> states
ChecksumFn = Callable[[Any], torch.Tensor]  # states (B, ...) -> (B, 4) int32


def _tick_slice(tick_inputs: Any, t: int) -> Any:
    return tree_map(lambda a: a[:, t], tick_inputs)


def _slot_major(r: int, leaf: torch.Tensor) -> torch.Tensor:
    """``leaf`` (B, ...) in each of R slots, stored slot-major: the
    ``(B, R, ...)`` view of a contiguous ``(R, B, ...)`` tensor."""
    return leaf.unsqueeze(0).expand(r, *leaf.shape).clone(
        memory_format=torch.contiguous_format).transpose(0, 1)


def _slots(buf: torch.Tensor, rs: slice) -> torch.Tensor:
    """Slots ``rs`` of a slot-major ``(B, R, ...)`` buffer as ``(k, B,
    ...)``: the contiguous block that stores them."""
    return buf.transpose(0, 1)[rs]


def _rows(buf: torch.Tensor, rs: slice) -> torch.Tensor:
    """Slots ``rs`` as ``(k*B, ...)`` rows in slot order, a view (raises
    rather than copy, so a write lands in the ring)."""
    block = _slots(buf, rs)
    return block.view(-1, *block.shape[2:])


def _carry_key(carry: Any) -> tuple:
    """What a carry's graphs are bound to: every leaf's address, shape,
    strides and dtype."""
    return tuple((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype) for x in tree_leaves(carry))


def _stage_key(carry: Any) -> tuple:
    """What a carry's input stage is bound to: its input ring's addresses,
    shapes and dtypes (a few leaves, where ``_carry_key`` reads them all)."""
    return tuple((x.data_ptr(), tuple(x.shape), x.dtype) for x in tree_leaves(carry["inputs"]))


@dataclass(frozen=True)
class ReplayPrograms:
    """Tick programs over a fixed (advance, ring, check_distance).

    ``advance`` is batch-native and pure: it takes state leaves ``(B, ...)``
    and inputs ``(B, ...)`` and returns new tensors without writing its
    arguments (the loaded state is a view of the ring).  Where it takes an
    ``out`` (the games with a kernel, ``games/_card.py``: the leaves to
    write) the steady tick hands it the ring slot or live state to write;
    otherwise its result is copied there.  ``checksum`` likewise, with ``out`` the digests'
    rows."""

    ring: DeviceStateRing
    check_distance: int
    advance: AdvanceFn
    checksum: ChecksumFn
    # the steady tick's graphs of each CUDA carry, by _carry_key
    _graphs: Dict[tuple, "TickGraphs"] = field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    # the input stage of each CUDA carry that ``run_ticks`` has run, by _stage_key
    _stages: Dict[tuple, InputStage] = field(
        default_factory=dict, init=False, repr=False, compare=False
    )
    # devices on which this program has run a tick eagerly (run_warmup, or
    # TickGraphs' rehearsal before a first capture)
    _eager_on: Set[torch.device] = field(default_factory=set, init=False, repr=False, compare=False)
    # advance and checksum as calls that write into ``out`` (``writing_into``)
    _advance_into: Callable[..., Any] = field(init=False, repr=False, compare=False)
    _checksum_into: Callable[..., Any] = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        object.__setattr__(self, "_advance_into", writing_into(self.advance))
        object.__setattr__(self, "_checksum_into", writing_into(self.checksum))

    @property
    def warmup_ticks(self) -> int:
        """Ticks before rollback starts: frames 0..d inclusive (the reference
        only rolls back once current_frame > check_distance)."""
        return self.check_distance + 1

    def split_at_warmup(self, ticks_run: int, n: int) -> int:
        """How many of the next ``n`` ticks must go through the warmup program
        given ``ticks_run`` ticks already executed."""
        return min(max(0, self.warmup_ticks - ticks_run), n)

    def digest_calls(self, frame: int) -> int:
        """The ``checksum`` calls of the tick at ``frame`` (one digest launch
        each on the card): a warmup tick's two; a steady tick's one a
        contiguous span of its window's slots (one, or two where the window
        wraps the ring), and the live state's."""
        if frame < self.warmup_ticks:
            return 2
        return len(self.ring.spans(frame - self.check_distance + 1, self.check_distance)) + 1

    @property
    def tick_graphs(self) -> List["TickGraphs"]:
        """The steady tick's graphs, one ``TickGraphs`` per CUDA carry that
        ``run_steady`` has run."""
        return list(self._graphs.values())

    @property
    def input_stages(self) -> List[InputStage]:
        """The input stages, one per CUDA carry that ``run_ticks`` has run."""
        return list(self._stages.values())

    # -- carry ---------------------------------------------------------

    def init_carry(
        self,
        init_state: Any,
        input_template: Any,
        batch_size: int = 1,
        device: DeviceLike = None,
    ) -> Any:
        """Carry for ``batch_size`` sessions starting at frame 0, each with
        (a copy of) ``init_state``.  ``init_state`` and ``input_template``
        (one frame's inputs, e.g. a (P,) u8 array) are unbatched numpy arrays
        or tensors.  The ring-indexed buffers are stored slot-major (module
        docstring); the ring's slots start as the initial state with frame
        NULL_FRAME = -1, as ``DeviceStateRing.init`` makes them."""
        dev = resolve_device(device)
        b, r = batch_size, self.ring.length

        def batched(leaf: torch.Tensor) -> torch.Tensor:
            return leaf.unsqueeze(0).expand(b, *leaf.shape).clone()

        def ring_of(leaf: torch.Tensor) -> torch.Tensor:
            return _slot_major(r, leaf)

        live = tree_map(batched, from_numpy(init_state, dev))
        digests = torch.zeros((b, CHECKSUM_LANES), dtype=torch.int32, device=dev)
        return {
            "ring": {
                "states": tree_map(ring_of, live),
                "checksums": ring_of(digests),
                "frames": ring_of(torch.full((b,), -1, dtype=torch.int32, device=dev)),
            },
            "inputs": tree_map(lambda leaf: ring_of(leaf.new_zeros((b, *leaf.shape))),
                               from_numpy(input_template, dev)),
            "hist": ring_of(digests),
            "live": live,
            "frame": torch.zeros((b,), dtype=torch.int32, device=dev),
            "mismatches": torch.zeros((b,), dtype=torch.int32, device=dev),
            "first_bad": torch.full((b,), I32_MAX, dtype=torch.int32, device=dev),
        }

    # -- ticks ---------------------------------------------------------

    def _store_input(self, carry: Any, frame: int, inp: Any) -> None:
        """``inp`` (leaves ``(B, ...)``) into the input ring's slot of
        ``frame``, one copy a leaf: from a pinned row an asynchronous
        host-to-device copy."""
        i = self.ring.slot(frame)
        tree_map(lambda buf, leaf: buf[:, i].copy_(leaf, non_blocking=True), carry["inputs"], inp)

    def warmup_body(self, carry: Any, frame: int) -> None:
        """[Save, Advance] -- the pre-rollback request pattern, reading the
        frame's input from its slot."""
        ring, hist = self.ring, carry["hist"]
        live = carry["live"]
        cs = self.checksum(live)
        ring.save(carry["ring"], frame, live, cs, stamp=carry["frame"])
        hist[:, ring.slot(frame)] = cs
        new_live = self.advance(live, _tick_slice(carry["inputs"], ring.slot(frame)))
        # first-seen digest for frame+1 comes from this live advance; later
        # resimulations of that frame are compared against it
        hist[:, ring.slot(frame + 1)] = self.checksum(new_live)
        tree_copy_(live, new_live)
        carry["frame"].add_(1)

    def steady_tick(self, carry: Any, inp: Any, frame: int) -> None:
        """[Load, (Save, Advance) x d resim, Save, Advance] -- 2d+2 requests:
        the tick's input into the input ring, then ``steady_body``.  On a
        CUDA carry ``run_steady`` replays the body's graph instead; this is
        its plain version."""
        self._store_input(carry, frame, inp)
        self.steady_body(carry, frame)

    def steady_body(self, carry: Any, frame: int) -> None:
        """The steady tick after its input is stored, reading that input
        from the input ring.  ``frame`` picks the ring slots, and only
        through ``frame % R``; every frame number written comes from
        ``carry["frame"]`` (``frame`` on entry, one more on exit).  So the
        body captured as a CUDA graph at one frame is the body at every
        frame of its phase.

        Frame F - d is loaded from its slot and frames F - d + 1 .. F are
        resimulated each into its own slot, reading each frame's input in
        its slot; the window is digested and compared span by span where it
        lies, its frame numbers stamped; the live advance writes
        ``carry["live"]`` and its digest goes into ``hist``'s slot F + 1.
        Each stretch of one layer's work opens with ``layer`` (advance,
        digest, ring, compare, advance, digest, ring; seven a tick): a span
        when run eagerly, a mark kernel inside the tick's graphs."""
        ring, d = self.ring, self.check_distance
        saved, inputs, hist = carry["ring"], carry["inputs"], carry["hist"]
        spans = ring.spans(frame - d + 1, d)  # the window F-d+1 .. F
        with layer("advance"):
            st = ring.load(saved, frame - d)
            for f in range(frame - d, frame):
                st = self._advance_into(st, _tick_slice(inputs, ring.slot(f)),
                                        out=ring.load(saved, f + 1))
        with layer("digest"):
            for rs, _ in spans:
                self._checksum_into(tree_map(lambda buf: _rows(buf, rs), saved["states"]),
                                    out=_rows(saved["checksums"], rs))
        with layer("ring"):
            back = torch.arange(1 - d, 1, dtype=torch.int32, device=carry["frame"].device)
            for rs, ws in spans:
                torch.add(carry["frame"], back[ws].unsqueeze(1), out=_slots(saved["frames"], rs))
        with layer("compare"):
            # every window frame has a first-seen digest (frame F's was recorded
            # by the previous tick's live advance), so the whole window is checked
            for rs, _ in spans:
                bad = (_slots(saved["checksums"], rs) != _slots(hist, rs)).any(dim=2)  # (k, B)
                carry["mismatches"].add_(bad.sum(dim=0, dtype=torch.int32))
                worst = torch.where(bad, _slots(saved["frames"], rs), I32_MAX).amin(dim=0)
                torch.minimum(carry["first_bad"], worst, out=carry["first_bad"])
        with layer("advance"):
            # st is the resimulated state at F, in its slot
            self._advance_into(st, _tick_slice(inputs, ring.slot(frame)), out=carry["live"])
        with layer("digest"):
            self._checksum_into(carry["live"], out=hist[:, ring.slot(frame + 1)])
        with layer("ring"):
            carry["frame"].add_(1)

    def _run(self, body: Callable, carry: Any, tick_inputs: Any, start_frame: int,
             stored: int) -> Any:
        """Over the ticks axis (axis 1) of ``tick_inputs``, leaves ``(B, n,
        ...)``: tick ``t`` stores its input in the slot of frame ``start_frame
        + t`` (the first ``stored`` ticks' are there already), then runs
        ``body(carry, frame)``."""
        n = tree_leaves(tick_inputs)[0].shape[1]
        for t in range(n):
            if t >= stored:
                self._store_input(carry, start_frame + t, _tick_slice(tick_inputs, t))
            body(carry, start_frame + t)
        return carry

    def run_warmup(self, carry: Any, tick_inputs: Any, start_frame: int, stored: int = 0) -> Any:
        with trace_span("ggrs:tick.warmup"):
            self._eager_on.add(carry["frame"].device)
            return self._run(self.warmup_body, carry, tick_inputs, start_frame, stored)

    def run_steady(self, carry: Any, tick_inputs: Any, start_frame: int, stored: int = 0) -> Any:
        """The steady ticks, per tick one input copy, then an eager
        ``steady_body`` on a CPU carry, or on a CUDA carry one replay of
        the phase's graph (``TickGraphs``)."""
        with trace_span("ggrs:tick.replay"):
            if carry["frame"].device.type != "cuda":
                return self._run(self.steady_body, carry, tick_inputs, start_frame, stored)
            key = _carry_key(carry)
            graphs = self._graphs.get(key)
            if graphs is None:
                graphs = self._graphs[key] = TickGraphs(self, carry)
            return self._run(graphs.run, carry, tick_inputs, start_frame, stored)

    def run_ticks(self, carry: Any, inputs: Any, start_frame: int) -> int:
        """One call of a SyncTest entry on ``carry``, from frame
        ``start_frame``: ``inputs`` (leaves ``(B, n, ...)``: numpy arrays or
        tensors) uploaded in ``ggrs:tick.upload``, then the ticks before
        ``warmup_ticks`` through ``run_warmup`` and the rest through
        ``run_steady``.  Returns n.

        The upload, on a CUDA carry: host leaves copied once into the
        carry's ``InputStage``, whose row of each tick is sent straight into
        the tick's input ring slot just before the tick runs, the first
        tick's inside the upload; CUDA tensor leaves copied there device
        to device.  On a CPU carry the leaves are converted as
        ``from_numpy`` converts them.  ``ggrs_tick_upload_total`` counts the
        ticks by route."""
        n = tree_leaves(inputs)[0].shape[1]
        if n == 0:
            return 0
        dev = carry["frame"].device
        stage = None
        with trace_span("ggrs:tick.upload"):
            if dev.type != "cuda":
                route, rows = "host", from_numpy(inputs, dev)
            else:
                on_card = all(isinstance(x, torch.Tensor) and x.is_cuda
                              for x in tree_leaves(inputs))
                if on_card:
                    route, rows = "device", inputs
                else:
                    key = _stage_key(carry)
                    stage = self._stages.get(key)
                    if stage is None:
                        stage = self._stages[key] = InputStage(dev)
                    route, rows = "staged", stage.put(inputs)
            _UPLOADED[route].inc(n)
            self._store_input(carry, start_frame, _tick_slice(rows, 0))
        try:
            n_warm = self.split_at_warmup(start_frame, n)
            if n_warm:
                self.run_warmup(carry, tree_map(lambda a: a[:, :n_warm], rows), start_frame,
                                stored=1)
            if n > n_warm:
                self.run_steady(carry, tree_map(lambda a: a[:, n_warm:], rows),
                                start_frame + n_warm, stored=int(n_warm == 0))
        finally:
            if stage is not None:
                stage.sent()
        return n


class TickGraphs:
    """The steady tick of one CUDA carry as CUDA graphs, one per phase
    ``frame % R``, each captured the first time its phase comes up.

    ``run`` replays the graph of the tick's phase of ``steady_body``, which
    reads the tick's input in its input ring slot (stored there by the one
    copy before the replay, ``ReplayPrograms._run``).  A graph writes only
    into the carry, and nothing its capture allocates outlives the capture,
    so the R graphs share one private memory pool (the first capture's): they
    replay one at a time, on the caller's stream, in any order.  They stay
    valid while the carry's tensors do; ``load_checkpoint`` copies into
    them in place.  Each replay adds its graph's digest launches to the
    counters (``kernels.GraphLaunches``).

    A capture runs nothing, so whatever a tick does once lazily (the games'
    device constants, the digest library's first launch) must have run
    before it: the program's warmup ticks did, or, where the carry came
    from a checkpoint in a program that ran none on this device, an eager
    ``steady_body`` on a scratch copy of the carry does before the first
    capture (its digest launches ran and count).

    The set takes layer marks: each graph holds ``steady_body``'s seven
    mark kernels, disabled while no profiler runs (``ops/graphs.py``)."""

    def __init__(self, programs: ReplayPrograms, carry: Any) -> None:
        self.programs = programs
        self.device = carry["frame"].device
        self.set = GraphSet(self.device, "replay", marks=True)
        self.graphs: Dict[int, Graph] = {}

    @property
    def captures(self) -> int:
        return self.set.captures

    @property
    def replays(self) -> int:
        return self.set.replays

    @property
    def pool(self):
        return self.set.pool

    def run(self, carry: Any, frame: int) -> None:
        phase = self.programs.ring.slot(frame)
        graph = self.graphs.get(phase)
        if graph is None:
            graph = self.graphs[phase] = self._capture(carry, frame)
        graph.replay()

    def _capture(self, carry: Any, frame: int) -> Graph:
        programs = self.programs
        if self.device not in programs._eager_on:
            programs.steady_body(tree_map(torch.clone, carry), frame)
            programs._eager_on.add(self.device)
        return self.set.capture(lambda: programs.steady_body(carry, frame))


def _advance_window(advance: AdvanceFn, st: Any, inputs: Any) -> Any:
    """``advance`` over the leading axis of ``inputs``, each frame on the
    previous frame's output; ``st`` leaves are ``(1, ...)``."""
    for k in range(tree_leaves(inputs)[0].shape[0]):
        st = advance(st, tree_map(lambda leaf: leaf[k:k + 1], inputs))
    return st


def _layout(tree: Any) -> str:
    return repr(tree_map(lambda leaf: (tuple(leaf.shape), leaf.dtype), tree))


class ScrubProgram:
    """The confirmed-only playback program: advance N frames with state and
    inputs resident on the device -- the fast-forward mode of journal replay
    (``sessions.replay.ReplaySession``).

    Replaying a journal never rolls back (every input is confirmed), so the
    tick above collapses to a bare run of advances: no ring, no digest
    history, no resimulation.  ``scrub(state, stacked_inputs) -> state``
    takes one unbatched state and the window's per-frame inputs stacked on
    the leading axis.  The window is uploaded once and nothing is read
    back.  The argument state is never written (the JAX package donates it
    on a TPU only).

    On a CUDA device a window is one CUDA graph replay: a graph per window
    length (and state layout), captured at its first call over static state
    and input buffers, which each call fills with one copy per leaf.  The
    caller gets a copy of the result, never the graph's own output, which
    the next replay overwrites.  The graphs of one program share a private
    memory pool.  ``eager`` is the plain version, each advance issued from
    Python on ``(1, ...)`` views, and what the CPU runs.  ``captures`` and
    ``replays`` count the graphs and their replays."""

    def __init__(self, advance: AdvanceFn, device: torch.device) -> None:
        self.advance = advance
        self.device = device
        self.set = GraphSet(device, "scrub")
        self._graphs: Dict[Tuple[str, str], Tuple[Graph, Any, Any, Any]] = {}

    @property
    def captures(self) -> int:
        return self.set.captures

    @property
    def replays(self) -> int:
        return self.set.replays

    def _batched(self, state: Any, stacked_inputs: Any) -> Tuple[Any, Any]:
        st = tree_map(lambda leaf: leaf.unsqueeze(0), from_numpy(state, self.device))
        return st, from_numpy(stacked_inputs, self.device)

    def eager(self, state: Any, stacked_inputs: Any) -> Any:
        st, inputs = self._batched(state, stacked_inputs)
        with trace_span("ggrs:scrub"):
            st = _advance_window(self.advance, st, inputs)
        return tree_map(lambda leaf: leaf[0], st)

    def __call__(self, state: Any, stacked_inputs: Any) -> Any:
        if self.device.type != "cuda":
            return self.eager(state, stacked_inputs)
        st, inputs = self._batched(state, stacked_inputs)
        with trace_span("ggrs:scrub"):
            key = (_layout(st), _layout(inputs))
            if key not in self._graphs:
                self._graphs[key] = self._capture(st, inputs)
            graph, static_st, static_inputs, out = self._graphs[key]
            tree_copy_(static_st, st)
            tree_copy_(static_inputs, inputs)
            graph.replay()
            return tree_map(lambda leaf: leaf[0].clone(), out)

    def _capture(self, st: Any, inputs: Any) -> Tuple[Graph, Any, Any, Any]:
        static_st = tree_map(torch.empty_like, st)
        static_inputs = tree_map(torch.empty_like, inputs)
        # one eager advance first: the game's lazy device constants are
        # made outside the capture
        self.advance(st, tree_map(lambda leaf: leaf[:1], inputs))
        out = []
        graph = self.set.capture(
            lambda: out.append(_advance_window(self.advance, static_st, static_inputs)))
        return graph, static_st, static_inputs, out[0]


def build_scrub_program(advance: AdvanceFn, device: DeviceLike = None) -> ScrubProgram:
    """The scrub program (``ScrubProgram``) of a batch-native ``advance``
    on ``device`` (the card by default)."""
    return ScrubProgram(advance, resolve_device(device))


def build_replay_programs(
    advance: AdvanceFn,
    ring_length: int,
    check_distance: int,
    checksum: ChecksumFn = checksum_device,
) -> ReplayPrograms:
    """Tick programs for a batch-native ``advance``.  ``ring_length`` must
    exceed ``check_distance`` so the rollback target is still in the ring,
    mirroring ``max_prediction + 1`` cells in the reference."""
    if check_distance < 1:
        raise ValueError("device replay needs check_distance >= 1")
    if ring_length <= check_distance:
        raise ValueError("ring must cover the rollback window")
    return ReplayPrograms(
        ring=DeviceStateRing(ring_length),
        check_distance=check_distance,
        advance=advance,
        checksum=checksum,
    )
