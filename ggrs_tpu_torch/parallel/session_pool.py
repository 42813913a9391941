"""Massed P2P hosting: fulfil MANY live sessions' request lists in one
batched tick on the card.

The port of ``ggrs_tpu/parallel/session_pool.py``'s device half.  The
reference binds one rollback session to one process (GGRS
src/sessions/p2p_session.rs:254-265); ``ops.DeviceRequestExecutor`` moves a
session's save / load / advance onto the card, but N executors still cost N
times its kernels per tick, each launched by the host.  Here B independent
host sessions (P2P, SyncTest, Spectator: anything that emits the reference's
request grammar) hand their per-tick request lists to one
``BatchedRequestExecutor``, which runs them as batched operations over
``[B, ...]`` state.

Every session's tick is normalized to one fixed-shape descriptor --

    [pre-save*] [load [post-load-save]*] (advance, save?) * <= max_burst

-- with per-session masks, so heterogeneous ticks (one session rolling back
8 frames, another advancing once, a third skipping on the prediction
threshold) are one masked batch, not B programs.  The tick runs

1. the pre-save of the live states;
2. ``where(do_load, load, live)``;
3. the post-load save;
4. up to ``max_burst`` steps of ``where(j < n_adv, advance, st)``, each
   followed by its masked save.

The descriptor is built on the host, so the tick loops only to the largest
``n_adv`` of this tick and skips a masked write (and its digest) that no row
takes: the same result, fewer kernels.  Each write that some row takes is
one ``checksum_device`` launch over the B rows and one scatter per ring
buffer; the descriptor goes to the card in one copy from pinned memory.

Saved states live in per-session rings ``[B, R, ...]`` tagged with frame
numbers and 4-lane digests; ``GameStateCell``s are fulfilled with lazy slot
references and lazy checksums, so desync detection and ``cell.load()`` work
unchanged while ``run`` reads nothing back from the card.

Not ported yet: the ``mesh=`` argument (sharding the pool over several
cards, queue A item 4 of the roadmap), and the descriptor plane's
``raw_inputs_to_array``, ``_run_plan``, ``_fill_resim``, ``_fulfill_fast``
and ``HostedPool``, which consume the host bank's ``RequestPlan`` (queue A
item 6).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import from_numpy, to_numpy
from ..core.device import DeviceLike, resolve_device
from ..core.types import AdvanceFrame, Frame, GgrsRequest, LoadGameState, SaveGameState
from ..obs.registry import default_registry
from ..obs.trace import NULL_TRACER
from ..ops.checksum import CHECKSUM_LANES, checksum_device, checksum_to_u128
from ..ops.ring import DeviceStateRing
from ..utils.tree import tree_map

# device-tick accounting for the pooled executor: process-wide counters,
# observational only
_OBS_DISPATCHES = default_registry().counter(
    "ggrs_executor_dispatches_total",
    "pooled ticks run on the device",
)
_OBS_EMPTY_TICKS = default_registry().counter(
    "ggrs_executor_empty_ticks_total",
    "run() calls where every session's request list was empty (no device work)",
)
_OBS_ROLLBACK_LOADS = default_registry().counter(
    "ggrs_executor_rollback_loads_total",
    "sessions that carried a LoadGameState (rollback) into a pooled tick",
)
_OBS_BURST_DEPTH = default_registry().histogram(
    "ggrs_executor_burst_depth_frames",
    "deepest per-session advance burst (replay depth) per pooled tick",
    buckets=(1, 2, 4, 8, 16, 32),
)


def _tree_where(pred: torch.Tensor, a: Any, b: Any) -> Any:
    """Per row: ``a`` where ``pred`` (``(B,)``), else ``b``."""
    return tree_map(
        lambda x, y: torch.where(pred.view(-1, *([1] * (x.dim() - 1))), x, y), a, b
    )


class _BatchSlotRef:
    """What a fulfilled SaveGameState cell holds: a reference into the pool's
    ring.  ``materialize`` fetches the state to the host through the owning
    executor (diagnostics only; the live path never calls it)."""

    __slots__ = ("owner", "index", "frame")

    def __init__(self, owner: "BatchedRequestExecutor", index: int, frame: Frame):
        self.owner = owner
        self.index = index
        self.frame = frame

    def materialize(self) -> Any:
        return self.owner.ring_state(self.index, self.frame)

    def __repr__(self) -> str:  # pragma: no cover
        return f"_BatchSlotRef(session={self.index}, frame={self.frame})"


class _LazyBatchChecksum:
    """Lazy u128 checksum backed by the pool's digest ring; satisfies
    ``GameStateCell.save``'s ``materialize()`` protocol, so the desync
    exchange reads the card only for frames it reports."""

    __slots__ = ("_owner", "_index", "_frame", "_value")

    def __init__(self, owner: "BatchedRequestExecutor", index: int, frame: Frame):
        self._owner = owner
        self._index = index
        self._frame = frame
        self._value: Optional[int] = None

    def materialize(self) -> int:
        if self._value is None:
            self._value = self._owner.ring_checksum(self._index, self._frame)
        return self._value


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    """The tensor dtype ``convert.from_numpy`` gives a numpy dtype (u32 as
    int32 bit patterns)."""
    dt = np.dtype(np.int32) if dt == np.uint32 else dt
    return torch.from_numpy(np.zeros(1, dt)).dtype


class _Upload:
    """Numpy sections packed into one byte buffer, each at an 8-byte
    boundary, sent to the device in one copy and read back there as typed
    views."""

    def __init__(self) -> None:
        self._parts: List[Tuple[int, np.ndarray]] = []
        self._size = 0

    def add(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        at = self._size
        self._parts.append((at, arr))
        self._size = at + (arr.nbytes + 7) // 8 * 8
        return len(self._parts) - 1

    def send(self, device: torch.device) -> List[torch.Tensor]:
        buf = np.zeros(max(self._size, 8), np.uint8)
        for at, arr in self._parts:
            buf[at:at + arr.nbytes] = arr.reshape(-1).view(np.uint8)
        dev = from_numpy(buf, device)
        out = []
        for at, arr in self._parts:
            t = dev[at:at + arr.nbytes].view(_torch_dtype(arr.dtype))
            out.append(t.reshape(arr.shape))
        return out


class BatchedRequestExecutor:
    """Fulfils B sessions' GgrsRequest lists as one batched tick.

    ``advance``         batch-native ``(states (B, ...), inputs (B, ...)) ->
                        states``, pure (it writes neither argument).
    ``init_state``      one session's initial state (numpy arrays or tensors).
    ``inputs_to_array`` maps a request's ``[(input, status), ...]`` to the
                        numpy array ``advance`` takes for one session -- the
                        contract of ``ops.DeviceRequestExecutor``.
    ``batch_size``      B, the number of pooled sessions (index 0..B-1).
    ``ring_length``     saved-state slots per session; must exceed the
                        sessions' ``max_prediction`` (the reference keeps
                        ``max_prediction + 1`` cells, sync_layer.rs:144-166).
    ``max_burst``       most advances one tick can carry (rollback resims +
                        the live advance): ``max_prediction + 1`` for the
                        stock P2P session.
    ``device``          the card by default (``None``); ``"cpu"`` runs on
                        the CPU.
    """

    def __init__(
        self,
        advance: Callable[[Any, Any], Any],
        init_state: Any,
        inputs_to_array: Callable[[Sequence[Tuple[Any, Any]]], np.ndarray],
        batch_size: int,
        ring_length: int,
        max_burst: int,
        with_checksums: bool = True,
        device: DeviceLike = None,
    ) -> None:
        assert batch_size >= 1 and ring_length >= 2 and max_burst >= 1
        self.batch_size = batch_size
        self.ring_length = ring_length
        self.max_burst = max_burst
        self.device = resolve_device(device)
        self._advance = advance
        self._inputs_to_array = inputs_to_array
        self._with_checksums = with_checksums

        B, R = batch_size, ring_length
        state0 = from_numpy(init_state, self.device)
        live = tree_map(lambda l: l.unsqueeze(0).expand(B, *l.shape).clone(), state0)
        self._ring = DeviceStateRing(R)
        # one DeviceStateRing (states / checksums / frames) per session,
        # stacked on the leading B axis and written in place; its frame tags
        # back the host-side accessors
        self._carry: Dict[str, Any] = {"live": live, "ring": self._ring.init(live)}
        self._zero_cs = torch.zeros((B, CHECKSUM_LANES), dtype=torch.int32, device=self.device)
        self._input_dtype: Optional[np.dtype] = None
        self._input_shape: Optional[Tuple[int, ...]] = None
        # tracing: device dispatch and fence spans; assign a live Tracer to
        # light them up
        self.tracer = NULL_TRACER
        # set on a failed run(): once a tick aborts mid-parse, fulfilled
        # cells reference slots that were never written -- every later use
        # must fail loudly instead of serving stale state
        self._invalid: Optional[str] = None
        # host shadow of the ring frame tags: loud failure at _parse time if
        # a session rolls back past ring_length (device aliasing is silent)
        self._host_frames = np.full((B, R), -1, np.int64)

    # ------------------------------------------------------------------
    # request-list parsing (host, numpy only)
    # ------------------------------------------------------------------

    def _parse(
        self, index: int, requests: List[GgrsRequest], desc: Dict[str, np.ndarray]
    ) -> None:
        """Normalize one session's tick into the descriptor row ``index``,
        fulfilling its Save cells with lazy slot references.

        Fulfillment is eager (cell + ``_host_frames`` updated during parse)
        because the ring-capacity guard below must see this tick's pre-saves
        in device order -- the tick writes pre-saves before the load, so a
        pre-save that aliases the load's slot means the gather returns the
        pre-saved frame, and only the updated shadow catches that.  The flip
        side -- a parse failure partway through ``run()`` leaves earlier
        sessions' cells pointing at slots the aborted tick never wrote -- is
        handled by invalidating the whole pool (see ``run``)."""
        i = 0
        n = len(requests)
        b = index

        def fulfill_save(req: SaveGameState) -> None:
            self._host_frames[b, req.frame % self.ring_length] = req.frame
            req.cell.save(
                req.frame,
                _BatchSlotRef(self, b, req.frame),
                _LazyBatchChecksum(self, b, req.frame) if self._with_checksums else None,
            )

        # optional pre-save(s) of the live state (the frame-0 tick emits the
        # initial save AND the per-frame save, both of frame 0 -- reference:
        # p2p_session.rs:307-310); all must label the same frame, since no
        # advance runs between them
        while i < n and isinstance(requests[i], SaveGameState):
            if desc["pre_save"][b] and desc["pre_frame"][b] != requests[i].frame:
                raise ValueError(
                    f"session {b}: consecutive pre-saves of different frames "
                    f"({desc['pre_frame'][b]} then {requests[i].frame})"
                )
            desc["pre_save"][b] = True
            desc["pre_frame"][b] = requests[i].frame
            fulfill_save(requests[i])
            i += 1

        if i < n and isinstance(requests[i], LoadGameState):
            req = requests[i]
            data = req.cell.data()
            # real exceptions, not asserts: these guards are the only thing
            # between an undersized ring and a silent desync, and
            # ``python -O`` strips asserts
            if not (
                isinstance(data, _BatchSlotRef)
                and data.owner is self
                and data.index == b
                and data.frame == req.frame
            ):
                raise ValueError(
                    f"session {b} loads frame {req.frame} from a cell this "
                    f"pool did not save ({data!r})"
                )
            # ring-capacity guard: the gather cannot tell an aliased slot
            # from the right one, so check the host shadow of the frame tags
            held = self._host_frames[b, req.frame % self.ring_length]
            if held != req.frame:
                raise RuntimeError(
                    f"session {b}: rollback to frame {req.frame} but its ring "
                    f"slot holds frame {held} -- ring_length={self.ring_length} "
                    f"is too small for this session's prediction window"
                )
            desc["do_load"][b] = True
            desc["load_frame"][b] = req.frame
            i += 1
            # sparse saving: save of the just-loaded state before any advance
            while i < n and isinstance(requests[i], SaveGameState):
                if desc["postload_save"][b] and desc["postload_frame"][b] != requests[i].frame:
                    raise ValueError(
                        f"session {b}: consecutive post-load saves of "
                        f"different frames ({desc['postload_frame'][b]} then "
                        f"{requests[i].frame})"
                    )
                desc["postload_save"][b] = True
                desc["postload_frame"][b] = requests[i].frame
                fulfill_save(requests[i])
                i += 1

        j = 0
        while i < n and isinstance(requests[i], AdvanceFrame):
            if j >= self.max_burst:
                raise ValueError(
                    f"session {b}: tick carries more than max_burst="
                    f"{self.max_burst} advances"
                )
            desc["inputs"][b, j] = np.asarray(self._inputs_to_array(requests[i].inputs))
            i += 1
            if i < n and isinstance(requests[i], SaveGameState):
                desc["save_mask"][b, j] = True
                desc["save_frame"][b, j] = requests[i].frame
                fulfill_save(requests[i])
                i += 1
            j += 1
        desc["n_adv"][b] = j
        if i != n:
            raise ValueError(
                f"session {b}: unsupported request shape at position {i}: {requests[i]!r}"
            )

    def _blank_desc(self) -> Dict[str, np.ndarray]:
        B, D = self.batch_size, self.max_burst
        if self._input_shape is None:
            raise RuntimeError("call warmup(example_inputs) before the first run()")
        return {
            "pre_save": np.zeros((B,), bool),
            "pre_frame": np.zeros((B,), np.int32),
            "do_load": np.zeros((B,), bool),
            "load_frame": np.zeros((B,), np.int32),
            "postload_save": np.zeros((B,), bool),
            "postload_frame": np.zeros((B,), np.int32),
            "n_adv": np.zeros((B,), np.int32),
            "inputs": np.zeros((B, D) + self._input_shape, self._input_dtype),
            "save_mask": np.zeros((B, D), bool),
            "save_frame": np.zeros((B, D), np.int32),
        }

    # ------------------------------------------------------------------
    # the tick
    # ------------------------------------------------------------------

    def _plan_write(self, up: _Upload, pred: np.ndarray, frames: np.ndarray):
        """Host: the upload sections of one masked write, or None when no
        row takes it."""
        rows = np.flatnonzero(pred)
        if not rows.size:
            return None
        every = rows.size == self.batch_size
        return (
            up.add(self._ring.flat_index(rows, frames[rows])),
            up.add(frames[rows].astype(np.int32)),
            None if every else up.add(rows.astype(np.int64)),
        )

    def _tick(self, desc: Dict[str, np.ndarray]) -> None:
        """Run one descriptor on the device, masked over all B sessions."""
        B = self.batch_size
        n_max = int(desc["n_adv"].max())
        up = _Upload()
        pre = self._plan_write(up, desc["pre_save"], desc["pre_frame"])
        load = None
        if desc["do_load"].any():
            load = (up.add(self._ring.flat_index(np.arange(B), desc["load_frame"])),
                    None if desc["do_load"].all() else up.add(desc["do_load"]))
        post = self._plan_write(up, desc["postload_save"], desc["postload_frame"])
        steps = []
        if n_max:
            inputs = up.add(np.moveaxis(desc["inputs"][:, :n_max], 1, 0))
            for j in range(n_max):
                act = j < desc["n_adv"]
                save = self._plan_write(up, act & desc["save_mask"][:, j], desc["save_frame"][:, j])
                steps.append((None if act.all() else up.add(act), save))
        dev = up.send(self.device)

        ring = self._carry["ring"]

        def write(st: Any, plan) -> None:
            index, frames, rows = (None if k is None else dev[k] for k in plan)
            cs = checksum_device(st) if self._with_checksums else self._zero_cs
            self._ring.save_rows(ring, index, st, cs, frames, rows)

        live = self._carry["live"]
        if pre is not None:
            write(live, pre)
        st = live
        if load is not None:
            loaded = self._ring.load_rows(ring, dev[load[0]])
            st = loaded if load[1] is None else _tree_where(dev[load[1]], loaded, live)
        if post is not None:
            write(st, post)
        for j, (act, save) in enumerate(steps):
            nxt = self._advance(st, dev[inputs][j])
            st = nxt if act is None else _tree_where(dev[act], nxt, st)
            if save is not None:
                write(st, save)
        self._carry["live"] = st

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def warmup(self, example_inputs: Any) -> None:
        """Record the per-frame input array's shape and dtype, and run the
        tick's device work once without touching the pool's state (a B-row
        digest, advance and gather), then wait for the card: this builds the
        digest kernel and fills the allocators before a live loop."""
        arr = np.asarray(example_inputs)
        self._input_dtype = arr.dtype
        self._input_shape = arr.shape
        live, ring = self._carry["live"], self._carry["ring"]
        B = self.batch_size
        checksum_device(live)
        inputs = from_numpy(np.broadcast_to(arr, (B,) + arr.shape).copy(), self.device)
        self._advance(live, inputs)
        index = from_numpy(self._ring.flat_index(np.arange(B), np.zeros(B, np.int64)), self.device)
        self._ring.load_rows(ring, index)
        self.block_until_ready()

    def run(self, request_lists: Sequence[List[GgrsRequest]]) -> None:
        """Fulfil all B sessions' request lists as one tick (no device work
        when every list is empty).  ``request_lists[b]`` belongs to session
        ``b``; sessions with nothing to do this tick pass ``[]``."""
        self._check_valid()
        if len(request_lists) != self.batch_size:
            raise ValueError(
                f"run() got {len(request_lists)} request lists for a pool of "
                f"{self.batch_size} sessions"
            )
        if all(not reqs for reqs in request_lists):
            _OBS_EMPTY_TICKS.inc()
            return
        desc = self._blank_desc()
        # parse fulfils cells eagerly (the ring-capacity guard needs this
        # tick's pre-saves visible in device order -- see _parse); if any
        # session's list fails to parse, or the tick itself fails, earlier
        # sessions already hold cells referencing slots this aborted tick
        # never wrote, so the pool is unusable: poison it loudly rather than
        # let a caller that caught the error keep running on stale loads
        try:
            with self.tracer.span("device.dispatch"):
                for b, reqs in enumerate(request_lists):
                    if reqs:
                        self._parse(b, reqs, desc)
                _OBS_DISPATCHES.inc()
                _OBS_ROLLBACK_LOADS.inc(int(desc["do_load"].sum()))
                _OBS_BURST_DEPTH.observe(int(desc["n_adv"].max()))
                self._tick(desc)
        except BaseException as e:  # incl. KeyboardInterrupt mid-parse
            self._invalid = f"{type(e).__name__}: {e}"
            raise

    # ------------------------------------------------------------------
    # accessors (device reads -- diagnostics / desync exchange, not hot path)
    # ------------------------------------------------------------------

    @property
    def live_states(self) -> Any:
        """The ``(B, ...)`` live state tensors (no transfer)."""
        self._check_valid()
        return self._carry["live"]

    def live_state(self, index: int) -> Any:
        """One session's live state, fetched to the host as numpy arrays."""
        self._check_valid()
        return to_numpy(tree_map(lambda l: l[index], self._carry["live"]))

    def _check_valid(self) -> None:
        if self._invalid is not None:
            raise RuntimeError(
                f"pool was invalidated by an earlier failed tick "
                f"({self._invalid}); rebuild it -- its rings and fulfilled "
                f"cells are out of sync"
            )

    def _slot_probe(self, index: int, frame: Frame) -> Tuple[int, np.ndarray]:
        """(slot, checksum lanes as uint32), with the slot's frame tag and
        lanes read in one transfer."""
        self._check_valid()
        slot = frame % self.ring_length
        ring = self._carry["ring"]
        vals = torch.cat([ring["frames"][index, slot].reshape(1),
                          ring["checksums"][index, slot]]).cpu().numpy()
        held = int(vals[0])
        if held != frame:
            raise RuntimeError(
                f"session {index}: ring slot {slot} holds frame {held}, "
                f"wanted {frame} (rolled past ring_length={self.ring_length}?)"
            )
        return slot, vals[1:].view(np.uint32)

    def ring_state(self, index: int, frame: Frame) -> Any:
        """A saved state, fetched to the host (validates the slot still
        holds ``frame``).  Diagnostics path."""
        slot, _ = self._slot_probe(index, frame)
        return to_numpy(tree_map(lambda buf: buf[index, slot], self._carry["ring"]["states"]))

    def ring_checksum(self, index: int, frame: Frame) -> int:
        """A saved frame's u128 checksum (validates the slot)."""
        assert self._with_checksums, "pool was built with with_checksums=False"
        _, lanes = self._slot_probe(index, frame)
        return checksum_to_u128(lanes)

    def block_until_ready(self) -> None:
        with self.tracer.span("device.fence"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
