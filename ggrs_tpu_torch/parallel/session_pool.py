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

The JAX package jits that tick.  The port's counterpart on the card is a
CUDA graph per shard and per set of those host decisions (``_ShardGraphs``):
a tick packs its descriptor in one fixed layout, copies it in one copy into
the shard's static descriptor buffer and replays one graph, which updates
the ring and the live state in place and launches the same digests as the
eager tick.  The eager ``_tick_shard`` is the graphs' plain version and
what the CPU runs; routing is by the shard's device.

Saved states live in per-session rings ``[B, R, ...]`` tagged with frame
numbers and 4-lane digests; ``GameStateCell``s are fulfilled with lazy slot
references and lazy checksums, so desync detection and ``cell.load()`` work
unchanged while ``run`` reads nothing back from the card.

With ``mesh=`` the session axis is sharded over the mesh's devices, as
``BatchedSessions`` shards it: each shard's rows, rings and live states live
on its own device, and the masked tick runs per shard on that shard's slice
of the descriptor.  Sessions are independent, so the tick needs no
collectives.

The descriptor plane: given a ``host_bank.HostSessionPool`` tick's
``RequestPlan`` (and ``raw_inputs_to_array``), ``run`` fills the descriptor
from the plan's flat numpy columns (quiet rows in one gather, rollback-resim
and save-only rows per row) and builds no ``GgrsRequest`` for them; the
plan's other slots go through ``_parse``.  What it reads of the plan is
copied into the descriptor before ``run`` returns, since the plan views the
host pool's reused output buffer.  ``HostedPool`` is the whole serving tick:
one ``stage_inputs`` crossing, one ``ggrs_bank_tick`` crossing, one masked
batched tick on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import copy_into, from_numpy, to_numpy
from ..core.device import DeviceLike, resolve_device
from ..core.types import AdvanceFrame, Frame, GgrsRequest, LoadGameState, SaveGameState
from ..obs.registry import default_registry
from ..obs.trace import NULL_TRACER
from ..ops.checksum import CHECKSUM_LANES, checksum_device, checksum_to_u128
from ..ops.graphs import Graph, GraphSet, Upload, synchronize
from ..ops.ring import DeviceStateRing
from ..utils.tree import tree_map
from .batch import Mesh, _on

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


class _ShardGraphs:
    """One shard's masked tick as CUDA graphs: the counterpart of the JAX
    package's jitted (and, under a mesh, shard_mapped) ``vmap`` of
    ``session_tick``.

    A graph is keyed by the decisions the eager ``_tick_shard`` makes on
    the host each tick (``key``): the largest ``n_adv`` and which masked
    writes some row takes.  So a replay launches the same digests as the
    eager tick, and everything per row is a fixed-shape tensor of one
    descriptor, whose layout is fixed by the shard's rows and the pool's
    ``max_burst`` (``pack``): each write's ``(rows,)`` mask, flat ring
    index and frame, the load's mask and index, each step's ``act`` mask
    and the ``(max_burst, rows, ...)`` inputs.  A row a write's mask does
    not take points at its own slot and writes back its contents
    (``DeviceStateRing.save_rows_where``); ``_tree_where`` with an all-true
    mask is the plain output bit for bit.  A tick packs its descriptor on
    the host, copies it from a fresh pinned block into the static
    descriptor buffer in one copy, and replays its key's graph, which
    updates the shard's ring and live state in place (the live state is a
    static buffer: the graph copies the tick's final state into it).

    A graph is captured at its key's first tick (``warmup`` captures a
    quiet tick's and a full-window rollback's).  It is captured while the
    descriptor buffer is all zero, a descriptor that takes no row; the
    tick's own descriptor is copied in after, before the replay."""

    def __init__(self, pool: "BatchedRequestExecutor", shard: Dict[str, Any]) -> None:
        self.pool = pool
        self.shard = shard
        self.set = GraphSet(shard["device"], "pool")
        self._graphs: Dict[tuple, Graph] = {}
        blank = {k: v[:pool._rows] for k, v in pool._blank_desc().items()}
        up, _ = self.pack(blank)
        self._static = torch.zeros(up.pack().nbytes, dtype=torch.uint8, device=shard["device"])
        self._views = up.views(self._static)

    @property
    def captures(self) -> int:
        return self.set.captures

    @property
    def replays(self) -> int:
        return self.set.replays

    def pack(self, desc: Dict[str, np.ndarray]) -> Tuple[Upload, tuple]:
        """The descriptor of one shard's rows in the fixed layout, and the
        key of its graph."""
        ring = self.pool._ring
        rows = np.arange(len(desc["n_adv"]))
        n_adv = desc["n_adv"]
        act = np.arange(self.pool.max_burst)[:, None] < n_adv[None, :]  # (D, rows)
        save = act & desc["save_mask"].T
        up = Upload()
        for mask, frames in ((desc["pre_save"], desc["pre_frame"]),
                             (desc["postload_save"], desc["postload_frame"])):
            up.add(mask)
            up.add(ring.flat_index(rows, frames))
            up.add(frames)
        up.add(desc["do_load"])
        up.add(ring.flat_index(rows, desc["load_frame"]))
        up.add(act)
        up.add(save)
        up.add(ring.flat_index(rows[None, :], desc["save_frame"].T))
        up.add(np.ascontiguousarray(desc["save_frame"].T))
        up.add(np.moveaxis(desc["inputs"], 1, 0))
        n_max = int(n_adv.max())
        key = (n_max, bool(desc["pre_save"].any()), bool(desc["do_load"].any()),
               bool(desc["postload_save"].any()), tuple(save[:n_max].any(axis=1).tolist()))
        return up, key

    def _body(self, key: tuple) -> Callable[[], None]:
        n_max, pre, load, post, saves = key
        pool, shard = self.pool, self.shard
        ring, live, dring = shard["ring"], shard["live"], pool._ring
        (pre_mask, pre_index, pre_frame, post_mask, post_index, post_frame, load_mask,
         load_index, act, save_mask, save_index, save_frame, inputs) = self._views

        def write(st: Any, index, frames, mask) -> None:
            cs = checksum_device(st) if pool._with_checksums else shard["zero_cs"]
            dring.save_rows_where(ring, index, st, cs, frames, mask)

        def body() -> None:
            if pre:
                write(live, pre_index, pre_frame, pre_mask)
            st = live
            if load:
                st = _tree_where(load_mask, dring.load_rows(ring, load_index), live)
            if post:
                write(st, post_index, post_frame, post_mask)
            for j in range(n_max):
                st = _tree_where(act[j], pool._advance(st, inputs[j]), st)
                if saves[j]:
                    write(st, save_index[j], save_frame[j], save_mask[j])
            if st is not live:
                tree_map(lambda dst, src: dst.copy_(src), live, st)

        return body

    def warm(self) -> None:
        """Capture the keys every live loop meets: a quiet tick (each row
        saves its live state, then advances once) and a full-window
        rollback (beside quiet rows, a load and ``max_burst`` advances, each
        but the live last one saved)."""
        d = self.pool.max_burst
        self.capture((1, True, False, False, (False,)))
        self.capture((d, True, True, False, (True,) * (d - 1) + (False,)))

    def capture(self, key: tuple) -> Graph:
        self._static.zero_()
        graph = self._graphs[key] = self.set.capture(self._body(key))
        return graph

    def tick(self, desc: Dict[str, np.ndarray]) -> None:
        up, key = self.pack(desc)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self.capture(key)
        copy_into(self._static, torch.from_numpy(up.pack()))
        graph.replay()


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
    ``mesh``            optional ``parallel.Mesh`` of this process's devices
                        (instead of ``device``): the session axis is sharded
                        over every mesh axis, host-major (the device count
                        must divide ``batch_size``), so one pool spans cards.
                        The descriptor is built on the host and split per
                        shard.
    ``raw_inputs_to_array``  optional bulk twin of ``inputs_to_array`` for
                        the descriptor plane: called as ``raw(blobs,
                        statuses)`` with the ENCODED input bytes ``[k,
                        players, input_size]`` (u8) and status codes ``[k,
                        players]`` (u8) of k advances, it returns the ``[k,
                        ...]`` numpy array of per-session inputs.  With it, a
                        ``HostSessionPool`` RequestPlan's quiet and resim
                        slots are consumed as flat columns: zero
                        ``GgrsRequest`` objects, zero per-slot
                        ``input_decode`` calls.  Without it, plans still work
                        (per-slot materialization, the reference semantics).
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
        mesh: Optional[Mesh] = None,
        raw_inputs_to_array: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
    ) -> None:
        assert batch_size >= 1 and ring_length >= 2 and max_burst >= 1
        self.batch_size = batch_size
        self.ring_length = ring_length
        self.max_burst = max_burst
        self.mesh = mesh
        if mesh is not None:
            if device is not None:
                raise ValueError("pass device= or mesh=, not both")
            if mesh.world_size > 1:
                raise ValueError("a pool's mesh holds this process's devices only")
            assert batch_size % mesh.size == 0, (
                f"batch_size {batch_size} must divide evenly over {mesh.size} mesh devices"
            )
            devices = [dev for _, dev in mesh.local_shards()]
        else:
            devices = [resolve_device(device)]
        self.device = devices[0]
        self._advance = advance
        self._inputs_to_array = inputs_to_array
        self._raw_inputs = raw_inputs_to_array
        self._with_checksums = with_checksums
        # descriptor plane: per-(session, ring slot) pooled _BatchSlotRef /
        # _LazyBatchChecksum pairs, so the plan path's cell fulfilment
        # allocates nothing at steady state
        self._ref_rings: List[Optional[List[Any]]] = [None] * batch_size

        R = ring_length
        self._rows = batch_size // len(devices)
        self._ring = DeviceStateRing(R)
        # per shard: one DeviceStateRing (states / checksums / frames) per
        # session, stacked on the leading row axis and written in place (its
        # frame tags back the host-side accessors), the live states, and a
        # zero digest for pools without checksums
        self._shards: List[Dict[str, Any]] = []
        for k, dev in enumerate(devices):
            with _on(dev):
                state0 = from_numpy(init_state, dev)
                live = tree_map(lambda l: l.unsqueeze(0).expand(self._rows, *l.shape).clone(), state0)
                self._shards.append({
                    "lo": k * self._rows, "device": dev, "live": live,
                    "ring": self._ring.init(live), "graphs": None,
                    "zero_cs": torch.zeros((self._rows, CHECKSUM_LANES), dtype=torch.int32,
                                           device=dev),
                })
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
        self._host_frames = np.full((batch_size, R), -1, np.int64)

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

    def _plan_write(self, up: Upload, pred: np.ndarray, frames: np.ndarray):
        """Host: the upload sections of one masked write, or None when no
        row takes it."""
        rows = np.flatnonzero(pred)
        if not rows.size:
            return None
        every = rows.size == pred.size
        return (
            up.add(self._ring.flat_index(rows, frames[rows])),
            up.add(frames[rows].astype(np.int32)),
            None if every else up.add(rows.astype(np.int64)),
        )

    def _tick(self, desc: Dict[str, np.ndarray]) -> None:
        """Run one descriptor on the device, masked over all B sessions:
        each shard runs its slice of the descriptor on its own device."""
        for shard in self._shards:
            lo, hi = shard["lo"], shard["lo"] + self._rows
            with _on(shard["device"]):
                self._run_shard(shard, {k: v[lo:hi] for k, v in desc.items()})

    def _run_shard(self, shard: Dict[str, Any], desc: Dict[str, np.ndarray]) -> None:
        """One shard's rows of the tick: one replay of its graphs on a CUDA
        shard (``_ShardGraphs``), the eager ``_tick_shard`` elsewhere."""
        graphs = shard["graphs"]
        if graphs is None:
            self._tick_shard(shard, desc)
        else:
            graphs.tick(desc)

    def _tick_shard(self, shard: Dict[str, Any], desc: Dict[str, np.ndarray]) -> None:
        """One shard's rows of the tick, masked over them: the plain version
        of its graphs, and what the CPU runs.  It skips each write that no
        row takes and replaces the shard's live state."""
        rows_all = len(desc["n_adv"])
        n_max = int(desc["n_adv"].max())
        up = Upload()
        pre = self._plan_write(up, desc["pre_save"], desc["pre_frame"])
        load = None
        if desc["do_load"].any():
            load = (up.add(self._ring.flat_index(np.arange(rows_all), desc["load_frame"])),
                    None if desc["do_load"].all() else up.add(desc["do_load"]))
        post = self._plan_write(up, desc["postload_save"], desc["postload_frame"])
        steps = []
        if n_max:
            inputs = up.add(np.moveaxis(desc["inputs"][:, :n_max], 1, 0))
            for j in range(n_max):
                act = j < desc["n_adv"]
                save = self._plan_write(up, act & desc["save_mask"][:, j], desc["save_frame"][:, j])
                steps.append((None if act.all() else up.add(act), save))
        dev = up.send(shard["device"])

        ring = shard["ring"]

        def write(st: Any, plan) -> None:
            index, frames, rows = (None if k is None else dev[k] for k in plan)
            cs = checksum_device(st) if self._with_checksums else shard["zero_cs"]
            self._ring.save_rows(ring, index, st, cs, frames, rows)

        live = shard["live"]
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
        shard["live"] = st

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def warmup(self, example_inputs: Any) -> None:
        """Record the per-frame input array's shape and dtype, and run the
        tick's device work once without touching the pool's state (a B-row
        digest, advance and gather): this builds the digest kernel and the
        game's device constants before a live loop.  On a CUDA shard it
        then captures the graphs that every live loop meets (``captures``):
        a quiet tick (one advance after a pre-save) and a full-window
        rollback (a load and ``max_burst`` advances, each but the last
        saved, beside quiet rows' pre-saves).  Then it waits for the card."""
        arr = np.asarray(example_inputs)
        self._input_dtype = arr.dtype
        self._input_shape = arr.shape
        B = self._rows
        for shard in self._shards:
            dev = shard["device"]
            with _on(dev):
                checksum_device(shard["live"])
                inputs = from_numpy(np.broadcast_to(arr, (B,) + arr.shape).copy(), dev)
                self._advance(shard["live"], inputs)
                index = from_numpy(self._ring.flat_index(np.arange(B), np.zeros(B, np.int64)), dev)
                self._ring.load_rows(shard["ring"], index)
                if dev.type == "cuda" and shard["graphs"] is None:
                    shard["graphs"] = _ShardGraphs(self, shard)
                    shard["graphs"].warm()
        self.block_until_ready()

    @property
    def captures(self) -> int:
        """Graphs captured over the shards (0 on the CPU)."""
        return sum(s["graphs"].captures for s in self._shards if s["graphs"] is not None)

    @property
    def replays(self) -> int:
        """Graph replays over the shards: one a shard a tick on the card."""
        return sum(s["graphs"].replays for s in self._shards if s["graphs"] is not None)

    def _fulfill_fast(self, cells, b: int, frame: Frame) -> None:
        """Fulfil one save cell WITHOUT a SaveGameState object (the
        descriptor path): pooled per-(session, ring slot) refs refilled in
        place.  Refs are pooled per ring slot, not per session: an older
        cell in a different slot keeps seeing its own frame."""
        ring = self._ref_rings[b]
        if ring is None:
            ring = self._ref_rings[b] = [
                (_BatchSlotRef(self, b, -1), _LazyBatchChecksum(self, b, -1))
                for _ in range(self.ring_length)
            ]
        slot = frame % self.ring_length
        ref, cs = ring[slot]
        ref.frame = frame
        if self._with_checksums:
            cs._frame = frame
            cs._value = None
        self._host_frames[b, slot] = frame
        cells.get_cell(frame).save(frame, ref, cs if self._with_checksums else None)

    def _fill_resim(self, plan, desc: Dict[str, np.ndarray], b: int, lf: int,
                    n_adv: int, trailing: bool, adv_off: int, adv_stride: int) -> None:
        """One rollback-resim slot straight from its descriptor row:
        load, then advance^N with interleaved saves, inputs gathered from
        the tick output buffer (copied into ``desc``), no request objects."""
        cells = plan.saved_states(b)
        data = cells.get_cell(lf).data()
        # the two guards the request path applies through the LoadGameState
        # cell: ownership and ring capacity
        if not (
            isinstance(data, _BatchSlotRef)
            and data.owner is self
            and data.index == b
            and data.frame == lf
        ):
            raise ValueError(
                f"session {b} loads frame {lf} from a cell this pool did "
                f"not save ({data!r})"
            )
        held = self._host_frames[b, lf % self.ring_length]
        if held != lf:
            raise RuntimeError(
                f"session {b}: rollback to frame {lf} but its ring slot "
                f"holds frame {held} -- ring_length={self.ring_length} is "
                f"too small for this session's prediction window"
            )
        if n_adv > self.max_burst:
            raise ValueError(
                f"session {b}: tick carries more than max_burst="
                f"{self.max_burst} advances"
            )
        desc["do_load"][b] = True
        desc["load_frame"][b] = lf
        desc["n_adv"][b] = n_adv
        players, isize = plan.players, plan.input_size
        span = players * (1 + isize)
        buf = plan.buffer
        for j in range(n_adv):
            so = adv_off + j * adv_stride
            st = buf[so : so + players]
            blobs = buf[so + players : so + span].reshape(1, players, isize)
            desc["inputs"][b, j] = self._raw_inputs(blobs, st[None])[0]
            # every advance except (with a trailing live advance) the last
            # is followed by a save of the frame it produced: lf + 1 + j
            if (j < n_adv - 1) if trailing else True:
                f = lf + 1 + j
                desc["save_mask"][b, j] = True
                desc["save_frame"][b, j] = f
                self._fulfill_fast(cells, b, f)

    def _run_plan(self, plan) -> None:
        """``run`` on a ``HostSessionPool`` RequestPlan: quiet slots fill
        the descriptor vectorized, resim and save-only slots per row, and
        only the plan's eager (slow / other) slots go through request
        materialization and ``_parse``."""
        pool = plan.pool
        if plan.tick_no != pool._tick_no or plan is not pool._plan:
            # the columns view the host pool's REUSED output buffer, so
            # consuming an old plan would run garbage silently
            raise RuntimeError(
                "stale RequestPlan: request plans are only valid until "
                "the next advance_all"
            )
        rows = plan.quiet_rows
        eager = list(plan.eager_rows)
        vector = self._raw_inputs is not None and plan.uniform
        any_work = bool(
            rows.size or plan.resim_rows or plan.save_only_rows
        ) or any(plan.lists[b] for b in eager)
        if not any_work:
            _OBS_EMPTY_TICKS.inc()
            return
        desc = self._blank_desc()
        try:
            with self.tracer.span("device.dispatch"):
                if vector and rows.size:
                    frames = plan.quiet_frames
                    desc["pre_save"][rows] = True
                    desc["pre_frame"][rows] = frames
                    desc["n_adv"][rows] = 1
                    statuses, blobs = plan.gather_quiet()
                    desc["inputs"][rows, 0] = self._raw_inputs(blobs, statuses)
                    # _fulfill_fast writes the _host_frames shadow too: one
                    # writer for the ring tags
                    for b, f in zip(rows.tolist(), frames.tolist()):
                        self._fulfill_fast(plan.saved_states(b), b, f)
                elif rows.size:
                    # no bulk converter or a non-uniform pool: quiet slots
                    # materialize like any other (reference semantics)
                    eager.extend(rows.tolist())
                for b, f in plan.save_only_rows:
                    desc["pre_save"][b] = True
                    desc["pre_frame"][b] = f
                    self._fulfill_fast(plan.saved_states(b), b, f)
                for b, lf, n_adv, trailing, adv_off, adv_stride in plan.resim_rows:
                    if vector:
                        self._fill_resim(plan, desc, b, lf, n_adv, trailing, adv_off, adv_stride)
                    else:
                        eager.append(b)
                for b in eager:
                    reqs = plan[b]
                    if reqs:
                        self._parse(b, reqs, desc)
                _OBS_DISPATCHES.inc()
                _OBS_ROLLBACK_LOADS.inc(int(desc["do_load"].sum()))
                _OBS_BURST_DEPTH.observe(int(desc["n_adv"].max()))
                self._tick(desc)
        except BaseException as e:  # incl. KeyboardInterrupt mid-fill
            self._invalid = f"{type(e).__name__}: {e}"
            raise

    def run(self, request_lists: Sequence[List[GgrsRequest]]) -> None:
        """Fulfil all B sessions' request lists as one tick (no device work
        when every list is empty).  ``request_lists[b]`` belongs to session
        ``b``; sessions with nothing to do this tick pass ``[]``.  A
        ``HostSessionPool`` RequestPlan is consumed through its flat
        columns: no ``GgrsRequest`` objects for its fast-path slots."""
        self._check_valid()
        if len(request_lists) != self.batch_size:
            raise ValueError(
                f"run() got {len(request_lists)} request lists for a pool of "
                f"{self.batch_size} sessions"
            )
        if getattr(request_lists, "quiet_rows", None) is not None:
            self._run_plan(request_lists)
            return
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
        """A copy of the ``(B, ...)`` live state tensors, on the first
        shard's device (the card's graphs update the live state in place,
        so the caller never gets the tick's own tensors)."""
        self._check_valid()
        if len(self._shards) == 1:
            return tree_map(torch.clone, self._shards[0]["live"])
        return tree_map(lambda *leaves: torch.cat([l.to(self.device) for l in leaves]),
                        *[shard["live"] for shard in self._shards])

    @property
    def _carry(self) -> Dict[str, Any]:
        """An unsharded pool's ``{"live", "ring"}`` buffers."""
        if len(self._shards) != 1:
            raise RuntimeError("a sharded pool has one carry per shard (_shards)")
        return self._shards[0]

    def _locate(self, index: int) -> Tuple[Dict[str, Any], int]:
        """(shard, row within it) of session ``index``."""
        return self._shards[index // self._rows], index % self._rows

    def live_state(self, index: int) -> Any:
        """One session's live state, fetched to the host as numpy arrays of
        its own (the live state is updated in place on the graph route)."""
        self._check_valid()
        shard, row = self._locate(index)
        return to_numpy(tree_map(lambda l: l[row].clone(), shard["live"]))

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
        shard, row = self._locate(index)
        ring = shard["ring"]
        vals = torch.cat([ring["frames"][row, slot].reshape(1),
                          ring["checksums"][row, slot]]).cpu().numpy()
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
        shard, row = self._locate(index)
        return to_numpy(tree_map(lambda buf: buf[row, slot], shard["ring"]["states"]))

    def ring_checksum(self, index: int, frame: Frame) -> int:
        """A saved frame's u128 checksum (validates the slot)."""
        assert self._with_checksums, "pool was built with with_checksums=False"
        _, lanes = self._slot_probe(index, frame)
        return checksum_to_u128(lanes)

    def block_until_ready(self) -> None:
        with self.tracer.span("device.fence"):
            for shard in self._shards:
                if shard["device"].type == "cuda":
                    synchronize(shard["device"])


class HostedPool:
    """The full massed-hosting tick, both halves pooled: a
    ``host_bank.HostSessionPool`` steps all B sessions' protocol and sync
    mechanism in ONE ctypes crossing, and a ``BatchedRequestExecutor``
    fulfils the B request lists in one masked batched tick on the card.

    ``host_pool`` must hold the same sessions, in the same order, as the
    executor's batch indices.  A host pool on the per-session Python
    fallback gives the same request lists, so this wrapper needs no
    fallback of its own.
    """

    def __init__(self, host_pool, executor: BatchedRequestExecutor) -> None:
        if len(host_pool) != executor.batch_size:
            raise ValueError(
                f"host pool has {len(host_pool)} sessions but the executor "
                f"was built for batch_size={executor.batch_size}"
            )
        self.host = host_pool
        self.executor = executor
        # one trace per hosted pool: the device dispatch / fence spans join
        # the host pool's tick -> crossing -> slot timeline
        host_tracer = getattr(host_pool, "tracer", None)
        if host_tracer is not None and host_tracer.enabled and not executor.tracer.enabled:
            executor.tracer = host_tracer

    def tick(self, local_inputs: Sequence[Tuple[int, int, Any]]) -> None:
        """One pool tick: stage ``(session_index, handle, value)`` local
        inputs (one batched native call on the descriptor plane), advance
        every session, fulfil every request list."""
        stage = getattr(self.host, "stage_inputs", None)
        if stage is not None:
            stage(local_inputs)
        else:
            add = self.host.add_local_input
            for index, handle, value in local_inputs:
                add(index, handle, value)
        self.executor.run(self.host.advance_all())

    def block_until_ready(self) -> None:
        self.executor.block_until_ready()
