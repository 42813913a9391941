"""Session parallelism: many independent sessions batched over a mesh of
devices (the port of ``ggrs_tpu/parallel/batch.py``).

The reference runs one session per process.  Here B sessions are one
batched replay: every game ``advance`` is batch-native, so the session axis
is the leading axis of every carry leaf.  With a ``Mesh``, that axis is
sharded over every mesh axis, host-major: each shard's ``B / n`` sessions
live on the shard's own device, and its replay is issued there.  The only
cross-shard traffic is the health reduction (``psum`` / ``pmin`` in the JAX
package): a per-shard ``sum`` / ``amin``, combined on the process's first
device and, when the mesh spans processes, through
``torch.distributed.all_reduce`` (SUM, MIN; gloo on the CPU, NCCL on the
card).  This is BASELINE config 5's shape (256 concurrent SyncTest
sessions over several chips).

``Mesh`` mirrors ``jax.sharding.Mesh``'s ``.devices`` and ``.axis_names``.
The single-process forms (``make_mesh``, ``make_mesh2d``) stay in one
process, as in the JAX package; ``make_mesh(n, device="cpu")`` gives n
shards on the CPU, the analogue of the JAX tests' virtual 8-device CPU mesh.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import from_numpy, to_numpy
from ..core.device import DeviceLike, resolve_device
from ..core.errors import InvalidRequest
from ..ops.graphs import synchronize
from ..ops.replay import I32_MAX, ReplayPrograms, build_replay_programs
from ..utils.checkpoint import load_pytree, save_pytree
from ..utils.tracing import trace_span
from ..utils.tree import tree_leaves, tree_map

SESSION_AXIS = "sessions"
HOST_AXIS = "hosts"


def _dist():
    import torch.distributed as dist

    return dist


class Mesh:
    """A grid of devices with named axes, as ``jax.sharding.Mesh`` has.

    ``devices`` is an object array of ``torch.device`` (one entry per
    shard), ``axis_names`` names its axes, and ``process_index`` (same
    shape) is the rank of the process that owns each entry.  ``group`` is
    the ``torch.distributed`` process group the health reduction crosses,
    or None for a mesh inside one process.  Shards are numbered in the
    grid's row-major (host-major) order; shard k holds sessions ``k * B / n
    .. (k + 1) * B / n - 1`` of a batch of B."""

    def __init__(
        self,
        devices: Sequence,
        axis_names: Sequence[str],
        process_index: Optional[np.ndarray] = None,
        group: Any = None,
    ) -> None:
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = torch.device(d)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs {grid.ndim} axis names")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.process_index = (
            np.zeros(grid.shape, np.int64) if process_index is None
            else np.asarray(process_index, np.int64)
        )
        self.group = group

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else _dist().get_rank(self.group)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else _dist().get_world_size(self.group)

    def local_shards(self) -> List[Tuple[int, torch.device]]:
        """(shard index, device) of every shard this process owns."""
        rank = self.rank
        return [
            (k, d) for k, (d, p) in enumerate(zip(self.devices.flat, self.process_index.flat))
            if p == rank
        ]

    def all_reduce_(self, tensor: torch.Tensor, op: str) -> None:
        """In place, across the mesh's processes (nothing in one process)."""
        if self.group is not None:
            dist = _dist()
            dist.all_reduce(tensor, op=getattr(dist.ReduceOp, op), group=self.group)

    def gather(self, obj: Any) -> List[Any]:
        """Every process's ``obj``, in rank order (a collective)."""
        if self.world_size == 1:
            return [obj]
        out: List[Any] = [None] * self.world_size
        _dist().all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        if self.world_size > 1:
            _dist().barrier(group=self.group)


def _devices(n: Optional[int], device: DeviceLike) -> List[torch.device]:
    """The first ``n`` devices of ``device``'s type: the cards
    (``cuda:0 .. cuda:n-1``, default all) or n CPU shards (default 1)."""
    kind = resolve_device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count()
        n = have if n is None else n
        if n > have:
            raise AssertionError(f"asked for {n} devices, have {have}")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(kind)] * (1 if n is None else n)


def make_mesh(n_devices: Optional[int] = None, axis: str = SESSION_AXIS,
              device: DeviceLike = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` cards (default: all of them);
    with ``device="cpu"``, ``n_devices`` shards on the CPU."""
    return Mesh(_devices(n_devices, device), (axis,))


def make_mesh2d(
    n_hosts: int,
    chips_per_host: int,
    axes: Tuple[str, str] = (HOST_AXIS, SESSION_AXIS),
    device: DeviceLike = None,
) -> Mesh:
    """2-D ``(hosts, chips)`` mesh, the multi-host shape, in one process.

    ``BatchedSessions`` shards its session axis over every mesh axis,
    host-major, so moving from one host to N is a mesh swap, not a program
    change (``make_distributed_mesh`` builds the multi-process form)."""
    devs = _devices(n_hosts * chips_per_host, device)
    grid = np.empty((n_hosts, chips_per_host), dtype=object)
    for i, d in enumerate(devs):
        grid.flat[i] = d
    return Mesh(grid, axes)


def make_distributed_mesh(
    axes: Tuple[str, str] = (HOST_AXIS, SESSION_AXIS),
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    devices_per_process: Optional[int] = None,
) -> Mesh:
    """The multi-process ``(hosts, chips)`` mesh over a ``torch.distributed``
    group, ``make_mesh2d``'s launchable form.

    Call once per process.  If the process is not yet in a process group
    and ``coordinator_address`` (an ``init_method`` URL such as
    ``tcp://host0:29500`` or ``file:///shared/path``) and ``num_processes >
    1`` are given, the group is initialised first, with NCCL for the cards
    and gloo for the CPU; ``process_id`` is then required.  A caller that
    initialised the group itself passes none of them.  Each process
    contributes ``devices_per_process`` devices (default: every card it
    sees, or one CPU shard), and every process must contribute the same
    number.  The grid is host-major, one row per process in rank order, and
    ``BatchedSessions``' health reduction crosses processes through the
    group's all-reduce.

    Two-process launch (same program on both)::

        # process 0, then process 1 with process_id=1
        mesh = make_distributed_mesh(coordinator_address="tcp://host0:29500",
                                     num_processes=2, process_id=0)
        batch = BatchedSessions(..., mesh=mesh)   # same calls on every process

    With one process and no group this is a ``(1, n_devices)`` mesh running
    the identical program; in a world-size-1 group it is the same grid with
    the reduction through the group."""
    dev = resolve_device(device)
    dist = _dist()
    if not dist.is_initialized() and coordinator_address and (num_processes or 0) > 1:
        if process_id is None:
            raise ValueError(
                "make_distributed_mesh: a coordinator and num_processes are set "
                "but no process_id (defaulting to 0 would register every "
                "process as rank 0 and hang the rendezvous)"
            )
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=coordinator_address,
            world_size=int(num_processes),
            rank=int(process_id),
        )
    group = dist.group.WORLD if dist.is_initialized() else None
    world = 1 if group is None else dist.get_world_size(group)
    local = _devices(devices_per_process, dev)
    if world > 1:
        counts: List[Any] = [None] * world
        dist.all_gather_object(counts, len(local), group=group)
        if len(set(counts)) != 1:
            raise RuntimeError(
                f"make_distributed_mesh: devices are not evenly attached per process: {counts}"
            )
    grid = np.empty((world, len(local)), dtype=object)
    for r in range(world):
        for i, d in enumerate(local):
            grid[r, i] = d
    owner = np.repeat(np.arange(world)[:, None], len(local), axis=1)
    return Mesh(grid, axes, owner, group)


def _on(device: torch.device):
    """Issue on ``device``: its card is the current device inside."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class BatchedSessions:
    """B independent device-synctest sessions as one batched program.

    All sessions share the same (advance, check_distance) program but have
    independent states, inputs and desync counters.  The host reads two
    scalars per ``verify``, regardless of B.

    Without a ``mesh`` the batch lives on ``device`` (the card by default).
    With one, session rows are split over its shards (the device count must
    divide B); on a mesh that spans processes every process makes the same
    calls with the same global ``(B, n, ...)`` inputs, and uses its own
    shards' rows."""

    def __init__(
        self,
        advance: Callable[[Any, Any], Any],
        init_state: Any,
        input_template: Any,
        batch_size: int,
        check_distance: int = 2,
        max_prediction: int = 8,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        if mesh is not None:
            if device is not None:
                raise ValueError("pass device= or mesh=, not both")
            assert batch_size % mesh.size == 0, (
                f"batch_size {batch_size} must divide evenly over {mesh.size} devices"
            )
            shards = mesh.local_shards()
        else:
            shards = [(0, resolve_device(device))]
        self.mesh = mesh
        self.device = shards[0][1]
        self.batch_size = batch_size
        self._rows = batch_size // (1 if mesh is None else mesh.size)
        ring_length = max(max_prediction, check_distance) + 1
        self._programs: ReplayPrograms = build_replay_programs(
            advance, ring_length, check_distance
        )
        self.check_distance = check_distance
        self._ticks_run = 0
        self._last_stats: Optional[torch.Tensor] = None
        # (first session row, device, carry) per shard this process owns
        self._shards: List[Tuple[int, torch.device, Any]] = []
        for k, dev in shards:
            with _on(dev):
                carry = self._programs.init_carry(
                    init_state, input_template, batch_size=self._rows, device=dev
                )
            self._shards.append((k * self._rows, dev, carry))

    @property
    def programs(self) -> ReplayPrograms:
        return self._programs

    @property
    def shard_carries(self) -> List[Any]:
        """This process's shards' carries, ``(B / n, R, ...)`` leaves each,
        in shard order (the device buffers themselves)."""
        return [carry for _, _, carry in self._shards]

    @property
    def carry(self) -> Any:
        """The batched carry, ``(B, R, ...)`` leaves as the JAX package's
        ``BatchedSessions`` stacks it: the device buffers themselves for an
        unsharded batch, a copy on the first device of this process's shards
        otherwise."""
        if len(self._shards) == 1 and self.mesh is None:
            return self._shards[0][2]
        return tree_map(lambda *leaves: torch.cat([l.to(self.device) for l in leaves]),
                        *self.shard_carries)

    @property
    def current_frame(self) -> int:
        return self._ticks_run

    def run_ticks(self, inputs: Any, check: bool = True) -> Optional[Dict[str, int]]:
        """Advance all sessions ``n`` frames.  ``inputs`` leading axes are
        ``(B, n, ...per-frame...)``.  Returns the global stats: total
        mismatches and earliest bad frame across all sessions (across every
        shard, and every process of the mesh).

        ``check=False`` defers the stats fetch (nothing is read back from the
        device) and returns None; read the result later with ``verify()``."""
        leaf0 = tree_leaves(inputs)[0]
        if leaf0.shape[0] != self.batch_size:
            raise ValueError(
                f"inputs lead with {leaf0.shape[0]} sessions, batch has {self.batch_size}"
            )
        n = leaf0.shape[1]
        if n == 0:
            return {"mismatches": 0, "first_bad": I32_MAX} if check else None
        with trace_span("ggrs:tick"):
            for lo, dev, carry in self._shards:
                with _on(dev):
                    self._programs.run_ticks(
                        carry, tree_map(lambda a: a[lo:lo + self._rows], inputs), self._ticks_run)
            self._ticks_run += n
            with trace_span("ggrs:tick.reduce"):
                self._last_stats = self._reduce()
            if not check:
                return None
            return self.verify()

    def _reduce(self) -> torch.Tensor:
        """(mismatches, first_bad) as int64 on the first device: per shard a
        sum and a min, combined here, then across the mesh's processes."""
        parts = []
        for _, dev, carry in self._shards:
            with _on(dev):
                parts.append((carry["mismatches"].sum().to(self.device),
                              carry["first_bad"].amin().to(self.device, torch.int64)))
        mismatches = torch.stack([m for m, _ in parts]).sum().reshape(1)
        first_bad = torch.stack([f for _, f in parts]).amin().reshape(1)
        if self.mesh is not None:
            self.mesh.all_reduce_(mismatches, "SUM")
            self.mesh.all_reduce_(first_bad, "MIN")
        return torch.cat([mismatches, first_bad])

    def verify(self) -> Dict[str, int]:
        """Fetch the deferred global stats (one transfer for both scalars)."""
        if self._last_stats is None:
            return {"mismatches": 0, "first_bad": I32_MAX}
        with trace_span("ggrs:tick.read"):
            mismatches, first_bad = self._last_stats.tolist()
        return {"mismatches": mismatches, "first_bad": first_bad}

    def _host_carry(self, pick: Callable[[Any], Any]) -> Any:
        """``pick(carry)`` of every shard of the mesh (every process's, a
        collective when it spans several), fetched to the host and
        concatenated in session order."""
        local = [to_numpy(pick(carry)) for _, _, carry in self._shards]
        parts = [p for rank_parts in (self.mesh.gather(local) if self.mesh else [local])
                 for p in rank_parts]
        if len(parts) == 1:
            return parts[0]
        return tree_map(lambda *leaves: np.concatenate(leaves), *parts)

    def live_states(self) -> Any:
        """All B live states, fetched to the host (leading axis B)."""
        return self._host_carry(lambda carry: carry["live"])

    # -- durable checkpoints (the reference keeps its saved states in memory) --

    def save_checkpoint(self, path: str) -> None:
        """Write every session's carry, ``(B, ...)`` leaves gathered from
        every shard (and every process of the mesh), and the tick count to
        ``path``, in the JAX package's ``BatchedSessions`` layout.  On a mesh
        of several processes every process calls it and process 0
        writes."""
        carry = self._host_carry(lambda c: c)
        if self.mesh is None or self.mesh.rank == 0:
            save_pytree(
                path,
                carry,
                {
                    "ticks_run": self._ticks_run,
                    "check_distance": self.check_distance,
                    "batch_size": self.batch_size,
                },
            )
        if self.mesh is not None:
            self.mesh.barrier()

    def load_checkpoint(self, path: str) -> None:
        """Restore a checkpoint written by either package's
        ``save_checkpoint`` into this batch (same game, batch_size and
        check_distance), into its preallocated carry.  The mesh may differ
        from the one that saved it: the rows are re-sharded onto this
        batch's shards."""
        template = tree_map(
            lambda t: torch.empty((self.batch_size, *t.shape[1:]), dtype=t.dtype, device="meta"),
            self._shards[0][2],
        )
        carry, meta = load_pytree(path, template)
        if meta["check_distance"] != self.check_distance:
            raise InvalidRequest(
                f"checkpoint was taken at check_distance="
                f"{meta['check_distance']}, batch uses {self.check_distance}"
            )
        if meta["batch_size"] != self.batch_size:
            raise InvalidRequest(
                f"checkpoint holds {meta['batch_size']} sessions, batch was "
                f"built for {self.batch_size}"
            )
        for lo, dev, dst in self._shards:
            src = from_numpy(tree_map(lambda a: a[lo:lo + self._rows], carry), dev)
            tree_map(lambda d, s: d.copy_(s), dst, src)
        self._ticks_run = int(meta["ticks_run"])
        self._last_stats = None

    def block_until_ready(self) -> None:
        for dev in {dev for _, dev, _ in self._shards}:
            if dev.type == "cuda":
                synchronize(dev)
