"""Host session pool: step B P2P sessions' per-tick protocol and sync
mechanism in ONE ctypes crossing per pool tick (the port's copy of
``ggrs_tpu/parallel/host_bank.py``).

``HostSessionPool`` drives every pooled session's tick (input enqueue,
prediction and confirmation watermarks, endpoint timers, ack trim, outbound
InputMessage assembly) through ``csrc/host/session_bank.cpp``, compiled into the
port's host library, off a single packed command buffer per tick.

POLICY STAYS HERE, in Python: GgrsEvent emission, the disconnect consensus
(``P2PSession._update_player_disconnects`` semantics, applied as next tick's
control ops), wait-recommendation pacing, and the construction of the
``GgrsRequest`` lists the game fulfills.  The request grammar and the public
per-session observables (``current_frame``, ``last_confirmed_frame``,
``events``) are those of ``sessions/p2p.py``.

FALLBACK: under ``GGRS_TPU_NO_NATIVE``, or when any session's shape is
outside the bank's mechanism (sparse saving, lockstep, spectators, desync
detection, handshake, variable-size inputs, clocks on different timebases),
the pool drives ordinary per-session ``P2PSession`` objects, the semantic
reference.  Both paths give the JAX package's wire bytes, frames and events
under seeded loss, duplication and reordering.

Known one-tick-late behaviors on the native path (the JAX package's
documented divergence, exercised only in disconnect scenarios; the fallback
is exact): reactions to ``Disconnected`` protocol events and
disconnect-consensus adjustments are computed from this tick's mirrors and
applied as next tick's control ops.

FAULT ISOLATION: the native bank reports per-session error codes in its
output records instead of failing the tick.  On a slot fault the pool
QUARANTINES the slot (its command segment shrinks to a skip flag; the other
B-1 sessions keep the one-crossing tick), harvests the slot's last committed
state (``ggrs_bank_harvest``, a one-off extra crossing), and EVICTS it to a
freshly built Python ``P2PSession`` that resumes the same match from the last
committed frame (``P2PSession.adopt_resume_state``).  Eviction retries with
backoff a bounded number of times; an unrecoverable slot is marked DEAD and
its request lists go empty.  The same per-slot containment wraps the Python
fallback.  ``inject_datagram`` and ``inject_slot_error`` drive faults through
the real tick path.

DESCRIPTOR PLANE: ``stage_inputs`` stages all B local inputs through ONE
``ggrs_bank_stage_inputs`` crossing; ``advance_all`` returns a lazy
:class:`RequestPlan` built from the tick output's two leading fixed-stride
tables (the per-slot header and the request descriptor), materializing a
slot's pooled ``GgrsRequest`` objects only when indexed.
``parallel.BatchedRequestExecutor`` consumes its flat columns directly
(``parallel.HostedPool``).  Fast slots' outbound datagrams flush through one
``ggrs_net_send_table`` crossing (fd-backed sockets, zero-copy out of the
tick output buffer) or one ``send_datagram_batch`` call per socket.
``GGRS_TPU_NO_FASTPATH=1`` selects the reference decoder, which gives the
same requests, events and wire bytes.

OBSERVABILITY: counters and gauges land in an ``obs.Registry``, a per-slot
``FlightRecorder`` keeps the last events, and ``scrape()`` harvests every
slot's protocol and sync counters through ``ggrs_bank_stats`` in ONE extra
crossing per scrape (cached per tick).  ``network_stats(index, handle)``
returns ``P2PSession.network_stats``'s shape for native, quarantined and
evicted slots alike.

NATIVE I/O (docs/DESIGN.md §15, §23): with ``native_io=True`` each slot's
UDP fd is attached to the kernel-batched datapath (csrc/host/net_batch.cpp) and
the tick crossing becomes ``ggrs_bank_pump``: datagrams flow socket ->
crossing -> socket through recvmmsg/sendmmsg with ZERO Python on the packet
path, with the same wire bytes in the same send order, one receive drain and
one send flush per slot per tick.  Fallback is per slot, the JAX package's:
unattachable sockets (in-memory networks, wrappers without fileno,
unresolvable addresses, non-Linux, ``GGRS_TPU_NO_NATIVE_IO``) keep the
Python shuttle, and ``io_state(i)`` says so.  Every other fd-backed socket,
private or a view on a shared ``net.sockets.DispatchHub``, is drained by ONE
``ggrs_net_recv_table`` crossing a tick (the native demux routes by source
address; GRO is armed on covered hubs), unless ``GGRS_TPU_NO_RECV_TABLE``
asks for the per-socket drain; spectator fan-out flushes through the native
send table, GSO-coalesced unless ``GGRS_TPU_NO_GSO``.  Slow slots' records
decode on a ``parallel.decode_pool.DecodePool`` when its backend is not
``serial``; their side effects replay on the owning thread in slot order.

BROADCAST (docs/DESIGN.md §13): with a ``broadcast.SpectatorHub`` attached
before the first tick, matches with spectators are bank-eligible; the bank
fans each slot's confirmed inputs out to its viewers and taps the confirmed
stream into a ``MatchJournal`` inside the one tick crossing.  An evicted
slot's viewers are grafted onto the resumed Python session, and a journal
can stand in for a failed harvest (``MatchJournal.recovery_harvest``).
"""

from __future__ import annotations

import copy
import ctypes
import logging
import os
import pickle
import random
import socket as _pysocket
import struct
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.errors import (
    BadPlayerHandle,
    GgrsError,
    InvalidRequest,
    NotSynchronized,
    StatsUnavailable,
)
from ..core.sync_layer import SavedStates
from ..core.types import (
    AdvanceFrame,
    Disconnected,
    Frame,
    GgrsRequest,
    InputStatus,
    LoadGameState,
    NetworkInterrupted,
    NetworkResumed,
    NULL_FRAME,
    SaveGameState,
    SessionState,
    WaitRecommendation,
)
from ..net import _native
from ..net.messages import RawMessage
from ..net.protocol import (
    MAX_CHECKSUM_HISTORY_SIZE,
    UDP_HEADER_SIZE,
    draw_magic,
)
from ..net.stats import NetworkStats
from ..obs.recorder import (
    EV_DESYNC,
    EV_EVICT,
    EV_FAULT,
    EV_ROLLBACK,
    EV_STATE,
    EV_WIRE,
    FlightRecorder,
)
from ..obs.registry import Registry, default_registry
from ..obs.timeline import EV_DEMOTE_LOCKSTEP as TL_DEMOTE_LOCKSTEP
from ..obs.trace import NULL_TRACER, Tracer
from ..obs.forensics import DesyncReport, build_desync_report
from ..utils.tracing import trace_span
from ..sessions.p2p import (
    MAX_EVENT_QUEUE_SIZE,
    MIN_RECOMMENDATION,
    RECOMMENDATION_INTERVAL,
)

_logger = logging.getLogger(__name__)


_STATUS = (
    InputStatus.CONFIRMED,
    InputStatus.PREDICTED,
    InputStatus.DISCONNECTED,
)

# bank event kinds (session_bank.cpp EvKind)
_EV_INTERRUPTED = 1
_EV_RESUMED = 2
_EV_DISCONNECTED = 3
_EV_CHECKSUM = 4

# ---- vectorized policy plane (DESIGN.md §19) -----------------------------
# Packed per-tick output header: one fixed-stride record per slot leads the
# tick output (session_bank.cpp kHdr*), classified here with a handful of
# NumPy ops.  Quiet slots — live, no events, no spectator streams, no
# consensus, no status-mirror changes — take a fast path that refills
# pooled GgrsRequest objects (per-kind per-slot caches; rollback-resim
# ticks reuse the same objects too) and jumps over the events / status
# mirror / spectator-tail sections instead of parsing them positionally.
_HDR_DTYPE = np.dtype(list(_native.BANK_HDR_FIELDS))
# ---- descriptor plane (DESIGN.md §21) -----------------------------------
# The request descriptor table (one fixed-stride record per slot, after the
# header table), the batched input-staging record, and the batched outbound
# send record — all mirrored from session_bank.cpp / net_batch.cpp and
# pinned by the ggrs-verify layout contract.
_REQ_DTYPE = np.dtype(list(_native.BANK_REQ_FIELDS))
_STAGE_DTYPE = np.dtype(list(_native.BANK_STAGE_FIELDS))
_SEND_DTYPE = np.dtype(list(_native.NET_SEND_FIELDS))
_RECV_DTYPE = np.dtype(list(_native.NET_RECV_FIELDS))
# per-session command flag bytes (session_bank.cpp kFlag*, mirrored as
# _native.CMD_FLAG_*; ggrs-verify pins the pairs equal)
_CMD_INPUTS = bytes([_native.CMD_FLAG_INPUTS])
_CMD_SKIP = bytes([_native.CMD_FLAG_SKIP])
_CMD_STAGED = bytes([_native.CMD_FLAG_INPUTS | _native.CMD_FLAG_STAGED])
# resume bundles cross process boundaries: pin the pickle protocol (the JAX
# package's fleet.rpc.PICKLE_PROTOCOL), so that either package reads them
_BUNDLE_PICKLE_PROTOCOL = 4
_HDR_FAST_WANT = _native.BANK_HDR_LIVE
_HDR_FAST_MASK = (
    _HDR_FAST_WANT
    | _native.BANK_HDR_EVENTS
    | _native.BANK_HDR_SPEC
    | _native.BANK_HDR_CONSENSUS
    | _native.BANK_HDR_DIRTY
    | _native.BANK_HDR_SKIP
)

# Lazy event decoding: the policy section stages cheap tagged tuples in the
# mirror's event queue; real GgrsEvent objects are constructed only when a
# consumer actually drains them (``events()``, eviction's pending_events,
# the export bundle).  Tags deliberately unhashable-free plain strings.
_LZ_INTERRUPTED = "i"
_LZ_RESUMED = "r"
_LZ_DISCONNECTED = "d"
_LZ_WAIT = "w"


def _materialize_events(queue) -> List[Any]:
    """Construct the public ``GgrsEvent`` objects from a mirror's staged
    event queue (lazily-decoded tuples; already-constructed events pass
    through untouched — eviction hand-off re-queues real objects)."""
    out: List[Any] = []
    for ev in queue:
        if type(ev) is not tuple:
            out.append(ev)
        elif ev[0] == _LZ_INTERRUPTED:
            out.append(NetworkInterrupted(addr=ev[1],
                                          disconnect_timeout=ev[2]))
        elif ev[0] == _LZ_RESUMED:
            out.append(NetworkResumed(addr=ev[1]))
        elif ev[0] == _LZ_DISCONNECTED:
            out.append(Disconnected(addr=ev[1]))
        else:  # _LZ_WAIT
            out.append(WaitRecommendation(skip_frames=ev[1]))
    return out

# receive staging caps shared with NativeEndpointCore: a session whose
# worst-case input packet could overflow them must stay on the fallback
# (the bank drops cap-exceeding packets instead of re-decoding in Python)
_RECV_CAP_BYTES = 1 << 16
_RECV_CAP_FRAMES = 512
_WORST_CASE_FRAMES = 192  # 128-deep pending window with generous slack

# slot supervision states (the fault-isolation layer)
SLOT_NATIVE = "native"          # stepped by the bank (or the py fallback)
SLOT_QUARANTINED = "quarantined"  # faulted; eviction pending/backing off
SLOT_EVICTED = "evicted"        # resumed on a per-session Python P2PSession
SLOT_DEAD = "dead"              # unrecoverable; request lists stay empty
SLOT_MIGRATED = "migrated"      # exported to another pool (fleet layer);
#                                 behaves like dead here — the match lives on

# The declared supervision transition table (docs/DESIGN.md §9, §22): every
# ``_set_slot_state`` call site performs an edge from this table, and an
# undeclared edge is logged as an error.  DEAD and MIGRATED are absorbing:
# no edge leaves them.
SLOT_TRANSITIONS = (
    (SLOT_NATIVE, SLOT_QUARANTINED),   # bank fault -> quarantine
    (SLOT_NATIVE, SLOT_DEAD),          # match retired / fallback tick fault
    (SLOT_NATIVE, SLOT_MIGRATED),      # live-migration commit
    (SLOT_NATIVE, SLOT_EVICTED),       # load-shed demotion -> lockstep tier
    (SLOT_QUARANTINED, SLOT_EVICTED),  # eviction succeeded
    (SLOT_QUARANTINED, SLOT_DEAD),     # eviction attempts exhausted
    (SLOT_QUARANTINED, SLOT_MIGRATED),
    (SLOT_EVICTED, SLOT_DEAD),         # fallback tick fault / match retired
    (SLOT_EVICTED, SLOT_MIGRATED),
)
_SLOT_TRANSITION_SET = frozenset(SLOT_TRANSITIONS)

# eviction retry policy: attempt n+1 waits n * backoff ticks PLUS a
# deterministic per-slot jitter draw; after the bounded attempts the slot
# is marked dead.  The jitter decorrelates a shard-wide failure (N slots
# quarantined on the same tick) so the retries do not all land on the same
# tick cadence, and EVICT_MAX_PER_TICK clamps how many eviction attempts
# one supervision pass may run — the rest stay quarantined and retry next
# tick (a retry storm must never turn one bad tick into a stalled pool).
EVICT_MAX_ATTEMPTS = 3
EVICT_BACKOFF_TICKS = 8
EVICT_MAX_PER_TICK = 4


def _evict_jitter(index: int, attempt: int) -> int:
    """Deterministic backoff jitter in ``[0, EVICT_BACKOFF_TICKS)``: a
    stateless hash of (slot, attempt) so identical runs stay bit-identical
    (the control/chaos comparison contract) while co-quarantined slots
    draw different delays."""
    h = ((index + 1) * 2654435761 + attempt * 40503) & 0xFFFFFFFF
    h ^= h >> 16
    return h % EVICT_BACKOFF_TICKS


def _select_resume_frame(h: Dict[str, Any], saved_states):
    """Resume from the newest frame whose save the game actually
    fulfilled.  Normally that is the confirmed watermark, but a fault
    tick can raise the watermark and then have its own save op
    suppressed (native fault after set_last_confirmed, or a send
    failure dropping the parsed requests) — then the watermark-1 cell
    is the newest committed state, and the harvest keeps that frame's
    inputs precisely for this case.  Frames at or below the watermark
    can never hold misprediction state (the watermark cannot pass the
    first incorrect frame), so either cell is sound to resume from.
    Shared by eviction (``_evict``) and the fleet export seam
    (``export_resume_state``); returns ``(frame, cell)``."""
    for r in (h["last_confirmed"], h["last_confirmed"] - 1):
        if r < 0:
            continue
        c = saved_states.get_cell(r)
        if c.frame != r:
            continue
        if any(blobs and start > r for start, blobs in h["player_inputs"]):
            continue  # harvested inputs do not reach back to r
        return r, c
    raise RuntimeError(
        f"no committed resumable frame at or below "
        f"{h['last_confirmed']} (unfulfilled saves?)"
    )


class SlotFault:
    """One fault-log entry for a pool slot."""

    __slots__ = ("tick", "code", "detail")

    def __init__(self, tick: int, code: int, detail: str):
        self.tick = tick
        self.code = code
        self.detail = detail

    def __repr__(self) -> str:  # pragma: no cover
        return f"SlotFault(tick={self.tick}, code={self.code}, {self.detail!r})"


def _uvarint_len(v: int) -> int:
    n = 1
    while v >= 0x80:
        v >>= 7
        n += 1
    return n


def _phase_names(n_ph: int):
    """The ``n_ph`` phase names of a timing tail (shared by the tick-tail
    and stats-tail parsers); the library is built from the same sources as
    ``_native.BANK_PHASES``, so a count past it is a layout drift."""
    if n_ph > len(_native.BANK_PHASES):
        raise RuntimeError(f"timing tail has {n_ph} phases, BANK_PHASES names "
                           f"{len(_native.BANK_PHASES)}")
    return _native.BANK_PHASES[:n_ph]


def _bank_eligible(builder, hub_active: bool = False) -> bool:
    """Can this builder's session run on the native bank mechanism?  The
    checks mirror the bank's scope; anything outside it uses the Python
    sessions (identical semantics, per-session cost).

    ``hub_active``: a ``broadcast.SpectatorHub`` owns spectator relaying for
    this pool.  A match with spectators is then bank-eligible: the bank fans
    the confirmed-input stream out natively inside the tick crossing.
    Hubless callers keep the JAX package's behavior: spectator matches run
    as per-session Python sessions, whose own relay path is the semantic
    reference."""
    cfg = builder._config
    from ..core.sync_layer import _native_sync_semantics_ok
    from ..core.types import Spectator

    if not _native_sync_semantics_ok(cfg):
        return False
    if builder._sparse_saving or builder._max_prediction < 1:
        return False  # sparse saving / lockstep: fallback policy paths
    if builder._desync_detection.enabled or builder._sync_handshake:
        return False
    if builder._local_players < 1 or builder._num_players > 64:
        return False
    if not hub_active and any(
        isinstance(t, Spectator) for t in builder._player_reg.handles.values()
    ):
        return False
    # worst-case packet must fit the native staging caps
    size = cfg.native_input_size
    per_frame = builder._num_players * (size + _uvarint_len(size))
    if _WORST_CASE_FRAMES * per_frame > _RECV_CAP_BYTES:
        return False
    if _WORST_CASE_FRAMES > _RECV_CAP_FRAMES:
        return False
    return True


class RequestPlan:
    """One tick's request lists as a lazily-materializing sequence
    (descriptor plane, DESIGN.md §21).

    ``advance_all()`` returns this on the descriptor path.  It behaves
    like the ``List[List[GgrsRequest]]`` it replaces — ``len``, indexing,
    iteration, and in-place assignment all work — but a fast-path slot's
    pooled ``GgrsRequest`` objects are only constructed when someone
    actually indexes that slot (``plan[i]`` / ``pool.requests_for(i)``).
    ``BatchedRequestExecutor`` never does: it consumes the flat descriptor
    columns below directly and builds its device dispatch with NumPy,
    constructing zero request objects for quiet slots.

    Lifetime: like the pooled request lists before it, a plan is valid
    until the NEXT ``advance_all`` on its pool (the columns view the
    pool's reused output buffer).  Materializing a stale plan raises.

    Executor-facing columns (all referring to the tick output buffer):

    ``quiet_rows``/``quiet_frames``  slot indices whose tick is exactly
        [save f, advance], and f per row;
    ``resim_rows``  ``(slot, load_frame, n_adv, trailing, adv_off,
        adv_stride)`` per rollback-resim slot (absolute buffer offsets);
    ``save_only_rows``  ``(slot, frame)`` per prediction-limit slot;
    ``eager_rows``  slots whose lists were materialized at build time
        (slow/other/skip slots) — consume via ``plan[i]``;
    ``gather_quiet()``  the quiet rows' advance payloads as
        ``(statuses [k, players] u8, blobs [k, players, isize] u8)``,
        one fancy-index gather, uniform pools only.
    """

    __slots__ = (
        "pool", "tick_no", "lists", "buffer", "players", "input_size",
        "uniform", "quiet_rows", "quiet_frames", "quiet_offs",
        "quiet_adv_off", "resim_rows", "save_only_rows", "eager_rows",
        "offs_l", "live_l",
    )

    def __init__(self, pool, n: int):
        self.pool = pool
        self.tick_no = pool._tick_no
        self.lists: List[Optional[List[GgrsRequest]]] = [None] * n
        self.buffer: Optional[np.ndarray] = None
        self.players = 0
        self.input_size = 0
        self.uniform = False
        self.quiet_rows: Optional[np.ndarray] = None
        self.quiet_frames: Optional[np.ndarray] = None
        self.quiet_offs: Optional[np.ndarray] = None
        self.quiet_adv_off: Optional[np.ndarray] = None
        self.resim_rows: List[Tuple[int, int, int, bool, int, int]] = []
        self.save_only_rows: List[Tuple[int, int]] = []
        self.eager_rows: List[int] = []
        self.offs_l: List[int] = []
        self.live_l: List[bool] = []

    def __len__(self) -> int:
        return len(self.lists)

    def __getitem__(self, i):
        if isinstance(i, slice):
            # list parity: a slice of request lists, members materialized
            return [self[k] for k in range(*i.indices(len(self.lists)))]
        lst = self.lists[i]
        if lst is None:
            lst = self.lists[i] = self.pool._materialize_slot(self, i)
        return lst

    def __setitem__(self, i: int, value: List[GgrsRequest]) -> None:
        self.lists[i] = value

    def __iter__(self):
        for i in range(len(self.lists)):
            yield self[i]

    def saved_states(self, i: int):
        """Slot ``i``'s ``SavedStates`` ring — where the executor's
        descriptor path fulfills save cells without request objects."""
        return self.pool._mirrors[i].saved_states

    def gather_quiet(self) -> Tuple[np.ndarray, np.ndarray]:
        """All quiet rows' advance payloads in one fancy-index gather."""
        rows = self.quiet_rows
        k = int(rows.size)
        players, isize = self.players, self.input_size
        base = self.quiet_offs + self.quiet_adv_off
        span = players * (1 + isize)
        flat = self.buffer[base[:, None] + np.arange(span)]
        statuses = flat[:, :players]
        blobs = flat[:, players:].reshape(k, players, isize)
        return statuses, blobs


class _EndpointMirror:
    """Python-side view of one bank endpoint: identity plus the state the
    consensus / event policy reads."""

    __slots__ = (
        "addr", "handles", "magic", "running",
        "peer_disc", "peer_last", "pending_checksums",
    )

    def __init__(self, addr, handles: List[int], magic: int, players: int):
        self.addr = addr
        self.handles = handles
        self.magic = magic
        self.running = True
        self.peer_disc = [False] * players
        self.peer_last = [NULL_FRAME] * players
        self.pending_checksums: Dict[Frame, int] = {}


class _SpectatorMirror:
    """Python-side view of one native fan-out (spectator) endpoint: the
    identity plus the hub-facing state (attach handles, liveness, the ack
    watermark the catchup-lag gauge reads, and the one-tick datagram
    deferral that reproduces the Python session's flush order)."""

    __slots__ = ("addr", "magic", "handles", "running", "last_acked",
                 "deferred")

    def __init__(self, addr, magic: int, handles: List[int]):
        self.addr = addr
        self.magic = magic
        self.handles = handles  # builder spectator handles ([] = hub-joined)
        self.running = True
        self.last_acked: Frame = NULL_FRAME
        self.deferred: List[bytes] = []  # fan-out datagrams, sent next tick


class _SessionMirror:
    """Python-side policy state for one bank session."""

    __slots__ = (
        "config", "socket", "num_players", "max_prediction", "input_size",
        "local_handles", "local_handle_set", "endpoints", "addr_to_ep",
        "saved_states", "current_frame", "last_confirmed", "frames_ahead",
        "local_disc", "local_last", "event_queue", "next_recommended_sleep",
        "staged_inputs", "pending_ctrl",
        "spectators", "addr_to_spec", "next_spec_frame", "send_raw",
        # vectorized policy plane: the byte length of this slot's
        # status-mirror section (to jump to the broadcast tail without
        # parsing) and the pooled request-object caches the fast path
        # refills in place, valid until the next advance_all like the
        # scrape records
        "mirror_len", "pooled_list", "pool_saves", "pool_loads",
        "pool_advs",
        # descriptor plane (DESIGN.md §21): the set of handles staged
        # NATIVELY this tick (ggrs_bank_stage_inputs — the blobs live in
        # the bank, only membership is tracked here), the socket's batched
        # raw-send entry when it has one, and the cached input encoder
        "staged_native", "send_batch", "encode",
    )

    def __init__(self, config, socket, num_players, max_prediction,
                 local_handles):
        self.config = config
        self.socket = socket
        self.num_players = num_players
        self.max_prediction = max_prediction
        self.input_size = config.native_input_size
        self.local_handles = local_handles
        self.local_handle_set = set(local_handles)
        self.endpoints: List[_EndpointMirror] = []
        self.addr_to_ep: Dict[Any, int] = {}
        self.saved_states = SavedStates(max_prediction)
        self.current_frame: Frame = 0
        self.last_confirmed: Frame = NULL_FRAME
        self.frames_ahead = 0
        self.local_disc = [False] * num_players
        self.local_last = [NULL_FRAME] * num_players
        self.event_queue: deque = deque()
        self.next_recommended_sleep: Frame = 0
        self.staged_inputs: Dict[int, bytes] = {}
        self.pending_ctrl: List[Tuple[int, int, Frame]] = []
        # broadcast fan-out (hub-owned): mirrors of the slot's native
        # spectator endpoints, plus the next-frame cursor the attach policy
        # reads (native truth, refreshed from every tick's broadcast tail)
        self.spectators: List[_SpectatorMirror] = []
        self.addr_to_spec: Dict[Any, int] = {}
        self.next_spec_frame: Frame = 0
        # raw datagram send: the socket's send_datagram when it has one
        # (no RawMessage wrapper, no re-encode), else a send_to shim —
        # bound once at finalization, called per outbound datagram
        send = getattr(socket, "send_datagram", None)
        if send is None:
            send = lambda data, addr, _s=socket: _s.send_to(  # noqa: E731
                RawMessage(data), addr
            )
        self.send_raw = send
        # batched outbound (§21): one send_datagram_batch call per slot
        # per tick when the socket offers it; None keeps the per-datagram
        # send_raw path (wrapped/recording sockets — the reference leg)
        self.send_batch = getattr(socket, "send_datagram_batch", None)
        # batched staging (§21)
        self.staged_native: set = set()
        self.encode = config.input_encode
        # vectorized policy plane: filled by _finalize on the native path.
        # The pools grow to the deepest tick seen (rollback resims append
        # extra save/advance pairs) and are reused in place from then on.
        self.mirror_len = 0
        self.pooled_list: List[Any] = []
        self.pool_saves: List[SaveGameState] = []
        self.pool_loads: List[LoadGameState] = []
        self.pool_advs: List[AdvanceFrame] = []

    def push_event(self, event) -> None:
        """Queue one event — either a real GgrsEvent or a lazily-decoded
        tag tuple (``_materialize_events`` constructs the public objects
        when a consumer drains the queue)."""
        self.event_queue.append(event)
        while len(self.event_queue) > MAX_EVENT_QUEUE_SIZE:
            self.event_queue.popleft()


class HostSessionPool:
    """B pooled host sessions, one mechanism crossing per tick.

    Usage (single-threaded, like every session object)::

        pool = HostSessionPool()
        for builder, socket in matches:
            pool.add_session(builder, socket)
        ...
        pool.add_local_input(i, handle, value)     # per session, per tick
        request_lists = pool.advance_all()          # ONE native crossing
        events = pool.events(i)

    ``request_lists[i]`` follows the exact ``GgrsRequest`` grammar of
    ``P2PSession.advance_frame``; feed it to any executor, including
    ``parallel.BatchedRequestExecutor`` (see ``parallel.HostedPool``).

    On the native path all sessions' timers run off ONE clock read per tick
    (builder 0's clock): pooled sessions must share a timebase.  Builders
    whose clocks read visibly apart at finalize fall back to per-session
    Python sessions, where each honors its own clock.
    """

    def __init__(self, retire_dead_matches: bool = False,
                 metrics: Optional[Registry] = None,
                 tracer: Optional[Tracer] = None,
                 flight_recorder_size: int = 256,
                 native_io: bool = False,
                 evict_max_per_tick: Optional[int] = None) -> None:
        # per-pool override of the eviction storm clamp (None = the module
        # default); the fleet layer passes its tuning's value through
        self._evict_max_per_tick = (
            EVICT_MAX_PER_TICK if evict_max_per_tick is None
            else evict_max_per_tick
        )
        # native_io (docs/DESIGN.md §15): attach each slot's UDP fd to the
        # kernel-batched datapath (net_batch.cpp) so datagrams flow
        # socket -> crossing -> socket with zero Python on the packet path
        # (one recvmmsg + one sendmmsg per slot per tick instead of one
        # syscall per datagram).  Per-slot fallback to the Python shuttle
        # whenever the fd is not native-attachable: in-memory networks,
        # wrapped sockets, unresolvable peer addresses, non-Linux builds,
        # GGRS_TPU_NO_NATIVE_IO=1.
        self.native_io = native_io
        self._use_pump = False
        self._net_handles: List[Optional[int]] = []
        self._io_attached: List[bool] = []
        self._io_live: List[int] = []  # attached slot indices (the io-delta
        # walk is driven by this list, not range(B))
        self._io_prev: Dict[Tuple[int, int], int] = {}  # (slot, word) deltas
        # final counter snapshots of detached/evicted slots: io_stats()
        # totals must never regress when a NetBatch is released
        self._io_final: Dict[int, Dict[str, Any]] = {}
        # ---- the one-crossing inbound drain (docs/DESIGN.md §23) over all
        # non-attached fd-backed sockets (ggrs_net_recv_table), shared
        # dispatch sockets and GSO fan-out.  The drain tables are rebuilt
        # by _refresh_drain() on any membership/state change.
        self._drain_ok = False
        self._drain_fd_tab = b""      # packed NET_FD_STRIDE entries
        self._drain_route_tab = b""   # packed NET_ROUTE_STRIDE entries
        self._drain_n_fds = 0
        self._drain_n_routes = 0
        self._drain_fd_fault: List[List[int]] = []  # fd_idx -> slots to
        # fault on a fatal recv errno (one slot per private fd; every
        # routed slot for a shared dispatch fd)
        self._drain_covered: List[bool] = []  # slot served by the drain
        self._drain_covered_keys: List[int] = []  # covered slot indices
        self._drain_wire: List[Optional[Dict]] = []  # slot ->
        # {(ip, port): ('e'|'s', idx)}: the Python-side half of the demux
        self._drain_deliver: Dict[int, Any] = {}  # quarantined/evicted
        # co-tenant on a shared hub -> its view (records go to _pending)
        self._drain_recs: Optional[ctypes.Array] = None
        self._drain_recs_cap = 0
        self._drain_slab: Optional[ctypes.Array] = None
        self._drain_slab_cap = 0
        self._drain_totals = dict.fromkeys(
            _native.NET_RECV_TABLE_STAT_FIELDS, 0
        )
        self._drain_hist = [0] * (len(_native.IO_BATCH_BUCKETS) + 1)
        self.drain_crossings = 0  # ggrs_net_recv_table invocations
        self.drain_ns = 0  # wall ns in _drain_inbound (profiling split)
        self._send_flags: List[int] = []  # per-slot NET_SEND_FIELDS flags
        self._gso_totals = {"gso_sends": 0, "gso_segments": 0}
        self._gro_on = False  # UDP_GRO armed on >=1 covered hub
        self._decode_pool = None  # parallel slow-slot decode plane (§24)
        self.decode_parallel_ticks = 0  # ticks that fanned decode out
        self._builders: List[Tuple[Any, Any]] = []
        self._finalized = False
        self._native_active = False
        self._bank = None
        self._lib = None
        self._mirrors: List[_SessionMirror] = []
        self._sessions: List[Any] = []  # fallback P2PSessions
        # ---- input plane (DESIGN.md §27) ----
        # device-batched prediction over the Python-path slots: gathered
        # once per tick in _advance_all_fallback, served to the queues
        self._prediction_plane = None
        # slots demoted to the lockstep tier (load-shedding): index ->
        # tick demoted, for stats; the session itself lives in _evicted
        self._lockstep_slots: Dict[int, int] = {}
        # match-lifecycle timeline seam (DESIGN.md §28): the owning shard
        # installs a callable(etype, slot, detail) to translate pool-level
        # lifecycle moments (lockstep demotion) into match-keyed timeline
        # events; None when the pool runs unsupervised
        self.timeline_sink = None
        self._clock = None
        self._out_buf: Optional[ctypes.Array] = None
        self._out_len = ctypes.c_size_t(0)
        self._invalid: Optional[str] = None
        self.crossings = 0  # ggrs_bank_tick invocations (the count test)
        self.harvests = 0   # eviction harvest crossings (one-off per fault)
        self.stat_crossings = 0  # ggrs_bank_stats invocations (scrapes)
        # ---- vectorized policy plane ----
        # _vectorized: classify slots from the tick output's header table
        # and fast-path the quiet ones (GGRS_TPU_NO_FASTPATH=1 forces the
        # reference per-slot parse, the parity legs' reference).  Tracing
        # uses the reference parse too: the per-slot spans ARE the point of
        # a traced tick.  The strides are the library's, checked at finalize.
        self._hdr_stride = 0
        self._req_stride = 0
        self._vectorized = False
        self.fast_slot_ticks = 0  # slots served by the fast path (counter)
        self.fast_ticks = 0       # ticks where every live slot was fast
        # ---- descriptor plane ----
        self._uniform = False  # all mirrors share (players, input_size) —
        # the executor's bulk input gather requires it
        self.plan_ticks = 0        # advance_all calls decoded via a plan
        self.desc_slow_slots = 0   # plan-tick slots that needed the eager
        # per-slot reference decoder (slow/other/skip records)
        # per-slot input stagers: add_local_input dispatches through this
        # table (one bound callable per slot, rebuilt on supervision
        # transitions) instead of re-validating slot state and handle
        # membership on every call — the B-proportional staging walk fix
        self._stagers: List[Any] = []
        # the most recent descriptor-plane tick's RequestPlan (also what
        # advance_all returned); requests_for() and the staleness guard
        # read it
        self._plan: Optional[RequestPlan] = None
        # per-slot native outbound eligibility (§21c): a non-attached but
        # fd-backed socket whose endpoint addresses resolve rides the
        # one-crossing ggrs_net_send_table flush; everything else batches
        # per slot (send_datagram_batch) or keeps the per-datagram path
        self._send_fds: List[Optional[int]] = []
        self._ep_wire: List[Optional[List[Tuple[int, int]]]] = []
        # ---- observability (DESIGN.md §12) ----
        # metrics: explicit Registry for isolation (tests, multi-pool
        # processes) or the process-wide default; Registry(enabled=False)
        # turns the whole layer off (null instruments, no recorders)
        self.metrics = metrics if metrics is not None else default_registry()
        m = self.metrics
        self._obs_on = m.enabled
        self._recorders: List[Optional[FlightRecorder]] = []
        self._flight_capacity = flight_recorder_size
        # ---- tracing (DESIGN.md §14) ----
        # tracer: tick -> crossing -> slot spans on the Python side; when
        # the library carries ggrs_bank_set_timing, the native per-phase
        # timings ride the tick output's timing tail (zero extra crossings)
        # and are re-emitted as child spans of the crossing.  The shared
        # NULL_TRACER default keeps the hot path at one no-op call per tick.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._trace_native = False  # timing tail armed on the loaded bank
        self._phase_totals: Optional[Tuple[int, Dict[str, int]]] = None
        self._last_phase_ns: Optional[Dict[str, int]] = None
        # /healthz source: last completed pool tick on time.monotonic()
        self.last_tick_at: Optional[float] = None
        # desync forensics: slot -> the report built when a desync-class
        # fault quarantined it (DesyncReport; scripts/chaos.py artifacts)
        self._desync_reports: Dict[int, DesyncReport] = {}
        self._m_ticks = m.counter(
            "ggrs_pool_ticks_total", "pool ticks driven (advance_all calls)")
        _cross = m.counter(
            "ggrs_pool_crossings_total",
            "ctypes crossings by kind (tick / harvest / stats)",
            labels=("kind",))
        self._m_cross_tick = _cross.labels(kind="tick")
        self._m_cross_harvest = _cross.labels(kind="harvest")
        self._m_cross_stats = _cross.labels(kind="stats")
        self._m_faults = m.counter(
            "ggrs_pool_slot_faults_total", "per-slot faults by error code",
            labels=("code",))
        self._m_transitions = m.counter(
            "ggrs_pool_slot_transitions_total",
            "supervision state transitions", labels=("src", "dst"))
        self._m_slot_state = m.gauge(
            "ggrs_pool_slot_state", "slots currently in each supervision "
            "state", labels=("state",))
        self._m_evictions = m.counter(
            "ggrs_pool_evictions_total",
            "slots successfully evicted to the Python fallback")
        self._m_evict_failures = m.counter(
            "ggrs_pool_eviction_failures_total", "failed eviction attempts")
        self._m_evict_latency = m.histogram(
            "ggrs_pool_eviction_latency_ticks",
            "ticks from quarantine to successful eviction",
            buckets=(1, 2, 4, 8, 16, 32, 64))
        self._m_demotions = m.counter(
            "ggrs_pool_lockstep_demotions_total",
            "healthy slots demoted to the lockstep tier (load-shedding)")
        # ---- prediction accuracy (DESIGN.md §28): the Python tier's
        # input queues count mispredict episodes / rollback depth, the
        # device plane counts adopt-vs-decline; both fold into these at
        # scrape cadence (zero extra crossings) ----
        _mis = m.counter(
            "ggrs_predict_mispredicts_total",
            "rollback episodes caused by a wrong input prediction, by "
            "the source that produced it (plane = device-batched table, "
            "scalar = the config predictor)", labels=("source",))
        self._m_mis_plane = _mis.labels(source="plane")
        self._m_mis_scalar = _mis.labels(source="scalar")
        _served = m.counter(
            "ggrs_predict_served_total",
            "device prediction-plane row outcomes: adopted from the "
            "batched table vs declined to the scalar fallback",
            labels=("outcome",))
        self._m_pred_adopt = _served.labels(outcome="adopted")
        self._m_pred_fallback = _served.labels(outcome="fallback")
        self._m_mis_depth = m.counter(
            "ggrs_predict_rollback_frames_total",
            "rollback depth (frames re-simulated) attributed to "
            "mispredicted inputs")
        # last folded cumulative totals: (mispredicts, plane_mispredicts,
        # depth_frames, plane_hits, plane_fallbacks)
        self._predict_seen = [0, 0, 0, 0, 0]
        _req = m.counter(
            "ggrs_pool_requests_total",
            "GgrsRequests returned to the game, by kind",
            labels=("kind",))
        self._m_req_save = _req.labels(kind="save")
        self._m_req_load = _req.labels(kind="load")
        self._m_req_advance = _req.labels(kind="advance")
        self._m_rollbacks = m.counter(
            "ggrs_pool_rollbacks_total",
            "rollback decisions executed by pooled slots")
        # ---- broadcast (docs/DESIGN.md §13): fan-out + journal
        # observability ----
        self._m_fanout_dgrams = m.counter(
            "ggrs_fanout_datagrams_total",
            "confirmed-input datagrams fanned out to spectators",
            labels=("slot",))
        self._m_fanout_bytes = m.counter(
            "ggrs_fanout_bytes_total",
            "wire bytes fanned out to spectators", labels=("slot",))
        self._m_spectators = m.gauge(
            "ggrs_spectators_attached",
            "spectator endpoints attached per slot", labels=("slot",))
        self._m_spec_lag = m.gauge(
            "ggrs_spectator_catchup_lag",
            "frames broadcast but not yet acked by the viewer",
            labels=("slot", "spectator"))
        # ---- batched I/O (docs/DESIGN.md §15): refreshed from the scrape's
        # per-slot io tail (the native counters ride the SAME one-crossing
        # stats harvest; nothing here touches the packet path) ----
        self._m_io_syscalls = m.counter(
            "ggrs_io_syscalls_total",
            "socket syscalls by kind (sendto/recvfrom = per-datagram "
            "Python path; recvmmsg/sendmmsg = kernel-batched native path)",
            labels=("kind",))
        self._m_io_dgrams = m.counter(
            "ggrs_io_datagrams_total",
            "datagrams moved by the kernel-batched datapath, by direction",
            labels=("dir",))
        self._m_io_send_errors = m.counter(
            "ggrs_io_send_errors_total",
            "transient native send failures counted as packet loss")
        self._m_io_oversized = m.counter(
            "ggrs_io_oversized_total",
            "natively-sent datagrams above the ideal UDP size")
        self._m_io_recv_batch = m.histogram(
            "ggrs_io_recv_batch_size",
            "datagrams per recvmmsg call", buckets=_native.IO_BATCH_BUCKETS)
        self._m_io_send_batch = m.histogram(
            "ggrs_io_send_batch_size",
            "datagrams per sendmmsg call", buckets=_native.IO_BATCH_BUCKETS)
        self._m_io_recvmmsg = self._m_io_syscalls.labels(kind="recvmmsg")
        self._m_io_sendmmsg = self._m_io_syscalls.labels(kind="sendmmsg")
        self._m_io_dgrams_in = self._m_io_dgrams.labels(dir="in")
        self._m_io_dgrams_out = self._m_io_dgrams.labels(dir="out")
        self._m_fast_slots = m.counter(
            "ggrs_pool_fastpath_slots_total",
            "slot ticks served by the vectorized quiet path (no per-slot "
            "body parse)")
        # the one-crossing inbound drain + GSO (docs/DESIGN.md §23)
        self._m_drain_crossings = m.counter(
            "ggrs_io_drain_crossings_total",
            "ggrs_net_recv_table invocations (one per pool tick when the "
            "batched inbound drain is active)")
        self._m_drain_dgrams = m.counter(
            "ggrs_io_drain_datagrams_total",
            "datagrams moved by the one-crossing inbound drain")
        self._m_drain_unroutable = m.counter(
            "ggrs_io_drain_unroutable_total",
            "dispatch-socket datagrams dropped for an unclaimed source")
        self._m_drain_batch = m.histogram(
            "ggrs_io_drain_batch_size",
            "datagrams per recvmmsg call on the batched inbound drain",
            buckets=_native.IO_BATCH_BUCKETS)
        self._m_gso_sends = m.counter(
            "ggrs_io_gso_sends_total",
            "UDP_SEGMENT segmented sends on the batched outbound path")
        self._m_gso_segments = m.counter(
            "ggrs_io_gso_segments_total",
            "datagrams coalesced into UDP_SEGMENT segmented sends")
        self._quarantined_at: Dict[int, int] = {}  # index -> quarantine tick
        self._stats_cache: Optional[Tuple[int, List[Dict[str, Any]]]] = None
        self._setter_cache: Dict[int, Any] = {}  # slot -> prebound gauge sets
        # slot -> prebound spectator catchup-lag Gauge.set list: label
        # resolution (str() + dict walk) off the scrape loop, like
        # _setter_cache — part of the B=256 allocation-free scrape pin
        self._spec_setter_cache: Dict[int, List[Any]] = {}
        # slot -> prebound (datagrams.inc, bytes.inc): label resolution off
        # the per-tick fan-out send loop, like _setter_cache for scrapes
        self._fanout_counters: Dict[int, Tuple[Any, Any]] = {}
        self._scrape_buf: Optional[ctypes.Array] = None  # persistent (GC)
        self._bank_records: Optional[List[Dict[str, Any]]] = None
        # scrape-refreshed gauges (set by scrape(), one label set per slot /
        # endpoint — the Prometheus-facing view of the stat harvest)
        self._m_slot_frame = m.gauge(
            "ggrs_slot_current_frame", "slot's post-tick frame",
            labels=("slot",))
        self._m_slot_occupancy = m.gauge(
            "ggrs_slot_prediction_occupancy",
            "frames of prediction window in use (current - confirmed)",
            labels=("slot",))
        self._m_slot_rollbacks = m.gauge(
            "ggrs_slot_rollbacks", "rollbacks executed by this slot",
            labels=("slot",))
        self._m_slot_rollback_depth = m.gauge(
            "ggrs_slot_max_rollback_depth",
            "deepest single rollback this slot has executed",
            labels=("slot",))
        self._m_ep_ping = m.gauge(
            "ggrs_endpoint_ping_ms", "round-trip time per remote endpoint",
            labels=("slot", "endpoint"))
        self._m_ep_queue = m.gauge(
            "ggrs_endpoint_send_queue_len",
            "unacked outbound inputs per remote endpoint",
            labels=("slot", "endpoint"))
        self._m_ep_kbps = m.gauge(
            "ggrs_endpoint_kbps_sent", "estimated outbound bandwidth",
            labels=("slot", "endpoint"))
        self._m_ep_behind = m.gauge(
            "ggrs_endpoint_frames_behind",
            "frame advantage from each perspective",
            labels=("slot", "endpoint", "side"))
        # ---- supervision state (fault isolation) ----
        # retire_dead_matches: when every remote endpoint of a slot has
        # disconnected the match is over; True retires the slot (state dead,
        # empty request lists) instead of letting it run free on dummy
        # inputs forever.  Default False preserves P2PSession semantics.
        self.retire_dead_matches = retire_dead_matches
        self._tick_no = 0
        self._slot_state: List[str] = []
        # incremental supervision (DESIGN.md §19): the post-tick walk is
        # driven by the slots that actually need attention — quarantined
        # (eviction pending) and evicted (their Python session must tick)
        # — instead of range(B).  Maintained by _set_slot_state; dead /
        # migrated slots leave the set (nothing here ticks for them).
        self._attention: set = set()
        # state-transition feed for incremental consumers (fleet shards'
        # forensics sweep): (slot, old, new, tick), bounded, drained via
        # drain_state_transitions()
        self._state_transitions: List[Tuple[int, str, str, int]] = []
        self._fault_log: List[List[SlotFault]] = []
        self._evicted: Dict[int, Any] = {}       # index -> P2PSession
        self._pending_load: Dict[int, GgrsRequest] = {}
        self._evict_attempts: Dict[int, int] = {}
        self._evict_next_try: Dict[int, int] = {}
        self._inject_dgrams: Dict[int, List[Tuple[int, bytes]]] = {}
        self._inject_err: Dict[int, int] = {}
        # ---- broadcast seams (broadcast/) ----
        # _spectator_hub: the SpectatorHub that owns relay policy for this
        # pool (set by SpectatorHub.__init__, must precede finalization);
        # _journal_sinks: per-slot confirmed-stream consumers
        # (MatchJournal.append_frames signature); _journal_recovery holds
        # per-slot callables that synthesize a harvest-shaped resume dict
        # from the journal tail when ggrs_bank_harvest itself fails (crash
        # recovery).
        self._spectator_hub: Optional[Any] = None
        self._journal_sinks: Dict[int, Any] = {}
        self._journal_recovery: Dict[int, Any] = {}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def add_session(self, builder, socket) -> int:
        """Register one session described by a fully-populated
        ``SessionBuilder`` plus its socket.  Returns the session index."""
        if self._finalized:
            raise InvalidRequest("pool already finalized; add sessions first")
        self._builders.append((builder, socket))
        return len(self._builders) - 1

    def _finalize(self) -> None:
        self._finalized = True
        self._slot_state = [SLOT_NATIVE] * len(self._builders)
        self._fault_log = [[] for _ in self._builders]
        self._net_handles = [None] * len(self._builders)
        self._io_attached = [False] * len(self._builders)
        self._recorders = [
            FlightRecorder(self._flight_capacity) if self._obs_on else None
            for _ in self._builders
        ]
        if self._builders:
            self._m_slot_state.labels(state=SLOT_NATIVE).inc(
                len(self._builders)
            )
        # read at the moment the JAX package reads it; a failed build of
        # the host library raises from here
        lib = None if os.environ.get("GGRS_TPU_NO_NATIVE") else (
            _native.bank_lib()
        )
        if lib is not None and (
            int(lib.ggrs_bank_hdr_stride()) != _HDR_DTYPE.itemsize
            or int(lib.ggrs_bank_req_stride()) != _REQ_DTYPE.itemsize
            or int(lib.ggrs_bank_stage_stride()) != _STAGE_DTYPE.itemsize
        ):
            # the library is built from this checkout's csrc/host/ sources, so
            # a stride skew is a packed-table drift in this module
            raise RuntimeError(
                "bank table strides (hdr %d, req %d, stage %d) differ from "
                "BANK_HDR_FIELDS / BANK_REQ_FIELDS / BANK_STAGE_FIELDS"
                % (lib.ggrs_bank_hdr_stride(), lib.ggrs_bank_req_stride(),
                   lib.ggrs_bank_stage_stride())
            )
        # The bank runs every session's timers off ONE clock read per tick
        # (builder 0's clock): that is the pool's contract.  Builders whose
        # clocks are visibly on a different timebase (a frozen test clock
        # pooled with a real one reads hours apart) stay on the per-session
        # fallback, where each session honors its own clock.  Distinct
        # callables over the same timebase read within the tolerance and
        # pool fine.
        def same_timebase() -> bool:
            if not self._builders:
                return False
            first = self._builders[0][0]._clock
            t0 = first()
            for b, _ in self._builders:
                if b._clock is first:
                    continue
                if abs(b._clock() - t0) > 100:
                    return False
            return True

        hub_active = self._spectator_hub is not None and lib is not None
        eligible = lib is not None and same_timebase() and all(
            _bank_eligible(b, hub_active=hub_active)
            and hasattr(s, "receive_all_datagrams")
            for b, s in self._builders
        )
        if not eligible:
            for builder, socket in self._builders:
                self._sessions.append(builder.start_p2p_session(socket))
            self._stagers = [
                self._make_stager(i) for i in range(len(self._builders))
            ]
            return

        self._lib = lib
        self._bank = lib.ggrs_bank_new()
        if not self._bank:
            raise MemoryError("ggrs_bank_new failed")
        self._native_active = True
        self._hdr_stride = _HDR_DTYPE.itemsize
        self._req_stride = _REQ_DTYPE.itemsize
        self._vectorized = not os.environ.get("GGRS_TPU_NO_FASTPATH")
        # arm the in-crossing phase timers only when someone is tracing:
        # disarmed, the tick performs zero clock reads
        if self.tracer.enabled:
            lib.ggrs_bank_set_timing(self._bank, 1)
            self._trace_native = True
        from ..core.types import Remote, Spectator

        for builder, socket in self._builders:
            cfg = builder._config
            # builder-level validation parity (start_p2p_session's checks)
            for handle in range(builder._num_players):
                if handle not in builder._player_reg.handles:
                    raise InvalidRequest(
                        "Not enough players have been added. Keep registering "
                        "players up to the defined player number."
                    )
            local_handles = sorted(
                h for h, t in builder._player_reg.handles.items()
                if not isinstance(t, (Remote, Spectator))
            )
            arr = (ctypes.c_int32 * max(1, len(local_handles)))(*local_handles)
            idx = lib.ggrs_bank_add_session(
                self._bank, builder._num_players, cfg.native_input_size,
                builder._max_prediction, builder._fps,
                builder._disconnect_timeout_ms,
                builder._disconnect_notify_start_ms,
                arr, len(local_handles), builder._input_delay,
            )
            if idx < 0:
                raise RuntimeError(f"ggrs_bank_add_session failed: {idx}")
            mirror = _SessionMirror(
                cfg, socket, builder._num_players, builder._max_prediction,
                local_handles,
            )
            # endpoints: same address grouping, iteration order, and magic
            # draws as start_p2p_session -> PeerProtocol.__init__, so the
            # wire bytes (magic included) match the fallback bit-for-bit
            remote_by_addr: Dict[Any, List[int]] = {}
            for handle, ptype in builder._player_reg.handles.items():
                if isinstance(ptype, Remote):
                    remote_by_addr.setdefault(ptype.addr, []).append(handle)
            now = builder._clock()
            for addr, handles in remote_by_addr.items():
                rng = builder._rng if builder._rng is not None else (
                    random.Random()
                )
                magic = draw_magic(rng)
                handles = sorted(handles)
                harr = (ctypes.c_int32 * len(handles))(*handles)
                ep_idx = lib.ggrs_bank_add_endpoint(
                    self._bank, idx, magic, harr, len(handles), now
                )
                if ep_idx < 0:
                    raise RuntimeError(
                        f"ggrs_bank_add_endpoint failed: {ep_idx}"
                    )
                mirror.addr_to_ep[addr] = int(ep_idx)
                mirror.endpoints.append(
                    _EndpointMirror(addr, handles, magic,
                                    builder._num_players)
                )
            # builder-declared spectators (hub-owned relay): native fan-out
            # endpoints, created AFTER the remotes with the same rng draws
            # start_p2p_session would make, so the remote endpoints' magic
            # numbers — and hence the host's remote-facing wire bytes —
            # are bit-identical to the per-session baseline
            spectator_by_addr: Dict[Any, List[int]] = {}
            for handle, ptype in builder._player_reg.handles.items():
                if isinstance(ptype, Spectator):
                    spectator_by_addr.setdefault(ptype.addr, []).append(
                        handle
                    )
            for addr, handles in spectator_by_addr.items():
                rng = builder._rng if builder._rng is not None else (
                    random.Random()
                )
                magic = draw_magic(rng)
                sp_idx = lib.ggrs_bank_attach_spectator(
                    self._bank, idx, magic, now
                )
                if sp_idx < 0:
                    raise RuntimeError(
                        f"ggrs_bank_attach_spectator failed: {sp_idx}"
                    )
                mirror.addr_to_spec[addr] = int(sp_idx)
                mirror.spectators.append(
                    _SpectatorMirror(addr, magic, sorted(handles))
                )
            if mirror.spectators:
                self._m_spectators.labels(slot=str(idx)).set(
                    len(mirror.spectators)
                )
            # fast-path geometry: the status-mirror section's byte length
            # (u8 n_eps + per-endpoint u8 state + players*(u8,i64) + the
            # local players*(u8,i64) tail): the jump from the outbound
            # sections to the broadcast tail without a positional parse
            mirror.mirror_len = (
                1
                + len(mirror.endpoints) * (1 + 9 * mirror.num_players)
                + 9 * mirror.num_players
            )
            self._mirrors.append(mirror)
        self._clock = self._builders[0][0]._clock
        # output buffer sized to the worst realistic tick (rollback resim
        # descriptors + a full outbound volley per endpoint); a larger tick
        # grows it through one ggrs_bank_fetch_out crossing
        per_session = 0
        for m in self._mirrors:
            adv_bytes = m.num_players * (1 + m.input_size)
            per_session = max(
                per_session,
                4096
                + (m.max_prediction + 4) * (16 + adv_bytes)
                + len(m.endpoints) * (2048 + 32 * m.num_players)
                + len(m.spectators) * 2048
                + (m.max_prediction + 4) * (16 + adv_bytes),  # journal tap
            )
        self._out_buf = ctypes.create_string_buffer(
            max(1 << 16, per_session * len(self._mirrors)
                + (self._hdr_stride + self._req_stride)
                * len(self._mirrors))
        )
        # uniform pools (every mirror shares (players, input_size)) unlock
        # the executor's bulk input gather over the quiet rows
        self._uniform = len({
            (m.num_players, m.input_size) for m in self._mirrors
        }) == 1
        self._stagers = [
            self._make_stager(i) for i in range(len(self._mirrors))
        ]
        # ---- batched socket datapath (docs/DESIGN.md §15) ----
        # opt-in, per-slot, and failure is always a clean per-slot fallback
        # to the Python shuttle, never an error.  net_lib() is None when
        # the platform has no recvmmsg/sendmmsg or GGRS_TPU_NO_NATIVE_IO is
        # set.
        if self.native_io and _native.net_lib() is lib:
            for i, m in enumerate(self._mirrors):
                self._try_attach_io(i, m)
            # pump only when someone actually attached: with zero attached
            # slots the pump is semantically the tick but pays a per-tick
            # cmd re-parse for its pre-drain scan
            self._use_pump = any(self._io_attached)
        # batched outbound eligibility, after the io attach pass, so
        # NetBatch-attached slots (whose sends never re-enter Python) are
        # excluded
        self._send_fds = [None] * len(self._mirrors)
        self._ep_wire = [None] * len(self._mirrors)
        self._send_flags = [0] * len(self._mirrors)
        for i in range(len(self._mirrors)):
            self._refresh_send_fd(i)
        # ---- the one-crossing inbound drain, GSO, GRO (§23) ----
        # GSO posture: the env switch is applied once, process-wide (the
        # probe result itself is cached in the library); the per-feature
        # fallback matrix is reported by io_capabilities()
        lib.ggrs_net_set_gso(0 if os.environ.get("GGRS_TPU_NO_GSO") else -1)
        self._refresh_drain()
        # parallel slow-slot decode plane (§24): backend resolved once per
        # pool (env kill switch / force inside the constructor); "serial"
        # means the pool object exists for the capability matrix but every
        # decode stays on the inline _parse_slot reference
        if self._decode_pool is None and self._native_active:
            from .decode_pool import DecodePool

            self._decode_pool = DecodePool()

    def _refresh_send_fd(self, index: int) -> None:
        """(Re)compute slot ``index``'s native batched-outbound
        eligibility: an fd-backed, non-NetBatch-attached socket whose
        endpoint addresses resolve to (ipv4, port) sends through the
        one-crossing ``ggrs_net_send_table`` flush.  Everything else
        (in-memory networks, wrapped sockets, unresolvable addresses,
        non-Linux, ``GGRS_TPU_NO_NATIVE_IO``) keeps the Python batch and
        per-datagram paths."""
        if not self._send_fds:
            return
        self._send_fds[index] = None
        self._ep_wire[index] = None
        if self._send_flags:
            self._send_flags[index] = 0
        m = self._mirrors[index]
        if (
            not self._lib.ggrs_net_supported()
            or os.environ.get("GGRS_TPU_NO_NATIVE_IO")
            or self._io_attached[index]
        ):
            return
        fileno = getattr(m.socket, "fileno", None)
        if fileno is None:
            return
        try:
            fd = fileno()
        except Exception:
            return
        if not isinstance(fd, int) or fd < 0:
            return
        try:
            wire = [
                self._resolve_wire_addr(ep.addr) for ep in m.endpoints
            ]
        except (TypeError, ValueError, OSError):
            return
        self._send_fds[index] = fd
        self._ep_wire[index] = wire
        if self._send_flags and getattr(m.socket, "is_dispatch", False):
            # shared dispatch fd: a fatal errno on one record must fault
            # only the owning slot, so the native flush skips the record
            # instead of abandoning the co-tenants' run
            self._send_flags[index] = _native.NET_SEND_FLAG_DISPATCH

    @staticmethod
    def _resolve_wire_addr(addr) -> Tuple[int, int]:
        """(s_addr word, host-order port) for an ``(ipv4, port)`` tuple;
        raises for anything the native send table cannot address
        (hostnames, in-memory addresses): the caller keeps the Python
        send path."""
        host, port = addr
        packed = _pysocket.inet_aton(host)
        # "little" = host order: the native side stores this u32 straight
        # into sin_addr.s_addr, so the bytes must round-trip unchanged
        # (wire_common.h refuses to build on big-endian hosts)
        return int.from_bytes(packed, "little"), int(port)

    def _try_attach_io(self, index: int, m: _SessionMirror) -> None:
        """Attach one slot's socket to the native datapath: the fd must be
        a real one and every remote/spectator address must resolve to
        (ipv4, port).  Any miss leaves the slot on the Python shuttle."""
        lib = self._lib
        if getattr(m.socket, "is_dispatch", False):
            # shared dispatch fd (§23b): a whole-fd NetBatch attach would
            # couple co-tenant faults; dispatch slots ride the table
            # paths, whose per-record dispatch flag keeps §9 isolation
            return
        fileno = getattr(m.socket, "fileno", None)
        if fileno is None:
            return
        try:
            fd = fileno()
        except Exception:
            return
        if not isinstance(fd, int) or fd < 0:
            return
        try:
            eps = [
                (idx,) + self._resolve_wire_addr(addr)
                for addr, idx in m.addr_to_ep.items()
            ]
            sps = [
                (idx,) + self._resolve_wire_addr(addr)
                for addr, idx in m.addr_to_spec.items()
            ]
        except (TypeError, ValueError, OSError):
            return
        handle = lib.ggrs_net_attach(fd, 64)
        if not handle:
            return
        if lib.ggrs_bank_attach_socket(self._bank, index, handle) != 0:
            lib.ggrs_net_free(handle)
            return
        for idx, ip, port in eps:
            lib.ggrs_bank_map_addr(self._bank, index, 0, idx, ip, port)
        for idx, ip, port in sps:
            lib.ggrs_bank_map_addr(self._bank, index, 1, idx, ip, port)
        self._net_handles[index] = handle
        self._io_attached[index] = True
        self._io_live.append(index)

    def _refresh_drain(self) -> None:
        """(Re)build the gen-2 one-crossing inbound drain plan (§23a):
        the packed fd table (every SLOT_NATIVE, non-NetBatch-attached,
        fd-backed socket — dispatch hubs contribute their sibling fds
        once, marked slot ``-1``), the sorted (ip, port) -> slot route
        table the native demux binary-searches, and the per-slot wire
        maps the Python side uses to turn records into the cmd stream's
        ``(ep_idx, data)`` sections.  Any ineligible slot simply stays on
        the per-slot ``receive_all_datagrams`` reference drain — the
        per-feature fallback, never an error."""
        self._drain_ok = False
        if not self._finalized or not self._native_active:
            return
        # dispatch claims first, OUTSIDE the native gate: the hub's
        # reference Python demux needs them even when ggrs_net_recv_table
        # is unavailable (per-feature degradation)
        for i, m in enumerate(self._mirrors):
            sock = m.socket
            if getattr(sock, "is_dispatch", False) and hasattr(
                sock, "claim"
            ):
                for addr in m.addr_to_ep:
                    sock.claim(addr)
                for addr in m.addr_to_spec:
                    sock.claim(addr)
        lib = self._lib
        if (
            not lib.ggrs_net_supported()
            or os.environ.get("GGRS_TPU_NO_NATIVE_IO")
            or os.environ.get("GGRS_TPU_NO_RECV_TABLE")
        ):
            return
        n = len(self._mirrors)
        fd_rows: List[Tuple[int, int]] = []
        fd_fault: List[List[int]] = []
        route_rows: List[Tuple[int, int, int]] = []
        covered = [False] * n
        wire_maps: List[Optional[Dict]] = [None] * n
        deliver: Dict[int, Any] = {}  # slot -> hub view (pending queue)
        dispatch_idx: Dict[int, int] = {}  # shared fd -> fd table index
        hubs: List[Any] = []  # covered dispatch hubs (GRO candidates)
        for i, m in enumerate(self._mirrors):
            sock = m.socket
            if self._slot_state[i] != SLOT_NATIVE or self._io_attached[i]:
                # §9 on a SHARED fd: a quarantined/evicted co-tenant's
                # inbound still arrives on the hub socket the native
                # drain keeps reading — dropping its routes would starve
                # the Python-path session (its datagrams become
                # unroutable drops).  Keep its routes and deliver its
                # records into the view's pending queue, where the
                # evicted session's receive path already looks.
                if (
                    getattr(sock, "is_dispatch", False)
                    and self._slot_state[i] in (SLOT_QUARANTINED,
                                                SLOT_EVICTED)
                ):
                    try:
                        for addr in m.addr_to_ep:
                            ip, port = self._resolve_wire_addr(addr)
                            route_rows.append((ip, port, i))
                        for addr in m.addr_to_spec:
                            ip, port = self._resolve_wire_addr(addr)
                            route_rows.append((ip, port, i))
                    except (TypeError, ValueError, OSError):
                        continue
                    deliver[i] = sock
                continue
            fileno = getattr(sock, "fileno", None)
            if fileno is None:
                continue
            try:
                fd = fileno()
            except Exception:
                continue
            if not isinstance(fd, int) or fd < 0:
                continue
            try:
                wire: Dict[Tuple[int, int], Tuple[str, int]] = {}
                for addr, idx in m.addr_to_ep.items():
                    wire[self._resolve_wire_addr(addr)] = ("e", idx)
                for addr, idx in m.addr_to_spec.items():
                    wire[self._resolve_wire_addr(addr)] = ("s", idx)
            except (TypeError, ValueError, OSError):
                continue
            if getattr(sock, "is_dispatch", False):
                hub = getattr(sock, "hub", None)
                if hub is None:
                    continue
                for fd2 in hub.filenos():
                    at = dispatch_idx.get(fd2)
                    if at is None:
                        dispatch_idx[fd2] = len(fd_rows)
                        fd_rows.append((fd2, -1))
                        fd_fault.append([i])
                    elif i not in fd_fault[at]:
                        fd_fault[at].append(i)
                if hub not in hubs:
                    hubs.append(hub)
                for ip, port in wire:
                    route_rows.append((ip, port, i))
            else:
                fd_rows.append((fd, i))
                fd_fault.append([i])
            covered[i] = True
            wire_maps[i] = wire
        if not fd_rows:
            return
        pack = struct.pack
        route_rows.sort(key=lambda r: (r[0] << 16) | r[1])
        self._drain_fd_tab = b"".join(
            pack("<ii", fd, slot) for fd, slot in fd_rows
        )
        self._drain_route_tab = b"".join(
            pack("<IHHi", ip, port, 0, slot)
            for ip, port, slot in route_rows
        )
        self._drain_n_fds = len(fd_rows)
        self._drain_n_routes = len(route_rows)
        self._drain_fd_fault = fd_fault
        self._drain_covered = covered
        self._drain_covered_keys = [
            i for i, c in enumerate(covered) if c
        ]
        self._drain_wire = wire_maps
        self._drain_deliver = deliver
        # GRO (§23d): every covered hub's inbound is now drained by the
        # native recv table — which splits coalesced trains back into
        # wire datagrams — so it is safe, and ONLY now, to let the kernel
        # coalesce.  Hubs on the reference Python drain must never see
        # GRO (drain() reads into a RECV_BUFFER_SIZE buffer).  The
        # crossing's ring posture is process-wide, refreshed per plan
        # like the GSO posture in _finalize.
        gro_on = False
        if (
            hubs
            and not os.environ.get("GGRS_TPU_NO_GRO")
            and lib.ggrs_net_gro_supported()
        ):
            for hub in hubs:
                if hub.enable_gro():
                    gro_on = True
        self._gro_on = gro_on
        lib.ggrs_net_set_gro(1 if gro_on else 0)
        if self._drain_recs is None:
            # a GRO drain can legally turn ONE message into 64 records /
            # 64 KiB of slab, and the crossing reserves that worst case
            # before each syscall — size the buffers so the reserve never
            # clamps a recvmmsg below the ring's full 64-message window
            # (recs: 64 msgs x 64 segs; slab: 64 msgs x 64 KiB = 4 MiB),
            # else an armed drain batches WORSE than the plain ring on
            # traffic the kernel happens not to coalesce
            if gro_on:
                self._drain_recs_cap = max(4096, 4 * len(fd_rows))
                self._drain_slab_cap = max(4 << 20, 4096 * len(fd_rows))
            else:
                self._drain_recs_cap = max(256, 4 * len(fd_rows))
                self._drain_slab_cap = max(1 << 18, 4096 * len(fd_rows))
            self._drain_recs = ctypes.create_string_buffer(
                self._drain_recs_cap * _native.NET_RECV_STRIDE
            )
            self._drain_slab = ctypes.create_string_buffer(
                self._drain_slab_cap
            )
        self._drain_ok = True

    def _drain_inbound(self) -> Optional[Dict[int, Tuple[list, list]]]:
        """The gen-2 inbound drain: ONE ctypes crossing pulls every
        covered slot's pending datagrams (recvmmsg per fd, dispatch demux
        in C) and this routine walks the packed record table once to
        build each slot's ``(datagrams, spec_datagrams)`` cmd sections —
        zero per-slot Python calls.  A fatal recv errno faults exactly
        the owning slot(s) BEFORE the tick snapshot, so the faulted slot
        skips this tick (§9); the drain itself never raises.  Returns
        None when the drain plan is stale/disabled (caller falls back to
        the reference per-slot drain)."""
        if not self._drain_ok:
            return None
        lib = self._lib
        nb = len(_native.IO_BATCH_BUCKETS) + 1
        # every covered slot gets a key (the consumer reads membership as
        # "already drained" — a missing key would re-drain the socket on
        # the shuttle path); the two lists are allocated only for slots
        # with traffic this tick
        out: Dict[int, Optional[Tuple[list, list]]] = dict.fromkeys(
            self._drain_covered_keys
        )
        stats = (ctypes.c_uint64 * _native.NET_RECV_TABLE_STATS)()
        fatal = (ctypes.c_int32 * 64)()
        n_fatal = ctypes.c_int32(0)
        wire_maps = self._drain_wire
        # local snapshot: a fault below triggers _refresh_drain(), which
        # REPLACES these tables — the indices in this call's record/fatal
        # buffers refer to the plan the crossing actually ran against
        fault_map = self._drain_fd_fault
        deliver = self._drain_deliver
        for _round in range(8):  # regrow-and-continue bound (backpressure)
            ctypes.memset(stats, 0, ctypes.sizeof(stats))
            n_recs = lib.ggrs_net_recv_table(
                self._drain_fd_tab, self._drain_n_fds,
                self._drain_route_tab, self._drain_n_routes,
                self._drain_recs, self._drain_recs_cap,
                self._drain_slab, self._drain_slab_cap,
                stats, fatal, 32, ctypes.byref(n_fatal),
            )
            self.drain_crossings += 1
            if n_recs < 0:
                # builder bug (corrupt tables): disable the drain and let
                # this tick run the reference path rather than poison it
                self._drain_ok = False
                return None
            slab = self._drain_slab
            if n_recs:
                # one vectorized parse of the record table, then plain-int
                # column lists for the routing walk (a B=512 dispatch pool
                # sees ~2B records per tick — per-record unpack_from was
                # the walk's hottest line)
                arr = np.frombuffer(
                    self._drain_recs, dtype=_RECV_DTYPE, count=n_recs
                )
                slot_l = arr["slot"].tolist()
                ip_l = arr["ip"].tolist()
                port_l = arr["port"].tolist()
                off_l = arr["off"].tolist()
                len_l = arr["len"].tolist()
            for k in range(n_recs):
                slot = slot_l[k]
                ip = ip_l[k]
                port = port_l[k]
                off = off_l[k]
                wire = wire_maps[slot]
                if wire is None:
                    # quarantined/evicted co-tenant on a shared hub: hand
                    # the record to the view's pending queue — the slot's
                    # Python session drains it exactly where the hub's
                    # reference demux would have put it
                    view = deliver.get(slot)
                    if view is not None:
                        src = (
                            _pysocket.inet_ntoa(ip.to_bytes(4, "little")),
                            port,
                        )
                        view._pending.append(
                            (src, slab[off:off + len_l[k]])
                        )
                    continue
                dst = wire.get((ip, port))
                if dst is None:
                    continue  # unknown source: the reference drain's drop
                kind, idx = dst
                data = slab[off:off + len_l[k]]
                entry = out[slot]
                if entry is None:
                    entry = out[slot] = ([], [])
                if kind == "e":
                    entry[0].append((idx, data))
                else:
                    entry[1].append((idx, data))
            t = self._drain_totals
            t["recv_calls"] += int(stats[0])
            t["datagrams"] += int(stats[1])
            t["unroutable"] += int(stats[2])
            t["backpressure_stops"] += int(stats[3])
            # the GRO tail lives at words [12..13], after the histogram
            t["gro_datagrams"] += int(stats[12])
            t["gro_segments"] += int(stats[13])
            for b in range(nb):
                self._drain_hist[b] += int(stats[4 + b])
            if self._obs_on:
                self._m_drain_crossings.inc()
                if stats[1]:
                    self._m_drain_dgrams.inc(int(stats[1]))
                if stats[2]:
                    self._m_drain_unroutable.inc(int(stats[2]))
                hist = getattr(self._m_drain_batch, "_default", None)
                if hist is not None and stats[0]:
                    for b in range(nb):
                        hist.counts[b] += int(stats[4 + b])
                    hist.count += int(stats[0])
                    hist.sum += int(stats[1])
            for k in range(min(int(n_fatal.value), 32)):
                fd_idx = fatal[2 * k]
                err = fatal[2 * k + 1]
                for slot in fault_map[fd_idx]:
                    self._on_slot_fault(
                        slot, _native.BANK_ERR_IO,
                        f"batched inbound drain errno {err}",
                    )
            if int(n_fatal.value):
                # supervision transitions invalidated the plan (and the
                # faulted slots must not be re-drained this tick)
                break
            if not int(stats[3]):
                break
            # backpressure: the kernel still holds datagrams — double the
            # record/slab capacity and keep draining (appending)
            self._drain_recs_cap *= 2
            self._drain_recs = ctypes.create_string_buffer(
                self._drain_recs_cap * _native.NET_RECV_STRIDE
            )
            self._drain_slab_cap *= 2
            self._drain_slab = ctypes.create_string_buffer(
                self._drain_slab_cap
            )
        return out

    def io_capabilities(self) -> Dict[str, bool]:
        """The gen-2 per-feature capability/fallback matrix (§23): which
        datapath tiers THIS pool can use right now.  Every False here is
        a per-feature fallback to the tier below, never an error."""
        lib = self._lib
        native = bool(
            lib is not None
            and lib.ggrs_net_supported()
            and not os.environ.get("GGRS_TPU_NO_NATIVE_IO")
        )
        return {
            "native_io": native,
            "recv_table": bool(
                native and not os.environ.get("GGRS_TPU_NO_RECV_TABLE")
            ),
            "send_table": native,
            "dispatch": any(
                getattr(m.socket, "is_dispatch", False)
                for m in self._mirrors
            ),
            "reuseport": hasattr(_pysocket, "SO_REUSEPORT"),
            "gso": bool(
                native
                and lib.ggrs_net_gso_supported()
                and not os.environ.get("GGRS_TPU_NO_GSO")
            ),
            # kernel probe ok + not killed; _gro_on says whether THIS
            # pool actually armed it (needs a covered dispatch hub)
            "gro": bool(
                native
                and lib.ggrs_net_gro_supported()
                and not os.environ.get("GGRS_TPU_NO_GRO")
            ),
            "gro_active": self._gro_on,
            # parallel slow-slot decode plane (§24): backend the pool's
            # DecodePool resolved ("serial" is the bit-identical
            # fallback; the kill switch forces it)
            "parallel_decode": bool(
                self._decode_pool is not None
                and self._decode_pool.backend != "serial"
            ),
            "decode_backend": (
                self._decode_pool.backend
                if self._decode_pool is not None else "serial"
            ),
        }

    @staticmethod
    def _io_words_to_dict(words) -> Dict[str, Any]:
        """One NetBatch counter dump (22 u64s) as the scrape's io-record
        shape."""
        nf = len(_native.IO_STAT_FIELDS)
        nb = len(_native.IO_BATCH_BUCKETS) + 1
        io: Dict[str, Any] = dict(zip(_native.IO_STAT_FIELDS, words[:nf]))
        io["recv_batches"] = list(words[nf:nf + nb])
        io["send_batches"] = list(words[nf + nb:nf + 2 * nb])
        return io

    def _detach_io(self, index: int) -> None:
        """Per-slot automatic fallback: return the slot to the Python
        shuttle (eviction, or a late-attached spectator address the
        native side cannot route) and release its NetBatch.  The final
        counter snapshot is retained (and folded into the registry) so
        ``io_stats()`` totals never regress across a detach."""
        if not self._io_attached[index]:
            return
        self._lib.ggrs_bank_detach_socket(self._bank, index)
        self._io_attached[index] = False
        if index in self._io_live:
            self._io_live.remove(index)
        handle = self._net_handles[index]
        self._net_handles[index] = None
        if handle:
            words = (ctypes.c_uint64 * _native.IO_STAT_WORDS)()
            self._lib.ggrs_net_stats(handle, words)
            io = self._io_words_to_dict(list(words))
            self._io_final[index] = io
            # flush the tail accrued since the last scrape into the
            # registry counters before the source disappears
            self._apply_io_metrics([dict(index=index, io=io)])
            self._lib.ggrs_net_free(handle)
        # drop the slot's delta-tracking keys: a later attach on this fd
        # (e.g. the match re-admitted on a destination pool) starts its
        # NetBatch counters at zero, and stale high-water marks here would
        # silently swallow its deltas — the classic re-attach leak
        for k in [k for k in self._io_prev if k[0] == index]:
            del self._io_prev[k]
        if not any(self._io_attached):
            # last attached slot gone: drop back to the plain tick entry
            # (the pump's pre-drain scan would walk the cmd for nothing)
            self._use_pump = False
        # the slot is back on the Python shuttle: it may now qualify for
        # the batched one-crossing outbound flush and the gen-2 batched
        # inbound drain instead
        self._refresh_send_fd(index)
        self._refresh_drain()

    # ------------------------------------------------------------------
    # per-tick API
    # ------------------------------------------------------------------

    @property
    def native_active(self) -> bool:
        if not self._finalized:
            self._finalize()
        return self._native_active

    def __len__(self) -> int:
        return len(self._builders)

    def _make_stager(self, index: int):
        """One slot's input-staging dispatch (the B-proportional staging
        walk fix): the slot-state branch and the
        handle→slot validation are resolved HERE, once per supervision
        transition, instead of on every ``add_local_input`` call.  The
        returned callable is what ``add_local_input`` (and the per-item
        fallback of ``stage_inputs``) invokes."""
        state = self._slot_state[index]
        if state in (SLOT_DEAD, SLOT_MIGRATED):
            def drop(handle, value):
                return  # dead/migrated: accept and drop (nothing ticks)
            return drop
        if not self._native_active:
            return self._sessions[index].add_local_input
        if state == SLOT_EVICTED:
            return self._evicted[index].add_local_input
        m = self._mirrors[index]
        local_set = m.local_handle_set
        staged = m.staged_inputs
        encode = m.encode

        def stage(handle, value):
            if handle not in local_set:
                raise InvalidRequest(
                    "The player handle you provided is not referring to a "
                    "local player."
                )
            staged[handle] = encode(value)

        return stage

    def add_local_input(self, index: int, handle: int, value) -> None:
        if not self._finalized:
            self._finalize()
        self._stagers[index](handle, value)

    def stage_inputs(self, items) -> None:
        """Batched input staging (descriptor plane, DESIGN.md §21): stage
        many ``(session_index, handle, value)`` local inputs in ONE native
        crossing per pool tick instead of B ``add_local_input`` calls.

        On the native descriptor path the encoded blobs go straight into
        the bank via ``ggrs_bank_stage_inputs`` — one packed fixed-stride
        table plus a joined payload (a jump table) — and the
        tick's command stream carries a flag byte per slot instead of the
        inline input bytes.  Slots that are not bank-resident (evicted,
        dead, the whole-pool Python fallback) route through their per-slot
        stager, so the call is always semantically ``add_local_input`` per
        item.  Per slot per tick, inputs must come entirely through ONE
        mechanism — ``add_local_input`` staging after ``stage_inputs`` for
        the same slot makes the inline path win and drops the native
        staging for that slot (both sides discard it in lockstep)."""
        if not self._finalized:
            self._finalize()
        if not self._native_active:
            stagers = self._stagers
            for index, handle, value in items:
                stagers[index](handle, value)
            return
        mirrors = self._mirrors
        slot_state = self._slot_state
        slots: List[int] = []
        handles: List[int] = []
        blobs: List[bytes] = []
        lens: List[int] = []
        # pass 1: validate + encode EVERYTHING before any state mutates —
        # a bad item mid-list must leave the pool exactly as it was (a
        # partially-updated staged_native set would make the next
        # advance_all emit kFlagStaged for a slot the bank never staged,
        # poisoning the whole pool with kBankErrCmd)
        for index, handle, value in items:
            if slot_state[index] != SLOT_NATIVE:
                self._stagers[index](handle, value)
                continue
            m = mirrors[index]
            if handle not in m.local_handle_set:
                raise InvalidRequest(
                    "The player handle you provided is not referring to a "
                    "local player."
                )
            blob = m.encode(value)
            if len(blob) != m.input_size:
                raise InvalidRequest(
                    f"encoded input is {len(blob)} bytes but slot "
                    f"{index}'s input size is {m.input_size}"
                )
            slots.append(index)
            handles.append(handle)
            blobs.append(blob)
            lens.append(len(blob))
        n = len(slots)
        if not n:
            return
        desc = np.empty(n, _STAGE_DTYPE)
        desc["slot"] = slots
        desc["handle"] = handles
        desc["frame"] = NULL_FRAME
        lens_arr = np.asarray(lens, np.uint32)
        desc["len"] = lens_arr
        offs = np.zeros(n, np.uint32)
        np.cumsum(lens_arr[:-1], out=offs[1:])
        desc["off"] = offs
        payload = b"".join(blobs)
        rc = self._lib.ggrs_bank_stage_inputs(
            self._bank, desc.ctypes.data, n, payload, len(payload)
        )
        if rc < 0:
            # should be unreachable after the validation above (a native
            # reject means this builder drifted from the bank): drop the
            # Python-side membership so the next tick takes the inline
            # path — the bank discards its partial staging on
            # !kFlagStaged — instead of a poisoned kFlagStaged cmd
            for index in slots:
                mirrors[index].staged_native.clear()
            raise InvalidRequest(
                f"ggrs_bank_stage_inputs rejected the staging table "
                f"({rc}): slot/handle/length mismatch"
            )
        for index, handle in zip(slots, handles):
            mirrors[index].staged_native.add(handle)

    def advance_all(self) -> List[List[GgrsRequest]]:
        """Run every session's tick (poll + advance); returns the B request
        lists in session order.  Native path: exactly one ctypes crossing
        for every bank-resident slot; evicted slots tick their Python
        session; quarantined/dead slots return empty lists."""
        if not self._finalized:
            self._finalize()
        if not self._native_active:
            return self._advance_all_fallback()
        self._check_valid()
        self._tick_no += 1
        self._m_ticks.inc()
        tracer = self.tracer
        tracing = tracer.enabled
        t_tick = tracer.now_ns() if tracing else 0

        pack = struct.pack
        # validate EVERY bank-resident session's staged inputs before any
        # destructive step (ctrl-op swap, socket drain): raising mid-build
        # would silently lose pending disconnect ops and drained datagrams
        # on a caller retry.  (Evicted sessions enforce their own contract.)
        # A slot's inputs come through ONE mechanism per tick: the inline
        # staged dict (add_local_input) when non-empty, else the native
        # staging set (stage_inputs, §21) when complete.
        use_staged: List[bool] = [False] * len(self._mirrors)
        for i, m in enumerate(self._mirrors):
            state = self._slot_state[i]
            if state == SLOT_EVICTED:
                # same pre-crossing check for evicted sessions: their
                # advance_frame raising AFTER the bank crossing would lose
                # the healthy slots' request lists for this tick
                self._evicted[i].validate_local_inputs()
                continue
            if state not in (SLOT_NATIVE, SLOT_QUARANTINED):
                continue
            if not m.local_handles:
                continue  # nothing to stage: the inline path sends the
                # plain flag byte with zero input bytes, as always
            if m.staged_inputs:
                for handle in m.local_handles:
                    if handle not in m.staged_inputs:
                        raise InvalidRequest(
                            f"Missing local input for handle {handle} "
                            "while calling advance_frame()."
                        )
                if m.staged_native:
                    # inline wins: the native copy is stale and the bank
                    # drops it at slot-tick start on the !kFlagStaged path
                    m.staged_native.clear()
            elif len(m.staged_native) == len(m.local_handles):
                use_staged[i] = True
            else:
                missing = next(
                    h for h in m.local_handles
                    if h not in m.staged_native
                )
                raise InvalidRequest(
                    f"Missing local input for handle {missing} while "
                    "calling advance_frame()."
                )
        # the one-crossing inbound drain (§23): ONE crossing drains every
        # covered fd-backed socket BEFORE the tick snapshot; a fatal recv
        # errno faults the owning slot(s) here, so they skip this tick
        if self._drain_ok:
            _dt0 = time.perf_counter_ns()
            drained = self._drain_inbound()
            self.drain_ns += time.perf_counter_ns() - _dt0
        else:
            drained = None
        # snapshot which slots the bank steps this tick: the parse below
        # must use the build-time view even if new faults land mid-parse
        ticked = [s == SLOT_NATIVE for s in self._slot_state]
        cmd_parts: List[bytes] = []
        for i, m in enumerate(self._mirrors):
            if not ticked[i]:
                cmd_parts.append(_CMD_SKIP)  # no fields follow
                continue
            if use_staged[i]:
                # batched staging (§21): the bank already holds this
                # slot's input bytes — the cmd carries only the flag
                cmd_parts.append(_CMD_STAGED)
            else:
                cmd_parts.append(_CMD_INPUTS)
                cmd_parts.extend(
                    m.staged_inputs[h] for h in m.local_handles
                )
            ctrl = m.pending_ctrl
            m.pending_ctrl = []
            inj = self._inject_err.pop(i, None)
            if inj is not None:
                ctrl = ctrl + [(2, 0, inj)]  # op 2: simulated slot fault
            cmd_parts.append(pack("<H", len(ctrl)))
            for op, ep_idx, frame in ctrl:
                cmd_parts.append(pack("<BHq", op, ep_idx, frame))
            datagrams = []
            spec_datagrams = []
            if drained is not None and i in drained:
                # this slot's inbound was already pulled by the one-crossing
                # drain above: routed record table, zero per-slot Python
                # calls (None = covered, no traffic)
                rec = drained[i]
                if rec is not None:
                    datagrams, spec_datagrams = rec
            elif not self._io_attached[i]:
                # the Python shuttle: drain + route per datagram here (a
                # datagram from an unknown address is dropped, as a
                # session's receive path drops it).  Attached slots drain
                # INSIDE the crossing (recvmmsg): only injected chaos
                # traffic rides the cmd sections.
                addr_to_spec = m.addr_to_spec
                for from_addr, data in m.socket.receive_all_datagrams():
                    ep_idx = m.addr_to_ep.get(from_addr)
                    if ep_idx is not None:
                        datagrams.append((ep_idx, data))
                    elif addr_to_spec:
                        sp_idx = addr_to_spec.get(from_addr)
                        if sp_idx is not None:
                            spec_datagrams.append((sp_idx, data))
            datagrams.extend(self._inject_dgrams.pop(i, ()))
            cmd_parts.append(pack("<H", len(datagrams)))
            for ep_idx, data in datagrams:
                cmd_parts.append(pack("<HI", ep_idx, len(data)))
                cmd_parts.append(data)
            # inbound viewer traffic (acks, quality, keep-alives, sync
            # probes) rides the SAME crossing
            cmd_parts.append(pack("<H", len(spec_datagrams)))
            for sp_idx, data in spec_datagrams:
                cmd_parts.append(pack("<HI", sp_idx, len(data)))
                cmd_parts.append(data)
        cmd = b"".join(cmd_parts)

        self.crossings += 1
        self._m_cross_tick.inc()
        t_cross = tracer.now_ns() if tracing else 0
        # the pump is the tick crossing plus native socket I/O for attached
        # slots: still exactly ONE crossing per pool tick
        crossing = (
            self._lib.ggrs_bank_pump if self._use_pump
            else self._lib.ggrs_bank_tick
        )
        rc = crossing(
            self._bank, self._clock(), cmd, len(cmd),
            self._out_buf, len(self._out_buf), ctypes.byref(self._out_len),
        )
        if rc == _native.BANK_ERR_BUFFER_TOO_SMALL:
            # kErrBufferTooSmall: the tick RAN and its output is
            # retained natively — grow and fetch (the one case that costs a
            # second crossing, e.g. a stalled peer's whole-window volley)
            self._out_buf = ctypes.create_string_buffer(
                max(self._out_len.value, 2 * len(self._out_buf))
            )
            rc = self._lib.ggrs_bank_fetch_out(
                self._bank, self._out_buf, len(self._out_buf),
                ctypes.byref(self._out_len),
            )
        if tracing:
            # the crossing span, then the native per-phase timings laid
            # end-to-end inside it (they were measured inside this very
            # window, so they nest under it and sum to the in-crossing
            # time; the gap to the crossing span is pure ctypes overhead)
            dur = tracer.now_ns() - t_cross
            tracer.add_complete("bank.crossing", t_cross, dur, cat="native",
                                args={"tick": self._tick_no})
            if self._trace_native and rc == 0:
                off = t_cross
                phases = self._parse_timing_tail()
                for name, ns in phases:
                    if name == "staging":
                        # staging accrued OUTSIDE the tick window (the
                        # stage_inputs crossings since the last tick): a
                        # sibling span ending at the crossing start, never
                        # nested inside it — the in-crossing phases still
                        # sum to the measured crossing time
                        if ns:
                            tracer.add_complete(
                                "bank.staging", t_cross - ns, ns,
                                cat="native",
                            )
                        continue
                    if ns:
                        tracer.add_complete(
                            f"bank.{name}", off, ns, cat="native"
                        )
                    off += ns
                self._last_phase_ns = dict(phases)
        if rc != 0:
            # the only whole-bank failure left is a malformed command stream
            # (a bug in THIS builder, no per-session blame possible)
            self._invalid = f"ggrs_bank_tick failed: {rc}"
            raise RuntimeError(self._invalid)
        # decode: the descriptor plane's lazy RequestPlan by default
        # (classification AND request programs read from the two flat
        # tables, request objects only materialized on demand); the
        # reference sequential parse under tracing (the per-slot spans ARE
        # the point) and under GGRS_TPU_NO_FASTPATH
        if self._vectorized and not tracing:
            request_lists, retire_mask = self._parse_output_plan(ticked)
            self._plan = request_lists
        else:
            request_lists = self._parse_output(ticked)
            retire_mask = None
            self._plan = None
        self._supervise(request_lists, retire_mask)
        if tracing:
            tracer.add_complete("pool.tick", t_tick,
                                tracer.now_ns() - t_tick, cat="py")
        self.last_tick_at = time.monotonic()
        return request_lists

    def _parse_timing_tail(self) -> List[Tuple[str, int]]:
        """The tick output's timing tail: ``(phase, ns)`` pairs in bank
        order.  The count byte sits LAST so the tail parses from the end
        of the buffer, independent of the session records before it."""
        end = self._out_len.value
        n_ph = self._out_buf[end - 1][0]
        vals = struct.unpack_from(
            f"<{n_ph}Q", self._out_buf, end - 1 - 8 * n_ph
        )
        return list(zip(_phase_names(n_ph), vals))

    def _parse_output(self, ticked: List[bool]) -> List[List[GgrsRequest]]:
        """Reference sequential parse: every slot's body record, in order.
        The reference decoder (the descriptor plane is held bit-identical
        to it) and the tracing-mode parse: per-slot spans are the point of
        a traced tick."""
        buf = memoryview(self._out_buf).cast("B")[: self._out_len.value]
        n = len(self._mirrors)
        pos = n * (self._hdr_stride + self._req_stride)
        request_lists: List[List[GgrsRequest]] = []
        tracer = self.tracer
        tracing = tracer.enabled
        # parallel decode plane (§24): with the header table's rec_len jump
        # chain every slot's byte range is known up front, so this path
        # fans ALL slots across the DecodePool.  A TRACED pool stays on the
        # interleaved reference decoder: per-slot spans are the point of
        # tracing, and fanning the byte walk out would destroy that
        # attribution.
        decs = None
        if not tracing and n > 1:
            hdr = np.frombuffer(self._out_buf, dtype=_HDR_DTYPE, count=n)
            offs = np.empty(n, np.int64)
            offs[0] = pos
            offs[1:] = pos + np.cumsum(hdr["rec_len"][:-1], dtype=np.int64)
            decs = self._decode_slow_slots(
                buf, list(range(n)), offs.tolist(), ticked
            )
        for idx in range(n):
            t_slot = tracer.now_ns() if tracing else 0
            if decs is not None:
                requests, pos, current = self._apply_slot(
                    decs[idx], idx, ticked[idx]
                )
            else:
                requests, pos, current = self._parse_slot(
                    buf, pos, idx, ticked[idx]
                )
            request_lists.append(requests)
            if tracing:
                tracer.add_complete(
                    "pool.slot", t_slot, tracer.now_ns() - t_slot,
                    cat="py", args={"slot": idx, "frame": current},
                )
        return request_lists

    def _parse_output_plan(self, ticked: List[bool]):
        """Descriptor-plane tick decode (DESIGN.md §21): classify all B
        slots from the packed header table AND read their request
        programs from the request descriptor table — both flat NumPy
        views — then run only the irreducible per-slot work (outbound
        sends, journal taps, the wait-recommendation policy, frame mirrors)
        for fast slots, constructing ZERO request objects for
        them.  The returned :class:`RequestPlan` materializes a slot's
        pooled ``GgrsRequest`` list only when indexed;
        ``BatchedRequestExecutor`` consumes the descriptor columns
        directly instead.

        Outbound is batched (§21c): fast slots' datagrams go out through
        one ``send_datagram_batch`` call per slot (in-memory / batchable
        sockets), or ride ONE ``ggrs_net_send_table`` crossing for the
        whole tick (fd-backed sockets that are not NetBatch-attached): the
        send-table payload is the tick output buffer itself, zero
        copies.  Per-socket send order is unchanged (records stay in slot
        order); slow slots keep the reference per-datagram path.

        Returns ``(plan, retire_mask)`` like the legacy fast path."""
        mirrors = self._mirrors
        n = len(mirrors)
        plan = RequestPlan(self, n)
        if n == 0:
            return plan, None
        hdr = np.frombuffer(self._out_buf, dtype=_HDR_DTYPE, count=n)
        req = np.frombuffer(self._out_buf, dtype=_REQ_DTYPE, count=n,
                            offset=n * self._hdr_stride)
        flags = hdr["flags"]
        pattern = req["pattern"]
        fast = (flags & _HDR_FAST_MASK) == _HDR_FAST_WANT
        # a fast slot must also carry a CLASSIFIED request program —
        # kReqOther (frame-0 double save, future shapes) takes the
        # reference decoder so a wrong descriptor can never be consumed
        fast &= pattern != _native.REQ_OTHER
        base = n * (self._hdr_stride + self._req_stride)
        rec_len = hdr["rec_len"]
        offs = np.empty(n, np.int64)
        offs[0] = base
        if n > 1:
            offs[1:] = base + np.cumsum(rec_len[:-1], dtype=np.int64)
        out_len = self._out_len.value
        plan.buffer = np.frombuffer(self._out_buf, np.uint8, count=out_len)
        plan.uniform = self._uniform
        m0 = mirrors[0]
        plan.players = m0.num_players
        plan.input_size = m0.input_size
        # the plan retains the per-slot offsets/liveness until the next
        # advance_all: keep them as the numpy arrays (compact) and take
        # throwaway int lists only for the hot loops below
        plan.offs_l = offs
        offs_l = offs.tolist()
        fast_l = fast.tolist()
        plan.live_l = fast
        self.plan_ticks += 1
        n_fast = int(np.count_nonzero(fast))
        if n_fast == 0:
            # nothing fast this tick (fault storm, first tick's frame-0
            # shapes): sequential reference parse of every slot — cheaper
            # than the column extraction + two-pass walk below when every
            # slot is slow anyway
            buf = memoryview(self._out_buf).cast("B")[:out_len]
            decs = self._decode_slow_slots(
                buf, list(range(n)), offs_l, ticked
            )
            for idx in range(n):
                if decs is not None:
                    reqs, _, _ = self._apply_slot(
                        decs[idx], idx, ticked[idx]
                    )
                else:
                    reqs, _, _ = self._parse_slot(
                        buf, offs_l[idx], idx, ticked[idx]
                    )
                plan.lists[idx] = reqs
                plan.eager_rows.append(idx)
            self.desc_slow_slots += n
            plan.quiet_rows = np.empty(0, np.int64)
            plan.quiet_frames = np.empty(0, np.int64)
            plan.quiet_offs = np.empty(0, np.int64)
            plan.quiet_adv_off = np.empty(0, np.int64)
            retire_mask = None
            if self.retire_dead_matches:
                retire_mask = [True] * n  # every slot was slow-parsed
            return plan, retire_mask

        # executor-facing columns (views into this tick's tables — valid,
        # like the plan itself, until the next advance_all)
        quiet = fast & (pattern == _native.REQ_QUIET)
        plan.quiet_rows = np.flatnonzero(quiet)
        plan.quiet_frames = req["frame"][quiet]
        plan.quiet_offs = offs[quiet]
        plan.quiet_adv_off = req["adv_off"][quiet].astype(np.int64)

        # request-kind metrics, vectorized from the descriptor columns
        # (eager slots count inside _parse_slot as before)
        resim = fast & (pattern == _native.REQ_RESIM)
        save_only = fast & (pattern == _native.REQ_SAVE_ONLY)
        trailing = (req["rflags"] & _native.REQ_FLAG_TRAILING_ADV) != 0
        n_adv_col = req["n_adv"].astype(np.int64)
        n_quiet = int(plan.quiet_rows.size)
        n_resim = int(np.count_nonzero(resim))
        n_save = n_quiet + int(np.count_nonzero(save_only)) + int(
            (n_adv_col[resim] - trailing[resim]).sum()
        )
        n_adv_total = n_quiet + int(n_adv_col[resim].sum())
        if n_save:
            self._m_req_save.inc(n_save)
        if n_resim:
            self._m_req_load.inc(n_resim)
            self._m_rollbacks.inc(n_resim)
        if n_adv_total:
            self._m_req_advance.inc(n_adv_total)

        buf = memoryview(self._out_buf).cast("B")[:out_len]
        fa_l = hdr["fa"].tolist()
        cur_l = hdr["current"].tolist()
        conf_l = hdr["confirmed"].tolist()
        flags_l = flags.tolist()
        pattern_l = pattern.tolist()
        trailing_l = trailing.tolist()
        ops_end_l = req["ops_end"].tolist()
        # plain-int columns once, not per-row structured indexing (resim
        # ticks visit hundreds of rows on a rollback-heavy pool)
        rframe_l = req["frame"].tolist()
        n_adv_l = req["n_adv"].tolist()
        adv_off_l = req["adv_off"].tolist()
        adv_stride_l = req["adv_stride"].tolist()
        CONF = _native.BANK_HDR_CONF
        unpack_from = struct.unpack_from
        recorders = self._recorders
        lists = plan.lists
        eager = plan.eager_rows

        # ---- pass 1: eager slots through the reference decoder; fast
        # slots' outbound staged/sent + per-slot pass-2 work queued ----
        table_rows: List[Tuple[int, int, int, int, int]] = []  # native tbl
        table_slots: List[int] = []
        pass2: List[Tuple[int, int]] = []  # (slot, pos after out sections)
        flush_failed: Dict[int, Tuple[int, str]] = {}  # slot -> code, msg
        # parallel decode plane (§24): every slow slot's byte range is known
        # up front (the offs jump chain), so their pure decode fans out
        # across the DecodePool BEFORE the slot walk; the walk below then
        # applies each decoded record in slot order, interleaved with the
        # fast slots exactly where the serial decoder ran: side-effect order
        # is untouched because decode is pure
        slow_rows = [idx for idx in range(n) if not fast_l[idx]]
        decs = self._decode_slow_slots(buf, slow_rows, offs_l, ticked)
        for idx in range(n):
            if not fast_l[idx]:
                if decs is not None:
                    requests, _, _ = self._apply_slot(
                        decs[idx], idx, ticked[idx]
                    )
                else:
                    requests, _, _ = self._parse_slot(
                        buf, offs_l[idx], idx, ticked[idx]
                    )
                lists[idx] = requests
                eager.append(idx)
                continue
            m = mirrors[idx]
            off = offs_l[idx]
            pos = off + ops_end_l[idx]
            rec = recorders[idx] if recorders else None
            fd = self._send_fds[idx]
            wire = self._ep_wire[idx]
            batch: Optional[List[Tuple[Any, Any]]] = (
                [] if (fd is None and m.send_batch is not None) else None
            )
            send_raw = m.send_raw
            endpoints = m.endpoints
            failed: Optional[str] = None
            for _section in (0, 1):
                (n_out,) = unpack_from("<H", buf, pos)
                pos += 2
                for _ in range(n_out):
                    ep_idx, dlen = unpack_from("<HI", buf, pos)
                    pos += 6
                    if failed is not None:
                        pos += dlen
                        continue
                    if rec is not None:
                        # forensics caveat: on the BATCHED tiers the
                        # flush outcome is only known after the whole
                        # slot staged, so a mid-flush fatal leaves EV_WIRE
                        # entries for datagrams that never hit the wire —
                        # always bounded by the EV_FAULT marker the flush
                        # failure records right after them
                        rec.record(
                            self._tick_no, EV_WIRE,
                            (ep_idx, dlen,
                             zlib.crc32(buf[pos : pos + dlen])),
                        )
                    if fd is not None:
                        # native send table: the datagram bytes stay in
                        # the output buffer; only (fd, addr, off, len) is
                        # recorded — flushed once for the whole tick
                        ip, port = wire[ep_idx]
                        table_rows.append((fd, ip, port, pos, dlen))
                        table_slots.append(idx)
                    elif batch is not None:
                        batch.append(
                            (buf[pos : pos + dlen], endpoints[ep_idx].addr)
                        )
                    else:
                        try:
                            send_raw(bytes(buf[pos : pos + dlen]),
                                     endpoints[ep_idx].addr)
                        except Exception as e:
                            failed = f"socket send failed: {e!r}"
                    pos += dlen
            if failed is None and batch:
                # one batched call per slot per tick (§21c): the socket
                # walks the list internally — same per-socket send order
                try:
                    m.send_batch(batch)
                except Exception as e:
                    failed = f"socket send failed: {e!r}"
            if failed is not None:
                flush_failed[idx] = (0, failed)
            pass2.append((idx, pos))

        # ---- the one native outbound crossing for fd-backed slots ----
        if table_rows:
            desc = np.empty(len(table_rows), _SEND_DTYPE)
            cols = list(zip(*table_rows))
            desc["fd"] = cols[0]
            desc["ip"] = cols[1]
            desc["port"] = cols[2]
            # dispatch-mode rows carry kSendFlagDispatch: a fatal errno on
            # the SHARED fd faults only the owning record's slot, and the
            # run continues for co-tenants
            send_flags = self._send_flags
            desc["flags"] = [send_flags[s] for s in table_slots]
            desc["off"] = cols[3]
            desc["len"] = cols[4]
            stats3 = (ctypes.c_uint64 * _native.NET_SEND_STATS)()
            fatal = (ctypes.c_int32 * 32)()
            rc = self._lib.ggrs_net_send_table(
                desc.ctypes.data, len(table_rows), self._out_buf, out_len,
                stats3, fatal, 16,
            )
            if rc < 0:
                # table refused whole (corrupt offsets = builder bug):
                # fault every participating slot rather than lose sends
                # silently (dict.fromkeys: deterministic slot order)
                for idx in dict.fromkeys(table_slots):
                    flush_failed.setdefault(
                        idx, (0, f"ggrs_net_send_table failed: {rc}")
                    )
            else:
                for k in range(min(rc, 16)):
                    slot = table_slots[fatal[2 * k]]
                    flush_failed.setdefault(
                        slot,
                        (_native.BANK_ERR_IO,
                         "socket send failed: batched flush errno "
                         f"{fatal[2 * k + 1]}"),
                    )
                if rc > 16:
                    # more fatal fds than the report buffer holds (a
                    # host-wide EPERM-class condition): the unreported
                    # slots' datagrams were abandoned too — fault them
                    # ALL rather than let ~B-16 slots run policy on
                    # sends that never happened
                    for idx in dict.fromkeys(table_slots):
                        flush_failed.setdefault(
                            idx,
                            (_native.BANK_ERR_IO,
                             "socket send failed: batched flush fatal "
                             f"overflow ({rc} fatal fds)"),
                        )
            if self._obs_on and stats3[1]:
                self._m_io_send_errors.inc(int(stats3[1]))
            if self._obs_on and stats3[2]:
                self._m_io_oversized.inc(int(stats3[2]))
            if stats3[3]:
                self._gso_totals["gso_sends"] += int(stats3[3])
                self._gso_totals["gso_segments"] += int(stats3[4])
                if self._obs_on:
                    self._m_gso_sends.inc(int(stats3[3]))
                    self._m_gso_segments.inc(int(stats3[4]))

        # ---- pass 2: journal taps, policy, frame mirrors, forensics ----
        for idx, pos in pass2:
            m = mirrors[idx]
            failed = idx in flush_failed
            if failed:
                # reference-decoder parity (_parse_slot): a send fault
                # suppresses the slot's requests and policy, but the journal
                # tap below still appends (the confirmed records are in
                # hand: dropping them would gap the journal) and the frame
                # mirrors still update; staged inputs are KEPT for the
                # eviction path.  Natively-staged inputs were already
                # consumed by the crossing's trailing advance: reconstruct
                # them into the inline dict from the advance payload in the
                # tick output, which eviction re-feeds.  With input_delay >
                # 0 the payload carries the DELAYED frame's value (the JAX
                # package's documented approximation on this corner).
                if m.staged_native and trailing_l[idx]:
                    isize = m.input_size
                    po = offs_l[idx] + adv_off_l[idx]
                    if pattern_l[idx] == _native.REQ_RESIM:
                        po += (n_adv_l[idx] - 1) * adv_stride_l[idx]
                    bo = po + m.num_players
                    for h in m.local_handles:
                        m.staged_inputs[h] = bytes(
                            buf[bo + h * isize : bo + (h + 1) * isize]
                        )
                    m.staged_native.clear()
                code, detail = flush_failed[idx]
                self._on_slot_fault(idx, code, detail)
                lists[idx] = []
            hf = flags_l[idx]
            players, isize = m.num_players, m.input_size
            blob_len = players * isize
            if hf & CONF:
                # journal tap: read the confirmed-record section directly
                # (no spectators on a fast slot, so the intervening
                # sections are fixed-size)
                pos += 2 + m.mirror_len  # n_events(=0) + status mirrors
                (next_spec,) = unpack_from("<q", buf, pos)
                m.next_spec_frame = next_spec
                pos += 9 + 4  # + n_specs(=0) + n_spec_out/evts(=0)
                (n_conf,) = unpack_from("<H", buf, pos)
                pos += 2
                (conf_start,) = unpack_from("<q", buf, pos)
                pos += 8
                conf_records = []
                for _ in range(n_conf):
                    cflags = bytes(buf[pos : pos + players])
                    pos += players
                    conf_records.append(
                        (cflags, bytes(buf[pos : pos + blob_len]))
                    )
                    pos += blob_len
                sink = self._journal_sinks.get(idx)
                if sink is not None:
                    sink.append_frames(conf_start, conf_records)
            current = cur_l[idx]
            if not failed:
                pat = pattern_l[idx]
                if pat == _native.REQ_RESIM:
                    lf = rframe_l[idx]
                    plan.resim_rows.append((
                        idx, lf, n_adv_l[idx], trailing_l[idx],
                        offs_l[idx] + adv_off_l[idx], adv_stride_l[idx],
                    ))
                    rec = recorders[idx] if recorders else None
                    if rec is not None:
                        rec.record(
                            self._tick_no, EV_ROLLBACK,
                            f"load frame {lf} (was at {m.current_frame})",
                        )
                elif pat == _native.REQ_SAVE_ONLY:
                    plan.save_only_rows.append((idx, rframe_l[idx]))
                # ---- policy (the fast-slot subset: no events, no
                # consensus — just the wait recommendation) ----
                advanced = trailing_l[idx]
                fa = fa_l[idx]
                m.frames_ahead = fa
                pre_current = current - (1 if advanced else 0)
                if (
                    pre_current > m.next_recommended_sleep
                    and fa >= MIN_RECOMMENDATION
                ):
                    m.next_recommended_sleep = (
                        pre_current + RECOMMENDATION_INTERVAL
                    )
                    m.push_event((_LZ_WAIT, fa))
                if advanced:
                    if m.staged_inputs:
                        m.staged_inputs.clear()
                    if m.staged_native:
                        m.staged_native.clear()
            m.current_frame = current
            m.last_confirmed = conf_l[idx]

        if flush_failed:
            # a faulted fast slot's device program must be suppressed
            # exactly like its requests: prune it from the executor-facing
            # quiet columns and route it through the eager rows instead,
            # so the executor reads plan[idx] — the empty list, or the
            # evicted session's replacement if _supervise swaps it in
            # this same tick
            dead = np.fromiter(flush_failed, np.int64,
                               count=len(flush_failed))
            keep = ~np.isin(plan.quiet_rows, dead)
            plan.quiet_rows = plan.quiet_rows[keep]
            plan.quiet_frames = plan.quiet_frames[keep]
            plan.quiet_offs = plan.quiet_offs[keep]
            plan.quiet_adv_off = plan.quiet_adv_off[keep]
            plan.eager_rows.extend(flush_failed)

        self.fast_slot_ticks += n_fast
        self.desc_slow_slots += n - n_fast
        self._m_fast_slots.inc(n_fast)
        # "every LIVE slot was fast": skip records (quarantined / evicted
        # / dead slots) are never fast and must not pin this counter at
        # zero for the rest of a degraded pool's life
        n_skip = int(np.count_nonzero(
            (flags & _native.BANK_HDR_SKIP) != 0
        ))
        if n_fast == n - n_skip:
            self.fast_ticks += 1
        retire_mask = None
        if self.retire_dead_matches:
            # endpoint liveness can only have changed on a dirty or
            # slow-parsed slot — the retirement walk skips the rest
            retire_mask = (
                ((flags & _native.BANK_HDR_DIRTY) != 0) | ~fast
            ).tolist()
        return plan, retire_mask

    def requests_for(self, index: int) -> List[GgrsRequest]:
        """The most recent tick's request list for slot ``index`` — the
        lazy-materialization surface of the descriptor plane (§21).
        Identical to indexing the object ``advance_all`` returned; valid,
        like that object, until the next ``advance_all``."""
        plan = self._plan
        if plan is None:
            raise InvalidRequest(
                "no request plan: advance_all has not produced a "
                "descriptor-plane tick yet"
            )
        return plan[index]

    def _materialize_slot(self, plan: RequestPlan,
                          idx: int) -> List[GgrsRequest]:
        """Build slot ``idx``'s pooled ``GgrsRequest`` list from its body
        record — the deferred half of the descriptor plane.  Pooled
        per-kind objects are refilled in place (valid until the next
        ``advance_all``, like the scrape records); metrics were already
        counted from the descriptor columns at plan build."""
        if plan.tick_no != self._tick_no or plan is not self._plan:
            raise InvalidRequest(
                "stale RequestPlan: request lists are only valid until "
                "the next advance_all"
            )
        if not plan.live_l[idx]:
            return []
        m = self._mirrors[idx]
        buf = memoryview(self._out_buf).cast("B")[: len(plan.buffer)]
        off = plan.offs_l[idx]
        unpack_from = struct.unpack_from
        players, isize = m.num_players, m.input_size
        decode = m.config.input_decode
        get_cell = m.saved_states.get_cell
        (n_ops,) = unpack_from("<H", buf, off + 33)
        pos = off + 35
        requests = m.pooled_list
        requests.clear()
        saves, loads, advs = m.pool_saves, m.pool_loads, m.pool_advs
        si = li = ai = 0
        blob_len = players * isize
        for _ in range(n_ops):
            kind = buf[pos]
            pos += 1
            if kind == 2:
                if ai == len(advs):
                    advs.append(AdvanceFrame(inputs=[None] * players))
                adv = advs[ai]
                ai += 1
                inputs = adv.inputs
                bo = pos + players
                for p in range(players):
                    inputs[p] = (
                        decode(bytes(
                            buf[bo + p * isize : bo + (p + 1) * isize]
                        )),
                        _STATUS[buf[pos + p]],
                    )
                pos = bo + blob_len
                requests.append(adv)
            else:
                (frame,) = unpack_from("<q", buf, pos)
                pos += 8
                cell = get_cell(frame)
                if kind == 0:
                    if si == len(saves):
                        saves.append(
                            SaveGameState(cell=None, frame=NULL_FRAME)
                        )
                    req = saves[si]
                    si += 1
                else:
                    assert cell.frame == frame, (
                        f"rollback loads frame {frame} but its cell "
                        f"holds {cell.frame} — was the save fulfilled?"
                    )
                    if li == len(loads):
                        loads.append(
                            LoadGameState(cell=None, frame=NULL_FRAME)
                        )
                    req = loads[li]
                    li += 1
                req.cell = cell
                req.frame = frame
                requests.append(req)
        return requests

    def _parse_slot(self, buf, pos, idx, ticked_slot):
        """Positional parse of ONE slot's body record starting at
        ``pos`` — the reference decoder for a single slot, shared by the
        sequential legacy parse and the vectorized path's slow slots.
        Returns ``(requests, end_pos, current_frame)``."""
        m = self._mirrors[idx]
        unpack_from = struct.unpack_from
        players, isize = m.num_players, m.input_size
        err, landed, frames_ahead, current, confirmed, consensus, n_ops = (
            unpack_from("<iqiqqBH", buf, pos)
        )
        pos += 35
        # live: the bank actually stepped this slot and it didn't fault.
        # A faulted slot's record is status-only (its ops/outbound/events
        # were suppressed natively); parse positionally either way.
        live = ticked_slot and err == 0
        if ticked_slot and err != 0:
            self._on_slot_fault(idx, err)
        requests: List[GgrsRequest] = []
        advanced = False
        decode = m.config.input_decode
        rec = self._recorders[idx] if self._recorders else None
        for _ in range(n_ops):
            kind = buf[pos]
            pos += 1
            if kind == 2:
                statuses = bytes(buf[pos : pos + players])
                pos += players
                blob = bytes(buf[pos : pos + players * isize])
                pos += players * isize
                requests.append(AdvanceFrame(inputs=[
                    (decode(blob[p * isize : (p + 1) * isize]),
                     _STATUS[statuses[p]])
                    for p in range(players)
                ]))
                advanced = True
                self._m_req_advance.inc()
            else:
                (frame,) = unpack_from("<q", buf, pos)
                pos += 8
                cell = m.saved_states.get_cell(frame)
                if kind == 0:
                    requests.append(SaveGameState(cell=cell, frame=frame))
                    advanced = False
                    self._m_req_save.inc()
                else:
                    assert cell.frame == frame, (
                        f"rollback loads frame {frame} but its cell "
                        f"holds {cell.frame} — was the save fulfilled?"
                    )
                    requests.append(LoadGameState(cell=cell, frame=frame))
                    advanced = False
                    self._m_req_load.inc()
                    self._m_rollbacks.inc()
                    if rec is not None:
                        rec.record(
                            self._tick_no, EV_ROLLBACK,
                            f"load frame {frame} (was at "
                            f"{m.current_frame})",
                        )
        # outbound.  Broadcast layout: the poll-phase remote
        # datagrams send immediately; the adv-phase (input) sends wait
        # until the spectator queues — LAST tick's deferred fan-out plus
        # this tick's spectator poll messages — have gone out, which is
        # the Python session's exact per-socket order (poll's
        # send_all_messages flushes remotes then spectators, then
        # advance_frame sends the remote input messages inline; the
        # fan-out messages it queues flush at the NEXT tick's poll).
        send_raw = m.send_raw  # socket.send_datagram (raw bytes, no
        # RawMessage wrapper / re-encode) or the send_to shim
        send_failed: Optional[str] = None
        (n_out_poll,) = unpack_from("<H", buf, pos)
        pos += 2
        for _ in range(n_out_poll):
            ep_idx, dlen = unpack_from("<HI", buf, pos)
            pos += 6
            data = bytes(buf[pos : pos + dlen])
            pos += dlen
            if send_failed is not None:
                continue  # slot already faulted; keep consuming bytes
            if rec is not None:
                # wire digest: a tuple of scalars, formatted lazily by
                # dump() — cheap enough to leave on for healthy slots
                rec.record(self._tick_no, EV_WIRE,
                           (ep_idx, dlen, zlib.crc32(data)))
            try:
                send_raw(data, m.endpoints[ep_idx].addr)
            except Exception as e:  # a send fault is THIS slot's fault
                send_failed = f"socket send failed: {e!r}"
        adv_out: List[Tuple[int, bytes]] = []
        (n_out_adv,) = unpack_from("<H", buf, pos)
        pos += 2
        for _ in range(n_out_adv):
            ep_idx, dlen = unpack_from("<HI", buf, pos)
            pos += 6
            adv_out.append((ep_idx, bytes(buf[pos : pos + dlen])))
            pos += dlen
        # stage event records; dispatch AFTER the status mirrors below
        # are parsed — _on_protocol_disconnected reads m.local_last, and
        # p2p.py's _handle_event sees the status as updated by this
        # tick's EvInputs, not last tick's
        (n_events,) = unpack_from("<H", buf, pos)
        pos += 2
        staged_events = []
        for _ in range(n_events):
            kind, ep_idx = unpack_from("<BH", buf, pos)
            pos += 3
            if kind == _EV_INTERRUPTED:
                (remaining,) = unpack_from("<q", buf, pos)
                pos += 8
                staged_events.append((kind, ep_idx, remaining))
            elif kind == _EV_CHECKSUM:
                frame, lo, hi = unpack_from("<qQQ", buf, pos)
                pos += 24
                staged_events.append((kind, ep_idx, (frame, lo, hi)))
            else:
                staged_events.append((kind, ep_idx, None))
        (n_eps,) = unpack_from("<B", buf, pos)
        pos += 1
        for e in range(n_eps):
            ep = m.endpoints[e]
            ep.running = buf[pos] == 0
            pos += 1
            for h in range(players):
                disc, lf = unpack_from("<Bq", buf, pos)
                pos += 9
                ep.peer_disc[h] = bool(disc)
                ep.peer_last[h] = lf
        for h in range(players):
            disc, lf = unpack_from("<Bq", buf, pos)
            pos += 9
            m.local_disc[h] = bool(disc)
            m.local_last[h] = lf

        # ---- broadcast tail (docs/DESIGN.md §13): spectator mirror, the
        # phase-tagged fan-out streams, hub events, journal tap ----
        next_spec, n_specs = unpack_from("<qB", buf, pos)
        pos += 9
        m.next_spec_frame = next_spec
        for e in range(n_specs):
            st, la = unpack_from("<Bq", buf, pos)
            pos += 9
            sp = m.spectators[e]
            sp.running = st == 0
            sp.last_acked = la
        (n_spec_out,) = unpack_from("<H", buf, pos)
        pos += 2
        spec_poll: List[List[bytes]] = [[] for _ in range(n_specs)]
        spec_adv: List[List[bytes]] = [[] for _ in range(n_specs)]
        for _ in range(n_spec_out):
            sp_idx, phase, dlen = unpack_from("<HBI", buf, pos)
            pos += 7
            (spec_adv if phase else spec_poll)[sp_idx].append(
                bytes(buf[pos : pos + dlen])
            )
            pos += dlen
        (n_spec_events,) = unpack_from("<H", buf, pos)
        pos += 2
        spec_events: List[Tuple[int, int, Any]] = []
        for _ in range(n_spec_events):
            kind, sp_idx = unpack_from("<BH", buf, pos)
            pos += 3
            payload = None
            if kind == _EV_INTERRUPTED:
                (payload,) = unpack_from("<q", buf, pos)
                pos += 8
            spec_events.append((kind, sp_idx, payload))
        (n_conf,) = unpack_from("<H", buf, pos)
        pos += 2
        conf_start: Frame = NULL_FRAME
        conf_records: List[Tuple[bytes, bytes]] = []
        if n_conf:
            (conf_start,) = unpack_from("<q", buf, pos)
            pos += 8
            blob_len = players * isize
            for _ in range(n_conf):
                flags = bytes(buf[pos : pos + players])
                pos += players
                conf_records.append((
                    flags, bytes(buf[pos : pos + blob_len]),
                ))
                pos += blob_len
        if live and m.spectators:
            # spectator sends: per viewer, last tick's deferred
            # fan-out datagrams then this tick's poll messages —
            # then the remote input messages, then stash this
            # tick's fan-out for the next (the Python flush order)
            fan = self._fanout_counters.get(idx)
            if fan is None:
                fan = (
                    self._m_fanout_dgrams.labels(slot=str(idx)).inc,
                    self._m_fanout_bytes.labels(slot=str(idx)).inc,
                )
                self._fanout_counters[idx] = fan
            fan_d, fan_b = fan
            # fan-out through the send table (§23): when the slot's
            # socket rides the native send table, stage every viewer datagram as a
            # table row and flush ONCE — the native side coalesces
            # same-viewer equal-size runs into GSO segmented sends
            # (sendmmsg fallback when UDP_SEGMENT is unavailable).
            # GGRS_TPU_NO_FASTPATH pins this loop per-datagram.
            fd = (
                self._send_fds[idx] if self._vectorized
                and self._send_fds else None
            )
            spec_rows: Optional[List[Tuple[int, int, bytes]]] = None
            if fd is not None:
                try:
                    spec_wire = [
                        self._resolve_wire_addr(sp.addr)
                        for sp in m.spectators
                    ]
                    spec_rows = []
                except (TypeError, ValueError, OSError):
                    spec_rows = None  # unresolvable viewer: reference
            for e, sp in enumerate(m.spectators):
                to_send = sp.deferred
                sp.deferred = []
                if e < n_specs:
                    to_send = to_send + spec_poll[e]
                for data in to_send:
                    if send_failed is not None:
                        continue
                    if rec is not None:
                        rec.record(
                            self._tick_no, EV_WIRE,
                            (f"spec{e}", len(data),
                             zlib.crc32(data)),
                        )
                    if spec_rows is not None:
                        # same forensics caveat as §21c: the flush
                        # outcome lands after the whole stage, so
                        # these counters may include datagrams a
                        # mid-flush fatal abandons (bounded by the
                        # EV_FAULT marker)
                        ip, port = spec_wire[e]
                        spec_rows.append((ip, port, data))
                        fan_d()
                        fan_b(len(data))
                        continue
                    try:
                        send_raw(data, sp.addr)
                        fan_d()
                        fan_b(len(data))
                    except Exception as exc:
                        send_failed = f"socket send failed: {exc!r}"
            if spec_rows and send_failed is None:
                # flushed BEFORE the adv-phase endpoint sends below:
                # the reference path interleaves on the same socket
                # in exactly this order
                send_failed = self._spec_send_table(
                    idx, fd, spec_rows
                )
        elif not live:
            # a faulted/skipped slot's deferred stream is stale: the
            # fan-out window lives in the harvest's pending dumps
            # and is re-emitted by the evicted relay's retry timer
            for sp in m.spectators:
                sp.deferred = []
        for ep_idx, data in adv_out:
            if send_failed is not None:
                continue
            if rec is not None:
                rec.record(self._tick_no, EV_WIRE,
                           (ep_idx, len(data), zlib.crc32(data)))
            try:
                send_raw(data, m.endpoints[ep_idx].addr)
            except Exception as e:
                send_failed = f"socket send failed: {e!r}"
        if live and m.spectators:
            for e, sp in enumerate(m.spectators):
                if e < n_specs:
                    sp.deferred.extend(spec_adv[e])
            hub = self._spectator_hub
            if hub is not None and spec_events:
                for kind, sp_idx, payload in spec_events:
                    hub._on_native_event(idx, sp_idx, kind, payload)
        if live and n_conf:
            sink = self._journal_sinks.get(idx)
            if sink is not None:
                sink.append_frames(conf_start, conf_records)
        if send_failed is not None:
            if m.staged_native and advanced:
                # batched staging (§21): the bank consumed the staged
                # inputs on the trailing advance before the Python-side
                # send failed — rebuild the inline dict from the decoded
                # advance (encode∘decode is the identity for
                # bank-eligible configs) so eviction re-feeds this
                # tick's inputs exactly like the inline-staged reference
                adv = next(
                    (r for r in reversed(requests)
                     if type(r) is AdvanceFrame), None,
                )
                if adv is not None:
                    encode = m.encode
                    for h in m.local_handles:
                        m.staged_inputs[h] = encode(adv.inputs[h][0])
                m.staged_native.clear()
            self._on_slot_fault(idx, 0, send_failed)
            live = False

        # ---- policy (Python): events, wait recommendation, consensus ----
        # applied only for live slots; a faulted/skipped record carries
        # no events and its policy state is frozen pending supervision
        if live:
            # events stage as lazy tag tuples (decoded on drain —
            # _materialize_events); only the checksum/disconnect kinds do
            # policy work here
            for kind, ep_idx, payload in staged_events:
                ep = m.endpoints[ep_idx]
                if kind == _EV_INTERRUPTED:
                    m.push_event((_LZ_INTERRUPTED, ep.addr, payload))
                elif kind == _EV_RESUMED:
                    m.push_event((_LZ_RESUMED, ep.addr))
                elif kind == _EV_DISCONNECTED:
                    self._on_protocol_disconnected(m, ep_idx)
                elif kind == _EV_CHECKSUM:
                    frame, lo, hi = payload
                    self._store_checksum(ep, frame, lo | (hi << 64))
            pre_current = current - (1 if advanced else 0)
            m.frames_ahead = frames_ahead
            if (
                pre_current > m.next_recommended_sleep
                and frames_ahead >= MIN_RECOMMENDATION
            ):
                m.next_recommended_sleep = (
                    pre_current + RECOMMENDATION_INTERVAL
                )
                m.push_event((_LZ_WAIT, frames_ahead))
            if advanced:
                m.staged_inputs.clear()
                if m.staged_native:
                    m.staged_native.clear()
            if consensus:
                self._run_consensus(m)
        if ticked_slot:
            m.current_frame = current
            m.last_confirmed = confirmed
        if not live:
            requests = []
        return requests, pos, current

    def _apply_slot(self, dec, idx, ticked_slot):
        """Replay ONE slot's side effects from a decoded record (§24).

        The stateful half of :meth:`_parse_slot`: ``dec`` is the
        plain-data tuple ``decode_pool.decode_slot_record`` produced on
        a worker; this method performs — on the owning thread, in slot
        order — exactly the side effects the reference decoder
        interleaves with its byte walk: request construction (cells,
        pooled objects, user input_decode), sends, EV_WIRE/EV_ROLLBACK
        forensics, event staging, status/frame mirrors, journal taps,
        fault handling, policy.  Returns ``(requests, end_pos,
        current_frame)``, ``_parse_slot``'s contract, bit for bit."""
        m = self._mirrors[idx]
        players, isize = m.num_players, m.input_size
        (err, landed, frames_ahead, current, confirmed, consensus, ops,
         poll_out, adv_out, staged_events, eps_t, local_t, spec,
         end_pos) = dec
        live = ticked_slot and err == 0
        if ticked_slot and err != 0:
            self._on_slot_fault(idx, err)
        requests: List[GgrsRequest] = []
        advanced = False
        decode = m.config.input_decode
        rec = self._recorders[idx] if self._recorders else None
        for kind, a, b in ops:
            if kind == 2:
                statuses, blob = a, b
                requests.append(AdvanceFrame(inputs=[
                    (decode(blob[p * isize : (p + 1) * isize]),
                     _STATUS[statuses[p]])
                    for p in range(players)
                ]))
                advanced = True
                self._m_req_advance.inc()
            else:
                frame = a
                cell = m.saved_states.get_cell(frame)
                if kind == 0:
                    requests.append(SaveGameState(cell=cell, frame=frame))
                    advanced = False
                    self._m_req_save.inc()
                else:
                    assert cell.frame == frame, (
                        f"rollback loads frame {frame} but its cell "
                        f"holds {cell.frame} — was the save fulfilled?"
                    )
                    requests.append(LoadGameState(cell=cell, frame=frame))
                    advanced = False
                    self._m_req_load.inc()
                    self._m_rollbacks.inc()
                    if rec is not None:
                        rec.record(
                            self._tick_no, EV_ROLLBACK,
                            f"load frame {frame} (was at "
                            f"{m.current_frame})",
                        )
        send_raw = m.send_raw
        send_failed: Optional[str] = None
        for ep_idx, data in poll_out:
            if send_failed is not None:
                continue
            if rec is not None:
                rec.record(self._tick_no, EV_WIRE,
                           (ep_idx, len(data), zlib.crc32(data)))
            try:
                send_raw(data, m.endpoints[ep_idx].addr)
            except Exception as e:
                send_failed = f"socket send failed: {e!r}"
        for e, (running, prs) in enumerate(eps_t):
            ep = m.endpoints[e]
            ep.running = running == 0
            for h in range(players):
                disc, lf = prs[h]
                ep.peer_disc[h] = bool(disc)
                ep.peer_last[h] = lf
        for h in range(players):
            disc, lf = local_t[h]
            m.local_disc[h] = bool(disc)
            m.local_last[h] = lf
        if spec is not None:
            (next_spec, n_specs, sstat, spec_poll, spec_adv, spec_events,
             conf_start, conf_records) = spec
            m.next_spec_frame = next_spec
            for e, (st, la) in enumerate(sstat):
                sp = m.spectators[e]
                sp.running = st == 0
                sp.last_acked = la
            n_conf = len(conf_records)
            if live and m.spectators:
                fan = self._fanout_counters.get(idx)
                if fan is None:
                    fan = (
                        self._m_fanout_dgrams.labels(slot=str(idx)).inc,
                        self._m_fanout_bytes.labels(slot=str(idx)).inc,
                    )
                    self._fanout_counters[idx] = fan
                fan_d, fan_b = fan
                fd = (
                    self._send_fds[idx] if self._vectorized
                    and self._send_fds else None
                )
                spec_rows: Optional[List[Tuple[int, int, bytes]]] = None
                if fd is not None:
                    try:
                        spec_wire = [
                            self._resolve_wire_addr(sp.addr)
                            for sp in m.spectators
                        ]
                        spec_rows = []
                    except (TypeError, ValueError, OSError):
                        spec_rows = None
                for e, sp in enumerate(m.spectators):
                    to_send = sp.deferred
                    sp.deferred = []
                    if e < n_specs:
                        to_send = to_send + spec_poll[e]
                    for data in to_send:
                        if send_failed is not None:
                            continue
                        if rec is not None:
                            rec.record(
                                self._tick_no, EV_WIRE,
                                (f"spec{e}", len(data),
                                 zlib.crc32(data)),
                            )
                        if spec_rows is not None:
                            ip, port = spec_wire[e]
                            spec_rows.append((ip, port, data))
                            fan_d()
                            fan_b(len(data))
                            continue
                        try:
                            send_raw(data, sp.addr)
                            fan_d()
                            fan_b(len(data))
                        except Exception as exc:
                            send_failed = f"socket send failed: {exc!r}"
                if spec_rows and send_failed is None:
                    send_failed = self._spec_send_table(
                        idx, fd, spec_rows
                    )
            elif not live:
                for sp in m.spectators:
                    sp.deferred = []
        for ep_idx, data in adv_out:
            if send_failed is not None:
                continue
            if rec is not None:
                rec.record(self._tick_no, EV_WIRE,
                           (ep_idx, len(data), zlib.crc32(data)))
            try:
                send_raw(data, m.endpoints[ep_idx].addr)
            except Exception as e:
                send_failed = f"socket send failed: {e!r}"
        if spec is not None and live and m.spectators:
            for e, sp in enumerate(m.spectators):
                if e < n_specs:
                    sp.deferred.extend(spec_adv[e])
            hub = self._spectator_hub
            if hub is not None and spec_events:
                for kind, sp_idx, payload in spec_events:
                    hub._on_native_event(idx, sp_idx, kind, payload)
        if spec is not None and live and n_conf:
            sink = self._journal_sinks.get(idx)
            if sink is not None:
                sink.append_frames(conf_start, conf_records)
        if send_failed is not None:
            if m.staged_native and advanced:
                adv = next(
                    (r for r in reversed(requests)
                     if type(r) is AdvanceFrame), None,
                )
                if adv is not None:
                    encode = m.encode
                    for h in m.local_handles:
                        m.staged_inputs[h] = encode(adv.inputs[h][0])
                m.staged_native.clear()
            self._on_slot_fault(idx, 0, send_failed)
            live = False
        if live:
            for kind, ep_idx, payload in staged_events:
                ep = m.endpoints[ep_idx]
                if kind == _EV_INTERRUPTED:
                    m.push_event((_LZ_INTERRUPTED, ep.addr, payload))
                elif kind == _EV_RESUMED:
                    m.push_event((_LZ_RESUMED, ep.addr))
                elif kind == _EV_DISCONNECTED:
                    self._on_protocol_disconnected(m, ep_idx)
                elif kind == _EV_CHECKSUM:
                    frame, lo, hi = payload
                    self._store_checksum(ep, frame, lo | (hi << 64))
            pre_current = current - (1 if advanced else 0)
            m.frames_ahead = frames_ahead
            if (
                pre_current > m.next_recommended_sleep
                and frames_ahead >= MIN_RECOMMENDATION
            ):
                m.next_recommended_sleep = (
                    pre_current + RECOMMENDATION_INTERVAL
                )
                m.push_event((_LZ_WAIT, frames_ahead))
            if advanced:
                m.staged_inputs.clear()
                if m.staged_native:
                    m.staged_native.clear()
            if consensus:
                self._run_consensus(m)
        if ticked_slot:
            m.current_frame = current
            m.last_confirmed = confirmed
        if not live:
            requests = []
        return requests, end_pos, current

    def _decode_slow_slots(self, buf, slots: List[int], offs_l,
                           ticked) -> Optional[Dict[int, Any]]:
        """Fan the tick's slow slots across the DecodePool (§24) and
        return ``slot -> decoded tuple`` — or None when the parallel
        plane must stay out of the way (serial backend, no pool, a
        single slot not worth the fan-out): the caller then uses the
        reference ``_parse_slot`` directly, which IS the serial
        fallback, bit for bit."""
        pool = self._decode_pool
        if pool is None or pool.backend == "serial" or len(slots) < 2:
            return None
        mirrors = self._mirrors
        jobs = []
        for idx in slots:
            m = mirrors[idx]
            # every record carries the broadcast sections
            jobs.append((offs_l[idx], m.num_players, m.input_size, True))
        decs = pool.decode_slots(buf, jobs)
        self.decode_parallel_ticks += 1
        return dict(zip(slots, decs))

    def _spec_send_table(self, idx: int, fd: int,
                         rows: List[Tuple[int, int, bytes]]) -> Optional[str]:
        """Flush one slot's staged spectator fan-out through the native
        send table (§23): one crossing for the whole viewer burst; the
        native side GSO-coalesces same-viewer equal-size runs and windows
        the rest through sendmmsg.  Returns a fault string (the
        ``send_failed`` contract of :meth:`_parse_slot`) or None."""
        payload = b"".join(r[2] for r in rows)
        desc = np.empty(len(rows), _SEND_DTYPE)
        desc["fd"] = fd
        desc["ip"] = [r[0] for r in rows]
        desc["port"] = [r[1] for r in rows]
        desc["flags"] = self._send_flags[idx] if self._send_flags else 0
        off = 0
        offs: List[int] = []
        lens: List[int] = []
        for _, _, data in rows:
            offs.append(off)
            lens.append(len(data))
            off += len(data)
        desc["off"] = offs
        desc["len"] = lens
        stats = (ctypes.c_uint64 * _native.NET_SEND_STATS)()
        fatal = (ctypes.c_int32 * 8)()
        rc = self._lib.ggrs_net_send_table(
            desc.ctypes.data, len(rows), payload, len(payload),
            stats, fatal, 4,
        )
        if self._obs_on and stats[1]:
            self._m_io_send_errors.inc(int(stats[1]))
        if self._obs_on and stats[2]:
            self._m_io_oversized.inc(int(stats[2]))
        if stats[3]:
            self._gso_totals["gso_sends"] += int(stats[3])
            self._gso_totals["gso_segments"] += int(stats[4])
            if self._obs_on:
                self._m_gso_sends.inc(int(stats[3]))
                self._m_gso_segments.inc(int(stats[4]))
        if rc < 0:
            return f"socket send failed: ggrs_net_send_table {rc}"
        if rc > 0:
            return (
                "socket send failed: batched fan-out errno "
                f"{fatal[1]}"
            )
        return None

    # ------------------------------------------------------------------
    # supervision: quarantine, eviction, retirement (fault isolation)
    # ------------------------------------------------------------------

    def _advance_all_fallback(self) -> List[List[GgrsRequest]]:
        """Per-session Python path with the same per-slot containment: a
        session whose tick raises is marked dead (no Python-to-Python
        eviction exists — it IS the fallback) while the rest keep ticking.
        Deliberate contract errors (``GgrsError``: missing inputs, not
        synchronized) still propagate to the caller."""
        self._tick_no += 1
        self._m_ticks.inc()
        tracer = self.tracer
        t_tick = tracer.now_ns() if tracer.enabled else 0
        # validate every live session's preconditions BEFORE any session
        # advances: a contract raise mid-loop would discard earlier
        # sessions' already-generated request lists (the native path makes
        # the same check before its crossing).  Handshaking sessions are
        # POLLED first — raising without polling would starve the handshake
        # of its sync-request/reply datagrams (in-pool peers would never
        # answer each other) and livelock the pool — then the pool raises
        # once for all of them, losslessly: nothing has advanced yet.
        synchronizing = False
        for i, s in enumerate(self._sessions):
            if self._slot_state[i] in (SLOT_DEAD, SLOT_MIGRATED):
                continue
            if s.current_state() is SessionState.SYNCHRONIZING:
                s.poll_remote_clients()
                synchronizing |= (
                    s.current_state() is SessionState.SYNCHRONIZING
                )
        if synchronizing:
            raise NotSynchronized()
        for i, s in enumerate(self._sessions):
            if self._slot_state[i] not in (SLOT_DEAD, SLOT_MIGRATED):
                s.validate_local_inputs()
        if self._prediction_plane is not None:
            # one device op predicts every registered slot's missing
            # inputs; queues fall back to the scalar strategy on any row
            # the gather didn't cover (predict/batched.py contract)
            self._prediction_plane.begin_tick()
        out: List[List[GgrsRequest]] = []
        for i, s in enumerate(self._sessions):
            if self._slot_state[i] in (SLOT_DEAD, SLOT_MIGRATED):
                out.append([])
                continue
            try:
                out.append(s.advance_frame())
            except GgrsError:
                raise
            except Exception as e:
                self._on_slot_fault(i, 0, f"{type(e).__name__}: {e}")
                # ggrs-model: transitions(quarantined->dead, evicted->dead)
                self._set_slot_state(i, SLOT_DEAD)
                out.append([])
                continue
            if self.retire_dead_matches:
                self._maybe_retire(i, s._remote_endpoints and all(
                    not ep.is_running() for ep in s._remote_endpoints
                ))
        if tracer.enabled:
            tracer.add_complete("pool.tick", t_tick,
                                tracer.now_ns() - t_tick, cat="py")
        self.last_tick_at = time.monotonic()
        return out

    def _maybe_retire(self, index: int, match_over) -> None:
        """With ``retire_dead_matches``, a slot whose every remote endpoint
        has disconnected is retired: the match is over, so empty request
        lists beat running free on dummy inputs forever.  ``match_over``
        must already be False for sessions with no remote endpoints."""
        if self.retire_dead_matches and match_over:
            self._fault_log[index].append(SlotFault(
                self._tick_no, 0,
                "match over: every remote endpoint disconnected",
            ))
            # ggrs-model: transitions(native->dead, evicted->dead)
            self._set_slot_state(index, SLOT_DEAD)

    def _supervise(self, request_lists: List[List[GgrsRequest]],
                   retire_mask: Optional[List[bool]] = None) -> None:
        """Post-tick supervision pass: retire dead matches, drive pending
        evictions, and tick evicted sessions — filling their slots of
        ``request_lists`` in place.

        Incremental (DESIGN.md §19): the walk is driven by ``_attention``
        — the quarantined/evicted slots — instead of range(B); on the
        quiet steady state this loop touches nothing.  The optional
        ``retire_mask`` (from the header's dirty bits) bounds the
        ``retire_dead_matches`` liveness check the same way: endpoint
        liveness only changes on dirty or slow-parsed ticks."""
        if self.retire_dead_matches:
            for i, state in enumerate(self._slot_state):
                if state != SLOT_NATIVE:
                    continue
                if retire_mask is not None and not retire_mask[i]:
                    continue
                m = self._mirrors[i]
                self._maybe_retire(i, m.endpoints and all(
                    not ep.running for ep in m.endpoints
                ))
        if not self._attention:
            return
        evictions_this_tick = 0
        for i in sorted(self._attention):
            state = self._slot_state[i]
            if state == SLOT_QUARANTINED:
                # retry-storm clamp: a shard-wide failure quarantines many
                # slots on one tick; at most EVICT_MAX_PER_TICK eviction
                # attempts (each a harvest crossing + session build) run
                # per supervision pass — the rest stay quarantined and are
                # picked up on following ticks, keeping the tick budget
                # bounded while the jittered backoff spreads the retries
                if evictions_this_tick < self._evict_max_per_tick:
                    if self._try_evict(i):
                        evictions_this_tick += 1
                state = self._slot_state[i]
            if state != SLOT_EVICTED:
                continue
            session = self._evicted[i]
            try:
                reqs = session.advance_frame()
            except GgrsError:
                raise
            except Exception as e:
                # the fallback faulted too (e.g. the same malicious peer):
                # blast radius stays this one slot
                self._on_slot_fault(i, 0, f"evicted tick: {type(e).__name__}: {e}")
                # ggrs-model: transitions(evicted->dead)
                self._set_slot_state(i, SLOT_DEAD)
                request_lists[i] = []
                continue
            load = self._pending_load.pop(i, None)
            if load is not None:
                # the resume tick leads with restoring the game state saved
                # at the slot's last committed frame
                reqs = [load] + reqs
            request_lists[i] = reqs
            if self.retire_dead_matches:
                self._maybe_retire(i, session._remote_endpoints and all(
                    not ep.is_running() for ep in session._remote_endpoints
                ))

    def _set_slot_state(self, index: int, new_state: str) -> None:
        """The single path for supervision transitions: flips the state,
        counts the transition, keeps the per-state gauge current, and
        appends the transition to the slot's flight recorder."""
        old = self._slot_state[index]
        if old == new_state:
            return
        if (old, new_state) not in _SLOT_TRANSITION_SET:
            # undeclared edge: loud in logs, never fatal in production —
            # the static conformance lint is the enforcing layer
            _logger.error(
                "undeclared supervision transition %s -> %s (slot %d)",
                old, new_state, index,
            )
        self._slot_state[index] = new_state
        # the staging router resolves slot state at transition time, not
        # per call — rebuild this slot's dispatch
        if self._stagers:
            self._stagers[index] = self._make_stager(index)
        # incremental supervision: only quarantined/evicted slots need the
        # post-tick walk; dead/migrated slots need nothing and native
        # slots are the bank's business
        if new_state in (SLOT_QUARANTINED, SLOT_EVICTED):
            self._attention.add(index)
        else:
            self._attention.discard(index)
        # transition feed for incremental consumers (fleet shards): bounded
        # — an undrained feed must never grow without bound, but the bound
        # must hold a whole shard-wide failure (every slot transitioning
        # on one tick) or the forensics sweep silently loses post-mortems
        self._state_transitions.append(
            (index, old, new_state, self._tick_no)
        )
        del self._state_transitions[:-max(256, 2 * len(self._slot_state))]
        if new_state != SLOT_NATIVE and self._io_attached[index]:
            # a slot leaving the bank leaves the batched datapath with it:
            # the evicted session owns the socket (per-datagram Python
            # path), so io_state() must say "python" and the NetBatch is
            # released rather than idling attached forever
            self._detach_io(index)
        # the drain plan indexes slots by state: any transition in or out
        # of SLOT_NATIVE changes which fds/routes the one-crossing inbound
        # drain may touch (a faulted slot must drop out of the plan
        # IMMEDIATELY: its socket now belongs to supervision)
        self._refresh_drain()
        self._m_transitions.labels(src=old, dst=new_state).inc()
        self._m_slot_state.labels(state=old).dec()
        self._m_slot_state.labels(state=new_state).inc()
        rec = self._recorders[index] if self._recorders else None
        if rec is not None:
            rec.record(self._tick_no, EV_STATE, f"{old} -> {new_state}")

    def _on_slot_fault(self, index: int, code: int, detail: str = "") -> None:
        """Record a fault and quarantine the slot: the bank stops stepping
        it (skip flag) while eviction — resume on the Python fallback from
        the last committed frame — is attempted with bounded backoff."""
        named = detail or _native.BANK_ERR_NAMES.get(
            code, f"bank error {code}"
        )
        self._fault_log[index].append(SlotFault(self._tick_no, code, named))
        self._m_faults.labels(code=str(code)).inc()
        rec = self._recorders[index] if self._recorders else None
        if rec is not None:
            rec.record(self._tick_no, EV_FAULT, f"code={code} {named}")
        if self._slot_state[index] == SLOT_NATIVE:
            self._set_slot_state(index, SLOT_QUARANTINED)
            self._quarantined_at[index] = self._tick_no
            self._evict_attempts[index] = 0
            self._evict_next_try[index] = self._tick_no  # try immediately
            if code == _native.BANK_ERR_SYNC:
                # desync-class fault: synthesize the forensic artifact NOW,
                # while the mirrors and the trace window still
                # hold the state around the fault (DESIGN.md §14)
                self._build_native_desync_report(index, code, named)
            # the post-mortem: the slot's recent history, logged the moment
            # it leaves the bank (DESIGN.md §12 flight-recorder contract)
            if rec is not None:
                _logger.warning(
                    "slot %d quarantined at tick %d (code=%d %s); flight "
                    "recorder (last 32 events):\n%s",
                    index, self._tick_no, code, named, rec.dump(32),
                )

    def _build_native_desync_report(self, index: int, code: int,
                                    named: str) -> None:
        """DesyncReport for a desync-class native fault: no local checksum
        history exists on the bank path (desync detection is a fallback
        feature), so the report carries the evidence that IS available —
        the peers' reported checksums, the flight recorder, the journal
        tail, and the active trace window."""
        m = self._mirrors[index]
        rec = self._recorders[index] if self._recorders else None
        # per-peer attribution: same-frame reports from different peers
        # must not overwrite each other — a multi-endpoint window is keyed
        # by peer address (the disagreeing peer is the forensic lead)
        peer_windows = {
            ep.addr: dict(ep.pending_checksums) for ep in m.endpoints
        }
        single = m.endpoints[0].addr if len(m.endpoints) == 1 else None
        report = build_desync_report(
            kind="native-fault",
            detected_frame=m.current_frame,
            addr=single,
            remote_history=peer_windows[single] if single is not None else {},
            recorder=rec,
            journal=self._journal_sinks.get(index),
            tracer=self.tracer,
            detail=f"slot {index} quarantined by desync-class fault "
                   f"code={code} ({named}) at pool tick {self._tick_no}",
        )
        if single is None:
            report.checksum_window = {
                f"remote[{addr!r}]": window
                for addr, window in peer_windows.items() if window
            }
        self._desync_reports[index] = report
        if rec is not None:
            rec.record(self._tick_no, EV_DESYNC,
                       f"code={code} report built (frame {m.current_frame})")
        self.tracer.add_instant("pool.desync", cat="py", slot=index,
                                frame=m.current_frame, code=code)

    def desync_report(self, index: int) -> Optional[DesyncReport]:
        """The forensic report built when slot ``index`` quarantined on a
        desync-class fault, or None.  (The checksum-compare detection path
        lives on Python sessions — see ``P2PSession.desync_reports``.)"""
        return self._desync_reports.get(index)

    def _try_evict(self, index: int) -> bool:
        """One eviction attempt for a quarantined slot.  Returns True when
        an attempt actually ran (success or failure) so the caller's
        per-tick clamp counts real work, not backoff skips."""
        if self._tick_no < self._evict_next_try.get(index, 0):
            return False  # backing off
        attempt = self._evict_attempts.get(index, 0) + 1
        self._evict_attempts[index] = attempt
        self._evict_next_try[index] = (
            self._tick_no + EVICT_BACKOFF_TICKS * attempt
            + _evict_jitter(index, attempt)
        )
        rec = self._recorders[index] if self._recorders else None
        try:
            with self.tracer.span("pool.evict", slot=index):
                session, load_req = self._evict(index)
        except Exception as e:
            self._fault_log[index].append(SlotFault(
                self._tick_no, 0, f"eviction attempt {attempt} failed: {e}"
            ))
            self._m_evict_failures.inc()
            if rec is not None:
                rec.record(self._tick_no, EV_EVICT,
                           f"attempt {attempt} failed: {e}")
            if attempt >= EVICT_MAX_ATTEMPTS:
                # ggrs-model: transitions(quarantined->dead)
                self._set_slot_state(index, SLOT_DEAD)
                if rec is not None:
                    _logger.error(
                        "slot %d marked dead after %d eviction attempts; "
                        "flight recorder (last 32 events):\n%s",
                        index, attempt, rec.dump(32),
                    )
            return True
        self._evicted[index] = session
        self._pending_load[index] = load_req
        # ggrs-model: transitions(quarantined->evicted)
        self._set_slot_state(index, SLOT_EVICTED)
        self._m_evictions.inc()
        self._m_evict_latency.observe(
            self._tick_no - self._quarantined_at.get(index, self._tick_no)
        )
        self._fault_log[index].append(SlotFault(
            self._tick_no, 0,
            f"evicted to Python fallback, resuming from frame "
            f"{load_req.frame}",
        ))
        if rec is not None:
            rec.record(self._tick_no, EV_EVICT,
                       f"resumed on fallback from frame {load_req.frame}")
            _logger.warning(
                "slot %d evicted at tick %d, resuming from frame %d; flight "
                "recorder (last 32 events):\n%s",
                index, self._tick_no, load_req.frame, rec.dump(32),
            )
        return True

    def _evict(self, index: int, *, lockstep: bool = False):
        """Build a fresh ``P2PSession`` resuming from the slot's last
        committed frame: harvest the native state (read-only, retry-safe),
        adopt it through the adoption seam, feed this tick's staged inputs,
        and hand back the session plus the leading ``LoadGameState``.

        ``lockstep=True`` is the load-shed demotion variant (DESIGN.md
        §27): the same adoption seam, but the resumed session runs with
        ``max_prediction == 0`` — confirmed frames only, no saves, no
        rollbacks.  The ``LoadGameState`` handed back is the POOL's
        one-time resume protocol, not session rollback machinery: it is
        the last load this slot will ever emit."""
        m = self._mirrors[index]
        builder, socket = self._builders[index]
        if lockstep:
            # shallow copy: the registry/endpoints are rebuilt by
            # start_p2p_session below; the original builder never starts
            # another session for this slot (the slot leaves NATIVE for
            # good), so sharing the registry object is safe
            builder = copy.copy(builder)
            builder.with_max_prediction_window(0)
        try:
            h = self._harvest(index)
        except Exception:
            # crash recovery (docs/DESIGN.md §13): the native slot's
            # resumable state is gone (corrupt harvest, dead bank memory).
            # A match journal, when attached, can stand in: its tail window
            # holds the same confirmed inputs the harvest would have
            # recovered, so the slot resumes from the journal instead of
            # dying.
            recover = self._journal_recovery.get(index)
            if recover is None:
                raise
            h = recover()
            self._fault_log[index].append(SlotFault(
                self._tick_no, 0,
                "harvest unavailable; resuming from journal tail "
                f"(frame {h['last_confirmed']})",
            ))
        resume, cell = _select_resume_frame(h, m.saved_states)
        session = builder.start_p2p_session(socket)
        endpoint_states = {}
        for e, ep in enumerate(m.endpoints):
            he = h["endpoints"][e]
            # peer mirrors: the harvest copy is authoritative (the
            # vectorized pool's Python mirrors may be quiet-tick stale);
            # journal-synthesized harvests lack them: fall back to the
            # mirror, which was fresh as of the fault tick's slow parse
            endpoint_states[ep.addr] = dict(
                magic=ep.magic,
                running=he["state"] == 0,
                peer_connect_status=list(zip(
                    he.get("peer_disc") or ep.peer_disc,
                    he.get("peer_last") or ep.peer_last,
                )),
                last_recv_frame=he["last_recv"],
                recv_entries=he["recv_entries"],
                last_acked_frame=he["last_acked_frame"],
                send_base=he["send_base"],
                pending=he["pending"],
                pending_checksums=ep.pending_checksums,
            )
        session.adopt_resume_state(
            frame=resume,
            last_confirmed=resume,
            saved_states=m.saved_states,
            connect_status=list(zip(h["local_disc"], h["local_last"])),
            player_inputs=h["player_inputs"],
            endpoint_states=endpoint_states,
            next_recommended_sleep=m.next_recommended_sleep,
            pending_events=_materialize_events(m.event_queue),
            next_spectator_frame=h.get("next_spectator_frame", 0),
        )
        m.event_queue.clear()
        # broadcast continuity: the relay falls back to the Python session
        # (p2p.py's own spectator path), resuming each viewer's fan-out
        # window mid-stream: builder-declared endpoints are adopted in
        # place, hub-attached viewers are grafted through the adoption seam
        if m.spectators:
            self._adopt_spectators(session, builder, m, h)
        sink = self._journal_sinks.get(index)
        if sink is not None:
            from ..broadcast.journal import JournalTap

            # the tap needs the session config: it re-ENCODES the decoded
            # inputs the relay hands it back into the journal's fixed-size
            # wire blobs
            session.adopt_spectator_endpoint(
                JournalTap.ADDR, JournalTap(sink, m.config)
            )
        decode = m.config.input_decode
        staged_native = h.get("staged_inputs") or {}
        for handle in m.local_handles:
            blob = m.staged_inputs.get(handle)
            if blob is None:
                # batched staging (§21): the blobs live in the bank; the
                # harvest's staged tail is the authoritative copy
                blob = staged_native.get(handle)
            if blob is not None:
                session.add_local_input(handle, decode(blob))
        m.staged_inputs.clear()
        m.staged_native.clear()
        # the evicted session routes through the same pooled-request /
        # lazy-event decode economics as the vectorized bank path: the
        # pool consumes its request list tick-synchronously (DESIGN.md
        # §19; the degraded-mode gap this narrows is priced by
        # bench host_bank_degraded)
        session.enable_request_pooling()
        # forensic continuity: the evicted session keeps tracing into the
        # pool's ring, recording into the slot's flight recorder, and citing
        # the slot's journal tail in any future DesyncReport
        session.attach_forensics(
            recorder=self._recorders[index] if self._recorders else None,
            tracer=self.tracer if self.tracer.enabled else None,
            journal=self._journal_sinks.get(index),
        )
        return session, LoadGameState(cell=cell, frame=resume)

    def _harvest(self, index: int) -> Dict[str, Any]:
        """One ``ggrs_bank_harvest`` crossing, parsed into the adoption
        inputs (see session_bank.cpp for the layout)."""
        self.harvests += 1
        self._m_cross_harvest.inc()
        buf = ctypes.create_string_buffer(1 << 16)
        out_len = ctypes.c_size_t(0)
        while True:
            rc = self._lib.ggrs_bank_harvest(
                self._bank, index, buf, len(buf), ctypes.byref(out_len)
            )
            if rc == _native.BANK_ERR_BUFFER_TOO_SMALL:
                buf = ctypes.create_string_buffer(
                    max(out_len.value, 2 * len(buf))
                )
                continue
            if rc != 0:
                raise RuntimeError(f"ggrs_bank_harvest failed: {rc}")
            break
        b = bytes(buf.raw[: out_len.value])
        unpack_from = struct.unpack_from
        current, confirmed, disc_frame = unpack_from("<qqq", b, 0)
        players, isize = unpack_from("<BI", b, 24)
        pos = 29
        local_disc: List[bool] = []
        local_last: List[Frame] = []
        player_inputs: List[Tuple[Frame, List[bytes]]] = []
        for _ in range(players):
            disc, last = unpack_from("<Bq", b, pos)
            pos += 9
            local_disc.append(bool(disc))
            local_last.append(last)
            start, count = unpack_from("<qI", b, pos)
            pos += 12
            blobs = [
                b[pos + i * isize : pos + (i + 1) * isize]
                for i in range(count)
            ]
            pos += count * isize
            player_inputs.append((start, blobs))
        (n_eps,) = unpack_from("<B", b, pos)
        pos += 1
        endpoints: List[Dict[str, Any]] = []
        for _ in range(n_eps):
            (state,) = unpack_from("<B", b, pos)
            pos += 1
            # per-endpoint peer status mirrors follow the state byte:
            # authoritative for eviction and export, since the vectorized
            # pool's Python mirrors skip quiet-tick refreshes
            peer_disc: List[bool] = []
            peer_last: List[Frame] = []
            for _p in range(players):
                d, lf = unpack_from("<Bq", b, pos)
                pos += 9
                peer_disc.append(bool(d))
                peer_last.append(lf)
            last_acked, base_len = unpack_from("<qI", b, pos)
            pos += 12
            send_base = b[pos : pos + base_len]
            pos += base_len
            (n_pending,) = unpack_from("<H", b, pos)
            pos += 2
            pending: List[Tuple[Frame, bytes]] = []
            for _ in range(n_pending):
                frame, dlen = unpack_from("<qI", b, pos)
                pos += 12
                pending.append((frame, b[pos : pos + dlen]))
                pos += dlen
            last_recv, n_recv = unpack_from("<qH", b, pos)
            pos += 10
            recv_entries: List[Tuple[Frame, bytes]] = []
            for _ in range(n_recv):
                frame, dlen = unpack_from("<qI", b, pos)
                pos += 12
                recv_entries.append((frame, b[pos : pos + dlen]))
                pos += dlen
            endpoints.append(dict(
                state=state, last_acked_frame=last_acked,
                send_base=send_base, pending=pending,
                last_recv=last_recv, recv_entries=recv_entries,
                peer_disc=peer_disc, peer_last=peer_last,
            ))
        # the broadcast section: the fan-out cursor, then each spectator
        # endpoint's send window
        next_spec, n_specs = unpack_from("<qB", b, pos)
        pos += 9
        spectators: List[Dict[str, Any]] = []
        for _ in range(n_specs):
            (state,) = unpack_from("<B", b, pos)
            pos += 1
            last_acked, base_len = unpack_from("<qI", b, pos)
            pos += 12
            send_base = b[pos : pos + base_len]
            pos += base_len
            (n_pending,) = unpack_from("<H", b, pos)
            pos += 2
            pending = []
            for _ in range(n_pending):
                frame, dlen = unpack_from("<qI", b, pos)
                pos += 12
                pending.append((frame, b[pos : pos + dlen]))
                pos += dlen
            spectators.append(dict(
                state=state, last_acked_frame=last_acked,
                send_base=send_base, pending=pending,
            ))
        # staged-inputs tail: inputs staged natively that no advance
        # consumed; eviction and export re-feed them like the Python-side
        # staged dict
        staged: Dict[int, bytes] = {}
        (n_staged,) = unpack_from("<B", b, pos)
        pos += 1
        for _ in range(n_staged):
            (sh,) = unpack_from("<i", b, pos)
            pos += 4
            staged[sh] = b[pos : pos + isize]
            pos += isize
        if pos != len(b):
            raise RuntimeError("harvest buffer layout mismatch")
        return dict(
            current=current, last_confirmed=confirmed,
            disconnect_frame=disc_frame, local_disc=local_disc,
            local_last=local_last, player_inputs=player_inputs,
            endpoints=endpoints, next_spectator_frame=next_spec,
            spectators=spectators, staged_inputs=staged,
        )

    def _adopt_spectators(self, session, builder, m: _SessionMirror,
                          h: Dict[str, Any]) -> None:
        """Graft the slot's fan-out endpoints onto the evicted Python
        session: builder-declared spectator endpoints are adopted in place,
        hub-attached viewers get fresh ``PeerProtocol``s through
        ``P2PSession.adopt_spectator_endpoint``.  Each resumes its harvested
        send window (ack base + unacked pending), so the viewer sees a
        retransmission hiccup, not a reset stream.  The grafting itself is
        shared with migration's adoption
        (``broadcast.hub.graft_spectator_endpoints``)."""
        from ..broadcast.hub import graft_spectator_endpoints

        spec_states = h.get("spectators") or []
        graft_spectator_endpoints(session, builder, [
            dict(
                addr=sp.addr, magic=sp.magic, handles=list(sp.handles),
                running=sp.running,
                state=spec_states[e] if e < len(spec_states) else None,
            )
            for e, sp in enumerate(m.spectators)
        ])
        for sp in m.spectators:
            sp.deferred = []

    # ------------------------------------------------------------------
    # fleet seam (ggrs_tpu/fleet): live migration export + slot release
    # ------------------------------------------------------------------

    def export_resume_state(self, index: int) -> Dict[str, Any]:
        """Process-portable resume bundle for one bank-resident slot, the
        source half of match migration.  The bundle carries everything
        ``adopt_resume_bundle`` needs to resume the match on ANOTHER pool,
        possibly in another process: the harvested native state (falling
        back to the registered journal recovery when the harvest is dead),
        the resume frame's fulfilled game state (pickled), the endpoint and
        spectator wire identities (magics, connect mirrors, pending
        checksums), and this tick's staged inputs.  Plain data only: it
        survives a serialize/deserialize round trip.  Read-only and
        retry-safe; pair with :meth:`release_slot` once the bundle is
        adopted elsewhere."""
        if not self._finalized:
            self._finalize()
        if not self._native_active:
            raise InvalidRequest(
                "export_resume_state requires the native bank"
            )
        state = self._slot_state[index]
        if state not in (SLOT_NATIVE, SLOT_QUARANTINED):
            raise InvalidRequest(
                f"slot {index} is {state}: only bank-resident slots can "
                "export a resume bundle"
            )
        m = self._mirrors[index]
        try:
            h = self._harvest(index)
        except Exception:
            # the same crash-recovery ladder as eviction: the journal tail
            # stands in when the native resumable state is gone
            recover = self._journal_recovery.get(index)
            if recover is None:
                raise
            h = recover()
        resume, cell = _select_resume_frame(h, m.saved_states)
        return dict(
            version=1,
            num_players=m.num_players,
            input_size=m.input_size,
            max_prediction=m.max_prediction,
            local_handles=list(m.local_handles),
            resume_frame=resume,
            state_blob=pickle.dumps(
                (cell.data(), cell.checksum),
                protocol=_BUNDLE_PICKLE_PROTOCOL,
            ),
            harvest=h,
            next_recommended_sleep=m.next_recommended_sleep,
            # materialize: the queue holds lazy tag tuples; the bundle's
            # consumer extends a real session's event queue verbatim
            pending_events=_materialize_events(m.event_queue),
            endpoints=[
                # identity from the mirror; liveness and peer mirrors from
                # the harvest when it carries them (authoritative under the
                # vectorized parse: the Python mirrors may be quiet-tick
                # stale), mirror fallback otherwise (journal-synthesized)
                dict(
                    addr=ep.addr, handles=list(ep.handles), magic=ep.magic,
                    running=(
                        h["endpoints"][e]["state"] == 0
                        if e < len(h["endpoints"]) and "state" in h["endpoints"][e]
                        else ep.running
                    ),
                    peer_disc=list(
                        h["endpoints"][e].get("peer_disc") or ep.peer_disc
                        if e < len(h["endpoints"]) else ep.peer_disc
                    ),
                    peer_last=list(
                        h["endpoints"][e].get("peer_last") or ep.peer_last
                        if e < len(h["endpoints"]) else ep.peer_last
                    ),
                    pending_checksums=dict(ep.pending_checksums),
                )
                for e, ep in enumerate(m.endpoints)
            ],
            spectators=[
                dict(addr=sp.addr, magic=sp.magic, handles=list(sp.handles),
                     running=sp.running)
                for sp in m.spectators
            ],
            staged_inputs={
                # native staging first (§21 harvest tail), inline staging
                # wins on conflict (the same precedence advance_all uses)
                **{
                    int(sh): bytes(blob)
                    for sh, blob in (h.get("staged_inputs") or {}).items()
                },
                **{
                    handle: bytes(blob)
                    for handle, blob in m.staged_inputs.items()
                },
            },
        )

    def release_slot(self, index: int, detail: str = "migrated") -> None:
        """Retire a slot whose match now lives on another pool (the commit
        point of migration): the bank stops stepping it, its native I/O
        detaches cleanly (NetBatch freed, delta keys purged), its journal
        tap and staged state drop, and the slot lands in the MIGRATED state:
        request lists and events go empty, like dead, but the state records
        that the match itself lives on elsewhere."""
        if not self._finalized:
            self._finalize()
        state = self._slot_state[index]
        if state in (SLOT_DEAD, SLOT_MIGRATED):
            return
        if state == SLOT_EVICTED:
            self._evicted.pop(index, None)
            self._pending_load.pop(index, None)
        if self._native_active and index < len(self._mirrors):
            m = self._mirrors[index]
            m.staged_inputs.clear()
            m.staged_native.clear()
            m.event_queue.clear()
            m.pending_ctrl = []
            for sp in m.spectators:
                sp.deferred = []
        self._inject_dgrams.pop(index, None)
        self._inject_err.pop(index, None)
        if index in self._journal_sinks:
            # the destination journals through its own tap from here on
            self.set_confirmed_stream(index, None)
        self._fault_log[index].append(
            SlotFault(self._tick_no, 0, f"released: {detail}")
        )
        # ggrs-model: transitions(native->migrated, quarantined->migrated, evicted->migrated)
        self._set_slot_state(index, SLOT_MIGRATED)

    # ------------------------------------------------------------------
    # input plane: lockstep demotion + device-batched prediction
    # (DESIGN.md §27)
    # ------------------------------------------------------------------

    def demote_to_lockstep(self, index: int) -> Frame:
        """Load-shed demotion (ROADMAP item 5 hook, DESIGN.md §27):
        move a HEALTHY bank-resident slot to the lockstep tier.  The
        match keeps running — same peers, same wire address, same
        journal tap — but as a ``max_prediction == 0`` Python session:
        confirmed frames only, zero save/load work, no rollback
        re-simulation.  Cheapest possible tier for a pool shedding tick
        budget under flash-crowd load.

        Rides the eviction seam: harvest → adopt → replay this tick's
        staged inputs, landing in the EVICTED supervision state (the
        per-session fallback tier; ``in_lockstep`` distinguishes demoted
        slots from fault evictions).  Returns the resume frame; the
        caller sees the one-time adoption ``LoadGameState`` prepended to
        the slot's next request list, after which the session never
        emits another save or load (pinned by tests/test_input_plane.py).

        One-way: promotion back to the bank is a future concern — the
        fleet re-admits demoted matches by migration instead."""
        if not self._finalized:
            self._finalize()
        if not self._native_active:
            raise InvalidRequest(
                "demote_to_lockstep requires the native bank (a fallback "
                "pool's sessions already run per-session; build them "
                "lockstep via with_max_prediction_window(0) instead)"
            )
        state = self._slot_state[index]
        if state != SLOT_NATIVE:
            raise InvalidRequest(
                f"slot {index} is {state}: only healthy bank-resident "
                "slots demote to lockstep (quarantined slots take the "
                "eviction path)"
            )
        rec = self._recorders[index] if self._recorders else None
        with self.tracer.span("pool.demote_lockstep", slot=index):
            session, load_req = self._evict(index, lockstep=True)
        assert session.in_lockstep_mode()
        self._evicted[index] = session
        self._pending_load[index] = load_req
        # ggrs-model: transitions(native->evicted)
        self._set_slot_state(index, SLOT_EVICTED)
        self._lockstep_slots[index] = self._tick_no
        self._m_demotions.inc()
        if self.timeline_sink is not None:
            try:
                self.timeline_sink(TL_DEMOTE_LOCKSTEP, index,
                                   {"frame": load_req.frame})
            except Exception:
                pass  # a broken sink must never block load-shedding
        self._fault_log[index].append(SlotFault(
            self._tick_no, 0,
            f"demoted to lockstep tier, resuming from frame "
            f"{load_req.frame}",
        ))
        if rec is not None:
            rec.record(self._tick_no, EV_EVICT,
                       f"demoted to lockstep from frame {load_req.frame}")
        return load_req.frame

    def in_lockstep(self, index: int) -> bool:
        """True when ``index`` was demoted to the lockstep tier (it runs
        a ``max_prediction == 0`` fallback session)."""
        return index in self._lockstep_slots

    def lockstep_slots(self) -> Dict[int, int]:
        """Demoted slots: index -> the pool tick the demotion ran on."""
        return dict(self._lockstep_slots)

    def attach_prediction_plane(self, plane) -> None:
        """Serve every fallback session's prediction-mode entries from
        one device-batched table (predict.batched, DESIGN.md §27): the
        plane gathers each queue's last-added input once per pool tick
        (``begin_tick`` in ``_advance_all_fallback``) and answers
        ``predict_at`` from the batched kernel's output.  Fallback pools
        only — batched predictors are deliberately not native-eligible,
        so a pool built with one always lands here."""
        if not self._finalized:
            self._finalize()
        if self._native_active:
            raise InvalidRequest(
                "the prediction plane serves the per-session fallback "
                "path; this pool runs the native bank (whose sync core "
                "predicts repeat-last in-kernel already)"
            )
        for i, session in enumerate(self._sessions):
            session.bind_prediction_plane(plane, i)
        self._prediction_plane = plane

    def prediction_plane(self):
        """The attached ``DevicePredictionPlane``, or None."""
        return self._prediction_plane

    # ------------------------------------------------------------------
    # broadcast seams (driven by broadcast.SpectatorHub)
    # ------------------------------------------------------------------

    def _attach_spectator(self, index: int, addr, magic: int,
                          handles: Optional[List[int]] = None) -> int:
        """Attach one fan-out endpoint to slot ``index`` (native path; the
        hub owns the policy and calls this).  Must happen before the match
        confirms its first frame — the native side refuses later joins."""
        if not self._finalized:
            self._finalize()
        if not self._native_active:
            raise InvalidRequest(
                "native spectator fan-out unavailable on this pool"
            )
        m = self._mirrors[index]
        if addr in m.addr_to_spec or addr in m.addr_to_ep:
            raise InvalidRequest(f"address {addr!r} already attached")
        sp_idx = self._lib.ggrs_bank_attach_spectator(
            self._bank, index, magic, self._clock()
        )
        if sp_idx < 0:
            raise InvalidRequest(
                "spectator attach refused (match already past frame 0?): "
                f"{_native.BANK_ERR_NAMES.get(sp_idx, sp_idx)}"
            )
        m.addr_to_spec[addr] = int(sp_idx)
        m.spectators.append(_SpectatorMirror(addr, magic, handles or []))
        self._m_spectators.labels(slot=str(index)).set(len(m.spectators))
        if self._io_attached[index]:
            # the native datapath must be able to route this viewer; an
            # unresolvable address drops the WHOLE slot back to the Python
            # shuttle (per-slot automatic fallback) rather than silently
            # never fanning out to one viewer
            try:
                ip, port = self._resolve_wire_addr(addr)
            except (TypeError, ValueError, OSError):
                self._detach_io(index)
            else:
                self._lib.ggrs_bank_map_addr(
                    self._bank, index, 1, int(sp_idx), ip, port
                )
        # the drain plan's per-slot wire map must learn the new viewer
        # (and a dispatch hub must claim its source address) before the
        # next tick's one-crossing drain
        self._refresh_drain()
        return int(sp_idx)

    def _detach_spectator(self, index: int, addr) -> None:
        """Detach a viewer: the native endpoint shuts down immediately (no
        disconnect linger) and stops receiving the stream."""
        if not self._finalized:
            self._finalize()
        m = self._mirrors[index]
        sp_idx = m.addr_to_spec.get(addr)
        if sp_idx is None:
            raise InvalidRequest(f"no spectator at address {addr!r}")
        if self._native_active and self._slot_state[index] in (
            SLOT_NATIVE, SLOT_QUARANTINED
        ):
            self._lib.ggrs_bank_detach_spectator(self._bank, index, sp_idx)
        sp = m.spectators[sp_idx]
        sp.running = False
        sp.deferred = []
        self._refresh_drain()
        if index in self._evicted:
            ep = self._evicted[index]._player_reg.spectators.get(addr)
            if ep is not None:
                ep.disconnect()

    def _disconnect_spectator(self, index: int, sp_idx: int) -> None:
        """Queue the hub's disconnect decision as next tick's ctrl op (the
        same one-tick-late policy application as remote disconnects)."""
        m = self._mirrors[index]
        m.pending_ctrl.append((3, sp_idx, 0))
        m.spectators[sp_idx].running = False

    def set_confirmed_stream(self, index: int, sink,
                             recovery=None) -> None:
        """Attach a journal sink: the slot's newly-confirmed frames arrive
        at ``sink.append_frames(start_frame, records)`` FROM THE TICK
        CROSSING (zero extra crossings; records are ``(blank_flags,
        joined_inputs)`` pairs).  ``recovery``, when given, is called if
        eviction's native harvest fails and must return a harvest-shaped
        dict built from the journal tail (crash recovery)."""
        if not self._finalized:
            self._finalize()
        if sink is None:
            self._journal_sinks.pop(index, None)
            self._journal_recovery.pop(index, None)
            if self._native_active:
                self._lib.ggrs_bank_set_confirmed_stream(
                    self._bank, index, 0
                )
            return
        if not self._native_active:
            raise InvalidRequest(
                "native confirmed-stream tap unavailable on this pool"
            )
        rc = self._lib.ggrs_bank_set_confirmed_stream(self._bank, index, 1)
        if rc != 0:
            raise InvalidRequest(
                "journal tap refused (match already past frame 0?): "
                f"{_native.BANK_ERR_NAMES.get(rc, rc)}"
            )
        self._journal_sinks[index] = sink
        if recovery is not None:
            self._journal_recovery[index] = recovery

    def spectator_states(self, index: int) -> List[Dict[str, Any]]:
        """Hub-facing mirror of one slot's fan-out endpoints: address,
        liveness, the viewer's ack watermark, and the catchup lag
        ((next_spectator_frame - 1) - last_acked).  On the Python-session
        paths (fallback pool, evicted slot) the live endpoints answer."""
        if not self._finalized:
            self._finalize()
        if not self._native_active or index in self._evicted:
            session = (
                self._evicted[index] if index in self._evicted
                else self._sessions[index]
            )
            tip = getattr(session, "_next_spectator_frame", 0) - 1
            out = []
            for addr, sp in session._player_reg.spectators.items():
                if not hasattr(sp, "_core"):
                    continue  # journal taps have no wire state
                la = getattr(sp._core, "last_acked_frame", None)
                la = la() if la is not None else NULL_FRAME
                out.append(dict(
                    addr=addr, running=sp.is_running(), last_acked=la,
                    catchup_lag=(
                        max(0, tip - la) if sp.is_running() else 0
                    ),
                ))
            return out
        m = self._mirrors[index]
        tip = m.next_spec_frame - 1
        return [
            dict(
                addr=sp.addr, running=sp.running, last_acked=sp.last_acked,
                catchup_lag=(
                    max(0, tip - sp.last_acked) if sp.running else 0
                ),
            )
            for sp in m.spectators
        ]

    # ------------------------------------------------------------------
    # batched socket datapath (docs/DESIGN.md §15): observables + seams
    # ------------------------------------------------------------------

    def _io_delta(self, slot: int, key, value: int) -> int:
        """Delta of a cumulative native counter since the last scrape (the
        registry's counters are inc-only; the NetBatch reports totals)."""
        k = (slot, key)
        prev = self._io_prev.get(k, 0)
        if value > prev:
            self._io_prev[k] = value
            return value - prev
        return 0

    def _bump_io_hist(self, fam, slot: int, key: str, buckets, sum_delta):
        """Fold one slot's cumulative batch-size buckets into the pool
        histogram (sum approximated by the datagram delta — a batch-size
        histogram's sum IS its datagram count)."""
        child = getattr(fam, "_default", None)
        if child is None or getattr(fam, "kind", "") != "histogram":
            return
        total = 0
        for j, v in enumerate(buckets):
            d = self._io_delta(slot, (key, j), v)
            child.counts[j] += d
            total += d
        child.count += total
        child.sum += sum_delta

    def _apply_io_metrics(self, stats: List[Dict[str, Any]]) -> None:
        """Refresh the io instruments from per-slot NetBatch records (the
        detach path's final-snapshot flush; the per-scrape walk uses
        :meth:`_apply_io_metrics_live`, driven by the attached-slot list
        instead of range(B))."""
        if not self._obs_on:
            return
        for s in stats:
            io = s.get("io")
            if io:
                self._apply_io_record(s["index"], io)

    def _apply_io_metrics_live(self, stats: List[Dict[str, Any]]) -> None:
        """The per-scrape io-delta walk, incremental: only the slots with
        a live NetBatch attachment are visited (``self._io_live``) — at
        B=256 with no native io this is a no-op, not 256 dict probes."""
        if not self._obs_on or not self._io_live:
            return
        for slot in self._io_live:
            io = stats[slot].get("io")
            if io:
                self._apply_io_record(slot, io)

    def _apply_io_record(self, slot: int, io: Dict[str, Any]) -> None:
        """Fold one slot's cumulative NetBatch counters into the registry
        instruments (delta-encoded: the native counters are totals)."""
        recv_d = self._io_delta(slot, "recv_datagrams",
                                io["recv_datagrams"])
        send_d = self._io_delta(slot, "send_datagrams",
                                io["send_datagrams"])
        self._m_io_recvmmsg.inc(
            self._io_delta(slot, "recv_calls", io["recv_calls"]))
        self._m_io_sendmmsg.inc(
            self._io_delta(slot, "send_calls", io["send_calls"]))
        self._m_io_dgrams_in.inc(recv_d)
        self._m_io_dgrams_out.inc(send_d)
        self._m_io_send_errors.inc(
            self._io_delta(slot, "send_errors", io["send_errors"]))
        self._m_io_oversized.inc(
            self._io_delta(slot, "oversized", io["oversized"]))
        self._bump_io_hist(self._m_io_recv_batch, slot, "rb",
                           io["recv_batches"], recv_d)
        self._bump_io_hist(self._m_io_send_batch, slot, "sb",
                           io["send_batches"], send_d)

    @property
    def native_io_active(self) -> bool:
        """At least one slot's datagrams flow through the kernel-batched
        native datapath (socket → crossing → socket, zero Python)."""
        if not self._finalized:
            self._finalize()
        return any(self._io_attached)

    def io_state(self, index: int) -> str:
        """``"native"`` when the slot's socket is attached to the batched
        datapath, ``"python"`` when it rides the per-datagram shuttle."""
        if not self._finalized:
            self._finalize()
        return "native" if self._io_attached[index] else "python"

    def io_stats(self) -> Dict[str, Any]:
        """Aggregated NetBatch counters over every attached slot (from
        the one-crossing stats scrape; all zeros when nothing is
        attached).  Keys: ``_native.IO_STAT_FIELDS``, plus ``drain`` (the
        one-crossing inbound drain's totals + ``crossings``), ``gso``
        (segmented-send totals), ``decode`` (the decode plane's counters)
        and ``capabilities`` (the per-feature fallback matrix)."""
        out: Dict[str, Any] = dict.fromkeys(_native.IO_STAT_FIELDS, 0)
        if not self._finalized:
            self._finalize()
        if self._native_active:
            for s in self._bank_stats():
                io = s.get("io")
                # a detached slot's live tail is gone; its retained final
                # snapshot keeps the totals monotonic
                if io is None:
                    io = self._io_final.get(s["index"])
                if io:
                    for k in _native.IO_STAT_FIELDS:
                        out[k] += io[k]
        out["drain"] = dict(
            self._drain_totals, crossings=self.drain_crossings
        )
        out["gso"] = dict(self._gso_totals)
        out["decode"] = (
            dict(self._decode_pool.stats(),
                 parallel_ticks=self.decode_parallel_ticks)
            if self._decode_pool is not None
            else {"backend": "serial", "workers": 1, "jobs": 0,
                  "batches": 0, "decode_ns": 0, "worker_jobs": {},
                  "parallel_ticks": 0}
        )
        out["capabilities"] = self.io_capabilities()
        return out

    def _io_set_capture(self, index: int, on: bool = True) -> None:
        """Test seam: tee every natively-sent datagram of slot ``index``
        into a drainable buffer (the wire-parity pin's capture side)."""
        if not self._finalized:
            self._finalize()
        if not self._io_attached[index]:
            raise InvalidRequest(f"slot {index} is not on the native io path")
        self._lib.ggrs_net_set_capture(
            self._net_handles[index], 1 if on else 0
        )

    def _io_drain_capture(self, index: int) -> List[Tuple[Any, bytes]]:
        """Drain slot ``index``'s capture tee: ``((ip, port), bytes)`` per
        datagram, in exact send order."""
        if not self._finalized:
            self._finalize()
        if not self._io_attached[index]:
            raise InvalidRequest(f"slot {index} is not on the native io path")
        handle = self._net_handles[index]
        buf = ctypes.create_string_buffer(1 << 16)
        out_len = ctypes.c_size_t(0)
        while True:
            rc = self._lib.ggrs_net_drain_capture(
                handle, buf, len(buf), ctypes.byref(out_len)
            )
            if rc == _native.BANK_ERR_BUFFER_TOO_SMALL:
                buf = ctypes.create_string_buffer(
                    max(out_len.value, 2 * len(buf))
                )
                continue
            if rc != 0:
                raise RuntimeError(f"ggrs_net_drain_capture failed: {rc}")
            break
        b = buf.raw[: out_len.value]
        out: List[Tuple[Any, bytes]] = []
        pos = 0
        unpack_from = struct.unpack_from
        while pos < len(b):
            ip, port, dlen = unpack_from("<IHI", b, pos)
            pos += 10
            addr = (_pysocket.inet_ntoa(ip.to_bytes(4, "little")), port)
            out.append((addr, b[pos : pos + dlen]))
            pos += dlen
        return out

    def inject_socket_errno(self, index: int, err: int,
                            count: int = 1) -> None:
        """Chaos hook: the next ``count`` datagrams slot ``index`` stages
        on the native datapath fail with errno ``err`` before any syscall
        — transient errnos (ENOBUFS, EAGAIN...) count as packet loss, a
        fatal errno faults the slot (``BANK_ERR_IO``) exactly like a
        raising ``sendto`` on the Python path."""
        if not self._finalized:
            self._finalize()
        if not self._io_attached[index]:
            raise InvalidRequest(f"slot {index} is not on the native io path")
        self._lib.ggrs_net_inject_send_errno(
            self._net_handles[index], int(err), int(count)
        )

    # ------------------------------------------------------------------
    # chaos hooks (tests + scripts/chaos.py)
    # ------------------------------------------------------------------

    def inject_datagram(self, index: int, from_addr, data: bytes) -> None:
        """Chaos hook: deliver raw datagram bytes to session ``index`` as if
        they arrived from ``from_addr``, without touching the network (other
        slots' traffic and fault-rng streams are unperturbed).  Native slots
        stage for the next tick's crossing; evicted slots process
        immediately through the session's receive path."""
        if not self._finalized:
            self._finalize()
        if not self._native_active:
            raise InvalidRequest("inject_datagram requires the native bank")
        state = self._slot_state[index]
        if state == SLOT_EVICTED:
            ep = self._evicted[index]._player_reg.remotes.get(from_addr)
            if ep is None:
                raise InvalidRequest(f"no endpoint for address {from_addr!r}")
            ep.handle_datagram(data)
            return
        if state != SLOT_NATIVE:
            # quarantined/dead slots process no traffic; dropping silently
            # would let a chaos run report clean without exercising its fault
            raise InvalidRequest(
                f"slot {index} is {state}: it processes no datagrams"
            )
        m = self._mirrors[index]
        ep_idx = m.addr_to_ep.get(from_addr)
        if ep_idx is None:
            raise InvalidRequest(f"no endpoint for address {from_addr!r}")
        self._inject_dgrams.setdefault(index, []).append((ep_idx, bytes(data)))

    def inject_slot_error(self, index: int, code: Optional[int] = None) -> None:
        """Chaos hook: make session ``index`` fault with ``code`` (default
        ``BANK_ERR_INJECTED``) on the next native tick — the stand-in for a
        real mid-tick native fault, driven through the real ctrl-op path."""
        if not self._finalized:
            self._finalize()
        if not self._native_active:
            raise InvalidRequest("inject_slot_error requires the native bank")
        if self._slot_state[index] != SLOT_NATIVE:
            raise InvalidRequest(
                f"slot {index} is {self._slot_state[index]}: only "
                "bank-resident slots can take a simulated native fault"
            )
        self._inject_err[index] = int(
            code if code is not None else _native.BANK_ERR_INJECTED
        )

    # ------------------------------------------------------------------
    # supervision observables
    # ------------------------------------------------------------------

    def slot_state(self, index: int) -> str:
        """``"native"`` (bank-resident, or the healthy fallback),
        ``"quarantined"``, ``"evicted"``, or ``"dead"``."""
        if not self._finalized:
            self._finalize()
        return self._slot_state[index]

    def fault_log(self, index: int) -> List[SlotFault]:
        if not self._finalized:
            self._finalize()
        return list(self._fault_log[index])

    def drain_state_transitions(self) -> List[Tuple[int, str, str, int]]:
        """Ship-and-clear the supervision transition feed: ``(slot, old,
        new, tick)`` per transition since the last drain (bounded at
        ``max(256, 2 * B)`` while undrained — sized to hold a whole
        shard-wide failure).  Incremental consumers — the fleet shard's
        forensics sweep — react to exactly these instead of polling every
        slot's state every tick."""
        out = self._state_transitions
        self._state_transitions = []
        return out

    # ------------------------------------------------------------------
    # observability: the one-crossing stat harvest (DESIGN.md §12)
    # ------------------------------------------------------------------

    def flight_recorder(self, index: int) -> Optional[FlightRecorder]:
        """The slot's flight recorder (None when metrics are disabled)."""
        if not self._finalized:
            self._finalize()
        return self._recorders[index] if self._recorders else None

    def flight_dump(self, index: int, last: int = 32) -> str:
        """Formatted dump of the slot's newest ``last`` recorded events —
        the post-mortem surface (also logged automatically on quarantine
        and eviction)."""
        rec = self.flight_recorder(index)
        if rec is None:
            return "  (flight recorder disabled)"
        return rec.dump(last)

    def scrape(self) -> List[Dict[str, Any]]:
        """Harvest every slot's protocol/sync counters and refresh the
        scrape gauges.  Native path: ONE ``ggrs_bank_stats`` ctypes
        crossing for the whole bank, cached per pool tick (repeat scrapes
        and ``network_stats`` calls within a tick reuse it) — the tick
        crossing count (``crossings``) is never touched; scrapes count in
        ``stat_crossings``.  Evicted slots report from their live Python
        session; quarantined slots report their frozen bank state.  The
        returned records are re-filled in place on the next scrape (zero
        steady-state allocation) — copy what you need to keep."""
        if not self._finalized:
            self._finalize()
        with trace_span("ggrs.obs.scrape"), self.tracer.span("pool.scrape"):
            if self._native_active:
                stats = self._bank_stats()
            else:
                stats = [
                    self._session_stats(i, s)
                    for i, s in enumerate(self._sessions)
                ]
            self._update_scrape_gauges(stats)
        return stats

    def native_phase_totals(self) -> Optional[Tuple[int, Dict[str, int]]]:
        """``(timed_ticks, {phase: total_ns})`` accumulated by the native
        phase timers since the bank was built — the cumulative view of the
        per-tick timing tail, refreshed by ``scrape()`` (it rides the
        stats crossing).  None until tracing is armed and a scrape ran."""
        return self._phase_totals

    def last_tick_phases(self) -> Optional[Dict[str, int]]:
        """The most recent tick's in-crossing phase ns (the same numbers
        re-emitted as ``bank.*`` trace spans), or None."""
        return self._last_phase_ns

    def _bank_stats(self) -> List[Dict[str, Any]]:
        if (
            self._stats_cache is not None
            and self._stats_cache[0] == self._tick_no
        ):
            return self._stats_cache[1]
        self.stat_crossings += 1
        self._m_cross_stats.inc()
        if self._scrape_buf is None:
            self._scrape_buf = ctypes.create_string_buffer(
                max(1 << 16, 256 * sum(
                    1 + len(m.endpoints) for m in self._mirrors
                ))
            )
        out_len = ctypes.c_size_t(0)
        while True:
            rc = self._lib.ggrs_bank_stats(
                self._bank, self._scrape_buf, len(self._scrape_buf),
                ctypes.byref(out_len),
            )
            if rc == _native.BANK_ERR_BUFFER_TOO_SMALL:
                self._scrape_buf = ctypes.create_string_buffer(
                    max(out_len.value, 2 * len(self._scrape_buf))
                )
                continue
            if rc != 0:
                raise RuntimeError(f"ggrs_bank_stats failed: {rc}")
            break
        stats = self._refresh_bank_records(out_len.value)
        self._apply_io_metrics_live(stats)
        # evicted (and dead-after-eviction) slots: the bank record froze at
        # fault time; the live numbers are the Python session's
        for i, session in self._evicted.items():
            stats[i] = self._session_stats(i, session)
        self._stats_cache = (self._tick_no, stats)
        return stats

    _EP_KEYS = (
        "state", "ping", "send_queue_len", "last_acked_frame",
        "last_recv_frame", "local_frames_behind", "remote_frames_behind",
        "frame_advantage", "packets_sent", "bytes_sent", "stats_start",
    )

    def _refresh_bank_records(self, n: int) -> List[Dict[str, Any]]:
        """Parse one ``ggrs_bank_stats`` dump (layout: session_bank.cpp)
        into the pool's record dicts, IN PLACE.

        Hot for the scrape budget: one ``unpack_from`` per record (header /
        endpoint, straight off the ctypes buffer) and zero steady-state
        allocation — the record dicts are built once and re-filled, so a
        caller that scrapes every tick at B=64 stays inside the <5% tick-p99
        budget instead of feeding the gen-0 GC ~500 dicts per tick.  The
        returned records are live views: valid until the next scrape."""
        if self._bank_records is None:
            self._bank_records = [
                dict(
                    index=i, state="", current_frame=0, last_confirmed=0,
                    ticks=0, rollbacks=0, rollback_frames=0,
                    max_rollback_depth=0, faults=0,
                    endpoints=[
                        dict.fromkeys(self._EP_KEYS, 0) | {
                            "addr": ep.addr,
                            "core": dict.fromkeys(_native.EP_STAT_FIELDS, 0),
                        }
                        for ep in m.endpoints
                    ],
                    next_spectator_frame=0,
                    spectators=[],
                    io=None,
                )
                for i, m in enumerate(self._mirrors)
            ]
        unpack_from = struct.unpack_from
        buf = self._scrape_buf
        end = n
        if self._trace_native:
            # cumulative timing tail (count byte last): u64 timed_ticks,
            # n_ph * u64 totals, u8 n_ph — parsed from the end, like the
            # tick output's tail
            (n_ph,) = unpack_from("<B", buf, n - 1)
            tail = 8 + 8 * n_ph + 1
            vals = unpack_from(f"<{n_ph + 1}Q", buf, n - tail)
            self._phase_totals = (
                vals[0], dict(zip(_phase_names(n_ph), vals[1:]))
            )
            end = n - tail
        pos = 0
        for i, rec in enumerate(self._bank_records):
            (rec["current_frame"], rec["last_confirmed"], rec["ticks"],
             rec["rollbacks"], rec["rollback_frames"],
             rec["max_rollback_depth"], rec["faults"], n_eps) = unpack_from(
                "<qq5QB", buf, pos
            )
            rec["state"] = self._slot_state[i]
            pos += 57
            if n_eps != len(rec["endpoints"]):
                raise RuntimeError("bank stats endpoint count mismatch")
            for es in rec["endpoints"]:
                (es["state"], es["ping"], es["send_queue_len"],
                 es["last_acked_frame"], es["last_recv_frame"],
                 es["local_frames_behind"], es["remote_frames_behind"],
                 es["frame_advantage"], es["packets_sent"],
                 es["bytes_sent"], es["stats_start"], c0, c1, c2, c3, c4,
                 c5, c6) = unpack_from("<B10q7Q", buf, pos)
                pos += 137
                core = es["core"]
                (core["emits"], core["emit_bytes"], core["acks"],
                 core["datagrams"], core["new_frames"], core["drops"],
                 core["fallbacks"]) = (c0, c1, c2, c3, c4, c5, c6)
            next_spec, n_specs = unpack_from("<qB", buf, pos)
            pos += 9
            rec["next_spectator_frame"] = next_spec
            specs = rec["spectators"]
            if len(specs) != n_specs:  # dynamic attach since last build
                del specs[:]
                specs.extend(
                    dict(addr=sp.addr, state=0, last_acked_frame=0,
                         pending_len=0, ping=0, packets_sent=0,
                         bytes_sent=0, stats_start=0)
                    for sp in self._mirrors[i].spectators[:n_specs]
                )
            for ss in specs:
                (ss["state"], ss["last_acked_frame"],
                 ss["pending_len"], ss["ping"], ss["packets_sent"],
                 ss["bytes_sent"], ss["stats_start"]) = unpack_from(
                    "<B6q", buf, pos
                )
                pos += 49
            # the batched-datapath tail (docs/DESIGN.md §15): u8 flag, then
            # 22 u64 NetBatch counters when this slot has a socket attached.
            # Refilled in place, like everything else here.
            (has_io,) = unpack_from("<B", buf, pos)
            pos += 1
            if has_io:
                words = unpack_from(
                    f"<{_native.IO_STAT_WORDS}Q", buf, pos
                )
                pos += 8 * _native.IO_STAT_WORDS
                nf = len(_native.IO_STAT_FIELDS)
                nb = len(_native.IO_BATCH_BUCKETS) + 1
                io = rec["io"]
                if io is None:
                    io = rec["io"] = dict.fromkeys(
                        _native.IO_STAT_FIELDS, 0
                    ) | {"recv_batches": [0] * nb,
                         "send_batches": [0] * nb}
                for k, v in zip(_native.IO_STAT_FIELDS, words):
                    io[k] = v
                io["recv_batches"][:] = words[nf:nf + nb]
                io["send_batches"][:] = words[nf + nb:]
            else:
                rec["io"] = None
        if pos != end:
            raise RuntimeError("bank stats buffer layout mismatch")
        # a fresh list (the evicted overrides below must not clobber the
        # master records); the dicts themselves are shared live views
        return list(self._bank_records)


    _EP_STATE_CODE = {
        "running": 0, "disconnected": 1, "shutdown": 2, "synchronizing": 3,
    }

    def _session_stats(self, index: int, session: Any) -> Dict[str, Any]:
        """The same record shape as ``_parse_bank_stats``, read from a live
        ``P2PSession`` (the fallback path and evicted slots)."""
        endpoints: List[Dict[str, Any]] = []
        for ep in session._remote_endpoints:
            core_obj = ep._core
            last_acked = getattr(core_obj, "last_acked_frame", None)
            endpoints.append(dict(
                addr=ep.peer_addr,
                state=self._EP_STATE_CODE.get(ep._state, 1),
                ping=ep._round_trip_time,
                send_queue_len=core_obj.pending_len(),
                last_acked_frame=(
                    last_acked() if last_acked is not None else NULL_FRAME
                ),
                last_recv_frame=ep.last_recv_frame(),
                local_frames_behind=ep.local_frame_advantage,
                remote_frames_behind=ep.remote_frame_advantage,
                frame_advantage=ep.average_frame_advantage(),
                packets_sent=ep._packets_sent,
                bytes_sent=ep._bytes_sent,
                stats_start=ep._stats_start_time,
                core={k: 0 for k in _native.EP_STAT_FIELDS},
            ))
        return dict(
            index=index, state=self._slot_state[index],
            current_frame=session.current_frame,
            last_confirmed=session._sync_layer.last_confirmed_frame,
            ticks=getattr(session, "_stat_ticks", 0),
            rollbacks=getattr(session, "_stat_rollbacks", 0),
            rollback_frames=getattr(session, "_stat_rollback_frames", 0),
            max_rollback_depth=getattr(session, "_stat_max_rollback", 0),
            faults=len(self._fault_log[index]),
            endpoints=endpoints,
            next_spectator_frame=getattr(
                session, "_next_spectator_frame", 0
            ),
            spectators=[
                dict(addr=addr, state=0 if sp.is_running() else 1,
                     last_acked_frame=getattr(
                         sp._core, "last_acked_frame", lambda: NULL_FRAME
                     )(),
                     pending_len=sp._core.pending_len(),
                     ping=getattr(sp, "_round_trip_time", 0),
                     packets_sent=getattr(sp, "_packets_sent", 0),
                     bytes_sent=getattr(sp, "_bytes_sent", 0),
                     stats_start=getattr(sp, "_stats_start_time", 0))
                for addr, sp in getattr(
                    session._player_reg, "spectators", {}
                ).items()
                if hasattr(sp, "_core")  # journal taps have no wire state
            ],
        )

    def _gauge_setters(self, index: int, n_eps: int):
        """Prebound ``Gauge.set`` methods for one slot — label resolution
        (dict lookups + str conversions) happens once per pool lifetime,
        not once per scrape (the scrape budget at B=64 is dominated by
        exactly this)."""
        cached = self._setter_cache.get(index)
        if cached is not None and len(cached[1]) == n_eps:
            return cached
        slot = str(index)
        slot_set = (
            self._m_slot_frame.labels(slot=slot).set,
            self._m_slot_occupancy.labels(slot=slot).set,
            self._m_slot_rollbacks.labels(slot=slot).set,
            self._m_slot_rollback_depth.labels(slot=slot).set,
        )
        ep_set = []
        for e in range(n_eps):
            ep = str(e)
            ep_set.append((
                self._m_ep_ping.labels(slot=slot, endpoint=ep).set,
                self._m_ep_queue.labels(slot=slot, endpoint=ep).set,
                self._m_ep_kbps.labels(slot=slot, endpoint=ep).set,
                self._m_ep_behind.labels(
                    slot=slot, endpoint=ep, side="local"
                ).set,
                self._m_ep_behind.labels(
                    slot=slot, endpoint=ep, side="remote"
                ).set,
            ))
        cached = (slot_set, ep_set)
        self._setter_cache[index] = cached
        return cached

    def _refresh_predict_metrics(self) -> None:
        """Fold the Python-tier prediction-accuracy counters (input-queue
        mispredict accounting, DESIGN.md §28) and the device plane's
        adopt/decline tallies into the ``ggrs_predict_*`` family, as
        deltas against the previous scrape.  Rides the existing scrape
        cadence: zero extra ctypes crossings, zero extra RPC traffic."""
        mis = plane_mis = depth = 0
        seen_ids = set()
        for session in list(self._sessions) + list(self._evicted.values()):
            if id(session) in seen_ids:
                continue
            seen_ids.add(id(session))
            sl = getattr(session, "_sync_layer", None)
            if sl is None:
                continue
            for q in sl.input_queues:
                mis += q.mispredicts
                plane_mis += q.plane_mispredicts
                depth += q.mispredict_depth_frames
        hits = fallbacks = 0
        if self._prediction_plane is not None:
            st = self._prediction_plane.stats()
            hits = st.get("hits", 0)
            fallbacks = st.get("fallbacks", 0)
        prev = self._predict_seen
        d_plane = max(0, plane_mis - prev[1])
        d_scalar = max(0, (mis - plane_mis) - (prev[0] - prev[1]))
        d_depth = max(0, depth - prev[2])
        d_hits = max(0, hits - prev[3])
        d_fallbacks = max(0, fallbacks - prev[4])
        if d_plane:
            self._m_mis_plane.inc(d_plane)
        if d_scalar:
            self._m_mis_scalar.inc(d_scalar)
        if d_depth:
            self._m_mis_depth.inc(d_depth)
        if d_hits:
            self._m_pred_adopt.inc(d_hits)
        if d_fallbacks:
            self._m_pred_fallback.inc(d_fallbacks)
        self._predict_seen = [mis, plane_mis, depth, hits, fallbacks]

    def _update_scrape_gauges(self, stats: List[Dict[str, Any]]) -> None:
        if not self._obs_on:
            return
        self._refresh_predict_metrics()
        now = self._now_ms()
        for s in stats:
            slot_set, ep_set = self._gauge_setters(
                s["index"], len(s["endpoints"])
            )
            current = s["current_frame"]
            confirmed = s["last_confirmed"]
            slot_set[0](current)
            slot_set[1](
                current - confirmed if confirmed != NULL_FRAME else current
            )
            slot_set[2](s["rollbacks"])
            slot_set[3](s["max_rollback_depth"])
            for es, (set_ping, set_queue, set_kbps, set_local,
                     set_remote) in zip(s["endpoints"], ep_set):
                set_ping(es["ping"])
                set_queue(es["send_queue_len"])
                set_kbps(self._kbps(es, now))
                set_local(es["local_frames_behind"])
                set_remote(es["remote_frames_behind"])
            specs = s.get("spectators")
            if specs:
                # broadcast gauges: how far each viewer's ack trails the
                # broadcast tip (the stream stall detector).  Setters are
                # prebound per (slot, spectator) — zero label resolution
                # or str() allocation on the steady-state scrape.
                tip = s.get("next_spectator_frame", 0) - 1
                idx = s["index"]
                spec_set = self._spec_setter_cache.get(idx)
                if spec_set is None or len(spec_set) < len(specs):
                    slot = str(idx)
                    spec_set = [
                        self._m_spec_lag.labels(
                            slot=slot, spectator=str(e)
                        ).set
                        for e in range(len(specs))
                    ]
                    self._spec_setter_cache[idx] = spec_set
                for e, ss in enumerate(specs):
                    lag = (
                        max(0, tip - ss["last_acked_frame"])
                        if ss["state"] == 0 else 0
                    )
                    spec_set[e](lag)

    def _now_ms(self) -> int:
        clock = self._clock
        if clock is None:
            if not self._builders:
                return 0
            clock = self._builders[0][0]._clock
        return clock()

    def _kbps(self, es: Dict[str, Any], now: Optional[int] = None) -> int:
        """``PeerProtocol.network_stats``'s bandwidth estimate over one
        harvested endpoint record (0 before a second has elapsed)."""
        if now is None:
            now = self._now_ms()
        seconds = (now - es["stats_start"]) // 1000
        if seconds <= 0:
            return 0
        total = es["bytes_sent"] + es["packets_sent"] * UDP_HEADER_SIZE
        return (total // seconds) // 1024

    def network_stats(self, index: int, handle: int) -> NetworkStats:
        """``P2PSession.network_stats`` parity for pooled slots: the same
        ``NetworkStats`` dataclass, for NATIVE, QUARANTINED and EVICTED
        slots alike.  Native/quarantined slots read the one-crossing stat
        harvest (cached per tick); evicted slots delegate to their live
        Python session; a DEAD slot that never evicted raises
        ``StatsUnavailable`` (there is nothing live to measure).  Raises
        ``BadPlayerHandle`` for local/unknown handles and
        ``StatsUnavailable`` before any time has elapsed or when the
        endpoint is not running — exactly the per-session contract."""
        if not self._finalized:
            self._finalize()
        if not self._native_active:
            return self._sessions[index].network_stats(handle)
        if index in self._evicted:
            return self._evicted[index].network_stats(handle)
        if self._slot_state[index] in (SLOT_DEAD, SLOT_MIGRATED):
            raise StatsUnavailable()
        m = self._mirrors[index]
        ep_idx = next(
            (e for e, ep in enumerate(m.endpoints) if handle in ep.handles),
            None,
        )
        if ep_idx is None:
            raise BadPlayerHandle()
        es = self._bank_stats()[index]["endpoints"][ep_idx]
        if es["state"] != 0:
            raise StatsUnavailable()
        if (self._clock() - es["stats_start"]) // 1000 == 0:
            raise StatsUnavailable()
        stats = NetworkStats(
            ping=es["ping"],
            send_queue_len=es["send_queue_len"],
            kbps_sent=self._kbps(es),
            local_frames_behind=es["local_frames_behind"],
            remote_frames_behind=es["remote_frames_behind"],
        )
        sock_stats = getattr(m.socket, "stats", None)
        if sock_stats is not None:
            stats.send_errors = sock_stats.send_errors
        return stats

    # ------------------------------------------------------------------
    # policy helpers (the Python halves of the split)
    # ------------------------------------------------------------------

    def _on_protocol_disconnected(self, m: _SessionMirror, ep_idx: int) -> None:
        """EvDisconnected from an endpoint: mirror
        ``P2PSession._handle_event`` — mark the endpoint's players
        disconnected (via next tick's ctrl op) and surface the user event."""
        ep = m.endpoints[ep_idx]
        for handle in ep.handles:
            m.pending_ctrl.append((1, ep_idx, m.local_last[handle]))
            m.local_disc[handle] = True  # mirror eagerly for the policy reads
        ep.running = False
        m.push_event((_LZ_DISCONNECTED, ep.addr))

    def _run_consensus(self, m: _SessionMirror) -> None:
        """``P2PSession._update_player_disconnects`` over the mirrors; the
        resulting disconnects become next tick's ctrl ops."""
        n = m.num_players
        queue_connected = [True] * n
        queue_min = [2**31 - 1] * n
        for ep in m.endpoints:
            if not ep.running:
                continue
            for h in range(n):
                if ep.peer_disc[h]:
                    queue_connected[h] = False
                if ep.peer_last[h] < queue_min[h]:
                    queue_min[h] = ep.peer_last[h]
        handle_to_ep = {
            h: i for i, ep in enumerate(m.endpoints) for h in ep.handles
        }
        for h in range(n):
            local_connected = not m.local_disc[h]
            local_min = m.local_last[h]
            min_confirmed = queue_min[h]
            if local_connected:
                min_confirmed = min(min_confirmed, local_min)
            if not queue_connected[h] and (
                local_connected or local_min > min_confirmed
            ):
                ep_idx = handle_to_ep.get(h)
                if ep_idx is not None:
                    m.pending_ctrl.append((1, ep_idx, min_confirmed))
                    for eh in m.endpoints[ep_idx].handles:
                        m.local_disc[eh] = True
                    m.endpoints[ep_idx].running = False

    def _store_checksum(self, ep: _EndpointMirror, frame: Frame,
                        checksum: int) -> None:
        """``PeerProtocol._on_checksum_report`` with interval 1 (desync
        detection is off for bank-eligible sessions)."""
        if len(ep.pending_checksums) >= MAX_CHECKSUM_HISTORY_SIZE:
            oldest = frame - (MAX_CHECKSUM_HISTORY_SIZE - 1)
            ep.pending_checksums = {
                f: c for f, c in ep.pending_checksums.items() if f >= oldest
            }
        ep.pending_checksums[frame] = checksum

    # ------------------------------------------------------------------
    # observables (API parity with P2PSession where the pool's callers and
    # tests read it)
    # ------------------------------------------------------------------

    def events(self, index: int) -> List:
        if not self.native_active:  # property finalizes lazily
            return self._sessions[index].events()
        if index in self._evicted:  # evicted (or dead after eviction)
            return self._evicted[index].events()
        m = self._mirrors[index]
        # lazy decode (DESIGN.md §19): the queue holds tag tuples; the
        # public GgrsEvent objects are constructed only here, on drain
        out = _materialize_events(m.event_queue)
        m.event_queue.clear()
        return out

    def current_frame(self, index: int) -> Frame:
        if not self.native_active:
            return self._sessions[index].current_frame
        if index in self._evicted:
            return self._evicted[index].current_frame
        return self._mirrors[index].current_frame

    def last_confirmed_frame(self, index: int) -> Frame:
        if not self.native_active:
            return self._sessions[index]._sync_layer.last_confirmed_frame
        if index in self._evicted:
            return self._evicted[index]._sync_layer.last_confirmed_frame
        return self._mirrors[index].last_confirmed

    def frames_ahead(self, index: int) -> int:
        if not self.native_active:
            return self._sessions[index].frames_ahead()
        if index in self._evicted:
            return self._evicted[index].frames_ahead()
        return self._mirrors[index].frames_ahead

    def session(self, index: int):
        """The underlying P2PSession: always present on the fallback path,
        and present for EVICTED slots on the native path (the bank itself
        has no per-session objects)."""
        if not self.native_active:
            return self._sessions[index]
        if index in self._evicted:
            return self._evicted[index]
        raise InvalidRequest(
            "native bank active: this slot has no per-session object"
        )

    def _check_valid(self) -> None:
        if self._invalid is not None:
            raise RuntimeError(
                f"pool was invalidated by an earlier failed tick "
                f"({self._invalid}); rebuild it"
            )

    def __del__(self) -> None:  # pragma: no cover
        try:
            if self._decode_pool is not None:
                self._decode_pool.close()
                self._decode_pool = None
            if self._bank and self._lib is not None:
                self._lib.ggrs_bank_free(self._bank)
                self._bank = None
            if self._lib is not None:
                for i, handle in enumerate(self._net_handles):
                    if handle:
                        self._net_handles[i] = None
                        self._lib.ggrs_net_free(handle)
        except Exception:
            pass


def adopt_resume_bundle(builder, socket, bundle: Dict[str, Any], *,
                        journal=None, saved_states=None):
    """Resume a migrated match on THIS side of the wire: build a fresh
    ``P2PSession`` from an ``export_resume_state`` bundle (or a
    journal-synthesized equivalent), the destination half of match
    migration.

    ``builder`` must describe the SAME match topology as the source slot
    (player count, config, remote and spectator addresses); the adopted
    wire identities (endpoint magics, send and receive windows, connect
    mirrors) make the peers and viewers see a retransmission hiccup, never
    a new endpoint.  ``journal``, when given, is tapped so the resumed
    session keeps journaling its confirmed stream (``JournalTap``).

    Returns ``(session, load_request)``: the caller leads the session's
    next request list with ``load_request`` so the game restores the state
    saved at the resume frame (the bundle carries that state; its cell is
    pre-filled).

    ``saved_states``: a pre-built ``SavedStates`` ring for callers that
    rebuild the resume state some other way; when given, the bundle's
    ``state_blob`` is ignored and the caller owns filling the resume cell."""
    h = bundle["harvest"]
    resume = bundle["resume_frame"]
    if saved_states is None:
        saved = SavedStates(bundle["max_prediction"])
        data, checksum = pickle.loads(bundle["state_blob"])
        saved.get_cell(resume).save(resume, data, checksum)
    else:
        saved = saved_states
    cell = saved.get_cell(resume)
    session = builder.start_p2p_session(socket)
    endpoint_states: Dict[Any, Dict[str, Any]] = {}
    for e, em in enumerate(bundle["endpoints"]):
        he = h["endpoints"][e]
        endpoint_states[em["addr"]] = dict(
            magic=em["magic"],
            running=he["state"] == 0,
            peer_connect_status=list(zip(em["peer_disc"], em["peer_last"])),
            last_recv_frame=he["last_recv"],
            recv_entries=he["recv_entries"],
            last_acked_frame=he["last_acked_frame"],
            send_base=he["send_base"],
            pending=he["pending"],
            pending_checksums=em.get("pending_checksums") or {},
        )
    session.adopt_resume_state(
        frame=resume,
        last_confirmed=resume,
        saved_states=saved,
        connect_status=list(zip(h["local_disc"], h["local_last"])),
        player_inputs=h["player_inputs"],
        endpoint_states=endpoint_states,
        next_recommended_sleep=bundle.get("next_recommended_sleep", 0),
        pending_events=list(bundle.get("pending_events", ())),
        next_spectator_frame=h.get("next_spectator_frame", 0),
    )
    if bundle.get("spectators"):
        from ..broadcast.hub import graft_spectator_endpoints

        spec_states = h.get("spectators") or []
        graft_spectator_endpoints(session, builder, [
            dict(sp, state=spec_states[e] if e < len(spec_states) else None)
            for e, sp in enumerate(bundle["spectators"])
        ])
    if journal is not None:
        from ..broadcast.journal import JournalTap

        session.adopt_spectator_endpoint(
            JournalTap.ADDR, JournalTap(journal, builder._config)
        )
    decode = builder._config.input_decode
    for handle, blob in (bundle.get("staged_inputs") or {}).items():
        session.add_local_input(int(handle), decode(blob))
    # bundle-adopted sessions are pool-owned by definition: their request
    # lists are consumed tick-synchronously, so they take the pooled-request
    # path too
    session.enable_request_pooling()
    return session, LoadGameState(cell=cell, frame=resume)
