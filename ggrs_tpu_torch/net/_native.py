"""ctypes bindings of the native host code: the input codec and message
framing (``csrc/host/codec.cpp``), the endpoint datapath
(``csrc/host/endpoint.cpp``), the sync core (``csrc/host/sync_core.cpp``), the
session bank with its spectator fan-out, confirmed-stream tap and socket pump
(``csrc/host/session_bank.cpp``) and the kernel-batched socket datapath
(``csrc/host/net_batch.cpp``: per-socket ``NetBatch`` recvmmsg/sendmmsg, the
one-crossing send and receive tables, GSO and GRO).

The port's own copy of the bindings of ``ggrs_tpu/net/_native.py``, with the
packed-table layouts the bank and the datapath speak (``BANK_HDR_FIELDS``,
``BANK_REQ_FIELDS``, ``BANK_STAGE_FIELDS``, ``NET_SEND_FIELDS``,
``NET_FD_FIELDS``, ``NET_ROUTE_FIELDS``, ``NET_RECV_FIELDS``); every stride is
checked against the library when it loads, and a skew raises.  The sources are the package's
own ``csrc/host/*.cpp``, compiled into one host library by
``_build.build_host`` at first use (``g++``, into ``ggrs_tpu_torch/_build/``).
A failed build raises: nothing here quietly serves the Python codec or cores
instead.  ``GGRS_TPU_NO_NATIVE=1``, read as the JAX package reads it (before
the library is loaded, and by the sync core's eligibility gate at each
``SyncLayer``), is the caller asking for the Python implementations; the
Python codec, message framing and cores remain the semantic reference.
``GGRS_NATIVE_SANITIZE`` (``1``/``address`` for ASan+UBSan, ``thread`` for
TSan), read when the library is first loaded, binds the sanitizer-built
variant of the host library instead (``_build.sanitize_mode``); the process
must have the sanitizer's runtime preloaded.

``encode``, ``decode``, ``msg_encode`` and ``msg_decode`` return None where
the caller must take the Python path: the library is switched off, or a
packet is legal but exceeds the fast path's resource caps (an oversize
packet is legal and goes to the Python codec).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

from .. import _build
from .wire import WireError

# Resource caps for the fast path.  Real packets sit under the ~508-byte UDP
# budget with at most the 128-input pending window; anything bigger (but
# still legal for the Python codec, whose hard cap is 1<<22 bytes) falls back
# to the Python implementation rather than holding megabytes of scratch.
_DECODE_CAP_BYTES = 1 << 20
_DECODE_CAP_INPUTS = 4096
# error codes that mean "packet exceeded the fast path's resources", not
# "packet is malformed": codec.cpp's kErrBufferTooSmall / kErrTooManyInputs
_RESOURCE_ERRORS = (-11, -12)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_decode_out = None
_decode_sizes = None

_ERROR_NAMES = {
    -1: "truncated data",
    -2: "uvarint too long",
    -3: "decoded data exceeds maximum size",
    -4: "literal run exceeds remaining data",
    -5: "invalid size-mode byte",
    -6: "input size is negative or too large",
    -7: "decoded byte count does not match expected sizes",
    -8: "reference must be non-empty to decode inputs of unknown size",
    -9: "encoded bytes not a multiple of the reference size",
    -10: "trailing bytes after message",
    -11: "output buffer too small",
    -12: "too many inputs",
}

# must mirror struct GgrsMsg in csrc/host/codec.cpp field for field (ctypes
# reproduces the C compiler's alignment and padding for same-ordered fields)
_MAX_PLAYERS_ON_WIRE = 64


class _GgrsMsg(ctypes.Structure):
    _fields_ = [
        ("magic", ctypes.c_uint16),
        ("tag", ctypes.c_uint8),
        ("disconnect_requested", ctypes.c_uint8),
        ("start_frame", ctypes.c_int64),
        ("ack_frame", ctypes.c_int64),
        ("frame", ctypes.c_int64),
        ("frame_advantage", ctypes.c_int16),
        ("ping", ctypes.c_uint64),
        ("pong", ctypes.c_uint64),
        ("checksum_lo", ctypes.c_uint64),
        ("checksum_hi", ctypes.c_uint64),
        ("random_nonce", ctypes.c_uint64),
        ("n_status", ctypes.c_int32),
        ("payload_off", ctypes.c_uint64),
        ("payload_len", ctypes.c_uint64),
        ("status_disconnected", ctypes.c_uint8 * _MAX_PLAYERS_ON_WIRE),
        ("status_last_frame", ctypes.c_int64 * _MAX_PLAYERS_ON_WIRE),
    ]


# message-framing error codes (codec.cpp's msg section); kMsgFallback means
# "legal for Python's unbounded ints but not for the fast path": callers
# retry with the Python decoder
_MSG_FALLBACK = -100
_MSG_ERROR_NAMES = {
    -1: "truncated data",
    -2: "uvarint too long",
    -20: "invalid bool byte",
    -21: "unknown message tag",
    -22: "too many connect statuses",
    -23: "trailing bytes after message",
}

# endpoint-datapath return codes (csrc/host/endpoint.cpp)
EP_DROP = -30
EP_FALLBACK = -31
EP_BAD_PENDING_HEAD = -32
EP_ERR_BUFFER_TOO_SMALL = -11
EP_ERR_TOO_MANY_INPUTS = -12  # kErrTooManyInputs: > _MAX_PLAYERS_ON_WIRE

# sync-core return codes (csrc/host/sync_core.cpp SyncRc)
SYNC_OK = 0
SYNC_ERR_PREDICTION_PENDING = -40
SYNC_ERR_BEFORE_TAIL = -41
SYNC_ERR_NO_CONFIRMED = -42
SYNC_ERR_NON_SEQUENTIAL = -43
SYNC_ERR_CONFIRM_PAST_INCORRECT = -44
SYNC_ERR_BAD_ARGS = -45
SYNC_ERR_QUEUE_FULL = -46  # kSyncErrQueueFull: 128-slot ring exhausted

# session-bank return codes (mirror csrc/host/session_bank.cpp; the buffer
# code is wire_common.h's kErrBufferTooSmall, shared with the codec)
BANK_ERR_BUFFER_TOO_SMALL = -11
BANK_OK = 0
BANK_ERR_CMD = -60
BANK_ERR_LANDED_SPLIT = -70
BANK_ERR_SYNC = -71
BANK_ERR_SYNC_INPUTS = -72
BANK_ERR_CONFIRM = -73
BANK_ERR_NO_PLAYERS = -74
BANK_ERR_SEQUENCE = -75
BANK_ERR_INJECTED = -76  # chaos-harness simulated slot fault (ctrl op 2)
BANK_ERR_SPEC_STREAM = -77  # confirmed-input fan-out / journal tap failed
BANK_ERR_IO = -78  # batched socket I/O failed fatally (per-slot fault)

# net_batch.cpp return codes
NET_OK = 0
NET_ERR_UNSUPPORTED = -80
NET_ERR_FATAL = -81
NET_ERR_BAD_ARGS = -82

# NetBatch counter order (ggrs_net_stats; also the per-slot io tail of
# ggrs_bank_stats).  After the six scalars come two 8-bucket batch-size
# histograms (recv then send) with upper bounds IO_BATCH_BUCKETS + inf.
IO_STAT_FIELDS = (
    "recv_calls", "recv_datagrams", "send_calls", "send_datagrams",
    "send_errors", "oversized",
)
IO_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
IO_STAT_WORDS = len(IO_STAT_FIELDS) + 2 * (len(IO_BATCH_BUCKETS) + 1)  # 22

# endpoint-core observability counter order (ggrs_ep_stats; also the
# per-endpoint tail of each ggrs_bank_stats record)
EP_STAT_FIELDS = (
    "emits", "emit_bytes", "acks", "datagrams", "new_frames", "drops",
    "fallbacks",
)
# per-session command-stream flag byte (session_bank.cpp kFlag*): bit 0 =
# local inputs present (advance runs), bit 1 = skip (slot quarantined or
# evicted, no further fields follow), bit 2 = staged (inputs were staged
# natively through ggrs_bank_stage_inputs: no inline input bytes follow)
CMD_FLAG_INPUTS = 1
CMD_FLAG_SKIP = 2
CMD_FLAG_STAGED = 4

# Batched input staging record (ggrs_bank_stage_inputs): one fixed-stride
# descriptor per staged input, jumping into a shared payload blob.  `frame`
# is reserved (NULL_FRAME: "this tick"); `len` must equal the slot's
# input size.
BANK_STAGE_FIELDS = (
    ("slot", "<u4"), ("handle", "<i4"), ("frame", "<i8"),
    ("off", "<u4"), ("len", "<u4"),
)  # itemsize 24 == ggrs_bank_stage_stride()
BANK_STAGE_STRIDE = 24

# Per-slot request descriptor record (the SECOND fixed-stride table of
# every tick output, after the header table): the tick's request program as
# flat data, so the pool's decode and BatchedRequestExecutor's dispatch read
# numpy columns instead of parsing op bytes per slot.
BANK_REQ_FIELDS = (
    ("pattern", "<u1"), ("rflags", "<u1"), ("n_adv", "<u2"),
    ("adv_off", "<u4"), ("adv_stride", "<u4"), ("ops_end", "<u4"),
    ("frame", "<i8"),
)  # itemsize 24 == ggrs_bank_req_stride()
BANK_REQ_STRIDE = 24
REQ_OTHER = 0       # unclassified shape: use the generic op decoder
REQ_QUIET = 1       # ops are exactly [save frame, advance]
REQ_RESIM = 2       # [load frame, adv, (save, adv)*, save] (+ trailing adv)
REQ_SAVE_ONLY = 3   # [save frame]: the prediction-limit tick
REQ_EMPTY = 4       # no ops (skip / faulted records)
REQ_FLAG_TRAILING_ADV = 1  # the tick's last op was an advance ("advanced")

# Batched outbound send record (net_batch.cpp ggrs_net_send_table): per
# datagram fd + wire address + a jump into the shared payload (usually the
# tick output buffer itself).  Records for one fd form one contiguous run.
NET_SEND_FIELDS = (
    ("fd", "<i4"), ("ip", "<u4"), ("port", "<u2"), ("flags", "<u2"),
    ("off", "<u4"), ("len", "<u4"),
)  # itemsize 20 == net_batch.cpp kSendStride
NET_SEND_STRIDE = 20
# ``flags`` bit 0 marks a record on a SHARED dispatch fd: a fatal errno there
# faults only that record's slot, and the co-tenants' records keep flushing
NET_SEND_FLAG_DISPATCH = 1  # net_batch.cpp kSendFlagDispatch
# ggrs_net_send_table stats words: {sent, transient_errors, oversized,
# gso_sends, gso_segments}
NET_SEND_STATS = 5

# The one-crossing inbound drain (ggrs_net_recv_table).  The fd table names
# every socket to drain (slot == -1 marks a shared dispatch fd demuxed by
# source address); the route table maps (ip, port) -> slot and is sorted
# ascending by (ip << 16) | port; the record table describes each received
# datagram as a jump into the shared slab, in per-fd arrival order.
NET_FD_FIELDS = (
    ("fd", "<i4"), ("slot", "<i4"),
)  # itemsize 8 == net_batch.cpp kFdStride
NET_FD_STRIDE = 8
NET_ROUTE_FIELDS = (
    ("ip", "<u4"), ("port", "<u2"), ("pad", "<u2"), ("slot", "<i4"),
)  # itemsize 12 == net_batch.cpp kRouteStride
NET_ROUTE_STRIDE = 12
NET_RECV_FIELDS = (
    ("slot", "<i4"), ("fd_idx", "<i4"), ("ip", "<u4"), ("port", "<u2"),
    ("seg", "<u2"), ("off", "<u4"), ("len", "<u4"),
)  # itemsize 24 == net_batch.cpp kRecvStride; ``seg`` is the segment index
# when a GRO-coalesced train was split back into wire datagrams (else 0)
NET_RECV_STRIDE = 24
# ggrs_net_recv_table stats words (net_batch.cpp kRecvTableStats):
# {recv_calls, datagrams, unroutable, backpressure_stops}, the 8-bucket
# batch-size histogram (bounds IO_BATCH_BUCKETS + inf) in words [4..11],
# then the GRO tail (gro_datagrams, gro_segments) in [12..13].  ``datagrams``
# counts post-split wire datagrams, equal to the count with GRO off.
NET_RECV_TABLE_STAT_FIELDS = (
    "recv_calls", "datagrams", "unroutable", "backpressure_stops",
    "gro_datagrams", "gro_segments",
)
NET_RECV_TABLE_STATS = 14

# packed per-tick output header (session_bank.cpp kHdr*): one record per
# session leads the tick output.  The pool classifies all B slots from this
# table; slots with no event, spectator, consensus or status-mirror activity
# take the fast path.
BANK_HDR_LIVE = 1        # stepped this tick and err == 0
BANK_HDR_QUIET = 2       # ops are exactly [save, advance]
BANK_HDR_EVENTS = 4      # protocol events present
BANK_HDR_SPEC = 8        # spectator endpoints / streams / events present
BANK_HDR_CONSENSUS = 16  # disconnect consensus pending
BANK_HDR_DIRTY = 32      # a status mirror changed this tick
BANK_HDR_OUT = 64        # outbound datagram sections non-empty
BANK_HDR_SKIP = 128      # status-only record (slot was skipped)
BANK_HDR_CONF = 256      # journal-tap confirmed records present
BANK_HDR_FIELDS = (
    ("flags", "<u4"), ("rec_len", "<u4"), ("err", "<i4"), ("fa", "<i4"),
    ("landed", "<i8"), ("current", "<i8"), ("confirmed", "<i8"),
    ("save_frame", "<i8"),
)  # itemsize 48 == ggrs_bank_hdr_stride()

# in-crossing phase order (session_bank.cpp BankPhase; the timing tails of
# the tick and stats outputs carry one u64 of nanoseconds per entry, in this
# order, with the count byte last).  "staging" accrues OUTSIDE the tick
# window (the ggrs_bank_stage_inputs crossings since the last tick).
BANK_PHASES = (
    "inbound", "timers", "commit", "rollback", "outbound", "fanout",
    "emit", "other", "staging",
)

BANK_ERR_NAMES = {
    BANK_ERR_CMD: "malformed command stream",
    BANK_ERR_LANDED_SPLIT: "local inputs landed on different frames",
    BANK_ERR_SYNC: "sync-core operation failed",
    BANK_ERR_SYNC_INPUTS: "synchronized-input assembly failed",
    BANK_ERR_CONFIRM: "confirmed-frame watermark invariant broken",
    BANK_ERR_NO_PLAYERS: "every player disconnected",
    BANK_ERR_SEQUENCE: "remote input frame out of sequence",
    BANK_ERR_INJECTED: "injected fault (chaos harness)",
    BANK_ERR_SPEC_STREAM: "confirmed-input fan-out failed",
    BANK_ERR_IO: "batched socket I/O failed fatally",
}

_TAG_INPUT = 0
_TAG_INPUT_ACK = 1
_TAG_QUALITY_REPORT = 2
_TAG_QUALITY_REPLY = 3
_TAG_CHECKSUM_REPORT = 4
_TAG_KEEP_ALIVE = 5
_TAG_SYNC_REQUEST = 6
_TAG_SYNC_REPLY = 7


def _sig(fn, restype, *argtypes) -> None:
    fn.restype = restype
    fn.argtypes = list(argtypes)


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every entry point's signature (ctypes defaults to int)."""
    c_size_p = ctypes.POINTER(ctypes.c_size_t)
    c_i64_p = ctypes.POINTER(ctypes.c_int64)
    vp, i64, sz, cp = ctypes.c_void_p, ctypes.c_int64, ctypes.c_size_t, ctypes.c_char_p
    cint = ctypes.c_int
    # ---- codec and message framing (csrc/host/codec.cpp) ----
    _sig(lib.ggrs_codec_encode_bound, sz, sz, sz)
    _sig(lib.ggrs_codec_encode, cint, cp, sz, cp, c_size_p, sz, cp, sz, c_size_p)
    _sig(lib.ggrs_codec_decode, cint, cp, sz, cp, sz, cp, sz, c_size_p, sz, c_size_p)
    _sig(lib.ggrs_msg_decode, cint, cp, sz, ctypes.POINTER(_GgrsMsg))
    _sig(lib.ggrs_msg_encode, cint, ctypes.POINTER(_GgrsMsg), cp, sz, cp, sz, c_size_p)
    # ---- endpoint datapath (csrc/host/endpoint.cpp) ----
    _sig(lib.ggrs_ep_new, vp, cp, sz, cp, sz, i64)
    _sig(lib.ggrs_ep_free, None, vp)
    _sig(lib.ggrs_ep_pending_len, i64, vp)
    _sig(lib.ggrs_ep_last_recv_frame, i64, vp)
    _sig(lib.ggrs_ep_ack, None, vp, i64)
    _sig(lib.ggrs_ep_push, i64, vp, i64, cp, sz)
    _sig(lib.ggrs_ep_emit_input, cint, vp, ctypes.c_uint16,
         cp, cp,  # disconnect bytes, LE-packed frames
         ctypes.c_int32, ctypes.c_uint8, cp, sz, c_size_p)
    _sig(lib.ggrs_ep_on_input, cint, vp, i64, cp, sz, cp, sz, c_size_p, sz, c_size_p,
         c_i64_p, c_i64_p)
    _sig(lib.ggrs_ep_commit, None, vp)
    _sig(lib.ggrs_ep_handle_input_datagram, cint, vp, cp, sz,
         ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
         ctypes.POINTER(ctypes.c_uint8), c_i64_p,
         ctypes.POINTER(ctypes.c_int32), c_i64_p,
         cp, sz, c_size_p, sz, c_size_p, c_i64_p, c_i64_p)
    _sig(lib.ggrs_ep_fetch_base, cint, vp, i64, cp, sz, c_size_p)
    _sig(lib.ggrs_ep_store_one, None, vp, i64, cp, sz)
    _sig(lib.ggrs_ep_seed_send, None, vp, i64, cp, sz)
    _sig(lib.ggrs_ep_rewind_send, None, vp, i64, cp, sz)
    _sig(lib.ggrs_ep_stats, None, vp, ctypes.POINTER(ctypes.c_uint64))
    _sig(lib.ggrs_ep_last_acked_frame, i64, vp)
    # ---- sync core (csrc/host/sync_core.cpp) ----
    _sig(lib.ggrs_sync_new, vp, cint, cint)
    _sig(lib.ggrs_sync_free, None, vp)
    _sig(lib.ggrs_sync_set_frame_delay, None, vp, cint, cint)
    _sig(lib.ggrs_sync_reset_prediction, None, vp)
    _sig(lib.ggrs_sync_add_input, i64, vp, cint, i64, cp)
    _sig(lib.ggrs_sync_synchronized_inputs, cint, vp, i64, cp, c_i64_p, cp,
         ctypes.POINTER(ctypes.c_int32))
    _sig(lib.ggrs_sync_confirmed_inputs, cint, vp, i64, cp, c_i64_p, cp, c_i64_p)
    _sig(lib.ggrs_sync_set_last_confirmed, cint, vp, i64)
    _sig(lib.ggrs_sync_last_confirmed, i64, vp)
    _sig(lib.ggrs_sync_check_consistency, i64, vp, i64)
    _sig(lib.ggrs_sync_first_incorrect, i64, vp, cint)
    _sig(lib.ggrs_sync_last_added, i64, vp, cint)
    _sig(lib.ggrs_sync_confirmed_input, cint, vp, cint, i64, cp)
    _sig(lib.ggrs_sync_seed, cint, vp, cint, i64, ctypes.c_int32, cp)
    _sig(lib.ggrs_sync_tail_frame, i64, vp, cint)
    # ---- session bank (csrc/host/session_bank.cpp) ----
    i32_p = ctypes.POINTER(ctypes.c_int32)
    _sig(lib.ggrs_bank_new, vp)
    _sig(lib.ggrs_bank_free, None, vp)
    _sig(lib.ggrs_bank_add_session, i64, vp, cint, cint, cint, cint, i64, i64, i32_p, cint, cint)
    _sig(lib.ggrs_bank_add_endpoint, i64, vp, i64, ctypes.c_uint16, i32_p, cint, i64)
    _sig(lib.ggrs_bank_tick, cint, vp, i64, cp, sz, cp, sz, c_size_p)
    _sig(lib.ggrs_bank_fetch_out, cint, vp, cp, sz, c_size_p)
    _sig(lib.ggrs_bank_session_count, i64, vp)
    _sig(lib.ggrs_bank_harvest, cint, vp, i64, cp, sz, c_size_p)
    _sig(lib.ggrs_bank_stats, cint, vp, cp, sz, c_size_p)
    _sig(lib.ggrs_bank_set_timing, cint, vp, cint)
    _sig(lib.ggrs_bank_hdr_stride, cint)
    _sig(lib.ggrs_bank_req_stride, cint)
    _sig(lib.ggrs_bank_stage_stride, cint)
    _sig(lib.ggrs_bank_stage_inputs, i64, vp, vp, i64, cp, sz)
    # the broadcast entry points: spectator fan-out and the journal tap
    _sig(lib.ggrs_bank_attach_spectator, i64, vp, i64, ctypes.c_uint16, i64)
    _sig(lib.ggrs_bank_detach_spectator, cint, vp, i64, i64)
    _sig(lib.ggrs_bank_set_confirmed_stream, cint, vp, i64, cint)
    # the pump: the tick crossing plus native socket I/O for attached slots
    _sig(lib.ggrs_bank_pump, cint, vp, i64, cp, sz, cp, sz, c_size_p)
    _sig(lib.ggrs_bank_attach_socket, cint, vp, i64, vp)
    _sig(lib.ggrs_bank_detach_socket, cint, vp, i64)
    _sig(lib.ggrs_bank_map_addr, cint, vp, i64, cint, i64, ctypes.c_uint32, ctypes.c_uint16)
    # ---- the kernel-batched socket datapath (csrc/host/net_batch.cpp) ----
    u64_p = ctypes.POINTER(ctypes.c_uint64)
    _sig(lib.ggrs_net_supported, cint)
    _sig(lib.ggrs_net_attach, vp, cint, cint)
    _sig(lib.ggrs_net_free, None, vp)
    _sig(lib.ggrs_net_recv_all, cint, vp)
    _sig(lib.ggrs_net_stage, cint, vp, ctypes.c_uint32, ctypes.c_uint16, cp, sz)
    _sig(lib.ggrs_net_flush, cint, vp)
    _sig(lib.ggrs_net_staged_len, i64, vp)
    _sig(lib.ggrs_net_stats, None, vp, u64_p)
    _sig(lib.ggrs_net_set_capture, None, vp, cint)
    _sig(lib.ggrs_net_drain_capture, cint, vp, cp, sz, c_size_p)
    _sig(lib.ggrs_net_inject_send_errno, None, vp, cint, cint)
    _sig(lib.ggrs_net_send_table, cint, vp, i64, cp, sz, u64_p, i32_p, cint)
    _sig(lib.ggrs_net_recv_table, cint, vp, cint, vp, cint, vp, cint, vp, i64,
         u64_p, i32_p, cint, i32_p)
    _sig(lib.ggrs_net_gso_supported, cint)
    _sig(lib.ggrs_net_set_gso, None, cint)
    _sig(lib.ggrs_net_gro_supported, cint)
    _sig(lib.ggrs_net_set_gro, None, cint)
    _sig(lib.ggrs_net_inject_table_errno, None, cint, i64, cint)
    for probe in ("ggrs_net_recv_stride", "ggrs_net_route_stride", "ggrs_net_fd_stride",
                  "ggrs_net_send_stats_len", "ggrs_net_recv_stats_len"):
        _sig(getattr(lib, probe), cint)


def _check_layouts(lib: ctypes.CDLL) -> None:
    """The datapath's packed strides and stats lengths against this module's
    tables: the library is built from the checkout's ``csrc/host/`` sources,
    so a difference is a drift here, and it raises."""
    import numpy as np

    want = {
        "ggrs_net_fd_stride": (NET_FD_STRIDE, np.dtype(list(NET_FD_FIELDS)).itemsize),
        "ggrs_net_route_stride": (NET_ROUTE_STRIDE, np.dtype(list(NET_ROUTE_FIELDS)).itemsize),
        "ggrs_net_recv_stride": (NET_RECV_STRIDE, np.dtype(list(NET_RECV_FIELDS)).itemsize),
        "ggrs_net_send_stats_len": (NET_SEND_STATS, NET_SEND_STATS),
        "ggrs_net_recv_stats_len": (NET_RECV_TABLE_STATS, NET_RECV_TABLE_STATS),
    }
    for probe, (size, table) in want.items():
        got = int(getattr(lib, probe)())
        if got != size or table != size:
            raise RuntimeError(f"{probe}() is {got}, this module's table says {size} "
                               f"(packed size {table})")


def _load() -> Optional[ctypes.CDLL]:
    """The host library (the ``GGRS_NATIVE_SANITIZE`` variant when that is
    set), built and bound at first use; None when ``GGRS_TPU_NO_NATIVE`` is
    set before it was loaded.  A failed build raises
    ``_build.KernelBuildError``."""
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("GGRS_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None:
            lib = _build.load_host()
            _bind(lib)
            _check_layouts(lib)
            _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def bank_lib() -> Optional[ctypes.CDLL]:
    """The loaded library for ``parallel.HostSessionPool``'s native bank, or
    None (the caller asked for the per-session Python sessions)."""
    return _load()


def net_lib() -> Optional[ctypes.CDLL]:
    """The loaded library when the kernel-batched socket datapath is usable
    on this platform (``ggrs_net_supported`` is 0 on non-Linux builds), or
    None: the library is switched off, or ``GGRS_TPU_NO_NATIVE_IO=1`` asks
    for the Python shuttle (read at each call, as the JAX package reads
    it)."""
    lib = _load()
    if lib is None or os.environ.get("GGRS_TPU_NO_NATIVE_IO") or not lib.ggrs_net_supported():
        return None
    return lib


def broadcast_lib() -> Optional[ctypes.CDLL]:
    """The loaded library for the bank's spectator fan-out and
    confirmed-stream tap, or None (the library is switched off)."""
    return _load()


def endpoint_lib() -> Optional[ctypes.CDLL]:
    """The loaded library for ``NativeEndpointCore``, or None (the caller
    asked for the Python core)."""
    return _load()


def sync_lib() -> Optional[ctypes.CDLL]:
    """The loaded library for the native sync core, or None (the caller
    asked for the Python input queues)."""
    return _load()


def encode(reference: bytes, inputs: Sequence[bytes]) -> Optional[bytes]:
    """Native encode; None when the library is switched off."""
    lib = _load()
    if lib is None:
        return None
    blob = b"".join(inputs)
    n = len(inputs)
    lens = (ctypes.c_size_t * max(n, 1))(*[len(i) for i in inputs])
    cap = lib.ggrs_codec_encode_bound(len(blob), n)
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t(0)
    rc = lib.ggrs_codec_encode(
        reference, len(reference), blob, lens, n, out, cap, ctypes.byref(out_len)
    )
    if rc != 0:  # pragma: no cover - encode can only fail on a bad bound
        return None  # the Python encoder then runs, as in the JAX package
    return ctypes.string_at(out, out_len.value)  # .raw would copy all of cap


def decode(reference: bytes, data: bytes) -> Optional[List[bytes]]:
    """Native decode; None when the library is switched off OR the packet
    exceeds the fast path's resource caps (the caller takes the Python
    codec).  Raises ``CodecError`` (the Python codec's type) on malformed
    data."""
    lib = _load()
    if lib is None:
        return None
    from .compression import CodecError

    global _decode_out, _decode_sizes
    with _lock:  # buffers are reused across calls; protocol use is 1-thread
        if _decode_out is None:
            _decode_out = ctypes.create_string_buffer(_DECODE_CAP_BYTES)
            _decode_sizes = (ctypes.c_size_t * _DECODE_CAP_INPUTS)()
        out, out_sizes = _decode_out, _decode_sizes
        out_count = ctypes.c_size_t(0)
        rc = lib.ggrs_codec_decode(
            reference, len(reference), data, len(data), out, _DECODE_CAP_BYTES,
            out_sizes, _DECODE_CAP_INPUTS, ctypes.byref(out_count),
        )
        if rc in _RESOURCE_ERRORS:
            return None  # legal but huge: the Python codec handles it
        if rc != 0:
            raise CodecError(_ERROR_NAMES.get(rc, f"native error {rc}"))
        # copy only the decoded bytes out of the scratch buffer
        sizes = out_sizes[: out_count.value]
        blob = ctypes.string_at(out, sum(sizes))
        result: List[bytes] = []
        pos = 0
        for size in sizes:
            result.append(blob[pos : pos + size])
            pos += size
        return result


_msg_scratch = _GgrsMsg()
_msg_out_cap = 1 << 16
_msg_out: Optional[ctypes.Array] = None
_M = None  # messages module, bound lazily (it imports this module)


def _messages():
    global _M
    if _M is None:
        from . import messages

        _M = messages
    return _M


def msg_decode(data: bytes):
    """Native Message decode: the built ``messages.Message``, or None when
    the library is switched off or the packet needs the Python decoder
    (varints beyond u64).  Raises ``wire.WireError`` on malformed data, as
    the Python decoder does."""
    lib = _load()
    if lib is None:
        return None
    M = _messages()

    with _lock:  # the scratch struct is reused; protocol use is 1-thread
        m = _msg_scratch
        rc = lib.ggrs_msg_decode(data, len(data), ctypes.byref(m))
        if rc == _MSG_FALLBACK:
            return None
        if rc != 0:
            raise WireError(_MSG_ERROR_NAMES.get(rc, f"native error {rc}"))
        tag = m.tag
        if tag == _TAG_INPUT:
            n = m.n_status
            # bulk-slice the ctypes arrays (one C call each) and construct
            # positionally: this runs for every received input packet
            CS = M.ConnectionStatus
            disc = m.status_disconnected[:n]
            frames = m.status_last_frame[:n]
            off = m.payload_off
            body = M.InputMessage(
                [CS(bool(disc[i]), frames[i]) for i in range(n)],
                bool(m.disconnect_requested),
                m.start_frame,
                m.ack_frame,
                data[off : off + m.payload_len],
            )
        elif tag == _TAG_INPUT_ACK:
            body = M.InputAck(m.ack_frame)
        elif tag == _TAG_QUALITY_REPORT:
            body = M.QualityReport(m.frame_advantage, m.ping)
        elif tag == _TAG_QUALITY_REPLY:
            body = M.QualityReply(m.pong)
        elif tag == _TAG_CHECKSUM_REPORT:
            body = M.ChecksumReport(m.checksum_lo | (m.checksum_hi << 64), m.frame)
        elif tag == _TAG_KEEP_ALIVE:
            body = M.KeepAlive()
        elif tag == _TAG_SYNC_REQUEST:
            body = M.SyncRequest(m.random_nonce)
        else:  # _TAG_SYNC_REPLY (unknown tags already errored in C++)
            body = M.SyncReply(m.random_nonce)
        return M.Message(m.magic, body)


def _i64_ok(v) -> bool:
    return isinstance(v, int) and -(1 << 63) <= v < (1 << 63)


def _i16_ok(v) -> bool:
    return isinstance(v, int) and -(1 << 15) <= v < (1 << 15)


def _u64_ok(v) -> bool:
    return isinstance(v, int) and 0 <= v < (1 << 64)


def msg_encode(msg) -> Optional[bytes]:
    """Native Message encode: the wire bytes, or None when the library is
    switched off or a field exceeds the fast path's 64-bit range (the caller
    takes the Python encoder).

    The range checks are explicit because a ctypes field assignment wraps an
    out-of-range int silently, which would put bytes on the wire that differ
    from the Python encoder's; out of range, the Python path keeps its exact
    semantics (unbounded zigzag for huge frames, ``struct.error`` for an i16
    overflow, ``ValueError`` for a negative nonce)."""
    lib = _load()
    if lib is None:
        return None
    M = _messages()

    global _msg_out
    b = msg.body
    with _lock:
        m = _msg_scratch
        payload = b""
        try:
            m.magic = msg.magic & 0xFFFF
            if isinstance(b, M.InputMessage):
                statuses = b.peer_connect_status
                if len(statuses) > _MAX_PLAYERS_ON_WIRE:
                    return None  # the Python encoder handles it (the wire rejects)
                if not (_i64_ok(b.start_frame) and _i64_ok(b.ack_frame)):
                    return None
                if not all(_i64_ok(cs.last_frame) for cs in statuses):
                    return None
                m.tag = _TAG_INPUT
                m.n_status = len(statuses)
                for i, cs in enumerate(statuses):
                    m.status_disconnected[i] = 1 if cs.disconnected else 0
                    m.status_last_frame[i] = cs.last_frame
                m.disconnect_requested = 1 if b.disconnect_requested else 0
                m.start_frame = b.start_frame
                m.ack_frame = b.ack_frame
                # c_char_p takes bytes only; go through memoryview so that an
                # int payload (bytes(5) is five NULs) reaches the Python
                # encoder's TypeError instead of zero inputs on the wire
                payload = b.bytes if isinstance(b.bytes, bytes) else bytes(memoryview(b.bytes))
            elif isinstance(b, M.InputAck):
                if not _i64_ok(b.ack_frame):
                    return None
                m.tag = _TAG_INPUT_ACK
                m.ack_frame = b.ack_frame
            elif isinstance(b, M.QualityReport):
                if not _i16_ok(b.frame_advantage):
                    return None  # the Python encoder raises struct.error
                m.tag = _TAG_QUALITY_REPORT
                m.frame_advantage = b.frame_advantage
                m.ping = b.ping & 0xFFFFFFFFFFFFFFFF
            elif isinstance(b, M.QualityReply):
                m.tag = _TAG_QUALITY_REPLY
                m.pong = b.pong & 0xFFFFFFFFFFFFFFFF
            elif isinstance(b, M.ChecksumReport):
                if not _i64_ok(b.frame):
                    return None
                m.tag = _TAG_CHECKSUM_REPORT
                m.frame = b.frame
                m.checksum_lo = b.checksum & 0xFFFFFFFFFFFFFFFF
                m.checksum_hi = (b.checksum >> 64) & 0xFFFFFFFFFFFFFFFF
            elif isinstance(b, M.KeepAlive):
                m.tag = _TAG_KEEP_ALIVE
            elif isinstance(b, M.SyncRequest):
                if not _u64_ok(b.random):
                    return None  # the Python encoder raises ValueError
                m.tag = _TAG_SYNC_REQUEST
                m.random_nonce = b.random
            elif isinstance(b, M.SyncReply):
                if not _u64_ok(b.random):
                    return None
                m.tag = _TAG_SYNC_REPLY
                m.random_nonce = b.random
            else:
                return None  # unknown body: the Python encoder raises
        except (OverflowError, TypeError):
            # non-int field types the checks above did not catch
            return None
        if _msg_out is None or len(payload) + 1024 > len(_msg_out):
            _msg_out = ctypes.create_string_buffer(max(_msg_out_cap, len(payload) + 1024))
        out_len = ctypes.c_size_t(0)
        rc = lib.ggrs_msg_encode(
            ctypes.byref(m), payload, len(payload), _msg_out, len(_msg_out),
            ctypes.byref(out_len),
        )
        if rc != 0:
            return None  # the Python path as the universal fallback
        return ctypes.string_at(_msg_out, out_len.value)
