"""Cross-language ABI/layout checker (pillar 1 of ggrs-verify).

The native crossing and the Python decoders agree on a packed contract:
the 48-byte tick-output header, the body-record prefix and its jump
offsets, the command-stream flag bytes, the RPC frame header, the
message tags, and a few dozen mirrored error codes and resource caps.
Today that agreement is enforced at runtime (``ggrs_bank_hdr_stride()``
probes, parity fuzzes); this module proves the same facts from the
*source text* so drift fails lint before anything runs.

Everything here is static: C++ constants come from
:func:`..cpp.parse_cpp_constants` over the native sources, Python
constants/formats from the AST extractors in :mod:`..pysrc`.  The
checker never imports the modules it judges.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .cpp import parse_cpp_constants
from .pysrc import (
    parse_py_constants,
    parse_py_field_tuples,
    parse_py_struct_formats,
)
from .report import PKG, Finding

# ---------------------------------------------------------------------------
# the canonical contract
# ---------------------------------------------------------------------------

# The packed per-tick output header (session_bank.cpp kHdr*/kHdrStride;
# DESIGN.md §19).  THIS table is the contract both sides are checked
# against: the C++ side must declare the same stride, the Python side
# (net/_native.py BANK_HDR_FIELDS) must build the same dtype.
LAYOUT_HEADER_FIELDS: Tuple[Tuple[str, str, int], ...] = (
    # (field, little-endian numpy format, byte offset)
    ("flags", "<u4", 0),
    ("rec_len", "<u4", 4),
    ("err", "<i4", 8),
    ("fa", "<i4", 12),
    ("landed", "<i8", 16),
    ("current", "<i8", 24),
    ("confirmed", "<i8", 32),
    ("save_frame", "<i8", 40),
)
LAYOUT_HEADER_STRIDE = 48

# Body-record prefix (bank_tick_impl output stream): i32 err, i64
# landed_frame, i32 frames_ahead, i64 current, i64 last_confirmed,
# u8 consensus_pending, u16 n_ops.  The vectorized fast path jumps
# straight to n_ops / the first op with literal offsets derived from it.
BODY_PREFIX_FMT = "<iqiqqBH"
BODY_N_OPS_OFFSET = struct.calcsize("<iqiqqB")   # 33
BODY_OPS_OFFSET = struct.calcsize(BODY_PREFIX_FMT)  # 35

# Supervisor<->runner RPC frame header (fleet/rpc.py): magic, version,
# kind, payload length, crc32 over header[:CRC_COVERS]+payload.
RPC_HEADER_FMT = "<2sBBII"
RPC_HEADER_PREFIX_FMT = "<2sBBI"  # what _encode_frame packs before the crc
RPC_CRC_COVERS = struct.calcsize(RPC_HEADER_PREFIX_FMT)  # 8

# Multi-host TCP handshake records (fleet/transport.py, DESIGN.md §25):
# challenge (magic, version, flags, nonce), auth record (magic, version,
# flags, epoch u64, resume-cursor u64, shard id, then the HMAC-SHA256
# mac over nonce+prefix), verdict (magic, version, code, granted epoch,
# server resume cursor).  The mac covers exactly the auth prefix, so the
# prefix format must be the full record minus its 32-byte mac tail.
TCP_CHALLENGE_FMT = "<2sBB16s"
TCP_AUTH_PREFIX_FMT = "<2sBBQQ16s"
TCP_AUTH_FMT = "<2sBBQQ16s32s"
TCP_VERDICT_FMT = "<2sBBQQ"
TCP_MAC_BYTES = 32
TCP_NONCE_BYTES = 16

# Ingress-plane wire records (fleet/ingress.py, DESIGN.md §26): the
# forwarded-datagram header (magic, version, flags, vport, then the
# peer's public source address as port + ip4) wrapping every payload on
# the ingress<->leg uplink, and the route-update frame — the SAME shape
# plus the two u64 fence words (placement epoch, route version) between
# the version byte-pair and the vport, so a route write can never be
# confused with (or replayed as) a forwarded datagram.  v2 (§28) grew a
# trailing 16-byte trace context on the route frame.
ING_FWD_FMT = "<2sBBHH4s"
ING_ROUTE_FMT = "<2sBBQQHH4s16s"
ING_FENCE_BYTES = 16  # epoch u64 + route-version u64
ING_ROUTE_WIRE_VERSION = 2  # bumped when the trace-context tail landed

# §28 trace context (obs/timeline.py TRACE_CTX, mirrored as a literal
# in fleet/transport.py): match-id hash u64, placement epoch u32, span
# id u32 — 16 bytes riding the route-update tail and RPC payloads.
TRACE_CTX_FMT = "<QII"
TRACE_CTX_BYTES = 16

# Harvest prefix (ggrs_bank_harvest): i64 current, i64 last_confirmed,
# i64 disconnect_frame.
HARVEST_PREFIX_FMT = "<qqq"

# §27 variable-size input envelope (core/varrec.py): every record is
# framed [u16 payload_len LE][payload][zero pad] into a fixed
# ``capacity + VARREC_HEADER_BYTES`` blob — the shape that keeps serde
# inputs eligible for the native bank/journal/wire fast paths.
VARREC_HEADER_FMT = "<H"
VARREC_HEADER_BYTES = 2
VARREC_MAX_CAPACITY = 0xFFFF

# ---- descriptor plane (DESIGN.md §21) -----------------------------------
# Batched input-staging record (ggrs_bank_stage_inputs / kStageStride ↔
# _native.BANK_STAGE_FIELDS): the contract both sides are checked against.
LAYOUT_STAGE_FIELDS: Tuple[Tuple[str, str, int], ...] = (
    ("slot", "<u4", 0),
    ("handle", "<i4", 4),
    ("frame", "<i8", 8),
    ("off", "<u4", 16),
    ("len", "<u4", 20),
)
LAYOUT_STAGE_STRIDE = 24

# Per-slot request descriptor record (the second fixed-stride table of
# every tick output; kReqStride ↔ _native.BANK_REQ_FIELDS).
LAYOUT_REQ_FIELDS: Tuple[Tuple[str, str, int], ...] = (
    ("pattern", "<u1", 0),
    ("rflags", "<u1", 1),
    ("n_adv", "<u2", 2),
    ("adv_off", "<u4", 4),
    ("adv_stride", "<u4", 8),
    ("ops_end", "<u4", 12),
    ("frame", "<i8", 16),
)
LAYOUT_REQ_STRIDE = 24

# Batched outbound send record (net_batch.cpp ggrs_net_send_table /
# kSendStride ↔ _native.NET_SEND_FIELDS).
LAYOUT_SEND_FIELDS: Tuple[Tuple[str, str, int], ...] = (
    ("fd", "<i4", 0),
    ("ip", "<u4", 4),
    ("port", "<u2", 8),
    ("flags", "<u2", 10),
    ("off", "<u4", 12),
    ("len", "<u4", 16),
)
LAYOUT_SEND_STRIDE = 20

# ---- datapath gen 2 (DESIGN.md §23) -------------------------------------
# Batched inbound drain record (net_batch.cpp ggrs_net_recv_table /
# kRecvStride ↔ _native.NET_RECV_FIELDS): one row per datagram pulled by
# the one-crossing drain, addressing bytes in the shared slab.
LAYOUT_RECV_FIELDS: Tuple[Tuple[str, str, int], ...] = (
    ("slot", "<i4", 0),
    ("fd_idx", "<i4", 4),
    ("ip", "<u4", 8),
    ("port", "<u2", 12),
    ("seg", "<u2", 14),
    ("off", "<u4", 16),
    ("len", "<u4", 20),
)
LAYOUT_RECV_STRIDE = 24

# Dispatch demux route row (kRouteStride ↔ _native.NET_ROUTE_FIELDS):
# sorted by ((u64)ip << 16) | port, binary-searched natively per datagram.
LAYOUT_ROUTE_FIELDS: Tuple[Tuple[str, str, int], ...] = (
    ("ip", "<u4", 0),
    ("port", "<u2", 4),
    ("pad", "<u2", 6),
    ("slot", "<i4", 8),
)
LAYOUT_ROUTE_STRIDE = 12

# Drain fd-table row (kFdStride ↔ _native.NET_FD_FIELDS): slot >= 0 binds
# the fd to one slot; slot == -1 marks a shared dispatch fd (route demux).
LAYOUT_FD_FIELDS: Tuple[Tuple[str, str, int], ...] = (
    ("fd", "<i4", 0),
    ("slot", "<i4", 4),
)
LAYOUT_FD_STRIDE = 8

_NP_WIDTH = {"u4": 4, "i4": 4, "u8": 8, "i8": 8, "u2": 2, "i2": 2,
             "u1": 1, "i1": 1}


def host_sources(pkg: str = PKG) -> str:
    """Where ``pkg`` keeps its C++ host sources, relative to the root:
    the package's own ``csrc/host``.  A tree laid out otherwise (the JAX
    package's) is judged by handing its folder to the checks as
    ``host``."""
    return f"{pkg}/csrc/host"


def mirrored_constants(
    pkg: str = PKG,
    host: Optional[str] = None,
) -> Tuple[Tuple[str, str, str, str], ...]:
    """Mirrored scalar constants, ``(cpp file, cpp symbol, py file, py
    symbol)``: the C++ <-> Python pairs, the Python side and the port's
    own kernel source rooted at ``pkg``, the host sources at ``host``
    (default ``host_sources(pkg)``)."""
    if host is None:
        host = host_sources(pkg)
    return (
        # wire_common.h <-> codec/compression caps and shared error codes
        (f"{host}/wire_common.h", "kMaxDecodedBytes",
         f"{pkg}/net/compression.py", "MAX_DECODED_BYTES"),
        (f"{host}/wire_common.h", "kMaxPlayersOnWire",
         f"{pkg}/net/_native.py", "_MAX_PLAYERS_ON_WIRE"),
        (f"{host}/wire_common.h", "kErrBufferTooSmall",
         f"{pkg}/net/_native.py", "EP_ERR_BUFFER_TOO_SMALL"),
        (f"{host}/wire_common.h", "kErrTooManyInputs",
         f"{pkg}/net/_native.py", "EP_ERR_TOO_MANY_INPUTS"),
        # message tags (wire_common.h MsgTag <-> messages.py)
        (f"{host}/wire_common.h", "kTagInput",
         f"{pkg}/net/messages.py", "_TAG_INPUT"),
        (f"{host}/wire_common.h", "kTagInputAck",
         f"{pkg}/net/messages.py", "_TAG_INPUT_ACK"),
        (f"{host}/wire_common.h", "kTagQualityReport",
         f"{pkg}/net/messages.py", "_TAG_QUALITY_REPORT"),
        (f"{host}/wire_common.h", "kTagQualityReply",
         f"{pkg}/net/messages.py", "_TAG_QUALITY_REPLY"),
        (f"{host}/wire_common.h", "kTagChecksumReport",
         f"{pkg}/net/messages.py", "_TAG_CHECKSUM_REPORT"),
        (f"{host}/wire_common.h", "kTagKeepAlive",
         f"{pkg}/net/messages.py", "_TAG_KEEP_ALIVE"),
        (f"{host}/wire_common.h", "kTagSyncRequest",
         f"{pkg}/net/messages.py", "_TAG_SYNC_REQUEST"),
        (f"{host}/wire_common.h", "kTagSyncReply",
         f"{pkg}/net/messages.py", "_TAG_SYNC_REPLY"),
        # endpoint core verdicts
        (f"{host}/endpoint.cpp", "kEpDrop",
         f"{pkg}/net/_native.py", "EP_DROP"),
        (f"{host}/endpoint.cpp", "kEpFallback",
         f"{pkg}/net/_native.py", "EP_FALLBACK"),
        (f"{host}/endpoint.cpp", "kEpBadPendingHead",
         f"{pkg}/net/_native.py", "EP_BAD_PENDING_HEAD"),
        (f"{host}/endpoint.cpp", "kNullFrame",
         f"{pkg}/core/types.py", "NULL_FRAME"),
        # sync core error codes + ring capacity
        (f"{host}/sync_core.cpp", "kSyncOk",
         f"{pkg}/net/_native.py", "SYNC_OK"),
        (f"{host}/sync_core.cpp", "kSyncErrPredictionPending",
         f"{pkg}/net/_native.py", "SYNC_ERR_PREDICTION_PENDING"),
        (f"{host}/sync_core.cpp", "kSyncErrBeforeTail",
         f"{pkg}/net/_native.py", "SYNC_ERR_BEFORE_TAIL"),
        (f"{host}/sync_core.cpp", "kSyncErrNoConfirmed",
         f"{pkg}/net/_native.py", "SYNC_ERR_NO_CONFIRMED"),
        (f"{host}/sync_core.cpp", "kSyncErrNonSequential",
         f"{pkg}/net/_native.py", "SYNC_ERR_NON_SEQUENTIAL"),
        (f"{host}/sync_core.cpp", "kSyncErrConfirmPastIncorrect",
         f"{pkg}/net/_native.py", "SYNC_ERR_CONFIRM_PAST_INCORRECT"),
        (f"{host}/sync_core.cpp", "kSyncErrBadArgs",
         f"{pkg}/net/_native.py", "SYNC_ERR_BAD_ARGS"),
        (f"{host}/sync_core.cpp", "kSyncErrQueueFull",
         f"{pkg}/net/_native.py", "SYNC_ERR_QUEUE_FULL"),
        (f"{host}/sync_core.cpp", "kQueueLen",
         f"{pkg}/core/input_queue.py", "INPUT_QUEUE_LENGTH"),
        # session bank: slot fault codes, header flag bits, cmd flags
        (f"{host}/session_bank.cpp", "kBankOk",
         f"{pkg}/net/_native.py", "BANK_OK"),
        (f"{host}/session_bank.cpp", "kBankErrCmd",
         f"{pkg}/net/_native.py", "BANK_ERR_CMD"),
        (f"{host}/session_bank.cpp", "kBankErrLandedSplit",
         f"{pkg}/net/_native.py", "BANK_ERR_LANDED_SPLIT"),
        (f"{host}/session_bank.cpp", "kBankErrSync",
         f"{pkg}/net/_native.py", "BANK_ERR_SYNC"),
        (f"{host}/session_bank.cpp", "kBankErrSyncInputs",
         f"{pkg}/net/_native.py", "BANK_ERR_SYNC_INPUTS"),
        (f"{host}/session_bank.cpp", "kBankErrConfirm",
         f"{pkg}/net/_native.py", "BANK_ERR_CONFIRM"),
        (f"{host}/session_bank.cpp", "kBankErrNoPlayers",
         f"{pkg}/net/_native.py", "BANK_ERR_NO_PLAYERS"),
        (f"{host}/session_bank.cpp", "kBankErrSequence",
         f"{pkg}/net/_native.py", "BANK_ERR_SEQUENCE"),
        (f"{host}/session_bank.cpp", "kBankErrInjected",
         f"{pkg}/net/_native.py", "BANK_ERR_INJECTED"),
        (f"{host}/session_bank.cpp", "kBankErrSpecStream",
         f"{pkg}/net/_native.py", "BANK_ERR_SPEC_STREAM"),
        (f"{host}/session_bank.cpp", "kBankErrIo",
         f"{pkg}/net/_native.py", "BANK_ERR_IO"),
        (f"{host}/session_bank.cpp", "kHdrLive",
         f"{pkg}/net/_native.py", "BANK_HDR_LIVE"),
        (f"{host}/session_bank.cpp", "kHdrQuiet",
         f"{pkg}/net/_native.py", "BANK_HDR_QUIET"),
        (f"{host}/session_bank.cpp", "kHdrEvents",
         f"{pkg}/net/_native.py", "BANK_HDR_EVENTS"),
        (f"{host}/session_bank.cpp", "kHdrSpec",
         f"{pkg}/net/_native.py", "BANK_HDR_SPEC"),
        (f"{host}/session_bank.cpp", "kHdrConsensus",
         f"{pkg}/net/_native.py", "BANK_HDR_CONSENSUS"),
        (f"{host}/session_bank.cpp", "kHdrDirty",
         f"{pkg}/net/_native.py", "BANK_HDR_DIRTY"),
        (f"{host}/session_bank.cpp", "kHdrOut",
         f"{pkg}/net/_native.py", "BANK_HDR_OUT"),
        (f"{host}/session_bank.cpp", "kHdrSkip",
         f"{pkg}/net/_native.py", "BANK_HDR_SKIP"),
        (f"{host}/session_bank.cpp", "kHdrConf",
         f"{pkg}/net/_native.py", "BANK_HDR_CONF"),
        (f"{host}/session_bank.cpp", "kFlagInputs",
         f"{pkg}/net/_native.py", "CMD_FLAG_INPUTS"),
        (f"{host}/session_bank.cpp", "kFlagSkip",
         f"{pkg}/net/_native.py", "CMD_FLAG_SKIP"),
        (f"{host}/session_bank.cpp", "kFlagStaged",
         f"{pkg}/net/_native.py", "CMD_FLAG_STAGED"),
        # descriptor plane (§21): staging / request-descriptor / send strides
        # and the request pattern codes
        (f"{host}/session_bank.cpp", "kStageStride",
         f"{pkg}/net/_native.py", "BANK_STAGE_STRIDE"),
        (f"{host}/session_bank.cpp", "kReqStride",
         f"{pkg}/net/_native.py", "BANK_REQ_STRIDE"),
        (f"{host}/session_bank.cpp", "kReqOther",
         f"{pkg}/net/_native.py", "REQ_OTHER"),
        (f"{host}/session_bank.cpp", "kReqQuiet",
         f"{pkg}/net/_native.py", "REQ_QUIET"),
        (f"{host}/session_bank.cpp", "kReqResim",
         f"{pkg}/net/_native.py", "REQ_RESIM"),
        (f"{host}/session_bank.cpp", "kReqSaveOnly",
         f"{pkg}/net/_native.py", "REQ_SAVE_ONLY"),
        (f"{host}/session_bank.cpp", "kReqEmpty",
         f"{pkg}/net/_native.py", "REQ_EMPTY"),
        (f"{host}/session_bank.cpp", "kReqFlagTrailingAdv",
         f"{pkg}/net/_native.py", "REQ_FLAG_TRAILING_ADV"),
        (f"{host}/net_batch.cpp", "kSendStride",
         f"{pkg}/net/_native.py", "NET_SEND_STRIDE"),
        # datapath gen 2 (§23): drain/route/fd strides, dispatch flag, stat
        # table widths
        (f"{host}/net_batch.cpp", "kRecvStride",
         f"{pkg}/net/_native.py", "NET_RECV_STRIDE"),
        (f"{host}/net_batch.cpp", "kRouteStride",
         f"{pkg}/net/_native.py", "NET_ROUTE_STRIDE"),
        (f"{host}/net_batch.cpp", "kFdStride",
         f"{pkg}/net/_native.py", "NET_FD_STRIDE"),
        (f"{host}/net_batch.cpp", "kSendFlagDispatch",
         f"{pkg}/net/_native.py", "NET_SEND_FLAG_DISPATCH"),
        (f"{host}/net_batch.cpp", "kSendTableStats",
         f"{pkg}/net/_native.py", "NET_SEND_STATS"),
        (f"{host}/net_batch.cpp", "kRecvTableStats",
         f"{pkg}/net/_native.py", "NET_RECV_TABLE_STATS"),
        (f"{host}/session_bank.cpp", "kFrameWindow",
         f"{pkg}/core/time_sync.py", "FRAME_WINDOW_SIZE"),
        # kernel-batched datapath verdicts + socket caps
        (f"{host}/net_batch.cpp", "kNetOk",
         f"{pkg}/net/_native.py", "NET_OK"),
        (f"{host}/net_batch.cpp", "kNetErrUnsupported",
         f"{pkg}/net/_native.py", "NET_ERR_UNSUPPORTED"),
        (f"{host}/net_batch.cpp", "kNetErrFatal",
         f"{pkg}/net/_native.py", "NET_ERR_FATAL"),
        (f"{host}/net_batch.cpp", "kNetErrBadArgs",
         f"{pkg}/net/_native.py", "NET_ERR_BAD_ARGS"),
        (f"{host}/net_batch.cpp", "kRecvBufSize",
         f"{pkg}/net/sockets.py", "RECV_BUFFER_SIZE"),
        (f"{host}/net_batch.cpp", "kIdealMaxUdp",
         f"{pkg}/net/sockets.py", "IDEAL_MAX_UDP_PACKET_SIZE"),
        # the digest kernel's limits and lane primes (csrc/digest.cu) vs
        # its wrapper (ops/digest.py): the static twin of the limits
        # check the wrapper makes when it loads the library
        (f"{pkg}/csrc/digest.cu", "kMaxLeaves",
         f"{pkg}/ops/digest.py", "MAX_LEAVES"),
        (f"{pkg}/csrc/digest.cu", "kGroupMaxWords",
         f"{pkg}/ops/digest.py", "GROUP_MAX_WORDS"),
        (f"{pkg}/csrc/digest.cu", "kSegWords",
         f"{pkg}/ops/digest.py", "SEG_WORDS"),
        (f"{pkg}/csrc/digest.cu", "kPrimeA",
         f"{pkg}/ops/digest.py", "PRIME_A"),
        (f"{pkg}/csrc/digest.cu", "kPrimeB",
         f"{pkg}/ops/digest.py", "PRIME_B"),
    )


MIRRORED_CONSTANTS: Tuple[Tuple[str, str, str, str], ...] = (
    mirrored_constants()
)


def py_mirrored_constants(
    pkg: str = PKG,
) -> Tuple[Tuple[str, str, str, str], ...]:
    """Python<->Python mirrored constants: values duplicated across
    layers that cannot import each other (layering), pinned equal here
    instead."""
    return (
        # the bundle seam's pickle protocol: host_bank (parallel layer)
        # cannot import fleet, so it re-declares fleet.rpc.PICKLE_PROTOCOL
        (f"{pkg}/fleet/rpc.py", "PICKLE_PROTOCOL",
         f"{pkg}/parallel/host_bank.py", "_BUNDLE_PICKLE_PROTOCOL"),
    )


PY_MIRRORED_CONSTANTS: Tuple[Tuple[str, str, str, str], ...] = (
    py_mirrored_constants()
)


def static_bank_header() -> Dict[str, object]:
    """The checker's own header contract in probe-comparable form:
    ``{"stride": 48, "fields": ((name, fmt, offset), ...)}`` — what
    tests pin equal to ``ggrs_bank_hdr_stride()`` and the live
    ``np.dtype(BANK_HDR_FIELDS)``."""
    return {
        "stride": LAYOUT_HEADER_STRIDE,
        "fields": LAYOUT_HEADER_FIELDS,
    }


def _field_width(fmt: str) -> Optional[int]:
    return _NP_WIDTH.get(fmt.lstrip("<>=|"))


# ---------------------------------------------------------------------------
# individual checks (each returns a list of findings)
# ---------------------------------------------------------------------------


def _check_mirrors(
    root: Path,
    mirrors: Sequence[Tuple[str, str, str, str]],
) -> List[Finding]:
    """A side whose file is absent declares nothing: each of its
    constants is a ``layout/mirror-missing`` finding."""
    out: List[Finding] = []
    cpp_cache: Dict[str, Dict[str, int]] = {}
    py_cache: Dict[str, Dict[str, int]] = {}
    for cpp_file, cpp_name, py_file, py_name in mirrors:
        if cpp_file not in cpp_cache:
            path = root / cpp_file
            cpp_cache[cpp_file] = (
                parse_cpp_constants(path) if path.exists() else {}
            )
        if py_file not in py_cache:
            path = root / py_file
            py_cache[py_file] = (
                parse_py_constants(path) if path.exists() else {}
            )
        cv = cpp_cache[cpp_file].get(cpp_name)
        pv = py_cache[py_file].get(py_name)
        if cv is None:
            out.append(Finding(
                "layout/mirror-missing", cpp_file, 0,
                f"constant {cpp_name} not found (mirror of "
                f"{py_file}:{py_name})",
            ))
            continue
        if pv is None:
            out.append(Finding(
                "layout/mirror-missing", py_file, 0,
                f"constant {py_name} not found (mirror of "
                f"{cpp_file}:{cpp_name} = {cv})",
            ))
            continue
        if cv != pv:
            out.append(Finding(
                "layout/mirror-mismatch", py_file, 0,
                f"{py_name} = {pv} but {cpp_file}:{cpp_name} = {cv}",
            ))
    return out


def _check_py_mirrors(
    root: Path,
    mirrors: Optional[Sequence[Tuple[str, str, str, str]]] = None,
    pkg: str = PKG,
) -> List[Finding]:
    out: List[Finding] = []
    if mirrors is None:
        mirrors = py_mirrored_constants(pkg)
    cache: Dict[str, Dict[str, int]] = {}
    for file_a, name_a, file_b, name_b in mirrors:
        for f in (file_a, file_b):
            if f not in cache:
                cache[f] = parse_py_constants(root / f)
        va, vb = cache[file_a].get(name_a), cache[file_b].get(name_b)
        if va is None or vb is None:
            missing = (
                f"{file_a}:{name_a}" if va is None else f"{file_b}:{name_b}"
            )
            out.append(Finding(
                "layout/mirror-missing", missing.split(":")[0], 0,
                f"constant {missing} not found (py<->py mirror)",
            ))
        elif va != vb:
            out.append(Finding(
                "layout/mirror-mismatch", file_b, 0,
                f"{name_b} = {vb} but {file_a}:{name_a} = {va}",
            ))
    return out


def _check_header(
    root: Path, pkg: str = PKG, host: Optional[str] = None,
) -> List[Finding]:
    out: List[Finding] = []
    bank_cpp = f"{host or host_sources(pkg)}/session_bank.cpp"
    native = parse_cpp_constants(root / bank_cpp)
    stride = native.get("kHdrStride")
    if stride != LAYOUT_HEADER_STRIDE:
        out.append(Finding(
            "layout/header-stride", bank_cpp, 0,
            f"kHdrStride = {stride}, contract says "
            f"{LAYOUT_HEADER_STRIDE}",
        ))
    fields = parse_py_field_tuples(
        root / f"{pkg}/net/_native.py"
    ).get("BANK_HDR_FIELDS")
    if fields is None:
        out.append(Finding(
            "layout/header-fields", f"{pkg}/net/_native.py", 0,
            "BANK_HDR_FIELDS not found / not statically parseable",
        ))
        return out
    offset = 0
    declared = []
    for row in fields:
        if len(row) != 2:
            out.append(Finding(
                "layout/header-fields", f"{pkg}/net/_native.py", 0,
                f"BANK_HDR_FIELDS row {row!r} is not (name, fmt)",
            ))
            return out
        name, fmt = row
        width = _field_width(fmt)
        if width is None or not fmt.startswith("<"):
            out.append(Finding(
                "layout/header-endian", f"{pkg}/net/_native.py", 0,
                f"BANK_HDR_FIELDS field {name!r} has format {fmt!r}; "
                "the header contract is little-endian fixed-width only",
            ))
            return out
        declared.append((name, fmt, offset))
        offset += width
    if offset != LAYOUT_HEADER_STRIDE:
        out.append(Finding(
            "layout/header-stride", f"{pkg}/net/_native.py", 0,
            f"BANK_HDR_FIELDS itemsize {offset} != contract stride "
            f"{LAYOUT_HEADER_STRIDE}",
        ))
    if tuple(declared) != LAYOUT_HEADER_FIELDS:
        out.append(Finding(
            "layout/header-fields", f"{pkg}/net/_native.py", 0,
            f"BANK_HDR_FIELDS layout {tuple(declared)} != contract "
            f"{LAYOUT_HEADER_FIELDS}",
        ))
    return out


def _check_field_table(
    root: Path,
    py_name: str,
    contract: Sequence[Tuple[str, str, int]],
    stride: int,
    py_file: Optional[str] = None,
    pkg: str = PKG,
) -> List[Finding]:
    """Generic fixed-stride table check (the header check's shape, reused
    by the §21 descriptor-plane structs): the named Python field tuple
    must rebuild exactly the contract's (name, little-endian fmt, offset)
    rows and itemsize (``py_file`` defaults to ``pkg``'s
    ``net/_native.py``)."""
    out: List[Finding] = []
    if py_file is None:
        py_file = f"{pkg}/net/_native.py"
    fields = parse_py_field_tuples(root / py_file).get(py_name)
    if fields is None:
        out.append(Finding(
            "layout/table-fields", py_file, 0,
            f"{py_name} not found / not statically parseable",
        ))
        return out
    offset = 0
    declared = []
    for row in fields:
        if len(row) != 2:
            out.append(Finding(
                "layout/table-fields", py_file, 0,
                f"{py_name} row {row!r} is not (name, fmt)",
            ))
            return out
        name, fmt = row
        width = _field_width(fmt)
        if width is None or not fmt.startswith("<"):
            out.append(Finding(
                "layout/table-endian", py_file, 0,
                f"{py_name} field {name!r} has format {fmt!r}; the "
                "contract is little-endian fixed-width only",
            ))
            return out
        declared.append((name, fmt, offset))
        offset += width
    if offset != stride:
        out.append(Finding(
            "layout/table-stride", py_file, 0,
            f"{py_name} itemsize {offset} != contract stride {stride}",
        ))
    if tuple(declared) != tuple(contract):
        out.append(Finding(
            "layout/table-fields", py_file, 0,
            f"{py_name} layout {tuple(declared)} != contract "
            f"{tuple(contract)}",
        ))
    return out


def _check_descriptor_plane(root: Path, pkg: str = PKG) -> List[Finding]:
    """The §21 structs: staging record, request descriptor record, send
    record — Python dtypes vs the contract (the C++ strides and pattern
    codes are pinned by MIRRORED_CONSTANTS)."""
    out: List[Finding] = []
    out += _check_field_table(
        root, "BANK_STAGE_FIELDS", LAYOUT_STAGE_FIELDS, LAYOUT_STAGE_STRIDE,
        pkg=pkg,
    )
    out += _check_field_table(
        root, "BANK_REQ_FIELDS", LAYOUT_REQ_FIELDS, LAYOUT_REQ_STRIDE,
        pkg=pkg,
    )
    out += _check_field_table(
        root, "NET_SEND_FIELDS", LAYOUT_SEND_FIELDS, LAYOUT_SEND_STRIDE,
        pkg=pkg,
    )
    # datapath gen 2 (§23): the drain record table and demux tables
    out += _check_field_table(
        root, "NET_RECV_FIELDS", LAYOUT_RECV_FIELDS, LAYOUT_RECV_STRIDE,
        pkg=pkg,
    )
    out += _check_field_table(
        root, "NET_ROUTE_FIELDS", LAYOUT_ROUTE_FIELDS, LAYOUT_ROUTE_STRIDE,
        pkg=pkg,
    )
    out += _check_field_table(
        root, "NET_FD_FIELDS", LAYOUT_FD_FIELDS, LAYOUT_FD_STRIDE,
        pkg=pkg,
    )
    return out


def _check_body_prefix(root: Path, pkg: str = PKG) -> List[Finding]:
    """The body-record prefix format must be what the reference decoder
    unpacks, and the vectorized fast path's literal jump offsets must be
    the calcsize-derived ones."""
    out: List[Finding] = []
    hb = root / f"{pkg}/parallel/host_bank.py"
    fmts = {f.fmt for f in parse_py_struct_formats(hb)}
    if BODY_PREFIX_FMT not in fmts:
        out.append(Finding(
            "layout/body-prefix", f"{pkg}/parallel/host_bank.py", 0,
            f"body-record prefix {BODY_PREFIX_FMT!r} is not unpacked "
            "anywhere (reference decoder drifted?)",
        ))
    text = hb.read_text()
    for label, off in (("n_ops", BODY_N_OPS_OFFSET),
                       ("first op", BODY_OPS_OFFSET)):
        if not re.search(rf"off\s*\+\s*{off}\b", text):
            out.append(Finding(
                "layout/body-jump", f"{pkg}/parallel/host_bank.py", 0,
                f"fast path lacks the literal jump 'off + {off}' "
                f"({label}; derived from {BODY_PREFIX_FMT!r})",
            ))
    if HARVEST_PREFIX_FMT not in fmts:
        out.append(Finding(
            "layout/harvest-prefix", f"{pkg}/parallel/host_bank.py", 0,
            f"harvest prefix {HARVEST_PREFIX_FMT!r} is not unpacked "
            "anywhere (harvest decoder drifted?)",
        ))
    return out


def _check_rpc_framing(root: Path, pkg: str = PKG) -> List[Finding]:
    out: List[Finding] = []
    rpc = root / f"{pkg}/fleet/rpc.py"
    fmts = {f.fmt for f in parse_py_struct_formats(rpc)}
    if RPC_HEADER_FMT not in fmts:
        out.append(Finding(
            "layout/rpc-header", f"{pkg}/fleet/rpc.py", 0,
            f"RPC frame header {RPC_HEADER_FMT!r} not found",
        ))
    if RPC_HEADER_PREFIX_FMT not in fmts:
        out.append(Finding(
            "layout/rpc-header", f"{pkg}/fleet/rpc.py", 0,
            f"RPC pre-crc header {RPC_HEADER_PREFIX_FMT!r} not found "
            "(encode path drifted from the Struct declaration?)",
        ))
    if struct.calcsize(RPC_HEADER_FMT) != RPC_CRC_COVERS + 4:
        out.append(Finding(
            "layout/rpc-header", f"{pkg}/fleet/rpc.py", 0,
            f"header {RPC_HEADER_FMT!r} is not pre-crc "
            f"({RPC_CRC_COVERS}) + u32 crc",
        ))
    text = rpc.read_text()
    consts = parse_py_constants(rpc)
    if consts.get("VERSION") is None:
        out.append(Finding(
            "layout/rpc-header", f"{pkg}/fleet/rpc.py", 0,
            "VERSION constant not statically visible",
        ))
    # the crc must cover exactly the pre-crc header bytes + payload
    if not re.search(rf"\[:\s*{RPC_CRC_COVERS}\s*\]", text):
        out.append(Finding(
            "layout/rpc-crc", f"{pkg}/fleet/rpc.py", 0,
            f"no '[:{RPC_CRC_COVERS}]' header slice near the crc check "
            "(crc coverage drifted from the header prefix?)",
        ))
    return out


def _check_tcp_handshake(root: Path, pkg: str = PKG) -> List[Finding]:
    """The §25 TCP handshake records vs transport.py: all four wire
    structs present, auth = prefix + mac tail, the mac/nonce sizes
    statically visible, and the handshake version negotiated (a
    constant, compared on both sides)."""
    out: List[Finding] = []
    tp = root / f"{pkg}/fleet/transport.py"
    fmts = {f.fmt for f in parse_py_struct_formats(tp)}
    for label, fmt in (("challenge", TCP_CHALLENGE_FMT),
                       ("auth prefix", TCP_AUTH_PREFIX_FMT),
                       ("auth record", TCP_AUTH_FMT),
                       ("verdict", TCP_VERDICT_FMT)):
        if fmt not in fmts:
            out.append(Finding(
                "layout/tcp-handshake", f"{pkg}/fleet/transport.py", 0,
                f"handshake {label} {fmt!r} not found (wire format "
                "drifted from the §25 contract?)",
            ))
    if (struct.calcsize(TCP_AUTH_FMT)
            != struct.calcsize(TCP_AUTH_PREFIX_FMT) + TCP_MAC_BYTES):
        out.append(Finding(
            "layout/tcp-handshake", f"{pkg}/fleet/transport.py", 0,
            f"auth record {TCP_AUTH_FMT!r} is not prefix "
            f"{TCP_AUTH_PREFIX_FMT!r} + {TCP_MAC_BYTES}-byte mac "
            "(mac coverage drifted?)",
        ))
    consts = parse_py_constants(tp)
    if consts.get("MAC_BYTES") != TCP_MAC_BYTES:
        out.append(Finding(
            "layout/tcp-handshake", f"{pkg}/fleet/transport.py", 0,
            f"MAC_BYTES {consts.get('MAC_BYTES')!r} != contract "
            f"{TCP_MAC_BYTES} (HMAC-SHA256 digest size)",
        ))
    if consts.get("NONCE_BYTES") != TCP_NONCE_BYTES:
        out.append(Finding(
            "layout/tcp-handshake", f"{pkg}/fleet/transport.py", 0,
            f"NONCE_BYTES {consts.get('NONCE_BYTES')!r} != contract "
            f"{TCP_NONCE_BYTES}",
        ))
    if consts.get("HS_VERSION") is None:
        out.append(Finding(
            "layout/tcp-handshake", f"{pkg}/fleet/transport.py", 0,
            "HS_VERSION constant not statically visible (version "
            "negotiation needs a comparable constant)",
        ))
    return out


def _check_ingress_wire(root: Path, pkg: str = PKG) -> List[Finding]:
    """The §26 ingress wire records vs ingress.py: both structs
    present, the route frame = forwarded header + the two u64 fence
    words, and the versions/route ops statically visible (the deliberate
    PUT=1/DEL=2 split the decode path refuses everything outside)."""
    out: List[Finding] = []
    ing = root / f"{pkg}/fleet/ingress.py"
    fmts = {f.fmt for f in parse_py_struct_formats(ing)}
    for label, fmt in (("forwarded-datagram header", ING_FWD_FMT),
                       ("route-update frame", ING_ROUTE_FMT)):
        if fmt not in fmts:
            out.append(Finding(
                "layout/ingress-wire", f"{pkg}/fleet/ingress.py", 0,
                f"ingress {label} {fmt!r} not found (wire format "
                "drifted from the §26 contract?)",
            ))
    if (struct.calcsize(ING_ROUTE_FMT)
            != struct.calcsize(ING_FWD_FMT) + ING_FENCE_BYTES
            + TRACE_CTX_BYTES):
        out.append(Finding(
            "layout/ingress-wire", f"{pkg}/fleet/ingress.py", 0,
            f"route frame {ING_ROUTE_FMT!r} is not the forwarded "
            f"header {ING_FWD_FMT!r} + {ING_FENCE_BYTES} fence bytes "
            f"+ {TRACE_CTX_BYTES} trace-context bytes (epoch u64 + "
            "route-version u64 + trace ctx drifted?)",
        ))
    consts = parse_py_constants(ing)
    for name in ("FWD_VERSION", "ROUTE_WIRE_VERSION"):
        if consts.get(name) is None:
            out.append(Finding(
                "layout/ingress-wire", f"{pkg}/fleet/ingress.py", 0,
                f"{name} constant not statically visible (version "
                "refusal needs a comparable constant)",
            ))
    if (consts.get("ROUTE_WIRE_VERSION") is not None
            and consts.get("ROUTE_WIRE_VERSION")
            != ING_ROUTE_WIRE_VERSION):
        out.append(Finding(
            "layout/ingress-wire", f"{pkg}/fleet/ingress.py", 0,
            f"ROUTE_WIRE_VERSION {consts.get('ROUTE_WIRE_VERSION')!r} "
            f"!= contract {ING_ROUTE_WIRE_VERSION} (the v2 trace-"
            "context tail requires the version bump)",
        ))
    if (consts.get("ROUTE_OP_PUT"), consts.get("ROUTE_OP_DEL")) != (1, 2):
        out.append(Finding(
            "layout/ingress-wire", f"{pkg}/fleet/ingress.py", 0,
            f"route ops PUT={consts.get('ROUTE_OP_PUT')!r} "
            f"DEL={consts.get('ROUTE_OP_DEL')!r} != contract (1, 2)",
        ))
    return out


def _check_trace_context(root: Path, pkg: str = PKG) -> List[Finding]:
    """The §28 trace context: timeline.py owns the definition,
    transport.py mirrors it as a literal (RPC payload carriage), and
    the ingress route frame's trailing ``16s`` makes room for exactly
    ``TRACE_CTX_BYTES`` — all three pinned to the same 16 bytes."""
    out: List[Finding] = []
    for rel in (f"{pkg}/obs/timeline.py", f"{pkg}/fleet/transport.py"):
        path = root / rel
        fmts = {f.fmt for f in parse_py_struct_formats(path)}
        if TRACE_CTX_FMT not in fmts:
            out.append(Finding(
                "layout/trace-context", rel, 0,
                f"trace context {TRACE_CTX_FMT!r} not found (the §28 "
                "16-byte context drifted from the contract?)",
            ))
        consts = parse_py_constants(path)
        if consts.get("TRACE_CTX_BYTES") != TRACE_CTX_BYTES:
            out.append(Finding(
                "layout/trace-context", rel, 0,
                f"TRACE_CTX_BYTES {consts.get('TRACE_CTX_BYTES')!r} != "
                f"contract {TRACE_CTX_BYTES}",
            ))
    if struct.calcsize(TRACE_CTX_FMT) != TRACE_CTX_BYTES:
        out.append(Finding(
            "layout/trace-context", f"{pkg}/analysis/layout.py", 0,
            f"trace context {TRACE_CTX_FMT!r} packs to "
            f"{struct.calcsize(TRACE_CTX_FMT)} bytes, contract says "
            f"{TRACE_CTX_BYTES}",
        ))
    # the route frame's tail must hold exactly one packed context
    if not ING_ROUTE_FMT.endswith(f"{TRACE_CTX_BYTES}s"):
        out.append(Finding(
            "layout/trace-context", f"{pkg}/fleet/ingress.py", 0,
            f"route frame {ING_ROUTE_FMT!r} does not end in a "
            f"{TRACE_CTX_BYTES}-byte tail for the trace context",
        ))
    return out


def _check_stat_tables(
    root: Path, pkg: str = PKG, host: Optional[str] = None,
) -> List[Finding]:
    out: List[Finding] = []
    native_py = root / f"{pkg}/net/_native.py"
    tables = parse_py_field_tuples(native_py)
    host = host or host_sources(pkg)
    bank = parse_cpp_constants(root / f"{host}/session_bank.cpp")
    net = parse_cpp_constants(root / f"{host}/net_batch.cpp")
    ep_stats = tables.get("EP_STAT_FIELDS")
    if ep_stats is None:
        out.append(Finding(
            "layout/stat-table", f"{pkg}/net/_native.py", 0,
            "EP_STAT_FIELDS not statically parseable",
        ))
    else:
        # the per-endpoint stats tail rides a "<B10q{n}Q" record in
        # host_bank.py; its trailing u64 count is the EP stat arity
        fmts = {
            f.fmt
            for f in parse_py_struct_formats(
                root / f"{pkg}/parallel/host_bank.py"
            )
        }
        want = f"<B10q{len(ep_stats)}Q"
        if want not in fmts:
            out.append(Finding(
                "layout/stat-table", f"{pkg}/parallel/host_bank.py", 0,
                f"per-endpoint stats record {want!r} (B, 10×i64, "
                f"len(EP_STAT_FIELDS)×u64) not unpacked anywhere",
            ))
    io_fields = tables.get("IO_STAT_FIELDS")
    io_buckets = tables.get("IO_BATCH_BUCKETS")
    n_stats = bank.get("kNumNetStats")
    n_stats_nb = net.get("kNumNetStats")
    if n_stats != n_stats_nb:
        out.append(Finding(
            "layout/stat-table", f"{host}/net_batch.cpp", 0,
            f"kNumNetStats disagrees across native TUs: "
            f"session_bank={n_stats} net_batch={n_stats_nb}",
        ))
    if io_fields is None or io_buckets is None:
        out.append(Finding(
            "layout/stat-table", f"{pkg}/net/_native.py", 0,
            "IO_STAT_FIELDS / IO_BATCH_BUCKETS not statically parseable",
        ))
    elif n_stats is not None:
        words = len(io_fields) + 2 * (len(io_buckets) + 1)
        if words != n_stats:
            out.append(Finding(
                "layout/stat-table", f"{pkg}/net/_native.py", 0,
                f"IO stat words {words} (fields + 2×(buckets+inf)) != "
                f"native kNumNetStats {n_stats}",
            ))
    # gen-2 drain stats (§23a): scalar fields + one batch histogram share
    # kRecvTableStats words — kept SEPARATE from the 22-word NetStat tail
    # so kNumNetStats (and every attached-slot scrape) is untouched
    drain_fields = tables.get("NET_RECV_TABLE_STAT_FIELDS")
    n_drain = net.get("kRecvTableStats")
    if drain_fields is None:
        out.append(Finding(
            "layout/stat-table", f"{pkg}/net/_native.py", 0,
            "NET_RECV_TABLE_STAT_FIELDS not statically parseable",
        ))
    elif n_drain is not None and io_buckets is not None:
        words = len(drain_fields) + len(io_buckets) + 1
        if words != n_drain:
            out.append(Finding(
                "layout/stat-table", f"{pkg}/net/_native.py", 0,
                f"recv-table stat words {words} (fields + buckets+inf) "
                f"!= native kRecvTableStats {n_drain}",
            ))
    return out


def _check_varrec(root: Path, pkg: str = PKG) -> List[Finding]:
    """The §27 variable-size input envelope vs core/varrec.py: the u16
    length prefix is packed/unpacked with the declared format, the
    statically-visible header width equals the contract (and the
    contract's own fmt computes it), the capacity bound matches, and the
    device-side consumer (games/rtscmd.py's in-kernel envelope decode)
    derives its header offset from the shared constant, not a literal
    that can drift."""
    out: List[Finding] = []
    vr = root / f"{pkg}/core/varrec.py"
    fmts = {f.fmt for f in parse_py_struct_formats(vr)}
    if VARREC_HEADER_FMT not in fmts:
        out.append(Finding(
            "layout/varrec-header", f"{pkg}/core/varrec.py", 0,
            f"envelope length prefix {VARREC_HEADER_FMT!r} not found "
            "(pack/unpack drifted from the §27 contract?)",
        ))
    consts = parse_py_constants(vr)
    if consts.get("VARREC_HEADER_BYTES") != VARREC_HEADER_BYTES:
        out.append(Finding(
            "layout/varrec-header", f"{pkg}/core/varrec.py", 0,
            f"VARREC_HEADER_BYTES = {consts.get('VARREC_HEADER_BYTES')!r} "
            f"but the §27 contract says {VARREC_HEADER_BYTES}",
        ))
    if struct.calcsize(VARREC_HEADER_FMT) != VARREC_HEADER_BYTES:
        out.append(Finding(
            "layout/varrec-header", f"{pkg}/analysis/layout.py", 0,
            f"contract fmt {VARREC_HEADER_FMT!r} is not "
            f"{VARREC_HEADER_BYTES} bytes (the contract itself skewed)",
        ))
    if consts.get("VARREC_MAX_CAPACITY") != VARREC_MAX_CAPACITY:
        out.append(Finding(
            "layout/varrec-capacity", f"{pkg}/core/varrec.py", 0,
            f"VARREC_MAX_CAPACITY = {consts.get('VARREC_MAX_CAPACITY')!r} "
            f"but the u16 length prefix bounds it at "
            f"{VARREC_MAX_CAPACITY}",
        ))
    rts = root / f"{pkg}/games/rtscmd.py"
    if rts.exists() and "VARREC_HEADER_BYTES" not in rts.read_text():
        out.append(Finding(
            "layout/varrec-consumer", f"{pkg}/games/rtscmd.py", 0,
            "device-side envelope decode does not reference "
            "VARREC_HEADER_BYTES (header offset drifted to a literal?)",
        ))
    return out


def check_layout(
    root: Path,
    mirrors: Optional[Sequence[Tuple[str, str, str, str]]] = None,
    pkg: str = PKG,
    host: Optional[str] = None,
) -> List[Finding]:
    """Run every layout check over ``pkg``'s tree at ``root``, its C++
    host sources at ``host`` (default ``host_sources(pkg)``; the mirror
    table defaults to ``mirrored_constants(pkg, host)``); returns the
    (ideally empty) finding list."""
    root = Path(root)
    if mirrors is None:
        mirrors = mirrored_constants(pkg, host)
    findings: List[Finding] = []
    findings += _check_mirrors(root, mirrors)
    findings += _check_py_mirrors(root, pkg=pkg)
    findings += _check_header(root, pkg, host)
    findings += _check_descriptor_plane(root, pkg)
    findings += _check_body_prefix(root, pkg)
    findings += _check_rpc_framing(root, pkg)
    findings += _check_tcp_handshake(root, pkg)
    findings += _check_ingress_wire(root, pkg)
    findings += _check_trace_context(root, pkg)
    findings += _check_stat_tables(root, pkg, host)
    findings += _check_varrec(root, pkg)
    return findings
