"""Endpoint datapath cores: the per-tick mechanism under ``PeerProtocol``
(the port's copy of ``ggrs_tpu/net/endpoint.py``).

``PeerProtocol`` (protocol.py) keeps the reliability *policy*: timers,
events, the state machine, connect-status merging.  The per-tick
*mechanism* of one endpoint lives here behind a two-implementation seam:

- ``PyEndpointCore``, the pure-Python semantic reference;
- ``NativeEndpointCore``, the same state machine in C++
  (``csrc/host/endpoint.cpp``, compiled by ``_build.build_host``) with ONE
  ctypes crossing per send and per receive.

Both cores own the unacked pending-output window with its last-acked delta
base (reference: protocol.rs:421-487), the received-input ring that provides
the decode base (reference: protocol.rs:534-682), and the InputMessage
datagram build/decode.  Their wire bytes are identical, and identical to the
JAX package's cores; which core runs is invisible above this module.

Receive flow is two-phase: ``on_input`` PEEKS (decodes and stages the new
frames), the protocol validates the inner per-player framing, then
``commit`` applies the staged frames.  A packet with any malformed inner
frame is therefore dropped whole, with no partial state advance.
"""

from __future__ import annotations

import ctypes
import struct
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple, Union

from ..core.types import Frame, NULL_FRAME
from . import _native, compression
from .messages import (
    ConnectionStatus,
    InputMessage,
    Message,
    _MAX_PLAYERS_ON_WIRE,
)

# The wire contract for frames is i64 (the reference's Frame type).  Python's
# unbounded varint reader can surface values beyond that; such packets are
# malformed and dropped, with headroom so frame arithmetic (start_frame +
# count, start_frame - 1) stays inside i64 as the JAX package's C++ core
# requires.
_FRAME_SANE_MIN = -(1 << 62)
_FRAME_SANE_MAX = 1 << 62
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

# per-player-count packers for the native emit path's connect-status frames
_FRAME_PACKERS: dict = {}


class PyEndpointCore:
    """Pure-Python endpoint core."""

    def __init__(
        self, send_base: bytes, recv_base: bytes, max_prediction: int
    ) -> None:
        # outbound: all inputs the peer hasn't acked yet, as (frame, payload)
        self._pending: Deque[Tuple[Frame, bytes]] = deque()
        self._last_acked_frame: Frame = NULL_FRAME
        self._last_acked: bytes = send_base
        # inbound: received frame payloads by frame; NULL_FRAME holds the
        # zeroed decode base (reference: protocol.rs:208-209)
        self._recv: dict[Frame, bytes] = {NULL_FRAME: recv_base}
        self._last_recv: Frame = NULL_FRAME
        self._max_prediction = max_prediction
        self._staged: Optional[Tuple[Frame, List[bytes]]] = None

    # ---- send side ----

    def push_input(self, frame: Frame, payload: bytes) -> int:
        self._pending.append((frame, payload))
        return len(self._pending)

    def emit_input(
        self,
        magic: int,
        statuses: Sequence[ConnectionStatus],
        disconnect_requested: bool,
    ) -> Optional[bytes]:
        if not self._pending:
            return None
        # Wire cap shared with the native core (kErrTooManyInputs): the
        # connect-status list is uvarint-counted on the wire but capped so
        # the cores stay indistinguishable above the seam even for callers
        # that bypass SessionBuilder's player-count validation.
        if len(statuses) > _MAX_PLAYERS_ON_WIRE:
            raise RuntimeError(
                f"emit_input: {len(statuses)} connect statuses exceed the "
                f"{_MAX_PLAYERS_ON_WIRE}-entry wire cap"
            )
        first_frame = self._pending[0][0]
        if not (
            self._last_acked_frame == NULL_FRAME
            or self._last_acked_frame + 1 == first_frame
        ):
            raise RuntimeError(
                f"pending output head {first_frame} does not follow "
                f"last acked frame {self._last_acked_frame}"
            )
        body = InputMessage(
            peer_connect_status=list(statuses),
            disconnect_requested=disconnect_requested,
            start_frame=first_frame,
            ack_frame=self._last_recv,
            bytes=compression.encode(
                self._last_acked, [p for _, p in self._pending]
            ),
        )
        return Message(magic=magic, body=body).encode()

    def ack(self, ack_frame: Frame) -> None:
        while self._pending and self._pending[0][0] <= ack_frame:
            self._last_acked_frame, self._last_acked = self._pending.popleft()

    def pending_len(self) -> int:
        return len(self._pending)

    # ---- receive side ----

    def _base_for(self, start_frame: Frame) -> Optional[bytes]:
        if self._last_recv == NULL_FRAME:
            return self._recv[NULL_FRAME]
        base_frame = start_frame - 1
        # GC-cutoff at lookup time: an entry older than the window counts as
        # collected even if the physical sweep hasn't run yet
        if base_frame != NULL_FRAME and base_frame < (
            self._last_recv - 2 * self._max_prediction
        ):
            return None
        return self._recv.get(base_frame)

    def on_input(
        self, start_frame: Frame, comp: bytes
    ) -> Optional[Tuple[Frame, List[bytes]]]:
        """Peek: decode the packet and stage its NEW frames.  Returns
        ``(first_new_frame, payloads)`` (possibly ``(NULL_FRAME, [])`` for a
        pure-duplicate packet, which the caller still acks) or ``None`` when
        the packet must be silently dropped."""
        if not _FRAME_SANE_MIN <= start_frame <= _FRAME_SANE_MAX:
            return None  # beyond the i64 wire contract: malformed, drop
        lr = self._last_recv
        # a gap between what we have and where the packet starts is
        # unrecoverable — but also impossible from an honest peer, so drop
        # rather than crash (reference asserts here, protocol.rs:588-590)
        if lr != NULL_FRAME and lr + 1 < start_frame:
            return None
        base = self._base_for(start_frame)
        if base is None:
            return None
        try:
            decoded = compression.decode(base, comp)
        except compression.CodecError:
            return None  # malicious or corrupt: drop silently
        payloads: List[bytes] = []
        first_new: Frame = NULL_FRAME
        for i, fp in enumerate(decoded):
            frame = start_frame + i
            if frame <= lr:
                continue  # already have it
            if first_new == NULL_FRAME:
                first_new = frame
            payloads.append(fp)
        self._staged = (first_new, payloads)
        return self._staged

    def commit(self) -> None:
        if self._staged is None:
            return
        first_new, payloads = self._staged
        self._staged = None
        for i, fp in enumerate(payloads):
            frame = first_new + i
            self._recv[frame] = fp
            if frame > self._last_recv:
                self._last_recv = frame
        # physical GC sweep, throttled: correctness comes from the
        # lookup-time cutoff above, so the sweep only bounds memory
        if len(self._recv) > 4 * self._max_prediction + 8:
            cutoff = self._last_recv - 2 * self._max_prediction
            for f in [
                f for f in self._recv if f != NULL_FRAME and f < cutoff
            ]:
                del self._recv[f]

    def last_recv_frame(self) -> Frame:
        return self._last_recv

    def last_acked_frame(self) -> Frame:
        """Newest frame the peer has acked (obs stat surface)."""
        return self._last_acked_frame

    # ---- adoption seams ----

    def seed_send(self, last_acked_frame: Frame, base: bytes) -> None:
        """Adopt the send-side delta base: the resumed pending window
        (re-fed via ``push_input``) compresses against, and must
        sequentially follow, the exact base the peer last acked."""
        self._last_acked_frame = last_acked_frame
        self._last_acked = base

    def seed_recv(
        self, last_recv: Frame, entries: Sequence[Tuple[Frame, bytes]]
    ) -> None:
        """Adopt the receive-side ring: the frame payloads in-flight packets
        will delta-decode against, plus the last-received watermark."""
        for frame, payload in entries:
            self._recv[frame] = payload
        if last_recv > self._last_recv:
            self._last_recv = last_recv

    def rewind_send(self, frame: Frame, base: bytes) -> None:
        """Rewind the send window to an earlier delta base: the peer resumed
        from its durable journal and holds less than it once acked.  Drops
        the pending window; the caller re-pushes everything after ``frame``
        from its sent-payload ring."""
        self._pending.clear()
        self._last_acked_frame = frame
        self._last_acked = base


class NativeEndpointCore:
    """C++-backed endpoint datapath (``csrc/host/endpoint.cpp`` via ctypes)."""

    # receive staging caps; a legal packet beyond these falls back to the
    # Python codec through the fetch_base/store_one escape hatches
    _RECV_CAP_BYTES = 1 << 16
    _RECV_CAP_FRAMES = 512

    def __init__(
        self, lib: ctypes.CDLL, send_base: bytes, recv_base: bytes,
        max_prediction: int,
    ) -> None:
        self._lib = lib
        self._ptr = lib.ggrs_ep_new(
            send_base, len(send_base), recv_base, len(recv_base), max_prediction
        )
        if not self._ptr:
            raise MemoryError("ggrs_ep_new failed")
        self._max_prediction = max_prediction
        self._out = ctypes.create_string_buffer(1 << 12)
        self._out_len = ctypes.c_size_t(0)
        self._recv_out = ctypes.create_string_buffer(self._RECV_CAP_BYTES)
        self._recv_sizes = (ctypes.c_size_t * self._RECV_CAP_FRAMES)()
        self._recv_count = ctypes.c_size_t(0)
        self._first_new = ctypes.c_int64(0)
        self._new_last_recv = ctypes.c_int64(0)
        self._last_recv: Frame = NULL_FRAME  # mirror, updated on commit
        # set when a fallback-path peek staged frames Python-side
        self._py_staged: Optional[Tuple[Frame, List[bytes]]] = None
        # fused-receive scratch (header outs of handle_input_datagram)
        self._hdr_magic = ctypes.c_uint16(0)
        self._hdr_dreq = ctypes.c_uint8(0)
        self._hdr_disc = (ctypes.c_uint8 * _MAX_PLAYERS_ON_WIRE)()
        self._hdr_frames = (ctypes.c_int64 * _MAX_PLAYERS_ON_WIRE)()
        self._hdr_n = ctypes.c_int32(0)
        self._hdr_start = ctypes.c_int64(0)
        # handle_input_datagram runs once per received packet; its 13
        # non-data arguments never change, so they are built once (byref
        # objects are reusable)
        self._hid_fn = lib.ggrs_ep_handle_input_datagram
        self._hid_tail = (
            ctypes.byref(self._hdr_magic), ctypes.byref(self._hdr_dreq),
            self._hdr_disc, self._hdr_frames, ctypes.byref(self._hdr_n),
            ctypes.byref(self._hdr_start),
            self._recv_out, self._RECV_CAP_BYTES,
            self._recv_sizes, self._RECV_CAP_FRAMES,
            ctypes.byref(self._recv_count), ctypes.byref(self._first_new),
            ctypes.byref(self._new_last_recv),
        )
        self._out_len_ref = ctypes.byref(self._out_len)

    def __del__(self) -> None:  # pragma: no cover
        try:
            if self._ptr:
                self._lib.ggrs_ep_free(self._ptr)
                self._ptr = None
        except Exception:
            pass

    # ---- send side ----

    def push_input(self, frame: Frame, payload: bytes) -> int:
        return self._lib.ggrs_ep_push(self._ptr, frame, payload, len(payload))

    def emit_input(
        self,
        magic: int,
        statuses: Sequence[ConnectionStatus],
        disconnect_requested: bool,
    ) -> Optional[bytes]:
        n = len(statuses)
        disc = bytes(1 if s.disconnected else 0 for s in statuses)
        # status frames are session state and always i64 (the protocol drops
        # packets carrying larger values before they can be merged in); the
        # Struct is cached per player count: this runs every send
        packer = _FRAME_PACKERS.get(n)
        if packer is None:
            packer = _FRAME_PACKERS[n] = struct.Struct(f"<{n}q")
        frames = packer.pack(*[s.last_frame for s in statuses])
        while True:
            rc = self._lib.ggrs_ep_emit_input(
                self._ptr, magic, disc, frames, n,
                1 if disconnect_requested else 0,
                self._out, len(self._out), self._out_len_ref,
            )
            if rc == _native.EP_ERR_BUFFER_TOO_SMALL:
                # grow until the datagram fits: the Python core has no size
                # limit here either (memory is bounded by the message)
                self._out = ctypes.create_string_buffer(len(self._out) * 4)
                continue
            break
        if rc == _native.EP_BAD_PENDING_HEAD:
            raise RuntimeError("pending output head does not follow last acked frame")
        if rc == _native.EP_ERR_TOO_MANY_INPUTS:
            # PyEndpointCore's message: the cores are indistinguishable
            # above the seam
            raise RuntimeError(
                f"emit_input: {n} connect statuses exceed the "
                f"{_MAX_PLAYERS_ON_WIRE}-entry wire cap"
            )
        if rc != 0:
            raise RuntimeError(f"ggrs_ep_emit_input failed: {rc}")
        if self._out_len.value == 0:
            return None
        return ctypes.string_at(self._out, self._out_len.value)

    def ack(self, ack_frame: Frame) -> None:
        # clamp rather than let ctypes wrap: stored frames are always in i64
        # range, so the clamped comparison pops exactly the entries the
        # Python core's unbounded comparison would
        ack_frame = min(max(ack_frame, _I64_MIN), _I64_MAX)
        self._lib.ggrs_ep_ack(self._ptr, ack_frame)

    def pending_len(self) -> int:
        return self._lib.ggrs_ep_pending_len(self._ptr)

    # ---- receive side ----

    def _staged_payloads(self) -> List[bytes]:
        payloads: List[bytes] = []
        pos = 0
        for i in range(self._recv_count.value):
            size = self._recv_sizes[i]
            payloads.append(ctypes.string_at(ctypes.byref(self._recv_out, pos), size))
            pos += size
        return payloads

    def on_input(
        self, start_frame: Frame, comp: bytes
    ) -> Optional[Tuple[Frame, List[bytes]]]:
        if not _FRAME_SANE_MIN <= start_frame <= _FRAME_SANE_MAX:
            return None  # beyond the i64 wire contract: malformed, drop
        self._py_staged = None
        rc = self._lib.ggrs_ep_on_input(
            self._ptr, start_frame, comp, len(comp),
            self._recv_out, self._RECV_CAP_BYTES,
            self._recv_sizes, self._RECV_CAP_FRAMES,
            ctypes.byref(self._recv_count), ctypes.byref(self._first_new),
            ctypes.byref(self._new_last_recv),
        )
        if rc == _native.EP_DROP:
            return None
        if rc == _native.EP_FALLBACK:
            return self._on_input_py(start_frame, comp)
        if rc != 0:
            raise RuntimeError(f"ggrs_ep_on_input failed: {rc}")
        payloads = self._staged_payloads()
        return (self._first_new.value if payloads else NULL_FRAME), payloads

    def handle_input_datagram(self, data: bytes) -> Union[None, str, tuple]:
        """The fused receive: parse + ack + decode + stage in ONE native
        call.  Returns ``(disconnect_requested, statuses, staged_or_None)``,
        where ``statuses`` is ``(n, disc_array, frame_array)`` over reusable
        scratch (read it before the next call) and ``staged_or_None`` is
        ``on_input``'s return; or ``"fallback"`` when the datagram needs the
        object path; or None when it is malformed and must be dropped
        whole."""
        self._py_staged = None
        rc = self._hid_fn(self._ptr, data, len(data), *self._hid_tail)
        if rc == _native.EP_FALLBACK:
            return "fallback"
        if rc != 0 and rc != _native.EP_DROP:
            return None  # malformed datagram: dropped whole, nothing applied
        statuses = (self._hdr_n.value, self._hdr_disc, self._hdr_frames)
        if rc == _native.EP_DROP:
            staged = None
        else:
            payloads = self._staged_payloads()
            staged = (self._first_new.value if payloads else NULL_FRAME, payloads)
        return bool(self._hdr_dreq.value), statuses, staged

    def _on_input_py(
        self, start_frame: Frame, comp: bytes
    ) -> Optional[Tuple[Frame, List[bytes]]]:
        """The Python codec for legal-but-huge packets: same staging
        semantics, committed through ggrs_ep_store_one."""
        base_buf = ctypes.create_string_buffer(compression.MAX_DECODED_BYTES)
        base_len = ctypes.c_size_t(0)
        rc = self._lib.ggrs_ep_fetch_base(
            self._ptr, start_frame, base_buf, len(base_buf), ctypes.byref(base_len)
        )
        if rc != 0:
            return None
        base = ctypes.string_at(base_buf, base_len.value)
        try:
            decoded = compression.decode_py(base, comp)
        except compression.CodecError:
            return None
        lr = self.last_recv_frame()
        payloads: List[bytes] = []
        first_new: Frame = NULL_FRAME
        for i, fp in enumerate(decoded):
            frame = start_frame + i
            if frame <= lr:
                continue
            if first_new == NULL_FRAME:
                first_new = frame
            payloads.append(fp)
        self._py_staged = (first_new, payloads)
        return self._py_staged

    def commit(self) -> None:
        if self._py_staged is not None:
            first_new, payloads = self._py_staged
            self._py_staged = None
            for i, fp in enumerate(payloads):
                self._lib.ggrs_ep_store_one(self._ptr, first_new + i, fp, len(fp))
            if payloads:
                self._last_recv = max(self._last_recv, first_new + len(payloads) - 1)
            return
        self._lib.ggrs_ep_commit(self._ptr)
        if self._new_last_recv.value > self._last_recv:
            self._last_recv = self._new_last_recv.value
        self._recv_count.value = 0

    def last_recv_frame(self) -> Frame:
        return self._last_recv

    def last_acked_frame(self) -> Frame:
        """Newest frame the peer has acked (obs stat surface)."""
        return self._lib.ggrs_ep_last_acked_frame(self._ptr)

    # ---- adoption seams ----

    def seed_send(self, last_acked_frame: Frame, base: bytes) -> None:
        """``PyEndpointCore.seed_send`` over the native core."""
        self._lib.ggrs_ep_seed_send(self._ptr, last_acked_frame, base, len(base))

    def seed_recv(
        self, last_recv: Frame, entries: Sequence[Tuple[Frame, bytes]]
    ) -> None:
        """``PyEndpointCore.seed_recv`` over the native core
        (``ggrs_ep_store_one`` keeps the C++ last-recv watermark in step)."""
        for frame, payload in entries:
            self._lib.ggrs_ep_store_one(self._ptr, frame, payload, len(payload))
        if last_recv > self._last_recv:
            self._last_recv = last_recv

    def rewind_send(self, frame: Frame, base: bytes) -> None:
        """``PyEndpointCore.rewind_send`` over the native core."""
        self._lib.ggrs_ep_rewind_send(self._ptr, frame, base, len(base))


def make_endpoint_core(
    send_base: bytes, recv_base: bytes, max_prediction: int
) -> Union[PyEndpointCore, NativeEndpointCore]:
    """The native core, or the pure-Python core when the caller switched the
    native library off (``GGRS_TPU_NO_NATIVE``)."""
    lib = _native.endpoint_lib()
    if lib is not None:
        return NativeEndpointCore(lib, send_base, recv_base, max_prediction)
    return PyEndpointCore(send_base, recv_base, max_prediction)
