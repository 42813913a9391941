"""Durable match journals: the per-match confirmed-input stream on disk.

The port's own copy of ``ggrs_tpu/broadcast/journal.py``; the files are byte
for byte the JAX package's, and each package reads the other's.  The
confirmed-input stream is the canonical, deterministic artifact of a
rollback match -- the record list a host relays to spectators
(GGRS src/sessions/p2p_session.rs:717-744) determines every frame of the
simulation.  ``MatchJournal`` appends it to one file per match, framed and
crc32-chained, fed from a session through :class:`JournalTap`.  Its reader
is ``sessions.replay.ReplaySession``, which re-emits the request stream and
fast-forwards it on the card (``ops.replay.build_scrub_program``).

File layout (all little-endian):

  header   ``GGJL1\\n`` + u32 meta_len + meta JSON + u32 crc32(meta)
  records  u8 kind, u32 payload_len, i64 frame, u32 crc, payload
           crc = crc32(kind + payload_len + frame + payload, prev_crc) --
           chained from the header crc and covering the record header, so
           truncation or a flipped byte ANYWHERE invalidates every later
           record and a reader recovers exactly the intact prefix.

Record kinds: FRAME (payload = num_players blank flags + num_players *
input_size raw input bytes), CHECKPOINT (payload = a self-contained npz blob
from ``utils.checkpoint.dumps_pytree``; ``frame`` = the next frame to
simulate from that state), GAP (a known hole; replays stop here), CLOSE
(clean end of match), LOCAL (payload = u16 player handle + input_size raw
bytes: one staged LOCAL input, written at staging time, ahead of the
confirmed stream, for fleet crash failover).

The journal is also the crash-recovery seam: :meth:`MatchJournal.
recovery_harvest` synthesizes a harvest-shaped resume dict from the in-memory
tail window, so an evicted bank slot whose native harvest is gone still
resumes mid-match (``HostSessionPool.set_confirmed_stream(recovery=...)``),
and :func:`resume_from_file` does the same from the durable file alone.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.types import NULL_FRAME
from ..net.wire import encode_uvarint
from ..obs.registry import Registry, default_registry
from ..obs.trace import NULL_TRACER

logger = logging.getLogger(__name__)

MAGIC = b"GGJL1\n"

REC_FRAME = 1
REC_CHECKPOINT = 2
REC_GAP = 3
REC_CLOSE = 4
REC_LOCAL = 5

_HEADER_FMT = "<BIqI"  # kind, payload_len, frame, crc
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)

# fsync latency lives in the sub-millisecond to tens-of-ms range
_FSYNC_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.5)


class JournalError(Exception):
    """Malformed or corrupt journal data."""


class JournalExhausted(Exception):
    """Replay reached the end of the journal (or a recorded gap)."""


class MatchJournal:
    """Append-only journal for one match.

    ``append_frames(start_frame, records)`` is the sink contract the session
    bank's confirmed-stream tap and a ``JournalTap`` call (records are
    ``(blank_flags, joined_inputs)`` byte pairs, one per consecutive frame).
    The journal also keeps an in-memory tail window (``tail_window`` newest
    frames) for crash recovery: :meth:`recovery_harvest` rebuilds an evicted
    slot's resume state from it without touching disk.

    ``fsync_every``: fsync after that many appended frames (0 = leave
    durability to ``close()``/the OS).  Fsync latency lands in the
    ``ggrs_journal_fsync_seconds`` histogram.
    """

    def __init__(
        self,
        path,
        num_players: int,
        input_size: int,
        meta: Optional[Dict[str, Any]] = None,
        fsync_every: int = 0,
        tail_window: int = 128,
        metrics: Optional[Registry] = None,
        tracer=None,
    ) -> None:
        self.path = os.fspath(path)
        self.num_players = num_players
        self.input_size = input_size
        self.next_frame = 0  # next frame the journal expects to append
        self._fsync_every = fsync_every
        self._since_fsync = 0
        self._local_dirty = False
        self._closed = False
        # write-failure degradation: the first OSError out of an
        # append/flush/fsync (ENOSPC, EIO, a yanked volume) marks the journal
        # FAILED -- further records are dropped (writing past a torn record
        # would corrupt the crc-chain prefix a reader can still recover), and
        # the failure is counted and logged loudly.  The in-memory tail keeps
        # updating.
        self.failed: Optional[str] = None
        # test seam: callable(stage) with stage in {"write", "flush",
        # "fsync"}; raise OSError to inject ENOSPC/EIO at that stage
        self._inject_fault = None
        # fsync stalls show up as journal.fsync spans on the tracer
        self._tracer = tracer if tracer is not None else NULL_TRACER
        # the newest frames: (frame, flags, blob), contiguous
        self.tail: deque = deque(maxlen=tail_window)
        # per-player connect tracking (a later resume reads these)
        self._disc = [False] * num_players
        self._last = [NULL_FRAME] * num_players
        m = metrics if metrics is not None else default_registry()
        self._m_bytes = m.counter(
            "ggrs_journal_bytes_total", "journal bytes appended")
        self._m_frames = m.counter(
            "ggrs_journal_frames_total", "confirmed frames journaled")
        self._m_checkpoints = m.counter(
            "ggrs_journal_checkpoints_total", "state checkpoints journaled")
        self._m_gaps = m.counter(
            "ggrs_journal_gaps_total", "gap records written (lost frames)")
        self._m_fsync = m.histogram(
            "ggrs_journal_fsync_seconds", "journal fsync latency",
            buckets=_FSYNC_BUCKETS)
        self._m_write_failures = m.counter(
            "ggrs_journal_write_failures_total",
            "journals degraded by an append/flush/fsync I/O error")

        header_meta = dict(meta or {})
        header_meta.setdefault("num_players", num_players)
        header_meta.setdefault("input_size", input_size)
        meta_blob = json.dumps(header_meta).encode()
        self.meta = header_meta
        # 'xb', never 'wb': silently truncating a prior match's journal would
        # destroy the very artifact this class exists to keep (raises
        # FileExistsError; pick a fresh path)
        self._f = open(self.path, "xb")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<I", len(meta_blob)))
        self._f.write(meta_blob)
        self._crc = zlib.crc32(meta_blob) & 0xFFFFFFFF
        self._f.write(struct.pack("<I", self._crc))
        self._m_bytes.inc(len(MAGIC) + 8 + len(meta_blob))

    # ------------------------------------------------------------------
    # writing
    # ------------------------------------------------------------------

    def _fail(self, reason: str) -> None:
        """First write failure: degrade loudly, once.  The journal stays
        open (the fd may still close cleanly) but appends no more."""
        if self.failed is not None:
            return
        self.failed = reason
        self._m_write_failures.inc()
        logger.error(
            "journal %s degraded (%s): further records dropped; crash "
            "failover must treat this incarnation as journal-less",
            self.path, reason,
        )

    def _append(self, kind: int, frame: int, payload: bytes) -> None:
        if self.failed is not None:
            return
        head = struct.pack("<BIq", kind, len(payload), frame)
        crc = zlib.crc32(payload, zlib.crc32(head, self._crc)) & 0xFFFFFFFF
        try:
            if self._inject_fault is not None:
                self._inject_fault("write")
            self._f.write(head)
            self._f.write(struct.pack("<I", crc))
            self._f.write(payload)
        except OSError as e:
            # the record may be TORN on disk (partial write); the crc chain
            # makes readers recover exactly the intact prefix, and never
            # appending again keeps that prefix stable
            self._fail(f"append: {e}")
            return
        self._crc = crc
        self._m_bytes.inc(_HEADER_SIZE + len(payload))

    def append_frames(
        self, start_frame: int, records: Sequence[Tuple[bytes, bytes]]
    ) -> None:
        """The confirmed-stream sink: consecutive frames from
        ``start_frame``, each a ``(blank_flags, joined_inputs)`` pair.
        Frames the journal already holds are skipped; a forward jump (frames
        lost to a fault) is recorded as an explicit GAP, never papered
        over."""
        if self._closed:
            return
        for i, (flags, blob) in enumerate(records):
            frame = start_frame + i
            if frame < self.next_frame:
                continue  # duplicate delivery: already journaled
            if frame > self.next_frame:
                self._append(REC_GAP, frame, b"")
                if self.failed is None:
                    self._m_gaps.inc()
                self.tail.clear()  # the tail window must stay contiguous
            self._append(REC_FRAME, frame, flags + blob)
            if self.failed is None:
                self._m_frames.inc()
            self.tail.append((frame, flags, blob))
            for p in range(self.num_players):
                if flags[p]:
                    self._disc[p] = True
                else:
                    self._disc[p] = False
                    self._last[p] = frame
            self.next_frame = frame + 1
            self._since_fsync += 1
        if self._fsync_every and self._since_fsync >= self._fsync_every:
            self.flush(fsync=True)

    def append_local_input(self, frame: int, handle: int, payload: bytes) -> None:
        """Journal one staged LOCAL input: the value player ``handle``
        staged for ``frame``, written BEFORE the tick that sends it (callers
        fsync via :meth:`flush_local` ahead of the send)."""
        if self._closed or self.failed is not None:
            return
        self._append(REC_LOCAL, frame, struct.pack("<H", handle) + payload)
        self._local_dirty = self.failed is None

    def flush_local(self) -> None:
        """Fsync pending LOCAL records (no-op when none were appended since
        the last flush) -- the durable-before-send barrier."""
        if self._local_dirty and not self._closed:
            self.flush(fsync=True)
            self._local_dirty = False

    def append_checkpoint(
        self, frame: int, state: Any, meta: Optional[Dict[str, Any]] = None
    ) -> None:
        """Embed a state checkpoint: ``state`` (a tree of tensors or numpy
        arrays, fetched to the host) is the simulation state from which
        ``frame`` is the NEXT frame to advance -- the state after applying
        frames ``0..frame-1``.  ``ReplaySession.seek`` lands on the newest
        checkpoint at or below its target."""
        if self._closed or self.failed is not None:
            return  # degraded: don't serialize, don't count
        from ..utils.checkpoint import dumps_pytree

        blob = dumps_pytree(state, dict(meta or {}, frame=frame))
        self._append(REC_CHECKPOINT, frame, blob)
        if self.failed is None:
            self._m_checkpoints.inc()

    def flush(self, fsync: bool = False) -> None:
        if self.failed is not None:
            return
        try:
            if self._inject_fault is not None:
                self._inject_fault("flush")
            self._f.flush()
        except OSError as e:
            self._fail(f"flush: {e}")
            return
        if fsync:
            with self._tracer.span("journal.fsync", cat="io"):
                t0 = time.perf_counter()
                try:
                    if self._inject_fault is not None:
                        self._inject_fault("fsync")
                    os.fsync(self._f.fileno())
                except OSError as e:
                    # an fsync failure means UNKNOWN durability for every
                    # record since the last good fsync: the same degradation
                    # as a torn append (a second fsync cannot resurrect pages
                    # the kernel dropped)
                    self._fail(f"fsync: {e}")
                    return
                self._m_fsync.observe(time.perf_counter() - t0)
            self._since_fsync = 0

    def close(self) -> None:
        if self._closed:
            return
        self._append(REC_CLOSE, self.next_frame, b"")
        self.flush(fsync=True)
        try:
            self._f.close()
        except OSError as e:
            self._fail(f"close: {e}")
        self._closed = True

    def __enter__(self) -> "MatchJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


    # ------------------------------------------------------------------
    # crash recovery (the journal adoption seam)
    # ------------------------------------------------------------------

    def recovery_harvest(self, pool, index: int) -> Dict[str, Any]:
        """Synthesize a ``ggrs_bank_harvest``-shaped resume dict from the
        in-memory tail window: the eviction path's stand-in when the
        native harvest itself fails (crash recovery; registered through
        ``HostSessionPool.set_confirmed_stream(recovery=...)``).

        The window holds every player's confirmed inputs for the newest
        ``tail_window`` frames, which is exactly what the harvest recovers:
        sync-queue seeds, per-endpoint send windows (resent by the retry
        timer, closing the peers' sequence gap — peers skip the overlap),
        receive rings, and the spectator fan-out windows.  Liveness state
        comes from the pool's Python-side mirrors."""
        if not self.tail:
            raise JournalError("journal tail is empty: nothing to resume")
        m = pool._mirrors[index]
        return _window_resume(
            list(self.tail),
            num_players=self.num_players,
            input_size=self.input_size,
            local_handles=m.local_handles,
            endpoints=[(ep.handles, ep.running) for ep in m.endpoints],
            spectators=[sp.running for sp in m.spectators],
            disc=self._disc,
            last=self._last,
            current=m.current_frame,
        )


def _window_resume(
    window: Sequence[Tuple[int, bytes, bytes]],
    *,
    num_players: int,
    input_size: int,
    local_handles: Sequence[int],
    endpoints: Sequence[Tuple[Sequence[int], bool]],
    spectators: Sequence[bool],
    disc: Sequence[bool],
    last: Sequence[int],
    current: int,
) -> Dict[str, Any]:
    """A ``ggrs_bank_harvest``-shaped resume dict from one contiguous
    window of confirmed frames (``(frame, blank_flags, joined_blob)``
    triples) — the core shared by :meth:`MatchJournal.recovery_harvest`
    (live in-memory tail + pool mirrors) and :func:`resume_from_file`
    (durable journal alone, fleet crash failover).  ``endpoints`` is
    ``(handles, running)`` per remote endpoint; ``spectators`` is one
    running flag per fan-out endpoint."""
    isize = input_size
    frames = [f for f, _, _ in window]
    w0, tip = frames[0], frames[-1]
    blob_at = {f: blob for f, _, blob in window}

    def join(handles: Sequence[int], frame: int) -> bytes:
        blob = blob_at[frame]
        return b"".join(
            encode_uvarint(isize) + blob[h * isize : (h + 1) * isize]
            for h in handles
        )

    def send_window(handles: Sequence[int]):
        """(last_acked, base, pending) so the pending head follows the
        base exactly (the emit-side invariant)."""
        if w0 == 0:
            zeros = bytes(isize)
            base = b"".join(encode_uvarint(isize) + zeros for _ in handles)
            return NULL_FRAME, base, [
                (f, join(handles, f)) for f in frames
            ]
        return w0, join(handles, w0), [
            (f, join(handles, f)) for f in frames[1:]
        ]

    eps = []
    for handles, running in endpoints:
        acked, base, pending = send_window(local_handles)
        eps.append(dict(
            state=0 if running else 1,
            last_acked_frame=acked, send_base=base, pending=pending,
            last_recv=tip,
            recv_entries=[(f, join(handles, f)) for f in frames],
        ))
    all_players = list(range(num_players))
    sps = []
    for running in spectators:
        acked, base, pending = send_window(all_players)
        sps.append(dict(
            state=0 if running else 1,
            last_acked_frame=acked, send_base=base, pending=pending,
        ))
    player_inputs = [
        (w0, [blob_at[f][p * isize : (p + 1) * isize] for f in frames])
        for p in all_players
    ]
    resume = min(tip, current)
    return dict(
        current=current,
        last_confirmed=resume,
        disconnect_frame=NULL_FRAME,
        local_disc=list(disc),
        local_last=list(last),
        player_inputs=player_inputs,
        endpoints=eps,
        next_spectator_frame=tip + 1,
        spectators=sps,
    )


def resume_from_file(
    path,
    *,
    local_handles: Sequence[int],
    endpoints: Sequence[Tuple[Sequence[int], bool]],
    spectators: Sequence[bool] = (),
    tail_window: int = 128,
) -> Dict[str, Any]:
    """Crash-failover recovery from the DURABLE journal alone (the JAX
    package's fleet layer, docs/DESIGN.md §16): parse the intact crc32
    prefix of ``path`` and synthesize the resume material for a match
    whose shard process (its native bank, mirrors, and in-memory journal
    tail) is GONE.

    Safe to call while the (dead or dying) writer's last append is torn
    mid-record: the crc chain truncates the parse at the last durable
    record, so the result always resumes to the last durable frame.

    Topology comes from the caller (the fleet supervisor's match
    registry), not the journal: ``endpoints`` is ``(handles, running)``
    per remote endpoint in the source slot's endpoint order,
    ``spectators`` one running flag per carried-over viewer.

    Returns ``dict(harvest=…, checkpoint=(frame, npz_blob) | None,
    durable_tip=frame, window=[(frame, flags, blob), …],
    local_tail={frame: {handle: raw_input}})``: ``harvest``
    is the harvest-shaped resume dict over the newest contiguous
    confirmed window (capped at ``tail_window`` frames, returned raw as
    ``window`` so failover can build its fast-forward prelude),
    ``checkpoint`` the newest embedded state checkpoint whose frame lies
    inside that window (the only state a dead process leaves behind;
    without one the game state cannot be rebuilt and the caller must
    treat the match as unrecoverable)."""
    parsed = read_journal(path)
    frames = parsed["frames"]
    if not frames:
        raise JournalError(f"{path}: no durable frames to resume from")
    window: List[Tuple[int, bytes, bytes]] = []
    for rec in reversed(frames):
        if window and rec[0] != window[-1][0] - 1:
            break  # a gap record (or lost prefix) ends the usable window
        window.append(rec)
        if len(window) >= tail_window:
            break
    window.reverse()
    meta = parsed["meta"]
    players = int(meta["num_players"])
    isize = int(meta["input_size"])
    disc = [False] * players
    last = [NULL_FRAME] * players
    for f, flags, _ in frames:
        for p in range(players):
            if flags[p]:
                disc[p] = True
            else:
                disc[p] = False
                last[p] = f
    w0, tip = window[0][0], window[-1][0]
    checkpoint = None
    for cf, blob in reversed(parsed["checkpoints"]):
        # resumable: the state at cf (frames 0..cf-1 applied) plus the
        # confirmed inputs cf..tip-1 (all in the window) rebuild the
        # state AT the durable tip.  cf == tip+1 is NOT resumable even
        # though it is durable: that state already includes frame tip,
        # and the fast-forward prelude would store it under the tip's
        # cell, making the resumed session re-apply frame tip — a silent
        # desync.  (Reachable for bank-tier matches: checkpoints follow
        # the pool's confirmed watermark while the journal's frame feed
        # trails it by the fan-out deferral.)
        if w0 <= cf <= tip:
            checkpoint = (cf, blob)
            break
    harvest = _window_resume(
        window,
        num_players=players,
        input_size=isize,
        local_handles=list(local_handles),
        endpoints=list(endpoints),
        spectators=list(spectators),
        disc=disc,
        last=last,
        current=tip,
    )
    # the staged-local tail: values the dead incarnation SENT for frames
    # at/after the durable tip (a rollback host sends predicted frames
    # immediately), which the resumed incarnation must replay verbatim —
    # re-sending different values for frames the peers already hold would
    # silently desync the match.  Last record wins (re-staging after a
    # readmission overwrites).
    local_tail: Dict[int, Dict[int, bytes]] = {}
    for f, handle, payload in parsed["local_inputs"]:
        if f >= tip:
            local_tail.setdefault(f, {})[handle] = payload
    return dict(harvest=harvest, checkpoint=checkpoint, durable_tip=tip,
                window=window, local_tail=local_tail)


class JournalTap:
    """A pseudo spectator endpoint that journals instead of sending.
    Grafted onto a ``P2PSession`` via ``adopt_spectator_endpoint``, it
    receives the exact ``send_input`` calls a real spectator endpoint would
    and appends them; every other endpoint-surface method is a no-op, so the
    session's poll/flush loops pass through it unperturbed."""

    ADDR = ("__ggrs_journal_tap__", 0)  # never a real peer address

    def __init__(self, journal: MatchJournal, config=None) -> None:
        self._journal = journal
        self._encode = config.input_encode if config is not None else None
        self.handles: List[int] = []
        self.peer_addr = self.ADDR

    # --- the one live method ---
    def send_input(self, inputs: Dict[int, Any], connect_status) -> None:
        j = self._journal
        flags = bytearray(j.num_players)
        parts: List[bytes] = []
        frame = NULL_FRAME
        for handle in sorted(inputs):
            pi = inputs[handle]
            if pi.frame == NULL_FRAME:
                flags[handle] = 1
                parts.append(bytes(j.input_size))
            else:
                frame = pi.frame
                blob = self._encode(pi.input) if self._encode is not None else bytes(pi.input)
                if len(blob) != j.input_size:
                    # a config-less tap handed non-bytes inputs would
                    # otherwise corrupt the journal silently
                    raise JournalError(
                        f"tap encoded a {len(blob)}-byte input; journal "
                        f"holds {j.input_size}-byte inputs (pass the "
                        "session Config to JournalTap)"
                    )
                parts.append(blob)
        if frame == NULL_FRAME:
            return  # every player disconnected below this frame
        j.append_frames(frame, [(bytes(flags), b"".join(parts))])

    # --- inert endpoint surface ---
    def poll(self, connect_status) -> List:
        return []

    def send_all_messages(self, socket) -> None:
        pass

    def is_running(self) -> bool:
        return True

    def is_synchronizing(self) -> bool:
        return False

    def is_handling_message(self, addr) -> bool:
        return False

    def handle_datagram(self, data) -> None:
        pass

    def handle_message(self, msg) -> None:
        pass

    def disconnect(self) -> None:
        pass


def read_journal(path) -> Dict[str, Any]:
    """Parse a journal file into ``{meta, frames, checkpoints, gaps,
    local_inputs, closed, truncated}``.  The crc chain is verified record by
    record; a mismatch (torn write, bit rot) truncates the parse at the last
    intact record instead of raising -- the recovered prefix is still a
    valid replay (``truncated`` reports it)."""
    with open(os.fspath(path), "rb") as f:
        data = f.read()
    if not data.startswith(MAGIC):
        raise JournalError("not a ggrs journal (bad magic)")
    pos = len(MAGIC)
    if pos + 4 > len(data):
        raise JournalError("truncated journal header")
    (meta_len,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if pos + meta_len + 4 > len(data):
        raise JournalError("truncated journal header")
    meta_blob = data[pos : pos + meta_len]
    pos += meta_len
    (header_crc,) = struct.unpack_from("<I", data, pos)
    pos += 4
    crc = zlib.crc32(meta_blob) & 0xFFFFFFFF
    if crc != header_crc:
        raise JournalError("journal header crc mismatch")
    meta = json.loads(meta_blob.decode())
    players = int(meta["num_players"])
    isize = int(meta["input_size"])
    frame_payload = players + players * isize

    frames: List[Tuple[int, bytes, bytes]] = []
    checkpoints: List[Tuple[int, bytes]] = []
    gaps: List[int] = []
    local_inputs: List[Tuple[int, int, bytes]] = []
    closed = False
    truncated = False
    while pos < len(data):
        if pos + _HEADER_SIZE > len(data):
            truncated = True
            break
        kind, plen, frame, rec_crc = struct.unpack_from(_HEADER_FMT, data, pos)
        if pos + _HEADER_SIZE + plen > len(data):
            truncated = True
            break
        payload = data[pos + _HEADER_SIZE : pos + _HEADER_SIZE + plen]
        next_crc = zlib.crc32(payload, zlib.crc32(data[pos : pos + 13], crc)) & 0xFFFFFFFF
        if next_crc != rec_crc:
            truncated = True
            break
        crc = next_crc
        pos += _HEADER_SIZE + plen
        if kind == REC_FRAME:
            if plen != frame_payload:
                raise JournalError(
                    f"frame record is {plen} bytes, expected {frame_payload}"
                )
            frames.append((frame, payload[:players], payload[players:]))
        elif kind == REC_CHECKPOINT:
            checkpoints.append((frame, payload))
        elif kind == REC_GAP:
            gaps.append(frame)
        elif kind == REC_CLOSE:
            closed = True
        elif kind == REC_LOCAL:
            if plen != 2 + isize:
                raise JournalError(
                    f"local record is {plen} bytes, expected {2 + isize}"
                )
            (handle,) = struct.unpack_from("<H", payload)
            local_inputs.append((frame, handle, payload[2:]))
        else:
            raise JournalError(f"unknown journal record kind {kind}")
    return dict(
        meta=meta, frames=frames, checkpoints=checkpoints, gaps=gaps,
        local_inputs=local_inputs, closed=closed, truncated=truncated,
    )
