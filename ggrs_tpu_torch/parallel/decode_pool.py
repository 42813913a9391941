"""Parallel slow-slot decode plane (the port's copy of
``ggrs_tpu/parallel/decode_pool.py``, docs/DESIGN.md §24).

The bank's tick output is a packed byte stream: one body record per slot,
addressed by the header table's ``rec_len`` jump chain.  Slow slots (the
ones the RequestPlan routes through the reference ``_parse_slot`` decoder)
are embarrassingly parallel to decode: each record is an independent byte
range, and everything order-sensitive about a slot (request construction,
sends, journal taps, event dispatch, frame mirrors) happens AFTER decoding,
against plain data.

This module is that split.  :func:`decode_slot_record` is the pure half of
``_parse_slot``: it walks one slot's record and returns a plain-data tuple
(no session state read, no side effects, nothing but ``bytes`` out), so it
can run on any worker against a read-only view of the shared tick buffer.
:class:`DecodePool` fans a tick's slow-slot ranges across workers and
returns the decoded tuples in slot order; the pool's ``_apply_slot`` then
replays the side effects on the owning thread in exactly the serial
decoder's order.

Backends (resolved once, at construction):

- ``interp``: sub-interpreter workers (``InterpreterPoolExecutor``, Python
  3.14+; each worker imports this module in its own interpreter, so decoding
  escapes the GIL).  Slot ranges cross as ``bytes``.
- ``thread``: a plain thread pool.  A real speedup only on free-threaded
  builds; on GIL builds it exercises the merge and ordering machinery.
  Workers receive zero-copy memoryview slices.
- ``serial``: the bit-identical default everywhere else: the host pool then
  calls its reference ``_parse_slot`` directly.

Switches (read when the pool is built, as the JAX package reads them):

- ``GGRS_TPU_NO_PARALLEL_DECODE=1`` forces ``serial``.
- ``GGRS_TPU_DECODE_BACKEND=serial|thread|interp`` forces a backend (an
  unavailable one resolves to ``serial``, never raises).
- ``GGRS_TPU_DECODE_WORKERS=N`` sets the worker count.

Apart from the ownership guard, the module is stdlib-only, with its own
copies of the bank's wire constants, so a worker imports nothing else.
"""

from __future__ import annotations

import os
import struct
import sys
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

from ..utils.ownership import ThreadOwned

# Mirrors of the bank's wire constants, re-declared locally so an interp
# worker importing this module pulls in nothing beyond the stdlib:
# session_bank.cpp EvKind (== host_bank._EV_*) and core.types.NULL_FRAME.
_EV_INTERRUPTED = 1
_EV_CHECKSUM = 4
_NULL_FRAME = -1

# A decoded slot is a plain tuple (index comments below); ops entries are
# (kind, a, b): kind 2 advance -> (2, statuses_bytes, inputs_blob), kind
# 0 save / 1 load -> (kind, frame, None).
DecodedSlot = Tuple[Any, ...]
# indices into a DecodedSlot, for readers of the apply path
DEC_ERR = 0          # bank error code (0 = stepped clean)
DEC_LANDED = 1       # landed frame
DEC_FRAMES_AHEAD = 2
DEC_CURRENT = 3
DEC_CONFIRMED = 4
DEC_CONSENSUS = 5
DEC_OPS = 6          # [(kind, a, b)] in bank order
DEC_POLL_OUT = 7     # [(ep_idx, bytes)] poll-phase endpoint sends
DEC_ADV_OUT = 8      # [(ep_idx, bytes)] adv-phase sends (broadcast mode)
DEC_EVENTS = 9       # [(kind, ep_idx, payload)] staged endpoint events
DEC_EPS = 10         # [(running_byte, [(disc, last_frame)] * players)]
DEC_LOCAL = 11       # [(disc, last_frame)] * players
DEC_SPEC = 12        # None | the broadcast tail (see decode_slot_record)
DEC_END = 13         # end position (pos after this record)


def decode_slot_record(buf, pos: int, players: int, isize: int,
                       has_spec: bool) -> DecodedSlot:
    """Decode ONE slot's body record starting at ``pos`` into plain data.

    The pure half of the host pool's ``_parse_slot``: the byte walk is
    identical, but where the reference decoder *does* things (builds
    requests, sends, records, mutates mirrors) this function only
    *collects* — every side-effect input lands in the returned tuple for
    the owning thread to replay in slot order.  Reads nothing but its
    arguments; safe on any worker against a read-only buffer view.
    """
    unpack_from = struct.unpack_from
    err, landed, frames_ahead, current, confirmed, consensus, n_ops = (
        unpack_from("<iqiqqBH", buf, pos)
    )
    pos += 35
    ops: List[Tuple[int, Any, Any]] = []
    for _ in range(n_ops):
        kind = buf[pos]
        pos += 1
        if kind == 2:
            statuses = bytes(buf[pos : pos + players])
            pos += players
            blob = bytes(buf[pos : pos + players * isize])
            pos += players * isize
            ops.append((2, statuses, blob))
        else:
            (frame,) = unpack_from("<q", buf, pos)
            pos += 8
            ops.append((kind, frame, None))
    poll_out: List[Tuple[int, bytes]] = []
    (n_out_poll,) = unpack_from("<H", buf, pos)
    pos += 2
    for _ in range(n_out_poll):
        ep_idx, dlen = unpack_from("<HI", buf, pos)
        pos += 6
        poll_out.append((ep_idx, bytes(buf[pos : pos + dlen])))
        pos += dlen
    adv_out: List[Tuple[int, bytes]] = []
    if has_spec:
        (n_out_adv,) = unpack_from("<H", buf, pos)
        pos += 2
        for _ in range(n_out_adv):
            ep_idx, dlen = unpack_from("<HI", buf, pos)
            pos += 6
            adv_out.append((ep_idx, bytes(buf[pos : pos + dlen])))
            pos += dlen
    (n_events,) = unpack_from("<H", buf, pos)
    pos += 2
    events: List[Tuple[int, int, Any]] = []
    for _ in range(n_events):
        kind, ep_idx = unpack_from("<BH", buf, pos)
        pos += 3
        if kind == _EV_INTERRUPTED:
            (remaining,) = unpack_from("<q", buf, pos)
            pos += 8
            events.append((kind, ep_idx, remaining))
        elif kind == _EV_CHECKSUM:
            frame, lo, hi = unpack_from("<qQQ", buf, pos)
            pos += 24
            events.append((kind, ep_idx, (frame, lo, hi)))
        else:
            events.append((kind, ep_idx, None))
    (n_eps,) = unpack_from("<B", buf, pos)
    pos += 1
    eps: List[Tuple[int, List[Tuple[int, int]]]] = []
    for _e in range(n_eps):
        running = buf[pos]
        pos += 1
        prs: List[Tuple[int, int]] = []
        for _h in range(players):
            disc, lf = unpack_from("<Bq", buf, pos)
            pos += 9
            prs.append((disc, lf))
        eps.append((running, prs))
    local: List[Tuple[int, int]] = []
    for _h in range(players):
        disc, lf = unpack_from("<Bq", buf, pos)
        pos += 9
        local.append((disc, lf))
    spec = None
    if has_spec:
        # broadcast tail: spectator mirror, phase-tagged fan-out
        # streams, hub events, journal confirmed-frame records
        next_spec, n_specs = unpack_from("<qB", buf, pos)
        pos += 9
        sstat: List[Tuple[int, int]] = []
        for _e in range(n_specs):
            st, la = unpack_from("<Bq", buf, pos)
            pos += 9
            sstat.append((st, la))
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
        conf_start = _NULL_FRAME
        conf_records: List[Tuple[bytes, bytes]] = []
        if n_conf:
            (conf_start,) = unpack_from("<q", buf, pos)
            pos += 8
            blob_len = players * isize
            for _ in range(n_conf):
                flags = bytes(buf[pos : pos + players])
                pos += players
                conf_records.append(
                    (flags, bytes(buf[pos : pos + blob_len]))
                )
                pos += blob_len
        spec = (next_spec, n_specs, sstat, spec_poll, spec_adv,
                spec_events, conf_start, conf_records)
    return (err, landed, frames_ahead, current, confirmed, consensus,
            ops, poll_out, adv_out, events, eps, local, spec, pos)


def _decode_chunk(buf, jobs: Sequence[Tuple[int, int, int, bool]]):
    """Worker entry: decode a contiguous chunk of slot jobs against one
    shared read-only buffer view.  Returns ``(worker_tag, results)`` so
    the pool can attribute utilization without any worker-side shared
    mutation (the tag is the worker thread's ident — unique per pool
    worker for threads, and per interpreter's single thread for interps).
    """
    out = [
        decode_slot_record(buf, pos, players, isize, has_spec)
        for pos, players, isize, has_spec in jobs
    ]
    return threading.get_ident(), out


class DecodePool(ThreadOwned):
    """Worker engine fanning slow-slot decode across workers.

    Owned like a session: :meth:`decode_slots` is a driving method, and
    only plain data crosses
    the worker boundary — workers run the module-level pure
    :func:`decode_slot_record`/:func:`_decode_chunk`, never a bound
    method of this class.  The tick buffer is shared read-only (thread
    backend: memoryview slices, zero copies; interp backend: one bytes
    copy per chunk, the interpreter boundary's price); workers never
    mutate shared state, and the caller applies results in slot order so
    side effects land exactly as the serial decoder produced them.
    """

    _DRIVING_METHODS = ("decode_slots",)

    def __init__(self, backend: Optional[str] = None,
                 workers: Optional[int] = None) -> None:
        self.jobs = 0          # slots decoded through the pool
        self.batches = 0       # decode_slots calls that fanned out
        self.decode_ns = 0     # wall ns inside decode_slots
        self.worker_jobs: dict = {}  # worker tag -> jobs decoded
        self._executor = None
        env_backend = os.environ.get("GGRS_TPU_DECODE_BACKEND")
        if os.environ.get("GGRS_TPU_NO_PARALLEL_DECODE"):
            backend = "serial"
        elif backend is None:
            backend = env_backend or self._auto_backend()
        if workers is None:
            try:
                workers = int(os.environ.get("GGRS_TPU_DECODE_WORKERS", 0))
            except ValueError:
                workers = 0
        if not workers or workers < 1:
            workers = min(8, max(2, (os.cpu_count() or 2) - 1))
        self.workers = workers
        if backend == "interp":
            ex = self._make_interp_executor(workers)
            if ex is None:
                backend = "serial"
            else:
                self._executor = ex
        elif backend == "thread":
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="ggrs-decode"
            )
        elif backend != "serial":
            backend = "serial"  # unknown forced backend: degrade
        self.backend = backend

    @staticmethod
    def _auto_backend() -> str:
        """Default backend for THIS interpreter: sub-interpreters where
        the stdlib offers them, threads only where they actually run in
        parallel (free-threaded builds), serial everywhere else — a GIL
        build gains nothing from Python-level decode threads, so the
        default stays on the reference path."""
        if DecodePool._interp_available():
            return "interp"
        gil_check = getattr(sys, "_is_gil_enabled", None)
        if gil_check is not None and not gil_check():
            return "thread"
        return "serial"

    @staticmethod
    def _interp_available() -> bool:
        try:
            from concurrent.futures import (  # noqa: F401
                InterpreterPoolExecutor,
            )
        except ImportError:
            return False
        return True

    @staticmethod
    def _make_interp_executor(workers: int):
        try:
            from concurrent.futures import InterpreterPoolExecutor
        except ImportError:
            return None
        try:
            return InterpreterPoolExecutor(max_workers=workers)
        except Exception:
            return None  # interpreters exist but won't start: degrade

    def decode_slots(
        self, buf, jobs: Sequence[Tuple[int, int, int, bool]]
    ) -> List[DecodedSlot]:
        """Decode ``jobs`` — ``(pos, players, isize, has_spec)`` slot
        ranges into ``buf`` — and return the decoded tuples in job
        order.  One driving call per tick; the fan-out/merge is entirely
        inside."""
        self._check_owner()
        t0 = time.perf_counter_ns()
        n = len(jobs)
        ex = self._executor
        if ex is None or n <= 1:
            tag, out = _decode_chunk(buf, jobs)
            self.worker_jobs[tag] = self.worker_jobs.get(tag, 0) + n
        else:
            if self.backend == "interp":
                # buffers don't cross interpreters: ship the bytes once
                # per call (workers slice it read-only)
                buf = bytes(buf)
            # contiguous chunks, one per worker, submitted in slot order
            # and merged by list order — ordering never depends on
            # completion order
            n_chunks = min(self.workers, n)
            bounds = [n * i // n_chunks for i in range(n_chunks + 1)]
            futs = [
                ex.submit(_decode_chunk, buf, jobs[bounds[i]:bounds[i + 1]])
                for i in range(n_chunks)
            ]
            out = []
            for i, f in enumerate(futs):
                tag, part = f.result()
                self.worker_jobs[tag] = (
                    self.worker_jobs.get(tag, 0) + len(part)
                )
                out.extend(part)
        self.jobs += n
        self.batches += 1
        self.decode_ns += time.perf_counter_ns() - t0
        return out

    def stats(self) -> dict:
        """Plain-data counters for ``io_stats()``/profiling: backend,
        worker count, jobs/batches, wall ns, and per-worker utilization
        (jobs per worker tag — even spread == good utilization)."""
        return {
            "backend": self.backend,
            "workers": self.workers if self._executor is not None else 1,
            "jobs": self.jobs,
            "batches": self.batches,
            "decode_ns": self.decode_ns,
            "worker_jobs": dict(self.worker_jobs),
        }

    def close(self) -> None:
        ex = self._executor
        self._executor = None
        if ex is not None:
            ex.shutdown(wait=True)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
